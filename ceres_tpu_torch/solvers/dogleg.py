"""Dogleg trust-region strategy (TRADITIONAL and SUBSPACE).

Port of `ceres_tpu.solvers.dogleg` (reference: dogleg_strategy.cc), as the
JAX package computes it: a Gauss-Newton point from DENSE_QR or
DENSE_NORMAL_CHOLESKY, and from CGNR + JACOBI for every other linear
solver (the residual tolerance eta, no minimum iteration count), on JᵀJ
plus a fixed 1e-12 · clamp(diag(JᵀJ)) floor where the reference escalates
mu; the Cauchy point along the scaled gradient; then the piecewise-linear
path (TRADITIONAL_DOGLEG) or the exact minimizer of the model over
span{gradient, GN} within the radius (SUBSPACE_DOGLEG: the 2x2 secular
equation in B's eigenbasis, by a fixed 80-step bisection). What the JAX
dogleg ignores is ignored here too: the preconditioner (JACOBI in the
GN's PCG), mixed-precision solves, and the Schur and sparse solvers, whose
GN is CGNR's; so kernels B4 and B5 do not run under DOGLEG.

`prepare` (the GN point and the Cauchy data) depends on the Jacobian
only, so the minimizers reuse it across rejected steps (the reference's
reuse_ flag, dogleg_strategy.cc:74-107, 617-643); `finish` selects the step
for a radius and reads nothing. On a card prepare's head (the diagonal
floor, the JACOBI inverses, the rhs), its PCG iteration and its Cauchy
tail are CUDA graphs, as CGNR's step is (strategies._cgnr_step_fn), and
the PCG reads one flag per step, so prepare runs its own graphs
(`step_fn.prepare_reads`); the finish, SUBSPACE's 80 bisection steps
included, is one graph. The dense GN runs eagerly. Each finish writes the
kind of step it took (STEP_KINDS) into `step_fn.step_kinds`, a device log
of one entry per finish that a caller may read after the solve (the
Evaluator's buffer: the next step function over it starts it over).
"""

from __future__ import annotations

import torch

from ..types import DoglegType, LinearSolverType, PreconditionerType
from ..utils import graphs
from .strategies import _step_result

# the codes of step_fn.step_kinds
STEP_KINDS = ("gauss-newton", "cauchy", "dogleg", "subspace")
_GN, _CAUCHY, _DOGLEG, _SUBSPACE = range(4)


def _eigh2(b):
    """Closed-form eigendecomposition of a symmetric 2x2 [[a, c], [c, d]]:
    (eigenvalues [2] ascending, eigenvectors [2, 2] as columns)."""
    a, c, d = b[0, 0], b[0, 1], b[1, 1]
    half_tr = 0.5 * (a + d)
    disc = torch.sqrt(torch.clamp_min(0.25 * (a - d) ** 2 + c * c, 0.0))
    l1 = half_tr - disc
    l2 = half_tr + disc
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    # the eigenvector of l2: (c, l2 - a) unless degenerate
    v2 = torch.where(
        torch.abs(c) > 1e-300,
        torch.stack([c, l2 - a]),
        torch.where(a >= d, torch.stack([one, zero]), torch.stack([zero, one])),
    )
    v2 = v2 / torch.clamp_min(torch.linalg.norm(v2), 1e-300)
    v1 = torch.stack([-v2[1], v2[0]])
    return torch.stack([l1, l2]), torch.stack([v1, v2], dim=1)


def _solve2(h, rhs):
    """h⁻¹ rhs for a 2x2 h by Gaussian elimination with partial pivoting
    (what an LU solve does at this size), with no host read."""
    swap = torch.abs(h[1, 0]) > torch.abs(h[0, 0])
    a00 = torch.where(swap, h[1, 0], h[0, 0])
    a01 = torch.where(swap, h[1, 1], h[0, 1])
    a10 = torch.where(swap, h[0, 0], h[1, 0])
    a11 = torch.where(swap, h[0, 1], h[1, 1])
    b0 = torch.where(swap, rhs[1], rhs[0])
    b1 = torch.where(swap, rhs[0], rhs[1])
    l10 = a10 / a00
    x1 = (b1 - l10 * b0) / (a11 - l10 * a01)
    return torch.stack([(b0 - a01 * x1) / a00, x1])


def _boundary_minimizer_2d(b, g, radius):
    """The minimizer of 0.5 yᵀBy + gᵀy on |y| = radius for a PD B: the
    secular equation Σ gt_i²/(l_i + y)² = r² solved for its unique y* >= 0
    by 80 bisection steps in [0, |g|/r] (the caller selects it only when
    the unconstrained minimum lies outside the ball)."""
    lams, q = _eigh2(b)
    gt = q.T @ g

    def norm2_of_x(y):
        xi = -gt / (lams + y)
        return (xi * xi).sum()

    g_norm = torch.clamp_min(torch.linalg.norm(gt), 1e-300)
    lo = torch.zeros_like(radius)
    hi = g_norm / torch.clamp_min(radius, 1e-300)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        outside = norm2_of_x(mid) > radius * radius
        lo, hi = torch.where(outside, mid, lo), torch.where(outside, hi, mid)
    y_star = 0.5 * (lo + hi)
    x = -gt / (lams + y_star)
    # exactly on the boundary
    x = x * (radius / torch.clamp_min(torch.linalg.norm(x), 1e-300))
    return q @ x


def _select(dogleg_type, jac_s, grad_s, radius, cache):
    """The step for `radius` from the prepare cache, and its STEP_KINDS
    code (ceres_tpu/solvers/dogleg.py:167-236)."""
    gn, alpha, g_norm2, dsq = cache["gn"], cache["alpha"], cache["g_norm2"], cache["dsq"]
    gn_norm = torch.linalg.norm(gn)
    sd = -alpha * grad_s
    sd_norm = torch.linalg.norm(sd)
    g_norm = torch.sqrt(g_norm2)
    bound_sd = -(radius / torch.where(g_norm > 0, g_norm, 1.0)) * grad_s
    gn_inside = gn_norm <= radius

    if dogleg_type == DoglegType.TRADITIONAL_DOGLEG:
        # GN inside the region; else the Cauchy point scaled to the boundary
        # when it lies outside; else the sd -> gn segment to the boundary
        diff = gn - sd
        a_ = torch.dot(diff, diff)
        b_ = 2.0 * torch.dot(sd, diff)
        c_ = torch.dot(sd, sd) - radius * radius
        disc = torch.clamp_min(b_ * b_ - 4.0 * a_ * c_, 0.0)
        beta = torch.where(
            a_ > 0, (-b_ + torch.sqrt(disc)) / torch.where(a_ > 0, 2.0 * a_, 1.0), 0.0
        )
        interp = sd + torch.clamp(beta, 0.0, 1.0) * diff
        cauchy = sd_norm >= radius
        step = torch.where(gn_inside, gn, torch.where(cauchy, bound_sd, interp))
        kind = torch.where(gn_inside, _GN, torch.where(cauchy, _CAUCHY, _DOGLEG))
        return step, kind

    # SUBSPACE_DOGLEG: the model's minimum on span{grad_s, gn} within the
    # radius (dogleg_strategy.cc ComputeSubspaceDoglegStep)
    v1 = grad_s / torch.where(g_norm > 0, g_norm, 1.0)
    w = gn - torch.dot(gn, v1) * v1
    w_norm = torch.linalg.norm(w)
    one_dimensional = w_norm <= 1e-12 * torch.clamp_min(gn_norm, 1.0)
    v2 = w / torch.where(w_norm > 0, w_norm, 1.0)
    jv1 = jac_s.right_multiply(v1)
    jv2 = jac_s.right_multiply(v2)

    def dot_r(a_groups, b_groups):
        # residual space: a rank's lanes on a shard, summed over the mesh
        return jac_s.psum(sum((a * b).sum() for a, b in zip(a_groups, b_groups)))

    h01 = dot_r(jv1, jv2)
    h = torch.stack([
        torch.stack([dot_r(jv1, jv1) + torch.dot(v1 * dsq, v1), h01]),
        torch.stack([h01, dot_r(jv2, jv2) + torch.dot(v2 * dsq, v2)]),
    ])
    gq = torch.stack([torch.dot(v1, grad_s), torch.dot(v2, grad_s)])
    y_unc = _solve2(h, -gq)
    inside = torch.linalg.norm(y_unc) <= radius
    y = torch.where(inside, y_unc, _boundary_minimizer_2d(h, gq, radius))
    step = v1 * y[0] + v2 * y[1]
    # a 1-D subspace: along the gradient to the boundary (dogleg_strategy.cc:305-316)
    step = torch.where(one_dimensional, bound_sd, step)
    step = torch.where(gn_inside, gn, step)
    kind = torch.where(gn_inside, _GN, torch.where(one_dimensional, _CAUCHY, _SUBSPACE))
    return step, kind


def make_dogleg_step_fn(program, options, evaluator):
    """The dogleg step function, with `.prepare` and `.finish` (the LM step
    function's signature and results); `.prepare_reads` tells the
    minimizers that prepare runs its own graphs and reads the device."""
    from ..evaluator import flatten_residuals
    from ..jacobian import BlockJacobian
    from ..linalg.cg import conjugate_gradients
    from ..linalg.dense import solve_dense_normal_cholesky, solve_dense_qr
    from ..linalg.preconditioners import BlockDiagSolver, make_preconditioner

    solver = options.linear_solver_type
    dense = solver in (LinearSolverType.DENSE_QR, LinearSolverType.DENSE_NORMAL_CHOLESKY)
    min_diag, max_diag = options.min_lm_diagonal, options.max_lm_diagonal
    garrs = evaluator.arrays["groups"]
    dev = evaluator.device
    # one entry per finish (a finish per iteration): the STEP_KINDS codes;
    # the finish graph reads both in place, so they are the evaluator's
    # and start over with each step function
    n_kinds = max(options.max_num_iterations, 1)
    kinds = evaluator.buffer(
        ("dogleg_kinds", n_kinds),
        lambda: torch.empty((n_kinds,), dtype=torch.int32, device=dev),
    ).fill_(-1)
    count = evaluator.buffer(
        "dogleg_count", lambda: torch.empty((), dtype=torch.long, device=dev)
    ).zero_()
    head_graph = evaluator.fn_graph("dogleg_head")
    pcg_graph = evaluator.step_graph("pcg")
    cauchy_graph = evaluator.fn_graph("dogleg_cauchy")
    finish_graph = evaluator.fn_graph("dogleg_finish")

    def jacobian(leaves, twins, scale):
        return BlockJacobian(program, leaves, garrs, twins=twins).scale_columns(scale)
    def head(fixed, scale):
        leaves, twins, grad = fixed
        jac_s = jacobian(leaves, twins, scale)
        # a small fixed regularization of a rank-deficient JᵀJ
        # (ceres_tpu/solvers/dogleg.py:135-143)
        dsq = torch.clamp(jac_s.squared_column_norms(), min_diag, max_diag) * 1e-12
        out = {"dsq": dsq, "b": -(grad * scale), "scale": scale.clone()}
        if not dense:
            out["prec_inv"] = make_preconditioner(
                PreconditionerType.JACOBI, program, jac_s, dsq=dsq
            ).inv_tables
        return out

    def cauchy(fixed, scale, gn, lin_iters):
        """The Cauchy data: alpha = |g|² / |J g|²."""
        leaves, twins, grad, dsq = fixed
        grad_s = grad * scale
        jac_s = jacobian(leaves, twins, scale)
        jg = jac_s.right_multiply(grad_s)
        g_norm2 = torch.dot(grad_s, grad_s)
        # residual space: a rank's lanes on a shard, summed over the mesh
        jg_norm2 = jac_s.psum(sum((m * m).sum() for m in jg))
        alpha = g_norm2 / torch.where(jg_norm2 > 0, jg_norm2, 1.0)
        return {"gn": gn.clone(), "lin_iters": lin_iters.clone(), "alpha": alpha,
                "g_norm2": g_norm2, "dsq": dsq}

    def prepare(jac, res_groups, grad, scale):
        """The radius-independent work: the scaled GN step and the Cauchy
        data (ceres_tpu/solvers/dogleg.py:131-165)."""
        leaves, twins = tuple(jac.jac_groups), jac.twins
        h = graphs.call(head_graph, head, (leaves, twins, grad), scale)
        jac_s = jacobian(leaves, twins, h["scale"])
        if dense:
            a = jac_s.to_dense()
            res_flat = flatten_residuals(program, res_groups)
            if solver == LinearSolverType.DENSE_QR:
                gn = solve_dense_qr(a, res_flat, h["dsq"])
            else:
                gn = solve_dense_normal_cholesky(a, res_flat, h["dsq"])
            lin_iters = torch.zeros((), dtype=torch.int32, device=grad.device)
        else:
            prec = BlockDiagSolver.from_inverse_tables(program, h["prec_inv"])
            fixed = [t for ls in leaves for t in ls] + list(twins.values())
            fixed += [h["scale"], h["dsq"]] + list(prec.inv_tables.values())
            result = conjugate_gradients(
                matvec=lambda v: jac_s.jtj_multiply(v, h["dsq"]),
                b=h["b"],
                preconditioner=prec,
                max_iterations=min(options.max_linear_solver_iterations,
                                   program.num_effective_parameters),
                tolerance=options.eta,
                graph=pcg_graph,
                fixed=fixed,
            )
            gn, lin_iters = result.x, result.iterations
        return graphs.call(
            cauchy_graph, cauchy, (leaves, twins, grad, h["dsq"]), scale, gn, lin_iters
        )

    def finish_body(fixed, radius, scale):
        leaves, twins, res_groups, grad, cache, kinds, count = fixed
        jac_s = jacobian(leaves, twins, scale)
        step, kind = _select(options.dogleg_type, jac_s, grad * scale, radius, cache)
        kinds.index_put_((torch.clamp(count, max=kinds.numel() - 1).reshape(1),),
                         kind.reshape(1).to(kinds.dtype))
        count.add_(1)
        return _step_result(jac_s, step, res_groups, scale, cache["lin_iters"].clone())

    def finish(jac, res_groups, grad, radius, scale, cache):
        if not isinstance(radius, torch.Tensor):
            radius = torch.full((), radius, dtype=grad.dtype, device=grad.device)
        fixed = (tuple(jac.jac_groups), jac.twins, tuple(res_groups), grad, cache, kinds, count)
        return graphs.call(finish_graph, finish_body, fixed, radius, scale)

    def step_fn(jac, res_groups, grad, radius, scale):
        return finish(jac, res_groups, grad, radius, scale,
                      prepare(jac, res_groups, grad, scale))

    step_fn.prepare = prepare
    step_fn.finish = finish
    step_fn.prepare_reads = True
    # attributes only: finish holds the tensors itself, so no closure refers
    # back to step_fn and the step function's graphs are freed by reference
    # counting, never by a cyclic collection that could run inside a capture
    step_fn.step_kinds, step_fn.step_count = kinds, count
    return step_fn
