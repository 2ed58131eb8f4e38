"""Trust-region step computation: the Levenberg-Marquardt strategy.

Port of the LM branch of `ceres_tpu.solvers.strategies`
(reference: levenberg_marquardt_strategy.cc:68-172) for every linear
solver: DENSE_QR, DENSE_NORMAL_CHOLESKY, CGNR, the Schur solvers, and the
host sparse solvers (SPARSE_NORMAL_CHOLESKY, SPARSE_SCHUR, CGNR with
SUBSET), which factor on the host and are not `jittable`
(`_host_step_fn`). The Schur step function
solves through `schur_solve`; for ITERATIVE_SCHUR with a block
preconditioner it also carries the prepare/finish split: `prepare` builds
everything that depends only on the Jacobian (cached by the host loop
across rejected steps), `finish` everything that depends on the radius.
CGNR runs unsplit, as in the JAX package: PCG on the normal equations
(JᵀJ + D²) x = -Jᵀr with `jtj_multiply` as its matvec, preconditioned by
IDENTITY or JACOBI; on a card its head (D², the rhs, the Jacobi inverses,
under mixed-precision solves the bfloat16 leaves), its PCG iteration and
its tail are CUDA graphs. The dense solvers materialize the Jacobian and
run eagerly.
The device step functions read nothing from the device: the step's
validity, its model cost change and the PCG count come back as tensors
(the JAX package's "jittable" contract), for the host loop to read and the
fused loop to decide on where they are.
"""

from __future__ import annotations

import torch

from ..types import LinearSolverType, PreconditionerType
from ..utils import graphs
from ..utils.execution_summary import record


def _model_cost_change(jac_scaled, step, res_groups):
    """-m'(r + m/2) with m = J step (reference: trust_region_minimizer.cc
    ComputeTrustRegionStep model_cost_change)."""
    mcc = torch.zeros((), dtype=step.dtype, device=step.device)
    for m, r in zip(jac_scaled.right_multiply(step), res_groups):
        mcc = mcc - (m * (r + 0.5 * m)).sum()
    # residual space: a rank's lanes on a shard, summed over the mesh
    return jac_scaled.psum(mcc)


def _step_result(jac_s, step, res_groups, scale, lin_iters):
    """(delta, model cost change, linear iterations, step is valid), all
    tensors on the step's device."""
    mcc = _model_cost_change(jac_s, step, res_groups)
    delta = scale * step
    valid = torch.isfinite(delta).all() & (mcc > 0)
    return delta, mcc, lin_iters, valid


def make_lm_step_fn(program, options, evaluator):
    """The LM step function; `.prepare` / `.finish` are attached for
    ITERATIVE_SCHUR with SCHUR_JACOBI, JACOBI or IDENTITY and neither the
    explicit complement nor the power-series warm start (the JAX package's
    condition, strategies.py:142-152). Under mixed-precision solves the
    prepare cache holds the bfloat16 matvec leaves and twins, which the
    finish's PCG reads (linalg/schur.py).

    signature: (jac, res_groups, grad, radius, scale) ->
       (delta, model_cost_change, lin_iters, step_is_valid); radius is a
       float or a 0-d tensor, the results are tensors
    """
    solver = options.linear_solver_type
    precond = options.preconditioner_type
    if solver in (LinearSolverType.DENSE_QR, LinearSolverType.DENSE_NORMAL_CHOLESKY):
        return _dense_step_fn(program, options)
    if solver == LinearSolverType.CGNR and precond == PreconditionerType.SUBSET:
        return _host_step_fn(program, options, _subset_solve)
    if solver == LinearSolverType.CGNR:
        return _cgnr_step_fn(program, options, evaluator)
    if solver == LinearSolverType.SPARSE_SCHUR:
        return _host_step_fn(program, options, _sparse_schur_solve)
    if solver == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
        return _host_step_fn(program, options, _sparse_cholesky_solve)
    from ..jacobian import BlockJacobian
    from ..linalg.schur import (
        schur_back_substitute, schur_finish_pcg, schur_finish_rhs, schur_prepare, schur_solve,
    )

    min_diag = options.min_lm_diagonal
    max_diag = options.max_lm_diagonal
    garrs = evaluator.arrays["groups"]

    def step_fn(jac, res_groups, grad, radius, scale):
        jac_s = jac.scale_columns(scale)
        # LM diagonal D^2 = clamp(diag(J'J), min, max) / radius
        # (levenberg_marquardt_strategy.cc:83-95)
        dsq = torch.clamp(jac_s.squared_column_norms(), min_diag, max_diag) / radius
        step, lin_iters = schur_solve(program, options, jac_s, res_groups, grad * scale, dsq)
        return _step_result(jac_s, step, res_groups, scale, lin_iters)

    def prepare_fn(jac, res_groups, grad, scale):
        return schur_prepare(program, options, jac.scale_columns(scale))

    # finish = head (the LM diagonal, the rhs and the inverse tables), the
    # PCG, tail (back-substitution and the step's result); on a card head,
    # the PCG iteration and tail run from CUDA graphs (one each per solve,
    # captured at their first call), which read the Jacobian, its twins,
    # the prepare cache and head's outputs in place
    head_graph = evaluator.fn_graph("finish_head")
    pcg_graph = evaluator.step_graph("pcg")
    tail_graph = evaluator.fn_graph("finish_tail")

    def head(fixed, radius, scale):
        leaves, twins, grad, cache = fixed
        jac_s = BlockJacobian(program, leaves, garrs, twins=twins).scale_columns(scale)
        dsq = torch.clamp(cache["colnorm2"], min_diag, max_diag) / radius
        grad_s = grad * scale
        return grad_s, schur_finish_rhs(program, options, jac_s, grad_s, dsq, cache)

    def tail(fixed, scale, x, lin_iters):
        leaves, twins, res_groups, grad_s, ete_inv = fixed
        jac_s = BlockJacobian(program, leaves, garrs, twins=twins).scale_columns(scale)
        step = schur_back_substitute(program, jac_s, grad_s, {"ete_inv": ete_inv}, x)
        return _step_result(jac_s, step, res_groups, scale, lin_iters)

    def finish_fn(jac, res_groups, grad, radius, scale, cache):
        if not isinstance(radius, torch.Tensor):
            radius = torch.full((), radius, dtype=grad.dtype, device=grad.device)
        leaves, twins = tuple(jac.jac_groups), jac.twins
        jac_cache = {k: cache[k] for k in ("colnorm2", "e_gram0", "p0")}
        grad_s, inter = graphs.call(
            head_graph, head, (leaves, twins, grad, jac_cache), radius, scale
        )
        x, lin_iters = schur_finish_pcg(program, options, jac, cache, inter, pcg_graph)
        return graphs.call(
            tail_graph, tail, (leaves, twins, tuple(res_groups), grad_s, inter["ete_inv"]),
            scale, x, lin_iters,
        )

    if (
        solver == LinearSolverType.ITERATIVE_SCHUR
        and precond
        in (PreconditionerType.SCHUR_JACOBI, PreconditionerType.JACOBI, PreconditionerType.IDENTITY)
        and not options.use_explicit_schur_complement
        and not options.use_spse_initialization
    ):
        step_fn.prepare = prepare_fn
        step_fn.finish = finish_fn
    return step_fn


def _dense_step_fn(program, options):
    """DENSE_QR and DENSE_NORMAL_CHOLESKY (with the float32 factor and
    refinement under mixed-precision solves): the Jacobi-scaled Jacobian
    materialized and solved whole (ceres_tpu/solvers/strategies.py:68-99)."""
    from ..evaluator import flatten_residuals
    from ..linalg.dense import (
        solve_dense_normal_cholesky, solve_dense_normal_cholesky_mixed, solve_dense_qr,
    )

    min_diag, max_diag = options.min_lm_diagonal, options.max_lm_diagonal
    qr = options.linear_solver_type == LinearSolverType.DENSE_QR
    refine = max(1, options.max_num_refinement_iterations or 3)

    def step_fn(jac, res_groups, grad, radius, scale):
        jac_s = jac.scale_columns(scale)
        dsq = torch.clamp(jac_s.squared_column_norms(), min_diag, max_diag) / radius
        dense = jac_s.to_dense()
        res_flat = flatten_residuals(program, res_groups)
        if qr:
            step = solve_dense_qr(dense, res_flat, dsq)
        elif options.use_mixed_precision_solves:
            step = solve_dense_normal_cholesky_mixed(dense, res_flat, dsq, refine)
        else:
            step = solve_dense_normal_cholesky(dense, res_flat, dsq)
        lin_iters = torch.zeros((), dtype=torch.int32, device=grad.device)
        return _step_result(jac_s, step, res_groups, scale, lin_iters)

    return step_fn


def _cgnr_step_fn(program, options, evaluator):
    """CGNR (ceres_tpu/solvers/strategies.py:100-129): PCG on (JᵀJ + D²) x =
    -Jᵀr, preconditioned by IDENTITY or JACOBI (any other preconditioner
    by JACOBI, as there), its matvec `jtj_multiply` on the bfloat16 copy of
    the leaves under mixed-precision solves. On a card the head, the PCG
    iteration and the tail replay CUDA graphs that read the Jacobian and
    the head's outputs in place."""
    from ..jacobian import BlockJacobian
    from ..linalg.cg import conjugate_gradients
    from ..linalg.preconditioners import BlockDiagSolver, make_preconditioner

    min_diag, max_diag = options.min_lm_diagonal, options.max_lm_diagonal
    kind = (
        options.preconditioner_type
        if options.preconditioner_type in (PreconditionerType.IDENTITY, PreconditionerType.JACOBI)
        else PreconditionerType.JACOBI
    )
    mixed = options.use_mixed_precision_solves
    garrs = evaluator.arrays["groups"]
    head_graph = evaluator.fn_graph("cgnr_head")
    pcg_graph = evaluator.step_graph("pcg")
    tail_graph = evaluator.fn_graph("cgnr_tail")

    def jacobian(leaves, twins, scale):
        return BlockJacobian(program, leaves, garrs, twins=twins).scale_columns(scale)

    def head(fixed, radius, scale):
        leaves, twins, grad = fixed
        jac_s = jacobian(leaves, twins, scale)
        dsq = torch.clamp(jac_s.squared_column_norms(), min_diag, max_diag) / radius
        prec = make_preconditioner(kind, program, jac_s, dsq=dsq)
        out = {"dsq": dsq, "b": -(grad * scale), "scale": scale.clone(),
               "prec_inv": getattr(prec, "inv_tables", None)}
        if mixed:
            # the bfloat16 matvec copy (ceres_tpu/solvers/strategies.py:118-123)
            jac_m = jac_s.astype(torch.bfloat16)
            out["leaves"], out["twins"] = jac_m.jac_groups, jac_m.twins
        return out

    def tail(fixed, scale, x, lin_iters):
        leaves, twins, res_groups = fixed
        return _step_result(jacobian(leaves, twins, scale), x, res_groups, scale, lin_iters)

    def step_fn(jac, res_groups, grad, radius, scale):
        if not isinstance(radius, torch.Tensor):
            radius = torch.full((), radius, dtype=grad.dtype, device=grad.device)
        leaves, twins = tuple(jac.jac_groups), jac.twins
        h = graphs.call(head_graph, head, (leaves, twins, grad), radius, scale)
        m_leaves, m_twins = (h["leaves"], h["twins"]) if mixed else (leaves, twins)
        jac_m = jacobian(m_leaves, m_twins, h["scale"])
        dsq = h["dsq"]
        prec = (None if h["prec_inv"] is None
                else BlockDiagSolver.from_inverse_tables(program, h["prec_inv"]))
        fixed = [t for ls in m_leaves for t in ls] + list(m_twins.values())
        fixed += [h["scale"], dsq] + ([] if prec is None else list(prec.inv_tables.values()))
        result = conjugate_gradients(
            matvec=lambda v: jac_m.jtj_multiply(v, dsq),
            b=h["b"],
            preconditioner=prec,
            max_iterations=min(options.max_linear_solver_iterations,
                               program.num_effective_parameters),
            min_iterations=options.min_linear_solver_iterations,
            # LM maps eta to the Q-based (truncated-Newton) criterion, the
            # residual test off (levenberg_marquardt_strategy.cc:98-103)
            tolerance=0.0,
            q_tolerance=options.eta,
            graph=pcg_graph,
            fixed=fixed,
        )
        return graphs.call(
            tail_graph, tail, (leaves, twins, tuple(res_groups)), scale, result.x,
            result.iterations,
        )

    return step_fn


def _host_step_fn(program, options, solve):
    """A step function whose linear solve factors on the host
    (ceres_tpu/solvers/strategies.py:189-296): the Jacobi-scaled Jacobian,
    the LM diagonal and the model cost stay on the device, and
    solve(program, options, jac_s, res_groups, grad_s, dsq) ->
    (step, linear iterations) brings what it factors over in counted reads.
    Not `jittable`, as there: the loops run it on the host loop. Its reads
    and factorizations are recorded in the current sink
    (utils.execution_summary), the solve's summary."""
    min_diag, max_diag = options.min_lm_diagonal, options.max_lm_diagonal

    def step_fn(jac, res_groups, grad, radius, scale):
        jac_s = jac.scale_columns(scale)
        grad_s = grad * scale
        dsq = torch.clamp(jac_s.squared_column_norms(), min_diag, max_diag) / radius
        step, lin_iters = solve(program, options, jac_s, res_groups, grad_s, dsq)
        return _step_result(jac_s, step, res_groups, scale, lin_iters)

    step_fn.jittable = False
    return step_fn


def _sparse_cholesky_solve(program, options, jac_s, res_groups, grad_s, dsq):
    """SPARSE_NORMAL_CHOLESKY: JᵀJ + D² factored on the host, refined twice
    (linalg/sparse.py)."""
    from ..linalg.sparse import solve_sparse_normal_cholesky

    step = solve_sparse_normal_cholesky(jac_s, res_groups, grad_s, dsq)
    return step, torch.ones((), dtype=torch.int32, device=grad_s.device)


def _sparse_schur_solve(program, options, jac_s, res_groups, grad_s, dsq):
    """SPARSE_SCHUR: the explicit S assembled on the device and factored on
    the host (linalg/explicit_schur.py); a problem that is not BA-shaped
    takes schur_solve's dense S, as in the JAX package, recorded as
    SparseSchur::Fallback."""
    from ..linalg.explicit_schur import ExplicitSchurPlan, solve_sparse_schur
    from ..linalg.schur import schur_solve, schur_views

    try:
        ExplicitSchurPlan.get(program, *schur_views(program, jac_s))
    except ValueError:
        record("SparseSchur::Fallback")
        return schur_solve(program, options, jac_s, res_groups, grad_s, dsq)
    return solve_sparse_schur(program, options, jac_s, res_groups, grad_s, dsq)


def _subset_solve(program, options, jac_s, res_groups, grad_s, dsq):
    """CGNR with the SUBSET preconditioner: QᵀQ + D² of the user's residual
    rows factored on the host, each application a host solve (one read),
    the PCG run eagerly on the device (linalg/sparse.py)."""
    from ..linalg.cg import conjugate_gradients
    from ..linalg.sparse import SubsetPreconditioner

    rows = program.subset_rows
    if rows is None or len(rows) == 0:
        raise ValueError(
            "SUBSET preconditioner requires residual_blocks_for_subset_preconditioner"
        )
    result = conjugate_gradients(
        matvec=lambda v: jac_s.jtj_multiply(v, dsq),
        b=-grad_s,
        preconditioner=SubsetPreconditioner(jac_s, rows, dsq),
        max_iterations=min(options.max_linear_solver_iterations,
                           program.num_effective_parameters),
        min_iterations=options.min_linear_solver_iterations,
        tolerance=0.0,
        q_tolerance=options.eta,  # levenberg_marquardt_strategy.cc:98-103
    )
    return result.x, result.iterations


class TrustRegionStepEvaluator:
    """Non-monotonic step acceptance bookkeeping (reference:
    trust_region_step_evaluator.cc:36-113)."""

    def __init__(self, initial_cost: float, max_consecutive_nonmonotonic_steps: int = 0):
        self.max_consecutive_nonmonotonic_steps = max_consecutive_nonmonotonic_steps
        self.minimum_cost = initial_cost
        self.current_cost = initial_cost
        self.reference_cost = initial_cost
        self.candidate_cost = initial_cost
        self.accumulated_reference_model_cost_change = 0.0
        self.accumulated_candidate_model_cost_change = 0.0
        self.num_consecutive_nonmonotonic_steps = 0

    def step_quality(self, cost: float, model_cost_change: float) -> float:
        relative_decrease = (self.current_cost - cost) / model_cost_change
        historical_relative_decrease = (self.reference_cost - cost) / (
            self.accumulated_reference_model_cost_change + model_cost_change
        )
        return max(relative_decrease, historical_relative_decrease)

    def step_accepted(self, cost: float, model_cost_change: float):
        self.current_cost = cost
        self.accumulated_candidate_model_cost_change += model_cost_change
        self.accumulated_reference_model_cost_change += model_cost_change
        if self.current_cost < self.minimum_cost:
            self.minimum_cost = self.current_cost
            self.num_consecutive_nonmonotonic_steps = 0
            self.candidate_cost = self.current_cost
            self.accumulated_candidate_model_cost_change = 0.0
        else:
            self.num_consecutive_nonmonotonic_steps += 1
            if self.current_cost > self.candidate_cost:
                self.candidate_cost = self.current_cost
                self.accumulated_candidate_model_cost_change = 0.0
        if self.num_consecutive_nonmonotonic_steps == self.max_consecutive_nonmonotonic_steps:
            self.reference_cost = self.candidate_cost
            self.accumulated_reference_model_cost_change = (
                self.accumulated_candidate_model_cost_change
            )
