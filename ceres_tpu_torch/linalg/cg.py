"""Preconditioned conjugate gradients, generic over a matvec closure.

Port of `ceres_tpu.linalg.cg` (reference: conjugate_gradients_solver.h
:108-311) as written there: the loop's scalars (rho, beta, alpha, Q, zeta)
are 0-d tensors in the vectors' dtype, every branch is a `torch.where`, and
the iteration count, `done` and `breakdown` are device tensors. The JAX
package runs the loop as a `lax.while_loop`; here the host drives it and
reads one flag per iteration (`done`, through utils.graphs.read). The
iteration is masked: once `done` holds it changes nothing, so the first
iteration also covers the JAX loop's initial test and the result equals
stopping exactly at `done`.

Vectors are tensors or lists of tensors (the per-class "tvec" tables of
jacobian.py). Termination as in the reference: residual tolerance
|r| <= tol*|b|, the Q-based truncated-Newton test, max iterations, and
breakdown guards on rho and p'Ap.

With a `graph` (a utils.graphs.StepGraph, on CUDA tensors) the iteration is
captured once and replayed; the matvec and the preconditioner then read only
the `fixed` tensors, in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.graphs import read


class CGResult(NamedTuple):
    x: object
    iterations: torch.Tensor  # 0-d int32
    final_norm: torch.Tensor
    converged: torch.Tensor
    # stopped on a numerical breakdown (p'Ap <= 0 or rho == 0 with a
    # non-negligible residual) rather than on the regular criteria
    breakdown: torch.Tensor


def _leaves(a):
    return list(a) if isinstance(a, (list, tuple)) else [a]


def _tmap(f, *ts):
    if isinstance(ts[0], (list, tuple)):
        return [f(*xs) for xs in zip(*ts)]
    return f(*ts)


def _tvdot(a, b, batched=False):
    """a·b, or with `batched` one dot per row of the leading column axis."""
    pairs = zip(_leaves(a), _leaves(b))
    if batched:
        parts = [(x * y).reshape(x.shape[0], -1).sum(dim=1) for x, y in pairs]
    else:
        parts = [(x * y).sum() for x, y in pairs]
    return sum(parts[1:], parts[0])


def _tnorm(a, batched=False):
    return torch.sqrt(_tvdot(a, a, batched))


def _bc(s, x):
    """A loop scalar against a vector leaf: a 0-d scalar as it is, a
    per-column one [k] shaped to broadcast over the leaf's other axes."""
    return s if s.dim() == 0 else s.reshape(s.shape + (1,) * (x.dim() - 1))


def _tselect(cond, old, new):
    return _tmap(lambda o, n: torch.where(_bc(cond, o), o, n), old, new)


def _cg_step(matvec, prec, b, tol_r, state, min_iterations, q_tolerance, batched=False):
    """One masked PCG iteration (ceres_tpu/linalg/cg.py:96-143). With
    `batched` the vectors carry a leading column axis and every loop scalar
    is per column, as under jax.vmap of the JAX loop: a column that is done
    computes the body and changes nothing."""
    x, r, z_rho, p, q_prev, it, done, bd = state
    z = prec(r)
    rho_new = _tvdot(r, z, batched)
    first = it == 0
    beta = torch.where(first, 0.0, rho_new / torch.where(z_rho != 0, z_rho, 1.0))
    p_new = _tmap(lambda zz, pp: zz + _bc(beta, zz) * pp, z, p)
    ap = matvec(p_new)
    pap = _tvdot(p_new, ap, batched)
    alpha = torch.where(pap > 0, rho_new / torch.where(pap != 0, pap, 1.0), 0.0)
    x_new = _tmap(lambda xx, pp: xx + _bc(alpha, xx) * pp, x, p_new)
    r_new = _tmap(lambda rr, aa: rr - _bc(alpha, rr) * aa, r, ap)

    # Q-test (reference conjugate_gradients_solver.h:244-283): with
    # r = b - Ax, Q_i = -x·(b + r); terminate when
    # i * (Q_i - Q_{i-1}) / Q_i < q_tolerance (signed test)
    q_new = -_tvdot(x_new, _tmap(lambda bb, rr: bb + rr, b, r_new), batched)
    it_new = it + 1
    zeta = torch.where(
        q_new != 0,
        it_new.to(q_new.dtype) * (q_new - q_prev) / torch.where(q_new != 0, q_new, 1.0),
        float("inf"),
    )
    enough = it_new >= min_iterations
    done_q = enough & (zeta < q_tolerance) if q_tolerance > 0 else torch.zeros_like(done)
    done_r = enough & (_tnorm(r_new, batched) <= tol_r)
    done_breakdown = ((pap <= 0) | (rho_new == 0)) & ~done_r
    done_new = done_q | done_r | done_breakdown
    return (
        _tselect(done, x, x_new),
        _tselect(done, r, r_new),
        torch.where(done, z_rho, rho_new),
        _tselect(done, p, p_new),
        torch.where(done, q_prev, q_new),
        torch.where(done, it, it_new),
        done | done_new,
        bd | (done_breakdown & ~done),
    )


def conjugate_gradients(
    matvec: Callable,
    b,
    x0=None,
    preconditioner: Optional[Callable] = None,
    max_iterations: int = 500,
    min_iterations: int = 0,
    tolerance: float = 1e-9,
    q_tolerance: float = 0.0,
    graph=None,
    fixed=(),
    batched: bool = False,
) -> CGResult:
    """Solve A x = b with PCG; A must be SPD (as an operator).

    tolerance: stop when |r| <= tolerance * |b| (reference :214-233).
    q_tolerance: stop when i * (Q_i - Q_{i-1}) / Q_i < q_tolerance with
      Q(x) = -x'(b + r) (reference :240-270).
    graph: a StepGraph (CUDA only); the iteration then runs from its
      capture, and `fixed` lists every tensor matvec and preconditioner read.
    batched: k systems at once, b (and every vector) with a leading column
      axis of k, matvec and preconditioner mapping [k, ...] to [k, ...]; the
      result's x is [k, ...] and its scalars are [k]. Each column equals
      its own solve (jax.vmap of the JAX loop, covariance.py:212). It runs
      eagerly: a graph step is not batched.

    The host reads `done` (with `batched`: whether every column is done)
    after every iteration but the last allowed one: at most
    max(iterations, 1) reads.
    """
    if batched and graph is not None:
        raise ValueError("conjugate_gradients: a batched PCG runs without a graph")
    x0 = _tmap(torch.zeros_like, b) if x0 is None else x0
    prec = preconditioner if preconditioner is not None else (lambda r: r)
    first = _leaves(b)[0]
    dtype, dev = first.dtype, first.device
    shape = first.shape[:1] if batched else ()

    tol_r = tolerance * _tnorm(b, batched)
    r0 = _tmap(lambda bb, ax: bb - ax, b, matvec(x0))
    state = (
        x0,
        r0,
        torch.zeros(shape, dtype=dtype, device=dev),
        _tmap(torch.zeros_like, b),
        torch.zeros(shape, dtype=dtype, device=dev),
        torch.zeros(shape, dtype=torch.int32, device=dev),
        _tnorm(r0, batched) <= tol_r,
        torch.zeros(shape, dtype=torch.bool, device=dev),
    )

    if graph is None:
        def step(s):
            return _cg_step(matvec, prec, b, tol_r, s, min_iterations, q_tolerance, batched)
    else:
        step, state, hand_out = _graph_step(
            graph, fixed, matvec, prec, state, b, tol_r, min_iterations, q_tolerance
        )
    for k in range(max_iterations):
        state = step(state)
        done = state[6].all() if batched else state[6]
        if k + 1 < max_iterations and bool(read(done)):
            break
    if graph is not None:
        state = hand_out()

    x, r, _, _, _, it, _, bd = state
    final_norm = _tnorm(r, batched)
    return CGResult(x=x, iterations=it, final_norm=final_norm,
                    converged=final_norm <= tol_r, breakdown=bd)


def _graph_step(graph, fixed, matvec, prec, state, b, tol_r, min_iterations, q_tolerance):
    """The iteration as a replay of the StepGraph, whose state holds the
    CG state's leaves, then b and tol_r (which the iteration reads and
    leaves as they are). Returns (step, the graph's state as a CG state,
    hand_out: copies of it, since the graph's state belongs to the graph)."""
    is_list = isinstance(b, (list, tuple))
    nv = len(_leaves(b))

    def vec(ts):
        return list(ts) if is_list else ts[0]

    def flat(s):
        x, r, rho, p, q, it, done, bd = s
        return _leaves(x) + _leaves(r) + [rho] + _leaves(p) + [q, it, done, bd]

    def unflat(f):
        return (vec(f[:nv]), vec(f[nv:2 * nv]), f[2 * nv], vec(f[2 * nv + 1:3 * nv + 1]),
                *f[3 * nv + 1:3 * nv + 5])

    n_state = 3 * nv + 5
    static = graph.load(
        list(fixed), flat(state) + _leaves(b) + [tol_r], key=(min_iterations, q_tolerance)
    )
    b_s, tol_s = vec(static[n_state:-1]), static[-1]

    def flat_step(f):
        new = _cg_step(matvec, prec, b_s, tol_s, unflat(f[:n_state]), min_iterations, q_tolerance)
        return flat(new) + f[n_state:]

    def step(s):
        graph.step(flat_step)
        return s

    return step, unflat(static[:n_state]), lambda: unflat([t.clone() for t in static[:n_state]])
