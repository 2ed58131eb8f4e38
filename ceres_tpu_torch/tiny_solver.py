"""TinySolver: a self-contained dense Levenberg-Marquardt for small problems.

Port of `ceres_tpu.tiny_solver` (reference: tiny_solver.h). The JAX package
compiles the solve into one `lax.while_loop` and vmaps it over a batch of
starts (`tiny_solve_batched`, its multistart solver). Here the LM iteration
is one function of the state with the batch axis written out: the residual
and its Jacobian come from `torch.func.vmap` over `torch.func.jacfwd` of the
user's residual function, and the normal equations of every lane are solved
by one batched `torch.linalg.solve_ex`. A lane that is done is frozen, as
under jax.vmap of the while loop: it computes the body and keeps its state,
so its x, cost, iterations and converged are those of its own solve. The
host reads one flag per iteration (whether any lane is still active,
through utils.graphs.read); nothing else leaves the device until the
caller reads the result. `tiny_solve` is the same loop on a batch of one.

Where a lane's damped normal matrix is singular, jnp.linalg.solve returns
inf or NaN and the step is rejected; torch.linalg.solve would raise on the
CPU, so the step of a lane whose factorization fails is NaN, and rejected
the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, vmap

from .utils.dtypes import resolve_device
from .utils.graphs import read


@dataclasses.dataclass(frozen=True)
class TinySolverOptions:
    max_num_iterations: int = 50
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    function_tolerance: float = 1e-6
    initial_trust_region_radius: float = 1e4


class TinySolverResult(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor
    iterations: torch.Tensor  # int32
    converged: torch.Tensor  # bool


def _sq(r):
    return 0.5 * (r * r).sum(dim=-1)


def _lm_step(residual_fn, options, x, cost, radius):
    """One LM iteration of every lane (ceres_tpu/tiny_solver.py:55-99):
    x [B, p], cost and radius [B] -> (x, cost, radius, done) after it."""

    def value_twice(v):  # the residual as jacfwd's output and as its aux
        r = residual_fn(v)
        return r, r

    jac, r = vmap(jacfwd(value_twice, has_aux=True))(x)
    jt = jac.mT
    g = (jt @ r[..., None])[..., 0]
    jtj = jt @ jac
    diag = torch.diagonal(jtj, dim1=-2, dim2=-1).clamp(1e-6, 1e32)
    a = jtj + torch.diag_embed(diag) / radius[:, None, None]
    sol, info = torch.linalg.solve_ex(a, g)
    step = -torch.where((info == 0)[:, None], sol, torch.full_like(sol, float("nan")))
    m_new = (jac @ step[..., None])[..., 0]
    model_cost_change = -((m_new * r).sum(dim=-1) + 0.5 * (m_new * m_new).sum(dim=-1))

    x_new = x + step
    cost_new = _sq(vmap(residual_fn)(x_new))
    positive = model_cost_change > 0
    rho = (cost - cost_new) / torch.where(positive, model_cost_change, 1.0)
    accept = positive & (rho > 1e-3) & torch.isfinite(cost_new)

    radius_up = radius / torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
    radius_new = torch.where(accept, torch.clamp_max(radius_up, 1e16), radius / 2.0)
    x_out = torch.where(accept[:, None], x_new, x)
    cost_out = torch.where(accept, cost_new, cost)

    g_done = g.abs().amax(dim=-1) <= options.gradient_tolerance
    step_done = accept & (
        torch.linalg.vector_norm(step, dim=-1)
        <= options.parameter_tolerance
        * (torch.linalg.vector_norm(x, dim=-1) + options.parameter_tolerance)
    )
    f_done = accept & ((cost - cost_new).abs() <= options.function_tolerance * cost)
    r_done = radius_new < 1e-32
    return x_out, cost_out, radius_new, g_done | step_done | f_done | r_done


def _start(x0, device):
    if device is None and isinstance(x0, torch.Tensor):
        return x0
    dtype = x0.dtype if isinstance(x0, torch.Tensor) else torch.float64
    return torch.as_tensor(x0, dtype=dtype, device=resolve_device(device))


def tiny_solve_batched(
    residual_fn: Callable, x0_batch, options: TinySolverOptions = TinySolverOptions(), device=None
) -> TinySolverResult:
    """Solve B independent problems min 0.5 |r(x)|^2 from the starts x0_batch
    [B, p]; residual_fn maps one x [p] to its residuals [m] (torch
    operations that torch.func can vmap). On x0_batch's device when it is a
    tensor and no device is named, else on `device` (by default the card)."""
    x = _start(x0_batch, device)
    b = x.shape[0]
    cost = _sq(vmap(residual_fn)(x)) if b else x.new_zeros((0,))
    radius = torch.full((b,), options.initial_trust_region_radius, dtype=x.dtype, device=x.device)
    it = torch.zeros((b,), dtype=torch.int32, device=x.device)
    done = torch.zeros((b,), dtype=torch.bool, device=x.device)
    active = ~done
    for _ in range(options.max_num_iterations if b else 0):
        if not bool(read(active.any())):
            break
        x_n, cost_n, radius_n, done_n = _lm_step(residual_fn, options, x, cost, radius)
        x = torch.where(active[:, None], x_n, x)
        cost = torch.where(active, cost_n, cost)
        radius = torch.where(active, radius_n, radius)
        done = torch.where(active, done_n, done)
        it = it + active.to(torch.int32)
        active = (it < options.max_num_iterations) & ~done
    return TinySolverResult(x=x, cost=cost, iterations=it, converged=done)


def tiny_solve(
    residual_fn: Callable, x0, options: TinySolverOptions = TinySolverOptions(), device=None
) -> TinySolverResult:
    """Minimize 0.5 |r(x)|^2 for one small dense problem from x0 [p]: the
    batched loop on a batch of one."""
    res = tiny_solve_batched(residual_fn, _start(x0, device)[None], options)
    return TinySolverResult(*(t[0] for t in res))


def cost_function_adapter(cost, data=()):
    """A single-block CostFunction as a tiny_solve residual function
    (reference: tiny_solver_cost_function_adapter.h)."""

    def residual_fn(x):
        return cost.fn((x,), data)

    return residual_fn
