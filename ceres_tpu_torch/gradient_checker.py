"""Gradient checking: autodiff against numeric derivatives of cost functors.

Port of `ceres_tpu.gradient_checker` (reference: gradient_checker.cc,
gradient_checking_cost_function.cc; wired through
Solver::Options::check_gradients, solver.cc:765-775). The port's autodiff
is torch.func's, so a mismatch names a functor that torch.func does not
differentiate right at the point: a custom autograd rule that is wrong, a
non-smooth branch. The probe runs on the host in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .autodiff import CostFunction, value_and_jacobians


@dataclasses.dataclass
class GradientCheckResult:
    ok: bool
    max_relative_error: float
    jacobians: list  # autodiff, per parameter block (tangent space)
    numeric_jacobians: list
    error_log: str = ""


def check_gradients(
    cost_function: CostFunction,
    params: list,
    data: tuple = (),
    manifolds: list = None,
    relative_step_size: float = 1e-6,
    relative_precision: float = 1e-8,
) -> GradientCheckResult:
    """Compare the functor's autodiff Jacobians with central differences,
    in the tangent space of each block (reference: GradientChecker::Probe)."""
    params = [torch.as_tensor(np.asarray(p, dtype=np.float64)) for p in params]
    data = tuple(torch.as_tensor(np.asarray(d)) for d in data)
    k = len(params)
    manifolds = manifolds or [None] * k

    _, jacs_ad = value_and_jacobians(cost_function.fn, tuple(params), data)
    jacs_ad = list(jacs_ad)
    for i, m in enumerate(manifolds):
        if m is not None:
            jacs_ad[i] = jacs_ad[i] @ m.plus_jacobian(params[i])

    numeric = []
    for i, m in enumerate(manifolds):
        tsize = m.tangent_size if m is not None else params[i].shape[0]
        cols = []
        for j in range(tsize):
            step = relative_step_size * max(
                float(params[i][j].abs()) if m is None else 1.0, 1.0
            )
            d = torch.zeros(tsize, dtype=torch.float64)
            d[j] = step
            if m is None:
                pp, pm = params[i] + d, params[i] - d
            else:
                pp, pm = m.plus(params[i], d), m.plus(params[i], -d)
            fp = cost_function.fn(tuple(params[:i] + [pp] + params[i + 1:]), data)
            fm = cost_function.fn(tuple(params[:i] + [pm] + params[i + 1:]), data)
            cols.append((fp.numpy() - fm.numpy()) / (2 * step))
        numeric.append(np.stack(cols, axis=1))

    max_rel = 0.0
    log_lines = []
    for i in range(k):
        a = jacs_ad[i].numpy()
        n = numeric[i]
        denom = np.maximum(np.abs(a), np.abs(n))
        denom = np.where(denom > 0, denom, 1.0)
        rel = np.abs(a - n) / denom
        # entries near zero are held absolutely
        rel = np.where(np.maximum(np.abs(a), np.abs(n)) < 1e-10, 0.0, rel)
        worst = float(rel.max()) if rel.size else 0.0
        max_rel = max(max_rel, worst)
        if worst > relative_precision:
            log_lines.append(
                f"parameter block {i}: max relative error {worst:.3e}\n"
                f"autodiff:\n{a}\nnumeric:\n{n}"
            )

    return GradientCheckResult(
        ok=max_rel <= relative_precision,
        max_relative_error=max_rel,
        jacobians=[j.numpy() for j in jacs_ad],
        numeric_jacobians=numeric,
        error_log="\n".join(log_lines),
    )
