"""Cost-function adapters and stock cost functions.

Port of `ceres_tpu.cost_functions` (reference: normal_prior.h,
conditioned_cost_function.h, cost_function_to_functor.h). Each adapter
is function composition: a wrapped functor that carries a Jacobian rule
(an AnalyticCostFunction's or a NumericDiffCostFunction's) keeps it, as
the JAX package's custom_jvp sits inside the wrapped fn. On a card the
generator lowers an analytic rule inside such a wrapper as a node of its
own (functor_codegen.op_rule_call); a numeric one makes the group take
the torch.func path.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .autodiff import CostFunction


def normal_prior(a, b) -> CostFunction:
    """residual = A (x - b): Mahalanobis prior with stiffness matrix A
    (reference: normal_prior.h; A need not be square)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("A must be [k, n] and b [n]")
    at, bt = torch.tensor(a), torch.tensor(b)

    def fn(params, data):
        (x,) = params
        return at.to(x) @ (x - bt.to(x))

    return CostFunction(fn, int(a.shape[0]), name="normal_prior")


def conditioned_cost_function(
    wrapped: CostFunction, conditioners: Sequence[Callable]
) -> CostFunction:
    """r_i' = c_i(r_i), one scalar conditioner per residual (None for the
    identity); reference: conditioned_cost_function.h."""
    if len(conditioners) != wrapped.num_residuals:
        raise ValueError("need one conditioner per residual")

    def fn(params, data):
        r = wrapped.fn(params, data)
        return torch.stack([r[i] if c is None else c(r[i]) for i, c in enumerate(conditioners)])

    return CostFunction(fn, wrapped.num_residuals, name=f"conditioned_{wrapped.name}",
                        rule=wrapped.rule)


def cost_function_to_functor(cost: CostFunction) -> Callable:
    """An existing CostFunction used inside another functor
    (reference: cost_function_to_functor.h): calling it."""

    def functor(params, data=()):
        return cost.fn(tuple(params), data)

    return functor


def scaled_cost_function(wrapped: CostFunction, s: float) -> CostFunction:
    """Residuals multiplied by a constant scale."""

    def fn(params, data):
        return s * wrapped.fn(params, data)

    return CostFunction(fn, wrapped.num_residuals, name=f"scaled_{wrapped.name}",
                        rule=wrapped.rule)
