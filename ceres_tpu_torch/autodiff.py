"""Forward-mode autodiff of cost functors, batched per signature group.

Port of `ceres_tpu.autodiff`: a cost functor is a plain PyTorch function

    fn(params: tuple[Tensor, ...], data: tuple[Tensor, ...]) -> Tensor[r]

written for ONE residual block. `torch.func.jacfwd` pushes one basis
tangent per parameter coordinate (the Jet<double, N> evaluation of the
reference, autodiff.h:318) and `torch.func.vmap` batches it over every
block of a signature group. This path serves every functor that has no
hand-written kernel; the Snavely functor has one (eval_kernel.py), chosen
by the `kernel` tag of its CostFunction.

A functor may carry its own Jacobian rule instead (`RuleFunctor`:
`analytic_diff` / `AnalyticCostFunction` with the user's closed forms,
`numeric_diff` / `NumericDiffCostFunction` with finite differences), the
port of the JAX package's `custom_jvp` wrappers: every torch.func
transform, and on a card B1 generic's generator, applies the rule.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jacfwd, vmap


def value_and_jacobians(fn: Callable, params: tuple, data: tuple):
    """(residuals [r], tuple of Jacobians [r, size_i]) for one block."""
    k = len(params)

    def f(*ps):
        out = fn(ps, data)
        return out, out

    jacs, res = jacfwd(f, argnums=tuple(range(k)), has_aux=True)(*params)
    # forward mode can promote tangents past the primal dtype (a 0-d select
    # combined with a Python float yields float64); the Jacobian takes the
    # residual's dtype
    return res, tuple(j.to(res.dtype) for j in jacs)


def batched_value_and_jacobians(fn: Callable, params: tuple, data: tuple):
    """vmap of `value_and_jacobians` over a batch of residual blocks.

    params: tuple of [n, size_i]; data: tuple of [n, ...].
    Returns (residuals [n, r], tuple of Jacobians [n, r, size_i]).
    """
    return vmap(lambda ps, d: value_and_jacobians(fn, ps, d))(params, data)


def batched_values(fn: Callable, params: tuple, data: tuple):
    """vmap residual-only evaluation: returns [n, r]."""
    return vmap(lambda ps, d: fn(ps, d))(params, data)


class CostFunction:
    """A residual functor with a static residual count.

    `kernel` names a hand-written CUDA evaluation kernel for this functor
    (e.g. "snavely", eval_kernel.py). The evaluator launches it for groups
    it is eligible for and runs the torch.func path otherwise. `rule` says
    which Jacobian rule the functor carries: None (torch.func
    differentiates it), "analytic" or "numeric" (fn a RuleFunctor, or an
    adapter of cost_functions.py around one, which passes it on). It
    describes the functor; the generator decides from its trace alone.
    """

    def __init__(
        self,
        fn: Callable,
        num_residuals: int,
        name: Optional[str] = None,
        kernel: Optional[str] = None,
        rule: Optional[str] = None,
    ):
        if num_residuals <= 0:
            raise ValueError("num_residuals must be static and positive")
        self.fn = fn
        self.num_residuals = int(num_residuals)
        self.name = name or getattr(fn, "__name__", "cost")
        self.kernel = kernel
        self.rule = fn.kind if isinstance(fn, RuleFunctor) else rule

    def __call__(self, params, data):
        return self.fn(params, data)


# ---------------------------------------------------------------------- #
# functors that carry their own Jacobian rule
# ---------------------------------------------------------------------- #


class RuleFunctor:
    """A functor fn(params, data) -> [r] with its own Jacobian rule, the
    port of the `jax.custom_jvp` wrappers of ceres_tpu/autodiff.py
    (`numeric_diff` :95, `analytic_diff` :203). `jacobians(params, data)`
    returns one [r, size_i] Jacobian per parameter block; the data get no
    derivative. Called, it runs `_RuleFn`, so torch.func's jacfwd, vmap and
    grad (evaluator.evaluate_batch, gradient_problem.py,
    gradient_checker.py) all go through the rule, never through fn.

    `kind` is "analytic" or "numeric". While functor_codegen traces a
    functor (`functor_codegen.generating()`), an analytic rule registers
    itself as one node of the trace, whose Jet output is (fn(x.a),
    sum_k jac(x.a)[:, k] x_k.v), and a numeric rule raises Ineligible:
    the group then takes the torch.func path, as JAX's group_kernel
    returns None for it."""

    def __init__(self, fn: Callable, jacobians: Callable, kind: str):
        self.fn = fn
        self._jacobians = jacobians
        self.kind = kind
        self.__name__ = getattr(fn, "__name__", "rule")

    def jacobians(self, params, data, num_residuals):
        """The rule's Jacobians, shape-checked as JAX's analytic_diff does."""
        jacs = self._jacobians(params, data)
        if len(jacs) != len(params):
            raise ValueError(
                f"jac returned {len(jacs)} Jacobians for {len(params)} parameter blocks"
            )
        out = []
        for i, (j, p) in enumerate(zip(jacs, params)):
            j = j if isinstance(j, torch.Tensor) else torch.as_tensor(j, dtype=p.dtype,
                                                                      device=p.device)
            expect = (num_residuals, p.shape[0])
            if tuple(j.shape) != expect:
                raise ValueError(
                    f"analytic Jacobian for parameter block {i} has shape {tuple(j.shape)}; "
                    f"expected [num_residuals, block_size] = {expect}"
                )
            out.append(j)
        return out

    def __call__(self, params, data=()):
        from . import functor_codegen

        params, data = tuple(params), tuple(data)
        if functor_codegen.generating():
            if self.kind != "analytic":
                raise functor_codegen.Ineligible(f"a {self.kind} Jacobian rule")
            return functor_codegen.rule_call(self, params, data)
        return _RuleFn.apply(self, len(params), *params, *data)


class _RuleFn(torch.autograd.Function):
    """fn(params, data) whose forward-mode tangent is sum_i J_i t_i and
    whose backward is J_iᵀ g, with J_i the rule's Jacobians at the primal
    (the data's tangents are dropped, as JAX's rules drop them)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(rule, k, *args):
        return rule.fn(tuple(args[:k]), tuple(args[k:]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        rule, k, *args = inputs
        ctx.rule, ctx.k = rule, k
        ctx.num_residuals = int(output.shape[0]) if output.ndim else 1
        ctx.save_for_forward(*args)
        ctx.save_for_backward(*args)

    @staticmethod
    def _jacobians(ctx):
        args = ctx.saved_tensors
        return ctx.rule.jacobians(tuple(args[: ctx.k]), tuple(args[ctx.k :]), ctx.num_residuals)

    @staticmethod
    def jvp(ctx, _rule_t, _k_t, *tangents):
        out = None
        for j, t in zip(_RuleFn._jacobians(ctx), tangents[: ctx.k]):
            if t is None:
                continue
            term = j @ t
            out = term if out is None else out + term
        if out is None:
            out = ctx.saved_tensors[0].new_zeros((ctx.num_residuals,))
        return out

    @staticmethod
    def backward(ctx, grad_output):
        jacs = _RuleFn._jacobians(ctx)
        n_data = len(ctx.saved_tensors) - ctx.k
        return (None, None, *(j.T @ grad_output for j in jacs), *([None] * n_data))


def numeric_diff(
    fn: Callable,
    method: str = "CENTRAL",
    relative_step_size: float = 1e-6,
    min_step_size: float = 1e-12,
    ridders_extrapolations: int = 10,
    ridders_epsilon: float = 1e-12,
    ridders_step_shrink: float = 2.0,
) -> RuleFunctor:
    """fn whose Jacobian is finite differences: ceres_tpu/autodiff.py:95
    (reference: numeric_diff_cost_function.h, internal/numeric_diff.h), the
    arithmetic in JAX's order: per coordinate step = max(rel |p|,
    min_step); FORWARD evaluates f0 once; RIDDERS extrapolates central
    differences from h0 = 8 step, shrinking by `ridders_step_shrink`, over
    `ridders_extrapolations` rows (ridders_epsilon is accepted and unused,
    as in JAX)."""
    method = method.upper()
    if method not in ("CENTRAL", "FORWARD", "RIDDERS"):
        raise ValueError(f"unknown numeric diff method {method}")

    def jac_fd(params, data):
        jacs = []
        f0 = fn(params, data) if method == "FORWARD" else None
        for i, p in enumerate(params):
            step = torch.clamp_min(relative_step_size * p.abs(), min_step_size)
            eye = torch.eye(p.shape[0], dtype=p.dtype, device=p.device)

            def at(h_vec, i=i, p=p):
                return params[:i] + (p + h_vec,) + params[i + 1 :]

            def col(j, eye=eye, step=step, at=at):
                dp = eye[j] * step[j]
                if method == "FORWARD":
                    return (fn(at(dp), data) - f0) / step[j]
                if method == "CENTRAL":
                    return (fn(at(dp), data) - fn(at(-dp), data)) / (2.0 * step[j])

                # RIDDERS: Richardson extrapolation of central differences
                # (numeric_diff.h EvaluateRiddersJacobianColumn)
                def central(h):
                    dpj = eye[j] * h
                    return (fn(at(dpj), data) - fn(at(-dpj), data)) / (2.0 * h)

                h = step[j] * 8.0
                tableau = [central(h)]
                fac = ridders_step_shrink * ridders_step_shrink
                for k in range(1, ridders_extrapolations):
                    h = h / ridders_step_shrink
                    row = [central(h)]
                    f = fac
                    for m in range(k):
                        row.append((row[m] * f - tableau[m]) / (f - 1.0))
                        f = f * fac
                    tableau = row
                return tableau[-1]

            jacs.append(torch.stack([col(j) for j in range(p.shape[0])], dim=1))
        return jacs

    return RuleFunctor(fn, jac_fd, "numeric")


def analytic_diff(fn: Callable, jac: Callable) -> RuleFunctor:
    """fn with user-supplied closed-form Jacobians: ceres_tpu/autodiff.py:203
    (reference: sized_cost_function.h, helloworld_analytic_diff.cc).
    `jac(params, data)` returns one [num_residuals, block_size] tensor per
    parameter block."""
    return RuleFunctor(fn, jac, "analytic")


class AnalyticCostFunction(CostFunction):
    """CostFunction with user-supplied analytic Jacobians
    (ceres_tpu/autodiff.py:249; reference: sized_cost_function.h):
    `jac(params, data)` returns one [num_residuals, block_size] tensor per
    parameter block. On a card its group runs B1 generic with the rule."""

    def __init__(self, fn: Callable, jac: Callable, num_residuals: int,
                 name: Optional[str] = None):
        super().__init__(analytic_diff(fn, jac), num_residuals,
                         name=name or getattr(fn, "__name__", "analytic_cost"))


class NumericDiffCostFunction(CostFunction):
    """CostFunction differentiated by finite differences
    (ceres_tpu/autodiff.py:271; reference: numeric_diff_cost_function.h,
    CENTRAL / FORWARD / RIDDERS). Its group takes the torch.func path."""

    def __init__(self, fn: Callable, num_residuals: int, method: str = "CENTRAL",
                 relative_step_size: float = 1e-6, name: Optional[str] = None):
        super().__init__(numeric_diff(fn, method=method, relative_step_size=relative_step_size),
                         num_residuals, name=name or getattr(fn, "__name__", "numeric_cost"))
