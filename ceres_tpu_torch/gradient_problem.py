"""First-order (general unconstrained) optimization API.

Port of `ceres_tpu.gradient_problem` (reference: gradient_problem.h,
gradient_problem_solver.cc, first_order_function.h,
autodiff_first_order_function.h). The user writes one scalar PyTorch
function f(x) of one tensor; torch.func.grad_and_value gives its gradient
(the role of AutoDiffFirstOrderFunction's Jet evaluation), the manifold
gives the retraction, and the line-search driver (solvers/line_search.py)
runs LBFGS, BFGS, NCG or steepest descent.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad_and_value

from .manifolds import EuclideanManifold, Manifold
from .types import MinimizerType, Summary
from .utils.dtypes import default_dtype, resolve_device
from .utils.execution_summary import counts


class GradientProblem:
    """min_x f(x) with an optional manifold on x (reference:
    gradient_problem.h)."""

    def __init__(self, f: Callable, manifold: Optional[Manifold] = None, size: int = None):
        self.f = f
        self.manifold = manifold
        if manifold is None and size is None:
            raise ValueError("provide `size` when no manifold is given")
        self.size = manifold.ambient_size if manifold is not None else int(size)

    @property
    def tangent_size(self) -> int:
        return self.manifold.tangent_size if self.manifold is not None else self.size


def solve_gradient_problem(options, problem: GradientProblem, x0) -> tuple:
    """Minimize; returns (x as numpy, Summary). On the card unless
    `options.device` names another device (RuntimeError when none is
    visible). reference: GradientProblemSolver::Solve."""
    from .solvers.line_search import LineSearchDriver

    total_start = time.time()
    summary = Summary()
    summary.minimizer_type = MinimizerType.LINE_SEARCH
    summary.line_search_direction_type = options.line_search_direction_type
    summary.num_parameters = problem.size
    summary.num_effective_parameters = problem.tangent_size

    device = resolve_device(options.device)
    dtype = options.dtype or default_dtype()
    x0 = torch.as_tensor(np.asarray(x0, dtype=np.float64), dtype=dtype, device=device)
    f = problem.f
    manifold = problem.manifold

    if manifold is None or isinstance(manifold, EuclideanManifold):
        def grad_fn(x):
            g, c = grad_and_value(f)(x)
            return c, g

        def plus_fn(x, step):
            return x + step
    else:
        def grad_fn(x):
            g, c = grad_and_value(f)(x)
            # the tangent gradient PlusJacobian(x)ᵀ g (gradient_problem.cc)
            return c, manifold.plus_jacobian(x).T @ g

        plus_fn = manifold.plus

    before = counts()
    driver = LineSearchDriver(options, f, grad_fn, plus_fn, problem.tangent_size)
    x = driver.minimize(x0, summary)
    summary.num_device_reads = (counts() - before)["Device::Read"]
    summary.total_time_in_seconds = time.time() - total_start
    summary.minimizer_time_in_seconds = summary.total_time_in_seconds
    return x.detach().cpu().numpy(), summary


class _NumericFirstOrder(torch.autograd.Function):
    """f(x) whose gradient is finite differences: the backward (and vmap)
    rule of numeric_diff_first_order."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, f, method, relative_step_size, min_step_size):
        return f(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, f, method, relative_step_size, min_step_size = inputs
        ctx.save_for_backward(x)
        ctx.f, ctx.method = f, method
        ctx.steps = (relative_step_size, min_step_size)

    @staticmethod
    def backward(ctx, grad_output):
        (x,) = ctx.saved_tensors
        return grad_output * _fd_gradient(ctx.f, x, ctx.method, *ctx.steps), None, None, None, None


def _fd_gradient(f, x, method, relative_step_size, min_step_size):
    """The forward or central difference gradient of f at x
    (ceres_tpu/gradient_problem.py:110-125)."""
    x = x.detach()
    v = f(x)
    step = torch.clamp_min(relative_step_size * x.abs(), min_step_size)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    cols = []
    for i in range(x.shape[0]):
        e = eye[i] * step[i]
        if method == "FORWARD":
            cols.append((f(x + e) - v) / step[i])
        else:
            cols.append((f(x + e) - f(x - e)) / (2.0 * step[i]))
    return torch.stack(cols)


def numeric_diff_first_order(
    f: Callable,
    method: str = "CENTRAL",
    relative_step_size: float = 1e-6,
    min_step_size: float = 1e-12,
):
    """Wrap a scalar objective so that its gradient is finite differences
    (reference: numeric_diff_first_order_function.h), for objectives the
    autodiff cannot differentiate. The wrapped function is a drop-in
    GradientProblem objective: its backward rule returns the
    finite-difference gradient, so grad_and_value works unchanged (the JAX
    package's custom_jvp)."""
    method = method.upper()
    if method not in ("CENTRAL", "FORWARD"):
        raise ValueError(f"unknown numeric diff method {method}")

    def wrapped(x):
        return _NumericFirstOrder.apply(x, f, method, relative_step_size, min_step_size)

    return wrapped
