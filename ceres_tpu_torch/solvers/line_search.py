"""Line-search minimization: directions, step-size search, outer loop.

Port of `ceres_tpu.solvers.line_search` (reference: line_search_minimizer.cc,
line_search.cc, line_search_direction.cc, low_rank_inverse_hessian.cc):
STEEPEST_DESCENT, NONLINEAR_CONJUGATE_GRADIENT (Fletcher-Reeves,
Polak-Ribiere, Hestenes-Stiefel, with restarts), LBFGS (the two-loop
recursion) and BFGS (a dense [n, n] inverse Hessian, as in the JAX
package), under ARMIJO backtracking or the strong WOLFE search with
zoom, and BISECTION, QUADRATIC or CUBIC interpolation.

The arithmetic is the JAX driver's, in the same order. What differs is
where the scalars live: the JAX driver brings one to the host at every
`float(jnp.vdot(...))`, two per history pair of the two-loop. Here the
direction's scalars stay 0-d tensors on the state's device (the two-loop's
alpha and beta, the scaling gamma, NCG's beta, BFGS's rho and its update),
and the host reads only what its control flow needs, each through
utils.graphs.read (counted): phi'(0) of the direction (its sign restarts
the direction, its value sets the first trial step), every trial's f (and
phi' under WOLFE), and one stack at the end of the iteration (the
gradient's max and norm, the step's norm, the state's norm and the
curvature s'y whose sign decides the L-BFGS / BFGS update). That is
2 + trials reads per iteration, one more on a restart.

The oracle is cost_fn(x) -> 0-d tensor, grad_fn(x) -> (cost, gradient)
and plus_fn(x, step) -> x: `LineSearchMinimizer` serves NLLS problems
from the Evaluator (the gradient from the trust-region loop's `evaluate`,
a CUDA graph on a card), gradient_problem.py serves first-order problems.
A graph rewrites its outputs at every replay, so the driver keeps a copy
of every gradient it holds on to (the current one, hence the previous one
and the L-BFGS pairs made from it).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..types import (
    CallbackReturnType,
    IterationSummary,
    LineSearchDirectionType,
    LineSearchType,
    NonlinearConjugateGradientType,
    TerminationType,
)
from ..utils.execution_summary import counts, span
from ..utils.graphs import read
from .polynomial import FunctionSample, minimize_interpolating_polynomial


class _LBFGSMemory:
    """Two-loop recursion state (low_rank_inverse_hessian.cc); every pair's
    curvature s'y is a 0-d device tensor."""

    def __init__(self, max_rank: int, use_eigenvalue_scaling: bool):
        self.max_rank = max_rank
        self.use_eigenvalue_scaling = use_eigenvalue_scaling
        self.s_list: list = []

    def update(self, s, y, sy, sy_host: float):
        """Add the pair (s, y) unless its host-read curvature would break
        positive definiteness."""
        if sy_host <= 1e-14:
            return
        if len(self.s_list) >= self.max_rank:
            self.s_list.pop(0)
        self.s_list.append((s, y, sy))

    def apply(self, g):
        """H g by the two-loop recursion, with no host read."""
        q = g
        alphas = []
        for s, y, sy in reversed(self.s_list):
            alpha = torch.dot(s, q) / sy
            q = q - alpha * y
            alphas.append(alpha)
        if self.s_list and self.use_eigenvalue_scaling:
            # gamma = s'y / y'y (low_rank_inverse_hessian.cc:134-160)
            s, y, sy = self.s_list[-1]
            q = (sy / torch.dot(y, y)) * q
        for (s, y, sy), alpha in zip(self.s_list, reversed(alphas)):
            beta = torch.dot(y, q) / sy
            q = q + (alpha - beta) * s
        return q


def _interpolate_step(a_lo, f_lo, g_lo, a_hi, f_hi, interpolation: str, g_hi=None,
                      extra_sample=None):
    """Minimizer of the interpolating polynomial on [lo, hi], 5% inside
    each end (ceres_tpu/solvers/line_search.py:81-128; reference:
    line_search.cc:415-470). BISECTION takes the midpoint; QUADRATIC fits
    phi(lo), phi'(lo), phi(hi); CUBIC adds phi'(hi) when there is one, or
    else a third value sample."""
    if interpolation == "BISECTION" or not np.isfinite(f_hi):
        return 0.5 * (a_lo + a_hi)
    samples = [FunctionSample.with_gradient(a_lo, f_lo, g_lo)]
    if interpolation == "CUBIC" and g_hi is not None and np.isfinite(g_hi):
        samples.append(FunctionSample.with_gradient(a_hi, f_hi, g_hi))
    else:
        samples.append(FunctionSample.valued(a_hi, f_hi))
        if interpolation == "CUBIC" and extra_sample is not None and np.isfinite(extra_sample[1]):
            samples.append(FunctionSample.valued(extra_sample[0], extra_sample[1]))
    lo, hi = min(a_lo, a_hi), max(a_lo, a_hi)
    span = hi - lo
    x, _ = minimize_interpolating_polynomial(samples, lo + 0.05 * span, hi - 0.05 * span)
    return float(x)


class LineSearchDriver:
    """Minimize by line search given the cost, gradient and plus oracles
    (see the module docstring)."""

    def __init__(self, options, cost_fn, grad_fn, plus_fn, num_tangent: int):
        self.options = options
        self.cost_fn = cost_fn
        self.grad_fn = grad_fn
        self.plus_fn = plus_fn
        self.num_tangent = num_tangent

    # -- step size search ----------------------------------------------- #

    def _phi(self, state, direction, alpha, summary):
        x = self.plus_fn(state, alpha * direction)
        summary.num_residual_evaluations += 1
        return read(self.cost_fn(x)).item(), x

    def _phi_grad(self, state, direction, alpha, summary):
        x = self.plus_fn(state, alpha * direction)
        c, g = self.grad_fn(x)
        summary.num_jacobian_evaluations += 1
        f, dphi = read(torch.stack([c.to(g.dtype), torch.dot(g, direction)])).tolist()
        return f, dphi, x, g

    def search(self, state, direction, cost, dphi0, initial_step, summary):
        """(alpha, new state, new cost, new gradient or None, trials), alpha
        None when the search fails (ceres_tpu/solvers/line_search.py:159-235)."""
        opts = self.options
        c1 = opts.line_search_sufficient_function_decrease
        interpolation = opts.line_search_interpolation_type.value
        trials = 0

        if opts.line_search_type == LineSearchType.ARMIJO:
            alpha = initial_step
            prev_trial = None  # the CUBIC fit's extra sample (line_search.cc:440-452)
            for _ in range(opts.max_num_line_search_step_size_iterations):
                f, x = self._phi(state, direction, alpha, summary)
                trials += 1
                if np.isfinite(f) and f <= cost + c1 * alpha * dphi0:
                    return alpha, x, f, None, trials
                new_alpha = _interpolate_step(
                    0.0, cost, dphi0, alpha, f, interpolation, extra_sample=prev_trial
                )
                new_alpha = max(new_alpha, alpha * opts.max_line_search_step_contraction)
                new_alpha = min(new_alpha, alpha * opts.min_line_search_step_contraction)
                prev_trial = (alpha, f) if np.isfinite(f) else None
                alpha = new_alpha
                if alpha < opts.min_line_search_step_size:
                    break
            return None, None, None, None, trials

        # WOLFE (strong): bracketing, then zoom (Nocedal & Wright 3.5/3.6)
        c2 = opts.line_search_sufficient_curvature_decrease
        alpha_prev, f_prev, dphi_prev = 0.0, cost, dphi0
        alpha = initial_step
        max_expansion = opts.max_line_search_step_expansion
        for it in range(opts.max_num_line_search_step_size_iterations):
            f, dphi, x, g = self._phi_grad(state, direction, alpha, summary)
            trials += 1
            if (not np.isfinite(f)) or f > cost + c1 * alpha * dphi0 or (it > 0 and f >= f_prev):
                lo, f_lo, dphi_lo = alpha_prev, f_prev, dphi_prev
                hi, f_hi, dphi_hi = alpha, f, dphi
                break
            if abs(dphi) <= -c2 * dphi0:
                return alpha, x, f, g, trials
            if dphi >= 0:
                lo, f_lo, dphi_lo = alpha, f, dphi
                hi, f_hi, dphi_hi = alpha_prev, f_prev, dphi_prev
                break
            alpha_prev, f_prev, dphi_prev = alpha, f, dphi
            alpha = min(alpha * 2.0, alpha * max_expansion)
        else:
            return None, None, None, None, trials

        # zoom: both bracket ends carry (value, gradient), so CUBIC is the
        # two-point Hermite cubic
        for _ in range(opts.max_num_line_search_step_size_iterations):
            alpha = _interpolate_step(lo, f_lo, dphi_lo, hi, f_hi, interpolation, g_hi=dphi_hi)
            if abs(hi - lo) < opts.min_line_search_step_size:
                break
            f, dphi, x, g = self._phi_grad(state, direction, alpha, summary)
            trials += 1
            if (not np.isfinite(f)) or f > cost + c1 * alpha * dphi0 or f >= f_lo:
                hi, f_hi, dphi_hi = alpha, f, dphi
            else:
                if abs(dphi) <= -c2 * dphi0:
                    return alpha, x, f, g, trials
                if dphi * (hi - lo) >= 0:
                    hi, f_hi, dphi_hi = lo, f_lo, dphi_lo
                lo, f_lo, dphi_lo = alpha, f, dphi
        return None, None, None, None, trials

    # -- direction (line_search_direction.cc) ---------------------------- #

    def _direction(self, grad, prev_grad, prev_direction, lbfgs, bfgs_h):
        opts = self.options
        kind = opts.line_search_direction_type
        if kind == LineSearchDirectionType.STEEPEST_DESCENT or (
            kind == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT and prev_grad is None
        ):
            return -grad
        if kind == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT:
            t = opts.nonlinear_conjugate_gradient_type
            if t == NonlinearConjugateGradientType.FLETCHER_REEVES:
                beta = torch.dot(grad, grad) / torch.dot(prev_grad, prev_grad)
            elif t == NonlinearConjugateGradientType.POLAK_RIBIERE:
                beta = torch.dot(grad, grad - prev_grad) / torch.dot(prev_grad, prev_grad)
                beta = torch.clamp_min(beta, 0.0)
            else:  # HESTENES_STIEFEL
                dy = grad - prev_grad
                beta = torch.dot(grad, dy) / torch.clamp_min(torch.dot(prev_direction, dy), 1e-30)
            return -grad + beta * prev_direction
        if kind == LineSearchDirectionType.LBFGS:
            return -lbfgs.apply(grad)
        return -(bfgs_h @ grad)

    def _eye(self, like):
        return torch.eye(self.num_tangent, dtype=like.dtype, device=like.device)

    # -- outer loop (ceres_tpu/solvers/line_search.py:237-432) ----------- #

    def minimize(self, state, summary):
        opts = self.options
        start = time.perf_counter()
        before = counts()
        cost_t, grad = self.grad_fn(state)
        grad = grad.clone()
        summary.num_jacobian_evaluations += 1
        cost, grad_max, grad_norm = read(
            torch.stack([cost_t.to(grad.dtype), grad.abs().max(), torch.linalg.norm(grad)])
        ).tolist()
        summary.initial_cost = cost + summary.fixed_cost
        if not math.isfinite(cost):
            summary.termination_type = TerminationType.FAILURE
            summary.message = "Initial cost is not finite."
            return state

        direction_type = opts.line_search_direction_type
        lbfgs = (
            _LBFGSMemory(opts.max_lbfgs_rank, opts.use_approximate_eigenvalue_bfgs_scaling)
            if direction_type == LineSearchDirectionType.LBFGS
            else None
        )
        bfgs_h = self._eye(grad) if direction_type == LineSearchDirectionType.BFGS else None
        prev_grad = prev_direction = prev_cost = None
        num_restarts = 0

        summary.iterations.append(IterationSummary(
            iteration=0,
            cost=cost + summary.fixed_cost,
            gradient_max_norm=grad_max,
            gradient_norm=grad_norm,
            cumulative_time_in_seconds=time.perf_counter() - start,
            num_device_reads=(counts() - before)["Device::Read"],
        ))
        if grad_max <= opts.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = "Gradient tolerance reached."
            summary.final_cost = cost + summary.fixed_cost
            return state

        for iteration in range(1, opts.max_num_iterations + 1):
            with span("LineSearch::Iteration"):
                it_start = time.perf_counter()
                before = counts()
                if it_start - start > opts.max_solver_time_in_seconds:
                    summary.termination_type = TerminationType.NO_CONVERGENCE
                    summary.message = "Maximum solver time reached."
                    break

                direction = self._direction(grad, prev_grad, prev_direction, lbfgs, bfgs_h)
                dphi0 = read(torch.dot(grad, direction)).item()
                if dphi0 >= 0:
                    # not a descent direction: restart from steepest descent
                    num_restarts += 1
                    if num_restarts > opts.max_num_line_search_direction_restarts:
                        summary.termination_type = TerminationType.FAILURE
                        summary.message = "Too many direction restarts."
                        break
                    if lbfgs is not None:
                        lbfgs.s_list.clear()
                    if bfgs_h is not None:
                        bfgs_h = self._eye(grad)
                    prev_grad = prev_cost = None  # the first iteration's step policy
                    direction = -grad
                    dphi0 = read(torch.dot(grad, direction)).item()

                # the initial step (line_search_minimizer.cc:297-302): scaled by
                # the gradient on the first iteration and after a restart, else
                # the quadratic model's 2 (f_k - f_{k-1}) / phi'(0)
                first_step = min(1.0, 1.0 / max(grad_max, 1e-12))
                if iteration == 1 or prev_cost is None:
                    initial_step = first_step
                else:
                    initial_step = min(1.0, 2.0 * (cost - prev_cost) / dphi0)
                    if not np.isfinite(initial_step) or initial_step <= 0.0:
                        initial_step = first_step

                alpha, new_state, new_cost, new_grad, trials = self.search(
                    state, direction, cost, dphi0, initial_step, summary
                )
                if alpha is None:
                    summary.termination_type = TerminationType.NO_CONVERGENCE
                    summary.message = "Line search failed to find a valid step."
                    break
                if new_grad is None:
                    _, new_grad = self.grad_fn(new_state)
                    summary.num_jacobian_evaluations += 1
                new_grad = new_grad.clone()

                step = alpha * direction
                cost_change = cost - new_cost
                y = new_grad - grad
                sy = torch.dot(step, y)
                grad_max, grad_norm, step_norm, x_norm, sy_host = read(torch.stack([
                    new_grad.abs().max(), torch.linalg.norm(new_grad), torch.linalg.norm(step),
                    torch.linalg.norm(new_state), sy,
                ])).tolist()
                # the curvature updates
                if lbfgs is not None:
                    lbfgs.update(step, y, sy, sy_host)
                if bfgs_h is not None and sy_host > 1e-14:
                    rho = 1.0 / sy
                    v = self._eye(grad) - rho * torch.outer(step, y)
                    bfgs_h = v @ bfgs_h @ v.T + rho * torch.outer(step, step)

                prev_grad, prev_direction, prev_cost = grad, direction, cost
                state, cost, grad = new_state, new_cost, new_grad
                summary.num_successful_steps += 1
                summary.num_line_search_steps += 1

                counted = counts() - before
                it_sum = IterationSummary(
                    iteration=iteration,
                    step_is_valid=True,
                    step_is_successful=True,
                    cost=cost + summary.fixed_cost,
                    cost_change=cost_change,
                    gradient_max_norm=grad_max,
                    gradient_norm=grad_norm,
                    step_norm=step_norm,
                    step_size=alpha,
                    line_search_iterations=trials,
                    iteration_time_in_seconds=time.perf_counter() - it_start,
                    cumulative_time_in_seconds=time.perf_counter() - start,
                    num_device_reads=counted["Device::Read"],
                    num_graph_replays=counted["CUDAGraph::Replay"],
                )
                if opts.line_search_type == LineSearchType.ARMIJO:
                    it_sum.line_search_function_evaluations = trials
                else:
                    it_sum.line_search_gradient_evaluations = trials
                summary.iterations.append(it_sum)
                ret = CallbackReturnType.SOLVER_CONTINUE
                for cb in opts.callbacks:
                    r = cb(it_sum)
                    if r != CallbackReturnType.SOLVER_CONTINUE:
                        ret = r
                if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                    summary.termination_type = TerminationType.USER_SUCCESS
                    summary.message = "User callback requested termination."
                    break
                if ret == CallbackReturnType.SOLVER_ABORT:
                    summary.termination_type = TerminationType.USER_FAILURE
                    summary.message = "User callback aborted."
                    break

                if grad_max <= opts.gradient_tolerance:
                    summary.termination_type = TerminationType.CONVERGENCE
                    summary.message = "Gradient tolerance reached."
                    break
                if abs(cost_change) <= opts.function_tolerance * cost:
                    summary.termination_type = TerminationType.CONVERGENCE
                    summary.message = "Function tolerance reached."
                    break
                if step_norm <= opts.parameter_tolerance * (x_norm + opts.parameter_tolerance):
                    summary.termination_type = TerminationType.CONVERGENCE
                    summary.message = "Parameter tolerance reached."
                    break
        else:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum number of iterations reached."

        summary.final_cost = cost + summary.fixed_cost
        return state


class LineSearchMinimizer:
    """NLLS problems under the line-search minimizer (reference:
    Minimizer::Create with LINE_SEARCH, line_search_minimizer.cc;
    ceres_tpu/solvers/line_search.py:435-462). The cost oracle is the
    Evaluator's residual-only evaluation (kernel B1 without the Jacobian on
    a Snavely group), the gradient the trust-region loop's `evaluate` (B1
    with the Jacobian, then Jᵀr: B3 on the cameras' onehot plan), replayed
    from a CUDA graph on a card. Bounds are not enforced beyond Plus's
    clamp, as in the JAX package (the reference refuses LINE_SEARCH with
    bounds)."""

    def __init__(self, program, options, evaluator):
        from .trust_region import make_evaluate

        self.program = program
        self.options = options
        self.evaluator = evaluator
        self._evaluate = make_evaluate(program, evaluator)

    def minimize(self, state, summary):
        ev = self.evaluator

        def grad_fn(x):
            cost, _, _, grad, _, _ = self._evaluate(x)
            return cost, grad

        driver = LineSearchDriver(
            self.options, ev.cost, grad_fn, ev.plus, self.program.num_effective_parameters
        )
        return driver.minimize(state, summary)
