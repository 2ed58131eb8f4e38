"""Trust-region minimizer: the outer optimization loop.

Port of `ceres_tpu.solvers.trust_region` (reference:
trust_region_minimizer.cc:66-836): LM and dogleg, Jacobi scaling,
non-monotonic step acceptance, invalid-step retry, the convergence tests,
bounds (the active-set mask and projected gradient norms; Plus clamps to
the box), the projected Armijo line search, and the prepare cache reused
across rejected steps. An eligible solve runs the fused device loop
(fused_loop.py), as the JAX package's does; this host loop runs the rest
(every solve with `fused_execution=False`, the host solvers' step
functions, which are not `jittable`, and the solves that refine the
candidate with inner iterations or dump iterations' problems). Tensors
stay on the Program's device; the host loop brings scalars (cost, model
cost change, radius decisions) to the host through utils.graphs.read,
which counts them.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..evaluator import diagnose_non_finite, flatten_residuals
from ..evaluator import evaluate as evaluate_program
from ..jacobian import BlockJacobian
from ..types import (
    CallbackReturnType, IterationSummary, LoggingType, TerminationType, TrustRegionStrategyType,
)
from ..utils import graphs
from ..utils.execution_summary import counts, span
from ..utils.graphs import read, upload
from .strategies import TrustRegionStepEvaluator, make_lm_step_fn


def grad_norms(program, evaluator, state, grad):
    """(max, norm) of the gradient as 0-d tensors; with bounds the
    projected gradient |x - Plus(x, -g)|, so coordinates held at a bound
    stop counting (trust_region_minimizer.cc:270-295)."""
    if grad.numel() == 0:
        zero = torch.zeros((), dtype=state.dtype, device=state.device)
        return zero, zero
    if program.has_bounds:
        grad = state - evaluator.plus(state, -grad)
    return grad.abs().max(), torch.linalg.norm(grad)


def active_bound_mask(program, arrays, state, grad):
    """Active-set mask over tangent coordinates, on the state's device: 0
    where the coordinate sits at a bound and the descent direction (-g)
    points outward. Zeroing those columns of the scale freezes them, so the
    step slides along the boundary instead of being clipped (the
    gradient-projection handling of the box constraints the reference
    clamps in PlusWithBoundsClamping). Blocks on a manifold have no
    coordinate-wise pairing and keep 1 (Plus still clamps them)."""
    t_idx, a_idx = program.cached(
        ("bound_maps", state.device),
        lambda p: tuple(upload(m, device=state.device) for m in p.bound_coordinate_maps()),
    )
    x, g = state[a_idx], grad[t_idx]
    lo, hi = arrays["lower_bound"][a_idx], arrays["upper_bound"][a_idx]
    active = ((x <= lo) & (g > 0)) | ((x >= hi) & (g < 0))
    mask = torch.ones(program.num_effective_parameters, dtype=state.dtype, device=state.device)
    return mask.index_copy(0, t_idx, (~active).to(state.dtype))


def projected_line_search(evaluator, options, state, delta, cost, grad, valid=None):
    """Armijo backtracking on f(a) = cost(Plus(x, a*delta)) with every value
    on the state's device; with bounds Plus projects onto the box, so the
    search both keeps the box and improves the step
    (trust_region_minimizer.cc:101-106, 585-633). A failed search keeps the
    full step. The host reads whether to start and, after each cost
    evaluation but the last allowed one, whether to stop. Returns (delta',
    number of cost evaluations)."""
    ev = evaluator
    c1 = options.line_search_sufficient_function_decrease
    max_evals = options.max_num_line_search_step_size_iterations
    dphi0 = torch.dot(grad, delta)
    start = torch.isfinite(dphi0) & (dphi0 < 0.0)
    if not bool(read(start if valid is None else start & valid)):
        return delta, 0
    alpha = torch.ones((), dtype=delta.dtype, device=delta.device)
    best = alpha
    done = torch.zeros((), dtype=torch.bool, device=delta.device)
    evals = 0
    for k in range(max_evals):
        f = ev.cost(ev.plus(state, alpha * delta))
        evals += 1
        ok = torch.isfinite(f) & (f <= cost + c1 * alpha * dphi0)
        # quadratic interpolation through (0, cost, dphi0), (alpha, f)
        denom = 2.0 * (f - cost - dphi0 * alpha)
        new_alpha = torch.where(
            torch.isfinite(denom) & (denom > 0), -dphi0 * alpha * alpha / denom, 0.5 * alpha
        )
        new_alpha = torch.clamp(
            new_alpha,
            alpha * options.max_line_search_step_contraction,
            alpha * options.min_line_search_step_contraction,
        )
        best = torch.where(ok, alpha, best)
        alpha = torch.where(ok, alpha, new_alpha)
        done = done | ok
        if k + 1 == max_evals or bool(read(done | (alpha < options.min_line_search_step_size))):
            break
    return torch.where(done, best, 1.0) * delta, evals


def make_evaluate(program, evaluator):
    """evaluate(state) -> (cost, residual groups, Jacobian, gradient,
    gradient max norm, norm), all on the device. On a card it runs from a
    CUDA graph, whose outputs are the Jacobian, its twins and the gradient
    that the finish graphs read in place. The Program's evaluation
    callback runs on the host before every call, replays included."""
    graph = evaluator.fn_graph("evaluate")
    garrs = evaluator.arrays["groups"]

    def run(_, x):
        cost, res, jac, grad = evaluate_program(program, evaluator.arrays, x, True, True)
        gmax, gnorm = grad_norms(program, evaluator, x, grad)
        return cost, res, tuple(jac.jac_groups), jac.twins, grad, gmax, gnorm

    def evaluate(state):
        evaluator.notify(True)
        cost, res, leaves, twins, grad, gmax, gnorm = graphs.call(graph, run, (), state)
        return cost, res, BlockJacobian(program, leaves, garrs, twins=twins), grad, gmax, gnorm

    return evaluate


def make_prepare(program, evaluator, step_fn):
    """prepare(jac, res_groups, grad, scale) -> the step function's prepare
    cache; on a card from a CUDA graph that reads the Jacobian in place. A
    prepare that reads the device (dogleg's PCG, `prepare_reads`) runs its
    own graphs and is returned as it is."""
    if getattr(step_fn, "prepare_reads", False):
        return step_fn.prepare
    graph = evaluator.fn_graph("prepare")
    garrs = evaluator.arrays["groups"]

    def run(fixed, scale):
        leaves, twins, res, grad = fixed
        return step_fn.prepare(BlockJacobian(program, leaves, garrs, twins=twins), res, grad, scale)

    def prepare(jac, res_groups, grad, scale):
        fixed = (tuple(jac.jac_groups), jac.twins, tuple(res_groups), grad)
        return graphs.call(graph, run, fixed, scale)

    return prepare


def dump_problem(options, iteration, jac, res_groups, grad, scale, radius):
    """Write the iteration's linear least-squares problem to
    `trust_region_problem_dump_directory`/ceres_tpu_problem_{iteration:03d}.npz
    with the JAX package's keys (ceres_tpu/solvers/trust_region.py:292-317;
    reference: DumpLinearLeastSquaresProblem,
    levenberg_marquardt_strategy.cc:135-147): the Jacobian as a CRS triple,
    the residuals, the gradient, the Jacobi scale and the radius. The
    Jacobian and the three vectors cross to the host in one read."""
    from ..linalg.sparse import host_crs

    (vals, cols, row_ptr), (residuals, gradient, scale_h), _ = host_crs(
        jac, flatten_residuals(jac.program, res_groups), grad, scale
    )
    np.savez(
        os.path.join(
            options.trust_region_problem_dump_directory, f"ceres_tpu_problem_{iteration:03d}.npz"
        ),
        jacobian_values=vals, jacobian_cols=cols, jacobian_row_ptr=row_ptr,
        residuals=residuals, gradient=gradient, scale=scale_h, trust_region_radius=radius,
    )


class TrustRegionMinimizer:
    def __init__(self, program, options, evaluator):
        self.program = program
        self.options = options
        self.evaluator = evaluator
        # the strategy (ceres_tpu/solvers/trust_region.py:48-55); both update
        # the radius as LM does, as the JAX package's loop does
        if options.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG:
            from .dogleg import make_dogleg_step_fn

            self._step_fn = make_dogleg_step_fn(program, options, evaluator)
        else:
            self._step_fn = make_lm_step_fn(program, options, evaluator)
        # the prepare/finish split: the J-dependent prepare cache holds while
        # steps are rejected (in the fused loop not under bounds, where the
        # active-set mask changes the effective scale every iteration)
        self.has_split = hasattr(self._step_fn, "prepare")
        # the host loop of a sharded solve (a gloo mesh) stands in for
        # ceres_tpu's sharded solve, which runs its fused loop: it takes that
        # loop's split, none under bounds (fused_loop.make_chunk_fn). The
        # split and the whole step sum in different orders: a bounded BA
        # parts by 2.5e-5 in five iterations between them, in both packages
        self.host_split = self.has_split and not (options.mesh is not None and program.has_bounds)
        # the projected line search: with bounds (upstream runs DoLineSearch
        # when is_constrained, :101-106), and on unconstrained problems with
        # trust_region_use_line_search
        self.use_line_search = (
            program.has_bounds or options.trust_region_use_line_search
        ) and options.max_num_line_search_step_size_iterations > 0
        self.evaluate = make_evaluate(program, evaluator)
        self.prepare = make_prepare(program, evaluator, self._step_fn) if self.has_split else None
        self._prepare_cache = self._prepare_key = None
        self._iter_counts = None
        from .fused_loop import eligible, make_chunk_fn

        self.inner = None
        if options.use_inner_iterations:
            from .inner_iterations import InnerIterationRefiner

            refiner = InnerIterationRefiner(program, options, evaluator)
            if refiner.available:
                self.inner = refiner
        self._fused_chunk_fn = None
        if eligible(options, self._step_fn, program):
            self._fused_chunk_fn = make_chunk_fn(self)

    def minimize(self, state, summary):
        if self._fused_chunk_fn is not None:
            from .fused_loop import run_fused

            return run_fused(self, state, summary)
        options = self.options
        ev = self.evaluator
        program = self.program
        start = time.perf_counter()
        self._iter_counts = counts()

        radius = float(options.initial_trust_region_radius)
        decrease_factor = 2.0
        num_consecutive_invalid = 0
        iteration_of_last_jacobian = -1
        inner_iterations_enabled = self.inner is not None
        self._prepare_key = None

        with span("Evaluator::Jacobian") as jac_span:
            cost, res_groups, jac, grad, gmax, gnorm = self.evaluate(state)
            cost, grad_max_norm, grad_norm = read(torch.stack([cost, gmax, gnorm])).tolist()
        summary.num_jacobian_evaluations += 1
        summary.jacobian_evaluation_time_in_seconds += jac_span.seconds
        if not math.isfinite(cost):
            summary.termination_type = TerminationType.FAILURE
            summary.message = (
                "Initial cost evaluation failed (non-finite).\n"
                + diagnose_non_finite(program, state)
            )
            return state
        summary.initial_cost = cost + summary.fixed_cost

        # Jacobi column scaling from the first Jacobian
        # (trust_region_minimizer.cc EvaluateGradientAndJacobian iteration 0)
        if options.jacobi_scaling:
            scale = 1.0 / (1.0 + torch.sqrt(jac.squared_column_norms()))
        else:
            scale = torch.ones(
                program.num_effective_parameters, dtype=state.dtype, device=state.device
            )

        step_evaluator = TrustRegionStepEvaluator(
            cost,
            options.max_consecutive_nonmonotonic_steps if options.use_nonmonotonic_steps else 0,
        )

        it_sum = IterationSummary(
            iteration=0,
            step_is_valid=True,
            step_is_successful=True,
            cost=cost + summary.fixed_cost,
            gradient_max_norm=grad_max_norm,
            gradient_norm=grad_norm,
            trust_region_radius=radius,
            eta=options.eta,
            iteration_time_in_seconds=time.perf_counter() - start,
            cumulative_time_in_seconds=time.perf_counter() - start,
        )
        self._count_reads(it_sum)
        summary.iterations.append(it_sum)
        self._log(it_sum)

        if grad_max_norm <= options.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = (
                f"Gradient tolerance reached. Gradient max norm {grad_max_norm:e}"
                f" <= {options.gradient_tolerance:e}"
            )
            summary.final_cost = cost + summary.fixed_cost
            return state

        for iteration in range(1, options.max_num_iterations + 1):
            with span("TrustRegion::Iteration"):
                iter_start = time.perf_counter()
                if iter_start - start > options.max_solver_time_in_seconds:
                    summary.termination_type = TerminationType.NO_CONVERGENCE
                    summary.message = "Maximum solver time reached."
                    break

                with span("LinearSolver::Solve") as solve_span:
                    iter_scale = scale
                    if program.has_bounds:
                        mask = active_bound_mask(program, ev.arrays, state, grad)
                        if bool(read((mask == 0).any())):
                            iter_scale = scale * mask
                    if iteration in options.trust_region_minimizer_iterations_to_dump:
                        dump_problem(options, iteration, jac, res_groups, grad, iter_scale, radius)
                    if not self.host_split:
                        delta, mcc, lin_iters, valid = self._step_fn(
                            jac, res_groups, grad, radius, iter_scale
                        )
                    else:
                        # reuse the cached prepare while the Jacobian is unchanged
                        # (rejected steps only shrink the radius); an active bound
                        # mask changes iter_scale per iteration, so the cache is
                        # rebuilt every time it is in effect
                        key = iteration_of_last_jacobian
                        if iter_scale is not scale:
                            key = ("masked", iteration)
                        if self._prepare_key != key:
                            self._prepare_cache = self.prepare(jac, res_groups, grad, iter_scale)
                            self._prepare_key = key
                        delta, mcc, lin_iters, valid = self._step_fn.finish(
                            jac, res_groups, grad, radius, iter_scale, self._prepare_cache
                        )
                    valid, mcc, lin_iters = read(
                        torch.stack([valid.to(mcc.dtype), mcc, lin_iters.to(mcc.dtype)])
                    ).tolist()
                valid = bool(valid)
                step_solver_time = solve_span.seconds
                summary.num_linear_solves += 1
                summary.linear_solver_time_in_seconds += step_solver_time

                it_sum = IterationSummary(
                    iteration=iteration,
                    step_is_valid=valid,
                    trust_region_radius=radius,
                    linear_solver_iterations=int(lin_iters),
                    step_solver_time_in_seconds=step_solver_time,
                )

                if not valid:
                    # reference: HandleInvalidStep (trust_region_minimizer.cc:462-502)
                    num_consecutive_invalid += 1
                    if num_consecutive_invalid >= options.max_num_consecutive_invalid_steps:
                        summary.termination_type = TerminationType.FAILURE
                        summary.message = f"{num_consecutive_invalid} consecutive invalid steps."
                        self._count_reads(it_sum)
                        summary.iterations.append(it_sum)
                        break
                    radius, decrease_factor = self._step_rejected(radius, decrease_factor)
                    summary.num_unsuccessful_steps += 1
                    it_sum.cost = cost + summary.fixed_cost
                    self._finish_iteration(summary, it_sum, iter_start, start)
                    if radius < options.min_trust_region_radius:
                        summary.termination_type = TerminationType.CONVERGENCE
                        summary.message = "Minimum trust region radius reached."
                        break
                    continue

                num_consecutive_invalid = 0
                if self.use_line_search:
                    with span("LineSearch::CostEvaluation") as ls_span:
                        delta, ls_evals = projected_line_search(
                            ev, options, state, delta, cost, grad
                        )
                        ls_span.calls = ls_evals
                    summary.num_residual_evaluations += ls_evals
                    summary.num_line_search_steps += ls_evals

                candidate = ev.plus(state, delta)
                with span("Evaluator::Residual") as res_span:
                    new_cost = ev.cost(candidate)
                    # with bounds the projected candidate can move less than
                    # |delta|: the realized ambient step, as the reference
                    # measures it (trust_region_minimizer.cc
                    # ComputeCandidatePointAndEvaluateCost)
                    step = state - candidate if program.has_bounds else delta
                    new_cost, step_norm, x_norm = read(
                        torch.stack([new_cost, torch.linalg.norm(step), torch.linalg.norm(state)])
                    ).tolist()
                summary.num_residual_evaluations += 1
                summary.residual_evaluation_time_in_seconds += res_span.seconds

                if inner_iterations_enabled and math.isfinite(new_cost):
                    # refine the candidate (DoInnerIterationsIfNeeded,
                    # trust_region_minimizer.cc:504-583), credit its decrease
                    # to the model (:558-560), and stop refining once its
                    # relative progress falls below the tolerance (:564-570)
                    with span("InnerIterations::Refine"):
                        candidate, refined_cost = self.inner.refine(candidate, new_cost)
                    summary.num_inner_iteration_steps += 1
                    mcc += new_cost - refined_cost
                    rel_progress = 1.0 - refined_cost / new_cost if new_cost > 0 else 0.0
                    inner_iterations_enabled = rel_progress > options.inner_iteration_tolerance
                    new_cost = refined_cost
                    if program.has_bounds:
                        step_norm = read(torch.linalg.norm(state - candidate)).item()

                cost_change = cost - new_cost
                it_sum.step_norm = step_norm
                it_sum.cost_change = cost_change

                # parameter tolerance (trust_region_minimizer.cc:686-706)
                if step_norm <= options.parameter_tolerance * (x_norm + options.parameter_tolerance):
                    summary.termination_type = TerminationType.CONVERGENCE
                    summary.message = f"Parameter tolerance reached. |step| = {step_norm:e}"
                    it_sum.cost = cost + summary.fixed_cost
                    self._finish_iteration(summary, it_sum, iter_start, start)
                    break

                # function tolerance (:708-727)
                if math.isfinite(new_cost) and abs(cost_change) <= options.function_tolerance * cost:
                    summary.termination_type = TerminationType.CONVERGENCE
                    summary.message = (
                        f"Function tolerance reached. |cost change|/cost = "
                        f"{abs(cost_change) / max(cost, 1e-300):e}"
                    )
                    it_sum.cost = min(cost, new_cost) + summary.fixed_cost
                    if new_cost < cost:
                        state = candidate
                        cost = new_cost
                    self._finish_iteration(summary, it_sum, iter_start, start)
                    break

                finite = math.isfinite(new_cost)
                relative_decrease = step_evaluator.step_quality(new_cost, mcc) if finite else -1.0
                step_successful = finite and relative_decrease > options.min_relative_decrease
                it_sum.relative_decrease = relative_decrease
                it_sum.step_is_successful = step_successful

                if step_successful:
                    # LM radius update (levenberg_marquardt_strategy.cc:157-165)
                    radius = radius / max(1.0 / 3.0, 1.0 - (2.0 * relative_decrease - 1.0) ** 3)
                    radius = min(radius, options.max_trust_region_radius)
                    decrease_factor = 2.0
                    step_evaluator.step_accepted(new_cost, mcc)
                    state = candidate
                    cost = new_cost
                    summary.num_successful_steps += 1
                    if options.update_state_every_iteration:
                        self.program.write_state_back(read(state).double().numpy())

                    with span("Evaluator::Jacobian") as jac_span:
                        cost_j, res_groups, jac, grad, gmax, gnorm = self.evaluate(state)
                    iteration_of_last_jacobian = iteration
                    summary.num_jacobian_evaluations += 1
                    summary.jacobian_evaluation_time_in_seconds += jac_span.seconds
                    cost_j, grad_max_norm, grad_norm = read(
                        torch.stack([cost_j, gmax, gnorm])
                    ).tolist()
                    if not math.isfinite(cost_j):
                        summary.termination_type = TerminationType.FAILURE
                        summary.message = (
                            "Residual/Jacobian evaluation failed at accepted point.\n"
                            + diagnose_non_finite(program, state)
                        )
                        break
                    it_sum.gradient_max_norm = grad_max_norm
                    it_sum.gradient_norm = grad_norm
                    if grad_max_norm <= options.gradient_tolerance:
                        summary.termination_type = TerminationType.CONVERGENCE
                        summary.message = f"Gradient tolerance reached. Gradient max norm {grad_max_norm:e}"
                        it_sum.cost = cost + summary.fixed_cost
                        self._finish_iteration(summary, it_sum, iter_start, start)
                        break
                else:
                    radius, decrease_factor = self._step_rejected(radius, decrease_factor)
                    summary.num_unsuccessful_steps += 1
                    if radius < options.min_trust_region_radius:
                        summary.termination_type = TerminationType.CONVERGENCE
                        summary.message = "Minimum trust region radius reached."
                        it_sum.cost = cost + summary.fixed_cost
                        self._finish_iteration(summary, it_sum, iter_start, start)
                        break

                it_sum.cost = cost + summary.fixed_cost
                it_sum.trust_region_radius = radius
                cb = self._finish_iteration(summary, it_sum, iter_start, start)
                if cb == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                    summary.termination_type = TerminationType.USER_SUCCESS
                    summary.message = "User callback requested termination."
                    break
                if cb == CallbackReturnType.SOLVER_ABORT:
                    summary.termination_type = TerminationType.USER_FAILURE
                    summary.message = "User callback aborted the solve."
                    break
        else:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum number of iterations reached."

        summary.final_cost = cost + summary.fixed_cost
        return state

    @staticmethod
    def _step_rejected(radius, decrease_factor):
        """reference: levenberg_marquardt_strategy.cc:166-171."""
        return radius / decrease_factor, 2.0 * decrease_factor

    def _count_reads(self, it_sum):
        """The device reads and graph replays since the last iteration's
        record."""
        now = counts()
        counted = now - self._iter_counts
        it_sum.num_device_reads = counted["Device::Read"]
        it_sum.num_graph_replays = counted["CUDAGraph::Replay"]
        self._iter_counts = now

    def _finish_iteration(self, summary, it_sum, iter_start, start):
        now = time.perf_counter()
        it_sum.iteration_time_in_seconds = now - iter_start
        it_sum.cumulative_time_in_seconds = now - start
        self._count_reads(it_sum)
        summary.iterations.append(it_sum)
        self._log(it_sum)
        ret = CallbackReturnType.SOLVER_CONTINUE
        for cb in self.options.callbacks:
            r = cb(it_sum)
            if r == CallbackReturnType.SOLVER_ABORT:
                return CallbackReturnType.SOLVER_ABORT
            if r == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                ret = CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return ret

    def _log(self, it_sum):
        if self.options.logging_type == LoggingType.SILENT:
            return
        if self.options.minimizer_progress_to_stdout:
            print(
                f"iter {it_sum.iteration:3d}  cost {it_sum.cost:.6e}  "
                f"cost_change {it_sum.cost_change:.2e}  "
                f"|gradient| {it_sum.gradient_max_norm:.2e}  "
                f"tr_radius {it_sum.trust_region_radius:.2e}  "
                f"li {it_sum.linear_solver_iterations}  "
                f"it_time {it_sum.iteration_time_in_seconds:.3f}s"
            )
