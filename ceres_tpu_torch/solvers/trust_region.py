"""Trust-region minimizer: the host outer loop.

Port of the host loop of `ceres_tpu.solvers.trust_region` (reference:
trust_region_minimizer.cc:66-836): LM, Jacobi scaling, non-monotonic step
acceptance, invalid-step retry, the convergence tests, and the prepare
cache reused across rejected steps. Tensors stay on the Program's device;
the loop moves only scalars (cost, model cost change, radius).
"""

from __future__ import annotations

import math
import time

import torch

from ..types import CallbackReturnType, IterationSummary, LoggingType, TerminationType
from .strategies import TrustRegionStepEvaluator, make_lm_step_fn


class _NullExec:
    def record(self, name, seconds, calls=1):
        pass


def _exec(summary):
    return getattr(summary, "execution_summary", None) or _NullExec()


class TrustRegionMinimizer:
    def __init__(self, program, options, evaluator):
        self.program = program
        self.options = options
        self.evaluator = evaluator
        self._step_fn = make_lm_step_fn(program, options, evaluator)
        self._prepare_fn = getattr(self._step_fn, "prepare", None)
        self._finish_fn = getattr(self._step_fn, "finish", None)
        self._prepare_cache = self._prepare_key = None

    @staticmethod
    def _grad_norms(grad):
        if grad.numel() == 0:
            return 0.0, 0.0
        return float(grad.abs().max()), float(torch.linalg.norm(grad))

    def minimize(self, state, summary):
        options = self.options
        ev = self.evaluator
        start = time.time()

        radius = float(options.initial_trust_region_radius)
        decrease_factor = 2.0
        num_consecutive_invalid = 0
        iteration_of_last_jacobian = -1
        self._prepare_key = None

        exec_sum = _exec(summary)
        t_jac = time.time()
        cost, res_groups, jac, grad = ev.evaluate_groups(state)
        cost = float(cost)
        summary.num_jacobian_evaluations += 1
        summary.jacobian_evaluation_time_in_seconds += time.time() - t_jac
        exec_sum.record("Evaluator::Jacobian", time.time() - t_jac)
        if not math.isfinite(cost):
            summary.termination_type = TerminationType.FAILURE
            summary.message = "Initial cost evaluation failed (non-finite)."
            return state
        summary.initial_cost = cost + summary.fixed_cost

        # Jacobi column scaling from the first Jacobian
        # (trust_region_minimizer.cc EvaluateGradientAndJacobian iteration 0)
        if options.jacobi_scaling:
            scale = 1.0 / (1.0 + torch.sqrt(jac.squared_column_norms()))
        else:
            scale = torch.ones(
                self.program.num_effective_parameters, dtype=state.dtype, device=state.device
            )

        step_evaluator = TrustRegionStepEvaluator(
            cost,
            options.max_consecutive_nonmonotonic_steps if options.use_nonmonotonic_steps else 0,
        )

        grad_max_norm, grad_norm = self._grad_norms(grad)
        it_sum = IterationSummary(
            iteration=0,
            step_is_valid=True,
            step_is_successful=True,
            cost=cost + summary.fixed_cost,
            gradient_max_norm=grad_max_norm,
            gradient_norm=grad_norm,
            trust_region_radius=radius,
            eta=options.eta,
            iteration_time_in_seconds=time.time() - start,
            cumulative_time_in_seconds=time.time() - start,
        )
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
            iter_start = time.time()
            if time.time() - start > options.max_solver_time_in_seconds:
                summary.termination_type = TerminationType.NO_CONVERGENCE
                summary.message = "Maximum solver time reached."
                break

            t_solve = time.time()
            if self._prepare_fn is None:
                delta, mcc, lin_iters, valid = self._step_fn(
                    jac, res_groups, grad, radius, scale
                )
            else:
                # reuse the cached prepare while the Jacobian is unchanged
                # (rejected steps only shrink the radius)
                if self._prepare_key != iteration_of_last_jacobian:
                    self._prepare_cache = self._prepare_fn(jac, res_groups, grad, scale)
                    self._prepare_key = iteration_of_last_jacobian
                delta, mcc, lin_iters, valid = self._finish_fn(
                    jac, res_groups, grad, radius, scale, self._prepare_cache
                )
            step_solver_time = time.time() - t_solve
            summary.num_linear_solves += 1
            summary.linear_solver_time_in_seconds += step_solver_time
            exec_sum.record("LinearSolver::Solve", step_solver_time)
            mcc = float(mcc)

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
            candidate = ev.plus(state, delta)
            t_res = time.time()
            new_cost = float(ev.cost(candidate))
            summary.num_residual_evaluations += 1
            summary.residual_evaluation_time_in_seconds += time.time() - t_res
            exec_sum.record("Evaluator::Residual", time.time() - t_res)

            step_norm = float(torch.linalg.norm(delta))
            x_norm = float(torch.linalg.norm(state))
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
                    self.program.write_state_back(state.cpu().numpy())

                t_jac = time.time()
                cost_j, res_groups, jac, grad = ev.evaluate_groups(state)
                iteration_of_last_jacobian = iteration
                summary.num_jacobian_evaluations += 1
                summary.jacobian_evaluation_time_in_seconds += time.time() - t_jac
                exec_sum.record("Evaluator::Jacobian", time.time() - t_jac)
                if not math.isfinite(float(cost_j)):
                    summary.termination_type = TerminationType.FAILURE
                    summary.message = "Residual/Jacobian evaluation failed at accepted point."
                    break
                grad_max_norm, grad_norm = self._grad_norms(grad)
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

    def _finish_iteration(self, summary, it_sum, iter_start, start):
        now = time.time()
        it_sum.iteration_time_in_seconds = now - iter_start
        it_sum.cumulative_time_in_seconds = now - start
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
