"""Trust-region step computation: the Levenberg-Marquardt strategy.

Port of the LM branch of `ceres_tpu.solvers.strategies`
(reference: levenberg_marquardt_strategy.cc:68-172) for the Schur solvers.
The step function solves through `schur_solve`; for ITERATIVE_SCHUR with a
block preconditioner it also carries the prepare/finish split: `prepare`
builds everything that depends only on the Jacobian (cached by the host
loop across rejected steps), `finish` everything that depends on the radius.
"""

from __future__ import annotations

import torch

from ..types import LinearSolverType, PreconditionerType


def _model_cost_change(jac_scaled, step, res_groups):
    """-m'(r + m/2) with m = J step (reference: trust_region_minimizer.cc
    ComputeTrustRegionStep model_cost_change)."""
    mcc = torch.zeros((), dtype=step.dtype, device=step.device)
    for m, r in zip(jac_scaled.right_multiply(step), res_groups):
        mcc = mcc - (m * (r + 0.5 * m)).sum()
    return mcc


def _step_result(jac_s, step, res_groups, scale, lin_iters):
    """(delta, model cost change, linear iterations, step is valid)."""
    mcc = _model_cost_change(jac_s, step, res_groups)
    delta = scale * step
    valid = bool(torch.isfinite(delta).all()) and float(mcc) > 0
    return delta, mcc, lin_iters, valid


def make_lm_step_fn(program, options, evaluator):
    """The LM step function; `.prepare` / `.finish` are attached for
    ITERATIVE_SCHUR with SCHUR_JACOBI, JACOBI or IDENTITY and neither the
    explicit complement nor the power-series warm start (the JAX package's
    condition, strategies.py:142-152).

    signature: (jac, res_groups, grad, radius, scale) ->
       (delta, model_cost_change, lin_iters, step_is_valid)
    """
    solver = options.linear_solver_type
    precond = options.preconditioner_type
    if solver not in (LinearSolverType.ITERATIVE_SCHUR, LinearSolverType.DENSE_SCHUR):
        raise NotImplementedError(
            f"this port runs LM with ITERATIVE_SCHUR or DENSE_SCHUR only; got {solver.value} "
            "(ROADMAP Queue A: linear solvers)"
        )
    if options.use_mixed_precision_solves:
        raise NotImplementedError(
            "use_mixed_precision_solves is not ported yet (ROADMAP Queue A: mixed precision)"
        )
    from ..linalg.schur import schur_finish, schur_prepare, schur_solve

    min_diag = options.min_lm_diagonal
    max_diag = options.max_lm_diagonal

    def step_fn(jac, res_groups, grad, radius, scale):
        jac_s = jac.scale_columns(scale)
        # LM diagonal D^2 = clamp(diag(J'J), min, max) / radius
        # (levenberg_marquardt_strategy.cc:83-95)
        dsq = torch.clamp(jac_s.squared_column_norms(), min_diag, max_diag) / radius
        step, lin_iters = schur_solve(program, options, jac_s, res_groups, grad * scale, dsq)
        return _step_result(jac_s, step, res_groups, scale, lin_iters)

    def prepare_fn(jac, res_groups, grad, scale):
        return schur_prepare(program, options, jac.scale_columns(scale))

    def finish_fn(jac, res_groups, grad, radius, scale, cache):
        jac_s = jac.scale_columns(scale)
        dsq = torch.clamp(cache["colnorm2"], min_diag, max_diag) / radius
        step, lin_iters = schur_finish(
            program, options, jac_s, res_groups, grad * scale, dsq, cache
        )
        return _step_result(jac_s, step, res_groups, scale, lin_iters)

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
