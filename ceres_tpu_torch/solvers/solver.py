"""Solve facade: validate -> compile -> minimize -> summarize.

Port of `ceres_tpu.solvers.solver` (reference: Solver::Solve, solver.cc
:720-846). The device is resolved once here (utils.dtypes.resolve_device)
and carried by the Program and the Evaluator.
"""

from __future__ import annotations

import time

from ..evaluator import Evaluator
from ..types import LinearSolverType, MinimizerType, Summary, TerminationType
from ..utils.dtypes import default_dtype, resolve_device
from ..utils.execution_summary import ExecutionSummary


def solve(options, problem) -> Summary:
    summary = Summary()
    summary.execution_summary = ExecutionSummary()
    total_start = time.time()

    ok, msg = options.is_valid()
    if not ok:
        summary.termination_type = TerminationType.FAILURE
        summary.message = f"Invalid options: {msg}"
        return summary
    if options.minimizer_type != MinimizerType.TRUST_REGION:
        raise NotImplementedError("the line-search minimizer is not ported yet")

    # ---- preprocess (reference: trust_region_preprocessor.cc:373-405) ----
    t0 = time.time()
    device = resolve_device(options.device)
    dtype = options.dtype or default_dtype()
    summary.num_parameter_blocks = problem.num_parameter_blocks()
    summary.num_parameters = problem.num_parameters()
    summary.num_effective_parameters = problem.num_effective_parameters()
    summary.num_residual_blocks = problem.num_residual_blocks()
    summary.num_residuals = problem.num_residuals()
    summary.minimizer_type = options.minimizer_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    summary.linear_solver_type_used = options.linear_solver_type
    summary.preconditioner_type_used = options.preconditioner_type
    summary.used_fused_execution = False

    program = problem.compile(device)
    summary.num_parameter_blocks_reduced = summary.num_parameter_blocks
    summary.num_parameters_reduced = summary.num_parameters
    summary.num_effective_parameters_reduced = program.num_effective_parameters
    summary.num_residual_blocks_reduced = program.num_residual_blocks
    summary.num_residuals_reduced = program.num_residuals

    if program.num_residuals == 0:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Problem has no residual blocks."
        summary.preprocessor_time_in_seconds = time.time() - t0
        summary.total_time_in_seconds = time.time() - total_start
        return summary

    if options.linear_solver_type in (
        LinearSolverType.ITERATIVE_SCHUR, LinearSolverType.DENSE_SCHUR
    ):
        # the elimination ordering is preprocessing (reference:
        # trust_region_preprocessor.cc, ReorderProgram); cached per Program
        program.schur_tangent_masks()
    evaluator = Evaluator(program, dtype=dtype)
    state = program.state_vector(dtype)
    summary.preprocessor_time_in_seconds = time.time() - t0

    # ---- minimize ----
    from .trust_region import TrustRegionMinimizer

    t1 = time.time()
    minimizer = TrustRegionMinimizer(program, options, evaluator)
    final_state = minimizer.minimize(state, summary)
    summary.minimizer_time_in_seconds = time.time() - t1

    # ---- postprocess ----
    t2 = time.time()
    program.write_state_back(final_state.double().cpu().numpy())
    summary.postprocessor_time_in_seconds = time.time() - t2
    summary.total_time_in_seconds = time.time() - total_start
    return summary
