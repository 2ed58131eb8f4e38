"""Enums and option structs, ported from `ceres_tpu.types`.

The capability surface (reference: include/ceres/types.h:52-402,
include/ceres/solver.h:65-841) is unchanged: every option of the JAX
package exists here with the same name and default, so an options object
reads the same in both packages. Options whose code path is not ported yet
are accepted and validated; `solve` refuses configurations it cannot run
(see solvers/solver.py). Two fields are PyTorch-specific: `dtype` takes a
`torch.dtype`, and `device` selects where the solve runs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Sequence


class LinearSolverType(enum.Enum):
    # reference: include/ceres/types.h:58-103
    DENSE_NORMAL_CHOLESKY = "DENSE_NORMAL_CHOLESKY"
    DENSE_QR = "DENSE_QR"
    SPARSE_NORMAL_CHOLESKY = "SPARSE_NORMAL_CHOLESKY"
    DENSE_SCHUR = "DENSE_SCHUR"
    SPARSE_SCHUR = "SPARSE_SCHUR"
    ITERATIVE_SCHUR = "ITERATIVE_SCHUR"
    CGNR = "CGNR"


class PreconditionerType(enum.Enum):
    # reference: include/ceres/types.h:105-161
    IDENTITY = "IDENTITY"
    JACOBI = "JACOBI"
    SCHUR_JACOBI = "SCHUR_JACOBI"
    SCHUR_POWER_SERIES_EXPANSION = "SCHUR_POWER_SERIES_EXPANSION"
    CLUSTER_JACOBI = "CLUSTER_JACOBI"
    CLUSTER_TRIDIAGONAL = "CLUSTER_TRIDIAGONAL"
    SUBSET = "SUBSET"


class VisibilityClusteringType(enum.Enum):
    CANONICAL_VIEWS = "CANONICAL_VIEWS"
    SINGLE_LINKAGE = "SINGLE_LINKAGE"


class TrustRegionStrategyType(enum.Enum):
    # reference: include/ceres/types.h:163-175
    LEVENBERG_MARQUARDT = "LEVENBERG_MARQUARDT"
    DOGLEG = "DOGLEG"


class DoglegType(enum.Enum):
    TRADITIONAL_DOGLEG = "TRADITIONAL_DOGLEG"
    SUBSPACE_DOGLEG = "SUBSPACE_DOGLEG"


class MinimizerType(enum.Enum):
    TRUST_REGION = "TRUST_REGION"
    LINE_SEARCH = "LINE_SEARCH"


class LineSearchDirectionType(enum.Enum):
    STEEPEST_DESCENT = "STEEPEST_DESCENT"
    NONLINEAR_CONJUGATE_GRADIENT = "NONLINEAR_CONJUGATE_GRADIENT"
    LBFGS = "LBFGS"
    BFGS = "BFGS"


class NonlinearConjugateGradientType(enum.Enum):
    FLETCHER_REEVES = "FLETCHER_REEVES"
    POLAK_RIBIERE = "POLAK_RIBIERE"
    HESTENES_STIEFEL = "HESTENES_STIEFEL"


class LineSearchType(enum.Enum):
    ARMIJO = "ARMIJO"
    WOLFE = "WOLFE"


class LineSearchInterpolationType(enum.Enum):
    BISECTION = "BISECTION"
    QUADRATIC = "QUADRATIC"
    CUBIC = "CUBIC"


class TerminationType(enum.Enum):
    # reference: include/ceres/types.h:284-350
    CONVERGENCE = "CONVERGENCE"
    NO_CONVERGENCE = "NO_CONVERGENCE"
    FAILURE = "FAILURE"
    USER_SUCCESS = "USER_SUCCESS"
    USER_FAILURE = "USER_FAILURE"


class CallbackReturnType(enum.Enum):
    SOLVER_CONTINUE = "SOLVER_CONTINUE"
    SOLVER_ABORT = "SOLVER_ABORT"
    SOLVER_TERMINATE_SUCCESSFULLY = "SOLVER_TERMINATE_SUCCESSFULLY"


class LoggingType(enum.Enum):
    SILENT = "SILENT"
    PER_MINIMIZER_ITERATION = "PER_MINIMIZER_ITERATION"


class CovarianceAlgorithmType(enum.Enum):
    DENSE_SVD = "DENSE_SVD"
    SPARSE_QR = "SPARSE_QR"
    ITERATIVE_PCG = "ITERATIVE_PCG"


class NumericDiffMethodType(enum.Enum):
    CENTRAL = "CENTRAL"
    FORWARD = "FORWARD"
    RIDDERS = "RIDDERS"


@dataclasses.dataclass
class SolverOptions:
    """Options controlling the solve (field names and defaults as in
    `ceres_tpu.types.SolverOptions`, reference Solver::Options)."""

    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION

    # --- trust region ---
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
    dogleg_type: DoglegType = DoglegType.TRADITIONAL_DOGLEG
    max_num_iterations: int = 50
    max_solver_time_in_seconds: float = 1e9
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5
    max_num_consecutive_invalid_steps: int = 5
    jacobi_scaling: bool = True
    fused_execution: bool = True
    fused_execution_chunk_iters: int = 0

    # --- convergence tolerances (solver.h:430-470) ---
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8

    # --- linear solver ---
    linear_solver_type: LinearSolverType = LinearSolverType.DENSE_QR
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    eta: float = 1e-1
    use_explicit_schur_complement: bool = False
    linear_solver_ordering: Optional[Sequence[int]] = None
    use_spse_initialization: bool = False
    max_num_spse_iterations: int = 5
    spse_tolerance: float = 0.1
    visibility_clustering_type: VisibilityClusteringType = (
        VisibilityClusteringType.CANONICAL_VIEWS
    )
    residual_blocks_for_subset_preconditioner: list = dataclasses.field(
        default_factory=list
    )

    # --- line search (first-order) ---
    line_search_direction_type: LineSearchDirectionType = LineSearchDirectionType.LBFGS
    line_search_type: LineSearchType = LineSearchType.WOLFE
    nonlinear_conjugate_gradient_type: NonlinearConjugateGradientType = (
        NonlinearConjugateGradientType.FLETCHER_REEVES
    )
    max_lbfgs_rank: int = 20
    use_approximate_eigenvalue_bfgs_scaling: bool = False
    line_search_interpolation_type: LineSearchInterpolationType = (
        LineSearchInterpolationType.CUBIC
    )
    min_line_search_step_size: float = 1e-9
    line_search_sufficient_function_decrease: float = 1e-4
    max_line_search_step_contraction: float = 1e-3
    min_line_search_step_contraction: float = 0.6
    max_num_line_search_step_size_iterations: int = 20
    max_num_line_search_direction_restarts: int = 5
    line_search_sufficient_curvature_decrease: float = 0.9
    max_line_search_step_expansion: float = 10.0
    trust_region_use_line_search: bool = False

    # --- inner iterations ---
    use_inner_iterations: bool = False
    inner_iteration_tolerance: float = 1e-3
    inner_iteration_ordering: Any = None

    # --- logging / callbacks ---
    logging_type: LoggingType = LoggingType.PER_MINIMIZER_ITERATION
    minimizer_progress_to_stdout: bool = False
    callbacks: list = dataclasses.field(default_factory=list)
    update_state_every_iteration: bool = False

    # Mixed-precision linear solves (ceres_tpu/types.py:247-255): the PCG
    # matvec reads a bfloat16 copy of the scaled Jacobian (kernels B2, B3,
    # B4 in their bfloat16 instantiation) and accumulates in float32; the
    # preconditioner, rhs and back-substitution stay in the working dtype;
    # DENSE_SCHUR factors in float32 and refines
    # max(1, max_num_refinement_iterations or 3) times.
    use_mixed_precision_solves: bool = False
    split_step_dispatch: bool = False
    max_num_refinement_iterations: int = 0

    # --- numerics ---
    # torch dtype of the evaluation / linear-algebra path; None -> float64.
    dtype: Any = None
    # torch device (or its name) the solve runs on; None -> "cuda", and
    # solve raises when no card is visible (pass "cpu" for the CPU).
    device: Any = None

    # --- multi-device: a parallel.distributed.Mesh (one rank per shard);
    # residual blocks are sharded over mesh_axis (a 1-D mesh's axis; a
    # hybrid mesh shards over both of its axes) and every reduction over
    # them is all-reduced ---
    mesh: Any = None
    mesh_axis: str = "dp"

    trust_region_minimizer_iterations_to_dump: tuple = ()
    trust_region_problem_dump_directory: str = "/tmp"

    check_gradients: bool = False
    gradient_check_relative_precision: float = 1e-8
    gradient_check_numeric_derivative_relative_step_size: float = 1e-6

    def is_valid(self) -> tuple[bool, str]:
        """Validate option combinations (reference: solver.cc:692-716)."""
        if self.max_num_iterations < 0:
            return False, "max_num_iterations must be >= 0"
        for name in (
            "function_tolerance",
            "gradient_tolerance",
            "parameter_tolerance",
        ):
            if getattr(self, name) < 0:
                return False, f"{name} must be >= 0"
        if self.initial_trust_region_radius <= 0:
            return False, "initial_trust_region_radius must be > 0"
        if self.min_trust_region_radius > self.max_trust_region_radius:
            return False, "min_trust_region_radius > max_trust_region_radius"
        if not (0 < self.min_relative_decrease < 1):
            return False, "min_relative_decrease must be in (0, 1)"
        if self.max_linear_solver_iterations < 1:
            return False, "max_linear_solver_iterations must be >= 1"
        if self.mesh is not None:
            if len(self.mesh.axis_names) == 1 and self.mesh_axis not in self.mesh.axis_names:
                return False, f"mesh_axis {self.mesh_axis!r} is not an axis of the mesh"
            if (self.minimizer_type == MinimizerType.TRUST_REGION
                    and self.linear_solver_type in _WHOLE_JACOBIAN_SOLVERS):
                # each rank holds only its lanes of J (ceres_tpu's dense and
                # host solvers do not run under shard_map either)
                return False, (
                    f"{self.linear_solver_type.value} factors the whole Jacobian on one "
                    "process; a sharded solve takes CGNR, ITERATIVE_SCHUR or DENSE_SCHUR"
                )
        return True, ""


# the linear solvers that read the whole Jacobian on one process
_WHOLE_JACOBIAN_SOLVERS = (
    LinearSolverType.DENSE_QR, LinearSolverType.DENSE_NORMAL_CHOLESKY,
    LinearSolverType.SPARSE_NORMAL_CHOLESKY, LinearSolverType.SPARSE_SCHUR,
)


@dataclasses.dataclass
class IterationSummary:
    """Per-iteration record (reference: include/ceres/iteration_callback.h)."""

    iteration: int = 0
    step_is_valid: bool = False
    step_is_nonmonotonic: bool = False
    step_is_successful: bool = False
    cost: float = 0.0
    cost_change: float = 0.0
    gradient_max_norm: float = 0.0
    gradient_norm: float = 0.0
    step_norm: float = 0.0
    relative_decrease: float = 0.0
    trust_region_radius: float = 0.0
    eta: float = 0.0
    step_size: float = 0.0
    line_search_function_evaluations: int = 0
    line_search_gradient_evaluations: int = 0
    line_search_iterations: int = 0
    linear_solver_iterations: int = 0
    # device->host reads the iteration took (utils.graphs.read), and the
    # CUDA graph replays it made (the PCG iterations, the finish's head and
    # tail, decide, and after an accepted step evaluate and prepare); the
    # port's own counters
    num_device_reads: int = 0
    num_graph_replays: int = 0
    iteration_time_in_seconds: float = 0.0
    step_solver_time_in_seconds: float = 0.0
    cumulative_time_in_seconds: float = 0.0


@dataclasses.dataclass
class Summary:
    """Solve summary (reference: Solver::Summary, solver.h:845-1155)."""

    termination_type: TerminationType = TerminationType.FAILURE
    message: str = ""
    initial_cost: float = 0.0
    final_cost: float = 0.0
    fixed_cost: float = 0.0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    num_inner_iteration_steps: int = 0
    num_line_search_steps: int = 0
    iterations: list = dataclasses.field(default_factory=list)

    num_parameter_blocks: int = 0
    num_parameters: int = 0
    num_effective_parameters: int = 0
    num_residual_blocks: int = 0
    num_residuals: int = 0
    num_parameter_blocks_reduced: int = 0
    num_parameters_reduced: int = 0
    num_effective_parameters_reduced: int = 0
    num_residual_blocks_reduced: int = 0
    num_residuals_reduced: int = 0

    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
    linear_solver_type_used: Optional[LinearSolverType] = None
    preconditioner_type_used: Optional[PreconditionerType] = None
    line_search_direction_type: Optional[LineSearchDirectionType] = None
    used_fused_execution: bool = False

    preprocessor_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    postprocessor_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    linear_solver_time_in_seconds: float = 0.0
    residual_evaluation_time_in_seconds: float = 0.0
    jacobian_evaluation_time_in_seconds: float = 0.0
    num_residual_evaluations: int = 0
    num_jacobian_evaluations: int = 0
    num_linear_solves: int = 0
    # device->host reads of the minimizer (utils.graphs.read) and its CUDA
    # graph replays (the port's own counters)
    num_device_reads: int = 0
    num_graph_replays: int = 0
    execution_summary: Any = None

    def brief_report(self) -> str:
        return (
            f"Solver Summary: iterations {len(self.iterations)}, "
            f"initial cost {self.initial_cost:.6e}, "
            f"final cost {self.final_cost:.6e}, "
            f"termination {self.termination_type.value} ({self.message})"
        )

    def full_report(self) -> str:
        """Human-readable rollup (reference: Summary::FullReport)."""
        lines = [
            "Solver report",
            "-------------",
            f"Parameter blocks    {self.num_parameter_blocks:>12d}",
            f"Parameters          {self.num_parameters:>12d}",
            f"Effective params    {self.num_effective_parameters:>12d}",
            f"Residual blocks     {self.num_residual_blocks:>12d}",
            f"Residuals           {self.num_residuals:>12d}",
            "",
            f"Minimizer           {self.minimizer_type.value}",
            f"Trust region        {self.trust_region_strategy_type.value}",
            f"Linear solver       "
            f"{self.linear_solver_type_used.value if self.linear_solver_type_used else 'n/a'}",
            f"Preconditioner      "
            f"{self.preconditioner_type_used.value if self.preconditioner_type_used else 'n/a'}",
            "",
            f"Initial cost        {self.initial_cost:.12e}",
            f"Final cost          {self.final_cost:.12e}",
            f"Termination         {self.termination_type.value} ({self.message})",
            "",
            f"Successful steps    {self.num_successful_steps:>12d}",
            f"Unsuccessful steps  {self.num_unsuccessful_steps:>12d}",
            f"Residual evals      {self.num_residual_evaluations:>12d}",
            f"Jacobian evals      {self.num_jacobian_evaluations:>12d}",
            f"Linear solves       {self.num_linear_solves:>12d}",
            "",
            f"Preprocessor time   {self.preprocessor_time_in_seconds:>12.6f} s",
            f"Minimizer time      {self.minimizer_time_in_seconds:>12.6f} s",
            f"  Residual eval     {self.residual_evaluation_time_in_seconds:>12.6f} s",
            f"  Jacobian eval     {self.jacobian_evaluation_time_in_seconds:>12.6f} s",
            f"  Linear solver     {self.linear_solver_time_in_seconds:>12.6f} s",
            f"Total time          {self.total_time_in_seconds:>12.6f} s",
        ]
        if self.execution_summary is not None:
            per_call = self.execution_summary.report_lines()
            if per_call:
                lines.append("")
                lines.extend(per_call)
        return "\n".join(lines)
