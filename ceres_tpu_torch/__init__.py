"""ceres_tpu_torch — the PyTorch / CUDA port of ceres_tpu.

A second package beside `ceres_tpu` (which stays the JAX reference). It
mirrors ceres_tpu's module layout and names, and runs its trust-region
solves (Levenberg-Marquardt and dogleg, every linear solver; the sparse
direct factorizations on the host, as in the JAX package) on one NVIDIA
H100 through five hand-written CUDA kernels:

  B1 eval_kernel.py          fused Snavely evaluation, angle-axis and
                             quaternion cameras (csrc/eval_snavely.cu), and
                             B1 generic for any functor the generator
                             (functor_codegen.py) traces
                             (csrc/eval_generic.cuh)
  B2 gather_reduce.py        camera gather-contract F·y (csrc/gather_reduce.cu)
  B3 gather_reduce.py        deterministic camera contract-reduce Fᵀu
  B4 linalg/schur_kernels.py the fused implicit-Schur matvec (csrc/schur_sy.cuh)
  B5 linalg/schur_kernels.py the SCHUR_JACOBI block build (csrc/schur_p0.cu)

Beside the trust-region solves: the line-search minimizer
(solvers/line_search.py; `minimizer_type=LINE_SEARCH`), the first-order
API (gradient_problem.py), inner iterations (solvers/inner_iterations.py),
the host loop's problem dump and check_gradients (gradient_checker.py),
analytic and numeric-diff cost functions (autodiff.py; an analytic group
runs B1 generic with the user's Jacobian rule), the cost-function adapters
(cost_functions.py), every manifold of the JAX package, interpolation
(interpolation.py), checkpoints (checkpoint.py) and the evaluation
callback (`Problem(evaluation_callback=...)`); covariance (covariance.py:
DENSE_SVD and SPARSE_QR on the host, ITERATIVE_PCG as one batched PCG on
the card through B2 and B3 over a batch of columns) and the dense
multistart TinySolver (tiny_solver.py). A solve shards over several
processes (`SolverOptions(mesh=...)`, parallel/: one rank per shard, the
reductions all-reduced over torch.distributed; B1 masks the pad lanes).
The submodules `capi` (the C API's Python side, its embedding shim under
native/) and `io.native` (the C++ BAL parser that `load_bal` takes) are
built with the host's C++ compiler at first use.

On CPU tensors every kernel wrapper runs its plain PyTorch version instead.
Importing the package builds nothing; the kernels compile on first use on a
card (cuda_lib.py).
"""

from .autodiff import AnalyticCostFunction, CostFunction, NumericDiffCostFunction
from .covariance import Covariance, CovarianceOptions
from .cost_functions import (
    conditioned_cost_function,
    cost_function_to_functor,
    normal_prior,
    scaled_cost_function,
)
from .gradient_checker import GradientCheckResult, check_gradients
from .gradient_problem import GradientProblem, numeric_diff_first_order, solve_gradient_problem
from .io.bal import BalProblem, build_ba_problem, load_bal, load_bal_lazy, synthetic_bal
from .io.lazy import LazyRows
from .loss import (
    ArctanLoss,
    CauchyLoss,
    ComposedLoss,
    HuberLoss,
    LossFunction,
    LossFunctionWrapper,
    ScaledLoss,
    SoftLOneLoss,
    TolerantLoss,
    TrivialLoss,
    TukeyLoss,
)
from .manifolds import (
    AutoDiffManifold,
    EigenQuaternionManifold,
    EuclideanManifold,
    LineManifold,
    Manifold,
    ProductManifold,
    QuaternionManifold,
    SphereManifold,
    SubsetManifold,
)
from .ordering import ParameterBlockOrdering
from .problem import Problem
from .solvers.solver import solve
from .tiny_solver import TinySolverOptions, tiny_solve, tiny_solve_batched
from .types import (
    CallbackReturnType,
    CovarianceAlgorithmType,
    DoglegType,
    IterationSummary,
    LinearSolverType,
    LineSearchDirectionType,
    LineSearchInterpolationType,
    LineSearchType,
    LoggingType,
    MinimizerType,
    NonlinearConjugateGradientType,
    PreconditionerType,
    SolverOptions,
    Summary,
    TerminationType,
    TrustRegionStrategyType,
    VisibilityClusteringType,
)

__all__ = [
    "AnalyticCostFunction",
    "ArctanLoss",
    "AutoDiffManifold",
    "BalProblem",
    "CallbackReturnType",
    "CauchyLoss",
    "ComposedLoss",
    "CostFunction",
    "Covariance",
    "CovarianceAlgorithmType",
    "CovarianceOptions",
    "DoglegType",
    "EigenQuaternionManifold",
    "EuclideanManifold",
    "GradientCheckResult",
    "GradientProblem",
    "HuberLoss",
    "IterationSummary",
    "LineSearchDirectionType",
    "LineSearchInterpolationType",
    "LineSearchType",
    "LineManifold",
    "LinearSolverType",
    "LoggingType",
    "LossFunction",
    "LossFunctionWrapper",
    "Manifold",
    "MinimizerType",
    "NonlinearConjugateGradientType",
    "NumericDiffCostFunction",
    "ParameterBlockOrdering",
    "PreconditionerType",
    "Problem",
    "ProductManifold",
    "QuaternionManifold",
    "ScaledLoss",
    "SoftLOneLoss",
    "SolverOptions",
    "SphereManifold",
    "SubsetManifold",
    "Summary",
    "TerminationType",
    "TinySolverOptions",
    "TolerantLoss",
    "TrivialLoss",
    "TrustRegionStrategyType",
    "TukeyLoss",
    "VisibilityClusteringType",
    "build_ba_problem",
    "check_gradients",
    "conditioned_cost_function",
    "cost_function_to_functor",
    "load_bal",
    "load_bal_lazy",
    "LazyRows",
    "normal_prior",
    "numeric_diff_first_order",
    "scaled_cost_function",
    "solve",
    "solve_gradient_problem",
    "synthetic_bal",
    "tiny_solve",
    "tiny_solve_batched",
]
