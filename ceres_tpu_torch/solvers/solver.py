"""Solve facade: validate -> compile -> minimize -> summarize.

Port of `ceres_tpu.solvers.solver` (reference: Solver::Solve, solver.cc
:720-846). The device is resolved once here (utils.dtypes.resolve_device;
under a mesh the rank's own, which options.device may name but not
change) and carried by the Program and the Evaluator; a mesh takes the
ShardedEvaluator (parallel/sharding.py).
"""

from __future__ import annotations

import copy
import dataclasses
import logging

import numpy as np
import torch

from ..evaluator import Evaluator
from ..loss import current_value
from ..ordering import ParameterBlockOrdering, eliminated_handles
from ..types import (
    LinearSolverType, MinimizerType, PreconditionerType, Summary, TerminationType,
)
from ..utils.dtypes import default_dtype, resolve_device
from ..utils.execution_summary import ExecutionSummary, counts, record, recording, span


def _check_gradients(options, program):
    """The failure message of the first group whose functor's autodiff
    Jacobians disagree with central differences, or None
    (ceres_tpu/solvers/solver.py:81-118; reference: check_gradients wraps
    every residual block in a GradientCheckingCostFunction, solver.cc
    :765-775). A group shares one functor, so one probe at its first
    block's current values covers every block's code path."""
    from ..gradient_checker import check_gradients

    for meta, idx in zip(program.groups, program.group_idx):
        params = [
            program.state0[program.x_offsets[ids[0]] : program.x_offsets[ids[0]] + pm.size]
            for pm, ids in zip(meta.positions, idx["block_ids"])
        ]
        res = check_gradients(
            meta.cost_function,
            params,
            data=tuple(d[0] for d in idx["data"]),
            manifolds=[pm.manifold for pm in meta.positions],
            relative_step_size=options.gradient_check_numeric_derivative_relative_step_size,
            relative_precision=options.gradient_check_relative_precision,
        )
        if not res.ok:
            return (
                f"Gradient check failed for cost function '{meta.cost_function.name}': "
                f"max relative error {res.max_relative_error:.3e}.\n{res.error_log}"
            )
    return None


def _rank_device(options, mesh):
    """The device of a sharded solve: the mesh's, which parallel.distributed
    chose by resolve_device's rule (never the CPU unless named). Raises
    when options.device names another."""
    resolve_device(mesh.device)  # its TF32 settings
    if options.device is not None:
        device = _normalized(resolve_device(options.device))
        if device != _normalized(mesh.device):
            raise ValueError(
                f"options.device {options.device} is not the mesh's device {mesh.device}"
            )
    return mesh.device


def _normalized(device):
    """cuda -> cuda:<current>, so that two names of one card compare equal."""
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def solve(options, problem) -> Summary:
    """Solve `problem`; its Summary's execution_summary holds the solve's
    spans and counters (utils.execution_summary): the whole under `Solve`,
    its parts under `Solve::Preprocess`, `Solve::Minimize` and
    `Solve::WriteBack`, and on a card the growth of the allocator's
    reserved memory under `Device::Reserved`.

    The Problem keeps its solve workspace on the card between solves: the
    Program's device tables, the CUDA graphs and their memory pools (about
    6.5 GB at BAL Venice-1778's size in float32; evaluator.Workspace). A
    later solve of the unchanged Problem with the same dtype, device and
    options uploads only the state and replays the graphs (a
    `Solve::Reuse` counter); any other solve builds a new workspace and
    drops the old one at once. A change to the Problem drops it with its
    Program; so does dropping the Problem. A sharded solve (`mesh`) builds
    its own every time."""
    summary = Summary()
    summary.execution_summary = ExecutionSummary()
    with recording(summary.execution_summary), span("Solve") as whole:
        _solve(options, problem, summary)
    summary.total_time_in_seconds = whole.seconds
    return summary


def _reserved():
    """The allocator's reserved bytes on each card (none before CUDA is
    initialized)."""
    if not torch.cuda.is_initialized():
        return [0] * torch.cuda.device_count()
    return [torch.cuda.memory_reserved(i) for i in range(torch.cuda.device_count())]


def _solve(options, problem, summary):
    reserved0 = _reserved()
    # ---- preprocess (reference: trust_region_preprocessor.cc:373-405) ----
    with span("Solve::Preprocess") as pre:
        ready = _preprocess(options, problem, summary)
    summary.preprocessor_time_in_seconds = pre.seconds
    if ready is None:
        return
    options, program, evaluator, state = ready

    # ---- minimize ----
    with span("Solve::Minimize") as mini:
        before = counts()
        if options.minimizer_type == MinimizerType.TRUST_REGION:
            from .trust_region import TrustRegionMinimizer

            minimizer = TrustRegionMinimizer(program, options, evaluator)
        else:
            from .line_search import LineSearchMinimizer

            minimizer = LineSearchMinimizer(program, options, evaluator)
        final_state = minimizer.minimize(state, summary)
    summary.minimizer_time_in_seconds = mini.seconds
    counted = counts() - before
    summary.num_device_reads = counted["Device::Read"]
    summary.num_graph_replays = counted["CUDAGraph::Replay"]
    for name, n in counted.items():
        if name.startswith("CUDAGraph::Replay "):
            record(name, calls=n)

    # ---- postprocess ----
    with span("Solve::WriteBack") as post:
        host = final_state.double().cpu()
        if host is final_state:  # the solve's own memory: copy it
            program.write_state_back(host.numpy())
        else:  # a fresh host copy that nothing else holds
            program.adopt_state(host.numpy())
    summary.postprocessor_time_in_seconds = post.seconds
    device = program.device
    if device.type == "cuda":
        # what the solve left reserved: its CUDA graphs' private pools
        i = torch.cuda.current_device() if device.index is None else device.index
        record("Device::Reserved", nbytes=torch.cuda.memory_reserved(i) - reserved0[i])


def _preprocess(options, problem, summary):
    """Validate, lower and bind: (options, program, evaluator, state), the
    options as the solve runs them, or None with the summary filled where
    the solve ends here."""
    ok, msg = options.is_valid()
    if not ok:
        summary.termination_type = TerminationType.FAILURE
        summary.message = f"Invalid options: {msg}"
        return None

    mesh = options.mesh
    if mesh is not None and options.preconditioner_type == PreconditionerType.SUBSET:
        # SUBSET's apply is a host sparse solve over the whole Q (ceres_tpu/
        # solvers/solver.py:121-135): a sharded solve downgrades, loudly
        logging.getLogger(__name__).warning(
            "SUBSET preconditioner is host-bound and unavailable for sharded solves; "
            "downgrading to JACOBI"
        )
        options = copy.copy(options)
        options.preconditioner_type = PreconditionerType.JACOBI
    device = resolve_device(options.device) if mesh is None else _rank_device(options, mesh)
    dtype = options.dtype or default_dtype()
    summary.minimizer_type = options.minimizer_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    summary.linear_solver_type_used = options.linear_solver_type
    summary.preconditioner_type_used = options.preconditioner_type

    program = problem.compile(device)
    # the counts of what the Program lowered (the Problem's, counted once)
    summary.num_parameter_blocks = program.num_parameter_blocks
    summary.num_parameters = program.num_parameters
    summary.num_effective_parameters = program.num_effective_parameters
    summary.num_residual_blocks = program.num_residual_blocks
    summary.num_residuals = program.num_residuals
    # the user's linear_solver_ordering pins the eliminated set (reference:
    # reorder_program.cc; ceres_tpu/solvers/solver.py:47-58): a flat handle
    # sequence or a ParameterBlockOrdering, whose first group is eliminated
    ordering = options.linear_solver_ordering
    program.set_eliminated_blocks(None if ordering is None else eliminated_handles(ordering))
    # the SUBSET preconditioner's rows (ceres_tpu/solvers/solver.py:61-67);
    # left empty, the step raises the JAX package's ValueError
    subset = options.residual_blocks_for_subset_preconditioner
    program.subset_rows = (
        problem.residual_rows_for_handles(subset)
        if options.preconditioner_type == PreconditionerType.SUBSET and subset
        else None
    )
    summary.num_parameter_blocks_reduced = summary.num_parameter_blocks
    summary.num_parameters_reduced = summary.num_parameters
    summary.num_effective_parameters_reduced = program.num_effective_parameters
    summary.num_residual_blocks_reduced = program.num_residual_blocks
    summary.num_residuals_reduced = program.num_residuals

    if program.num_residuals == 0:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Problem has no residual blocks."
        return None

    if options.check_gradients:
        message = _check_gradients(options, program)
        if message is not None:
            summary.termination_type = TerminationType.FAILURE
            summary.message = message
            return None

    if options.linear_solver_type in (
        LinearSolverType.ITERATIVE_SCHUR, LinearSolverType.DENSE_SCHUR,
        LinearSolverType.SPARSE_SCHUR,
    ):
        # the elimination ordering is preprocessing (reference:
        # trust_region_preprocessor.cc, ReorderProgram); cached per Program
        with span("Program::SchurOrdering"):
            program.schur_tangent_masks()
    if mesh is not None:
        from ..parallel.sharding import ShardedEvaluator

        evaluator = ShardedEvaluator(program, mesh, dtype=dtype)
    else:
        evaluator = _evaluator(options, program, dtype)
    return options, program, evaluator, program.state_vector(dtype)


def _evaluator(options, program, dtype):
    """The solve's Evaluator over the Program's kept workspace (its tables,
    graphs and their buffers) where the Program's last solve had an equal
    key, counted as `Solve::Reuse`; else over a new one, which replaces
    it."""
    # the losses as they are now: a LossFunctionWrapper's reset() swaps its
    # loss inside the same Program
    key = (dtype, _normalized(program.device), _options_key(options), program.user_e_blocks,
           None if program.subset_rows is None else program.subset_rows.tobytes(),
           tuple(current_value(meta.loss) for meta in program.groups))
    kept = program.workspace
    if kept is not None and kept.key == key:
        record("Solve::Reuse")
        return Evaluator(program, dtype=dtype, workspace=kept)
    program.release_workspace()
    evaluator = Evaluator(program, dtype=dtype)
    evaluator.workspace.key = key
    program.workspace = evaluator.workspace
    return evaluator


def _options_key(options):
    """Every field of `options` as a value that compares by content: the
    captured functions bake option values into their graphs, so any field
    may change what a kept graph computes."""
    return tuple((f.name, _frozen(getattr(options, f.name))) for f in dataclasses.fields(options))


def _frozen(value):
    if isinstance(value, ParameterBlockOrdering):
        return tuple(sorted((g, tuple(els)) for g, els in value.group_to_elements().items()))
    if isinstance(value, (set, frozenset)):
        return frozenset(value)
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, (list, tuple)):
        return tuple(_frozen(v) for v in value)
    return value
