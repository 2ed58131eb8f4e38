"""The solve workspace a Problem keeps between solves (solvers/solver.py,
evaluator.Workspace): the Program's device tables, the CUDA graphs and the
buffers they read in place. A second solve of an unchanged Problem with the same dtype,
device and options reuses it (`Solve::Reuse`) and gives the same answer,
bitwise, as a solve of a freshly built Problem; any change to the key or to
the Problem builds anew and drops the old workspace at once; dropping the
Problem drops it. The card's case (three solves at chip_smoke.py's size:
the captures, the reserved memory, the states) is marked `cuda`.

The file imports no JAX: `python -m pytest --noconftest
tests/test_torch_workspace.py` runs it on a machine that has only PyTorch."""

import gc
import weakref

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct

F64 = torch.float64
SCHUR = dict(linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
             preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI)


def _problem(loss=None, seed=3):
    bal = ct.synthetic_bal(8, 60, 300, seed=seed)
    return ct.build_ba_problem(bal, loss=loss or ct.HuberLoss(1.0))


def _options(**kw):
    base = dict(
        **SCHUR, max_num_iterations=4, function_tolerance=0.0, gradient_tolerance=0.0,
        parameter_tolerance=0.0, logging_type=ct.LoggingType.SILENT, device="cpu", dtype=F64,
    )
    return ct.SolverOptions(**{**base, **kw})


def _run(options, problem, program, x0):
    """A solve from x0: (summary, final state, cost history)."""
    program.write_state_back(x0)
    s = ct.solve(options, problem)
    return s, program.state0.copy(), [it.cost for it in s.iterations]


# the paths a solve takes: the fused and the host loop, dogleg (whose finish
# graph reads the evaluator's step-kind log), CGNR, mixed precision,
# inner iterations and the line-search minimizer
PATHS = {
    "fused": {},
    "fused_f32": {"dtype": torch.float32},
    "host_loop": {"fused_execution": False},
    "dogleg": {"trust_region_strategy_type": ct.TrustRegionStrategyType.DOGLEG},
    "cgnr": {"linear_solver_type": ct.LinearSolverType.CGNR,
             "preconditioner_type": ct.PreconditionerType.JACOBI},
    "mixed": {"use_mixed_precision_solves": True},
    "inner": {"use_inner_iterations": True},
    "line_search": {"minimizer_type": ct.MinimizerType.LINE_SEARCH},
}


@pytest.mark.parametrize("path", list(PATHS))
def test_a_second_solve_reuses_the_workspace(path):
    options = _options(**PATHS[path])
    problem, _, _ = _problem()
    program = problem.compile("cpu")
    x0 = program.state0.copy()
    first, _, _ = _run(options, problem, program, x0)
    kept = program.workspace
    again, state, costs = _run(options, problem, program, x0)
    assert program.workspace is kept
    assert first.execution_summary.calls("Solve::Reuse") == 0
    assert again.execution_summary.calls("Solve::Reuse") == 1
    assert "Evaluator::Build" not in again.execution_summary.names()
    assert "Solve::Reuse" in again.full_report()
    # the state is the only upload
    assert again.execution_summary.nbytes("Device::Upload") == x0.size * (
        torch.finfo(options.dtype).bits // 8)
    fresh_problem, _, _ = _problem()
    fresh_program = fresh_problem.compile("cpu")
    fresh, fresh_state, fresh_costs = _run(options, fresh_problem, fresh_program, x0)
    assert fresh.execution_summary.calls("Solve::Reuse") == 0
    assert costs == fresh_costs and len(costs) > 1
    assert np.array_equal(state, fresh_state)
    assert again.termination_type == fresh.termination_type


def _constant(problem, cams, pts, wrapper):
    problem.set_parameter_block_constant(int(cams[0]))


def _add_residual(problem, cams, pts, wrapper):
    prior = ct.CostFunction(lambda p, d: p[0][:3] - d[0], 3, name="prior")
    problem.add_residual_block(prior, None, [int(cams[1])], (np.zeros(3),))


def _remove_block(problem, cams, pts, wrapper):
    problem.remove_parameter_block(int(pts[0]))


def _set_manifold(problem, cams, pts, wrapper):
    problem.set_manifold(int(cams[2]), ct.SubsetManifold(9, (8,)))


def _ordering(problem, cams, pts, wrapper):
    return {"linear_solver_ordering": [int(p) for p in pts]}


def _loss_reset(problem, cams, pts, wrapper):
    wrapper.reset(ct.CauchyLoss(1.0))


# what changes between the two solves: an option of the key, the Problem
# (a new Program), or, inside the same Program, the eliminated set and the
# loss a LossFunctionWrapper wraps
CHANGES = {
    "dtype": {"dtype": torch.float32},
    "linear_solver_type": {"linear_solver_type": ct.LinearSolverType.CGNR},
    "preconditioner_type": {"preconditioner_type": ct.PreconditionerType.JACOBI},
    "eta": {"eta": 0.05},
    "max_linear_solver_iterations": {"max_linear_solver_iterations": 7},
    "set_parameter_block_constant": _constant,
    "add_residual_block": _add_residual,
    "remove_parameter_block": _remove_block,
    "set_manifold": _set_manifold,
    "linear_solver_ordering": _ordering,
    "loss_reset": _loss_reset,
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_changed_key_or_problem_builds_anew(change):
    wrapper = ct.LossFunctionWrapper(ct.HuberLoss(1.0))
    problem, cams, pts = _problem(loss=wrapper)
    options = _options()
    ct.solve(options, problem)
    old = weakref.ref(problem.compile("cpu").workspace)
    what = CHANGES[change]
    if callable(what):
        what = what(problem, cams, pts, wrapper) or {}
    s = ct.solve(_options(**what), problem)
    ex = s.execution_summary
    assert ex.calls("Solve::Reuse") == 0 and ex.calls("Evaluator::Build") == 1
    assert np.isfinite(s.final_cost) and s.final_cost < s.initial_cost
    # the replaced workspace was released at once, not left for the collector
    assert old() is None
    assert problem.compile("cpu").workspace is not None


@pytest.mark.parametrize("collect", [False, True])
def test_dropping_the_problem_drops_the_workspace(collect):
    """The workspace refers to no Program, so it goes with the Problem by
    reference counting, and with a collection too."""
    problem, _, _ = _problem()
    ct.solve(_options(), problem)
    ws = weakref.ref(problem.compile("cpu").workspace)
    assert ws() is not None
    gc.disable()
    try:
        del problem
        if collect:
            gc.collect()
        assert ws() is None
    finally:
        gc.enable()


def _blocks_match_the_state(problem, program, handles):
    for b in handles:
        o = int(program.x_offsets[b])
        value = problem.parameter_block_value(int(b))
        assert np.array_equal(value, program.state0[o : o + value.size]), b


@pytest.mark.parametrize("change", ["none", "set_parameter_block_constant",
                                    "remove_parameter_block"])
def test_the_write_back_plan_is_built_once_per_program(change):
    """The first solve of a Problem builds the Program's write-back plan
    (`Program::WriteBackPlan`: one build, its index bytes); a later solve of
    the same Program reuses it, and a structural change, which lowers a new
    Program, builds it again."""
    problem, cams, pts = _problem()
    options = _options()
    first = ct.solve(options, problem)
    ex = first.execution_summary
    assert ex.calls("Program::WriteBackPlan") == 1
    assert ex.nbytes("Program::WriteBackPlan") == 8 * (len(cams) + len(pts))
    assert "Program::WriteBackPlan" in first.full_report()
    _blocks_match_the_state(problem, problem.compile("cpu"), (*cams, *pts))
    live = list(pts)
    if change == "set_parameter_block_constant":
        problem.set_parameter_block_constant(int(cams[0]))
    elif change == "remove_parameter_block":
        problem.remove_parameter_block(int(pts[0]))
        live = live[1:]
    start = problem.compile("cpu").state0.copy()
    again = ct.solve(options, problem)
    ex = again.execution_summary
    assert ex.calls("Program::WriteBackPlan") == (change != "none")
    if change == "remove_parameter_block":  # the points' add holds its kept positions too
        assert ex.nbytes("Program::WriteBackPlan") == 8 * (len(cams) + 2 * len(live))
    program = problem.compile("cpu")
    _blocks_match_the_state(problem, program, (*cams, *live))
    # the same solve on a Problem lowered afresh gives the same state
    twin, twin_cams, twin_pts = _problem()
    if change == "set_parameter_block_constant":
        twin.set_parameter_block_constant(int(twin_cams[0]))
    elif change == "remove_parameter_block":
        twin.remove_parameter_block(int(twin_pts[0]))
    twin.compile("cpu").write_state_back(start)
    ct.solve(options, twin)
    assert np.array_equal(program.state0, twin.compile("cpu").state0)


def _card_options(**kw):
    return ct.SolverOptions(**{**dict(
        **SCHUR, eta=0.1, max_linear_solver_iterations=25, max_num_iterations=5,
        function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
        logging_type=ct.LoggingType.SILENT, device="cuda", dtype=torch.float32), **kw})


def _captures(summary):
    ex = summary.execution_summary
    return sum(ex.calls(n) for n in ex.names() if n.startswith("CUDAGraph::Capture "))


@pytest.mark.cuda
def test_three_card_solves_capture_once_and_hold_their_memory():
    """Three solves of one Problem at chip_smoke.py's size (BAL-1778's
    counts, 5,000,000 observations, float32, SCHUR_JACOBI, 5 iterations)
    from the same start: the first captures the six graphs, the others
    replay them; the allocator's reserved memory after the third equals
    that after the second; the three final states are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graphs have no CPU mode")
    bal = ct.synthetic_bal(1778, 993923, 5_000_000, seed=0)
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    program = problem.compile("cuda")
    x0 = program.state0.copy()
    options = _card_options()
    runs, reserved = [], []
    for _ in range(3):
        runs.append(_run(options, problem, program, x0))
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    summaries = [s for s, _, _ in runs]
    assert [_captures(s) for s in summaries] == [6, 0, 0]
    assert [s.execution_summary.calls("Solve::Reuse") for s in summaries] == [0, 1, 1]
    assert reserved[2] == reserved[1]
    assert summaries[2].execution_summary.nbytes("Device::Reserved") == 0
    # the state is the only upload of a reused solve
    assert summaries[1].execution_summary.nbytes("Device::Upload") == 4 * x0.size
    for _, state, costs in runs[1:]:
        assert np.array_equal(state, runs[0][1])
        assert costs == runs[0][2]
    assert summaries[0].final_cost < summaries[0].initial_cost


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "host_loop", "dogleg", "cgnr", "mixed", "line_search"])
def test_a_reused_card_solve_replays_every_graph(path):
    """On each path a second solve of the same Problem captures nothing and
    repeats the first bitwise (CGNR to its run-to-run spread: index_add_
    adds atomically on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graphs have no CPU mode")
    # 40,000 observations: the layout plans engage, so B4 is the matvec
    bal = ct.synthetic_bal(32, 4000, 40_000, seed=2)
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    program = problem.compile("cuda")
    x0 = program.state0.copy()
    options = _card_options(**{**PATHS[path], "dtype": torch.float64})
    first, state1, costs1 = _run(options, problem, program, x0)
    again, state2, costs2 = _run(options, problem, program, x0)
    assert _captures(first) > 0 and _captures(again) == 0
    assert again.execution_summary.calls("Solve::Reuse") == 1
    if path == "cgnr":
        np.testing.assert_allclose(costs2, costs1, rtol=1e-12)
    else:
        assert costs2 == costs1 and np.array_equal(state2, state1)
