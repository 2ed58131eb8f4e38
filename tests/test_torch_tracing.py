"""The spans and counters of a solve (utils/execution_summary.py): the
records of a bundle-adjustment solve on the fused and the host loop, their
nesting, the timings the Summary takes from them, the uploads' bytes, the
device reads, and their copies on torch.profiler's clock. The card's case
(CUDA graph captures, the allocator's growth) is marked `cuda`."""

import json

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.utils import execution_summary as es_mod
from ceres_tpu_torch.utils.execution_summary import ExecutionSummary, counts, recording, span

F64 = torch.float64

# each span's parent in a fused solve of a fresh problem
PARENTS = {
    "Solve": None,
    "Solve::Preprocess": "Solve",
    "Program::Lower": "Solve::Preprocess",
    "Program::Layout": "Program::Lower",
    "Program::Groups": "Program::Lower",
    "Program::SchurOrdering": "Solve::Preprocess",
    "Evaluator::Build": "Solve::Preprocess",
    "Solve::Minimize": "Solve",
    "Minimizer::Start": "Solve::Minimize",
    "Evaluator::Jacobian": "Minimizer::Start",
    "FusedLoop::Chunk": "Solve::Minimize",
    "LM::Iteration": "FusedLoop::Chunk",
    "LM::Step": "LM::Iteration",
    "LM::Decide": "LM::Iteration",
    "LM::Accept": "LM::Iteration",
    "Solve::WriteBack": "Solve",
    "Program::WriteStateBack": "Solve::WriteBack",
}
READ_PARENTS = {"Evaluator::Jacobian", "LM::Step", "LM::Decide", "LM::Accept", "LM::Iteration"}


def _problem(seed=3):
    bal = ct.synthetic_bal(8, 60, 300, seed=seed)
    return ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]


def _options(**kw):
    base = dict(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=6, function_tolerance=0.0, gradient_tolerance=0.0,
        parameter_tolerance=0.0, logging_type=ct.LoggingType.SILENT, device="cpu", dtype=F64,
    )
    return ct.SolverOptions(**{**base, **kw})


def _parent_names(ex):
    recs = ex.spans()
    return [(r.name, None if r.parent < 0 else recs[r.parent].name) for r in recs]


@pytest.mark.parametrize("chunk", [1, 20])
def test_fused_solve_records_each_span_under_its_parent(chunk):
    s = ct.solve(_options(fused_execution_chunk_iters=chunk), _problem())
    assert s.used_fused_execution
    ex = s.execution_summary
    seen = set()
    for name, parent in _parent_names(ex):
        if name == "Device::Read":
            assert parent in READ_PARENTS
            continue
        if name == "Python::GC":  # under whatever span the collector interrupted
            continue
        assert PARENTS[name] == parent, name
        seen.add(name)
    assert seen == set(PARENTS)
    n_it = len(s.iterations) - 1
    assert ex.calls("LM::Iteration") == ex.calls("LM::Step") == ex.calls("LM::Decide") == n_it
    assert ex.calls("LM::Accept") == s.num_successful_steps
    assert ex.calls("FusedLoop::Chunk") == -(-n_it // chunk)
    assert ex.calls("Solve") == ex.calls("Minimizer::Start") == 1
    # every span closed, inside its parent
    recs = ex.spans()
    for r in recs:
        assert r.end_ns >= r.start_ns > 0
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_a_second_solve_lowers_nothing():
    problem = _problem()
    ct.solve(_options(max_num_iterations=1), problem)
    s = ct.solve(_options(max_num_iterations=1), problem)
    names = set(s.execution_summary.names())
    # nor builds an Evaluator: the Program kept the first solve's workspace
    assert "Program::Lower" not in names and "Evaluator::Build" not in names
    assert s.execution_summary.calls("Solve::Reuse") == 1


@pytest.mark.parametrize("fused", [True, False, "sparse_schur"])
def test_device_read_spans_are_the_counted_reads(fused):
    """The fused loop, the host loop and a host loop whose step factors on
    the host (SPARSE_SCHUR): the Summary's reads and replays are the
    counter table's, the spans' and the iterations'; the host
    factorization's records land in the solve's summary, which nothing
    passed it."""
    if fused == "sparse_schur":
        options = _options(fused_execution=False,
                           linear_solver_type=ct.LinearSolverType.SPARSE_SCHUR,
                           preconditioner_type=ct.PreconditionerType.JACOBI)
    else:
        options = _options(fused_execution=fused)
    before = counts()
    s = ct.solve(options, _problem())
    counted = counts() - before
    assert s.used_fused_execution == (fused is True)
    ex = s.execution_summary
    assert ex.calls("Device::Read") == s.num_device_reads == counted["Device::Read"] > 0
    assert sum(it.num_device_reads for it in s.iterations) == s.num_device_reads
    replays = sum(ex.calls(n) for n in ex.names() if n.startswith("CUDAGraph::Replay "))
    assert replays == s.num_graph_replays == counted["CUDAGraph::Replay"]
    assert sum(it.num_graph_replays for it in s.iterations) == s.num_graph_replays
    assert "Device::Read" in "\n".join(ex.report_lines())
    if fused == "sparse_schur":
        assert ex.calls("SparseSchur::Read") == ex.calls("SparseSchur::HostSolve") \
            == ex.calls("SparseSchur::Explicit") == s.num_linear_solves > 0
        assert ex.nbytes("SparseSchur::Read") > 0


@pytest.mark.parametrize("chunk", [1, 4, 20])
def test_iteration_spans_are_the_iterations_times(chunk):
    # a process's first solve also imports the minimizer's modules
    ct.solve(_options(max_num_iterations=1), _problem())
    s = ct.solve(_options(fused_execution_chunk_iters=chunk, max_num_iterations=8), _problem())
    ex = s.execution_summary
    its = ex.spans("LM::Iteration")
    assert [it.iteration_time_in_seconds for it in s.iterations[1:]] == [r.seconds for r in its]
    assert s.iterations[0].iteration_time_in_seconds == ex.seconds("Minimizer::Start")
    total = sum(it.iteration_time_in_seconds for it in s.iterations)
    assert total == pytest.approx(s.minimizer_time_in_seconds, rel=0.02)
    assert s.iterations[-1].cumulative_time_in_seconds <= s.minimizer_time_in_seconds
    assert s.linear_solver_time_in_seconds == pytest.approx(ex.seconds("LM::Step"), rel=1e-12)
    assert s.jacobian_evaluation_time_in_seconds == pytest.approx(
        ex.seconds("Evaluator::Jacobian") + ex.seconds("LM::Accept"), rel=1e-12)
    assert s.preprocessor_time_in_seconds == ex.seconds("Solve::Preprocess")
    assert s.minimizer_time_in_seconds == ex.seconds("Solve::Minimize")
    assert s.total_time_in_seconds == ex.seconds("Solve")
    # the stages account for the iteration
    stages = sum(ex.seconds(n) for n in ("LM::Step", "LM::Decide", "LM::Accept"))
    assert stages <= ex.seconds("LM::Iteration")
    assert ex.self_seconds("LM::Iteration") == pytest.approx(
        ex.seconds("LM::Iteration") - stages, abs=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_uploads_count_the_bytes_of_the_tensors_made(dtype):
    problem = _problem()
    ct.solve(_options(dtype=dtype, max_num_iterations=1), problem)  # fills the cached tables
    # another key: a new Evaluator uploads the Program's tables and the state
    s = ct.solve(_options(dtype=dtype, max_num_iterations=2), problem)
    program = problem.compile("cpu")
    made = ExecutionSummary()
    with recording(made):
        tensors = torch.utils._pytree.tree_leaves(program.arrays(dtype))
        state = program.state_vector(dtype)
    nbytes = sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))
    state_nbytes = state.numel() * state.element_size()
    assert made.nbytes("Device::Upload") == nbytes + state_nbytes
    assert s.execution_summary.nbytes("Device::Upload") == nbytes + state_nbytes
    assert s.execution_summary.calls("Device::Upload") == made.calls("Device::Upload")
    # the same key again: the kept workspace, so the state alone
    again = ct.solve(_options(dtype=dtype, max_num_iterations=2), problem)
    assert again.execution_summary.nbytes("Device::Upload") == state_nbytes
    assert again.execution_summary.calls("Device::Upload") == 1


def test_host_loop_iterations_are_spans():
    s = ct.solve(_options(fused_execution=False), _problem())
    ex = s.execution_summary
    assert not s.used_fused_execution
    assert ex.calls("TrustRegion::Iteration") == len(s.iterations) - 1
    for name, parent in _parent_names(ex):
        if name == "TrustRegion::Iteration":
            assert parent == "Solve::Minimize"


def _trace_events(tmp_path, run):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_spans_reach_the_profiler_nested_as_recorded(tmp_path):
    s, events = _trace_events(tmp_path, lambda: ct.solve(_options(), _problem()))
    recs = s.execution_summary.spans()
    by_name = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        by_name.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    # the k-th record of a name is the k-th annotation of that name
    seen = {}
    where = []
    for r in recs:
        k = seen.get(r.name, 0)
        seen[r.name] = k + 1
        assert len(by_name.get(r.name, [])) > k, r.name
        where.append(by_name[r.name][k])
    for r, (a, b) in zip(recs, where):
        if r.parent >= 0:
            pa, pb = where[r.parent]
            assert pa <= a and b <= pb, (r.name, recs[r.parent].name)
    for name, n in seen.items():
        assert len(by_name[name]) == n


def test_write_state_back_outside_a_solve_goes_to_the_profiler_only(tmp_path):
    problem = _problem()
    program = problem.compile("cpu")
    _, events = _trace_events(tmp_path, lambda: program.write_state_back(program.state0))
    assert [e["name"] for e in events] == ["Program::WriteStateBack"]
    assert es_mod._sink is es_mod._NULL


class _Counting:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counting.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_without_a_profiler_no_record_function_is_entered(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    s = ct.solve(_options(), _problem())
    assert _Counting.entered == 0 and len(s.execution_summary.spans()) > 20
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        s = ct.solve(_options(), _problem())
    assert _Counting.entered == len(s.execution_summary.spans())


def test_execution_summary_derives_its_totals_from_records_and_counters():
    ex = ExecutionSummary()
    with recording(ex):
        assert es_mod._sink is ex
        with span("A") as a:
            with span("B"):
                pass
            with span("B") as b:
                b.calls = 3
            es_mod.record("Bytes", nbytes=7)
            es_mod.record("Bytes", nbytes=5, calls=2)
        ex.record("A", 0.5)
    assert es_mod._sink is es_mod._NULL
    recs = ex.spans()
    assert [(r.name, r.parent, r.calls) for r in recs] == [("A", -1, 1), ("B", 0, 1), ("B", 0, 3)]
    assert ex.spans("B") == recs[1:]
    assert ex.calls("A") == 2 and ex.calls("B") == 4 and ex.calls("Bytes") == 3
    assert ex.nbytes("Bytes") == 12 and ex.nbytes("A") == 0
    assert ex.seconds("A") == pytest.approx(a.seconds + 0.5)
    assert ex.self_seconds("A") == pytest.approx(
        recs[0].seconds - recs[1].seconds - recs[2].seconds)
    assert ex.names() == ["A", "B", "Bytes"]
    lines = ex.report_lines()
    assert len(lines) == 4 and lines[2].split()[:2] == ["B", "4"]
    # outside a solve a span keeps nothing but still times its block
    with span("C") as c:
        pass
    assert c.seconds >= 0.0 and "C" not in ex.names()


def test_scoped_records_into_its_own_summary():
    outer, own = ExecutionSummary(), ExecutionSummary()
    with recording(outer):
        with own.scoped("X"):
            with span("Y"):
                pass
    assert own.names() == ["X"] and outer.names() == ["Y"]
    assert outer.spans("Y")[0].parent == -1


def test_solve_restores_the_outer_sink():
    outer = ExecutionSummary()
    with recording(outer):
        with span("Outer"):
            s = ct.solve(_options(max_num_iterations=1), _problem())
    assert outer.names() == ["Outer"]
    assert s.execution_summary.spans()[0].name == "Solve"
    assert s.execution_summary.spans("Solve")[0].parent == -1


def test_collections_inside_a_solve_are_spans():
    """A run of the cyclic collector inside a solve is a Python::GC span
    under the span it interrupted; the hook is gone after the solve."""
    import gc

    def collect(_):
        gc.collect()
        return ct.CallbackReturnType.SOLVER_CONTINUE

    s = ct.solve(_options(callbacks=[collect], max_num_iterations=3), _problem())
    assert not s.used_fused_execution
    parents = [p for n, p in _parent_names(s.execution_summary) if n == "Python::GC"]
    assert parents.count("TrustRegion::Iteration") >= 3
    assert es_mod._collection not in gc.callbacks
    made = ExecutionSummary()
    gc.collect()  # outside any recording: no span anywhere
    with recording(made):
        gc.collect()
    assert made.calls("Python::GC") == 1


@pytest.mark.cuda
def test_card_solve_records_captures_and_the_pools_it_left():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graphs have no CPU mode")
    # 40,000 observations: the layout plans engage, so B4 is the matvec
    bal = ct.synthetic_bal(32, 4000, 40_000, seed=2)
    problem = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]
    kw = dict(device="cuda", dtype=torch.float32, max_num_iterations=4)
    before = counts()
    s = ct.solve(_options(**kw), problem)
    counted = counts() - before
    ex = s.execution_summary
    captures = {n: ex.calls(n) for n in ex.names() if n.startswith("CUDAGraph::Capture ")}
    assert sum(captures.values()) == counted["CUDAGraph::Capture"] == 6
    assert set(captures) == {f"CUDAGraph::Capture {g}" for g in (
        "evaluate", "prepare", "finish_head", "pcg", "finish_tail", "decide")}
    parents = dict(_parent_names(ex))
    assert parents["CUDAGraph::Capture evaluate"] == "Evaluator::Jacobian"
    assert parents["CUDAGraph::Capture prepare"] == "Minimizer::Start"
    assert parents["CUDAGraph::Capture pcg"] == "LM::Step"
    assert parents["CUDAGraph::Capture decide"] == "LM::Decide"
    assert ex.nbytes("Device::Reserved") > 0
    assert ex.calls("Device::Read") == s.num_device_reads
    program = problem.compile("cuda")
    made = ExecutionSummary()
    with recording(made):
        program.arrays(torch.float32)
        program.state_vector(torch.float32)
    assert 0 < made.nbytes("Device::Upload") <= ex.nbytes("Device::Upload")
    assert np.isfinite(s.final_cost) and s.final_cost < s.initial_cost
