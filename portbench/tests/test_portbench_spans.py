"""The span readers (metrics/<name>.py over spans.py) on synthetic
Summaries: each returns its value from a solve's spans and counters, and
nothing from a program whose summaries hold no spans."""

import importlib.util
import os
import types

import pytest

import roofline
import run
from ceres_tpu_torch.utils import execution_summary as esm
from ceres_tpu_torch.utils.execution_summary import ExecutionSummary, record, recording, span

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("evaluator_build_ms", "h2d_mb_per_solve", "captures_per_solve",
           "capture_ms_per_solve", "pool_gb_per_solve", "step_ms_per_iter",
           "evaluate_ms_per_accept")


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Clock:
    """perf_counter_ns that moves only when told to."""

    def __init__(self):
        self.t = 1_000_000

    def __call__(self):
        return self.t

    def ms(self, ms):
        self.t += int(round(ms * 1e6))


def synthetic_solve(clock, build_ms=40.0, upload=176_000_000, reserved=5_000_000_000,
                    step_ms=3.0, accept_ms=10.0, capture_ms=8.0, n_it=20, card=True):
    """The spans and counters of one fused solve: four captures in
    iteration 1 (two in Minimizer::Start), every odd iteration accepted."""
    ex = ExecutionSummary()
    with recording(ex), span("Solve"):
        with span("Solve::Preprocess"):
            with span("Evaluator::Build"):
                record("Device::Upload", nbytes=upload)
                clock.ms(build_ms)
        with span("Solve::Minimize"):
            with span("Minimizer::Start"):
                for g in ("evaluate", "prepare"):
                    with span(f"CUDAGraph::Capture {g}"):
                        clock.ms(capture_ms)
            with span("FusedLoop::Chunk"):
                for k in range(1, n_it + 1):
                    with span("LM::Iteration"):
                        with span("LM::Step"):
                            if k == 1:
                                for g in ("finish_head", "pcg", "finish_tail"):
                                    with span(f"CUDAGraph::Capture {g}"):
                                        clock.ms(capture_ms)
                            clock.ms(step_ms)
                        with span("LM::Decide"):
                            if k == 1:
                                with span("CUDAGraph::Capture decide"):
                                    clock.ms(capture_ms)
                            clock.ms(1.0)
                        if k % 2:
                            with span("LM::Accept"):
                                clock.ms(accept_ms + (50.0 if k == 1 else 0.0))
        with span("Solve::WriteBack"):
            clock.ms(2.0)
    if card:
        ex.record("Device::Reserved", 0.0, nbytes=reserved)
    return types.SimpleNamespace(execution_summary=ex, iterations=[])


def ctx_of(summaries):
    solves = [run.Solve(s, 0.5, None) for s in summaries]
    return run.Context({"obs": 1, "cameras": 1, "points": 1}, None, solves, None, roofline.load())


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(esm.time, "perf_counter_ns", c)
    return c


def test_each_reader_reads_its_span_or_counter(clock):
    ctx = ctx_of([synthetic_solve(clock),
                  synthetic_solve(clock, build_ms=60.0, upload=178_000_000,
                                  reserved=3_000_000_000, step_ms=5.0, accept_ms=12.0)])
    got = {name: reader(name)(ctx) for name in READERS}
    assert got["evaluator_build_ms"] == pytest.approx(50.0)
    assert got["h2d_mb_per_solve"] == pytest.approx(177.0)
    assert got["captures_per_solve"] == 6.0
    assert got["capture_ms_per_solve"] == pytest.approx(48.0)
    assert got["pool_gb_per_solve"] == pytest.approx(4.0)
    # iterations 2 to 20 only: iteration 1's captures and its accept stay out
    assert got["step_ms_per_iter"] == pytest.approx(4.0)
    assert got["evaluate_ms_per_accept"] == pytest.approx(11.0)


def test_readers_read_nothing_from_a_program_without_spans(clock):
    class Counters:
        """What an ExecutionSummary of counters alone answers."""

        def calls(self, name):
            return 6

        def seconds(self, name):
            return 0.0

        def nbytes(self, name):
            return 0

        def names(self):
            return ["CUDAGraph::Capture", "Device::Read"]

    for summaries in ([types.SimpleNamespace(execution_summary=Counters())],
                      [types.SimpleNamespace(execution_summary=None)],
                      [types.SimpleNamespace(execution_summary=ExecutionSummary())],
                      []):
        ctx = ctx_of(summaries)
        for name in READERS:
            assert reader(name)(ctx) is None, name


def test_pool_reads_nothing_off_the_card(clock):
    ctx = ctx_of([synthetic_solve(clock, card=False)])
    assert reader("pool_gb_per_solve")(ctx) is None
    assert reader("captures_per_solve")(ctx) == 6.0


def test_a_solve_of_one_iteration_has_no_steady_stage(clock):
    ctx = ctx_of([synthetic_solve(clock, n_it=1)])
    assert reader("step_ms_per_iter")(ctx) is None
    assert reader("evaluate_ms_per_accept")(ctx) is None
    assert reader("evaluator_build_ms")(ctx) == pytest.approx(40.0)
