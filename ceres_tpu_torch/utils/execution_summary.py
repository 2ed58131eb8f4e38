"""The port's one place for counts and timings: the spans and counters of
a solve, and the process-wide counter table.

reference: ExecutionSummary + ScopedExecutionTimer (execution_summary.h:89),
which accumulate cumulative call counts and seconds per call-site name
("Evaluator::Residual", "Evaluator::Jacobian", "LinearSolver::Solve") and
surface them through Evaluator::Statistics() into Summary::FullReport.

A solve's statistics come from two kinds of entry into the current sink:

- spans: `with span(name):` times its block on the host's clock
  (`time.perf_counter_ns`) and keeps one record (name, start, end, the
  index of the enclosing span's record) in the current sink. `solve` makes
  its Summary's ExecutionSummary the current sink for its duration
  (`recording`); outside a solve the sink keeps nothing. A span's own
  seconds are there either way (`.seconds`). While torch.profiler records,
  each span also enters `torch.profiler.record_function(name)`, so it
  shows as a `user_annotation` on the profiler's clock, beside the
  device's events; otherwise that costs one flag check. While a sink
  records, each run of Python's cyclic collector is a `Python::GC` span
  (it frees the earlier solves' CUDA graphs and tables, wherever it
  lands);
- counters: `record(name, seconds, calls=..., nbytes=...)`, cumulative per
  name: what a step counts rather than times (the device reads' bytes of a
  host factorization, the bytes uploaded, the growth of the allocator's
  reserved memory).

`calls`, `seconds`, `nbytes`, `names` and `report_lines` add the two up by
name; `spans` and `self_seconds` read the records.

Beside the sink, `count(name)` adds to one process-wide table what the
port counts whether or not a solve records: each kernel launch under the
kernel's counter name (cuda_lib.LAUNCHES), `Device::Read`,
`CUDAGraph::Capture`, `CUDAGraph::Replay` and `CUDAGraph::Replay <graph>`
(utils/graphs.py), `Mesh::AllReduce` and its `Mesh::AllReduce::Bytes`
(parallel.distributed), `CAPI::RoundTrip` and `CAPI::Call` (capi.py),
and `Kernel::GeneratedBuild` and `Kernel::GeneratedHit` (cuda_lib). A
snapshot (`counts()`) is a Counter, and `counts() - before` is what was
counted since `before`: a solve's Summary takes its reads and replays so,
and a CUDA graph's capture takes back what its capture counted
(`add_counts(diff, -1)`) and adds it once per replay.
"""

from __future__ import annotations

import collections
import gc
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch

_profiling = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    """One span: its name, its start and end (perf_counter_ns), the
    index of its parent's record (-1 at the top) and the calls it stands
    for (1 but where the block said otherwise, e.g. the sources one
    compiler run built)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    calls: int = 1

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class ExecutionSummary:
    """The spans (in start order) and counters of one solve."""

    def __init__(self):
        self._records = []  # [name, start_ns, end_ns, parent, calls], in start order
        self._open = []  # indices of the open spans, innermost last
        self._counters = {}  # name -> [calls, seconds, bytes]

    def record(self, name: str, seconds: float, calls: int = 1, nbytes: int = 0) -> None:
        ent = self._counters.setdefault(name, [0, 0.0, 0])
        ent[0] += calls
        ent[1] += seconds
        ent[2] += nbytes

    def scoped(self, name: str):
        """A span recorded into this summary, whichever sink is current."""
        return span(name, self)

    def _begin(self, name: str, t_ns: int) -> int:
        i = len(self._records)
        self._records.append([name, t_ns, 0, self._open[-1] if self._open else -1, 1])
        self._open.append(i)
        return i

    def _end(self, i: int, t_ns: int, calls: int) -> None:
        rec = self._records[i]
        rec[2] = t_ns
        rec[4] = calls
        self._open.pop()  # spans close innermost first (`with` blocks)

    def spans(self, name: str | None = None) -> list:
        """The spans' records (all, or those named `name`) in start order;
        a record's `parent` indexes `spans()`, and an open span's end_ns is
        0."""
        return [SpanRecord(*r) for r in self._records if name is None or r[0] == name]

    def self_seconds(self, name: str) -> float:
        """The seconds of the spans named `name` less those of their direct
        children."""
        recs = self._records
        own = {i: r[2] - r[1] for i, r in enumerate(recs) if r[0] == name and r[2]}
        for r in recs:
            if r[3] in own and r[2]:
                own[r[3]] -= r[2] - r[1]
        return sum(own.values()) * 1e-9

    def _totals(self) -> dict:
        out = {k: list(v) for k, v in self._counters.items()}
        for name, t0, t1, _, calls in self._records:
            if t1 and calls:  # a span that stood for no calls counts nothing
                ent = out.setdefault(name, [0, 0.0, 0])
                ent[0] += calls
                ent[1] += (t1 - t0) * 1e-9
        return out

    def calls(self, name: str) -> int:
        return self._totals().get(name, [0, 0.0, 0])[0]

    def seconds(self, name: str) -> float:
        return self._totals().get(name, [0, 0.0, 0])[1]

    def nbytes(self, name: str) -> int:
        return self._totals().get(name, [0, 0.0, 0])[2]

    def names(self):
        return sorted(self._totals())

    def report_lines(self):
        """Formatted block for Summary.full_report()."""
        totals = self._totals()
        if not totals:
            return []
        lines = [
            "Per-call statistics          calls      total s      mean ms        bytes",
        ]
        for name in sorted(totals):
            calls, secs, nbytes = totals[name]
            mean_ms = secs / calls * 1000.0 if calls else 0.0
            lines.append(
                f"  {name:<26s}{calls:>6d} {secs:>12.6f} {mean_ms:>12.3f} {nbytes:>12d}"
            )
        return lines


class _Idle:
    """Records nothing: the sink outside `solve`."""

    def record(self, name, seconds, calls=1, nbytes=0):
        pass

    def _begin(self, name, t_ns):
        return -1

    def _end(self, i, t_ns, calls):
        pass


_NULL = _Idle()
_sink = _NULL


@contextmanager
def recording(summary):
    """Make `summary` (an ExecutionSummary) the current sink for the block,
    the collector's runs in it `Python::GC` spans."""
    global _sink
    outer, _sink = _sink, summary
    watch = _collection not in gc.callbacks
    if watch:
        gc.callbacks.append(_collection)
    try:
        yield summary
    finally:
        _sink = outer
        if watch:
            gc.callbacks.remove(_collection)


_collecting = []  # the open Python::GC span


def _collection(phase, info):
    """gc.callbacks hook: a collection's start opens a span, its stop
    closes it."""
    if phase == "start":
        _collecting.append(span("Python::GC").__enter__())
    elif _collecting:
        _collecting.pop().__exit__(None, None, None)


def record(name: str, seconds: float = 0.0, calls: int = 1, nbytes: int = 0) -> None:
    """A counter entry in the current sink."""
    _sink.record(name, seconds, calls, nbytes)


class span:
    """`with span(name) as s:` records the block as a span in the current
    sink (or in `sink`); `s.seconds` is its wall time once it closed, and
    `s.calls`, set inside the block, the calls the record stands for."""

    __slots__ = ("name", "sink", "index", "start_ns", "end_ns", "calls", "_rf")

    def __init__(self, name: str, sink=None):
        self.name = name
        self.sink = sink
        self.calls = 1
        self.end_ns = 0

    def __enter__(self):
        if self.sink is None:
            self.sink = _sink
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.start_ns = time.perf_counter_ns()
        self.index = self.sink._begin(self.name, self.start_ns)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self.sink._end(self.index, self.end_ns, self.calls)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_table = collections.Counter()  # the process-wide counter table


def count(name: str, n: int = 1, nbytes: int = 0) -> None:
    """Add n to the counter `name` of the process-wide table, and nbytes
    to `<name>::Bytes`."""
    _table[name] += n
    if nbytes:
        _table[name + "::Bytes"] += nbytes


def counts() -> collections.Counter:
    """A snapshot of the counter table; `counts() - before` is what was
    counted since the snapshot `before`."""
    return collections.Counter(_table)


def add_counts(diff, sign: int = 1) -> None:
    """Add a diff of two snapshots to the table (sign -1: take it back)."""
    if sign > 0:
        _table.update(diff)
    else:
        _table.subtract(diff)


def reset_counts() -> None:
    """Zero the table (tests)."""
    _table.clear()
