"""The host's tools for a loop whose state stays on the card.

`read` is the one way the solver loops bring a device value to the host.
Every read drains the stream: the card idles until the host has decided and
launched the next work. So each read is counted (`read_count`; the solve
reports the count in `Summary.num_device_reads` and per iteration) and
timed as a `Device::Read` span (the host's wait, utils.execution_summary),
and a read is allowed to synchronize even under
`torch.cuda.set_sync_debug_mode("error")`, so that a loop run in that mode
fails on any other synchronization. Reads of CPU tensors are counted the
same way, so the CPU tests check the loops' read budgets too. `upload` is
the other direction: a host array made a tensor on the device, its bytes
counted under `Device::Upload`.

`FnGraph` captures one call of a function of tensors and replays it;
`StepGraph` captures one call of a step that advances a list of state
tensors (`torch.cuda.graphs`). A graph reads and writes fixed addresses, and
its operands come in two kinds:

- fixed: tensors that keep their address and change only in place, on the
  stream: another graph's outputs (the Jacobian, its twins, the prepare
  cache, the inverse tables) and the Program's and the Evaluator's tables.
  The graph reads them where they are;
- copied: every other tensor (the per-iteration scalars and vectors), which
  `bind` copies into the graph's own buffers on every call.

A call whose fixed tensors are not those of the capture, or whose copied
shapes or other arguments differ, captures anew. A solve's graphs are its
Evaluator's, one per name (evaluator.Evaluator.fn_graph), in the workspace
a Program keeps from its last solve (solvers/solver.py), so that the next
solve with the same key replays them: every fixed tensor is another graph's
output, a workspace buffer or table, or a table of the Program. An
FnGraph's outputs are the same tensors from its first call on, rewritten by
every replay: the Jacobian an `evaluate` graph returns is the one later
graphs read in place, and the caller is done with an output before the next
call. The first call runs eagerly on a side stream (the warm-up PyTorch's graph docs ask for; it
also fills the Program's lazy device tables, whose uploads a capture would
refuse), then captures; an FnGraph copies the warm-up's results into its
outputs. Later calls replay. The kernels' ctypes wrappers launch on
`torch.cuda.current_stream()`, which is the capture stream during capture.
Their launch counts (cuda_lib), and the all-reduces of a sharded solve, are
taken back after the capture and added once per replay, so the counts stay
those of the work the card did.
"""

from __future__ import annotations

import collections
import gc

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import cuda_lib
from .execution_summary import record, span

_reads = 0
# a sharded solve's all-reduces and the bytes they move (parallel.
# distributed.Mesh.psum), kept here so that a graph takes them back after
# its capture and adds them per replay as it does the kernels' launches
_collectives = {"all_reduce": 0, "all_reduce_bytes": 0}
_graph_stats = {
    "captures": 0, "replays": 0,
    "replays_by": collections.Counter(),
}


def read(t):
    """The tensor `t` on the host (a CPU tensor), counted as one read."""
    global _reads
    _reads += 1
    with span("Device::Read"):
        if t.device.type != "cuda":
            return t.detach()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return t.detach().cpu()
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def upload(a, dtype=None, device=None):
    """torch.as_tensor(a, dtype, device) of a host array, its bytes counted
    under `Device::Upload` (on the CPU too: the bytes a card would take)."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    record("Device::Upload", nbytes=t.numel() * t.element_size())
    return t


def read_count() -> int:
    return _reads


def count_all_reduce(nbytes: int):
    """Count one all-reduce of nbytes."""
    _collectives["all_reduce"] += 1
    _collectives["all_reduce_bytes"] += nbytes


def collective_counts() -> dict:
    """All-reduces and their bytes so far."""
    return dict(_collectives)


def reset_collective_counts():
    for name in _collectives:
        _collectives[name] = 0


def _counts():
    """The launch and all-reduce counts, which a capture takes back."""
    return cuda_lib.launch_counts(), collective_counts()


def _add(counts, sign):
    launches, collectives = counts
    for name, n in launches.items():
        cuda_lib.count(name, sign * n)
    for name, n in collectives.items():
        _collectives[name] += sign * n


def graph_stats() -> dict:
    """Captures and replays (in all and by graph name) of every graph so
    far; a capture's seconds are its `CUDAGraph::Capture <graph>` span."""
    out = dict(_graph_stats)
    out["replays_by"] = collections.Counter(_graph_stats["replays_by"])
    return out


def _tensors(leaves):
    return [x for x in leaves if isinstance(x, torch.Tensor)]


class _Graph:
    """What StepGraph and FnGraph share: the bound operands, the warm-up,
    the capture and the counted replay."""

    def __init__(self, name: str):
        self.name = name
        self.copies = None
        self._fixed = None
        self._key = None
        self._graph = None
        self._counted = ({}, {})

    def bind(self, fixed, copied, key=None):
        """Hold the tensors of `fixed` (read in place) and copy those of
        `copied` into the graph's buffers; returns the buffers. New fixed
        tensors, copied shapes or `key` drop the capture."""
        key = (key, tuple((tuple(t.shape), t.dtype, t.device) for t in copied))
        same = (
            self._fixed is not None
            and key == self._key
            and len(fixed) == len(self._fixed)
            and all(a is b for a, b in zip(fixed, self._fixed))
        )
        if not same:
            self._fixed, self._key = list(fixed), key
            self.copies = [t.clone() for t in copied]
            self._graph = None
        else:
            for s, t in zip(self.copies, copied):
                s.copy_(t)
        return self.copies

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def release(self):
        """Drop the capture (and with it its private memory pool), the
        buffers and the fixed tensors it holds."""
        self._graph = self._fixed = self._key = self.copies = None

    def _warm_up(self, fn):
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        return out

    def _capture(self, fn):
        """Capture fn() on a side stream into a graph with its own memory
        pool. torch.cuda.graph's context would also synchronize and empty
        the allocator's cache, which costs milliseconds in the middle of a
        solve and which the capture does not need. The cyclic garbage
        collector is off while the stream captures: a collection there
        could destroy another graph, which CUDA forbids during a capture
        and which then invalidates it."""
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    out = fn()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(side)
        _graph_stats["captures"] += 1
        after = _counts()
        # the wrappers counted while capturing, but nothing ran
        self._counted = tuple(
            {k: a[k] - b[k] for k in a if a[k] != b[k]} for a, b in zip(after, before)
        )
        _add(self._counted, -1)
        self._graph = graph
        return out

    def _replay(self):
        self._graph.replay()
        _graph_stats["replays"] += 1
        _graph_stats["replays_by"][self.name] += 1
        _add(self._counted, 1)

    @property
    def launches_per_replay(self) -> dict:
        return dict(self._counted[0])


class StepGraph(_Graph):
    """One captured call of a step that advances the graph's state in
    place, replayed; see the module docstring. Used on CUDA tensors only."""

    def load(self, fixed, state, key=None):
        """Hold `fixed` (the tensors the step reads in place) and set the
        graph's state to copies of `state`; returns the state."""
        return self.bind(fixed, state, key)

    def _advance(self, fn):
        for s, new in zip(self.copies, fn(self.copies)):
            if new is not s:
                s.copy_(new)

    def step(self, fn):
        """Advance the state by fn(state) -> new state: eagerly on a side
        stream the first time (which then captures the step), later by
        replaying the capture."""
        if not self.captured:
            with span(f"CUDAGraph::Capture {self.name}"):
                self._warm_up(lambda: self._advance(fn))
                self._capture(lambda: self._advance(fn))
            return
        self._replay()


class FnGraph(_Graph):
    """One captured call of out = fn(fixed, *args), replayed; see the module
    docstring. `fixed`, `args` and `out` are nests of lists, tuples and
    dicts; the tensors of `fixed` are read in place, those of `args` copied
    in, and what else they hold is part of the capture's key. Used on CUDA
    tensors only."""

    def __init__(self, name: str):
        super().__init__(name)
        self._out = None

    def release(self):
        super().release()
        self._out = None

    def __call__(self, fn, fixed, *args):
        f_leaves, f_spec = tree_flatten(fixed)
        leaves, spec = tree_flatten(args)
        where = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        others = [x for x in f_leaves + leaves if not isinstance(x, torch.Tensor)]
        copies = self.bind(
            _tensors(f_leaves), [leaves[i] for i in where], key=(f_spec, spec, others)
        )
        for i, t in zip(where, copies):
            leaves[i] = t
        s_args = tree_unflatten(leaves, spec)
        if not self.captured:
            with span(f"CUDAGraph::Capture {self.name}"):
                warm = tree_flatten(self._warm_up(lambda: fn(fixed, *s_args)))[0]
                out_leaves, out_spec = tree_flatten(self._capture(lambda: fn(fixed, *s_args)))
                for o, w in zip(out_leaves, warm):
                    if isinstance(o, torch.Tensor):
                        o.copy_(w)
            self._out = (out_leaves, out_spec)
        else:
            self._replay()
        # new containers around the same tensors: what a caller adds to them
        # does not outlive this call
        return tree_unflatten(*self._out)


def fn_graph(name: str, device):
    """An FnGraph for a function whose tensors live on `device`: on a card;
    None elsewhere, where the caller runs the function eagerly."""
    return FnGraph(name) if torch.device(device).type == "cuda" else None


def step_graph(name: str, device):
    """A StepGraph for a step on `device`: on a card; None elsewhere."""
    return StepGraph(name) if torch.device(device).type == "cuda" else None


def call(graph, fn, fixed, *args):
    """fn(fixed, *args), through `graph` when there is one."""
    return fn(fixed, *args) if graph is None else graph(fn, fixed, *args)
