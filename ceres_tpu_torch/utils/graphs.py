"""The host's tools for a loop whose state stays on the card.

`read` is the one way the solver loops bring a device value to the host.
Every read drains the stream: the card idles until the host has decided and
launched the next work. So each read is counted (`Device::Read` in the
counter table of utils.execution_summary; the solve reports the count in
`Summary.num_device_reads` and per iteration) and timed as a
`Device::Read` span (the host's wait), and a read is allowed to
synchronize even under `torch.cuda.set_sync_debug_mode("error")`, so that
a loop run in that mode fails on any other synchronization. Reads of CPU tensors are counted the
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
What the capture counted in the counter table (the kernels' launches, the
all-reduces of a sharded solve) is taken back after the capture and added
once per replay, so the counts stay those of the work the card did. Each
capture counts as `CUDAGraph::Capture`, each replay as `CUDAGraph::Replay`
and `CUDAGraph::Replay <graph>`; a capture's seconds are its
`CUDAGraph::Capture <graph>` span.
"""

from __future__ import annotations

import gc

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .execution_summary import add_counts, count, counts, record, span


def read(t):
    """The tensor `t` on the host (a CPU tensor), counted as one read."""
    count("Device::Read")
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
        self._counted = {}

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
        before = counts()
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
        # the wrappers counted while capturing, but nothing ran
        self._counted = counts() - before
        add_counts(self._counted, -1)
        count("CUDAGraph::Capture")
        self._graph = graph
        return out

    def _replay(self):
        self._graph.replay()
        count("CUDAGraph::Replay")
        count(f"CUDAGraph::Replay {self.name}")
        add_counts(self._counted)

    @property
    def counts_per_replay(self) -> dict:
        """What one replay adds to the counter table."""
        return dict(self._counted)


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
