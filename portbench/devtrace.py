"""The traced stretch of a run: torch.profiler over whole solves, read back
from its chrome trace.

The device's busy time is the union of the kernel, copy and memset
intervals inside the window, which runs from the start of the first
traced solve's reset span to the end of the last one's solve span (the
arithmetic of profile_torch_solve.timeline_shares). The idle gaps are the
window's stretches outside that union, each named by the innermost host
span and host operation that cover its middle.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RESET, RELEASE, SOLVE = "portbench::reset", "portbench::release", "portbench::solve"


class Trace:
    """What the per-layer readers take from a traced stretch: the device
    events in the window as (name, stream, start_us, dur_us) in start
    order, the window and busy time, and the breakdown."""

    def __init__(self, events):
        spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        resets = [e["ts"] for e in spans if e["name"] == RESET]
        solves = [e["ts"] + e["dur"] for e in spans if e["name"] == SOLVE]
        if not resets or not solves:
            raise ValueError("the trace holds no traced solve")
        self.lo, self.hi = min(resets), max(solves)
        dev = sorted(
            (e["ts"], e["ts"] + e["dur"], e["name"], e.get("args", {}).get("stream", 0))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo
        )
        self.kernels = [(name, stream, a, b - a) for a, b, name, stream in dev]
        self.window_us = self.hi - self.lo
        self.gaps = []
        busy, cur = 0.0, self.lo
        for a, b, _, _ in dev:
            a, b = max(a, self.lo), min(b, self.hi)
            if a > cur:
                self.gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if self.hi > cur:
            self.gaps.append((cur, self.hi))
        self.busy_us = busy
        self._host = self._host_spans(events)

    @staticmethod
    def _host_spans(events):
        out = {}
        for cat in ("user_annotation", "cpu_op"):
            sp = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                        if e.get("ph") == "X" and e.get("cat") == cat)
            out[cat] = ([s[0] for s in sp], sp)
        return out

    def _innermost(self, cat, t, depth=400):
        starts, sp = self._host[cat]
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - depth), -1):
            if sp[j][1] >= t:
                return sp[j][2]
        return None

    def idle_share(self) -> float:
        return 100.0 * (self.window_us - self.busy_us) / self.window_us

    def device_ops(self, k=10):
        """The k device operations that took most time: [name, seconds]."""
        tot = collections.Counter()
        for name, _, _, dur in self.kernels:
            tot[short(name)] += dur / 1e6
        return [[n, s] for n, s in tot.most_common(k)]

    def idle_gaps(self, k=10):
        """Idle time in the window by what the host was doing: the
        innermost host span and host operation over each gap's middle,
        summed by that name; [name, seconds], the k largest."""
        tot = collections.Counter()
        for a, b in self.gaps:
            mid = (a + b) / 2
            span = self._innermost("user_annotation", mid) or "no span"
            op = self._innermost("cpu_op", mid)
            tot[span if op is None else f"{span} / {op}"] += (b - a) / 1e6
        return [[n, s] for n, s in tot.most_common(k)]


def short(name: str, limit=160) -> str:
    """A kernel's name without its parameter list."""
    cut = name.find("(", name.find(">") if "<" in name else 0)
    return (name if cut <= 0 else name[:cut])[:limit]


def profile(run_solves, torch):
    """Run `run_solves()` under torch.profiler (host and device); returns
    (its result, the Trace of it). The chrome trace goes through a file in
    TMPDIR, removed at once."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        result = run_solves()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return result, Trace(events)
