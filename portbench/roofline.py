"""Kernel roofline shares from a device trace, driven by
`metrics/kernels.json`: which kernels make up a function's call, what the
call must move and compute at the problem's sizes, and the card's peaks.

share = (sum over the function's calls of its least time, the larger of
bytes / peak bandwidth and operations / peak float32 rate) / (the device
time of its kernels: the calls, their further parts and their tails).
"""

from __future__ import annotations

import json
import os
import re

KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "metrics", "kernels.json")


def load(path=KERNELS) -> dict:
    with open(path) as f:
        return json.load(f)


def _per(coeffs: dict, sizes: dict) -> float:
    return float(sum(c * sizes[k] for k, c in coeffs.items()))


def bound_ms(call: dict, sizes: dict, model: dict) -> float:
    """The least ms of one call at `sizes` ({"obs", "cameras", "points"})."""
    t_bytes = model["word_bytes"] * _per(call["words"], sizes) / model["peak"]["bytes_per_s"]
    t_ops = _per(call.get("ops", {}), sizes) / model["peak"]["float32_flops_per_s"]
    return 1e3 * max(t_bytes, t_ops)


def share(kernels, function: str, sizes: dict, model: dict):
    """Percent of the roofline that `function`'s kernels reach in the
    trace's kernel events [(name, stream, start_us, dur_us)], in start
    order; None where none of its calls ran."""
    spec = model["functions"][function]
    calls = [(re.compile(c["kernel"]), bound_ms(c, sizes, model)) for c in spec["calls"]]
    parts = [re.compile(p) for p in spec.get("parts", [])]
    tails = [re.compile(t) for t in spec.get("tails", [])]
    ours = {}  # stream -> whether the last kernel there was one of this function's
    need_ms, took_ms, n = 0.0, 0.0, 0
    for name, stream, _, dur in kernels:
        hit = next((b for rx, b in calls if rx.search(name)), None)
        if hit is not None:
            need_ms, took_ms, n = need_ms + hit, took_ms + dur / 1e3, n + 1
            ours[stream] = True
        elif any(rx.search(name) for rx in parts):
            took_ms += dur / 1e3
            ours[stream] = True
        elif ours.get(stream) and any(rx.search(name) for rx in tails):
            took_ms += dur / 1e3
        else:
            ours[stream] = False
    if n == 0 or took_ms <= 0:
        return None
    return 100.0 * need_ms / took_ms
