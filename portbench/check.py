"""What decides `correct`: the port's answers held to the plain reference.

Every solve in the window starts from the seeded start x0 and returns its
Summary and its final state x_T (the state the port writes back). Once
the window has closed and the port's state is freed, the configuration's
reference (portbench/reference/<name>.py) works out in float64, from the
benchmark's own inputs:

- initial_cost_gap: the largest |Summary.initial_cost - cost(x0)| / cost(x0)
  over the solves (the evaluation, B1, at the start);
- final_cost_gap: the largest |Summary.final_cost - cost(x_T)| / cost(x_T)
  (the evaluation at the state the solve returned: its answer as reported);
- final_gradient_ratio: the largest |grad cost(x_T)| / |grad cost(x0)|
  (what the 20 Schur/PCG steps achieved: a step that leaves the state
  where it was reads 1).

Each is compared with its limit from portbench/limits/<workload>.json.
Identical final states (the port's solves repeat bitwise) are evaluated
once.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NUMBERS = ("initial_cost_gap", "final_cost_gap", "final_gradient_ratio")


def load_limits(workload: str, root=HERE) -> dict:
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        limits = json.load(f)
    missing = [k for k in NUMBERS if k not in limits]
    if missing:
        raise ValueError(f"limits of {workload} lack {missing}")
    return limits


def reference_module(config: dict):
    return importlib.import_module(f"reference.{config['reference']}")


def _digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).view(np.uint8)).hexdigest()


def readings(ref, gen, start, solves, device) -> dict:
    """The three numbers over `solves` [(initial_cost, final_cost,
    [parameter blocks' final values])]; `start` holds the blocks' start
    values and `gen` the inputs, in the reference's order."""
    obs = ref.observed(gen)
    c0 = ref.cost(*start, *obs, device=device)
    g0 = ref.gradient_norm(*start, *obs, device=device)
    seen = {}
    out = dict.fromkeys(NUMBERS, 0.0)
    for initial, final, blocks in solves:
        key = "".join(_digest(b) for b in blocks)
        if key not in seen:
            seen[key] = (ref.cost(*blocks, *obs, device=device),
                         ref.gradient_norm(*blocks, *obs, device=device))
        c_t, g_t = seen[key]
        out["initial_cost_gap"] = max(out["initial_cost_gap"], abs(initial - c0) / c0)
        out["final_cost_gap"] = max(out["final_cost_gap"], abs(final - c_t) / c_t)
        out["final_gradient_ratio"] = max(out["final_gradient_ratio"], g_t / g0)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit and finite, {name: {value, limit}})."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
