"""NIST StRD nonlinear-regression accuracy harness.

reference: examples/nist.cc — fits the NIST Statistical Reference Datasets
(https://www.itl.nist.gov/div898/strd/nls/nls_main.shtml) and scores LRE
(log relative error) digits against certified parameter values. The 27
certified .dat files ship with the reference at `data/nist/`; point
`run_nist` at that directory (tests/test_nist.py does exactly this).

The standard model library (port of ceres_tpu/examples/nist.py, in torch)
follows the published model equations; each dataset name maps to its
model. Data is read only from a path given to it. Difficulty tiers and
the >4-matching-digits success bar follow `examples/nist.cc:659-705`.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re

import numpy as np
import torch

from ..autodiff import CostFunction
from ..problem import Problem
from ..solvers.solver import solve
from ..types import SolverOptions


# --- model library (published NIST NLS model equations) ------------------- #

def _misra1a(b, x):
    return b[0] * (1.0 - torch.exp(-b[1] * x))


def _misra1b(b, x):
    return b[0] * (1.0 - 1.0 / (1.0 + b[1] * x / 2.0) ** 2)


def _misra1c(b, x):
    return b[0] * (1.0 - 1.0 / torch.sqrt(1.0 + 2.0 * b[1] * x))


def _misra1d(b, x):
    return b[0] * b[1] * x / (1.0 + b[1] * x)


def _chwirut(b, x):
    return torch.exp(-b[0] * x) / (b[1] + b[2] * x)


def _lanczos(b, x):
    return (
        b[0] * torch.exp(-b[1] * x)
        + b[2] * torch.exp(-b[3] * x)
        + b[4] * torch.exp(-b[5] * x)
    )


def _gauss(b, x):
    return (
        b[0] * torch.exp(-b[1] * x)
        + b[2] * torch.exp(-((x - b[3]) ** 2) / b[4] ** 2)
        + b[5] * torch.exp(-((x - b[6]) ** 2) / b[7] ** 2)
    )


def _dan_wood(b, x):
    return b[0] * x ** b[1]


def _rat42(b, x):
    return b[0] / (1.0 + torch.exp(b[1] - b[2] * x))


def _rat43(b, x):
    return b[0] / (1.0 + torch.exp(b[1] - b[2] * x)) ** (1.0 / b[3])


def _thurber(b, x):
    num = b[0] + b[1] * x + b[2] * x**2 + b[3] * x**3
    den = 1.0 + b[4] * x + b[5] * x**2 + b[6] * x**3
    return num / den


def _boxbod(b, x):
    return b[0] * (1.0 - torch.exp(-b[1] * x))


def _mgh09(b, x):
    return b[0] * (x**2 + x * b[1]) / (x**2 + x * b[2] + b[3])


def _mgh10(b, x):
    return b[0] * torch.exp(b[1] / (x + b[2]))


def _mgh17(b, x):
    return b[0] + b[1] * torch.exp(-x * b[3]) + b[2] * torch.exp(-x * b[4])


def _eckerle4(b, x):
    return (b[0] / b[1]) * torch.exp(-0.5 * ((x - b[2]) / b[1]) ** 2)


def _roszman1(b, x):
    # two-argument arctan: the certified values live on the (0, pi) branch
    # when x - b4 < 0 (reference nist.cc:397-399 uses atan2 too)
    return b[0] - b[1] * x - torch.atan2(b[2], x - b[3]) / math.pi


def _enso(b, x):
    pi2 = 2.0 * math.pi
    return (
        b[0]
        + b[1] * torch.cos(pi2 * x / 12.0)
        + b[2] * torch.sin(pi2 * x / 12.0)
        + b[4] * torch.cos(pi2 * x / b[3])
        + b[5] * torch.sin(pi2 * x / b[3])
        + b[7] * torch.cos(pi2 * x / b[6])
        + b[8] * torch.sin(pi2 * x / b[6])
    )


def _bennett5(b, x):
    return b[0] * (b[1] + x) ** (-1.0 / b[2])


def _nelson(b, x):
    # log[y] = b1 - b2*x1 * exp[-b3*x2] (2 predictors; reference
    # examples/nist.cc:435-453 models the log response directly)
    return b[0] - b[1] * x[0] * torch.exp(-b[2] * x[1])


def _kirby2(b, x):
    return (b[0] + b[1] * x + b[2] * x**2) / (1.0 + b[3] * x + b[4] * x**2)


def _hahn1(b, x):
    num = b[0] + b[1] * x + b[2] * x**2 + b[3] * x**3
    den = 1.0 + b[4] * x + b[5] * x**2 + b[6] * x**3
    return num / den


MODELS = {
    "misra1a": _misra1a,
    "misra1b": _misra1b,
    "misra1c": _misra1c,
    "misra1d": _misra1d,
    "chwirut1": _chwirut,
    "chwirut2": _chwirut,
    "lanczos1": _lanczos,
    "lanczos2": _lanczos,
    "lanczos3": _lanczos,
    "gauss1": _gauss,
    "gauss2": _gauss,
    "gauss3": _gauss,
    "danwood": _dan_wood,
    "rat42": _rat42,
    "rat43": _rat43,
    "thurber": _thurber,
    "boxbod": _boxbod,
    "mgh09": _mgh09,
    "mgh10": _mgh10,
    "mgh17": _mgh17,
    "eckerle4": _eckerle4,
    "roszman1": _roszman1,
    "enso": _enso,
    "bennett5": _bennett5,
    "kirby2": _kirby2,
    "hahn1": _hahn1,
    "nelson": _nelson,
}

# datasets whose regression is on a transformed response
RESPONSE_TRANSFORMS = {"nelson": torch.log}

# number of predictor columns when != 1
NUM_PREDICTORS = {"nelson": 2}

# difficulty tiers exactly as grouped by the reference driver
# (examples/nist.cc:665-698); success bar is LRE > 4 digits per start.
DIFFICULTY = {
    "easy": [
        "misra1a", "chwirut1", "chwirut2", "lanczos3",
        "gauss1", "gauss2", "danwood", "misra1b",
    ],
    "medium": [
        "kirby2", "hahn1", "nelson", "mgh17", "lanczos1", "lanczos2",
        "gauss3", "misra1c", "misra1d", "roszman1", "enso",
    ],
    "hard": [
        "mgh09", "thurber", "boxbod", "rat42",
        "mgh10", "eckerle4", "rat43", "bennett5",
    ],
}


@dataclasses.dataclass
class NistDataset:
    name: str
    starts: np.ndarray  # [num_starts, p] starting points
    certified: np.ndarray  # [p] certified parameter values
    certified_cost: float  # residual sum of squares / 2
    data: np.ndarray  # [n, 1 + num_predictors] rows of (y, x...)
    num_predictors: int = 1


def _floats(tokens):
    out = []
    for t in tokens:
        try:
            out.append(float(t.replace("D", "E").replace("d", "e")))
        except ValueError:
            return None
    return out


def parse_nist_dat(path) -> NistDataset:
    """Parse the NIST StRD .dat format (same records nist.cc:200-270 reads).

    Robust to the certified files' layout: header counts (predictors,
    observations) are taken from the prose header when present; the
    parameter table is located by its `bN =` rows (the real files mention
    "Starting Values" earlier in the File-Format prose, so a plain text
    search is not enough); the data table is everything after the LAST
    `Data:` marker.
    """
    with open(path, errors="replace") as f:
        lines = f.readlines()
    name = os.path.splitext(os.path.basename(path))[0].lower()
    text = "".join(lines)

    m = re.search(r"(\d+)\s+Predictor Variable", text)
    num_predictors = int(m.group(1)) if m else NUM_PREDICTORS.get(name, 1)
    m = re.search(r"(\d+)\s+Observations", text)
    num_observations = int(m.group(1)) if m else None

    # parameter table rows: "bK =  start1 [start2 ...] certified stddev"
    starts_rows, certified = [], []
    for line in lines:
        m = re.match(r"\s*b\d+\s*=\s*(.+)$", line)
        if not m:
            continue
        vals = _floats(m.group(1).split())
        if vals is None or len(vals) < 3:
            continue
        starts_rows.append(vals[:-2])
        certified.append(vals[-2])
    if not starts_rows:
        raise ValueError(f"{path}: no parameter table found")
    starts = np.asarray(starts_rows).T  # [num_starts, p]

    m = re.search(r"Residual Sum of Squares:\s*([-\d.eEdD+]+)", text)
    if not m:
        raise ValueError(f"{path}: missing Residual Sum of Squares")
    rss = float(m.group(1).replace("D", "E").replace("d", "e"))

    data_idx = max(i for i, line in enumerate(lines) if re.match(r"\s*Data:", line))
    width = 1 + num_predictors
    rows = []
    for line in lines[data_idx + 1:]:
        vals = _floats(line.split())
        if vals and len(vals) >= width:
            rows.append(vals[:width])
    if num_observations is not None:
        rows = rows[:num_observations]
    return NistDataset(
        name=name,
        starts=starts,
        certified=np.asarray(certified),
        certified_cost=0.5 * rss,
        data=np.asarray(rows),
        num_predictors=num_predictors,
    )


def log_relative_error(estimate, truth) -> float:
    """LRE digits (nist.cc ComputeLRE)."""
    err = np.abs(estimate - truth)
    rel = np.where(np.abs(truth) > 0, err / np.abs(truth), err)
    worst = np.max(rel)
    if worst == 0:
        return 11.0
    return float(min(11.0, max(0.0, -np.log10(worst))))


@dataclasses.dataclass
class NistStartResult:
    lre: float
    final_cost: float
    certified_cost: float
    success: bool  # LRE > 4 matching digits (nist.cc:641-645)


def fit_nist_dataset(ds: NistDataset, options=None, device=None):
    """Solve one dataset from every certified starting point.

    Returns a list of NistStartResult, one per start, mirroring the
    reference RegressionDriver (examples/nist.cc:584-657). `device` applies
    to the default options only.
    """

    # Accuracy-harness defaults: the reference driver runs Ceres defaults
    # with max_num_iterations=10000 / radius 1e4 (nist.cc:137,141,488-491);
    # we additionally tighten the tolerances to the f64 floor so the LM loop
    # polishes to certified-digit accuracy instead of stopping at the
    # production default function_tolerance=1e-6.
    options = options or SolverOptions(
        max_num_iterations=10000,
        initial_trust_region_radius=1e4,
        function_tolerance=1e-15,
        gradient_tolerance=1e-15,
        parameter_tolerance=1e-15,
        use_nonmonotonic_steps=False,
        fused_execution=False,  # tiny problems: the host loop
        device=device,
    )
    model = MODELS[ds.name]
    resp_tf = RESPONSE_TRANSFORMS.get(ds.name, lambda y: y)
    npred = ds.num_predictors

    def residual(params, data, model=model, resp_tf=resp_tf, npred=npred):
        (b,) = params
        (row,) = data
        x = row[1] if npred == 1 else row[1:]
        return torch.stack([resp_tf(row[0]) - model(b, x)])

    out = []
    for start in ds.starts:
        problem = Problem()
        b = problem.add_parameter_block(np.array(start, dtype=np.float64))
        ids = np.full((ds.data.shape[0], 1), b)
        problem.add_residual_blocks(
            CostFunction(residual, 1, name=ds.name), None, ids,
            (ds.data,),
        )
        summary = solve(options, problem)
        est = problem.parameter_block_value(b)
        lre = log_relative_error(est, ds.certified)
        out.append(NistStartResult(
            lre=lre,
            final_cost=float(summary.final_cost),
            certified_cost=ds.certified_cost,
            success=lre > 4.0,
        ))
    return out


def run_nist(data_dir, options=None, names=None, device=None):
    """Fit every recognized dataset in `data_dir`.

    Returns {name: [NistStartResult per start]}. Use `summarize_nist` for
    the reference driver's per-difficulty success counts.
    """
    results = {}
    for fname in sorted(os.listdir(data_dir)):
        if not fname.lower().endswith(".dat"):
            continue
        name = os.path.splitext(fname)[0].lower()
        if name not in MODELS or (names and name not in names):
            continue
        ds = parse_nist_dat(os.path.join(data_dir, fname))
        results[name] = fit_nist_dataset(ds, options, device)
    return results


def summarize_nist(results):
    """Per-difficulty (successes, attempts) as printed by nist.cc:699-705."""
    summary = {}
    for tier, members in DIFFICULTY.items():
        wins = total = 0
        for name in members:
            for r in results.get(name, []):
                total += 1
                wins += bool(r.success)
        summary[tier] = (wins, total)
    return summary
