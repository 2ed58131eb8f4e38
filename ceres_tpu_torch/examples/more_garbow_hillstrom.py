"""Classic Moré–Garbow–Hillstrom test problems (1-19), with bounds.

reference: examples/more_garbow_hillstrom.cc — implements MGH problems 1-19
("Testing Unconstrained Optimization Software", TOMS 7(1), 1981) with the
bounds-constrained variants of Gay ("A trust-region approach to linearly
constrained optimization"). The functions below implement the published
formulas (port of ceres_tpu/examples/more_garbow_hillstrom.py, in torch:
each residual runs under torch.func and on the tiny solver's batched
lanes, its constants made in x's dtype on x's device); each problem
carries its certified start point, unconstrained optimal cost, and (where the reference certifies one) the
box-constrained optimal cost. f_min values are 0.5*sum-of-squares (the
reference compares `2.0 * summary.final_cost`, more_garbow_hillstrom.cc:
568-575).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..autodiff import CostFunction
from ..problem import Problem


@dataclasses.dataclass
class TestProblem:
    name: str
    residual_fn: Callable  # (params, data) -> residuals
    num_residuals: int
    x0: np.ndarray
    f_min: float  # certified minimal 0.5*|r|^2... stored as sum-of-squares/2
    x_min: Optional[np.ndarray] = None  # a known minimizer (if unique)
    lower_bounds: Optional[np.ndarray] = None
    upper_bounds: Optional[np.ndarray] = None
    constrained_f_min: Optional[float] = None  # 0.5*sum-of-squares under box

    def build(self, constrained: bool = False) -> tuple:
        p = Problem()
        b = p.add_parameter_block(self.x0)
        p.add_residual_block(
            CostFunction(self.residual_fn, self.num_residuals, name=self.name),
            None,
            [b],
        )
        if constrained:
            if self.lower_bounds is None:
                raise ValueError(f"{self.name} has no bound constraints")
            for i, (lo, hi) in enumerate(
                zip(self.lower_bounds, self.upper_bounds)
            ):
                if np.isfinite(lo):
                    p.set_parameter_lower_bound(b, i, float(lo))
                if np.isfinite(hi):
                    p.set_parameter_upper_bound(b, i, float(hi))
        return p, b


def _const(x, values):
    return torch.tensor(values, dtype=x.dtype, device=x.device)


def _arange(x, start, end):
    return torch.arange(start, end, dtype=x.dtype, device=x.device)


def _rosenbrock(params, data):
    (x,) = params
    return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def _freudenstein_roth(params, data):
    (x,) = params
    return torch.stack(
        [
            -13.0 + x[0] + ((5.0 - x[1]) * x[1] - 2.0) * x[1],
            -29.0 + x[0] + ((x[1] + 1.0) * x[1] - 14.0) * x[1],
        ]
    )


def _powell_badly_scaled(params, data):
    (x,) = params
    return torch.stack([1e4 * x[0] * x[1] - 1.0, torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001])


def _brown_badly_scaled(params, data):
    (x,) = params
    return torch.stack([x[0] - 1e6, x[1] - 2e-6, x[0] * x[1] - 2.0])


def _beale(params, data):
    (x,) = params
    return torch.stack(
        [
            1.5 - x[0] * (1.0 - x[1]),
            2.25 - x[0] * (1.0 - x[1] ** 2),
            2.625 - x[0] * (1.0 - x[1] ** 3),
        ]
    )


def _helical_valley(params, data):
    (x,) = params
    theta = torch.atan2(x[1], x[0]) / (2.0 * math.pi)
    return torch.stack(
        [
            10.0 * (x[2] - 10.0 * theta),
            10.0 * (torch.sqrt(x[0] ** 2 + x[1] ** 2) - 1.0),
            x[2],
        ]
    )


def _bard(params, data):
    (x,) = params
    y = _const(
        x,
        [0.14, 0.18, 0.22, 0.25, 0.29, 0.32, 0.35, 0.39,
         0.37, 0.58, 0.73, 0.96, 1.34, 2.10, 4.39]
    )
    u = _arange(x, 1.0, 16.0)
    v = 16.0 - u
    w = torch.minimum(u, v)
    return y - (x[0] + u / (x[1] * v + x[2] * w))


def _gaussian(params, data):
    (x,) = params
    y = _const(
        x,
        [0.0009, 0.0044, 0.0175, 0.0540, 0.1295, 0.2420, 0.3521, 0.3989,
         0.3521, 0.2420, 0.1295, 0.0540, 0.0175, 0.0044, 0.0009]
    )
    t = (8.0 - _arange(x, 1.0, 16.0)) / 2.0
    return x[0] * torch.exp(-0.5 * x[1] * (t - x[2]) ** 2) - y


def _jennrich_sampson(params, data):
    (x,) = params
    i = _arange(x, 1.0, 11.0)
    return 2.0 + 2.0 * i - (torch.exp(i * x[0]) + torch.exp(i * x[1]))


def _meyer(params, data):
    (x,) = params
    y = _const(
        x,
        [34780.0, 28610.0, 23650.0, 19630.0, 16370.0, 13720.0, 11540.0,
         9744.0, 8261.0, 7030.0, 6005.0, 5147.0, 4427.0, 3820.0, 3307.0,
         2872.0]
    )
    t = 45.0 + 5.0 * _arange(x, 1.0, 17.0)
    return x[0] * torch.exp(x[1] / (t + x[2])) - y


def _gulf(params, data):
    # published MGH #11 formula (the reference's transcription at
    # more_garbow_hillstrom.cc:318 multiplies where the paper subtracts;
    # both have the same unconstrained optimum f=0 at (50, 25, 1.5))
    (x,) = params
    t = _arange(x, 1.0, 100.0) / 100.0
    y = 25.0 + (-50.0 * torch.log(t)) ** (2.0 / 3.0)
    return torch.exp(-(torch.abs(y - x[1]) ** x[2]) / x[0]) - t


def _box_3d(params, data):
    (x,) = params
    t = 0.1 * _arange(x, 1.0, 4.0)
    return (
        torch.exp(-t * x[0])
        - torch.exp(-t * x[1])
        - x[2] * (torch.exp(-t) - torch.exp(-10.0 * t))
    )


def _powell_singular(params, data):
    (x,) = params
    return torch.stack(
        [
            x[0] + 10.0 * x[1],
            math.sqrt(5.0) * (x[2] - x[3]),
            (x[1] - 2.0 * x[2]) ** 2,
            math.sqrt(10.0) * (x[0] - x[3]) ** 2,
        ]
    )


def _kowalik_osborne(params, data):
    (x,) = params
    y = _const(
        x,
        [0.1957, 0.1947, 0.1735, 0.1600, 0.0844, 0.0627, 0.0456, 0.0342,
         0.0323, 0.0235, 0.0246]
    )
    u = _const(
        x,
        [4.0, 2.0, 1.0, 0.5, 0.25, 0.167, 0.125, 0.1, 0.0833, 0.0714, 0.0625]
    )
    return y - x[0] * (u * u + u * x[1]) / (u * u + u * x[2] + x[3])


def _osborne_1(params, data):
    (x,) = params
    y = _const(
        x,
        [0.844, 0.908, 0.932, 0.936, 0.925, 0.908, 0.881, 0.850, 0.818,
         0.784, 0.751, 0.718, 0.685, 0.658, 0.628, 0.603, 0.580, 0.558,
         0.538, 0.522, 0.506, 0.490, 0.478, 0.467, 0.457, 0.448, 0.438,
         0.431, 0.424, 0.420, 0.414, 0.411, 0.406]
    )
    t = 10.0 * _arange(x, 0.0, 33.0)
    return y - (x[0] + x[1] * torch.exp(-t * x[3]) + x[2] * torch.exp(-t * x[4]))


def _biggs_exp6(params, data):
    (x,) = params
    t = 0.1 * _arange(x, 1.0, 14.0)
    y = torch.exp(-t) - 5.0 * torch.exp(-10.0 * t) + 3.0 * torch.exp(-4.0 * t)
    return (
        x[2] * torch.exp(-t * x[0])
        - x[3] * torch.exp(-t * x[1])
        + x[5] * torch.exp(-t * x[4])
        - y
    )


def _osborne_2(params, data):
    (x,) = params
    y = _const(
        x,
        [1.366, 1.191, 1.112, 1.013, 0.991, 0.885, 0.831, 0.847, 0.786,
         0.725, 0.746, 0.679, 0.608, 0.655, 0.616, 0.606, 0.602, 0.626,
         0.651, 0.724, 0.649, 0.649, 0.694, 0.644, 0.624, 0.661, 0.612,
         0.558, 0.533, 0.495, 0.500, 0.423, 0.395, 0.375, 0.372, 0.391,
         0.396, 0.405, 0.428, 0.429, 0.523, 0.562, 0.607, 0.653, 0.672,
         0.708, 0.633, 0.668, 0.645, 0.632, 0.591, 0.559, 0.597, 0.625,
         0.739, 0.710, 0.729, 0.720, 0.636, 0.581, 0.428, 0.292, 0.162,
         0.098, 0.054]
    )
    t = _arange(x, 0.0, 65.0) / 10.0
    return y - (
        x[0] * torch.exp(-t * x[4])
        + x[1] * torch.exp(-((t - x[8]) ** 2) * x[5])
        + x[2] * torch.exp(-((t - x[9]) ** 2) * x[6])
        + x[3] * torch.exp(-((t - x[10]) ** 2) * x[7])
    )


def _wood(params, data):
    (x,) = params
    return torch.stack(
        [
            10.0 * (x[1] - x[0] ** 2),
            1.0 - x[0],
            math.sqrt(90.0) * (x[3] - x[2] ** 2),
            1.0 - x[2],
            math.sqrt(10.0) * (x[1] + x[3] - 2.0),
            (x[1] - x[3]) / math.sqrt(10.0),
        ]
    )


def _brown_dennis(params, data):
    (x,) = params
    t = _arange(x, 1.0, 21.0) / 5.0
    a = x[0] + t * x[1] - torch.exp(t)
    b = x[2] + x[3] * torch.sin(t) - torch.cos(t)
    return a * a + b * b


# Bounds and constrained optimal costs from the reference's certified table
# (more_garbow_hillstrom.cc; each lower/upper/constrained_optimal_cost
# constant). MGH numbering in comments. inf = unbounded coordinate.
_inf = np.inf

PROBLEMS = [
    # 1
    TestProblem("rosenbrock", _rosenbrock, 2, np.array([-1.2, 1.0]), 0.0,
                np.array([1.0, 1.0])),
    # 2
    TestProblem("freudenstein_roth", _freudenstein_roth, 2,
                np.array([0.5, -2.0]), 0.0, np.array([5.0, 4.0])),
    # 3
    TestProblem("powell_badly_scaled", _powell_badly_scaled, 2,
                np.array([0.0, 1.0]), 0.0,
                lower_bounds=np.array([0.0, 1.0]),
                upper_bounds=np.array([1.0, 9.0]),
                constrained_f_min=0.5 * 0.15125900e-9),
    # 4
    TestProblem("brown_badly_scaled", _brown_badly_scaled, 3,
                np.array([1.0, 1.0]), 0.0, np.array([1e6, 2e-6]),
                lower_bounds=np.array([0.0, 0.00003]),
                upper_bounds=np.array([1e6, 100.0]),
                constrained_f_min=0.5 * 0.784e3),
    # 5
    TestProblem("beale", _beale, 3, np.array([1.0, 1.0]), 0.0,
                np.array([3.0, 0.5]),
                lower_bounds=np.array([0.6, 0.5]),
                upper_bounds=np.array([10.0, 100.0]),
                constrained_f_min=0.0),
    # 6
    TestProblem("jennrich_sampson", _jennrich_sampson, 10,
                np.array([0.3, 0.4]), 0.5 * 124.362),
    # 7
    TestProblem("helical_valley", _helical_valley, 3,
                np.array([-1.0, 0.0, 0.0]), 0.0, np.array([1.0, 0.0, 0.0]),
                lower_bounds=np.array([-100.0, -1.0, -1.0]),
                upper_bounds=np.array([0.8, 1.0, 1.0]),
                constrained_f_min=0.5 * 0.99042212),
    # 8
    TestProblem("bard", _bard, 15, np.array([1.0, 1.0, 1.0]),
                0.5 * 8.21487e-3),
    # 9
    TestProblem("gaussian", _gaussian, 15, np.array([0.4, 1.0, 0.0]),
                0.5 * 1.12793e-8,
                lower_bounds=np.array([0.398, 1.0, -0.5]),
                upper_bounds=np.array([4.2, 2.0, 0.1]),
                constrained_f_min=0.5 * 0.112793e-7),
    # 10
    TestProblem("meyer", _meyer, 16, np.array([0.02, 4000.0, 250.0]),
                0.5 * 87.9458),
    # 11 (published formula; the reference's constrained cost certifies its
    # own transcription, so only the bounds carry over)
    TestProblem("gulf", _gulf, 99, np.array([5.0, 2.5, 0.15]), 0.0,
                np.array([50.0, 25.0, 1.5]),
                lower_bounds=np.array([1e-16, 0.0, 0.0]),
                upper_bounds=np.array([10.0, 10.0, 10.0])),
    # 12
    TestProblem("box_3d", _box_3d, 3, np.array([0.0, 10.0, 20.0]), 0.0,
                lower_bounds=np.array([0.0, 5.0, 0.0]),
                upper_bounds=np.array([2.0, 9.5, 20.0]),
                constrained_f_min=0.5 * 0.30998153e-5),
    # 13
    TestProblem("powell_singular", _powell_singular, 4,
                np.array([3.0, -1.0, 0.0, 1.0]), 0.0,
                np.array([0.0, 0.0, 0.0, 0.0])),
    # 14
    TestProblem("wood", _wood, 6, np.array([-3.0, -1.0, -3.0, -1.0]), 0.0,
                np.array([1.0, 1.0, 1.0, 1.0]),
                lower_bounds=np.array([-100.0, -100.0, -100.0, -100.0]),
                upper_bounds=np.array([0.0, 10.0, 100.0, 100.0]),
                constrained_f_min=0.5 * 0.15567008e1),
    # 15
    TestProblem("kowalik_osborne", _kowalik_osborne, 11,
                np.array([0.25, 0.39, 0.415, 0.39]), 0.5 * 3.07505e-4),
    # 16
    TestProblem("brown_dennis", _brown_dennis, 20,
                np.array([25.0, 5.0, -5.0, -1.0]), 0.5 * 85822.2,
                lower_bounds=np.array([-10.0, 0.0, -100.0, -20.0]),
                upper_bounds=np.array([100.0, 15.0, 0.0, 0.2]),
                constrained_f_min=0.5 * 0.88860479e5),
    # 17
    TestProblem("osborne_1", _osborne_1, 33,
                np.array([0.5, 1.5, -1.0, 0.01, 0.02]), 0.5 * 5.46489e-5),
    # 18
    TestProblem("biggs_exp6", _biggs_exp6, 13,
                np.array([1.0, 2.0, 1.0, 1.0, 1.0, 1.0]), 0.0,
                lower_bounds=np.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0]),
                upper_bounds=np.array([2.0, 8.0, 1.0, 7.0, 5.0, 5.0]),
                constrained_f_min=0.5 * 0.53209865e-3),
    # 19
    TestProblem("osborne_2", _osborne_2, 65,
                np.array([1.3, 0.65, 0.65, 0.7, 0.6, 3.0, 5.0, 7.0, 2.0,
                          4.5, 5.5]), 0.5 * 4.01377e-2),
]
