"""Classic optimization test functions as cost functors, in PyTorch.

Port of `ceres_tpu.examples.test_functions` (reference: examples/powell.cc,
examples/rosenbrock.cc, examples/curve_fitting.cc; the data is generated
synthetically with the same numpy generator, so both packages fit the same
points). The small problems of DENSE_QR and DENSE_NORMAL_CHOLESKY.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..autodiff import CostFunction


# ---- Powell's function (examples/powell.cc): four 1-d blocks ------------- #

def powell_f1(params, data):
    (x1,), (x2,) = params[0], params[1]
    return torch.stack([x1 + 10.0 * x2])


def powell_f2(params, data):
    (x3,), (x4,) = params[0], params[1]
    return torch.stack([math.sqrt(5.0) * (x3 - x4)])


def powell_f3(params, data):
    (x2,), (x3,) = params[0], params[1]
    return torch.stack([(x2 - 2.0 * x3) ** 2])


def powell_f4(params, data):
    (x1,), (x4,) = params[0], params[1]
    return torch.stack([math.sqrt(10.0) * (x1 - x4) ** 2])


def build_powell_problem():
    from ..problem import Problem

    p = Problem()
    x1 = p.add_parameter_block([3.0])
    x2 = p.add_parameter_block([-1.0])
    x3 = p.add_parameter_block([0.0])
    x4 = p.add_parameter_block([1.0])
    p.add_residual_block(CostFunction(powell_f1, 1), None, [x1, x2])
    p.add_residual_block(CostFunction(powell_f2, 1), None, [x3, x4])
    p.add_residual_block(CostFunction(powell_f3, 1), None, [x2, x3])
    p.add_residual_block(CostFunction(powell_f4, 1), None, [x1, x4])
    return p, (x1, x2, x3, x4)


# ---- Rosenbrock (examples/rosenbrock.cc) -------------------------------- #

def rosenbrock_residuals(params, data):
    (xy,) = params
    x, y = xy[0], xy[1]
    return torch.stack([10.0 * (y - x * x), 1.0 - x])


# ---- exponential curve fit (examples/curve_fitting.cc structure) --------- #

def exponential_residual(params, data):
    (mc,) = params
    (xy,) = data
    return torch.stack([xy[1] - torch.exp(mc[0] * xy[0] + mc[1])])


def make_curve_fitting_data(
    n: int = 67, m: float = 0.3, c: float = 0.1, noise: float = 0.2, seed: int = 3
):
    """Synthetic y = exp(m x + c) + N(0, noise) samples on [0, 5] (numpy;
    the JAX package's generator, so both packages fit the same points)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 5.0, n)
    y = np.exp(m * x + c) + rng.normal(0.0, noise, n)
    return np.stack([x, y], axis=1)


def build_curve_fitting_problem(data=None, loss=None, m0=0.0, c0=0.0):
    from ..problem import Problem

    if data is None:
        data = make_curve_fitting_data()
    p = Problem()
    mc = p.add_parameter_block([m0, c0])
    cf = CostFunction(exponential_residual, 1, name="exp_fit")
    ids = np.full((data.shape[0], 1), mc)
    p.add_residual_blocks(cf, loss, ids, (data,))
    return p, mc
