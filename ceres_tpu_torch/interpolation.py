"""Cubic and bicubic interpolation of gridded data, differentiable in
PyTorch.

Port of `ceres_tpu.interpolation` (reference: include/ceres/
cubic_interpolation.h: CubicHermiteSpline, Grid1D / Grid2D,
CubicInterpolator, BiCubicInterpolator), used by the sampled_function and
bicubic_interpolation examples and by cost functors that read sampled
data. torch.func differentiates through the spline (the reference's
hand-coded derivative outputs) and vmaps over query batches. Catmull-Rom
coefficients, as the reference's CubicHermiteSpline; queries out of range
clamp to the edge, as Grid1D / Grid2D.

The grid is copied to a query's device and dtype once (`_grid`), at the
first evaluation, so a captured CUDA graph (whose warm-up runs first)
reads it in place. The sample index depends on the data, so the B1
generic generator refuses such a functor (functor_codegen.Ineligible) and
its group takes the torch.func path, as the JAX package's group_kernel
returns None for it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad


def cubic_hermite(p0, p1, p2, p3, x):
    """Catmull-Rom interpolation on [0, 1] from 4 support points
    (cubic_interpolation.h:63-89)."""
    a = 0.5 * (-p0 + 3.0 * p1 - 3.0 * p2 + p3)
    b = 0.5 * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3)
    c = 0.5 * (-p0 + p2)
    d = p1
    return d + x * (c + x * (b + x * a))


class _Grid:
    def __init__(self, values):
        self.values = torch.as_tensor(np.asarray(values, dtype=np.float64))
        self._copies = {}

    def _grid(self, x):
        """The values on x's device in x's dtype, copied once."""
        key = (x.device, x.dtype)
        if key not in self._copies:
            self._copies[key] = self.values.to(device=x.device, dtype=x.dtype)
        return self._copies[key]


class CubicInterpolator(_Grid):
    """1-D interpolation of uniformly sampled values [n] or [n, k]
    (reference: CubicInterpolator<Grid1D>, cubic_interpolation.h:120-180)."""

    def __init__(self, values):
        super().__init__(values)
        self.n = self.values.shape[0]

    def __call__(self, x):
        values = self._grid(x)
        xi = torch.floor(x)
        frac = x - xi
        i = xi.long()

        def sample(j):
            # a one-element index tensor (vmap reads a 0-d one as a Python int)
            return values[torch.clamp(j, 0, self.n - 1).reshape(1)][0]

        return cubic_hermite(sample(i - 1), sample(i), sample(i + 1), sample(i + 2), frac)

    def evaluate_with_derivative(self, x):
        """(f(x), df/dx): the reference's Evaluate(x, f, dfdx)."""
        x = torch.as_tensor(x, dtype=torch.float64) if not isinstance(x, torch.Tensor) else x
        return self(x), grad(lambda q: self(q).sum())(x)


class BiCubicInterpolator(_Grid):
    """2-D interpolation of values [rows, cols] or [rows, cols, k]
    (reference: BiCubicInterpolator<Grid2D>, cubic_interpolation.h:300-423):
    row-major grid, query (r, c), edge clamping."""

    def __init__(self, values):
        super().__init__(values)
        self.rows = self.values.shape[0]
        self.cols = self.values.shape[1]

    def __call__(self, r, c):
        values = self._grid(r)
        ri = torch.floor(r)
        ci = torch.floor(c)
        fr = r - ri
        fc = c - ci
        i = ri.long()
        j = ci.long()

        def sample(dr, dc):
            rr = torch.clamp(i + dr, 0, self.rows - 1)
            cc = torch.clamp(j + dc, 0, self.cols - 1)
            return values[rr.reshape(1), cc.reshape(1)][0]

        rows = [cubic_hermite(sample(dr, -1), sample(dr, 0), sample(dr, 1), sample(dr, 2), fc)
                for dr in (-1, 0, 1, 2)]
        return cubic_hermite(rows[0], rows[1], rows[2], rows[3], fr)
