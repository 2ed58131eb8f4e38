"""Recover the shift between samples and a bicubic-interpolated grid
(reference: examples/bicubic_interpolation.cc)."""

from __future__ import annotations

import numpy as np
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.scripts._cli import parser
from ceres_tpu_torch.interpolation import BiCubicInterpolator


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    rows, cols = 10, 10
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    # a curved surface, so the shift is determined in both directions
    grid = np.sin(0.7 * rr) * 5.0 + np.cos(0.9 * cc) * 3.0 + rr * cc * 0.1
    interp = BiCubicInterpolator(grid)
    shift_true = np.array([1.3, 0.7])
    samples = np.random.default_rng(0).uniform(2, 7, (40, 2))
    r = samples[:, 0] + shift_true[0]
    c = samples[:, 1] + shift_true[1]
    values = np.sin(0.7 * r) * 5.0 + np.cos(0.9 * c) * 3.0 + r * c * 0.1

    def res(params, data):
        (shift,) = params
        (s,) = data
        return torch.stack([interp(s[0] + shift[0], s[1] + shift[1]) - s[2]])

    problem = ct.Problem()
    b = problem.add_parameter_block([0.0, 0.0])
    problem.add_residual_blocks(ct.CostFunction(res, 1, name="bicubic"), None,
                                np.full((40, 1), b),
                                (np.concatenate([samples, values[:, None]], axis=1),))
    summary = ct.solve(ct.SolverOptions(max_num_iterations=50, device=args.device), problem)
    print(summary.brief_report())
    print("shift =", problem.parameter_block_value(b), "(truth", shift_true, ")")


if __name__ == "__main__":
    main()
