"""Curve fitting with gross outliers under a Cauchy loss (reference:
examples/robust_curve_fitting.cc)."""

from __future__ import annotations

import numpy as np

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.scripts._cli import parser
from ceres_tpu_torch.examples.test_functions import (
    build_curve_fitting_problem,
    make_curve_fitting_data,
)


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    data = make_curve_fitting_data(seed=2)
    rng = np.random.default_rng(5)
    out_rows = rng.choice(data.shape[0], 8, replace=False)
    data[out_rows, 1] += rng.uniform(2.0, 6.0, 8)  # gross outliers
    problem, mc = build_curve_fitting_problem(data=data, loss=ct.CauchyLoss(2.0))
    summary = ct.solve(ct.SolverOptions(max_num_iterations=100, device=args.device), problem)
    print(summary.brief_report())
    m, c = problem.parameter_block_value(mc)
    print(f"m = {m:.4f} (truth 0.3), c = {c:.4f} (truth 0.1)")


if __name__ == "__main__":
    main()
