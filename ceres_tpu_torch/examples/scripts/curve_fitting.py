"""Fit y = exp(m x + c) to noisy samples, optionally with outliers and a
Cauchy loss (reference: examples/curve_fitting.cc, robust_curve_fitting.cc)."""

from __future__ import annotations

import numpy as np

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.scripts._cli import parser
from ceres_tpu_torch.examples.test_functions import (
    build_curve_fitting_problem,
    make_curve_fitting_data,
)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--robust", action="store_true", help="Cauchy loss")
    ap.add_argument("--outliers", type=int, default=0)
    ap.add_argument("--num_points", type=int, default=67)
    args = ap.parse_args(argv)
    data = make_curve_fitting_data(n=args.num_points)
    if args.outliers:
        rng = np.random.default_rng(5)
        rows = rng.choice(data.shape[0], args.outliers, replace=False)
        data[rows, 1] += rng.normal(0, 10.0, args.outliers)
    loss = ct.CauchyLoss(0.5) if args.robust else None
    problem, mc = build_curve_fitting_problem(data, loss=loss)
    options = ct.SolverOptions(max_num_iterations=100, minimizer_progress_to_stdout=True,
                               device=args.device)
    summary = ct.solve(options, problem)
    print(summary.brief_report())
    m, c = problem.parameter_block_value(mc)
    print(f"estimated m = {m:.6f} (truth 0.3), c = {c:.6f} (truth 0.1)")


if __name__ == "__main__":
    main()
