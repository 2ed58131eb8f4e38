"""Robust circle fit (reference: examples/circle_fit.cc)."""

from __future__ import annotations

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.misc_examples import build_circle_fit_problem, synthetic_circle_points
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    problem, xy, m = build_circle_fit_problem(synthetic_circle_points())
    summary = ct.solve(ct.SolverOptions(max_num_iterations=100, device=args.device), problem)
    print(summary.brief_report())
    cx, cy = problem.parameter_block_value(xy)
    r = float(problem.parameter_block_value(m)[0]) ** 2  # r = m^2 (circle_fit.cc)
    print(f"center = ({cx:.4f}, {cy:.4f}), radius = {r:.4f}")


if __name__ == "__main__":
    main()
