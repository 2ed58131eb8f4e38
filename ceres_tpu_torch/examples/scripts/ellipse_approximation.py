"""Piecewise-linear approximation of points on an ellipse, with inner
iterations (reference: examples/ellipse_approximation.cc)."""

from __future__ import annotations

import numpy as np

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.misc_examples import build_ellipse_approximation_problem
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(0)
    t = rng.uniform(-np.pi, np.pi, 200)
    pts = np.stack([2.0 * np.cos(t), np.sin(t)], axis=1)
    pts += rng.normal(0, 0.02, pts.shape)
    problem, _verts = build_ellipse_approximation_problem(pts)
    summary = ct.solve(ct.SolverOptions(max_num_iterations=100, use_inner_iterations=True,
                                        device=args.device), problem)
    print(summary.brief_report())


if __name__ == "__main__":
    main()
