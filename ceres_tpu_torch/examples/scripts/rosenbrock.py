"""Rosenbrock's function through the line-search gradient solver
(reference: examples/rosenbrock.cc)."""

from __future__ import annotations

import numpy as np

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.scripts._cli import parser


def rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    x, summary = ct.solve_gradient_problem(
        ct.SolverOptions(max_num_iterations=200, device=args.device),
        ct.GradientProblem(rosenbrock, size=2), np.array([-1.2, 1.0]))
    print(summary.brief_report())
    print("x =", np.asarray(x))


if __name__ == "__main__":
    main()
