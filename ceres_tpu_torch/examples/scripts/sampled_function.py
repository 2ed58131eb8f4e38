"""Minimize a function known only by its samples, through a cubic
interpolator (reference: examples/sampled_function.cc)."""

from __future__ import annotations

import numpy as np

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.denoising import build_sampled_function_problem
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    xs = np.arange(11.0)
    problem, b = build_sampled_function_problem((xs - 4.5) ** 2, x0=1.0)
    summary = ct.solve(ct.SolverOptions(max_num_iterations=100, device=args.device), problem)
    print(summary.brief_report())
    print("argmin x =", float(problem.parameter_block_value(b)[0]))


if __name__ == "__main__":
    main()
