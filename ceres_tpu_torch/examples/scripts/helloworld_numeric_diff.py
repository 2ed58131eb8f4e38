"""Minimize 0.5 (10 - x)^2 with a central-difference Jacobian (reference:
examples/helloworld_numeric_diff.cc)."""

from __future__ import annotations

import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    problem = ct.Problem()
    x = problem.add_parameter_block([0.5])

    def f(params, data):
        return torch.stack([10.0 - params[0][0]])

    cf = ct.NumericDiffCostFunction(f, 1, method="CENTRAL", name="hello")
    problem.add_residual_block(cf, None, [x])
    summary = ct.solve(ct.SolverOptions(device=args.device), problem)
    print(summary.brief_report())
    print("x =", float(problem.parameter_block_value(x)[0]))


if __name__ == "__main__":
    main()
