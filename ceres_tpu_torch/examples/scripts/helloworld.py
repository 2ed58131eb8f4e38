"""Minimize 0.5 (10 - x)^2, the canonical first example, with autodiff,
numeric and analytic differentiation (reference: examples/helloworld.cc,
helloworld_numeric_diff.cc, helloworld_analytic_diff.cc)."""

from __future__ import annotations

import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.scripts._cli import parser


def f(params, data):
    return torch.stack([10.0 - params[0][0]])


def f_jac(params, data):
    # d(10 - x)/dx = -1 (helloworld_analytic_diff.cc)
    return (-torch.ones((1, 1), dtype=params[0].dtype, device=params[0].device),)


def run(cost_function, label, device):
    problem = ct.Problem()
    x = problem.add_parameter_block([0.5])
    problem.add_residual_block(cost_function, None, [x])
    summary = ct.solve(ct.SolverOptions(max_num_iterations=50, device=device), problem)
    print(f"{label}: x = {problem.parameter_block_value(x)[0]:.10f} "
          f"({summary.termination_type.value})")


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    run(ct.CostFunction(f, 1), "autodiff      ", args.device)
    run(ct.NumericDiffCostFunction(f, 1, method="CENTRAL"), "numeric diff  ", args.device)
    run(ct.AnalyticCostFunction(f, f_jac, 1), "analytic      ", args.device)


if __name__ == "__main__":
    main()
