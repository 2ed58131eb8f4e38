"""Powell's singular function (reference: examples/powell.cc)."""

from __future__ import annotations

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.scripts._cli import parser
from ceres_tpu_torch.examples.test_functions import build_powell_problem


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    problem, handles = build_powell_problem()
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_QR,
        max_num_iterations=100,
        minimizer_progress_to_stdout=True,
        device=args.device,
    )
    summary = ct.solve(options, problem)
    print(summary.brief_report())
    print("final x =", [float(problem.parameter_block_value(h)[0]) for h in handles])


if __name__ == "__main__":
    main()
