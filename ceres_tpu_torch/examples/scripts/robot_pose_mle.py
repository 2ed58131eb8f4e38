"""1-D corridor localization from odometry and range readings (reference:
examples/robot_pose_mle.cc)."""

from __future__ import annotations

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.misc_examples import build_robot_pose_mle_problem, simulate_robot
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    odometry, ranges, _truth = simulate_robot()
    problem, handles = build_robot_pose_mle_problem(odometry, ranges)
    summary = ct.solve(ct.SolverOptions(max_num_iterations=100, device=args.device), problem)
    print(summary.brief_report())
    est = [float(problem.parameter_block_value(h)[0]) for h in handles]
    print("estimated step sizes:", [round(v, 3) for v in est[:8]], "...")


if __name__ == "__main__":
    main()
