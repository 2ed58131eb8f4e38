"""2D pose-graph SLAM from a g2o file, or a synthetic loop (reference:
examples/slam/pose_graph_2d)."""

from __future__ import annotations

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.pose_graph import (
    build_pose_graph_2d_problem,
    load_g2o_2d,
    synthetic_pose_graph_2d,
)
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--input", help="g2o file (synthetic loop if omitted)")
    args = ap.parse_args(argv)
    g = load_g2o_2d(args.input) if args.input else synthetic_pose_graph_2d()[0]
    problem, _handles = build_pose_graph_2d_problem(g)
    summary = ct.solve(ct.SolverOptions(max_num_iterations=100, device=args.device), problem)
    print(summary.brief_report())


if __name__ == "__main__":
    main()
