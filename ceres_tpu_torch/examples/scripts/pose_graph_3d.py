"""3D pose-graph SLAM from a g2o file (reference: examples/slam/pose_graph_3d)."""

from __future__ import annotations

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.pose_graph import build_pose_graph_3d_problem, load_g2o_3d
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--input", required=True, help="g2o 3D file")
    args = ap.parse_args(argv)
    problem, *_handles = build_pose_graph_3d_problem(load_g2o_3d(args.input))
    summary = ct.solve(ct.SolverOptions(max_num_iterations=100, device=args.device), problem)
    print(summary.brief_report())


if __name__ == "__main__":
    main()
