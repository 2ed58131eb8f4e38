"""Bundle a blender problem dump with libmv's EUC bundle (reference:
examples/libmv_bundle_adjuster.cc)."""

from __future__ import annotations

from ceres_tpu_torch.examples.libmv import read_libmv_problem, solve_libmv_problem
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--input", required=True, help="blender problem dump")
    ap.add_argument("--refine_intrinsics", default="none", choices=["none", "radial"])
    args = ap.parse_args(argv)
    prob = read_libmv_problem(args.input)
    print(f"cameras: {int(prob.camera_valid.sum())}, points: {int(prob.point_valid.sum())}, "
          f"markers: {prob.markers.shape[0]}")
    intr, _cams, _pts, summary = solve_libmv_problem(
        prob, refine_intrinsics=args.refine_intrinsics, device=args.device)
    print(summary.brief_report())
    print("final intrinsics:", intr)


if __name__ == "__main__":
    main()
