"""Homography from point correspondences: DLT, then the symmetric
geometric refinement (reference: examples/libmv_homography.cc)."""

from __future__ import annotations

import numpy as np

from ceres_tpu_torch.examples.libmv import EstimateHomographyOptions, estimate_homography
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    h_true = np.array([[1.243715, -0.461057, -111.964454],
                       [0.0, 0.617589, -192.379252],
                       [0.0, -0.000983, 1.0]])
    x1 = np.random.default_rng(0).uniform(0, 500, (12, 2))
    y = (h_true @ np.concatenate([x1, np.ones((12, 1))], axis=1).T).T
    x2 = y[:, :2] / y[:, 2:3]
    h, summary = estimate_homography(
        x1, x2, EstimateHomographyOptions(expected_average_symmetric_distance=1e-10),
        device=args.device)
    print(summary.brief_report())
    print("estimated H:\n", h)
    print("true H:\n", h_true)


if __name__ == "__main__":
    main()
