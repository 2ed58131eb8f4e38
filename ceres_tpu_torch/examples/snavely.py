"""Snavely reprojection error for BAL bundle adjustment, in PyTorch.

Port of `ceres_tpu.examples.snavely` (reference:
examples/snavely_reprojection_error.h). 9 camera parameters
[angle-axis(3), t(3), f, k1, k2] and 3 point parameters; pixel =
f * distortion * perspective_divide(R x + t) with radial distortion
1 + k1 r^2 + k2 r^4 and the BAL convention (camera looks down -z). The
quaternion variant takes 10 camera parameters [q(4), t(3), f, k1, k2].
The CUDA kernel in csrc/eval_snavely.cu computes both expressions in the
same order.
"""

from __future__ import annotations

import torch


def angle_axis_rotate_point(aa, p):
    """Rotate p by the angle-axis vector aa (Rodrigues), with the
    small-angle linearization of rotation.h AngleAxisRotatePoint, written
    branch-free."""
    theta2 = (aa * aa).sum()
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-32))
    small = theta2 < 1e-24
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    axis = aa / theta
    w_cross_p = torch.linalg.cross(axis, p)
    tmp = (axis * p).sum() * (1.0 - cos_t)
    rotated = cos_t * p + sin_t * w_cross_p + tmp * axis
    # small angle: p + aa x p
    approx = p + torch.linalg.cross(aa, p)
    return torch.where(small, approx, rotated)


def snavely_reprojection_error(params, data):
    """params = (camera [9], point [3]); data = (observed_xy [2],) -> [2]."""
    camera, point = params
    (observed,) = data
    p = angle_axis_rotate_point(camera[:3], point) + camera[3:6]
    # BAL convention: negative z plane projection. One-element slices, not
    # 0-d selects: torch.func's forward mode promotes a 0-d select combined
    # with a Python float to float64 tangents.
    xy = -p[:2] / p[2:3]
    f, k1, k2 = camera[6:7], camera[7:8], camera[8:9]
    r2 = xy[0:1] * xy[0:1] + xy[1:2] * xy[1:2]
    distortion = 1.0 + r2 * (k1 + k2 * r2)
    return f * distortion * xy - observed


def snavely_reprojection_error_with_quaternions(params, data):
    """params = (camera [10] = [q(4) | t(3) | f k1 k2], point [3]);
    data = (observed_xy [2],) -> [2].

    reference: SnavelyReprojectionErrorWithQuaternions
    (examples/snavely_reprojection_error.h:89-152). q is not normalized."""
    from ..rotation import unit_quaternion_rotate_point

    camera, point = params
    (observed,) = data
    p = unit_quaternion_rotate_point(camera[:4], point) + camera[4:7]
    # one-element slices, as in snavely_reprojection_error
    xy = -p[:2] / p[2:3]
    f, k1, k2 = camera[7:8], camera[8:9], camera[9:10]
    r2 = xy[0:1] * xy[0:1] + xy[1:2] * xy[1:2]
    distortion = 1.0 + r2 * (k1 + k2 * r2)
    return f * distortion * xy - observed
