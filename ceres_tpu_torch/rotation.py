"""Rotation conversions and applications, branch-free in PyTorch.

Port of `ceres_tpu.rotation` (reference: include/ceres/rotation.h):
angle-axis / quaternion / rotation-matrix conversions and point rotation.
Every function acts on one block's tensors, takes its small-angle branch by
a `torch.where` select on safe operands (so torch.func differentiates it and
`vmap` batches it), and builds no constant on another device than its
input's. Quaternions are [w, x, y, z] (Ceres order).
"""

from __future__ import annotations

import math

import torch


def _cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def angle_axis_rotate_point(aa, p):
    """Rodrigues rotation; differentiable at aa = 0."""
    theta2 = (aa * aa).sum()
    small = theta2 < 1e-24
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    axis = aa / theta
    w_cross_p = _cross(axis, p)
    tmp = (axis * p).sum() * (1.0 - cos_t)
    rotated = cos_t * p + sin_t * w_cross_p + tmp * axis
    approx = p + _cross(aa, p)
    return torch.where(small, approx, rotated)


def angle_axis_to_quaternion(aa):
    """[w, x, y, z]; rotation.h AngleAxisToQuaternion."""
    theta2 = (aa * aa).sum()
    small = theta2 < 1e-24
    one = torch.ones_like(theta2)
    theta = torch.sqrt(torch.where(small, one, theta2))
    half = 0.5 * theta
    k = torch.where(small, 0.5 * one, torch.sin(half) / theta)
    w = torch.where(small, one, torch.cos(half))
    return torch.cat([w[None], k * aa])


def quaternion_to_angle_axis(q):
    """rotation.h QuaternionToAngleAxis."""
    sin2 = (q[1:] * q[1:]).sum()
    small = sin2 < 1e-24
    sin_theta = torch.sqrt(torch.where(small, torch.ones_like(sin2), sin2))
    cos_theta = q[0]
    # two_theta in [0, 2pi): atan2 with the sign of cos_theta folded in
    # (rotation.h: k = two_theta / sin_theta)
    two_theta = 2.0 * torch.where(
        cos_theta < 0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta),
    )
    k = torch.where(small, 2.0 * torch.ones_like(sin2), two_theta / sin_theta)
    return k * q[1:]


def quaternion_to_rotation_matrix(q):
    """Row-major R from a quaternion; rotation.h QuaternionToRotation
    (normalizes first)."""
    n = torch.sqrt((q * q).sum())
    w, x, y, z = q[0] / n, q[1] / n, q[2] / n, q[3] / n
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def rotation_matrix_to_quaternion(r):
    """Shepperd's method: the candidate of the largest magnitude, chosen by
    a select (the first of equal ones), normalized, w >= 0."""
    t = r[0, 0] + r[1, 1] + r[2, 2]
    q0 = torch.stack([1.0 + t, r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    q1 = torch.stack([
        r[2, 1] - r[1, 2], 1.0 + r[0, 0] - r[1, 1] - r[2, 2], r[0, 1] + r[1, 0], r[0, 2] + r[2, 0],
    ])
    q2 = torch.stack([
        r[0, 2] - r[2, 0], r[0, 1] + r[1, 0], 1.0 - r[0, 0] + r[1, 1] - r[2, 2], r[1, 2] + r[2, 1],
    ])
    q3 = torch.stack([
        r[1, 0] - r[0, 1], r[0, 2] + r[2, 0], r[1, 2] + r[2, 1], 1.0 - r[0, 0] - r[1, 1] + r[2, 2],
    ])
    mags = torch.stack([
        1.0 + t,
        1.0 + r[0, 0] - r[1, 1] - r[2, 2],
        1.0 - r[0, 0] + r[1, 1] - r[2, 2],
        1.0 - r[0, 0] - r[1, 1] + r[2, 2],
    ])
    best = torch.argmax(mags)
    q = torch.stack([q0, q1, q2, q3])[best]
    q = q / torch.linalg.norm(q)
    return q * torch.where(q[0] < 0, -torch.ones_like(q[0]), torch.ones_like(q[0]))


def angle_axis_to_rotation_matrix(aa):
    return quaternion_to_rotation_matrix(angle_axis_to_quaternion(aa))


def rotation_matrix_to_angle_axis(r):
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(r))


def quaternion_product(a, b):
    """Hamilton product [w,x,y,z]; rotation.h QuaternionProduct."""
    w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3]
    x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2]
    y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1]
    z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0]
    return torch.stack([w, x, y, z])


def quaternion_conjugate(q):
    return torch.cat([q[:1], -q[1:]])


def unit_quaternion_rotate_point(q, p):
    """rotation.h UnitQuaternionRotatePoint: p + w t + v x t with
    t = 2 v x p. Does not normalize q."""
    t = 2.0 * _cross(q[1:], p)
    return p + q[0] * t + _cross(q[1:], t)


def quaternion_rotate_point(q, p):
    """Non-unit quaternion: normalize then rotate."""
    return unit_quaternion_rotate_point(q / torch.linalg.norm(q), p)


def cross_product_matrix(v):
    zero = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([zero, -v[2], v[1]]),
        torch.stack([v[2], zero, -v[0]]),
        torch.stack([-v[1], v[0], zero]),
    ])


def euler_angles_to_rotation_matrix(euler_deg):
    """ZYX convention in degrees; rotation.h EulerAnglesToRotationMatrix."""
    rad = euler_deg * (math.pi / 180.0)
    c = torch.cos(rad)
    s = torch.sin(rad)
    c1, c2, c3 = c[0], c[1], c[2]
    s1, s2, s3 = s[0], s[1], s[2]
    return torch.stack([
        torch.stack([c1 * c2, -s1 * c3 + c1 * s2 * s3, s1 * s3 + c1 * s2 * c3]),
        torch.stack([s1 * c2, c1 * c3 + s1 * s2 * s3, -c1 * s3 + s1 * s2 * c3]),
        torch.stack([-s2, c2 * s3, c2 * c3]),
    ])
