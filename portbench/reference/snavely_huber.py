"""The cost of a BAL problem under Huber(1.0), in plain PyTorch.

cost = 1/2 sum_i rho(|r_i|^2), r_i = f d(x, y) (x, y) - observed_i, with
(x, y) = -P[:2] / P[2], P = R(aa) X + t (BAL's camera looks down -z),
d = 1 + k1 |(x, y)|^2 + k2 |(x, y)|^4, and Huber's rho(s) = s for s <= 1,
2 sqrt(s) - 1 above (Ceres' HuberLoss with a = 1). The formula is the
BAL page's and Ceres' examples/snavely_reprojection_error.h's, written
here again; nothing is taken from the port.

`cost` runs in blocks of observations, in float64 by default, on any
device; `dtype=torch.bfloat16` is the control: every input rounded to
bfloat16 and the arithmetic done there, each block's sum kept in float32.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 21


def _rotate(aa: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of p [n, 3] by angle-axis aa [n, 3]; below an
    angle of 1e-12 (squared, 1e-24) the first-order form p + aa x p."""
    theta2 = (aa * aa).sum(1, keepdim=True)
    small = theta2 < 1e-24
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    axis = aa / theta
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    rotated = (cos_t * p + sin_t * torch.linalg.cross(axis, p)
               + (1 - cos_t) * (axis * p).sum(1, keepdim=True) * axis)
    return torch.where(small, p + torch.linalg.cross(aa, p), rotated)


def residuals(cams: torch.Tensor, pts: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """[n, 2] residuals of observations obs [n, 2] of points pts [n, 3] by
    cameras cams [n, 9] (one row per observation)."""
    pc = _rotate(cams[:, 0:3], pts) + cams[:, 3:6]
    xy = -pc[:, 0:2] / pc[:, 2:3]
    r2 = (xy * xy).sum(1, keepdim=True)
    distortion = 1 + r2 * (cams[:, 7:8] + cams[:, 8:9] * r2)
    return cams[:, 6:7] * distortion * xy - obs


def observed(gen):
    """The generated problem's observation arrays, in the order `cost` and
    `gradient_norm` take them after the parameter blocks."""
    return gen.camera_index, gen.point_index, gen.observations


def huber(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s <= 1, s, 2 * torch.sqrt(torch.clamp_min(s, 1)) - 1)


def cost(cameras, points, camera_index, point_index, observations,
         device="cpu", dtype=torch.float64, block=BLOCK) -> float:
    """1/2 sum of Huber(|r|^2) over every observation, in blocks of
    `block` rows; the arrays are numpy ([nc, 9], [np, 3], [n], [n], [n, 2])."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    cams = torch.as_tensor(np.asarray(cameras), device=device).to(dtype)
    pts = torch.as_tensor(np.asarray(points), device=device).to(dtype)
    total = torch.zeros((), dtype=torch.float64, device=device)
    n = int(np.asarray(camera_index).shape[0])
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        ci = torch.as_tensor(np.asarray(camera_index[lo:hi]), device=device)
        pi = torch.as_tensor(np.asarray(point_index[lo:hi]), device=device)
        ob = torch.as_tensor(np.asarray(observations[lo:hi]), device=device).to(dtype)
        r = residuals(cams[ci], pts[pi], ob)
        s = (r * r).sum(1)
        total += huber(s).to(acc).sum(dtype=acc).double()
    return 0.5 * float(total)


def gradient_norm(cameras, points, camera_index, point_index, observations,
                  device="cpu", block=BLOCK) -> float:
    """|grad cost|_2 over every camera and point coordinate, in float64
    (autograd of `residuals` and `huber`, block by block)."""
    cams = torch.tensor(np.asarray(cameras), dtype=torch.float64, device=device,
                        requires_grad=True)
    pts = torch.tensor(np.asarray(points), dtype=torch.float64, device=device,
                       requires_grad=True)
    n = int(np.asarray(camera_index).shape[0])
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        ci = torch.as_tensor(np.asarray(camera_index[lo:hi]), device=device)
        pi = torch.as_tensor(np.asarray(point_index[lo:hi]), device=device)
        ob = torch.as_tensor(np.asarray(observations[lo:hi]), dtype=torch.float64, device=device)
        r = residuals(cams[ci], pts[pi], ob)
        (0.5 * huber((r * r).sum(1)).sum()).backward()
    return float(torch.sqrt((cams.grad ** 2).sum() + (pts.grad ** 2).sum()))
