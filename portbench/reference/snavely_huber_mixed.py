"""The reference of the mixed-precision configuration (venice-1778-mixed), in
plain PyTorch.

`observed`, `cost` and `gradient_norm` are snavely_huber's: the option
changes how a step is found, not the problem, so `correct` judges the
answers as in the float32 cell.

`schur_matvec` is the product the option changes, the reduced camera
system's S·y as the configuration states it (Ceres' implicit Schur
complement, with the PCG matvec read from a bfloat16 copy of the Jacobian):

    J = [E F] sqrt(rho'(s)) diag(1 / (1 + |J_col|)),
    t1 = F y;  t2 = (EᵀE + D_e²)⁻¹ Eᵀ t1;  S y = Fᵀ(t1 − E t2) + D_f² y

The Jacobian of `residuals` is torch.func's; Huber's correction is the
factor sqrt(rho'(s)) (Ceres' corrector outside its inlier branch, which
Huber never enters: rho'' <= 0), and the column scale is Ceres' Jacobi
scaling, 1 / (1 + the column's norm), of the corrected Jacobian. The
scaled F and E, y, t1, t2 and t1 − E t2 are rounded to bfloat16 where the
port's PCG matvec rounds them (its kernel B4 on the bfloat16 copy);
EᵀE + D_e², its inverse and the D_f² y term take the unrounded values, as
the port keeps them in float32. Every product and sum is in float64.

Where it departs from the port:
- the order of sums: the port sums in float32, per point over its
  observations in bucket order and per camera in chunks of its slots, then
  the chunks in order; here float64 sums in the observations' order;
- blocks: the observations go in blocks of `block` rows (three passes: the
  column norms, then EᵀE, t1 and Eᵀt1, then Fᵀ(t1 − E t2)); the port holds
  the whole Jacobian;
- the leaves are rounded to bfloat16 from float64 values, the port's from
  float32 ones, so a value within a float32 rounding of a tie between two
  bfloat16 values may round the other way;
- EᵀE and its inverse are float64 (the port: float32).

`leaf_dtype=None` leaves every value unrounded, and `sum_dtype` sets the
dtype in which the sums are taken: the tests' controls.
"""

from __future__ import annotations

import numpy as np
import torch

from .snavely_huber import BLOCK, cost, gradient_norm, observed, residuals

__all__ = ["observed", "cost", "gradient_norm", "schur_matvec"]


def _jacobians(cams: torch.Tensor, pts: torch.Tensor, obs: torch.Tensor):
    """([n, 2, 9], [n, 2, 3]): d r / d camera and d r / d point of each
    observation's residuals (cameras and points one row per observation),
    times Huber's sqrt(rho'(|r|^2))."""

    def one(c, p, o):
        return residuals(c[None], p[None], o[None])[0]

    jc, jp = torch.func.vmap(torch.func.jacrev(one, argnums=(0, 1)))(cams, pts, obs)
    r = residuals(cams, pts, obs)
    s = (r * r).sum(1)
    w = torch.sqrt(torch.where(s <= 1, torch.ones_like(s), torch.rsqrt(s)))
    return jc * w[:, None, None], jp * w[:, None, None]


def schur_matvec(cameras, points, camera_index, point_index, observations, d_f, d_e, y,
                 device="cpu", block=BLOCK, leaf_dtype=torch.bfloat16,
                 sum_dtype=torch.float64) -> np.ndarray:
    """S·y [num_cameras, 9] of the scaled, corrected Jacobian at (cameras
    [nc, 9], points [np, 3]) for y [nc, 9], with the LM diagonal D_f [nc, 9]
    and D_e [np, 3] (S adds D_f² y, the point blocks D_e²); numpy in and out.
    `leaf_dtype` is the precision the leaves and the matvec's vectors are
    rounded to (None: not rounded), `sum_dtype` that of every sum."""
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(f64)

    def rnd(x):
        return x if leaf_dtype is None else x.to(leaf_dtype).to(f64)

    def acc(x):  # a sum's operand, in the sums' dtype
        return x.to(sum_dtype)

    cams, pts, yt = t(cameras), t(points), t(y)
    nc, npt = cams.shape[0], pts.shape[0]
    n = int(np.asarray(camera_index).shape[0])

    def blocks():
        for lo in range(0, n, block):
            hi = min(n, lo + block)
            ci = torch.as_tensor(np.asarray(camera_index[lo:hi]), device=device)
            pi = torch.as_tensor(np.asarray(point_index[lo:hi]), device=device)
            jc, jp = _jacobians(cams[ci], pts[pi], t(observations[lo:hi]))
            yield ci, pi, jc, jp

    # the Jacobi column scale of the corrected Jacobian
    norm_c = torch.zeros((nc, 9), dtype=f64, device=device)
    norm_p = torch.zeros((npt, 3), dtype=f64, device=device)
    for ci, pi, jc, jp in blocks():
        norm_c.index_add_(0, ci, (jc * jc).sum(1))
        norm_p.index_add_(0, pi, (jp * jp).sum(1))
    scale_c = 1 / (1 + torch.sqrt(norm_c))
    scale_p = 1 / (1 + torch.sqrt(norm_p))

    # EᵀE per point, t1 = F y per observation and s = Eᵀ t1 per point
    y_r = rnd(yt)
    gram = torch.zeros((npt, 3, 3), dtype=f64, device=device)
    s = torch.zeros((npt, 3), dtype=sum_dtype, device=device)
    t1 = []
    for ci, pi, jc, jp in blocks():
        F, E = jc * scale_c[ci][:, None, :], jp * scale_p[pi][:, None, :]
        gram.index_add_(0, pi, torch.einsum("nij,nik->njk", E, E))
        t1_b = rnd(acc(rnd(F) * y_r[ci][:, None, :]).sum(2).to(f64))  # [n, 2]
        s.index_add_(0, pi, acc(rnd(E) * t1_b[:, :, None]).sum(1))
        t1.append(t1_b)
    d_e2 = t(d_e) ** 2
    minv = torch.linalg.inv(gram + torch.diag_embed(d_e2))
    t2 = rnd(acc(minv * s.to(f64)[:, None, :]).sum(2).to(f64))  # [np, 3]

    # Fᵀ(t1 − E t2) per camera
    out = torch.zeros((nc, 9), dtype=sum_dtype, device=device)
    for (ci, pi, jc, jp), t1_b in zip(blocks(), t1):
        F, E = jc * scale_c[ci][:, None, :], jp * scale_p[pi][:, None, :]
        et2 = acc(rnd(E) * t2[pi][:, None, :]).sum(2).to(f64)
        diff = rnd((acc(t1_b) - acc(et2)).to(f64))
        out.index_add_(0, ci, acc(rnd(F) * diff[:, :, None]).sum(1))
    return (out.to(f64) + t(d_f) ** 2 * yt).cpu().numpy()
