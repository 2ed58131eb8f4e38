"""Kernels B4 (the PCG matvec S·y) and B5 (the SCHUR_JACOBI blocks).

B4 replaces `ceres_tpu/linalg/pallas_schur.py` `_sy_kernel`, B5 its
`_p0_kernel`; both read the scale-materialized F and E leaves in place.

B4 (`sy_apply`; `_sy_kernel` via `_seg_call` and `sy_apply`), the fused
implicit-Schur matvec of the PCG loop. Without the LM diagonal, which the
caller adds,

    t1 = F y;  t2 = (EᵀE + D_e²)⁻¹ Eᵀ t1;  S y = Fᵀ (t1 − E t2)

(reference: implicit_schur_complement.cc:118-165). The TPU kernel copies
F and E into (d, r·t, n_pad) segment arrays; here no copy is made. The
bucket plan already puts observation j of point p at lane
lane_start + j·n_seg + (p − out_row) (program.py), so csrc/schur_sy.cu runs
one thread per point straight on the scale-materialized F and E leaves:
gather y for each of its d observations, form t1_j = F_j·y, s = Σ_j E_jᵀt1_j,
t2 = M_p⁻¹ s from the [te², cnt_e] inverse table, and write
diff_j = t1_j − E_j·t2 to an [r, n] buffer. A second launch, kernel B3 on
(the F twin, the camera layout, diff), reduces Fᵀ·diff into [tf, ncols_f]
deterministically.

Eligibility (`sy_meta`, the counterpart of pallas_schur.sy_meta:65): one
signature group, a pure class split, one e-position on a bucket plan and
one f-position on a onehot plan, te <= MAX_TE, tf <= MAX_TF, r <= MAX_R and
r·tf <= MAX_RTF (the per-thread and shared-memory bounds of the two
kernels). The TPU's MIN_LANES threshold is dropped.
On CPU tensors `sy_apply` runs the composed product instead (the path JAX
takes when sy_meta is None, schur.py:533-541).

B5 (`p0_apply`, csrc/schur_p0.cu; `_p0_kernel` via `p0_apply`:563): per
camera c, P_c = Σ_l [F_lᵀF_l − (E_lᵀF_l)ᵀ M_p(l)⁻¹ (E_lᵀF_l)] over the
camera's observations, read from the camera-ordered twins of F and E and
the point row of each slot, one block per chunk of a camera's run with a
fixed-order combine (bitwise deterministic, no atomics), into a
[tf², cnt_f] table; tf, te and r are run-time values. The plain version is
the per-lane math of `ceres_tpu.linalg.schur.schur_jacobi_blocks`
(schur.py:250-263) on the same slots, followed by the camera reduce.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_lib
from ..gather_reduce import contract_reduce, contract_reduce_plain, gather_contract_plain
from ..jacobian import gather_T_t, reduce_T
from .preconditioners import apply_block_T

MAX_TE = 8  # e-block size bound of csrc/schur_sy.cu and csrc/schur_p0.cu
MAX_TF = 16  # f-block size bound of csrc/schur_p0.cu (its upper triangle)
MAX_R = 4  # residual bound of csrc/schur_p0.cu (its r x r Q per slot)
MAX_RTF = 32  # r·tf bound of csrc/schur_p0.cu (its shared-memory F and H tiles)


def sy_meta(program):
    """Static description of the fusable BA structure, or None."""
    if len(program.groups) != 1:
        return None
    from .schur import _pure_class_split

    split = _pure_class_split(program)
    if split is None:
        return None
    f_set, e_set = split
    _, e_positions, f_positions = program.compute_schur_partition()
    if len(e_positions[0]) != 1 or len(f_positions[0]) != 1:
        return None
    meta = program.groups[0]
    e_pos, f_pos = e_positions[0][0], f_positions[0][0]
    e_pm, f_pm = meta.positions[e_pos], meta.positions[f_pos]
    if e_pm.t_cls < 0 or f_pm.t_cls < 0:
        return None
    if {e_pm.t_cls} != e_set or {f_pm.t_cls} != f_set:
        return None
    plans = meta.red_plans or {}
    e_plan, f_plan = plans.get(e_pos), plans.get(f_pos)
    if e_plan is None or e_plan[0] != "bucket":
        return None
    if f_plan is None or f_plan[0] != "onehot":
        return None
    r = meta.num_residuals
    if e_pm.tangent_size > MAX_TE or f_pm.tangent_size > MAX_TF:
        return None
    if r > MAX_R or r * f_pm.tangent_size > MAX_RTF:
        return None
    buckets = e_plan[1]
    return {
        "e_pos": e_pos,
        "f_pos": f_pos,
        "e_cls": e_pm.t_cls,
        "f_cls": f_pm.t_cls,
        "cnt_f": program.tangent_class_counts[f_pm.t_cls],
        "te": e_pm.tangent_size,
        "tf": f_pm.tangent_size,
        "r": r,
        "buckets": buckets,
        "segs": np.asarray([list(b) for b in buckets], dtype=np.int32).reshape(-1),
        "pt_start": np.concatenate(
            [[0], np.cumsum([b[1] for b in buckets])]
        ).astype(np.int32),
    }


def sy_apply_plain(meta, F, E, rows_f, F_twin, layout_f, y_table, minv):
    """The composed product t1 = F y, s = Eᵀt1, t2 = M⁻¹ s, Fᵀ(t1 − E t2)."""
    r, te = meta["r"], meta["te"]
    n = F.shape[1]
    plan = ("bucket", meta["buckets"])
    cnt_e = minv.shape[1]
    t1 = gather_contract_plain(F, rows_f, y_table, r)
    e3 = E.reshape(r, te, n)
    s = reduce_T(plan, (e3 * t1[:, None, :]).sum(dim=0), None, cnt_e)
    t2 = apply_block_T(minv, s, te)
    et2 = (e3 * gather_T_t(plan, t2, None)[None]).sum(dim=1)
    return contract_reduce_plain(F_twin, layout_f, t1 - et2, r)


def sy_apply(meta, F, E, rows_f, F_twin, layout_f, y_table, minv, segs):
    """Fᵀ(I − E (EᵀE + D_e²)⁻¹ Eᵀ) F y for a camera table y_table
    [tf, ncols_f] (last column = dump) -> [tf, ncols_f]; D_f²·y is the
    caller's. F [r*tf, n] and E [r*te, n] are the scale-materialized leaves,
    F_twin F's camera-ordered copy in the slot order of layout_f (for the
    B3 reduce), minv the [te², cnt_e] inverse table.
    `segs` = sy_tables(meta, F.device)."""
    if F.device.type == "cpu":
        return sy_apply_plain(meta, F, E, rows_f, F_twin, layout_f, y_table, minv)
    r, te, tf = meta["r"], meta["te"], meta["tf"]
    dev, dt = F.device, F.dtype
    n = F.shape[1]
    ncols_f = y_table.shape[1]
    seg_t, pt_start = segs
    nb = len(meta["buckets"])
    num_points = int(meta["pt_start"][-1])
    cuda_lib.require("segs", seg_t, torch.int32, (nb * 4,), dev)
    cuda_lib.require("pt_start", pt_start, torch.int32, (nb + 1,), dev)
    cuda_lib.require("F", F, dt, (r * tf, n), dev)
    cuda_lib.require("E", E, dt, (r * te, n), dev)
    cuda_lib.require("rows_f", rows_f, torch.int32, (n,), dev)
    cuda_lib.require("y_table", y_table, dt, (tf, ncols_f), dev)
    cuda_lib.require("minv", minv, dt, (te * te, minv.shape[1]), dev)
    diff = torch.empty((r, n), dtype=dt, device=dev)
    fn = cuda_lib.kernel_fn("ctt_schur_sy", dt)
    rc = fn(
        cuda_lib.ptr(F), cuda_lib.ptr(E), cuda_lib.ptr(rows_f), cuda_lib.ptr(y_table),
        ncols_f, cuda_lib.ptr(seg_t), cuda_lib.ptr(pt_start), nb, num_points,
        cuda_lib.ptr(minv), minv.shape[1], n, r, te, tf, cuda_lib.ptr(diff),
        cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "schur_sy")
    cuda_lib.count("schur_sy")
    return contract_reduce(F_twin, layout_f, diff, r)


def sy_tables(meta, device):
    """The bucket table [nb*4] (lane_start, n_seg, d, out_row) and the point
    offsets [nb+1] as int32 tensors on `device`."""
    return (
        torch.as_tensor(meta["segs"], device=device),
        torch.as_tensor(meta["pt_start"], device=device),
    )


def p0_apply_plain(meta, F_twin, E_twin, prow, layout_f, minv_pm):
    """The per-slot FᵀF − (EᵀF)ᵀ M⁻¹ (EᵀF), reduced by camera; slots whose
    point row is outside the inverse table (padding: -1) add FᵀF only."""
    r, te, tf, cnt_f = meta["r"], meta["te"], meta["tf"], meta["cnt_f"]
    n_pad = F_twin.shape[1]
    cnt_e = minv_pm.shape[0]
    live = (prow >= 0) & (prow < cnt_e)
    m = minv_pm.T[:, torch.where(live, prow, torch.zeros_like(prow))]
    m = torch.where(live[None, :], m, torch.zeros_like(m)).reshape(te, te, n_pad)
    ej = E_twin.reshape(r, te, n_pad)
    fj = F_twin.reshape(r, tf, n_pad)
    outer = (fj[:, :, None, :] * fj[:, None, :, :]).sum(dim=0)
    etf = (ej[:, :, None, :] * fj[:, None, :, :]).sum(dim=0)
    minvetf = (m[:, :, None, :] * etf[None, :, :, :]).sum(dim=1)
    corr = (etf[:, :, None, :] * minvetf[:, None, :, :]).sum(dim=0)
    total = (outer - corr).reshape(tf * tf, n_pad)
    return contract_reduce_plain(total, layout_f, None, 1)[:, :cnt_f]


def p0_apply(meta, F_twin, E_twin, prow, layout_f, minv_pm):
    """SCHUR_JACOBI camera blocks without the LM diagonal: [tf², cnt_f] from
    the camera-ordered twins of the scale-materialized leaves, F_twin
    [r*tf, n_pad] and E_twin [r*te, n_pad] (zero on padding), the point row
    of each slot prow [n_pad] (-1 on padding), the camera layout and the
    point-major inverse blocks minv_pm [cnt_e, te²]
    (BlockDiagSolver.inv_records)."""
    if F_twin.device.type == "cpu":
        return p0_apply_plain(meta, F_twin, E_twin, prow, layout_f, minv_pm)
    r, te, tf, cnt_f = meta["r"], meta["te"], meta["tf"], meta["cnt_f"]
    dev, dt = F_twin.device, F_twin.dtype
    n_pad = F_twin.shape[1]
    cnt_e = minv_pm.shape[0]
    cuda_lib.require("F_twin", F_twin, dt, (r * tf, n_pad), dev)
    cuda_lib.require("E_twin", E_twin, dt, (r * te, n_pad), dev)
    cuda_lib.require("prow", prow, torch.int32, (n_pad,), dev)
    cuda_lib.require("chunk_start", layout_f.chunk_start, torch.int32, None, dev)
    cuda_lib.require("row_chunks", layout_f.row_chunks, torch.int32, (cnt_f + 2,), dev)
    cuda_lib.require("minv_pm", minv_pm, dt, (cnt_e, te * te), dev)
    nchunks = layout_f.live_chunks
    partial = torch.empty((tf * tf, nchunks), dtype=dt, device=dev)
    out = torch.empty((tf * tf, cnt_f), dtype=dt, device=dev)
    fn = cuda_lib.kernel_fn("ctt_schur_p0", dt)
    rc = fn(
        cuda_lib.ptr(F_twin), cuda_lib.ptr(E_twin), cuda_lib.ptr(prow),
        cuda_lib.ptr(layout_f.chunk_start), cuda_lib.ptr(layout_f.row_chunks),
        cuda_lib.ptr(minv_pm), cnt_e, n_pad, r, te, tf, nchunks, cnt_f,
        cuda_lib.ptr(partial), cuda_lib.ptr(out), cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "schur_p0")
    cuda_lib.count("schur_p0")
    return out
