"""Kernels B4 (the PCG matvec S·y) and B5 (the SCHUR_JACOBI blocks).

B4 replaces `ceres_tpu/linalg/pallas_schur.py` `_sy_kernel`, B5 its
`_p0_kernel`; both read the scale-materialized F and E leaves and the
camera-ordered twins of them (jacobian.make_twin).

B4 (`sy_apply`; `_sy_kernel` via `_seg_call` and `sy_apply`), the fused
implicit-Schur matvec of the PCG loop (reference:
implicit_schur_complement.cc:118-165):

    t1 = F y;  t2 = (EᵀE + D_e²)⁻¹ Eᵀ t1;  S y = Fᵀ (t1 − E t2) (+ D_f² y)

The TPU kernel does it in one pass over (d, r·t, n_pad) segment copies.
On the H100 the per-point sum and the per-camera sum run in two orders
(csrc/schur_sy.cu), and no [r, n] intermediate reaches device memory:

- `sy_point_pass`: one thread per point, in place on the bucket layout of
  the lane-order F and E leaves (observation j of point p at lane
  lane_start + j·n_seg + (p − out_row), program.py): t2 = M_p⁻¹ Σ_j E_jᵀ F_j y
  from the [te², cnt_e] inverse table, written point-major [cnt_e, ld].
- `sy_fold_pass`: one block per chunk of one camera's slots on the twins of
  F and E and the point row of each slot (the inputs B5 takes): per slot
  diff = F y_c − E t2[prow] in registers, Fᵀ diff summed per chunk, then a
  camera's chunks in index order, + D_f² y when the caller passes D_f²
  (rounded as out + dsq·y is), the dump column 0. Bitwise reproducible, no
  atomics.

Both passes stream the leaves (device memory bounds them): about 1.05 GB per
S·y at BAL-1778 in float32, against ~1.2 GB plus a random gather of an
[r, n] diff buffer by a second (B3) launch in the earlier design.

Eligibility (`sy_meta`, the counterpart of pallas_schur.sy_meta:65): one
signature group, a pure class split, one e-position on a bucket plan and
one f-position on a onehot plan, te <= MAX_TE, tf <= MAX_TF, r <= MAX_R and
r·tf <= MAX_RTF (the per-thread and shared-memory bounds of the kernels).
The TPU's MIN_LANES threshold is dropped. On CPU tensors `sy_apply` runs the
composed product, `sy_apply_plain` (the path JAX takes when sy_meta is None,
schur.py:533-541); `sy_point_plain` and `sy_fold_plain` are the plain
versions of the two passes.

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
from ..gather_reduce import contract_reduce_plain, gather_contract_plain
from ..jacobian import gather_T_t, reduce_T
from .preconditioners import apply_block_T

MAX_TE = 8  # e-block size bound of csrc/schur_sy.cu and csrc/schur_p0.cu
MAX_TF = 16  # f-block size bound of both (schur_p0.cu: its upper triangle)
MAX_R = 4  # residual bound of both (schur_p0.cu: its r x r Q per slot)
MAX_RTF = 32  # r·tf bound of both (schur_p0.cu: its shared-memory F and H tiles)


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


def _finish_plain(out, y_table, dsq):
    """+ dsq·y (a product, then a sum, as the kernel's epilogue rounds it),
    then the dump column zeroed."""
    if dsq is not None:
        out = out + dsq * y_table
    out[:, -1] = 0
    return out


def sy_apply_plain(meta, F, E, rows_f, F_twin, layout_f, y_table, minv, dsq=None):
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
    out = contract_reduce_plain(F_twin, layout_f, t1 - et2, r)
    return _finish_plain(out, y_table, dsq)


def sy_point_plain(meta, F, E, rows_f, y_table, minv):
    """Pass (a)'s plain version: t2 = M_p⁻¹ Σ_j E_jᵀ F_j y per point,
    point-major [cnt_e, te]."""
    r, te = meta["r"], meta["te"]
    n = F.shape[1]
    plan = ("bucket", meta["buckets"])
    t1 = gather_contract_plain(F, rows_f, y_table, r)
    s = reduce_T(plan, (E.reshape(r, te, n) * t1[:, None, :]).sum(dim=0), None, minv.shape[1])
    return apply_block_T(minv, s, te).T


def sy_fold_plain(meta, F_twin, E_twin, prow, layout_f, y_table, t2, dsq=None):
    """Pass (b)'s plain version: per slot diff = F y_c − E t2[prow] (t2 = 0
    where the point row is outside t2), Fᵀ diff reduced by camera, then the
    dump column zeroed and + dsq·y."""
    r, te, tf = meta["r"], meta["te"], meta["tf"]
    n_pad = F_twin.shape[1]
    f3 = F_twin.reshape(r, tf, n_pad)
    t1 = (f3 * y_table[:, layout_f.slot_row][None]).sum(dim=1)
    live = (prow >= 0) & (prow < t2.shape[0])
    tt = t2[torch.where(live, prow, torch.zeros_like(prow)), :te].T
    tt = torch.where(live[None, :], tt, torch.zeros_like(tt))
    diff = t1 - (E_twin.reshape(r, te, n_pad) * tt[None]).sum(dim=1)
    out = F_twin.new_zeros((tf, len(layout_f.offsets) - 1))
    out.index_add_(1, layout_f.slot_row, (f3 * diff[:, None, :]).sum(dim=0))
    return _finish_plain(out, y_table, dsq)


def sy_point_pass(meta, F, E, rows_f, y_table, minv, segs):
    """Pass (a) of `sy_apply`: t2 point-major [cnt_e, ld], ld = te rounded
    up to 4 (the record past te is 0). F [r*tf, n] and E [r*te, n] are the
    lane-order leaves, minv the [te², cnt_e] inverse table, `segs` =
    sy_tables(meta, F.device)."""
    if F.device.type == "cpu":
        return sy_point_plain(meta, F, E, rows_f, y_table, minv)
    r, te, tf = meta["r"], meta["te"], meta["tf"]
    dev, dt = F.device, F.dtype
    n = F.shape[1]
    ncols_f = y_table.shape[1]
    cnt_e = minv.shape[1]
    seg_t, pt_start = segs
    nb = len(meta["buckets"])
    cuda_lib.require("segs", seg_t, torch.int32, (nb * 4,), dev)
    cuda_lib.require("pt_start", pt_start, torch.int32, (nb + 1,), dev)
    cuda_lib.require("F", F, dt, (r * tf, n), dev)
    cuda_lib.require("E", E, dt, (r * te, n), dev)
    cuda_lib.require("rows_f", rows_f, torch.int32, (n,), dev)
    cuda_lib.require("y_table", y_table, dt, (tf, ncols_f), dev)
    cuda_lib.require("minv", minv, dt, (te * te, cnt_e), dev)
    ld = -(-te // 4) * 4
    t2 = torch.empty((cnt_e, ld), dtype=dt, device=dev)
    rc = cuda_lib.kernel_fn("ctt_schur_sy_point", dt)(
        cuda_lib.ptr(F), cuda_lib.ptr(E), cuda_lib.ptr(rows_f), cuda_lib.ptr(y_table),
        ncols_f, cuda_lib.ptr(seg_t), cuda_lib.ptr(pt_start), nb, int(meta["pt_start"][-1]),
        cuda_lib.ptr(minv), cnt_e, n, r, te, tf, cuda_lib.ptr(t2), ld, cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "schur_sy point pass")
    return t2


def sy_fold_pass(meta, F_twin, E_twin, prow, layout_f, y_table, t2, dsq=None):
    """Pass (b) of `sy_apply`: Fᵀ(F y − E t2) [tf, ncols_f] from the twins
    F_twin [r*tf, n_pad] and E_twin [r*te, n_pad] (zero on padding), the
    point row of each slot prow [n_pad] (-1 on padding), the camera layout
    and t2 [cnt_e, ld]; + dsq·y when dsq [tf, ncols_f] is given; the dump
    column 0."""
    if F_twin.device.type == "cpu":
        return sy_fold_plain(meta, F_twin, E_twin, prow, layout_f, y_table, t2, dsq)
    r, te, tf = meta["r"], meta["te"], meta["tf"]
    dev, dt = F_twin.device, F_twin.dtype
    n_pad = F_twin.shape[1]
    ncols_f = y_table.shape[1]
    cuda_lib.require("F_twin", F_twin, dt, (r * tf, n_pad), dev)
    cuda_lib.require("E_twin", E_twin, dt, (r * te, n_pad), dev)
    cuda_lib.require("prow", prow, torch.int32, (n_pad,), dev)
    cuda_lib.require("chunk_start", layout_f.chunk_start, torch.int32, None, dev)
    cuda_lib.require("row_chunks", layout_f.row_chunks, torch.int32, (ncols_f + 1,), dev)
    cuda_lib.require("slot_row", layout_f.slot_row, torch.int32, (n_pad,), dev)
    cuda_lib.require("y_table", y_table, dt, (tf, ncols_f), dev)
    cuda_lib.require("t2", t2, dt, (t2.shape[0], t2.shape[1]), dev)
    if dsq is not None:
        cuda_lib.require("dsq", dsq, dt, (tf, ncols_f), dev)
    nchunks = layout_f.live_chunks
    partial = torch.empty((tf, nchunks), dtype=dt, device=dev)
    out = torch.empty((tf, ncols_f), dtype=dt, device=dev)
    rc = cuda_lib.kernel_fn("ctt_schur_sy_fold", dt)(
        cuda_lib.ptr(F_twin), cuda_lib.ptr(E_twin), cuda_lib.ptr(prow),
        cuda_lib.ptr(layout_f.chunk_start), cuda_lib.ptr(layout_f.row_chunks),
        cuda_lib.ptr(layout_f.slot_row), cuda_lib.ptr(y_table), cuda_lib.ptr(dsq), ncols_f,
        cuda_lib.ptr(t2), t2.shape[1], t2.shape[0], n_pad, r, te, tf, nchunks,
        cuda_lib.ptr(partial), cuda_lib.ptr(out), cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "schur_sy fold pass")
    cuda_lib.count("schur_sy")  # one per S·y: the fold pass ends it
    return out


def sy_apply(meta, F, E, rows_f, F_twin, E_twin, prow, layout_f, y_table, minv, segs, dsq=None):
    """Fᵀ(I − E (EᵀE + D_e²)⁻¹ Eᵀ) F y (+ dsq·y) for a camera table y_table
    [tf, ncols_f] (last column = dump) -> [tf, ncols_f], dump column 0.
    F [r*tf, n] and E [r*te, n] are the scale-materialized leaves, F_twin and
    E_twin their copies in the slot order of layout_f, prow the point row of
    each slot (program.slot_rows), minv the [te², cnt_e] inverse table,
    dsq the LM diagonal D_f² as a [tf, ncols_f] table or None.
    `segs` = sy_tables(meta, F.device). Two launches; the fold pass counts
    them as one S·y."""
    if F.device.type == "cpu":
        return sy_apply_plain(meta, F, E, rows_f, F_twin, layout_f, y_table, minv, dsq)
    t2 = sy_point_pass(meta, F, E, rows_f, y_table, minv, segs)
    return sy_fold_pass(meta, F_twin, E_twin, prow, layout_f, y_table, t2, dsq)


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
