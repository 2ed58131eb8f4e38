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
(csrc/schur_sy.cuh), and no [r, n] intermediate reaches device memory:

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

Under mixed-precision solves F, E and their twins are bfloat16 (the
`_bf16` entry points, counted as `schur_sy_bf16`) and everything else is
float32: y, t1, t2 and diff are rounded to bfloat16 where `_sy_kernel`
casts them to the leaf type (y as gathered, t1 before Eᵀt1, t2 before E t2,
diff before Fᵀdiff; gather_reduce.leaf_operand), products and sums are
float32. `_sy_kernel` forms t1 in bfloat16 and subtracts that same value in
diff = t1 − E t2; so does this one (the rounded t1 in both passes), which
keeps diff the projection of one t1: subtracting the unrounded t1 instead
nearly doubles the error against exact arithmetic on the bfloat16 leaves
(3.3e-3 against 2.0e-3 of the largest output, synthetic_bal(6, 60, 300),
tests/test_torch_mixed_precision.py). `_sy_kernel` also rounds the products
and some sums to bfloat16 (pallas_schur.py:309); here a product of two
bfloat16 values is exact in float32, a deliberate deviation toward
precision. The bfloat16 passes have kernels of their own (csrc/schur_sy.cuh):
the point pass gathers y from a copy of the table in shared memory where
`gather_reduce.table_fits(tf, ncols)` (BAL-1778's 9 x 1,779), else from
device memory as the float kernel does, bitwise the same t2 either way;
the slot pass takes 4 consecutive slots a thread with 8-byte twin loads, a
block a 256-slot piece of a chunk (`gather_reduce.chunk_pieces` partial
sums a chunk), which needs n_pad a multiple of 8 and the twins and `prow`
16-byte aligned (every twin the port makes is; a misaligned one raises).
Device memory bounds both; reading each leaf once per pass, the two
passes' bounds together are about twice the bound of S·y (PERF.md §6).

Eligibility (`sy_meta`, the counterpart of pallas_schur.sy_meta:65): one
signature group, a pure class split, one e-position on a bucket plan and
one f-position on a onehot plan, te <= MAX_TE, tf <= MAX_TF, r <= MAX_R and
r·tf <= MAX_RTF (the per-thread and shared-memory bounds of the kernels).
The TPU's MIN_LANES threshold is dropped. On CPU tensors `sy_apply` runs the
composed product, `sy_apply_plain` (the path JAX takes when sy_meta is None,
schur.py:533-541); `sy_point_plain` and `sy_fold_plain` are the plain
versions of the two passes.

Every B4 kernel is shape-exact, as `_sy_kernel` is (static d, r, te, tf;
pallas_schur.py:260-275): the library holds the BA shape (r, tf, te) =
BA_SHAPE, and every other shape is a source of its own (`sy_source`: a
few lines that instantiate csrc/schur_sy.cuh), which `sy_meta` records,
cuda_lib.build_generated compiles into the gitignored _build/ and
`sy_point_pass` / `sy_fold_pass` launch (`sy_route`). The Evaluator builds
the source of its Program's shape (`sy_sources`) with B1 generic's, when it
is made on a card, before any CUDA graph capture; a failed build or launch
raises, and no shape falls back to another kernel.

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

import functools

import numpy as np
import torch

from .. import cuda_lib
from ..gather_reduce import (
    chunk_pieces, contract_reduce_plain, gather_contract_plain, leaf_operand, widen,
)
from ..jacobian import gather_T_t, reduce_T
from ..utils.graphs import upload
from .preconditioners import apply_block_T

MAX_TE = 8  # e-block size bound of csrc/schur_sy.cuh and csrc/schur_p0.cu
MAX_TF = 16  # f-block size bound of both (schur_p0.cu: its upper triangle)
MAX_R = 4  # residual bound of both (schur_p0.cu: its r x r Q per slot)
MAX_RTF = 32  # r·tf bound of both (schur_p0.cu: its shared-memory F and H tiles)
# the (r, tf, te) of B4's instantiation in the kernel library (csrc/schur_sy.cu)
BA_SHAPE = (2, 9, 3)


def sy_shape_ok(r, tf, te):
    """Whether B4 takes residual r, f-block tf and e-block te."""
    return 1 <= r <= MAX_R and 1 <= tf <= MAX_TF and 1 <= te <= MAX_TE and r * tf <= MAX_RTF


@functools.lru_cache(maxsize=None)
def sy_source(r, tf, te):
    """The CUDA source of B4's kernels at one shape (r, tf, te): the six
    entry points (point and slot pass; float32, float64 and bfloat16
    leaves) of csrc/schur_sy.cuh instantiated there, for
    cuda_lib.build_generated. The same text for the same shape."""
    if not sy_shape_ok(r, tf, te):
        raise ValueError(f"schur_sy: shape (r, tf, te) = {(r, tf, te)} is outside "
                         f"r <= {MAX_R}, tf <= {MAX_TF}, te <= {MAX_TE}, r·tf <= {MAX_RTF}")
    return (f"// Kernel B4 at (r, tf, te) = ({r}, {tf}, {te}), written by "
            f"ceres_tpu_torch/linalg/schur_kernels.py sy_source\n"
            f'#include "schur_sy.cuh"\n\nCTT_SCHUR_SY_ENTRY({r}, {tf}, {te})\n')


def sy_route(meta):
    """The source whose kernels run B4 at meta's shape, or None for the
    library's (the BA shape)."""
    shape = (meta["r"], meta["tf"], meta["te"])
    if shape == BA_SHAPE:
        return None
    return meta.get("source") or sy_source(*shape)


def _sy_fn(meta, prefix, dtype):
    """B4's entry point `prefix` for leaves of `dtype` at meta's shape."""
    source = sy_route(meta)
    if source is None:
        return cuda_lib.kernel_fn(prefix, dtype)
    return cuda_lib.generated_fn(source, dtype, prefix)


def sy_sources(program):
    """The sources of every B4 shape `sy_meta` can give this Program, read
    from its layout plans without the Schur partition (one group; a
    bucket-planned e-position and a onehot-planned f-position of other
    tangent classes): what the Evaluator builds, so that no source is met
    first inside a CUDA graph capture. [] for the BA shape and for a
    Program B4 does not serve."""
    if len(program.groups) != 1:
        return []
    meta = program.groups[0]
    plans = meta.red_plans or {}
    kind = {pos: plan[0] for pos, plan in plans.items() if plan is not None}
    out = set()
    for e_pm in (meta.positions[p] for p in kind if kind[p] == "bucket"):
        for f_pm in (meta.positions[p] for p in kind if kind[p] == "onehot"):
            shape = (meta.num_residuals, f_pm.tangent_size, e_pm.tangent_size)
            if (min(e_pm.t_cls, f_pm.t_cls) >= 0 and e_pm.t_cls != f_pm.t_cls
                    and shape != BA_SHAPE and sy_shape_ok(*shape)):
                out.add(sy_source(*shape))
    return sorted(out)


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
    r, tf, te = meta.num_residuals, f_pm.tangent_size, e_pm.tangent_size
    if not sy_shape_ok(r, tf, te):
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
        # the generated source of B4 at this shape; None: the library's
        "source": None if (r, tf, te) == BA_SHAPE else sy_source(r, tf, te),
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
    t1 = leaf_operand(gather_contract_plain(F, rows_f, y_table, r), E.dtype)
    e3 = widen(E).reshape(r, te, n)
    s = reduce_T(plan, (e3 * t1[:, None, :]).sum(dim=0), None, cnt_e)
    t2 = apply_block_T(minv, s, te)
    et2 = (e3 * leaf_operand(gather_T_t(plan, t2, None), E.dtype)[None]).sum(dim=1)
    out = contract_reduce_plain(F_twin, layout_f, t1 - et2, r)
    return _finish_plain(out, y_table, dsq)


def sy_point_plain(meta, F, E, rows_f, y_table, minv):
    """Pass (a)'s plain version: t2 = M_p⁻¹ Σ_j E_jᵀ F_j y per point,
    point-major [cnt_e, te]."""
    r, te = meta["r"], meta["te"]
    n = F.shape[1]
    plan = ("bucket", meta["buckets"])
    t1 = leaf_operand(gather_contract_plain(F, rows_f, y_table, r), E.dtype)
    s = (widen(E).reshape(r, te, n) * t1[:, None, :]).sum(dim=0)
    return apply_block_T(minv, reduce_T(plan, s, None, minv.shape[1]), te).T


def sy_fold_plain(meta, F_twin, E_twin, prow, layout_f, y_table, t2, dsq=None):
    """Pass (b)'s plain version: per slot diff = F y_c − E t2[prow] (t2 = 0
    where the point row is outside t2), Fᵀ diff reduced by camera, then the
    dump column zeroed and + dsq·y."""
    r, te, tf = meta["r"], meta["te"], meta["tf"]
    n_pad = F_twin.shape[1]
    dt = F_twin.dtype
    f3 = widen(F_twin).reshape(r, tf, n_pad)
    t1 = leaf_operand((f3 * leaf_operand(y_table, dt)[:, layout_f.slot_row][None]).sum(dim=1), dt)
    live = (prow >= 0) & (prow < t2.shape[0])
    tt = leaf_operand(t2[torch.where(live, prow, torch.zeros_like(prow)), :te].T, dt)
    tt = torch.where(live[None, :], tt, torch.zeros_like(tt))
    diff = leaf_operand(t1 - (widen(E_twin).reshape(r, te, n_pad) * tt[None]).sum(dim=1), dt)
    out = f3.new_zeros((tf, len(layout_f.offsets) - 1))
    out.index_add_(1, layout_f.slot_row, (f3 * diff[:, None, :]).sum(dim=0))
    return _finish_plain(out, y_table, dsq)


def sy_point_pass(meta, F, E, rows_f, y_table, minv, segs):
    """Pass (a) of `sy_apply`: t2 point-major [cnt_e, ld], ld = te rounded
    up to 4 (the record past te is 0). F [r*tf, n] and E [r*te, n] are the
    lane-order leaves, minv the [te², cnt_e] inverse table, `segs` =
    sy_tables(meta, F.device); y, minv and t2 in
    cuda_lib.vector_dtype(F.dtype)."""
    if F.device.type == "cpu":
        return sy_point_plain(meta, F, E, rows_f, y_table, minv)
    r, te, tf = meta["r"], meta["te"], meta["tf"]
    dev, lt = F.device, F.dtype
    dt = cuda_lib.vector_dtype(lt)
    n = F.shape[1]
    ncols_f = y_table.shape[1]
    cnt_e = minv.shape[1]
    seg_t, pt_start = segs
    nb = len(meta["buckets"])
    cuda_lib.require("segs", seg_t, torch.int32, (nb * 4,), dev)
    cuda_lib.require("pt_start", pt_start, torch.int32, (nb + 1,), dev)
    cuda_lib.require("F", F, lt, (r * tf, n), dev)
    cuda_lib.require("E", E, lt, (r * te, n), dev)
    cuda_lib.require("rows_f", rows_f, torch.int32, (n,), dev)
    cuda_lib.require("y_table", y_table, dt, (tf, ncols_f), dev)
    cuda_lib.require("minv", minv, dt, (te * te, cnt_e), dev)
    ld = -(-te // 4) * 4
    t2 = torch.empty((cnt_e, ld), dtype=dt, device=dev)
    rc = _sy_fn(meta, "ctt_schur_sy_point", lt)(
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
    column 0. y, t2, dsq and the output in cuda_lib.vector_dtype(F_twin.dtype)."""
    if F_twin.device.type == "cpu":
        return sy_fold_plain(meta, F_twin, E_twin, prow, layout_f, y_table, t2, dsq)
    r, te, tf = meta["r"], meta["te"], meta["tf"]
    dev, lt = F_twin.device, F_twin.dtype
    dt = cuda_lib.vector_dtype(lt)
    n_pad = F_twin.shape[1]
    ncols_f = y_table.shape[1]
    cuda_lib.require("F_twin", F_twin, lt, (r * tf, n_pad), dev)
    cuda_lib.require("E_twin", E_twin, lt, (r * te, n_pad), dev)
    cuda_lib.require("prow", prow, torch.int32, (n_pad,), dev)
    cuda_lib.require("chunk_start", layout_f.chunk_start, torch.int32, None, dev)
    cuda_lib.require("row_chunks", layout_f.row_chunks, torch.int32, (ncols_f + 1,), dev)
    cuda_lib.require("slot_row", layout_f.slot_row, torch.int32, (n_pad,), dev)
    cuda_lib.require("y_table", y_table, dt, (tf, ncols_f), dev)
    cuda_lib.require("t2", t2, dt, (t2.shape[0], t2.shape[1]), dev)
    if dsq is not None:
        cuda_lib.require("dsq", dsq, dt, (tf, ncols_f), dev)
    nchunks = layout_f.live_chunks
    partial = torch.empty((tf, nchunks * chunk_pieces(lt)), dtype=dt, device=dev)
    out = torch.empty((tf, ncols_f), dtype=dt, device=dev)
    rc = _sy_fn(meta, "ctt_schur_sy_fold", lt)(
        cuda_lib.ptr(F_twin), cuda_lib.ptr(E_twin), cuda_lib.ptr(prow),
        cuda_lib.ptr(layout_f.chunk_start), cuda_lib.ptr(layout_f.row_chunks),
        cuda_lib.ptr(layout_f.slot_row), cuda_lib.ptr(y_table), cuda_lib.ptr(dsq), ncols_f,
        cuda_lib.ptr(t2), t2.shape[1], t2.shape[0], n_pad, r, te, tf, nchunks,
        cuda_lib.ptr(partial), cuda_lib.ptr(out), cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "schur_sy fold pass")
    cuda_lib.count(cuda_lib.counter("schur_sy", lt))  # one per S·y: the fold pass ends it
    return out


def sy_apply(meta, F, E, rows_f, F_twin, E_twin, prow, layout_f, y_table, minv, segs, dsq=None):
    """Fᵀ(I − E (EᵀE + D_e²)⁻¹ Eᵀ) F y (+ dsq·y) for a camera table y_table
    [tf, ncols_f] (last column = dump) -> [tf, ncols_f], dump column 0.
    F [r*tf, n] and E [r*te, n] are the scale-materialized leaves, F_twin and
    E_twin their copies in the slot order of layout_f, prow the point row of
    each slot (program.slot_rows), minv the [te², cnt_e] inverse table,
    dsq the LM diagonal D_f² as a [tf, ncols_f] table or None.
    `segs` = sy_tables(meta, F.device). Leaves and twins are float32,
    float64 or bfloat16; y, minv, dsq and the output are in
    cuda_lib.vector_dtype of them. Two launches; the fold pass counts them
    as one S·y."""
    if F.device.type == "cpu":
        return sy_apply_plain(meta, F, E, rows_f, F_twin, layout_f, y_table, minv, dsq)
    t2 = sy_point_pass(meta, F, E, rows_f, y_table, minv, segs)
    return sy_fold_pass(meta, F_twin, E_twin, prow, layout_f, y_table, t2, dsq)


def sy_tables(meta, device):
    """The bucket table [nb*4] (lane_start, n_seg, d, out_row) and the point
    offsets [nb+1] as int32 tensors on `device`."""
    return (
        upload(meta["segs"], device=device),
        upload(meta["pt_start"], device=device),
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
