"""BlockJacobian: the matrix-free Jacobian operator, observation-minor.

Port of `ceres_tpu.jacobian`. The Jacobian is never assembled: one leaf
[r*t, n] per (signature group, position), and every product is a per-lane
contraction plus a gather or a reduction whose form the position's plan
picks:

- "bucket" (the owner class, BA points): gathers are slice+broadcast and
  reductions reshape+sum over the interleaved bucket lanes;
- "onehot" (small classes, BA cameras): an indexed gather (kernel B2,
  gather_reduce.py, on a card) of the lane-order leaf, and the deterministic
  reduce (kernel B3) of a twin;
- no plan: index_select / index_add_.

The twin of a lane-order array is its copy in the slot order of the padded
camera CSR (program.camera_layout): each camera's observations contiguous,
each run padded with zero columns to a multiple of 32 slots, so the
reducing kernels B3 and B5 read whole cache lines. This module is where
that order is decided. `reduce_T` takes lane-order input on every plan and
makes the twin of what it reduces; a BlockJacobian makes the twins of its
onehot leaves with the leaves (`build`; `materialize_scale` scales the raw
twin slot by slot) and shares them with every view of the same leaves, and
its reductions of a leaf work on the leaf's twin. Each onehot leaf then
exists twice, in lane order (read by B2 and B4) and as its twin: at
BAL-1778 in float32 ~0.36 GB more per camera leaf.

Leaves may be bfloat16 (`astype`, the mixed-precision solves' matvec
copy): the products then round their vector operand to bfloat16, form each
product exactly in float32 and accumulate and return float32 (`_acc_dtype`,
as ceres_tpu/jacobian.py:430-434), through the `_bf16` kernels B2 and B3 on
the onehot plan. On a card the copy of every leaf and twin is one launch
(`bf16_copies`).

The one-hot MXU machinery of the JAX package (ceres_tpu/jacobian.py:71-143)
exists only to serve a TPU and has no counterpart here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib
from .gather_reduce import (
    contract_reduce,
    contract_reduce_batched,
    gather_contract,
    gather_contract_batched,
    leaf_operand,
)
from .linalg.preconditioners import diag_rows


def _clip_rows(rows, nrows):
    # dump/pad rows may index one past the table; clip like jnp.take(clip)
    return rows.clamp(max=nrows - 1)


def group_plans(meta, garr):
    """The plans of a group's positions: a rank's own on a shard
    (parallel.sharding.shard_plans, garr["plans"]), else the Program's."""
    plans = garr.get("plans")
    return plans if plans is not None else (meta.red_plans or {})


def _windows_T(plan, table_t):
    """The [s, n] slice+broadcast of a bucket plan over a transposed class
    table [s, cnt(+1)]. A "bucket" is (lane_start, n_seg, d, out_row); a
    "bucket_sharded" one (local_start, per_e, d, out_row, live), the shard's
    window of per_e entities of which the first `live` are real: the rest
    read 0 (pad lanes, whose Jacobian columns are 0)."""
    s = table_t.shape[0]
    parts = []
    for b in plan[1]:
        width, d, out_row = b[1], b[2], b[3]
        live = b[4] if plan[0] == "bucket_sharded" else width
        seg = table_t[:, out_row : out_row + live]
        if live < width:
            seg = torch.cat([seg, seg.new_zeros((s, width - live))], dim=1)
        parts.append(seg[:, None, :].expand(s, d, width).reshape(s, d * width))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _is_bucket(plan):
    return plan is not None and plan[0] in ("bucket", "bucket_sharded")


def gather_T(plan, table, rows):
    """Gather class-table rows into transposed form [s, n].

    table: [cnt(+dump), s] row-major class table; rows: [n] class rows."""
    if _is_bucket(plan):
        return _windows_T(plan, table.T)
    return table[_clip_rows(rows, table.shape[0])].T


def gather_T_t(plan, table_t, rows):
    """gather_T for a TRANSPOSED class table [s, cnt+1] -> [s, n]."""
    if _is_bucket(plan):
        return _windows_T(plan, table_t)
    return table_t[:, _clip_rows(rows, table_t.shape[1])]


def make_twin(leaf, layout):
    """The twin of a lane-order array [k, n]: its copy [k, n_pad] in the
    slot order of a program.CameraLayout, zero on the padding slots."""
    twin = leaf.index_select(1, layout.perm.clamp(min=0))
    return twin.index_fill_(1, layout.pad.long(), 0)


def scale_twin(twin, layout, table, r):
    """The twin of leaf·scale from the leaf's twin [r*t, n_pad], for a scale
    table [cnt+1, t] gathered by class row: the products materialize_scale
    forms in lane order, one slot at a time (bitwise the same)."""
    t = table.shape[1]
    sg = table.T.contiguous().index_select(1, layout.slot_row)  # [t, n_pad], coalesced
    return (twin.reshape(r, t, -1) * sg[None]).reshape(r * t, -1)


def reduce_T(plan, contrib, rows, num_out, csr=None):
    """Segment-reduce lane-order contributions [k, n] -> [k, num_out];
    num_out includes the dump column. The bucket plans reduce by
    reshape+sum (a shard's window writes its live entities' columns only:
    the rest are pad lanes); the onehot plan reduces the contributions'
    twin in the slot order of its layout `csr` (kernel B3 on a card)."""
    k = contrib.shape[0]
    if _is_bucket(plan):
        out = contrib.new_zeros((k, num_out))
        for b in plan[1]:
            lane_start, width, d, out_row = b[:4]
            live = b[4] if plan[0] == "bucket_sharded" else width
            seg = contrib[:, lane_start : lane_start + width * d]
            if d > 1:
                seg = seg.reshape(k, d, width).sum(dim=1)
            out[:, out_row : out_row + live] = seg[:, :live]
        return out
    if plan is not None and plan[0] == "onehot":
        return contract_reduce(make_twin(contrib, csr), csr, None, 1)
    return contrib.new_zeros((k, num_out)).index_add_(1, rows, contrib)


def _gather_rows(plan, table, rows):
    """Rows of a class table [cnt(+1), ...] per lane -> [n, ...]: the
    batched products' gather (lane axis first, each row whole). Bucket
    plans slice and broadcast their windows (pad lanes of a shard's window
    read 0); else index_select."""
    if not _is_bucket(plan):
        return table.index_select(0, _clip_rows(rows, table.shape[0]))
    parts = []
    for b in plan[1]:
        width, d, out_row = b[1], b[2], b[3]
        live = b[4] if plan[0] == "bucket_sharded" else width
        seg = table[out_row : out_row + live]
        if live < width:
            seg = torch.cat([seg, seg.new_zeros((width - live,) + seg.shape[1:])])
        parts.append(seg[None].expand((d,) + seg.shape).reshape((d * width,) + seg.shape[1:]))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _reduce_rows(plan, contrib, rows, num_out):
    """Segment-reduce lane-first contributions [n, ...] -> [num_out, ...]
    (the dump row included): reduce_T with the lane axis first. Bucket
    plans reshape+sum over their windows; no plan index_add_."""
    if not _is_bucket(plan):
        return contrib.new_zeros((num_out,) + contrib.shape[1:]).index_add_(0, rows, contrib)
    out = contrib.new_zeros((num_out,) + contrib.shape[1:])
    for b in plan[1]:
        lane_start, width, d, out_row = b[:4]
        live = b[4] if plan[0] == "bucket_sharded" else width
        seg = contrib[lane_start : lane_start + width * d]
        if d > 1:
            seg = seg.reshape((d, width) + seg.shape[1:]).sum(dim=0)
        out[out_row : out_row + live] = seg[:live]
    return out


def bf16_copies(tensors):
    """`[t.to(torch.bfloat16) for t in tensors]`. On a card, float32 or
    float64 tensors (one dtype, each contiguous) are rounded by
    `leaf_to_bf16` (csrc/leaf_to_bf16.cu: one launch for up to 32 tensors,
    counted per launch; bitwise Tensor.to on finite values), into outputs allocated as Tensor.to allocates them: one each,
    of its source's shape, in the list's order, from the current pool.
    Elsewhere, and for bfloat16 sources, Tensor.to itself."""
    tensors = list(tensors)
    if not tensors or tensors[0].device.type != "cuda" or tensors[0].dtype == torch.bfloat16:
        return [t.to(torch.bfloat16) for t in tensors]
    dtype, device = tensors[0].dtype, tensors[0].device
    for i, t in enumerate(tensors):
        cuda_lib.require(f"tensors[{i}]", t, dtype, device=device)
    out = [torch.empty_like(t, dtype=torch.bfloat16) for t in tensors]
    fn = cuda_lib.kernel_fn("ctt_leaf_to_bf16", dtype)
    k = len(tensors)
    launches = ctypes.c_int(0)
    rc = fn(
        ctypes.cast((ctypes.c_void_p * k)(*[t.data_ptr() for t in tensors]), ctypes.c_void_p),
        ctypes.cast((ctypes.c_void_p * k)(*[t.data_ptr() for t in out]), ctypes.c_void_p),
        ctypes.cast((ctypes.c_longlong * k)(*[t.numel() for t in tensors]), ctypes.c_void_p),
        k, ctypes.c_void_p(ctypes.addressof(launches)), cuda_lib.stream(device),
    )
    cuda_lib.check(rc, "leaf_to_bf16")
    cuda_lib.count("leaf_to_bf16", launches.value)
    return out


class BlockJacobian:
    """Per-(group, position) Jacobian blocks stored as [r*t, n] tensors.

    On a rank's shard (parallel.sharding: the group arrays carry the
    `mesh`) the leaves hold the rank's lanes and every reduction over
    lanes (Jᵀu, the column norms, the Gram blocks) is all-reduced over the
    mesh, as the JAX package psums them under shard_map; products into
    residual space stay the rank's own."""

    def __init__(self, program, jac_groups, garrs, positions=None, col_scale=None, twins=None):
        self.program = program
        self.jac_groups = jac_groups  # tuple over groups of tuple over view positions
        self.garrs = garrs  # per-group arrays (t_rows, csr; on a shard mask, plans, mesh)
        self.mesh = garrs[0].get("mesh") if garrs else None
        if positions is None:
            positions = tuple(tuple(range(len(jacs))) for jacs in jac_groups)
        self.positions = positions
        # lazy Jacobi column scaling J diag(col_scale); products apply it at
        # the tangent-vector boundary (see ceres_tpu/jacobian.py)
        self.col_scale = col_scale
        # camera-ordered copies of the leaves, keyed by (group, position,
        # order position): they belong to these leaves, and every view of
        # the same leaves shares them
        self.twins = {} if twins is None else twins
        self.t_rows = tuple(
            tuple(g["t_rows"][p] for p in pos) for g, pos in zip(garrs, positions)
        )

    @classmethod
    def build(cls, program, arrays, jac_groups):
        """The Jacobian of one evaluation, with the twins of its onehot
        leaves."""
        jac = cls(program, tuple(jac_groups), arrays["groups"])
        for gi in range(len(jac.jac_groups)):
            for pos, pm, _jac, _tr, csr in jac._iter(gi):
                if csr is not None and pm.t_cls >= 0:
                    jac.twin(gi, pos)
        return jac

    def _with(self, jac_groups=None, positions=None, col_scale="keep", twins=None):
        """A view; new leaves (jac_groups) start without twins unless given."""
        if twins is None and jac_groups is None:
            twins = self.twins
        return BlockJacobian(
            self.program,
            self.jac_groups if jac_groups is None else jac_groups,
            self.garrs,
            self.positions if positions is None else positions,
            self.col_scale if col_scale == "keep" else col_scale,
            twins,
        )

    def leaf(self, gi, pos):
        return self.jac_groups[gi][self.positions[gi].index(pos)]

    def twin(self, gi, pos, order_pos=None):
        """The twin of the leaf at `pos` in the slot order of the onehot
        position `order_pos` (default: its own); made once per leaf."""
        order_pos = pos if order_pos is None else order_pos
        key = (gi, pos, order_pos)
        if key not in self.twins:
            self.twins[key] = make_twin(self.leaf(gi, pos), self.garrs[gi]["csr"][order_pos])
        return self.twins[key]

    def _reduce_leaf(self, gi, pos, lanewise, num_out):
        """reduce_T of lanewise(leaf) [k, n], for a function that treats
        each lane alone: on the onehot plan it runs on the leaf's twin,
        whose result is already in slot order."""
        plan, csr = self.plan(gi, pos), self.garrs[gi]["csr"].get(pos)
        if plan is not None and plan[0] == "onehot":
            return contract_reduce(lanewise(self.twin(gi, pos)).contiguous(), csr, None, 1)
        return reduce_T(plan, lanewise(self.leaf(gi, pos)), self.garrs[gi]["t_rows"][pos], num_out)

    def position_view(self, keep_positions):
        """Restrict to a subset of positions per group — the E or F half of
        the Schur partition."""
        jac_groups, positions = [], []
        for gi, keep in enumerate(keep_positions):
            orig = self.positions[gi]
            jac_groups.append(tuple(self.jac_groups[gi][orig.index(p)] for p in keep))
            positions.append(tuple(keep))
        return self._with(tuple(jac_groups), tuple(positions), twins=self.twins)

    @property
    def num_cols(self) -> int:
        return self.program.num_effective_parameters

    @property
    def num_rows(self) -> int:
        return self.program.num_residuals

    def _dtype(self):
        for jacs in self.jac_groups:
            for j in jacs:
                return j.dtype
        return torch.float64

    def _acc_dtype(self):
        """The products' dtype: bfloat16 leaves accumulate in float32."""
        dt = self._dtype()
        return torch.float32 if dt == torch.bfloat16 else dt

    def astype(self, dtype):
        """The same operator with its leaves, and the twins they already
        have, cast to `dtype` (the mixed-precision solves' bfloat16 copy
        for the PCG matvec, `bf16_copies`: one launch on a card;
        ceres_tpu/jacobian.py:436-458); the lazy column scale stays."""
        if dtype == self._dtype():
            return self
        leaves = [j for jacs in self.jac_groups for j in jacs]
        twins = list(self.twins.values())
        if dtype == torch.bfloat16:
            copies = bf16_copies(leaves + twins)
        else:
            copies = [t.to(dtype) for t in leaves + twins]
        it = iter(copies)
        return BlockJacobian(
            self.program,
            tuple(tuple(next(it) for _ in jacs) for jacs in self.jac_groups),
            self.garrs,
            self.positions,
            self.col_scale,
            {k: next(it) for k in self.twins},
        )

    def _device(self):
        for jacs in self.jac_groups:
            for j in jacs:
                return j.device
        return self.program.device

    def _iter(self, gi):
        """Yields (pos, pos_meta, jac [r*t, n], t_rows [n], layout|None)."""
        meta = self.program.groups[gi]
        garr = self.garrs[gi]
        for vpos, jac in enumerate(self.jac_groups[gi]):
            pos = self.positions[gi][vpos]
            yield pos, meta.positions[pos], jac, garr["t_rows"][pos], garr["csr"].get(pos)

    def plan(self, gi, pos):
        return group_plans(self.program.groups[gi], self.garrs[gi]).get(pos)

    def lanes(self, gi) -> int:
        """Lanes of group gi (the rank's, padded, on a shard)."""
        return self.garrs[gi]["a_rows"][0].shape[0]

    def psum(self, x):
        """x summed over the mesh's ranks (x itself without a mesh)."""
        return x if self.mesh is None else self.mesh.psum(x)

    def psum_tables(self, tables):
        """A list of per-class tables summed over the mesh in one
        all-reduce (the list itself without a mesh)."""
        return tables if self.mesh is None else self.mesh.psum_tables(tables)

    def _v_tables(self, v):
        from .evaluator import tangent_tables

        return tangent_tables(self.program, v, pad_zero_row=True)

    def _class_tables_T(self):
        """Zero per-class accumulators [s, cnt+1] (dump column last)."""
        return self.tvec_zeros()

    def _flatten_classes_T(self, tables):
        """[s, cnt+1] per class -> flat tangent vector (dump column dropped)."""
        parts = [
            t[:, :cnt].T.reshape(-1)
            for t, cnt in zip(tables, self.program.tangent_class_counts)
        ]
        if not parts:
            return torch.zeros(0, dtype=self._acc_dtype(), device=self._device())
        return torch.cat(parts)

    # -- table-vector ("tvec") form: per-class [s, cnt+1] tables -------- #

    def tvec(self, v):
        """flat [num_eff] -> list of per-class [s, cnt+1] tables."""
        p = self.program
        out = []
        for cls in range(len(p.tangent_class_sizes)):
            base, cnt, s = p.tangent_class_slice(cls)
            t = v[base : base + cnt * s].reshape(cnt, s).T
            out.append(torch.cat([t, v.new_zeros((s, 1))], dim=1))
        return out

    def tvec_flat(self, tv):
        return self._flatten_classes_T(tv)

    def tvec_zeros(self, dtype=None):
        p = self.program
        return [
            torch.zeros((s, cnt + 1), dtype=dtype or self._acc_dtype(), device=self._device())
            for cnt, s in zip(p.tangent_class_counts, p.tangent_class_sizes)
        ]

    def _zero_pad_cols(self, tv):
        """Zero the dump column (constant-block sums must not feed back)."""
        out = []
        for cls, t in enumerate(tv):
            cnt = self.program.tangent_class_counts[cls]
            t = t.clone()
            t[:, cnt:] = 0
            out.append(t)
        return out

    def right_multiply_t(self, tv):
        """J v for a tvec v -> per-group residuals [r, n] (col_scale must be
        folded into the leaves first: materialize_scale)."""
        assert self.col_scale is None, "tvec products require materialize_scale() first"
        acc_dt = self._acc_dtype()
        out = []
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            r = meta.num_residuals
            acc = None
            for pos, pm, jac, tr, _csr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                plan = self.plan(gi, pos)
                if plan is not None and plan[0] == "onehot":
                    part = gather_contract(jac, tr, tv[pm.t_cls].to(acc_dt).contiguous(), r)
                else:
                    vg = leaf_operand(gather_T_t(plan, tv[pm.t_cls], tr), jac.dtype)
                    part = (jac.reshape(r, t, -1) * vg[None]).sum(dim=1)
                acc = part if acc is None else acc + part
            if acc is None:
                acc = torch.zeros((r, self.lanes(gi)), dtype=acc_dt, device=self._device())
            out.append(acc)
        return out

    def _left(self, u_groups):
        acc = self._class_tables_T()
        acc_dt = self._acc_dtype()
        for gi in range(len(self.jac_groups)):
            r = self.program.groups[gi].num_residuals
            u = u_groups[gi].to(acc_dt)
            for pos, pm, jac, tr, csr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                plan = self.plan(gi, pos)
                width = acc[pm.t_cls].shape[1]
                if plan is not None and plan[0] == "onehot":
                    part = contract_reduce(self.twin(gi, pos), csr, u.contiguous(), r)
                else:
                    ul = leaf_operand(u, jac.dtype)
                    contrib = (jac.reshape(r, t, -1) * ul[:, None, :]).sum(dim=0)
                    part = reduce_T(plan, contrib, tr, width, csr)
                acc[pm.t_cls] = acc[pm.t_cls] + part
        return self.psum_tables(acc)

    def left_multiply_t(self, u_groups):
        """Jᵀu -> tvec (dump column zeroed)."""
        assert self.col_scale is None, "tvec products require materialize_scale() first"
        return self._zero_pad_cols(self._left(u_groups))

    def right_multiply(self, v):
        """J v: tangent vector [num_cols] -> per-group residuals [r, n]
        (reference: BlockSparseMatrix::RightMultiplyAndAccumulate)."""
        if self.col_scale is not None:
            v = v * self.col_scale
        tv = [t.T.contiguous() for t in self._v_tables(v)]
        return self._with(col_scale=None).right_multiply_t(tv)

    def left_multiply(self, u_groups):
        """Jᵀu for per-group residuals u [r, n] -> [num_cols] (reference:
        BlockSparseMatrix::LeftMultiplyAndAccumulate; deterministic)."""
        out = self._flatten_classes_T(self._left(u_groups))
        if self.col_scale is not None:
            out = out * self.col_scale
        return out

    def jtj_multiply(self, v, dsq=None):
        """(JᵀJ + diag(dsq)) v, the CGNR normal-equations operator
        (reference: CgnrSolver's operator, cgnr_solver.cc:219-242;
        ceres_tpu/jacobian.py:750)."""
        out = self.left_multiply(self.right_multiply(v))
        if dsq is not None:
            out = out + dsq * v
        return out

    # -- over a batch of columns: the covariance's batched PCG ---------- #
    # The JAX package runs jtj_multiply under jax.vmap over the requested
    # columns (ceres_tpu/covariance.py:212). Here the column axis is written
    # out as a leading dimension k and kept innermost in memory
    # (gather_reduce.lanes_major): class tables are logical [k, s, cnt+1]
    # over [cnt+1, s, k], residual-space vectors logical [k, r, n] over
    # [n, r, k]. The onehot positions run the batched kernels B2/B3 on their
    # twins; the bucket and no-plan positions gather, multiply and reduce
    # whole [t, k] rows in plain torch (XLA's part in JAX), so no pass of a
    # product transposes a residual-space array.

    def tvec_batched(self, v):
        """[k, num_eff] -> per class lane-major [k, s, cnt+1] tables (dump
        column zero), made in one copy each."""
        p, k = self.program, v.shape[0]
        out = []
        for cls in range(len(p.tangent_class_sizes)):
            base, cnt, s = p.tangent_class_slice(cls)
            t = v[:, base : base + cnt * s].reshape(k, cnt, s).permute(1, 2, 0)
            out.append(torch.cat([t, v.new_zeros((1, s, k))], dim=0).permute(2, 1, 0))
        return out

    def tvec_flat_batched(self, tv):
        """Per class [k, s, cnt+1] tables -> [k, num_eff] (dump columns
        dropped), in one copy."""
        parts = [
            t.permute(2, 1, 0)[:cnt].reshape(cnt * t.shape[1], t.shape[0]).T
            for t, cnt in zip(tv, self.program.tangent_class_counts)
        ]
        return torch.cat(parts, dim=1)

    def right_multiply_batched(self, v):
        """J V for k tangent vectors V [k, num_cols] -> per-group lane-major
        [k, r, n]."""
        if self.col_scale is not None:
            v = v * self.col_scale
        acc_dt = self._acc_dtype()
        tv = self.tvec_batched(v.to(acc_dt))
        k = v.shape[0]
        out = []
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            r = meta.num_residuals
            acc = None
            for pos, pm, jac, tr, csr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                plan = self.plan(gi, pos)
                tab = tv[pm.t_cls]
                if plan is not None and plan[0] == "onehot":
                    part = gather_contract_batched(jac, tr, tab, r, self.twin(gi, pos), csr)
                else:
                    # [n, t, k] rows of the class table, times the lane's [r, t] leaf
                    vg = leaf_operand(_gather_rows(plan, tab.permute(2, 1, 0), tr), jac.dtype)
                    jl = jac.reshape(r, t, -1).permute(2, 0, 1)
                    part = (jl[:, :, :, None] * vg[:, None]).sum(dim=2).contiguous()
                    part = part.permute(2, 1, 0)
                acc = part if acc is None else acc + part
            if acc is None:
                acc = torch.zeros((meta.n, r, k), dtype=acc_dt,
                                  device=self._device()).permute(2, 1, 0)
            out.append(acc)
        return out

    def left_multiply_batched(self, u_groups):
        """Jᵀu for k per-group lane-major residuals u [k, r, n] -> [k, num_cols]."""
        acc_dt = self._acc_dtype()
        k = u_groups[0].shape[0] if u_groups else 0
        acc = [torch.zeros((cnt + 1, s, k), dtype=acc_dt, device=self._device()).permute(2, 1, 0)
               for cnt, s in zip(self.program.tangent_class_counts,
                                 self.program.tangent_class_sizes)]
        for gi in range(len(self.jac_groups)):
            r = self.program.groups[gi].num_residuals
            u = u_groups[gi].to(acc_dt)
            for pos, pm, jac, tr, csr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                plan = self.plan(gi, pos)
                width = acc[pm.t_cls].shape[2]
                if plan is not None and plan[0] == "onehot":
                    part = contract_reduce_batched(self.twin(gi, pos), csr, u, r)
                else:
                    # the lane's [t, r] leaf times its [r, k] row of u, reduced by class row
                    ul = leaf_operand(u, jac.dtype).permute(2, 1, 0)
                    jl = jac.reshape(r, t, -1).permute(2, 0, 1)
                    contrib = (jl[:, :, :, None] * ul[:, :, None]).sum(dim=1).contiguous()
                    part = _reduce_rows(plan, contrib, tr, width).permute(2, 1, 0)
                acc[pm.t_cls] = acc[pm.t_cls] + part
        out = self.tvec_flat_batched(acc)
        if self.col_scale is not None:
            out = out * self.col_scale
        return out

    def jtj_multiply_batched(self, v, dsq=None):
        """(JᵀJ + diag(dsq)) V for k tangent vectors V [k, num_cols]: each
        row is jtj_multiply of that row (the vmapped operator of the JAX
        package's covariance)."""
        out = self.left_multiply_batched(self.right_multiply_batched(v))
        if dsq is not None:
            out = out + dsq * v
        return out

    def squared_column_norms(self):
        """Per-tangent-column sum of squares (LM diagonal / Jacobi scaling)."""
        acc = self._class_tables_T()
        for gi in range(len(self.jac_groups)):
            r = self.program.groups[gi].num_residuals
            for pos, pm, _jac, _tr, _csr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size

                def sq(j):
                    j3 = j.reshape(r, t, -1)
                    return (j3 * j3).sum(dim=0)

                acc[pm.t_cls] = acc[pm.t_cls] + self._reduce_leaf(
                    gi, pos, sq, acc[pm.t_cls].shape[1]
                )
        out = self._flatten_classes_T(self.psum_tables(acc))
        if self.col_scale is not None:
            out = out * self.col_scale * self.col_scale
        return out

    def scale_columns(self, scale):
        """Lazy column-scaled view J diag(scale) (composes multiplicatively)."""
        return self._with(
            col_scale=scale if self.col_scale is None else self.col_scale * scale
        )

    def materialize_scale(self):
        """Fold `col_scale` into new [r*t, n] leaves, with the twins of the
        new onehot leaves."""
        if self.col_scale is None:
            return self
        st = self._v_tables(self.col_scale)
        new_groups, twins = [], {}
        for gi in range(len(self.jac_groups)):
            r = self.program.groups[gi].num_residuals
            jacs = []
            for pos, pm, jac, tr, csr in self._iter(gi):
                if pm.t_cls < 0:
                    jacs.append(jac)
                    continue
                t = pm.tangent_size
                plan = self.plan(gi, pos)
                sg = gather_T(plan, st[pm.t_cls], tr)
                jacs.append((jac.reshape(r, t, -1) * sg[None]).reshape(r * t, -1))
                if plan is not None and plan[0] == "onehot":
                    twins[(gi, pos, pos)] = scale_twin(self.twin(gi, pos), csr, st[pm.t_cls], r)
            new_groups.append(tuple(jacs))
        return self._with(tuple(new_groups), col_scale=None, twins=twins)

    def block_diag_jtj(self, dsq=None, class_ids=None):
        """Per-block diagonal blocks of JᵀJ (+ diag(dsq)) as a list over
        tangent classes of TRANSPOSED [s*s, count] tables (block (i, j) of
        class row c at [i*s+j, c]). reference: block_jacobi_preconditioner.cc."""
        from .evaluator import tangent_tables

        p = self.program
        per_class = [
            torch.zeros((s * s, cnt + 1), dtype=self._dtype(), device=self._device())
            for cnt, s in zip(p.tangent_class_counts, p.tangent_class_sizes)
        ]
        for gi in range(len(self.jac_groups)):
            r = p.groups[gi].num_residuals
            for pos, pm, _jac, _tr, _csr in self._iter(gi):
                if pm.t_cls < 0 or (class_ids is not None and pm.t_cls not in class_ids):
                    continue
                t = pm.tangent_size

                def outer(j):
                    j3 = j.reshape(r, t, -1)
                    return (j3[:, :, None, :] * j3[:, None, :, :]).sum(dim=0).reshape(t * t, -1)

                per_class[pm.t_cls] = per_class[pm.t_cls] + self._reduce_leaf(
                    gi, pos, outer, per_class[pm.t_cls].shape[1]
                )
        per_class = self.psum_tables(per_class)
        dt = tangent_tables(p, dsq) if dsq is not None else None
        sc = tangent_tables(p, self.col_scale) if self.col_scale is not None else None
        out = []
        for cls, acc in enumerate(per_class):
            s = p.tangent_class_sizes[cls]
            cnt = p.tangent_class_counts[cls]
            acc = acc[:, :cnt]
            if sc is not None:
                scl = sc[cls].T  # [s, cnt]
                acc = acc * (scl[:, None, :] * scl[None, :, :]).reshape(s * s, cnt)
            if dt is not None:
                acc = acc.index_add(0, diag_rows(s, acc.device), dt[cls].T)
            out.append(acc)
        return out

    def _whole(self, what):
        if self.mesh is not None:
            raise ValueError(f"{what} needs the whole Jacobian; a rank holds only its lanes")

    def to_dense(self):
        """Dense [num_rows, num_cols] Jacobian (small problems / tests)."""
        self._whole("to_dense")
        dev, dtype = self._device(), self._dtype()
        a = torch.zeros(
            (self.num_rows, self.num_cols + max(self.program.tangent_class_sizes or [1])),
            dtype=dtype, device=dev,
        )
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n, r = meta.n, meta.num_residuals
            rows = meta.row_offset + torch.arange(n * r, device=dev).reshape(n, r, 1)
            for pos, pm, jac, tr, _csr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                cnt = self.program.tangent_class_counts[pm.t_cls]
                base = int(self.program.tangent_class_bases[pm.t_cls])
                t = pm.tangent_size
                jl = jac.reshape(r, t, n).permute(2, 0, 1)
                col0 = torch.where(tr < cnt, base + tr.long() * t, self.num_cols)
                cols = col0[:, None, None] + torch.arange(t, device=dev)[None, None, :]
                cols = cols.expand(jl.shape)
                a.index_put_((rows.expand(jl.shape), cols), jl, accumulate=True)
        a = a[:, : self.num_cols]
        if self.col_scale is not None:
            a = a * self.col_scale[None, :]
        return a

    def to_crs(self):
        """Host CRS triple (values, col_indices int32, row_pointers int32)
        over the free tangent columns, each row's entries by column
        (reference: CompressedRowSparseMatrix; ceres_tpu/jacobian.py:929)."""
        self._whole("to_crs")
        rows_list, cols_list, vals_list = [], [], []
        for gi in range(len(self.jac_groups)):
            meta = self.program.groups[gi]
            n, r = meta.n, meta.num_residuals
            base_rows = meta.row_offset + np.arange(n * r).reshape(n, r, 1)
            for pos, pm, jac, tr, _csr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                jl = jac.detach().cpu().numpy().reshape(r, t, n).transpose(2, 0, 1)
                trl = tr.detach().cpu().numpy()
                cnt = self.program.tangent_class_counts[pm.t_cls]
                base = int(self.program.tangent_class_bases[pm.t_cls])
                cols = base + trl[:, None, None].astype(np.int64) * t + np.arange(t)[None, None, :]
                keep = np.broadcast_to((trl < cnt)[:, None, None], (n, r, t)).reshape(-1)
                rows_list.append(np.broadcast_to(base_rows, (n, r, t)).reshape(-1)[keep])
                cols_list.append(np.broadcast_to(cols, (n, r, t)).reshape(-1)[keep])
                vals_list.append(jl.reshape(-1)[keep])
        if not rows_list:
            return (
                np.zeros(0), np.zeros(0, dtype=np.int32), np.zeros(self.num_rows + 1, dtype=np.int32)
            )
        rows = np.concatenate(rows_list)
        cols = np.concatenate(cols_list)
        vals = np.concatenate(vals_list)
        if self.col_scale is not None:
            vals = vals * self.col_scale.detach().cpu().numpy()[cols]
        perm = np.lexsort((cols, rows))
        row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=self.num_rows))])
        return vals[perm], cols[perm].astype(np.int32), row_ptr.astype(np.int32)
