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

The one-hot MXU machinery of the JAX package (ceres_tpu/jacobian.py:71-143)
exists only to serve a TPU and has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .gather_reduce import contract_reduce, gather_contract


def _clip_rows(rows, nrows):
    # dump/pad rows may index one past the table; clip like jnp.take(clip)
    return rows.clamp(max=nrows - 1)


def gather_T(plan, table, rows):
    """Gather class-table rows into transposed form [s, n].

    table: [cnt(+dump), s] row-major class table; rows: [n] class rows."""
    if plan is not None and plan[0] == "bucket":
        s = table.shape[1]
        parts = [
            table[out_row : out_row + n_seg].T[:, None, :].expand(s, d, n_seg).reshape(s, d * n_seg)
            for (_ls, n_seg, d, out_row) in plan[1]
        ]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return table[_clip_rows(rows, table.shape[0])].T


def gather_T_t(plan, table_t, rows):
    """gather_T for a TRANSPOSED class table [s, cnt+1] -> [s, n]."""
    if plan is not None and plan[0] == "bucket":
        s = table_t.shape[0]
        parts = [
            table_t[:, out_row : out_row + n_seg][:, None, :].expand(s, d, n_seg).reshape(s, d * n_seg)
            for (_ls, n_seg, d, out_row) in plan[1]
        ]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
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
    num_out includes the dump column. The bucket plan reduces by
    reshape+sum; the onehot plan reduces the contributions' twin in the
    slot order of its layout `csr` (kernel B3 on a card)."""
    k = contrib.shape[0]
    if plan is not None and plan[0] == "bucket":
        out = contrib.new_zeros((k, num_out))
        for (lane_start, n_seg, d, out_row) in plan[1]:
            seg = contrib[:, lane_start : lane_start + n_seg * d]
            if d > 1:
                seg = seg.reshape(k, d, n_seg).sum(dim=1)
            out[:, out_row : out_row + n_seg] = seg
        return out
    if plan is not None and plan[0] == "onehot":
        return contract_reduce(make_twin(contrib, csr), csr, None, 1)
    return contrib.new_zeros((k, num_out)).index_add_(1, rows, contrib)


class BlockJacobian:
    """Per-(group, position) Jacobian blocks stored as [r*t, n] tensors."""

    def __init__(self, program, jac_groups, garrs, positions=None, col_scale=None, twins=None):
        self.program = program
        self.jac_groups = jac_groups  # tuple over groups of tuple over view positions
        self.garrs = garrs  # per-group arrays (t_rows, csr)
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
        return (self.program.groups[gi].red_plans or {}).get(pos)

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
            return torch.zeros(0, dtype=self._dtype(), device=self._device())
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
            torch.zeros((s, cnt + 1), dtype=dtype or self._dtype(), device=self._device())
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
                    part = gather_contract(jac, tr, tv[pm.t_cls].contiguous(), r)
                else:
                    vg = gather_T_t(plan, tv[pm.t_cls], tr)
                    part = (jac.reshape(r, t, -1) * vg[None]).sum(dim=1)
                acc = part if acc is None else acc + part
            if acc is None:
                acc = torch.zeros((r, meta.n), dtype=self._dtype(), device=self._device())
            out.append(acc)
        return out

    def _left(self, u_groups):
        acc = self._class_tables_T()
        for gi in range(len(self.jac_groups)):
            r = self.program.groups[gi].num_residuals
            u = u_groups[gi]
            for pos, pm, jac, tr, csr in self._iter(gi):
                if pm.t_cls < 0:
                    continue
                t = pm.tangent_size
                plan = self.plan(gi, pos)
                width = acc[pm.t_cls].shape[1]
                if plan is not None and plan[0] == "onehot":
                    part = contract_reduce(self.twin(gi, pos), csr, u.contiguous(), r)
                else:
                    contrib = (jac.reshape(r, t, -1) * u[:, None, :]).sum(dim=0)
                    part = reduce_T(plan, contrib, tr, width, csr)
                acc[pm.t_cls] = acc[pm.t_cls] + part
        return acc

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
        out = self._flatten_classes_T(acc)
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
                diag_rows = torch.as_tensor(np.arange(s) * s + np.arange(s), device=acc.device)
                acc = acc.index_add(0, diag_rows, dt[cls].T)
            out.append(acc)
        return out

    def to_dense(self):
        """Dense [num_rows, num_cols] Jacobian (small problems / tests)."""
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
