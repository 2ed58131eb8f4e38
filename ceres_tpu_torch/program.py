"""Program: the lowered, executable form of a Problem.

Port of `ceres_tpu.program`. Everything here is host numpy and reproduces
the JAX package's tables exactly (tests/test_torch_program.py holds them
equal): the class-contiguous state/tangent layout, the Plus structure,
signature groups with their per-position row tables, the bucket/onehot
reduction plans, and the Schur partition. `arrays()` and `state_vector()`
materialize tensors on the Program's device.

One table has no JAX counterpart: the padded camera CSR (`camera_layout`).
For every position on the "onehot" plan it lists the group's lanes stably
sorted by class row, each row's run padded with -1 to a multiple of
TWIN_ALIGN slots, and cuts the slots into chunks of at most TWIN_CHUNK that
never straddle two rows. The Jacobian keeps a "twin" of each onehot leaf in
this slot order (jacobian.make_twin), so kernels B3 and B5 read every
camera's observations contiguously, one block per chunk, and combine the
chunks of a row in a fixed order: deterministic without atomics.
`slot_rows` gives another position's class rows in that slot order (the
point row of each slot, read by kernels B4 and B5).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .autodiff import CostFunction
from .loss import LossFunction
from .manifolds import EuclideanManifold, Manifold


def _span_indices(starts, lens):
    """Concatenate [start_i, start_i + len_i) ranges into one index vector."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lens)
    idx = np.arange(total, dtype=np.int64)
    span_of = np.searchsorted(ends, idx, side="right")
    within = idx - (ends - lens)[span_of]
    return starts[span_of] + within


@dataclasses.dataclass(frozen=True)
class PositionMeta:
    """Static description of one parameter slot of a signature."""

    size: int
    tangent_size: int
    manifold: Optional[Manifold]  # None == Euclidean
    a_cls: int = -1  # ambient class id (gathers)
    t_cls: int = -1  # tangent class id (reductions); -1 if no free block


@dataclasses.dataclass
class SigGroupMeta:
    """Static description of one signature group.

    red_plans maps a position to ("bucket", buckets) — lanes
    [lane_start + j*n_seg + e] hold observation j of class row out_row + e,
    so gathers are slice+broadcast and reductions reshape+sum — or to
    ("onehot",) — an indexed gather and the CSR reduce. Positions without a
    plan fall back to index_select / index_add_.
    """

    cost_function: CostFunction
    loss: Optional[LossFunction]
    positions: tuple
    n: int
    row_offset: int
    red_plans: Optional[dict] = None
    owner: int = -1
    owner_ambient_aligned: bool = False

    @property
    def num_residuals(self) -> int:
        return self.cost_function.num_residuals

    @property
    def rows(self) -> int:
        return self.n * self.num_residuals


@dataclasses.dataclass
class ManifoldGroupMeta:
    manifold: Manifold
    n: int


def camera_csr(t_rows: np.ndarray, ncols: int):
    """(perm [n] int32, offsets [ncols+1] int32): lanes stably sorted by
    class row, and where each row's run starts."""
    perm = np.argsort(t_rows, kind="stable").astype(np.int32)
    offsets = np.zeros(ncols + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(t_rows, minlength=ncols))
    return perm, offsets.astype(np.int32)


TWIN_ALIGN = 32  # slots: a run starts 128-byte aligned in float32
TWIN_CHUNK = 2048  # slots per block of kernels B3 and B5 (a multiple of TWIN_ALIGN)


class CameraLayout(NamedTuple):
    """The padded camera CSR of one onehot position (numpy, or tensors on a
    device). Slot k of row c lies in [offsets[c], offsets[c+1])."""

    perm: object  # [n_pad] int32: the lane in slot k, -1 on padding
    offsets: object  # [ncols+1] int32: run starts, multiples of TWIN_ALIGN
    slot_row: object  # [n_pad] int32: the class row owning slot k
    pad: object  # [n_pad - n] int32: the padding slots
    chunk_start: object  # [nchunks+1] int32: chunk m is [chunk_start[m], chunk_start[m+1])
    row_chunks: object  # [ncols+1] int32: row c's chunks are [row_chunks[c], row_chunks[c+1])
    live_chunks: int  # chunks of every row but the last (the dump column)

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_start) - 1

    def to(self, device):
        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=device)

        return self._replace(**{f: ints(getattr(self, f)) for f in self._fields[:-1]})


def camera_layout(t_rows: np.ndarray, ncols: int) -> CameraLayout:
    """The padded camera CSR of class rows t_rows [n] over ncols rows (the
    last one the dump column); see CameraLayout."""
    perm, offsets = camera_csr(t_rows, ncols)
    counts = np.diff(offsets).astype(np.int64)
    padded = -(-counts // TWIN_ALIGN) * TWIN_ALIGN
    offsets_pad = np.concatenate([[0], np.cumsum(padded)])
    n_pad = int(offsets_pad[-1])
    slot_row = np.repeat(np.arange(ncols), padded)
    live = np.arange(n_pad) - offsets_pad[slot_row] < counts[slot_row]
    perm_pad = np.full(n_pad, -1, dtype=np.int32)
    perm_pad[live] = perm
    nch = -(-padded // TWIN_CHUNK)
    row_chunks = np.concatenate([[0], np.cumsum(nch)])
    chunk_row = np.repeat(np.arange(ncols), nch)
    within = np.arange(int(row_chunks[-1])) - row_chunks[chunk_row]
    chunk_start = np.concatenate([offsets_pad[chunk_row] + within * TWIN_CHUNK, [n_pad]])
    return CameraLayout(
        perm_pad, offsets_pad.astype(np.int32), slot_row.astype(np.int32),
        np.nonzero(~live)[0].astype(np.int32), chunk_start.astype(np.int32),
        row_chunks.astype(np.int32), int(row_chunks[ncols - 1]),
    )


class Program:
    """Executable lowering of a Problem. See module docstring."""

    SEG_REDUCE_THRESHOLD = 32_768
    MAX_SEG_BUCKETS = 512
    ONEHOT_MAX_COLS = 16384

    def __init__(self, blocks, batches):
        self._blocks = blocks
        self._batches = batches
        self.device = torch.device("cpu")
        self._compute_block_degrees()
        self._build_layout()
        self._build_plus_structure()
        self.block_class = self.t_class
        self._build_groups()
        # Schur-side tables, computed once per Program (the JAX package
        # computes them once per trace); see `cached`
        self.schur_cache: dict = {}

    def to(self, device):
        """Re-target the Program's tensors (arrays, state) at `device`."""
        self.device = torch.device(device)
        return self

    def cached(self, key, fn):
        """fn(self), computed once per Program under `key` (its structure
        is fixed)."""
        if key not in self.schur_cache:
            self.schur_cache[key] = fn(self)
        return self.schur_cache[key]

    def slot_rows(self, gi, pos, order_pos, device):
        """The class rows of position `pos` of group `gi` in the slot order of
        the onehot position `order_pos` ([n_pad] int32 on `device`, -1 on
        padding): the point row of each camera-ordered slot, read by kernels
        B4 and B5.
        Computed once per Program and device."""

        def build(p):
            idx = p.group_idx[gi]
            perm = idx["csr"][order_pos].perm
            rows = np.where(perm >= 0, idx["t_rows"][pos][np.maximum(perm, 0)], -1)
            return torch.as_tensor(rows.astype(np.int32), device=device)

        return self.cached(("slot_rows", gi, pos, order_pos, torch.device(device)), build)

    def _compute_block_degrees(self):
        """Residual-row count per parameter block (its 'degree'); tangent
        classes are laid out in (degree, id) order (program.py:144-161 of
        the JAX package)."""
        deg = np.zeros(len(self._blocks), dtype=np.int64)
        for batch in self._batches:
            rows = batch.param_ids[batch.alive]
            if rows.size:
                np.add.at(deg, rows.reshape(-1), 1)
        self.block_degree = deg

    def tangent_class_slice(self, cls: int):
        """(base, count, size) of a tangent class in the flat tangent vector."""
        return (
            int(self.tangent_class_bases[cls]),
            int(self.tangent_class_counts[cls]),
            int(self.tangent_class_sizes[cls]),
        )

    def ambient_class_slice(self, cls: int):
        return (
            int(self.ambient_class_bases[cls]),
            int(self.ambient_class_counts[cls]),
            int(self.ambient_class_sizes[cls]),
        )

    # ------------------------------------------------------------------ #
    # layout
    # ------------------------------------------------------------------ #

    def _build_layout(self):
        """Class-contiguous layout: blocks grouped by ambient size in the
        state vector and by tangent size in the tangent vector; tangent
        class rows in (degree, id) order."""
        removed, constant, sizes, tsizes, manifold_ids, manifolds = (
            self._blocks.columns()
        )
        self._col_removed = removed
        self._col_constant = constant
        self._col_manifold_ids = manifold_ids
        self._manifold_objects = manifolds
        nb = len(self._blocks)
        self.sizes = sizes
        self.tangent_sizes = tsizes
        live = ~removed
        free = live & ~constant

        self.tangent_class_sizes = sorted(set(tsizes[free].tolist()))
        self.tangent_class_of_size = {
            s: i for i, s in enumerate(self.tangent_class_sizes)
        }
        t_size_keys = np.asarray(self.tangent_class_sizes, dtype=np.int64)
        self.t_class = np.full(nb, -1, dtype=np.int64)
        if t_size_keys.size:
            self.t_class[free] = np.searchsorted(t_size_keys, tsizes[free])
        self.t_row = np.full(nb, -1, dtype=np.int64)
        free_ids = np.nonzero(free)[0]
        order = free_ids[np.lexsort((free_ids, self.block_degree[free_ids]))]
        cls_of_order = self.t_class[order]
        t_counts = [int(np.sum(cls_of_order == c)) for c in range(t_size_keys.size)]
        csort = np.argsort(cls_of_order, kind="stable")
        pos = np.empty(order.size, dtype=np.int64)
        pos[csort] = np.arange(order.size)
        bases = np.concatenate([[0], np.cumsum(t_counts)])
        self.t_row[order] = pos - bases[cls_of_order]
        self.tangent_class_counts = t_counts

        # ambient classes; rows aligned to the tangent class where an
        # ambient class is exactly one tangent class's blocks
        self.ambient_class_sizes = sorted(set(sizes[live].tolist()))
        self.ambient_class_of_size = {
            s: i for i, s in enumerate(self.ambient_class_sizes)
        }
        a_size_keys = np.asarray(self.ambient_class_sizes, dtype=np.int64)
        self.a_class = np.full(nb, -1, dtype=np.int64)
        if a_size_keys.size:
            self.a_class[live] = np.searchsorted(a_size_keys, sizes[live])
        self.a_row = np.full(nb, -1, dtype=np.int64)
        a_counts = [
            int(np.sum(self.a_class[live] == c)) for c in range(a_size_keys.size)
        ]
        self.ambient_aligned = [False] * len(self.ambient_class_sizes)
        for c in range(a_size_keys.size):
            members = np.nonzero(live & (self.a_class == c))[0]
            t_cls = np.unique(self.t_class[members])
            if (
                members.size
                and t_cls.size == 1
                and t_cls[0] >= 0
                and self.tangent_class_counts[int(t_cls[0])] == members.size
            ):
                self.ambient_aligned[c] = True
                self.a_row[members] = self.t_row[members]
            else:
                self.a_row[members] = np.arange(members.size)
        self.ambient_class_counts = a_counts
        self.ambient_class_bases = np.concatenate(
            [[0], np.cumsum([c * s for c, s in zip(a_counts, self.ambient_class_sizes)])]
        ).astype(np.int64)
        self.x_offsets = np.zeros(nb, dtype=np.int64)
        self.x_offsets[live] = (
            self.ambient_class_bases[self.a_class[live]] + self.a_row[live] * sizes[live]
        )
        self.num_parameters = int(self.ambient_class_bases[-1])
        self.tangent_class_bases = np.concatenate(
            [[0], np.cumsum([c * s for c, s in zip(t_counts, self.tangent_class_sizes)])]
        ).astype(np.int64)
        self.t_offsets = np.full(nb, -1, dtype=np.int64)
        self.t_offsets[free] = (
            self.tangent_class_bases[self.t_class[free]] + self.t_row[free] * tsizes[free]
        )
        self.num_effective_parameters = int(self.tangent_class_bases[-1])

        self.state0 = np.zeros(self.num_parameters, dtype=np.float64)
        self._blocks.fill_state(self.state0, self.x_offsets)

    # ------------------------------------------------------------------ #
    # Plus structure
    # ------------------------------------------------------------------ #

    def _build_plus_structure(self):
        """Row-based Plus: per ambient class, Euclidean free blocks add
        their delta rows (constants map to a zero dump row); manifold blocks
        are batched per manifold (reference: Program::Plus)."""
        free = ~self._col_removed & ~self._col_constant
        mids = self._col_manifold_ids
        euclid = free & (mids < 0)

        self.plus_euclid = []
        for a_c, cnt in enumerate(self.ambient_class_counts):
            sel = euclid & (self.a_class == a_c)
            if not sel.any():
                self.plus_euclid.append(None)
                continue
            size = self.ambient_class_sizes[a_c]
            t_cls = self.tangent_class_of_size[size]
            dump = self.tangent_class_counts[t_cls]
            rows = np.full(cnt, dump, dtype=np.int64)
            rows[self.a_row[sel]] = self.t_row[sel]
            self.plus_euclid.append({"t_cls": t_cls, "t_row_map": rows.astype(np.int32)})

        self.manifold_group_meta: list[ManifoldGroupMeta] = []
        self.manifold_group_idx: list[dict] = []
        for mid, m in enumerate(self._manifold_objects):
            idx = np.nonzero(free & (mids == mid))[0]
            if idx.size == 0:
                continue
            self.manifold_group_meta.append(ManifoldGroupMeta(m, int(idx.size)))
            self.manifold_group_idx.append(
                {
                    "a_cls": int(self.a_class[idx[0]]),
                    "t_cls": int(self.t_class[idx[0]]),
                    "a_rows": self.a_row[idx].astype(np.int32),
                    "t_rows": self.t_row[idx].astype(np.int32),
                }
            )

    # ------------------------------------------------------------------ #
    # signature groups
    # ------------------------------------------------------------------ #

    def _manifold_key(self, b):
        m = self._blocks.manifold_of(b)
        return None if (m is None or isinstance(m, EuclideanManifold)) else m

    def _sig_key_for_row(self, batch, row):
        cf = batch.cost_function
        sizes = tuple(int(self.sizes[b]) for b in batch.param_ids[row])
        manifolds = tuple(self._manifold_key(b) for b in batch.param_ids[row])
        data_sig = tuple((d.shape[1:], d.dtype.str) for d in batch.data)
        return (cf.fn, cf.num_residuals, batch.loss, sizes, manifolds, data_sig)

    def _build_groups(self):
        buckets: dict = {}
        order: list = []
        for bi, batch in enumerate(self._batches):
            if batch.alive.all():
                alive_rows, first = None, 0
            else:
                alive_rows = np.nonzero(batch.alive)[0]
                if alive_rows.size == 0:
                    continue
                first = alive_rows[0]
            sizes0 = self.sizes[batch.param_ids[first]]
            rows_pid = batch.param_ids if alive_rows is None else batch.param_ids[alive_rows]
            if not np.all(self.sizes[rows_pid] == sizes0):
                raise ValueError(
                    "all rows of a residual batch must have uniform block sizes"
                )
            key = self._sig_key_for_row(batch, first)
            if key not in buckets:
                buckets[key] = []
                order.append(key)
            buckets[key].append((bi, alive_rows))

        def _take(arr, rows):
            return arr if rows is None else arr[rows]

        self.groups: list[SigGroupMeta] = []
        self.group_idx: list[dict] = []
        row_offset = 0
        for key in order:
            members = buckets[key]
            batch0 = self._batches[members[0][0]]
            k = batch0.param_ids.shape[1]
            pid = np.concatenate(
                [_take(self._batches[bi].param_ids, rows) for bi, rows in members]
            )
            data = tuple(
                np.concatenate(
                    [_take(self._batches[bi].data[di], rows) for bi, rows in members]
                )
                for di in range(len(batch0.data))
            )
            n = pid.shape[0]

            positions = []
            for pos in range(k):
                size = int(self.sizes[pid[0, pos]])
                manifold = self._manifold_key(pid[0, pos])
                tsize = manifold.tangent_size if manifold is not None else size
                positions.append(
                    PositionMeta(
                        size,
                        tsize,
                        manifold,
                        self.ambient_class_of_size[size],
                        self.tangent_class_of_size.get(tsize, -1),
                    )
                )

            meta = SigGroupMeta(
                cost_function=batch0.cost_function,
                loss=batch0.loss,
                positions=tuple(positions),
                n=n,
                row_offset=row_offset,
            )

            # layout plans (program.py:582-649 of the JAX package): the
            # largest all-free class (BA points) owns the lane order, with
            # lanes interleaved per equal-degree bucket; other classes of
            # at most ONEHOT_MAX_COLS rows get the onehot plan
            perm = None
            plans: dict = {}
            owner = -1
            if n >= self.SEG_REDUCE_THRESHOLD:
                candidates = [
                    (self.tangent_class_counts[pm.t_cls], pos)
                    for pos, pm in enumerate(positions)
                    if pm.t_cls >= 0 and np.all(self.t_row[pid[:, pos]] >= 0)
                ]
                if candidates:
                    _, rpos = max(candidates)
                    rows_of = self.t_row[pid[:, rpos]]
                    perm = np.argsort(rows_of, kind="stable")
                    seg = self._seg_buckets(rows_of[perm])
                    if seg is not None:
                        ileave = np.empty(n, dtype=np.int64)
                        for (lane_start, n_seg, d, _out) in seg:
                            blockidx = np.arange(
                                lane_start, lane_start + n_seg * d
                            ).reshape(n_seg, d)
                            ileave[lane_start : lane_start + n_seg * d] = (
                                blockidx.T.reshape(-1)
                            )
                        perm = perm[ileave]
                        owner = rpos
                        plans[rpos] = ("bucket", seg)
                    pid = pid[perm]
                    data = tuple(d[perm] for d in data)
                for pos, pm in enumerate(positions):
                    if pos in plans or pm.t_cls < 0:
                        continue
                    if self.tangent_class_counts[pm.t_cls] + 1 <= self.ONEHOT_MAX_COLS:
                        plans[pos] = ("onehot",)

            a_rows, t_rows, block_ids, csr = [], [], [], {}
            for pos, pm in enumerate(positions):
                ids = pid[:, pos]
                a_rows.append(self.a_row[ids].astype(np.int32))
                tr = self.t_row[ids]
                cnt = self.tangent_class_counts[pm.t_cls] if pm.t_cls >= 0 else 0
                tr = np.where(tr >= 0, tr, cnt).astype(np.int32)
                t_rows.append(tr)
                block_ids.append(ids.astype(np.int32))
                if plans.get(pos, ("",))[0] == "onehot":
                    csr[pos] = camera_layout(tr, cnt + 1)
            meta.red_plans = plans
            meta.owner = owner
            if owner >= 0:
                meta.owner_ambient_aligned = bool(
                    np.array_equal(a_rows[owner], t_rows[owner])
                )
            self.groups.append(meta)
            self.group_idx.append(
                {
                    "a_rows": tuple(a_rows),
                    "t_rows": tuple(t_rows),
                    "block_ids": tuple(block_ids),
                    "data": data,
                    "csr": csr,
                }
            )
            row_offset += meta.rows

        self.num_residuals = row_offset
        self.num_residual_blocks = sum(g.n for g in self.groups)

    def _seg_buckets(self, sorted_rows: np.ndarray):
        """Bucket decomposition of a class-row-sorted row array: tuple of
        (lane_start, n_seg, degree, out_row_start), or None when it
        fragments past MAX_SEG_BUCKETS."""
        uniq, starts, counts = np.unique(
            sorted_rows, return_index=True, return_counts=True
        )
        buckets = []
        i = 0
        m = len(uniq)
        while i < m:
            j = i + 1
            while j < m and counts[j] == counts[i] and uniq[j] == uniq[j - 1] + 1:
                j += 1
            buckets.append((int(starts[i]), j - i, int(counts[i]), int(uniq[i])))
            i = j
        if len(buckets) > self.MAX_SEG_BUCKETS:
            return None
        return tuple(buckets)

    # ------------------------------------------------------------------ #
    # Schur elimination partition
    # ------------------------------------------------------------------ #

    def compute_schur_partition(self):
        """(e_mask_blocks [nb] bool, e_positions, f_positions): each residual
        row elects its lowest-(degree, id) free block; a block is eliminated
        iff it wins every row it appears in; positions with mixed membership
        are demoted (program.py:823-934 of the JAX package). Cached."""
        return self.cached("partition", Program._compute_schur_partition)

    def _compute_schur_partition(self):
        nb = len(self._blocks)
        # rows per block (its degree); bincount rather than np.add.at, which
        # is ~10x slower at millions of rows
        degree = np.zeros(nb, dtype=np.int64)
        for idx in self.group_idx:
            for ids in idx["block_ids"]:
                degree += np.bincount(ids, minlength=nb)
        wins = np.zeros(nb, dtype=np.int64)
        for idx in self.group_idx:
            ids_mat = np.stack(idx["block_ids"], axis=1)
            free = self.t_offsets[ids_mat] >= 0
            key = degree[ids_mat] * (nb + 1) + ids_mat
            key = np.where(free, key, np.iinfo(np.int64).max)
            has_free = free.any(axis=1)
            winner = ids_mat[np.arange(ids_mat.shape[0]), np.argmin(key, axis=1)]
            wins += np.bincount(winner[has_free], minlength=nb)
        e_mask = (wins == degree) & (degree > 0) & (self.t_offsets >= 0)

        changed = True
        while changed:
            changed = False
            for idx in self.group_idx:
                e_positions = []
                for pos, ids in enumerate(idx["block_ids"]):
                    flags = e_mask[ids]
                    if flags.any() and not flags.all():
                        e_mask[ids[flags]] = False
                        changed = True
                    elif flags.all() and flags.size:
                        e_positions.append(pos)
                if len(e_positions) > 1:
                    for pos in e_positions[1:]:
                        e_mask[idx["block_ids"][pos]] = False
                    changed = True

        e_positions, f_positions = [], []
        for idx in self.group_idx:
            eps, fps = [], []
            for pos, ids in enumerate(idx["block_ids"]):
                if ids.size and e_mask[ids].all():
                    eps.append(pos)
                else:
                    fps.append(pos)
            e_positions.append(tuple(eps))
            f_positions.append(tuple(fps))

        return e_mask, e_positions, f_positions

    def schur_tangent_masks(self):
        """(e_mask, f_mask) over the tangent vector [num_eff], numpy f64."""
        return self.cached("masks", Program._compute_schur_masks)

    def _compute_schur_masks(self):
        e_blocks, _, _ = self.compute_schur_partition()
        e = np.zeros(self.num_effective_parameters, dtype=np.float64)
        sel = np.nonzero(np.asarray(e_blocks) & (self.t_offsets >= 0))[0]
        if sel.size:
            e[_span_indices(self.t_offsets[sel], self.tangent_sizes[sel])] = 1.0
        return e, 1.0 - e

    # ------------------------------------------------------------------ #
    # runtime tensors
    # ------------------------------------------------------------------ #

    def arrays(self, dtype):
        """Index tables and group data as tensors on the Program's device:
        int32 row tables, data leaves in `dtype` (float leaves only)."""
        dev = self.device

        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=dev)

        groups = []
        for idx in self.group_idx:
            groups.append(
                {
                    "a_rows": tuple(ints(a) for a in idx["a_rows"]),
                    "t_rows": tuple(ints(t) for t in idx["t_rows"]),
                    "data": tuple(
                        torch.as_tensor(
                            np.ascontiguousarray(d),
                            dtype=dtype if np.issubdtype(d.dtype, np.floating) else None,
                            device=dev,
                        )
                        for d in idx["data"]
                    ),
                    "csr": {pos: lay.to(dev) for pos, lay in idx["csr"].items()},
                }
            )
        return {
            "groups": groups,
            "plus_euclid": [
                None if rec is None else {"t_row_map": ints(rec["t_row_map"])}
                for rec in self.plus_euclid
            ],
            "manifold_groups": [
                {"a_rows": ints(g["a_rows"]), "t_rows": ints(g["t_rows"])}
                for g in self.manifold_group_idx
            ],
        }

    def state_vector(self, dtype):
        return torch.as_tensor(self.state0, dtype=dtype, device=self.device)

    def write_state_back(self, state):
        """Copy a solved state vector back into the Problem's blocks."""
        state = np.asarray(state, dtype=np.float64)
        self.state0 = state.copy()
        self._blocks.write_back(state, self.x_offsets)
