"""Problem modeling: parameter blocks, residual blocks, bounds, manifolds.

Port of `ceres_tpu.problem` (reference: include/ceres/problem.h). Parameter
blocks added together stay one [n, size] matrix; a block touched on its own
keeps only what changed (constancy, bounds, a manifold set after the add,
removal) beside it. Residual blocks added together form one batch sharing a
functor, with contiguous handles; a single add is a batch of one. Bounds
are kept per block, for Euclidean blocks only. `compile()` lowers the
problem to a `Program` (program.py); `evaluate` is Problem::Evaluate.
"""

from __future__ import annotations

import bisect
import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np

from .autodiff import CostFunction
from .io.lazy import is_lazy
from .loss import LossFunction
from .manifolds import EuclideanManifold, Manifold
from .utils.execution_summary import span


def _is_euclidean(m) -> bool:
    return m is None or isinstance(m, EuclideanManifold)


class _BlockStore:
    """Columnar parameter-block storage: one [n, size] matrix per bulk add,
    plus the blocks marked constant, their bounds, the manifolds set on
    single blocks after the add, and the removed blocks."""

    def __init__(self):
        self._ranges: list = []  # {start, n, size, manifold, values [n, s]}
        self._range_starts: list = []
        self._len = 0
        self.constant: set = set()
        # block -> [size] bound arrays (reference: ParameterBlock bounds)
        self.lower: dict = {}
        self.upper: dict = {}
        # block -> manifold (None: Euclidean), in the order they were set
        self.manifolds: dict = {}
        self.removed: set = set()

    def append_range(self, values: np.ndarray, manifold) -> int:
        start = self._len
        self._ranges.append(
            {
                "start": start,
                "n": int(values.shape[0]),
                "size": int(values.shape[1]),
                "manifold": manifold,
                "values": values,
            }
        )
        self._range_starts.append(start)
        self._len += int(values.shape[0])
        return start

    def __len__(self) -> int:
        return self._len

    def _range_of(self, i: int) -> dict:
        if not 0 <= i < self._len:
            raise IndexError(i)
        return self._ranges[bisect.bisect_right(self._range_starts, i) - 1]

    def check(self, i) -> int:
        """The handle as an int; IndexError for an unknown or removed one."""
        i = int(i)
        self._range_of(i)
        if i in self.removed:
            raise IndexError(f"parameter block {i} was removed")
        return i

    def manifold_of(self, i: int):
        i = int(i)
        if i in self.manifolds:
            return self.manifolds[i]
        return self._range_of(i)["manifold"]

    def value(self, i: int) -> np.ndarray:
        r = self._range_of(int(i))
        return r["values"][int(i) - r["start"]]

    def size_of(self, i: int) -> int:
        return self._range_of(int(i))["size"]

    def columns(self):
        """(removed, constant, sizes, tsizes, manifold_ids, manifolds): the
        per-block columns; a removed block has size 0 and no class."""
        nb = self._len
        removed = np.zeros(nb, dtype=bool)
        constant = np.zeros(nb, dtype=bool)
        sizes = np.zeros(nb, dtype=np.int64)
        tsizes = np.zeros(nb, dtype=np.int64)
        manifold_ids = np.full(nb, -1, dtype=np.int64)
        manifolds: list = []
        mindex: dict = {}

        def mid_of(m):
            if m not in mindex:
                mindex[m] = len(manifolds)
                manifolds.append(m)
            return mindex[m]

        for r in self._ranges:
            st, n, s, m = r["start"], r["n"], r["size"], r["manifold"]
            sizes[st : st + n] = s
            if _is_euclidean(m):
                tsizes[st : st + n] = s
            else:
                tsizes[st : st + n] = m.tangent_size
                manifold_ids[st : st + n] = mid_of(m)
        for i, m in self.manifolds.items():
            if _is_euclidean(m):
                tsizes[i] = sizes[i]
                manifold_ids[i] = -1
            else:
                tsizes[i] = m.tangent_size
                manifold_ids[i] = mid_of(m)
        if self.constant:
            constant[np.fromiter(self.constant, dtype=np.int64)] = True
        if self.removed:
            gone = np.fromiter(self.removed, dtype=np.int64)
            removed[gone] = True
            constant[gone] = False
            sizes[gone] = 0
            tsizes[gone] = 0
            manifold_ids[gone] = -1
        # compact away manifolds left with no live block (a range whose
        # every block was removed or given another manifold)
        used = np.unique(manifold_ids[manifold_ids >= 0])
        if used.size != len(manifolds):
            remap = np.full(len(manifolds), -1, dtype=np.int64)
            remap[used] = np.arange(used.size)
            manifold_ids = np.where(manifold_ids >= 0, remap[manifold_ids], -1)
            manifolds = [manifolds[int(u)] for u in used]
        return removed, constant, sizes, tsizes, manifold_ids, manifolds

    def removed_mask(self) -> np.ndarray:
        mask = np.zeros(self._len, dtype=bool)
        if self.removed:
            mask[np.fromiter(self.removed, dtype=np.int64)] = True
        return mask

    def bounds_any(self) -> bool:
        return any(b not in self.removed for b in (*self.lower, *self.upper))

    def fill_bounds(self, lower: np.ndarray, upper: np.ndarray, x_offsets: np.ndarray):
        for bounds, out in ((self.lower, lower), (self.upper, upper)):
            for b, vals in bounds.items():
                if b in self.removed:
                    continue
                o = int(x_offsets[b])
                out[o : o + vals.size] = vals

    def ranges(self):
        """(first handle, values [n, size]) of each add, in handle order:
        the arrays the blocks' values live in, written in place."""
        return [(r["start"], r["values"]) for r in self._ranges]

    def fill_state(self, state0: np.ndarray, x_offsets: np.ndarray):
        """state0 at each live block's offset = the block's values (a
        removed block has no offset and writes nothing)."""
        gone = self.removed_mask()
        for r in self._ranges:
            st, n, s = r["start"], r["n"], r["size"]
            keep = ~gone[st : st + n]
            rows = x_offsets[st : st + n][keep, None] + np.arange(s)[None, :]
            state0[rows.reshape(-1)] = r["values"][keep].reshape(-1)


@dataclasses.dataclass
class _ResidualBatch:
    """A homogeneous batch of residual blocks added together."""

    cost_function: CostFunction
    loss: Optional[LossFunction]
    param_ids: np.ndarray  # [n, k] parameter block indices
    data: tuple  # tuple of [n, ...] arrays
    first_handle: int
    alive: np.ndarray  # [n] bool


class Problem:
    """Nonlinear least-squares problem under construction
    (reference: include/ceres/problem.h:127-574)."""

    def __init__(self, evaluation_callback=None):
        """evaluation_callback(new_point: bool, evaluate_jacobians: bool)
        runs on the host before each evaluation the solver makes, the hook
        user code refreshes shared quantities in (reference:
        evaluation_callback.h, Problem::Options::evaluation_callback;
        ceres_tpu/problem.py:257-272). A solve with one takes the host
        loop."""
        self.evaluation_callback = evaluation_callback
        self._blocks = _BlockStore()
        self._batches: list[_ResidualBatch] = []
        # handles are contiguous per batch: handle -> (batch, row) is a
        # bisect over the batches' first handles
        self._batch_starts: list[int] = []
        self._next_residual_handle = 0
        self._dirty = True
        self._program = None

    def _locate_handle(self, handle: int) -> tuple:
        """(batch index, row) of a live residual-block handle."""
        h = int(handle)
        i = bisect.bisect_right(self._batch_starts, h) - 1
        if i < 0:
            raise KeyError(handle)
        batch = self._batches[i]
        row = h - batch.first_handle
        if row >= batch.alive.shape[0] or not batch.alive[row]:
            raise KeyError(handle)
        return i, row

    # ---- parameter blocks ---- #

    def add_parameter_block(self, values, manifold: Optional[Manifold] = None) -> int:
        """Add one parameter block; returns its handle (reference:
        Problem::AddParameterBlock)."""
        v = np.asarray(values, dtype=np.float64).reshape(-1).copy()
        if v.size == 0:
            raise ValueError("parameter block must be non-empty")
        self._check_manifold(v.size, manifold)
        handle = self._blocks.append_range(v.reshape(1, -1), manifold)
        self._dirty = True
        return handle

    def add_parameter_blocks(
        self, values, manifold: Optional[Manifold] = None
    ) -> np.ndarray:
        """Bulk-add n blocks of equal size from a [n, size] array; returns
        their handles."""
        v = np.asarray(values, dtype=np.float64)
        if v.ndim != 2:
            raise ValueError("add_parameter_blocks expects [n, size]")
        self._check_manifold(v.shape[1], manifold)
        start = self._blocks.append_range(v.copy(), manifold)
        self._dirty = True
        return np.arange(start, start + v.shape[0])

    @staticmethod
    def _check_manifold(size: int, manifold: Optional[Manifold]):
        if manifold is not None and manifold.ambient_size != size:
            raise ValueError(
                f"manifold ambient size {manifold.ambient_size} != block size {size}"
            )

    def set_manifold(self, block: int, manifold: Optional[Manifold]):
        block = self._blocks.check(block)
        self._check_manifold(self._blocks.size_of(block), manifold)
        self._blocks.manifolds[block] = manifold
        self._dirty = True

    def set_parameter_block_constant(self, block: int):
        self._blocks.constant.add(self._blocks.check(block))
        self._dirty = True

    def set_parameter_block_variable(self, block: int):
        self._blocks.constant.discard(self._blocks.check(block))
        self._dirty = True

    def is_parameter_block_constant(self, block: int) -> bool:
        return int(block) in self._blocks.constant

    def _bound_array(self, bounds: dict, block: int, fill: float) -> np.ndarray:
        block = self._blocks.check(block)
        if not _is_euclidean(self._blocks.manifold_of(block)):
            raise ValueError("bounds require a Euclidean parameter block")
        if block not in bounds:
            bounds[block] = np.full(self._blocks.size_of(block), fill)
        return bounds[block]

    def set_parameter_lower_bound(self, block: int, index: int, value: float):
        self._bound_array(self._blocks.lower, block, -np.inf)[index] = value
        self._dirty = True

    def set_parameter_upper_bound(self, block: int, index: int, value: float):
        self._bound_array(self._blocks.upper, block, np.inf)[index] = value
        self._dirty = True

    def get_parameter_lower_bound(self, block: int, index: int) -> float:
        vals = self._blocks.lower.get(int(block))
        return -np.inf if vals is None else float(vals[index])

    def get_parameter_upper_bound(self, block: int, index: int) -> float:
        vals = self._blocks.upper.get(int(block))
        return np.inf if vals is None else float(vals[index])

    def parameter_block_value(self, block: int) -> np.ndarray:
        return self._blocks.value(block).copy()

    def get_manifold(self, block: int):
        """The block's manifold, None where it has none (reference:
        Problem::GetManifold)."""
        return self._blocks.manifold_of(self._blocks.check(block))

    def set_parameter_block_value(self, block: int, values):
        """Replace a block's values; the compiled Program's state follows
        without a recompile (the structure is unchanged)."""
        block = self._blocks.check(block)
        v = np.asarray(values, dtype=np.float64).reshape(-1)
        if v.size != self._blocks.size_of(block):
            raise ValueError("size mismatch")
        self._blocks.value(block)[:] = v
        if self._program is not None and not self._dirty:
            self._program.set_block_value(block, v)

    def remove_parameter_block(self, block: int):
        """Remove a parameter block and every residual block that touches it
        (reference: Problem::RemoveParameterBlock, problem_impl.cc)."""
        block = self._blocks.check(block)
        self._blocks.removed.add(block)
        for batch in self._batches:
            batch.alive &= ~np.any(batch.param_ids == block, axis=1)
        self._dirty = True

    # ---- residual blocks ---- #

    def add_residual_block(
        self,
        cost_function: CostFunction,
        loss: Optional[LossFunction],
        params: Sequence[int],
        data: tuple = (),
    ) -> int:
        """Add one residual block; returns its handle (reference:
        Problem::AddResidualBlock, problem.h:268)."""
        pid = np.asarray(params, dtype=np.int64).reshape(1, -1)
        stacked = tuple(np.asarray(d)[None, ...] for d in data)
        return int(self.add_residual_blocks(cost_function, loss, pid, stacked)[0])

    def add_residual_blocks(
        self,
        cost_function: CostFunction,
        loss: Optional[LossFunction],
        param_ids,
        data: tuple = (),
    ) -> np.ndarray:
        """Bulk-add n residual blocks sharing one functor: param_ids [n, k],
        data = tuple of [n, ...] arrays. Returns the n handles."""
        if not isinstance(cost_function, CostFunction):
            raise TypeError("cost_function must be a ceres_tpu_torch CostFunction")
        pid = np.asarray(param_ids, dtype=np.int64)
        if pid.ndim != 2:
            raise ValueError("param_ids must be [n, k]")
        n = pid.shape[0]
        # a row-lazy leaf (io.lazy.LazyRows) stays lazy: a sharded solve
        # reads only each rank's rows of it
        data = tuple(d if is_lazy(d) else np.asarray(d) for d in data)
        for d in data:
            if d.shape[0] != n:
                raise ValueError("data arrays must have leading dim n")
        flat = pid.reshape(-1)
        bad = (flat < 0) | (flat >= len(self._blocks))
        if self._blocks.removed and not bad.any():
            bad = self._blocks.removed_mask()[flat]
        if bad.any():
            raise ValueError(f"unknown parameter block {flat[bad][0]}")
        first = self._next_residual_handle
        self._batches.append(
            _ResidualBatch(
                cost_function=cost_function,
                loss=loss,
                param_ids=pid,
                data=data,
                first_handle=first,
                alive=np.ones(n, dtype=bool),
            )
        )
        self._batch_starts.append(first)
        self._next_residual_handle += n
        self._dirty = True
        return np.arange(first, first + n)

    def parameter_blocks_for_residual_block(self, handle: int) -> list:
        """reference: Problem::GetParameterBlocksForResidualBlock
        (problem.h:402)."""
        bi, row = self._locate_handle(handle)
        return [int(b) for b in self._batches[bi].param_ids[row]]

    def residual_blocks_for_parameter_block(self, block: int) -> list:
        """reference: Problem::GetResidualBlocksForParameterBlock
        (problem.h:421)."""
        out = []
        for batch in self._batches:
            hits = np.nonzero(batch.alive & (batch.param_ids == int(block)).any(axis=1))[0]
            out.extend((batch.first_handle + hits).tolist())
        return out

    def mark_structure_dirty(self):
        """Force a recompile on the next solve (after changing a loss or a
        functor out of band)."""
        self._dirty = True

    def remove_residual_block(self, handle: int):
        """reference: Problem::RemoveResidualBlock."""
        bi, row = self._locate_handle(handle)
        self._batches[bi].alive[row] = False
        self._dirty = True

    # ---- counts (reference: problem.h:468-519) ---- #

    def num_parameter_blocks(self) -> int:
        return len(self._blocks) - len(self._blocks.removed)

    def num_parameters(self) -> int:
        return int(self._blocks.columns()[2].sum())

    def num_effective_parameters(self) -> int:
        _rm, constant, _s, tsizes, _m, _ms = self._blocks.columns()
        return int(tsizes[~constant].sum())

    def num_residual_blocks(self) -> int:
        return int(sum(b.alive.sum() for b in self._batches))

    def num_residuals(self) -> int:
        return int(
            sum(b.alive.sum() * b.cost_function.num_residuals for b in self._batches)
        )

    # ---- lowering and evaluation ---- #

    def compile(self, device=None):
        """Lower to a Program on `device`, by default the card, as `solve`
        picks it (utils.dtypes.resolve_device: with no device named and no
        card visible it raises; pass "cpu" for the CPU). Cached until the
        structure changes; a new device only re-targets the cached
        Program."""
        from .utils.dtypes import resolve_device

        return self._lowered().to(resolve_device(device))

    def _lowered(self):
        """The cached Program, lowered anew when the structure changed."""
        from .program import Program

        if self._dirty or self._program is None:
            if self._program is not None:
                # the old Program's solve workspace goes with it, now
                self._program.release_workspace()
            with span("Program::Lower"):
                self._program = Program(self._blocks, self._batches, self.evaluation_callback)
            self._dirty = False
        return self._program

    def residual_rows_for_handles(self, handles) -> np.ndarray:
        """Global residual rows (the compiled Program's row space, host
        tables only) of the given residual-block handles."""
        program = self._lowered()
        rows = []
        for h in handles:
            gi, grow = program.handle_entry(*self._locate_handle(h))
            meta = program.groups[gi]
            r = meta.num_residuals
            start = meta.row_offset + grow * r
            rows.append(np.arange(start, start + r))
        return np.concatenate(rows) if rows else np.zeros(0, dtype=np.int64)

    def evaluate(
        self,
        apply_loss_function: bool = True,
        residual_blocks: Optional[Sequence[int]] = None,
        device=None,
    ):
        """Whole-problem (or residual-subset) evaluation at the current
        parameter values in float64, on `device` (by default the card, as
        `compile`).

        Returns (cost, residuals, gradient, jacobian) with numpy residuals
        and gradient and the Jacobian as a CRS triple (values, col_indices,
        row_pointers) over the free tangent columns. Parity:
        Problem::Evaluate + EvaluateOptions (problem.h:430-467);
        `residual_blocks` plays EvaluateOptions::residual_blocks and lowers
        a Program of those blocks alone.
        """
        if residual_blocks is None:
            return self.compile(device).evaluate_full(apply_loss_function)

        from .program import Program
        from .utils.dtypes import resolve_device

        device = resolve_device(device)
        keep = {}
        for h in residual_blocks:
            try:
                bi, row = self._locate_handle(h)
            except KeyError:
                continue
            keep.setdefault(bi, []).append(row)
        batches = []
        for bi, batch in enumerate(self._batches):
            nb = copy.copy(batch)
            mask = np.zeros_like(batch.alive)
            mask[keep.get(bi, [])] = True
            nb.alive = batch.alive & mask
            batches.append(nb)
        program = Program(self._blocks, batches, self.evaluation_callback).to(device)
        return program.evaluate_full(apply_loss_function)
