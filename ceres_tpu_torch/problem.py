"""Problem modeling: parameter blocks and residual blocks, added in bulk.

Port of the bulk-add part of `ceres_tpu.problem` (reference:
include/ceres/problem.h). Parameter blocks added together stay one
[n, size] matrix; residual blocks added together form one batch sharing a
functor. `compile()` lowers the problem to a `Program` (program.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .autodiff import CostFunction
from .loss import LossFunction
from .manifolds import EuclideanManifold, Manifold


def _is_euclidean(m) -> bool:
    return m is None or isinstance(m, EuclideanManifold)


class _BlockStore:
    """Columnar parameter-block storage: one [n, size] matrix per bulk add
    plus a set of blocks marked constant."""

    def __init__(self):
        self._ranges: list = []  # {start, n, size, manifold, values [n, s]}
        self._len = 0
        self.constant: set = set()

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
        self._len += int(values.shape[0])
        return start

    def __len__(self) -> int:
        return self._len

    def _range_of(self, i: int) -> dict:
        for r in self._ranges:
            if r["start"] <= i < r["start"] + r["n"]:
                return r
        raise IndexError(i)

    def manifold_of(self, i: int):
        return self._range_of(int(i))["manifold"]

    def value(self, i: int) -> np.ndarray:
        r = self._range_of(int(i))
        return r["values"][int(i) - r["start"]]

    def columns(self):
        """(removed, constant, sizes, tsizes, manifold_ids, manifolds)."""
        nb = self._len
        removed = np.zeros(nb, dtype=bool)
        constant = np.zeros(nb, dtype=bool)
        sizes = np.zeros(nb, dtype=np.int64)
        tsizes = np.zeros(nb, dtype=np.int64)
        manifold_ids = np.full(nb, -1, dtype=np.int64)
        manifolds: list = []
        for r in self._ranges:
            st, n, s, m = r["start"], r["n"], r["size"], r["manifold"]
            sizes[st : st + n] = s
            if _is_euclidean(m):
                tsizes[st : st + n] = s
            else:
                if m not in manifolds:
                    manifolds.append(m)
                tsizes[st : st + n] = m.tangent_size
                manifold_ids[st : st + n] = manifolds.index(m)
        if self.constant:
            constant[np.fromiter(self.constant, dtype=np.int64)] = True
        return removed, constant, sizes, tsizes, manifold_ids, manifolds

    def fill_state(self, state0: np.ndarray, x_offsets: np.ndarray):
        for r in self._ranges:
            st, n, s = r["start"], r["n"], r["size"]
            rows = x_offsets[st : st + n, None] + np.arange(s)[None, :]
            state0[rows.reshape(-1)] = r["values"].reshape(-1)

    def write_back(self, state: np.ndarray, x_offsets: np.ndarray):
        for r in self._ranges:
            st, n, s = r["start"], r["n"], r["size"]
            rows = x_offsets[st : st + n, None] + np.arange(s)[None, :]
            r["values"][:] = state[rows.reshape(-1)].reshape(-1, s)


@dataclasses.dataclass
class _ResidualBatch:
    """A homogeneous batch of residual blocks added together."""

    cost_function: CostFunction
    loss: Optional[LossFunction]
    param_ids: np.ndarray  # [n, k] parameter block indices
    data: tuple  # tuple of [n, ...] arrays
    alive: np.ndarray  # [n] bool


class Problem:
    """Nonlinear least-squares problem under construction
    (reference: include/ceres/problem.h:127-574)."""

    def __init__(self):
        self._blocks = _BlockStore()
        self._batches: list[_ResidualBatch] = []
        self._dirty = True
        self._program = None

    def add_parameter_blocks(
        self, values, manifold: Optional[Manifold] = None
    ) -> np.ndarray:
        """Bulk-add n blocks of equal size from a [n, size] array; returns
        their handles."""
        v = np.asarray(values, dtype=np.float64)
        if v.ndim != 2:
            raise ValueError("add_parameter_blocks expects [n, size]")
        if manifold is not None and manifold.ambient_size != v.shape[1]:
            raise ValueError(
                f"manifold ambient size {manifold.ambient_size} != block size {v.shape[1]}"
            )
        start = self._blocks.append_range(v.copy(), manifold)
        self._dirty = True
        return np.arange(start, start + v.shape[0])

    def set_parameter_block_constant(self, block: int):
        self._blocks.constant.add(int(block))
        self._dirty = True

    def is_parameter_block_constant(self, block: int) -> bool:
        return int(block) in self._blocks.constant

    def parameter_block_value(self, block: int) -> np.ndarray:
        return self._blocks.value(block).copy()

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
        data = tuple(np.asarray(d) for d in data)
        for d in data:
            if d.shape[0] != n:
                raise ValueError("data arrays must have leading dim n")
        if n and (pid.min() < 0 or pid.max() >= len(self._blocks)):
            raise ValueError("unknown parameter block in param_ids")
        first = sum(b.param_ids.shape[0] for b in self._batches)
        self._batches.append(
            _ResidualBatch(
                cost_function=cost_function,
                loss=loss,
                param_ids=pid,
                data=data,
                alive=np.ones(n, dtype=bool),
            )
        )
        self._dirty = True
        return np.arange(first, first + n)

    # ---- counts (reference: problem.h:468-519) ---- #

    def num_parameter_blocks(self) -> int:
        return len(self._blocks)

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

    # ---- lowering ---- #

    def compile(self, device=None):
        """Lower to a Program on `device`, by default the card, as `solve`
        picks it (utils.dtypes.resolve_device: with no device named and no
        card visible it raises; pass "cpu" for the CPU). Cached until the
        structure changes; a new device only re-targets the cached
        Program."""
        from .program import Program
        from .utils.dtypes import resolve_device

        device = resolve_device(device)
        if self._dirty or self._program is None:
            self._program = Program(self._blocks, self._batches)
            self._dirty = False
        return self._program.to(device)
