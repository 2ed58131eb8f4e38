"""Row-lazy data handles for per-rank shard construction.

Port of `ceres_tpu.io.lazy`. A LazyRows wraps a row-indexed data source
(the observation payload of a BAL file) and a composed row map, so the
Program can permute and subset residual-block data without materializing
it, and parallel.sharding.build_shard_arrays can ask each rank for exactly
the rows it owns: the whole observation payload never exists in one
process.

A source has one method, `gather(rows) -> np.ndarray` (the requested rows,
in any order, duplicates allowed), and `shape` and `dtype` attributes that
describe the whole virtual array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class LazyRows:
    """A virtual [n, ...] array: source rows viewed through a row map."""

    def __init__(self, source, row_map: Optional[np.ndarray] = None):
        self.source = source
        self.row_map = None if row_map is None else np.asarray(row_map)

    @property
    def shape(self):
        n = self.source.shape[0] if self.row_map is None else self.row_map.shape[0]
        return (n,) + tuple(self.source.shape[1:])

    @property
    def dtype(self):
        return np.dtype(self.source.dtype)

    @property
    def ndim(self):
        return len(self.shape)

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, rows):
        """A row subset or permutation as a new LazyRows (nothing is read).
        Only whole-row indexing by a 1-D integer array or a slice: what the
        Program's group building and the shard layout apply."""
        if isinstance(rows, slice):
            rows = np.arange(*rows.indices(self.shape[0]))
        rows = np.asarray(rows)
        if rows.ndim != 1 or not np.issubdtype(rows.dtype, np.integer):
            raise TypeError("LazyRows supports 1-D integer-array row indexing only")
        return LazyRows(self.source, rows if self.row_map is None else self.row_map[rows])

    def gather(self, rows) -> np.ndarray:
        """The given (virtual) rows as a numpy array."""
        rows = np.asarray(rows)
        return self.source.gather(rows if self.row_map is None else self.row_map[rows])

    def materialize(self) -> np.ndarray:
        """Every row (single-process paths)."""
        return self.gather(np.arange(self.shape[0]))

    def __array__(self, dtype=None, copy=None):
        out = self.materialize()
        return out if dtype is None else out.astype(dtype)


class ArraySource:
    """An in-memory source (data already loaded; tests)."""

    def __init__(self, array: np.ndarray):
        self.array = np.asarray(array)
        self.shape = self.array.shape
        self.dtype = self.array.dtype

    def gather(self, rows: np.ndarray) -> np.ndarray:
        return self.array[np.asarray(rows)]


def is_lazy(d) -> bool:
    """True for a row-lazy leaf (LazyRows or any object with its contract)."""
    return hasattr(d, "gather") and hasattr(d, "shape")


def materialize_rows(a, rows):
    """Rows `rows` of a data leaf, ndarray or LazyRows."""
    return a.gather(rows) if is_lazy(a) else np.asarray(a)[rows]
