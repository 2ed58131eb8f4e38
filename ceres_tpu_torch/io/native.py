"""ctypes bindings to the native (C++) BAL loader and preprocessor.

Port of `ceres_tpu.io.native` (reference: examples/bal_problem.cc and
reorder_program.cc, which are C++). The port keeps its own copy of the
source, `ceres_tpu_torch/native/bal_loader.cc`, and builds it with the
host's C++ compiler at first use (cuda_lib.build_host, into `_build/`).
Every entry point has the JAX package's numpy fallback, the plain
version, which runs only where no C++ compiler is on PATH (`available()`
is then False): the counterpart of the JAX package's "library not built".
Once a compiler is there, a library that fails to build or to load
raises; it never turns into the numpy branch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from .. import cuda_lib

SOURCE = Path(__file__).resolve().parent.parent / "native" / "bal_loader.cc"
_LIB = None


def available() -> bool:
    """Whether the native library can be used (a C++ compiler is on PATH)."""
    return cuda_lib.host_compiler() is not None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is None:
        if not available():
            return None
        lib = ctypes.CDLL(str(cuda_lib.build_host(SOURCE, "libceres_tpu_torch_native")))
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.bal_header.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
        lib.bal_header.restype = ctypes.c_int
        lib.bal_load.argtypes = [ctypes.c_char_p, i64p, i64p, f64p, f64p, f64p]
        lib.bal_load.restype = ctypes.c_int
        lib.sort_by_camera.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
        lib.sort_by_camera.restype = None
        lib.count_degrees.argtypes = [i64p, i64p, ctypes.c_int64, i64p, i64p]
        lib.count_degrees.restype = None
        lib.coo_to_crs.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p]
        lib.coo_to_crs.restype = None
        _LIB = lib
    return _LIB


def _as_i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def load_bal_native(path: str):
    """Parse a BAL file with the native parser (mmap + std::from_chars):
    (cameras [nc, 9], points [np, 3], camera_index, point_index,
    observations [no, 2]), or None without a compiler. Raises IOError on a
    missing, malformed or truncated file."""
    lib = _lib()
    if lib is None:
        return None
    nc, np_, no = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.bal_header(str(path).encode(), ctypes.byref(nc), ctypes.byref(np_),
                      ctypes.byref(no)) != 0:
        raise IOError(f"failed to read BAL header from {path}")
    num_cameras, num_points, num_obs = nc.value, np_.value, no.value
    camera_index = np.empty(num_obs, dtype=np.int64)
    point_index = np.empty(num_obs, dtype=np.int64)
    observations = np.empty((num_obs, 2), dtype=np.float64)
    cameras = np.empty((num_cameras, 9), dtype=np.float64)
    points = np.empty((num_points, 3), dtype=np.float64)
    rc = lib.bal_load(str(path).encode(), _as_i64p(camera_index), _as_i64p(point_index),
                      _as_f64p(observations), _as_f64p(cameras), _as_f64p(points))
    if rc != 0:
        raise IOError(f"native BAL parse failed with code {rc} for {path}")
    return cameras, points, camera_index, point_index, observations


def sort_by_camera(camera_index: np.ndarray, point_index: np.ndarray) -> np.ndarray:
    """Permutation ordering observations by (camera, point), stable: the
    segment-sum-friendly layout. Native, numpy without a compiler."""
    lib = _lib()
    if lib is None:
        return np.lexsort((point_index, camera_index))
    ci = np.ascontiguousarray(camera_index, dtype=np.int64)
    pi = np.ascontiguousarray(point_index, dtype=np.int64)
    perm = np.empty(ci.shape[0], dtype=np.int64)
    lib.sort_by_camera(_as_i64p(ci), _as_i64p(pi), ci.shape[0], _as_i64p(perm))
    return perm


def count_degrees(camera_index, point_index, num_cameras, num_points):
    """(observations per camera, per point). Native, numpy without a compiler."""
    lib = _lib()
    ci = np.ascontiguousarray(camera_index, dtype=np.int64)
    pi = np.ascontiguousarray(point_index, dtype=np.int64)
    if lib is None:
        return (np.bincount(ci, minlength=num_cameras).astype(np.int64),
                np.bincount(pi, minlength=num_points).astype(np.int64))
    cd = np.zeros(num_cameras, dtype=np.int64)
    pd = np.zeros(num_points, dtype=np.int64)
    lib.count_degrees(_as_i64p(ci), _as_i64p(pi), ci.shape[0], _as_i64p(cd), _as_i64p(pd))
    return cd, pd


def coo_to_crs(rows, cols, num_rows):
    """(perm, row_ptr) of a COO -> CRS conversion, perm the stable (row,
    col) order. Native, numpy without a compiler."""
    lib = _lib()
    r = np.ascontiguousarray(rows, dtype=np.int64)
    c = np.ascontiguousarray(cols, dtype=np.int64)
    if lib is None:
        perm = np.lexsort((c, r))
        row_ptr = np.zeros(num_rows + 1, dtype=np.int64)
        np.add.at(row_ptr, r + 1, 1)
        return perm, np.cumsum(row_ptr)
    perm = np.empty(r.shape[0], dtype=np.int64)
    row_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    lib.coo_to_crs(_as_i64p(r), _as_i64p(c), r.shape[0], num_rows, _as_i64p(perm),
                   _as_i64p(row_ptr))
    return perm, row_ptr
