"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled with nvcc for sm_90a into one shared library with
a plain C interface and loaded with ctypes (no PyTorch headers: the build
takes seconds, not minutes). The build happens on first use, into
`ceres_tpu_torch/_build/`, keyed by a hash of the sources and flags; nothing
is built or loaded when the package is imported.

Each kernel wrapper calls `count(name)` once per launch of its kernel;
`launch_counts()` / `reset_launch_counts()` let a run show which kernels its
main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("eval_snavely", "gather_contract", "contract_reduce", "schur_sy", "schur_p0")
_launches = {name: 0 for name in KERNELS}
_lib = None

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C signatures: every function returns cudaGetLastError() as an int
_SIGNATURES = {
    # tbl0, rows0, tbl1, rows1, obs, n, loss_kind, loss_a, with_jac,
    # res, jac0, jac1, partials, cost, stream
    "ctt_eval_snavely": [_P, _P, _P, _P, _P, _I, _I, _D, _I, _P, _P, _P, _P, _P, _P],
    # jac, rows, table, n, r, t, ncols, out, stream
    "ctt_gather_contract": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    # twin, perm, chunk_start, row_chunks, u, n, n_pad, r, t, nchunks, ncols,
    # partial, out, stream
    "ctt_contract_reduce": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv, cnt_e,
    # n, r, te, tf, t2, ld, stream
    "ctt_schur_sy_point": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _I, _P],
    # F twin, E twin, point rows, chunk_start, row_chunks, slot_row, y, dsq,
    # ncols_f, t2, ld, cnt_e, n_pad, r, te, tf, nchunks, partial, out, stream
    "ctt_schur_sy_fold": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
    ],
    # F twin, E twin, point rows, chunk_start, row_chunks, minv, cnt_e, n_pad,
    # r, te, tf, nchunks, ncols_out, partial, out, stream
    "ctt_schur_p0": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
}


def nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build() -> Path:
    """Compile csrc/*.cu (with the headers they include) into the cached
    shared library; returns its path. One nvcc per source, all started
    together, then one link. The compilers' output (ptxas register / spill
    report) is kept in _build/build.log."""
    srcs = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(SRC_DIR.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libceres_tpu_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    procs = [
        subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(srcs, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s.name, p.returncode) for s, p in zip(srcs, procs) if p.returncode != 0]
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(link.stdout)
        if link.returncode != 0:
            failed.append(("link", link.returncode))
    for o in objs:
        o.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed {failed}:\n{''.join(logs)[-4000:]}")
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for prefix, argtypes in _SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, prefix + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_fn(prefix: str, dtype):
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{prefix}: unsupported dtype {dtype} (float32/float64)")
    return getattr(library(), prefix + suffix)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require(name, t, dtype=None, shape=None, device=None):
    """Raise unless t is a contiguous CUDA tensor of the given dtype/shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def count(name: str):
    _launches[name] += 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0
