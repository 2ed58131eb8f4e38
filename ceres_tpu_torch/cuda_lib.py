"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled with nvcc for sm_90a into one shared library with
a plain C interface and loaded with ctypes (no PyTorch headers: the build
takes seconds, not minutes). The build happens on first use, into
`ceres_tpu_torch/_build/`, keyed by a hash of the sources and flags; nothing
is built or loaded when the package is imported.

Each kernel wrapper calls `count(name)` once per launch of its kernel,
which adds to the counter of that name in the process-wide table
(utils.execution_summary.counts), and a replayed CUDA graph adds the
launches it captured once per replay (utils/graphs.py). `LAUNCHES` names
every launch counter, so a run shows which kernels its main path went
through.

Every kernel is instantiated for float32 and float64; B2, B3 and B4 also
for bfloat16 leaves (the mixed-precision solves), whose vectors,
accumulators and outputs are float32. Those instantiations count under
their own names (`counter`): `schur_sy_bf16`, ...

B1's generic instantiation is built per generated source
(functor_codegen.py fills in csrc/eval_generic.cuh), and so is B4 at every
shape but the BA shape (linalg/schur_kernels.py sy_source instantiates
csrc/schur_sy.cuh): `build_generated` compiles the sources it is given,
one nvcc each, all started together, into `_build/gen_<hash>.so` keyed by
a hash of the source, the headers and the flags (counted as
`Kernel::GeneratedBuild`, or `Kernel::GeneratedHit` when found built),
and `generated_fn` loads an entry point of one. A build never runs inside
a CUDA graph capture (it raises there): the Evaluator builds its
Program's sources when it is made. Each evaluation of B1 generic is one launch, counted as
`eval_generic` (with the Jacobian), `eval_generic_analytic` (with the
Jacobian, for a functor that carries an analytic rule) and
`eval_generic_residual`; B4's generated kernels count as the library's
(`schur_sy`, `schur_sy_bf16`).

The mixed-precision solves' bfloat16 copy of a Jacobian's leaves and twins
(jacobian.bf16_copies, csrc/leaf_to_bf16.cu; float32 or float64 sources)
is one launch, counted as `leaf_to_bf16`.

`build_host` compiles the port's host C++ sources (native/: the BAL
loader and the C API's embedding shim) with g++, the same way: keyed by a
hash, under the build lock, installed with os.replace.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .utils import execution_summary
from .utils.execution_summary import span

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("eval_snavely", "gather_contract", "contract_reduce", "schur_sy", "schur_p0")
# B1's quaternion instantiations (eval_kernel.snavely_quat_evaluate): on the
# camera's product manifold (tangent 9) and without a manifold (tangent 10)
QUAT_KERNELS = ("eval_snavely_quat", "eval_snavely_quat_nomanifold")
# B2 and B3 over a batch of columns (the covariance's batched PCG)
BATCHED_KERNELS = ("gather_contract_batched", "contract_reduce_batched")
# the kernels with a bfloat16-leaf instantiation (B2, B3, B4)
BF16_KERNELS = ("gather_contract", "contract_reduce", "schur_sy") + BATCHED_KERNELS
# B1's generic instantiation (eval_kernel.generic_evaluate): with the
# Jacobian (autodiff by Jets, or an analytic rule's) and residual-only
GENERIC_KERNELS = ("eval_generic", "eval_generic_analytic", "eval_generic_residual")
# the bfloat16 copy of a Jacobian's leaves and twins (mixed-precision solves)
COPY_KERNELS = ("leaf_to_bf16",)
# B1's launches with a lane mask (a sharded group's pad lanes: the mask_T
# operand of the JAX kernel) count under their own names: "<name>_masked"
MASKED_KERNELS = tuple(
    k + "_masked" for k in ("eval_snavely",) + QUAT_KERNELS + GENERIC_KERNELS
)
# every launch counter: the names count() takes
LAUNCHES = (
    KERNELS + QUAT_KERNELS + BATCHED_KERNELS + tuple(k + "_bf16" for k in BF16_KERNELS)
    + GENERIC_KERNELS + MASKED_KERNELS + COPY_KERNELS
)
_LAUNCH_SET = frozenset(LAUNCHES)
_lib = None
# generated sources: path -> loaded library, (source, entry point) -> its
# function
_generated = {}
_generated_fns = {}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C signatures: every function returns cudaGetLastError() as an int
_SIGNATURES = {
    # model, tbl0, rows0, tbl1, rows1, obs, mask (or null), n, loss kind, a,
    # b, c, scale, with_jac, res, jac0, jac1, partials, cost, stream
    "ctt_eval_snavely": [
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _D, _D, _D, _D, _I, _P, _P, _P, _P, _P, _P,
    ],
    # jac, rows, table, n, r, t, ncols, out, stream
    "ctt_gather_contract": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    # B2's shared-memory kernel, bfloat16 leaves only: the same arguments
    "ctt_gather_contract_shared": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    # twin, perm, chunk_start, row_chunks, u, n, n_pad, r, t, nchunks, ncols,
    # partial, out, stream
    "ctt_contract_reduce": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # the batched B2: twin, perm, chunk_start, slot_row, table [ncols, t, k],
    # n_pad, r, t, ncols, k, nchunks, out [n, r, k], stream
    "ctt_gather_contract_batched": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # the batched B3: twin, perm, chunk_start, row_chunks, u [n, r, k], n_pad,
    # r, t, k, nchunks, ncols, partial [nchunks, t, k], out [ncols, t, k], stream
    "ctt_contract_reduce_batched": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
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
    # host arrays of the sources, the destinations and the counts (int64),
    # the number of tensors, out: the launches made (int32), stream
    "ctt_leaf_to_bf16": [_P, _P, _P, _I, _P, _P],
}
_BF16_PREFIXES = (
    "ctt_gather_contract", "ctt_contract_reduce", "ctt_schur_sy_point", "ctt_schur_sy_fold",
    "ctt_gather_contract_batched", "ctt_contract_reduce_batched",
)
_BF16_ONLY = ("ctt_gather_contract_shared",)
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64", torch.bfloat16: "_bf16"}


def nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on _build/ (fcntl): processes that build at once,
    the ranks of a sharded solve, take turns, and each one after the first
    finds the libraries built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> Path:
    """Compile csrc/*.cu (with the headers they include) into the cached
    shared library; returns its path. One nvcc per source, all started
    together, then one link, under the build lock. The compilers' output
    (ptxas register / spill report) is kept in _build/build.log."""
    with _build_lock():
        return _build()


def _build() -> Path:
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


HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def host_compiler():
    """The C++ compiler of the host builds ($CXX, else g++) if it is on
    PATH, else None."""
    return shutil.which(os.environ.get("CXX") or "g++")


def build_host(source, name: str, extra_flags=()) -> Path:
    """Compile a host C++ source (a path) with g++ into
    `_build/host_<hash>/<name>.so`, keyed by a hash of the source and the
    flags, and return that path (the native BAL loader, io/native.py, and
    the C API's embedding shim, capi.py). Runs under the build lock and
    installs with os.replace, so processes that build at once end with one
    library; a compile or link error raises with the compiler's output.
    Needs a C++ compiler (host_compiler), never nvcc."""
    source = Path(source)
    flags = (*HOST_FLAGS, *extra_flags)
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    out = BUILD_DIR / f"host_{h.hexdigest()[:16]}" / f"{name}.so"
    with _build_lock():
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cxx = host_compiler()
        if cxx is None:
            raise RuntimeError("no C++ compiler on PATH ($CXX or g++)")
        # the source first, the libraries it links after it
        proc = subprocess.run(
            [cxx, *HOST_FLAGS, f"-Wl,-soname,{out.name}", "-o", str(tmp), str(source),
             *extra_flags],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed on {source.name} (rc {proc.returncode}):\n"
                               f"{proc.stdout[-4000:]}")
        os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for prefix, argtypes in _SIGNATURES.items():
            for suffix in _suffixes(prefix):
                fn = getattr(lib, prefix + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# a generated source's entry points beside the library's (_SIGNATURES):
# B1 generic's with_jac, ptrs, c, n, res, partials, ticket, cost, stream
_GENERATED_SIGNATURES = {"ctt_eval_generic": [_I, _P, _P, _I, _P, _P, _P, _P, _P]}


def _generated_path(source: str):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):  # the templates and what they include
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(source.encode())
    return BUILD_DIR / f"gen_{h.hexdigest()[:16]}.so"


def build_generated(sources) -> float:
    """Compile the generated sources (an iterable of source texts) that
    are not built yet, one nvcc each, all started together; returns the
    seconds it took. Raises RuntimeError with the compiler's output when
    one fails. The ptxas report of each goes to _build/gen_<hash>.log.
    Runs under the build lock; raises inside a CUDA graph capture."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a kernel build inside a CUDA graph capture: build the sources "
                           "before capturing (the Evaluator builds its Program's)")
    with _build_lock():
        return _build_generated(sources)


def _build_generated(sources) -> float:
    todo = {}
    for src in sources:
        path = _generated_path(src)
        if path.exists():
            execution_summary.count("Kernel::GeneratedHit")
        else:
            todo[path] = src
    if not todo:
        return 0.0
    with span("Kernel::Build") as build:
        build.calls = len(todo)
        return _run_nvcc(todo)


def _run_nvcc(todo) -> float:
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for path, src in todo.items():
        cu = path.with_name(f"{path.stem}.{os.getpid()}.cu")
        cu.write_text(src)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-shared", "-o", str(tmp), str(cu)]
        with open(path.with_suffix(".log"), "w") as log:
            procs[path] = (cu, tmp, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    failed = []
    for path, (cu, tmp, proc) in procs.items():
        proc.wait()
        cu.unlink(missing_ok=True)
        if proc.returncode != 0:
            log = path.with_suffix(".log").read_text()
            failed.append(f"{path.name} (rc {proc.returncode}):\n{log[-3000:]}")
        else:
            os.replace(tmp, path)
    seconds = time.perf_counter() - t0
    execution_summary.count("Kernel::GeneratedBuild", len(todo) - len(failed))
    if failed:
        raise RuntimeError("nvcc failed on a generated kernel: " + "\n".join(failed))
    return seconds


def generated_fn(source: str, dtype, prefix: str = "ctt_eval_generic"):
    """The entry point `prefix` of a generated source for leaves of
    `dtype` (float32 or float64; bfloat16 where the library's kernel of
    that name has it), built on first use."""
    fn = _generated_fns.get((source, prefix, dtype))
    if fn is not None:
        return fn
    suffix = _SUFFIX.get(dtype)
    if suffix not in _suffixes(prefix):
        raise TypeError(f"{prefix}: unsupported dtype {dtype}")
    path = _generated_path(source)
    lib = _generated.get(path)
    if lib is None:
        build_generated([source])
        lib = _generated[path] = ctypes.CDLL(str(path))
    fn = getattr(lib, prefix + suffix)
    fn.argtypes = _GENERATED_SIGNATURES.get(prefix) or _SIGNATURES[prefix]
    fn.restype = ctypes.c_int
    _generated_fns[(source, prefix, dtype)] = fn
    return fn


def _suffixes(prefix: str):
    """The leaf dtypes a kernel is instantiated for, as entry-point suffixes."""
    if prefix in _BF16_ONLY:
        return ("_bf16",)
    return ("_f32", "_f64") + (("_bf16",) if prefix in _BF16_PREFIXES else ())


def kernel_fn(prefix: str, dtype):
    """The instantiation of a kernel for its leaves' dtype: float32,
    float64, or bfloat16 where the kernel has one."""
    suffix = _SUFFIX.get(dtype)
    if suffix not in _suffixes(prefix):
        kinds = "/".join({"_f32": "float32", "_f64": "float64", "_bf16": "bfloat16"}[k]
                         for k in _suffixes(prefix))
        raise TypeError(f"{prefix}: unsupported dtype {dtype} ({kinds})")
    return getattr(library(), prefix + suffix)


def vector_dtype(leaf_dtype):
    """The dtype of a kernel's vectors, accumulators and outputs for leaves
    of `leaf_dtype`: float32 for bfloat16 leaves, else the leaves' own."""
    return torch.float32 if leaf_dtype == torch.bfloat16 else leaf_dtype


def counter(name: str, leaf_dtype) -> str:
    """The launch counter of kernel `name` for leaves of `leaf_dtype`."""
    return name + "_bf16" if leaf_dtype == torch.bfloat16 else name


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, name: str):
    if rc == 1:  # cudaErrorInvalidValue: the launcher refused its operands
        raise RuntimeError(f"{name}: the kernel does not take these operands (cudaErrorInvalidValue;"
                           " e.g. a bfloat16 twin or its prow/perm not 16-byte aligned)")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require(name, t, dtype=None, shape=None, device=None, lanes_major=False):
    """Raise unless t is a contiguous CUDA tensor of the given dtype/shape;
    with `lanes_major`, a 3-d tensor whose .permute(2, 1, 0) is contiguous
    (the batched B2/B3's layout: the leading column axis innermost)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if lanes_major:
        if t.dim() != 3 or not t.permute(2, 1, 0).is_contiguous():
            raise ValueError(f"{name}: tensor must be lane-major (a .permute(2, 1, 0) view of "
                             f"a contiguous tensor), got strides {tuple(t.stride())}")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def count(name: str, n: int = 1):
    """Count n launches of the kernel counter `name` (one of LAUNCHES)."""
    if name not in _LAUNCH_SET:
        raise KeyError(f"{name} is not a launch counter (cuda_lib.LAUNCHES)")
    execution_summary.count(name, n)
