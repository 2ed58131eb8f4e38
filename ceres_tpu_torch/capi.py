"""Python support layer of the C API (native/ceres_tpu_torch_c_api.cc).

Port of `ceres_tpu.capi` (reference: include/ceres/c_api.h +
internal/ceres/c_api.cc): a minimal C surface of init, the stock loss
functions, problem create/free, add_residual_block with a user C callback
that fills residuals and (optionally) analytic Jacobians, and solve with
default options. User parameter memory is adopted in place through
numpy.ctypeslib and written back after the solve (c_api.cc ceres_solve).

A C callback is a host function. It enters the solve as a functor whose
evaluation of a whole signature group is one host round trip: one
device->host copy of the group's [B, sum of sizes] parameter rows
(utils.graphs.read, so `num_device_reads` counts it), B calls of the C
function, and one upload of [B, r] residuals with their [B, r, sizes]
Jacobians; each round trip counts as `CAPI::RoundTrip` and each call of a
C function as `CAPI::Call` (utils.execution_summary.count). `_HostCall`
is the torch.autograd.Function that does it: its `vmap` rule is the JAX
package's `pure_callback(vmap_method="sequential")`, its `jvp` and
`backward` apply the callback's Jacobians (the JAX package's
custom_jvp), and it asks the callback for Jacobians only under a transform
that differentiates (torch.func's jvp or grad, or autograd). The
generator cannot lower a C function into B1 generic: the functor and
`CCallbackLoss` raise functor_codegen.Ineligible under `generating()`, and
their groups take the torch.func path, as JAX's group_kernel returns None
for a pure_callback. Nor can a host call be captured in a CUDA graph: an
Evaluator over such a Program runs its graphs eagerly
(`Evaluator.capturable`, the `runs_on_host` attribute), on the loop that
fused_loop.eligible picks as the JAX package does.

The device: the C API runs where the port's entry points run, on the card
unless the caller names the CPU. `CProblem.solve` passes
`CERES_TPU_TORCH_C_API_DEVICE` as the solve's device; unset, the solve
takes utils.dtypes.resolve_device(None), the card, and raises when none is
visible. `"cpu"` asks for the CPU.

`build_shim()` compiles the embedding shim with g++ against this
interpreter's libpython (cuda_lib.build_host), and `link_c_program` links a
C program against it.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import site
import subprocess
import sysconfig
from pathlib import Path

import numpy as np
import torch

from . import cuda_lib, functor_codegen
from .autodiff import CostFunction
from .loss import (
    ArctanLoss,
    CauchyLoss,
    HuberLoss,
    LossFunction,
    SoftLOneLoss,
    TolerantLoss,
)
from .problem import Problem
from .solvers.solver import solve
from .types import SolverOptions
from .utils import graphs
from .utils.dtypes import resolve_device
from .utils.execution_summary import count

DEVICE_ENV = "CERES_TPU_TORCH_C_API_DEVICE"
SHIM_SOURCE = Path(__file__).resolve().parent / "native" / "ceres_tpu_torch_c_api.cc"
SHIM_NAME = "libceres_tpu_torch_c_api"

# int (*ceres_cost_function_t)(void* user_data, double** parameters,
#                              double* residuals, double** jacobians)
COST_FUNC_T = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_void_p,
    ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
    ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
)

def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class _CCallbackCost:
    """Calls the user's C cost function (value + analytic Jacobians)."""

    def __init__(self, fn_addr: int, user_data: int, num_residuals: int, sizes):
        self.fn = COST_FUNC_T(fn_addr)
        self.user_data = ctypes.c_void_p(user_data)
        self.num_residuals = int(num_residuals)
        self.sizes = tuple(int(s) for s in sizes)

    def _call(self, params, want_jac: bool):
        """One block: params a list of [size_i] arrays -> (res [r], list of
        [r, size_i] Jacobians, empty without want_jac). A callback that
        returns 0 makes every value NaN (a cooperative abort: the solve
        ends in FAILURE)."""
        k = len(self.sizes)
        bufs = [np.ascontiguousarray(p, dtype=np.float64) for p in params]
        param_ptrs = (ctypes.POINTER(ctypes.c_double) * k)(*[_f64p(b) for b in bufs])
        res = np.zeros(self.num_residuals, dtype=np.float64)
        jacs = [np.zeros((self.num_residuals, s)) for s in self.sizes] if want_jac else []
        jac_ptrs = (ctypes.POINTER(ctypes.c_double) * k)(*[_f64p(j) for j in jacs]) \
            if want_jac else None
        count("CAPI::Call")
        if not self.fn(self.user_data, param_ptrs, _f64p(res), jac_ptrs):
            res[:] = np.nan
            for j in jacs:
                j[:] = np.nan
        return res, jacs

    def batch(self, x: np.ndarray, want_jac: bool) -> np.ndarray:
        """B blocks at once: x [B, sum of sizes] -> [B, r (+ r * sum of
        sizes)], each row the residuals then, with want_jac, the [r, sum of
        sizes] Jacobian (the blocks' Jacobians side by side), row-major."""
        r, total = self.num_residuals, sum(self.sizes)
        split = np.cumsum(self.sizes)[:-1]
        out = np.empty((x.shape[0], r + (r * total if want_jac else 0)))
        for b in range(x.shape[0]):
            res, jacs = self._call(np.split(x[b], split), want_jac)
            out[b, :r] = res
            if want_jac:
                out[b, r:] = np.concatenate(jacs, axis=1).reshape(-1)
        return out


def _differentiating(x) -> bool:
    """Whether x's consumer differentiates: a torch.func jvp or grad level
    is active, or autograd records x (or the tensor a vmap level wraps)."""
    from torch._C._functorch import (
        TransformType,
        get_interpreter_stack,
        get_unwrapped,
        is_functorch_wrapped_tensor,
    )

    if any(i.key() in (TransformType.Jvp, TransformType.Grad)
           for i in get_interpreter_stack() or ()):
        return True
    while not x.requires_grad and is_functorch_wrapped_tensor(x):
        x = get_unwrapped(x)
    return torch.is_grad_enabled() and x.requires_grad


class _HostCall(torch.autograd.Function):
    """(res [..., r], jac [..., r, S]) of a C cost callback at x [..., S]
    (the blocks' parameters side by side), over any leading batch dims in
    one host round trip; jac is [..., r, 0] when `want_jac` is False."""

    @staticmethod
    def forward(cb, want_jac, x):
        r, total = cb.num_residuals, x.shape[-1]
        lead = tuple(x.shape[:-1])
        host = graphs.read(x).to(torch.float64).reshape(-1, total).numpy()
        count("CAPI::RoundTrip")
        out = torch.from_numpy(cb.batch(host, want_jac)).to(device=x.device, dtype=x.dtype)
        res = out[:, :r].reshape(*lead, r)
        jac = out[:, r:].reshape(*lead, r, total if want_jac else 0)
        return res, jac

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(output[1])
        ctx.cb = inputs[0]
        ctx.save_for_forward(inputs[2], output[1])
        ctx.save_for_backward(inputs[2], output[1])

    @staticmethod
    def _jacobian(ctx):
        x, jac = ctx.saved_tensors
        if jac.shape[-1] != x.shape[-1]:
            # asked for none at the primal (a differentiation the forward
            # did not foresee): one more round trip
            jac = _HostCall.apply(ctx.cb, True, x)[1]
        return jac

    @staticmethod
    def jvp(ctx, _cb_t, _want_t, x_t):
        return (_HostCall._jacobian(ctx) @ x_t.unsqueeze(-1)).squeeze(-1), None

    @staticmethod
    def backward(ctx, g_res, _g_jac):
        if g_res is None:
            return None, None, None
        return None, None, (g_res.unsqueeze(-2) @ _HostCall._jacobian(ctx)).squeeze(-2)

    @staticmethod
    def vmap(info, in_dims, cb, want_jac, x):
        # the JAX package's vmap_method="sequential": the batch's rows go
        # to the host together and come back together
        dim = in_dims[2]
        x = x.movedim(dim, 0) if dim is not None else x.expand(info.batch_size, *x.shape)
        return _HostCall.apply(cb, want_jac, x), (0, 0)


class HostCallbackFunctor:
    """The functor fn(params, data) -> [r] of a C cost callback (data
    unused: the callback carries its own user data)."""

    runs_on_host = True

    def __init__(self, cb: _CCallbackCost, name: str):
        self.cb = cb
        self.__name__ = name

    def __call__(self, params, data=()):
        if functor_codegen.generating():
            raise functor_codegen.Ineligible("a host callback")
        x = torch.cat([p.reshape(-1) for p in params])
        res, _ = _HostCall.apply(self.cb, _differentiating(x), x)
        return res


_COST_CACHE: dict = {}
_LOSS_CACHE: dict = {}


def make_callback_cost_function(fn_addr, user_data, num_residuals, sizes):
    """CostFunction whose value and Jacobians come from the C callback.

    Cached per (address, user_data, signature), so residual blocks sharing
    one C callback and its data form one evaluation group, and so one host
    round trip per evaluation (reference: problem_cuda.h:462-468)."""
    key = (int(fn_addr), int(user_data), int(num_residuals), tuple(int(s) for s in sizes))
    if key not in _COST_CACHE:
        cb = _CCallbackCost(fn_addr, user_data, num_residuals, sizes)
        name = f"c_callback_{int(fn_addr):#x}"
        _COST_CACHE[key] = CostFunction(HostCallbackFunctor(cb, name), num_residuals, name=name)
    return _COST_CACHE[key]


_LOSS_KINDS = {
    0: lambda a, b: HuberLoss(a),
    1: lambda a, b: SoftLOneLoss(a),
    2: lambda a, b: CauchyLoss(a),
    3: lambda a, b: ArctanLoss(a),
    4: lambda a, b: TolerantLoss(a, b),
}


def make_stock_loss(kind: int, a: float, b: float) -> LossFunction:
    return _LOSS_KINDS[int(kind)](float(a), float(b))


def stock_loss_rho(kind: int, a: float, b: float, squared_norm: float):
    """rho, rho', rho'' of a stock loss at squared_norm (the C
    ceres_stock_loss_function entry; parity: c_api.cc)."""
    loss = make_stock_loss(kind, a, b)
    r0, r1, r2 = loss.rho(torch.tensor(float(squared_norm), dtype=torch.float64))
    return (float(r0), float(r1), float(r2))


# void (*ceres_loss_function_t)(void* user_data, double squared_norm,
#                               double out[3])
LOSS_FUNC_T = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_double)
)


class CCallbackLoss(LossFunction):
    """LossFunction backed by a user C loss callback: one host round trip
    per call of `rho` (the evaluator calls it on a group's [n] squared
    norms, outside vmap)."""

    runs_on_host = True

    def __init__(self, fn_addr: int, user_data: int):
        self.fn = LOSS_FUNC_T(fn_addr)
        self.user_data = ctypes.c_void_p(user_data)

    def _rho_host(self, s):
        s = np.atleast_1d(np.asarray(s, dtype=np.float64)).reshape(-1)
        out = np.zeros((3, s.size))
        buf = (ctypes.c_double * 3)()
        for i, si in enumerate(s):
            self.fn(self.user_data, float(si), buf)
            out[:, i] = buf[0], buf[1], buf[2]
        count("CAPI::Call", s.size)
        return out

    def rho(self, s):
        if functor_codegen.generating():
            raise functor_codegen.Ineligible("a host loss callback")
        host = graphs.read(s).to(torch.float64).numpy()
        count("CAPI::RoundTrip")
        out = torch.from_numpy(self._rho_host(host)).to(device=s.device, dtype=s.dtype)
        return tuple(o.reshape(s.shape) for o in out)


class CProblem:
    """Problem wrapper owning adopted user parameter memory. After `solve`,
    `summary` and `device` are those of the last solve."""

    def __init__(self):
        self.problem = Problem()
        self._param_arrays: dict[int, np.ndarray] = {}  # addr -> adopted array
        self._param_handles: dict[int, object] = {}
        self.summary = None
        self.device = None

    def _adopt(self, addr: int, size: int):
        if addr not in self._param_arrays:
            buf = np.ctypeslib.as_array(
                ctypes.cast(addr, ctypes.POINTER(ctypes.c_double)), shape=(size,)
            )
            self._param_arrays[addr] = buf
            self._param_handles[addr] = self.problem.add_parameter_block(
                np.array(buf, dtype=np.float64)
            )
        return self._param_handles[addr]

    def add_residual_block_c(
        self,
        cost_fn_addr: int,
        cost_user_data: int,
        loss_kind: int,  # -1: none / custom; >=0: stock loss index
        loss_a: float,
        loss_b: float,
        num_residuals: int,
        param_addrs,
        param_sizes,
        custom_loss_fn: int = 0,
        custom_loss_data: int = 0,
    ) -> int:
        cost = make_callback_cost_function(
            cost_fn_addr, cost_user_data, num_residuals, param_sizes
        )
        if loss_kind >= 0:
            loss = make_stock_loss(loss_kind, loss_a, loss_b)
        elif custom_loss_fn:
            lkey = (int(custom_loss_fn), int(custom_loss_data))
            if lkey not in _LOSS_CACHE:
                _LOSS_CACHE[lkey] = CCallbackLoss(custom_loss_fn, custom_loss_data)
            loss = _LOSS_CACHE[lkey]
        else:
            loss = None
        handles = [self._adopt(int(a), int(s)) for a, s in zip(param_addrs, param_sizes)]
        return int(self.problem.add_residual_block(cost, loss, handles))

    def solve(self) -> str:
        """Solve with default options on the C API's device (module
        docstring), write the solution into the adopted memory, and return
        the brief report and the device, one line each."""
        self.device = resolve_device(os.environ.get(DEVICE_ENV) or None)
        opts = SolverOptions(minimizer_progress_to_stdout=True, device=self.device)
        self.summary = solve(opts, self.problem)
        for addr, handle in self._param_handles.items():
            self._param_arrays[addr][:] = self.problem.parameter_block_value(handle)
        return f"{self.summary.brief_report()}\ndevice: {self.device}"


# ---------------------------------------------------------------------- #
# the embedding shim and C programs linked against it
# ---------------------------------------------------------------------- #


def _python_link_flags():
    """Compile and link flags of a library that embeds this interpreter,
    from sysconfig (a machine may lack python3-config)."""
    cfg = sysconfig.get_config_var
    libdir, ldlib = cfg("LIBDIR"), cfg("LDLIBRARY") or ""
    lib = f"-l:{ldlib}" if ldlib.endswith(".so") else f"-lpython{cfg('VERSION')}{cfg('ABIFLAGS') or ''}"
    return [f"-I{cfg('INCLUDEPY')}", f"-L{libdir}", lib, f"-Wl,-rpath,{libdir}"]


def build_shim() -> Path:
    """Build the C API's shim (native/ceres_tpu_torch_c_api.cc) into
    `_build/host_<hash>/libceres_tpu_torch_c_api.so` and return its path.
    The shim puts this package's parent directory and this interpreter's
    site-packages on the embedded interpreter's path."""
    root = str(Path(__file__).resolve().parent.parent)
    sites = ":".join(dict.fromkeys([*site.getsitepackages(), sysconfig.get_paths()["purelib"],
                                    sysconfig.get_paths()["platlib"]]))
    defines = [f"-DCTT_PACKAGE_ROOT={json.dumps(root)}", f"-DCTT_SITE_DIRS={json.dumps(sites)}"]
    return cuda_lib.build_host(SHIM_SOURCE, SHIM_NAME, [*defines, *_python_link_flags()])


def link_c_program(source, out, shim=None) -> Path:
    """Compile and link a C program (e.g. examples/curve_fitting.c) against
    the shim (built if not given) with $CC, cc or gcc; returns the binary's
    path. Raises with the compiler's output on an error."""
    shim = Path(shim or build_shim())
    cc = shutil.which(os.environ.get("CC") or "cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler on PATH ($CC, cc or gcc)")
    proc = subprocess.run(
        [cc, "-O2", "-o", str(out), str(source), f"-L{shim.parent}", f"-l:{shim.name}", "-lm",
         f"-Wl,-rpath,{shim.parent}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed on {source} (rc {proc.returncode}):\n{proc.stdout[-4000:]}")
    return Path(out)
