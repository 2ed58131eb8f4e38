"""Kernel B1: fused evaluation of one signature group.

Replaces `ceres_tpu/pallas_eval.py` GroupKernel (the kernel launched at
pallas_eval.py:571) for the Snavely functors, one instantiation per camera
model (csrc/eval_snavely.cu):
  - "snavely": the angle-axis camera, Euclidean (9, 3) blocks;
  - "snavely_quat": the quaternion camera [q(4) | t(3) | f k1 k2], (10, 3)
    blocks, on Quaternion x Euclidean(6) with the plus-Jacobian fused in
    (Jacobian columns in its 9-wide tangent space, GroupKernel's manifold
    branch, pallas_eval.py:306-314) or without a manifold (10 columns).
One CUDA thread per observation: it gathers its camera and point rows from
the [cnt, s] state tables (the gather_T of
evaluator._group_eval_pallas:182-220, fused), computes the residual and its
Jacobians by a hand-derived chain (rotation, translation, projection,
distortion: each derivative formed once, one reciprocal per denominator),
applies the loss by its code (`loss_code`) and the Triggs correction exactly
as `_lane_corrector`, and writes res [2, n], jac0 [2 t, n], jac1 [6, n] (row
rr*t + j, as pallas_eval.py:514-524) plus a per-block cost partial; a second
launch sums the partials in a fixed order (no atomics). The residual-only
launch is an instantiation of its own, without the derivative code.

Every other group whose functor, loss and manifolds functor_codegen.py can
generate (`functor_codegen.group_program`: any functor that traces to aten
ops with rules,
any loss whose rho is torch code, ComposedLoss and LossFunctionWrapper
included) takes B1's generic instantiation (`generic_evaluate`): the
generator fills the hand-written template csrc/eval_generic.cuh with the
group's functor, plus-Jacobians and rho, and the kernel evaluates it on
Jet<S, N> (N the group's total tangent), one thread per residual block,
with the same outputs, loss and correction as above, in one launch per
evaluation (the last block to finish sums the cost partials). A
functor with an analytic rule (an AnalyticCostFunction, alone or inside
a larger functor) gets the rule's Jacobian, never the Jet of its primal;
a numeric-diff one is not generated.
Groups sharing a structural signature (the K filter groups of a
Fields-of-Experts prior) share one build; their constants come in a
buffer. A group the generator cannot trace takes the torch.func path, as
the JAX package's group_kernel returns None for it.

On CPU tensors the plain version runs: the torch.func path plus the gather,
the plus-Jacobian chain, the loss and correct_batched
(evaluator.evaluate_batch).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_lib, functor_codegen
from .loss import (
    ArctanLoss,
    CauchyLoss,
    HuberLoss,
    ScaledLoss,
    SoftLOneLoss,
    TolerantLoss,
    TrivialLoss,
    TukeyLoss,
)
from .manifolds import EuclideanManifold, ProductManifold, QuaternionManifold

BLOCK = 256  # threads per block of the evaluation launch (eval_snavely.cu)
# the camera manifold of the quaternion model's fused plus-Jacobian
QUAT_CAMERA = ProductManifold(QuaternionManifold(), EuclideanManifold(6))
# the loss kinds of csrc/eval_snavely.cu (LossCode); kind 0 is no loss
_LOSS_KINDS = {
    TrivialLoss: 1, HuberLoss: 2, SoftLOneLoss: 3, CauchyLoss: 4, ArctanLoss: 5,
    TolerantLoss: 6, TukeyLoss: 7,
}


def loss_code(loss):
    """(kind, a, b, c, scale) passed to the kernel, or None when the kernel
    has no code for this loss. kind: 0 no loss, 1 Trivial, 2 Huber(a),
    3 SoftLOne(a), 4 Cauchy(a), 5 Arctan(a), 6 Tolerant(a, b), 7 Tukey(a);
    c is Tolerant's constant b log1p(exp(-a / b)) as loss.py forms it; a
    ScaledLoss around a coded loss (or around None: the trivial loss) folds
    in as the scale."""
    if loss is None:
        return 0, 0.0, 0.0, 0.0, 1.0
    scale = 1.0
    while isinstance(loss, ScaledLoss):
        scale *= float(loss.a)
        loss = loss.loss
        if loss is None:
            return 1, 0.0, 0.0, 0.0, scale
    kind = _LOSS_KINDS.get(type(loss))
    if kind is None:
        return None
    a = float(getattr(loss, "a", 0.0))
    b = float(getattr(loss, "b", 0.0))
    c = b * math.log1p(math.exp(-a / b)) if kind == 6 else 0.0
    return kind, a, b, c, scale


# kernel tag -> (camera ambient size, the camera manifolds it serves)
_MODELS = {"snavely": (9, (None,)), "snavely_quat": (10, (None, QUAT_CAMERA))}


def eligible(meta, dtype, apply_loss) -> bool:
    """True when the group is a Snavely functor in the shape the kernel
    serves: its tag, residual count, (9, 3) Euclidean blocks for
    "snavely", (10, 3) blocks with the quaternion product manifold or none
    on the camera for "snavely_quat", a loss it has a code for,
    float32/float64."""
    cf = meta.cost_function
    model = _MODELS.get(getattr(cf, "kernel", None))
    if model is None or cf.num_residuals != 2:
        return False
    amb, cam_manifolds = model
    if tuple(pm.size for pm in meta.positions) != (amb, 3):
        return False
    cam, pt = meta.positions
    if cam.manifold not in cam_manifolds or pt.manifold is not None:
        return False
    if dtype not in (torch.float32, torch.float64):
        return False
    return loss_code(meta.loss if apply_loss else None) is not None


def snavely_evaluate_plain(tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian, mask=None):
    from .evaluator import evaluate_batch
    from .examples.snavely import snavely_reprojection_error

    params = (tbl0[rows0], tbl1[rows1])
    return evaluate_batch(
        snavely_reprojection_error, params, (obs,), (None, None), loss, with_jacobian, mask
    )


def snavely_quat_evaluate_plain(tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian, manifold,
                                mask=None):
    from .evaluator import evaluate_batch
    from .examples.snavely import snavely_reprojection_error_with_quaternions

    params = (tbl0[rows0], tbl1[rows1])
    return evaluate_batch(
        snavely_reprojection_error_with_quaternions, params, (obs,),
        (QUAT_CAMERA if manifold else None, None), loss, with_jacobian, mask,
    )


def require_mask(mask, n, dtype, device):
    """Raise unless `mask` is None or a contiguous [n] tensor of the state's
    dtype on the launch's device (B1's mask_T operand)."""
    if mask is not None:
        cuda_lib.require("mask", mask, dtype, (n,), device)


def _launch(model, counter, amb, tan, tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian,
            mask=None):
    dev, dt = tbl0.device, tbl0.dtype
    n = rows0.shape[0]
    code = loss_code(loss)
    if code is None:
        raise ValueError(f"{counter}: no kernel code for loss {loss!r}")
    cuda_lib.require("tbl0", tbl0, dt, (tbl0.shape[0], amb), dev)
    cuda_lib.require("tbl1", tbl1, dt, (tbl1.shape[0], 3), dev)
    cuda_lib.require("rows0", rows0, torch.int32, (n,), dev)
    cuda_lib.require("rows1", rows1, torch.int32, (n,), dev)
    cuda_lib.require("obs", obs, dt, (n, 2), dev)
    require_mask(mask, n, dt, dev)
    res = torch.empty((2, n), dtype=dt, device=dev)
    jac0 = jac1 = None
    if with_jacobian:
        jac0 = torch.empty((2 * tan, n), dtype=dt, device=dev)
        jac1 = torch.empty((6, n), dtype=dt, device=dev)
    partials = torch.empty(((n + BLOCK - 1) // BLOCK,), dtype=dt, device=dev)
    cost = torch.empty((), dtype=dt, device=dev)
    fn = cuda_lib.kernel_fn("ctt_eval_snavely", dt)
    rc = fn(
        model, cuda_lib.ptr(tbl0), cuda_lib.ptr(rows0), cuda_lib.ptr(tbl1),
        cuda_lib.ptr(rows1), cuda_lib.ptr(obs), cuda_lib.ptr(mask), n, *code,
        int(with_jacobian), cuda_lib.ptr(res), cuda_lib.ptr(jac0),
        cuda_lib.ptr(jac1), cuda_lib.ptr(partials), cuda_lib.ptr(cost),
        cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, counter)
    cuda_lib.count(counter if mask is None else counter + "_masked")
    return cost, res, ((jac0, jac1) if with_jacobian else ())


def snavely_evaluate(tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian, mask=None):
    """Evaluate the angle-axis Snavely group: camera table tbl0 [cnt0, 9]
    with rows0 [n], point table tbl1 [cnt1, 3] with rows1 [n], observations
    obs [n, 2], and optionally the lane mask [n] of a sharded group (the
    JAX kernel's mask_T, pallas_eval.py:435-437: a lane whose mask is 0
    writes 0 to its residuals and Jacobian columns and adds nothing to the
    cost; None: every lane is real). Returns (cost [], res [2, n],
    (jac0 [18, n], jac1 [6, n]) or ())."""
    if tbl0.device.type == "cpu":
        return snavely_evaluate_plain(tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian, mask)
    return _launch(0, "eval_snavely", 9, 9, tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian,
                   mask)


def snavely_quat_evaluate(tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian, manifold,
                          mask=None):
    """Evaluate the quaternion Snavely group: camera table tbl0 [cnt0, 10]
    ([q | t | f k1 k2]), the rest as `snavely_evaluate`. With `manifold`
    the camera is on QUAT_CAMERA and jac0 is [18, n] in its tangent space;
    without, jac0 is [20, n]. Counted as eval_snavely_quat and
    eval_snavely_quat_nomanifold (a masked launch with "_masked" appended,
    as eval_snavely_masked)."""
    if tbl0.device.type == "cpu":
        return snavely_quat_evaluate_plain(
            tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian, manifold, mask
        )
    if manifold:
        return _launch(1, "eval_snavely_quat", 10, 9, tbl0, rows0, tbl1, rows1, obs, loss,
                       with_jacobian, mask)
    return _launch(2, "eval_snavely_quat_nomanifold", 10, 10, tbl0, rows0, tbl1, rows1, obs,
                   loss, with_jacobian, mask)


def group_evaluate(meta, tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian, mask=None):
    """The entry point of an eligible group's model."""
    if meta.cost_function.kernel == "snavely_quat":
        return snavely_quat_evaluate(
            tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian,
            meta.positions[0].manifold is not None, mask=mask,
        )
    return snavely_evaluate(tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian, mask=mask)


# ---------------------------------------------------------------------- #
# B1 generic: any functor the generator can trace
# ---------------------------------------------------------------------- #


def generic_block(n):
    """Threads per block of a generic launch over n residual blocks
    (eval_generic.cuh kWideLanes): 512 where the grid still has a block
    per SM of an H100 (n >= 132 * 512; a quarter of the cost partials and
    atomics of 128), else 128 (a small group over more SMs)."""
    return 512 if n >= 132 * 512 else 128


# the most blocks a generic launch takes (eval_generic.cuh kMaxBlocks): each
# strides over the lanes beyond, so the one-launch cost sum's atomics and
# final read stay bounded at any n
GENERIC_MAX_BLOCKS = 2048


def generic_blocks(n):
    """The blocks of a generic launch over n residual blocks, one cost
    partial each: ceil(n / generic_block(n)), at least 1 (that block writes
    the cost, 0 for n = 0) and at most GENERIC_MAX_BLOCKS."""
    return min(GENERIC_MAX_BLOCKS, max(1, -(-n // generic_block(n))))


def prepare_generic(program, arrays, dtype, extra_sources=()):
    """Build, all at once, the generic kernels of every group of a Program
    that is not served by the Snavely kernels, and `extra_sources` (the
    Evaluator's: B4 at its Program's shape, linalg/schur_kernels.py
    sy_sources), so that the solve finds them built; returns the nvcc
    seconds."""
    sources = list(extra_sources)
    for meta, garr in zip(program.groups, arrays["groups"]):
        if eligible(meta, dtype, True):
            continue
        prog = functor_codegen.group_program(meta, garr, dtype, True)
        if prog is not None:
            sources.append(prog.source)
    return cuda_lib.build_generated(sources) if sources else 0.0


def generic_evaluate(prog, meta, garr, state_2d, with_jacobian):
    """Evaluate a group through its generated program: garr the group's
    arrays (rows [n] int32 per position, data [n, ...] per data leaf) and
    state_2d the [cnt, size] state tables by class. Returns (cost [],
    res [r, n], tuple of [r * t_p, n] or ()), as `snavely_evaluate`, with
    the loss the program was traced with, in one launch; a sharded group's
    pad lanes are masked by garr["mask"] as there. On CPU tensors
    the plain version (evaluator.group_eval_plain) runs. Counted as
    eval_generic, eval_generic_analytic (the Jacobian of a functor with an
    analytic rule) or eval_generic_residual, with "_masked" appended for a
    masked launch."""
    if state_2d[0].device.type == "cpu":
        from .evaluator import group_eval_plain

        return group_eval_plain(meta, garr, state_2d, with_jacobian, prog.has_loss)
    tables = [state_2d[pm.a_cls] for pm in meta.positions]
    rows, data = garr["a_rows"], garr["data"]
    dev, dt = tables[0].device, prog.dtype
    n = rows[0].shape[0]
    checked = set()
    for p, (t, rr) in enumerate(zip(tables, rows)):
        if id(t) not in checked:  # the positions of one class share their table
            cuda_lib.require(f"table {p}", t, dt, (t.shape[0], prog.sizes[p]), dev)
            checked.add(id(t))
        cuda_lib.require(f"rows {p}", rr, torch.int32, (n,), dev)
    for q, d in enumerate(data):
        cuda_lib.require(f"data {q}", d, dt, (n, *prog.data_shapes[q]), dev)
    mask = garr.get("mask")
    require_mask(mask, n, dt, dev)
    res = torch.empty((prog.r, n), dtype=dt, device=dev)
    leaves = tuple(
        torch.empty((prog.r * t, n), dtype=dt, device=dev) for t in prog.tangents
    ) if with_jacobian else ()
    partials = torch.empty((generic_blocks(n),), dtype=dt, device=dev)
    cost = torch.empty((), dtype=dt, device=dev)
    ptrs = [t.data_ptr() for t in tables] + [r.data_ptr() for r in rows]
    ptrs += [d.data_ptr() for d in data] + [leaf.data_ptr() for leaf in leaves]
    ptrs += [0] * (len(tables) - len(leaves))
    ptrs.append(0 if mask is None else mask.data_ptr())
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    if prog.entry_point is None:
        prog.entry_point = cuda_lib.generated_fn(prog.source, dt)
    if dev not in prog.device_consts:  # the constant slots and the ticket, once per card
        prog.device_consts[dev] = torch.tensor(prog.consts or [0.0], dtype=dt, device=dev)
        prog.device_tickets[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    counter = ("eval_generic_analytic" if prog.has_rule else "eval_generic") if with_jacobian \
        else "eval_generic_residual"
    rc = prog.entry_point(
        int(with_jacobian), arr, cuda_lib.ptr(prog.device_consts[dev]), n,
        cuda_lib.ptr(res), cuda_lib.ptr(partials), cuda_lib.ptr(prog.device_tickets[dev]),
        cuda_lib.ptr(cost), cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, counter)
    cuda_lib.count(counter if mask is None else counter + "_masked")
    return cost, res, leaves
