"""Kernel B1: fused Snavely evaluation of one signature group.

Replaces `ceres_tpu/pallas_eval.py` GroupKernel (the kernel launched at
pallas_eval.py:571) for the Snavely 9+3 functor. One CUDA thread per
observation (csrc/eval_snavely.cu): it gathers its camera and point rows
from the [cnt, s] state tables (the gather_T of
evaluator._group_eval_pallas:182-220, fused), computes the residual and its
2x9 / 2x3 Jacobians by a hand-derived chain (rotation, translation,
projection, distortion: each derivative formed once, one reciprocal per
denominator, one sincos), applies TrivialLoss or Huber(a), the Triggs
correction exactly as `_lane_corrector`, and writes res [2, n], jac0 [18, n],
jac1 [6, n] (row rr*t + j, as pallas_eval.py:514-524) plus a per-block cost
partial; a second launch sums the partials in a fixed order (no atomics).
The residual-only launch is an instantiation of its own, without the
derivative code.

On CPU tensors the plain version runs: the torch.func path plus the gather,
the loss and correct_batched (evaluator.evaluate_batch).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .loss import HuberLoss, TrivialLoss

BLOCK = 256  # threads per block of the evaluation launch (eval_snavely.cu)


def loss_code(loss):
    """(kind, a) passed to the kernel: 0 no loss, 1 trivial, 2 Huber(a);
    None when the kernel has no code for this loss."""
    if loss is None:
        return 0, 0.0
    if isinstance(loss, TrivialLoss):
        return 1, 0.0
    if isinstance(loss, HuberLoss):
        return 2, float(loss.a)
    return None


def eligible(meta, dtype, apply_loss) -> bool:
    """True when the group is the Snavely functor in the shape the kernel
    serves: tag, residual count, Euclidean (9, 3) blocks, one [n, 2] data
    leaf, a loss it has code for, float32/float64."""
    cf = meta.cost_function
    if getattr(cf, "kernel", None) != "snavely" or cf.num_residuals != 2:
        return False
    if tuple(pm.size for pm in meta.positions) != (9, 3):
        return False
    if any(pm.manifold is not None for pm in meta.positions):
        return False
    if dtype not in (torch.float32, torch.float64):
        return False
    return loss_code(meta.loss if apply_loss else None) is not None


def snavely_evaluate_plain(tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian):
    from .evaluator import evaluate_batch
    from .examples.snavely import snavely_reprojection_error

    params = (tbl0[rows0], tbl1[rows1])
    return evaluate_batch(
        snavely_reprojection_error, params, (obs,), (None, None), loss, with_jacobian
    )


def snavely_evaluate(tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian):
    """Evaluate the Snavely group: camera table tbl0 [cnt0, 9] with rows0
    [n], point table tbl1 [cnt1, 3] with rows1 [n], observations obs
    [n, 2]. Returns (cost [], res [2, n], (jac0 [18, n], jac1 [6, n]) or ())."""
    if tbl0.device.type == "cpu":
        return snavely_evaluate_plain(tbl0, rows0, tbl1, rows1, obs, loss, with_jacobian)
    dev, dt = tbl0.device, tbl0.dtype
    n = rows0.shape[0]
    code = loss_code(loss)
    if code is None:
        raise ValueError(f"snavely_evaluate: no kernel code for loss {loss!r}")
    cuda_lib.require("tbl0", tbl0, dt, (tbl0.shape[0], 9), dev)
    cuda_lib.require("tbl1", tbl1, dt, (tbl1.shape[0], 3), dev)
    cuda_lib.require("rows0", rows0, torch.int32, (n,), dev)
    cuda_lib.require("rows1", rows1, torch.int32, (n,), dev)
    cuda_lib.require("obs", obs, dt, (n, 2), dev)
    res = torch.empty((2, n), dtype=dt, device=dev)
    jac0 = jac1 = None
    if with_jacobian:
        jac0 = torch.empty((18, n), dtype=dt, device=dev)
        jac1 = torch.empty((6, n), dtype=dt, device=dev)
    partials = torch.empty(((n + BLOCK - 1) // BLOCK,), dtype=dt, device=dev)
    cost = torch.empty((), dtype=dt, device=dev)
    fn = cuda_lib.kernel_fn("ctt_eval_snavely", dt)
    rc = fn(
        cuda_lib.ptr(tbl0), cuda_lib.ptr(rows0), cuda_lib.ptr(tbl1),
        cuda_lib.ptr(rows1), cuda_lib.ptr(obs), n, code[0], code[1],
        int(with_jacobian), cuda_lib.ptr(res), cuda_lib.ptr(jac0),
        cuda_lib.ptr(jac1), cuda_lib.ptr(partials), cuda_lib.ptr(cost),
        cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "eval_snavely")
    cuda_lib.count("eval_snavely")
    return cost, res, ((jac0, jac1) if with_jacobian else ())
