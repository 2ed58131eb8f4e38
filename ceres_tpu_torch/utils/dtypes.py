"""Precision and device policy.

The reference runs fp64 end to end. The port defaults to float64 (the
correctness baseline the CPU tests use) and takes float32 on request
(`SolverOptions.dtype`), which is the fast path on the card.

`resolve_device` is the one place the package selects its device. With no
device named it picks the card and raises when none is visible: the port
never falls back to the CPU on its own; the CPU runs only where the caller
names it. It also pins every float32 matrix product and convolution to full
precision: TF32 keeps ~3 decimal digits, and the JAX package was bitten by
exactly that class of bug when a reduced-precision matmul stood in for a
gather (ceres_tpu/jacobian.py:81-100, ~4e-3 quantization of gathered values).
"""

from __future__ import annotations

import torch


def default_dtype():
    """Solver working dtype when SolverOptions.dtype is None."""
    return torch.float64


def resolve_device(device=None) -> torch.device:
    """torch.device for a solve: the given one, else the card; raises
    RuntimeError when no device is named and no card is visible. Turns TF32
    off for matmuls and cuDNN either way."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)
