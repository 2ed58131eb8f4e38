"""Converters between the JAX package's host arrays and the port's tensors.

Both packages build from the same numpy `BalProblem` (or image and
Fields-of-Experts prior), and the port's Program reproduces the JAX
Program's tables exactly, so a JAX state vector or index table means the
same thing in the port. These helpers carry such
arrays across (the parity tests use them); they take numpy, never JAX
arrays, so the port does not import JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _convert(x, device, dtype):
    if isinstance(x, dict):
        return {k: _convert(v, device, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_convert(v, device, dtype) for v in x)
    if x is None:
        return None
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int32, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def from_jax_program_arrays(np_arrays, device, dtype):
    """The JAX Program's `arrays()` pytree, already converted leaf by leaf to
    numpy, as port tensors: integer tables -> int32, float leaves -> dtype,
    the dict/list/tuple structure kept."""
    return _convert(np_arrays, torch.device(device), dtype)


def foe_model(model):
    """A Fields-of-Experts prior of the port (examples.denoising.FoEModel)
    from any object with its five fields (the JAX package's FoEModel, a
    loaded file), each copied through numpy, so that both packages build
    the same denoising problem from it."""
    from .examples.denoising import FoEModel

    return FoEModel(
        int(model.size),
        np.asarray(model.x_deltas).astype(int),
        np.asarray(model.y_deltas).astype(int),
        np.asarray(model.alphas, dtype=np.float64),
        np.asarray(model.filters, dtype=np.float64),
    )


def state_from_numpy(program, x, dtype=None):
    """A state vector of the JAX Program (numpy, [num_parameters]) as a
    tensor on the port Program's device."""
    x = np.asarray(x)
    if x.shape != (program.num_parameters,):
        raise ValueError(
            f"state has shape {x.shape}, Program has {program.num_parameters} parameters"
        )
    return torch.tensor(x, dtype=dtype or torch.float64, device=program.device)
