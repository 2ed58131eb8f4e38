"""Kernels B2 and B3: the camera-side Jacobian products.

Replace `ceres_tpu/pallas_onehot.py` (`gather_contract` / `contract_reduce`).
For a position on the "onehot" plan (BA cameras), with jac [r*t, n] the
position's Jacobian leaf and rows [n] its class rows:

  B2 gather_contract: out[i, l] = sum_j jac[i*t+j, l] * table[j, rows[l]]
      (F·y; the last table column is the dump column of constant blocks
      and gathers zero)
  B3 contract_reduce: out[j, c] = sum_{slots k of c} sum_i twin[i*t+j, k] * u[i, perm[k]]
      (Fᵀu into the [t, ncols] class table; with u=None it is the plain
      segmented sum of the twin's rows, r=1 — reduce_T's onehot plan)

B2 reads the leaf in lane order. B3 reads the leaf's twin: a copy in the
slot order of the padded camera CSR (program.camera_layout,
jacobian.make_twin), where each camera's observations are contiguous. One
block per chunk of a camera's run and a fixed-order combine of the chunks
make it bitwise deterministic without atomics (the JAX package's decision 3
in docs/architecture.md). On CPU tensors both run their plain PyTorch
versions below, on the same inputs; on CUDA tensors they launch the kernels
in csrc/gather_reduce.cu or raise.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def gather_contract_plain(jac, rows, table_t, r):
    rt, n = jac.shape
    t = rt // r
    dump = table_t.shape[1] - 1
    live = rows < dump
    y = table_t[:, torch.where(live, rows, torch.zeros_like(rows))]
    y = torch.where(live[None, :], y, torch.zeros_like(y))
    return (jac.reshape(r, t, n) * y[None]).sum(dim=1)


def gather_contract(jac, rows, table_t, r):
    """F·y for a onehot-plan position: [r, n] from jac [r*t, n], rows [n]
    int32, table_t [t, ncols] whose last column is the dump column."""
    if jac.device.type == "cpu":
        return gather_contract_plain(jac, rows, table_t, r)
    rt, n = jac.shape
    t = rt // r
    ncols = table_t.shape[1]
    cuda_lib.require("jac", jac)
    cuda_lib.require("rows", rows, torch.int32, (n,), jac.device)
    cuda_lib.require("table_t", table_t, jac.dtype, (t, ncols), jac.device)
    out = torch.empty((r, n), dtype=jac.dtype, device=jac.device)
    fn = cuda_lib.kernel_fn("ctt_gather_contract", jac.dtype)
    rc = fn(
        cuda_lib.ptr(jac), cuda_lib.ptr(rows), cuda_lib.ptr(table_t),
        n, r, t, ncols, cuda_lib.ptr(out), cuda_lib.stream(jac.device),
    )
    cuda_lib.check(rc, "gather_contract")
    cuda_lib.count("gather_contract")
    return out


def contract_reduce_plain(twin, layout, u, r):
    """B3's plain version, on the kernel's inputs."""
    rt, n_pad = twin.shape
    t = rt // r
    x = twin.reshape(r, t, n_pad)
    if u is None:
        contrib = x.sum(dim=0)
    else:
        live = layout.perm >= 0
        us = u[:, layout.perm.clamp(min=0)]
        contrib = (x * torch.where(live[None, :], us, torch.zeros_like(us))[:, None, :]).sum(dim=0)
    out = torch.zeros((t, len(layout.offsets) - 1), dtype=twin.dtype, device=twin.device)
    return out.index_add_(1, layout.slot_row, contrib)


def contract_reduce(twin, layout, u, r):
    """Fᵀu for a onehot-plan position: [t, ncols] from its twin [r*t, n_pad]
    (the leaf in the slot order of `layout`, a program.CameraLayout; zero on
    padding), and u [r, n] in lane order (or None with r == 1: the
    segmented sum of the twin's rows). The dump column (constant blocks) is
    produced; callers drop it."""
    if twin.device.type == "cpu":
        return contract_reduce_plain(twin, layout, u, r)
    rt, n_pad = twin.shape
    t = rt // r
    ncols = len(layout.offsets) - 1
    if u is None and r != 1:
        raise ValueError("contract_reduce: u=None needs r == 1")
    dev = twin.device
    cuda_lib.require("twin", twin, None, (r * t, layout.perm.shape[0]), dev)
    cuda_lib.require("perm", layout.perm, torch.int32, None, dev)
    cuda_lib.require("chunk_start", layout.chunk_start, torch.int32, None, dev)
    cuda_lib.require("row_chunks", layout.row_chunks, torch.int32, (ncols + 1,), dev)
    n = 0
    if u is not None:
        n = u.shape[1]
        cuda_lib.require("u", u, twin.dtype, (r, n), dev)
    nchunks = layout.num_chunks
    partial = torch.empty((t, nchunks), dtype=twin.dtype, device=dev)
    out = torch.empty((t, ncols), dtype=twin.dtype, device=dev)
    fn = cuda_lib.kernel_fn("ctt_contract_reduce", twin.dtype)
    rc = fn(
        cuda_lib.ptr(twin), cuda_lib.ptr(layout.perm), cuda_lib.ptr(layout.chunk_start),
        cuda_lib.ptr(layout.row_chunks), cuda_lib.ptr(u), n, n_pad, r, t, nchunks, ncols,
        cuda_lib.ptr(partial), cuda_lib.ptr(out), cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "contract_reduce")
    cuda_lib.count("contract_reduce")
    return out
