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

B2 reads the leaf in lane order: on bfloat16 leaves 16 bytes of a leaf
row per thread, its table from shared memory (`gather_branch`); else one
lane per thread, as its first version. B3 reads the leaf's twin: a copy in the
slot order of the padded camera CSR (program.camera_layout,
jacobian.make_twin), where each camera's observations are contiguous; on
bfloat16 twins 16 bytes of a twin row per thread (8 consecutive slots),
which needs the twin and the layout's perm 16-byte aligned (every twin the
port makes is; a misaligned one raises). One
block per chunk of a camera's run and a fixed-order combine of the chunks
make it bitwise deterministic without atomics (the JAX package's decision 3
in docs/architecture.md). On CPU tensors both run their plain PyTorch
versions below, on the same inputs; on CUDA tensors they launch the kernels
in csrc/gather_reduce.cu or raise.

Leaves may be float32, float64 or bfloat16 (the mixed-precision solves). On
bfloat16 leaves the table, u and the output are float32, the table (B2) or
u (B3) is rounded to bfloat16 (`leaf_operand`) as the TPU kernels read it
at leaf precision, and every product and sum is float32. The TPU kernel of
B3 also rounds its products and their sum over r to bfloat16
(pallas_onehot.py:159-161); here a product of two bfloat16 values is exact
in float32, a deliberate deviation toward precision.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def leaf_operand(x, leaf_dtype):
    """A vector operand of products with leaves of `leaf_dtype`: for bfloat16
    leaves x rounded to bfloat16 (through float32, as the kernels round it)
    and held in float32, so that each product with a leaf is exact in
    float32 (csrc/leaf.cuh); otherwise x itself."""
    if leaf_dtype != torch.bfloat16:
        return x
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def widen(leaf):
    """A leaf in its products' dtype: bfloat16 widened (exactly) to float32."""
    return leaf.to(torch.float32) if leaf.dtype == torch.bfloat16 else leaf


# B2's shared-memory kernel (and B4's bfloat16 point pass): the table's
# bytes that one block may stage in shared memory. An H100 block may use 227 KB (232,448 bytes) of it, as
# dynamic shared memory after cudaFuncSetAttribute (csrc/gather_reduce.cu);
# one kilobyte of that is left for the 16 bytes of alignment slack and the
# kernel's own barrier.
SHARED_TABLE_MAX_BYTES = 232_448 - 1024


def table_fits(t, ncols):
    """Whether a [t, ncols] float32 camera table (bfloat16 leaves meet a
    float32 table) fits one block's shared memory, for B2 and B4's point
    pass (csrc/smem_table.cuh table_fits): BAL-1778's 9 x 1,779 (64 KB)
    does, BAL-13682's 9 x 13,683 (493 KB) not."""
    return t * ncols * 4 <= SHARED_TABLE_MAX_BYTES


def gather_branch(t, ncols, leaf_dtype):
    """B2's branch: "shared" (the table staged in shared memory, 16 bytes
    of leaf row per thread) for bfloat16 leaves whose table fits, else
    "global" (the first version's kernel, one lane per thread). The
    shared-memory kernel exists for bfloat16 leaves only: on the H100 at
    BAL-1778 it beat the first version there and lost to it on float32
    and float64 leaves (PERF.md §6)."""
    shared = leaf_dtype == torch.bfloat16 and table_fits(t, ncols)
    return "shared" if shared else "global"


# B3 and B4's slot pass on bfloat16 twins run one block per piece of 256
# slots of a chunk and write one partial sum per piece (csrc: kPieceSlots,
# kPieces = 2048 / 256), which their combine adds in order.
PIECE_SLOTS = 256


def chunk_pieces(leaf_dtype):
    """The partial sums per chunk that B3 and B4's slot pass write on twins
    of `leaf_dtype`: 8 on bfloat16 (the kernels take chunks of 2048
    slots), else 1."""
    from .program import TWIN_CHUNK

    if leaf_dtype != torch.bfloat16:
        return 1
    if TWIN_CHUNK != 2048:
        raise ValueError(f"the bfloat16 B3/B4 take chunks of 2048 slots, not {TWIN_CHUNK}")
    return TWIN_CHUNK // PIECE_SLOTS


def gather_contract_plain(jac, rows, table_t, r):
    rt, n = jac.shape
    t = rt // r
    dump = table_t.shape[1] - 1
    live = rows < dump
    y = table_t[:, torch.where(live, rows, torch.zeros_like(rows))]
    y = torch.where(live[None, :], y, torch.zeros_like(y))
    return (widen(jac).reshape(r, t, n) * leaf_operand(y, jac.dtype)[None]).sum(dim=1)


def gather_contract(jac, rows, table_t, r, branch=None):
    """F·y for a onehot-plan position: [r, n] from jac [r*t, n], rows [n]
    int32, table_t [t, ncols] whose last column is the dump column; table
    and output in cuda_lib.vector_dtype(jac.dtype). `branch` ("shared" or
    "global", default `gather_branch`) picks the kernel on bfloat16
    leaves; both give bitwise the same output."""
    if jac.device.type == "cpu":
        return gather_contract_plain(jac, rows, table_t, r)
    rt, n = jac.shape
    t = rt // r
    ncols = table_t.shape[1]
    vdt = cuda_lib.vector_dtype(jac.dtype)
    branch = branch or gather_branch(t, ncols, jac.dtype)
    if branch not in ("shared", "global") or branch == "shared" and (
            jac.dtype != torch.bfloat16 or not table_fits(t, ncols)):
        raise ValueError(f"gather_contract: branch {branch!r} for {jac.dtype} leaves and a "
                         f"[{t}, {ncols}] table")
    cuda_lib.require("jac", jac)
    cuda_lib.require("rows", rows, torch.int32, (n,), jac.device)
    cuda_lib.require("table_t", table_t, vdt, (t, ncols), jac.device)
    out = torch.empty((r, n), dtype=vdt, device=jac.device)
    prefix = "ctt_gather_contract_shared" if branch == "shared" else "ctt_gather_contract"
    fn = cuda_lib.kernel_fn(prefix, jac.dtype)
    rc = fn(
        cuda_lib.ptr(jac), cuda_lib.ptr(rows), cuda_lib.ptr(table_t),
        n, r, t, ncols, cuda_lib.ptr(out), cuda_lib.stream(jac.device),
    )
    cuda_lib.check(rc, "gather_contract")
    cuda_lib.count(cuda_lib.counter("gather_contract", jac.dtype))
    return out


def contract_reduce_plain(twin, layout, u, r):
    """B3's plain version, on the kernel's inputs."""
    rt, n_pad = twin.shape
    t = rt // r
    x = widen(twin).reshape(r, t, n_pad)
    if u is None:
        contrib = x.sum(dim=0)
    else:
        live = layout.perm >= 0
        us = leaf_operand(u, twin.dtype)[:, layout.perm.clamp(min=0)]
        contrib = (x * torch.where(live[None, :], us, torch.zeros_like(us))[:, None, :]).sum(dim=0)
    out = torch.zeros((t, len(layout.offsets) - 1), dtype=x.dtype, device=twin.device)
    return out.index_add_(1, layout.slot_row, contrib)


def contract_reduce(twin, layout, u, r):
    """Fᵀu for a onehot-plan position: [t, ncols] from its twin [r*t, n_pad]
    (the leaf in the slot order of `layout`, a program.CameraLayout; zero on
    padding), and u [r, n] in lane order (or None with r == 1: the
    segmented sum of the twin's rows); u and the output in
    cuda_lib.vector_dtype(twin.dtype). The dump column (constant blocks) is
    produced; callers drop it."""
    if twin.device.type == "cpu":
        return contract_reduce_plain(twin, layout, u, r)
    rt, n_pad = twin.shape
    t = rt // r
    ncols = len(layout.offsets) - 1
    if u is None and r != 1:
        raise ValueError("contract_reduce: u=None needs r == 1")
    dev = twin.device
    vdt = cuda_lib.vector_dtype(twin.dtype)
    cuda_lib.require("twin", twin, None, (r * t, layout.perm.shape[0]), dev)
    cuda_lib.require("perm", layout.perm, torch.int32, None, dev)
    cuda_lib.require("chunk_start", layout.chunk_start, torch.int32, None, dev)
    cuda_lib.require("row_chunks", layout.row_chunks, torch.int32, (ncols + 1,), dev)
    n = 0
    if u is not None:
        n = u.shape[1]
        cuda_lib.require("u", u, vdt, (r, n), dev)
    nchunks = layout.num_chunks
    partial = torch.empty((t, nchunks * chunk_pieces(twin.dtype)), dtype=vdt, device=dev)
    out = torch.empty((t, ncols), dtype=vdt, device=dev)
    fn = cuda_lib.kernel_fn("ctt_contract_reduce", twin.dtype)
    rc = fn(
        cuda_lib.ptr(twin), cuda_lib.ptr(layout.perm), cuda_lib.ptr(layout.chunk_start),
        cuda_lib.ptr(layout.row_chunks), cuda_lib.ptr(u), n, n_pad, r, t, nchunks, ncols,
        cuda_lib.ptr(partial), cuda_lib.ptr(out), cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "contract_reduce")
    cuda_lib.count(cuda_lib.counter("contract_reduce", twin.dtype))
    return out


# -- over a batch of columns: the covariance's batched PCG ----------------- #
#
# The JAX package runs one PCG per requested covariance column under
# jax.vmap (ceres_tpu/covariance.py:212), which gives the TPU kernels a
# table (B2) or u (B3) with a leading column axis over one leaf. These are
# that contract, with the column axis innermost in memory ("lane-major"):
# u and B2's output are logical [k, r, n] over [n, r, k] memory, tables
# logical [k, t, ncols] over [ncols, t, k], so a lane's (or a camera's)
# values for all k columns are one contiguous row. Both kernels walk the
# twin in camera order, reading the twin once; each column's output is
# bitwise the single-vector kernel's on that column (the same sums in the
# same order, csrc/gather_reduce.cu).


def lanes_major(x):
    """x [a, b, c] in the batched layout: a .permute(2, 1, 0) view of a
    contiguous [c, b, a] tensor (x itself when it is one already)."""
    return x.permute(2, 1, 0).contiguous().permute(2, 1, 0)


def gather_contract_batched_plain(jac, rows, table_t, r):
    """The batched B2's plain version: gather_contract_plain per column,
    in the kernel's layout (lane-major [k, r, n])."""
    return torch.stack([gather_contract_plain(jac, rows, tab, r).T for tab in table_t],
                       dim=2).permute(2, 1, 0)


def gather_contract_batched(jac, rows, table_t, r, twin, layout):
    """F·Y for k columns of a onehot-plan position: lane-major [k, r, n]
    from jac [r*t, n] (or, on the card, its twin [r*t, n_pad] in the slot
    order of `layout`, a program.CameraLayout over the table's ncols),
    rows [n] int32 and lane-major table_t [k, t, ncols] (the last column
    of each the dump column); table and output in
    cuda_lib.vector_dtype(jac.dtype)."""
    if jac.device.type == "cpu":
        return gather_contract_batched_plain(jac, rows, table_t, r)
    rt, n = jac.shape
    t = rt // r
    k, _, ncols = table_t.shape
    dev = jac.device
    vdt = cuda_lib.vector_dtype(jac.dtype)
    _require_layout(twin, layout, jac.dtype, rt, ncols, n, dev)
    cuda_lib.require("slot_row", layout.slot_row, torch.int32, (layout.perm.shape[0],), dev)
    cuda_lib.require("table_t", table_t, vdt, (k, t, ncols), dev, lanes_major=True)
    out = torch.empty((n, r, k), dtype=vdt, device=dev)
    fn = cuda_lib.kernel_fn("ctt_gather_contract_batched", jac.dtype)
    rc = fn(
        cuda_lib.ptr(twin), cuda_lib.ptr(layout.perm), cuda_lib.ptr(layout.chunk_start),
        cuda_lib.ptr(layout.slot_row), cuda_lib.ptr(table_t), layout.perm.shape[0], r, t, ncols,
        k, layout.num_chunks, cuda_lib.ptr(out), cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "gather_contract_batched")
    cuda_lib.count(cuda_lib.counter("gather_contract_batched", jac.dtype))
    return out.permute(2, 1, 0)


def _require_layout(twin, layout, leaf_dtype, rt, ncols, n, dev):
    """The twin and camera layout that the batched kernels walk, over n
    lanes."""
    from .program import TWIN_CHUNK

    if twin is None or layout is None:
        raise ValueError("the batched B2/B3 on a card need the leaf's twin and camera layout")
    if TWIN_CHUNK != 2048:  # csrc/gather_reduce.cu kChunkSlots
        raise ValueError(f"the batched B2/B3 take chunks of 2048 slots, not {TWIN_CHUNK}")
    if len(layout.offsets) - 1 != ncols:
        raise ValueError(f"layout: {len(layout.offsets) - 1} columns, expected {ncols}")
    if layout.perm.shape[0] - layout.pad.shape[0] != n:
        raise ValueError(f"layout: {layout.perm.shape[0] - layout.pad.shape[0]} lanes, "
                         f"expected {n}")
    cuda_lib.require("twin", twin, leaf_dtype, (rt, layout.perm.shape[0]), dev)
    if twin.data_ptr() % 16:
        raise ValueError("twin: data must be 16-byte aligned")
    cuda_lib.require("perm", layout.perm, torch.int32, None, dev)
    if layout.perm.data_ptr() % 16:
        raise ValueError("perm: data must be 16-byte aligned")
    cuda_lib.require("chunk_start", layout.chunk_start, torch.int32, None, dev)
    cuda_lib.require("row_chunks", layout.row_chunks, torch.int32, (ncols + 1,), dev)


def contract_reduce_batched_plain(twin, layout, u, r):
    """The batched B3's plain version: contract_reduce_plain per column,
    in the kernel's layout (lane-major [k, t, ncols])."""
    return torch.stack([contract_reduce_plain(twin, layout, uc, r).T for uc in u],
                       dim=2).permute(2, 1, 0)


def contract_reduce_batched(twin, layout, u, r):
    """Fᵀu for k columns of a onehot-plan position: lane-major [k, t, ncols]
    from its twin [r*t, n_pad] and lane-major u [k, r, n]; u and the output
    in cuda_lib.vector_dtype(twin.dtype). The dump column is produced."""
    if twin.device.type == "cpu":
        return contract_reduce_batched_plain(twin, layout, u, r)
    rt, n_pad = twin.shape
    t = rt // r
    k = u.shape[0]
    ncols = len(layout.offsets) - 1
    dev = twin.device
    vdt = cuda_lib.vector_dtype(twin.dtype)
    n = layout.perm.shape[0] - layout.pad.shape[0]
    _require_layout(twin, layout, twin.dtype, rt, ncols, n, dev)
    cuda_lib.require("u", u, vdt, (u.shape[0], r, n), dev, lanes_major=True)
    nchunks = layout.num_chunks
    partial = torch.empty((nchunks, t, k), dtype=vdt, device=dev)
    out = torch.empty((ncols, t, k), dtype=vdt, device=dev)
    fn = cuda_lib.kernel_fn("ctt_contract_reduce_batched", twin.dtype)
    rc = fn(
        cuda_lib.ptr(twin), cuda_lib.ptr(layout.perm), cuda_lib.ptr(layout.chunk_start),
        cuda_lib.ptr(layout.row_chunks), cuda_lib.ptr(u), n_pad, r, t, k, nchunks, ncols,
        cuda_lib.ptr(partial), cuda_lib.ptr(out), cuda_lib.stream(dev),
    )
    cuda_lib.check(rc, "contract_reduce_batched")
    cuda_lib.count(cuda_lib.counter("contract_reduce_batched", twin.dtype))
    return out.permute(2, 1, 0)
