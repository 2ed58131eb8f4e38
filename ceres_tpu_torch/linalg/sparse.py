"""Sparse direct solvers on the host (scipy), with iterative refinement.

Port of `ceres_tpu.linalg.sparse` (reference: SparseNormalCholeskySolver,
sparse_normal_cholesky_solver.cc over SuiteSparse, iterative_refiner.cc,
and subset_preconditioner.cc:68-115). The reference's sparse backends are
CPU libraries, and so are these: the Jacobian crosses from the device to
the host once per factorization, in ONE read through utils.graphs.read
(counted in `num_device_reads`), scipy's SuperLU factors JᵀJ + D² (or
QᵀQ + D² for SUBSET) in float64, and the solution goes back to the device.
The evaluation, the Jacobian, the PCG and the model cost stay on the
device. The factorizations are float64 whatever the working dtype, and
`use_mixed_precision_solves` changes nothing here, as in the JAX package.

Each host factorization records into the current sink
(utils.execution_summary.record; in a solve, its summary's):
its read, with the seconds (the wait for the device included) and the
bytes, and its factorization and solve, with the host seconds.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..utils.execution_summary import record
from ..utils.graphs import read


def _host_garrs(program):
    """The Program's row tables as CPU tensors, for a host BlockJacobian."""
    return program.cached(
        "host_garrs",
        lambda p: [
            {"t_rows": tuple(torch.as_tensor(t) for t in idx["t_rows"]), "csr": {}}
            for idx in p.group_idx
        ],
    )


def host_crs(jac, *extra):
    """The (lazily scaled) Jacobian as a float64 CRS triple on the host,
    and each tensor of `extra` as float64 numpy, from one read of the
    device. Returns ((values, col_indices, row_pointers), extras, bytes
    read)."""
    from ..jacobian import BlockJacobian

    program = jac.program
    free = [
        [program.groups[gi].positions[pos].t_cls >= 0 for pos in jac.positions[gi]]
        for gi in range(len(jac.jac_groups))
    ]
    parts = [
        leaf.reshape(-1)
        for jacs, keep in zip(jac.jac_groups, free)
        for leaf, k in zip(jacs, keep)
        if k
    ]
    if jac.col_scale is not None:
        parts.append(jac.col_scale)
    parts += [e.reshape(-1) for e in extra]
    flat = torch.cat(parts)
    nbytes = flat.numel() * flat.element_size()
    host = read(flat)

    off = 0

    def take(n):
        nonlocal off
        off += n
        return host[off - n : off]

    groups = []
    for jacs, keep in zip(jac.jac_groups, free):
        groups.append(tuple(
            take(leaf.numel()).reshape(leaf.shape) if k else host[:0] for leaf, k in zip(jacs, keep)
        ))
    scale = take(jac.col_scale.numel()) if jac.col_scale is not None else None
    extras = [take(e.numel()).reshape(e.shape).double().numpy() for e in extra]
    host_jac = BlockJacobian(
        program, tuple(groups), _host_garrs(program), positions=jac.positions, col_scale=scale
    )
    vals, cols, row_ptr = host_jac.to_crs()
    return (np.asarray(vals, dtype=np.float64), cols, row_ptr), extras, nbytes


def solve_sparse_normal_cholesky(
    jac, res_groups, grad, dsq, refinement_iterations: int = 2
):
    """Solve (JᵀJ + diag(dsq)) step = -grad with a host sparse factorization
    and iterative refinement (ceres_tpu/linalg/sparse.py:26-53). The
    Jacobian, dsq and grad cross to the host in one read; the step comes
    back as a tensor on grad's device, in grad's dtype. Its read and
    factorization are recorded in the current sink."""
    t0 = time.perf_counter()
    (vals, cols, row_ptr), (dsq_h, grad_h), nbytes = host_crs(jac, dsq, grad)
    t1 = time.perf_counter()
    record("SparseCholesky::Read", t1 - t0, nbytes=nbytes)
    n = jac.num_cols
    j = sp.csr_matrix((vals, cols, row_ptr), shape=(jac.num_rows, n))
    a = (j.T @ j).tocsc() + sp.diags(dsq_h)
    rhs = -grad_h
    solver = spla.splu(a.tocsc())
    x = solver.solve(rhs)
    # iterative refinement (iterative_refiner.cc SolveRefine)
    for _ in range(refinement_iterations):
        r = rhs - a @ x
        x = x + solver.solve(r)
    record("SparseCholesky::Factorize", time.perf_counter() - t1)
    return torch.as_tensor(x, dtype=grad.dtype, device=grad.device)


class SubsetPreconditioner:
    """M = QᵀQ + diag(dsq), Q = the user's residual rows of J
    (ceres_tpu/linalg/sparse.py:56-92): factored on the host once per step;
    each application reads its vector from the device (one counted read),
    solves on the host and sends the result back, as the JAX package's
    `jax.pure_callback` does and the reference's
    RightMultiplyAndAccumulate -> sparse_cholesky_->Solve."""

    def __init__(self, jac, subset_rows, dsq):
        t0 = time.perf_counter()
        (vals, cols, row_ptr), (dsq_h,), nbytes = host_crs(jac, dsq)
        t1 = time.perf_counter()
        record("SubsetPreconditioner::Read", t1 - t0, nbytes=nbytes)
        n = jac.num_cols
        j = sp.csr_matrix((vals, cols, row_ptr), shape=(jac.num_rows, n))
        q = j[np.asarray(subset_rows)]
        a = (q.T @ q).tocsc() + sp.diags(dsq_h)
        self._solver = spla.splu(a)
        record("SubsetPreconditioner::Factorize", time.perf_counter() - t1)

    def __call__(self, r):
        t0 = time.perf_counter()
        x = read(r).double().numpy()
        y = torch.as_tensor(self._solver.solve(x), dtype=r.dtype, device=r.device)
        record(
            "SubsetPreconditioner::Apply", time.perf_counter() - t0,
            nbytes=r.numel() * r.element_size(),
        )
        return y
