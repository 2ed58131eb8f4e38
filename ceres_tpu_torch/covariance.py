"""Covariance estimation of the solution.

Port of `ceres_tpu.covariance` (reference: covariance.h, covariance_impl.cc):
the covariance of selected parameter-block pairs from the inverse of JᵀJ at
the solution, in tangent space (optionally lifted to ambient space through
the plus Jacobian). Three algorithms, as in the JAX package:

- DENSE_SVD: J densified, JᵀJ formed and eigendecomposed in float64 on the
  host (np.linalg.eigh), eigenvalues at or below
  min_reciprocal_condition_number · max thresholded, the null-space rule
  applied; for sizes where J densifies;
- SPARSE_QR: the Jacobian read to the host in one read
  (linalg/sparse.host_crs), SuperLU of JᵀJ, rank from |diag U|, solves for
  the requested blocks' columns only;
- ITERATIVE_PCG: every requested tangent column solved at once on the
  device by the batched PCG (linalg/cg.py, `batched=True`) over the
  matrix-free JᵀJ (`BlockJacobian.jtj_multiply_batched`: kernels B2 and B3
  over k columns on the onehot positions), block-Jacobi preconditioned, as
  the JAX package vmaps one PCG over the columns
  (ceres_tpu/covariance.py:165-231). The host reads one flag per PCG step
  and the solution once.

The Jacobian comes from the same evaluation path (and kernel B1) as the
solve's, with or without the loss (`apply_loss_function`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from . import cuda_lib
from .evaluator import Evaluator
from .linalg.cg import conjugate_gradients
from .linalg.preconditioners import BlockDiagSolver
from .linalg.sparse import host_crs
from .types import CovarianceAlgorithmType
from .utils.execution_summary import counts
from .utils.graphs import read


@dataclasses.dataclass
class CovarianceOptions:
    """reference: Covariance::Options (covariance.h:360-460); `device` and
    `dtype` as in SolverOptions (None: the card, float64)."""

    algorithm_type: CovarianceAlgorithmType = CovarianceAlgorithmType.DENSE_SVD
    min_reciprocal_condition_number: float = 1e-14
    null_space_rank: int = 0  # -1: drop all small eigenvalues
    apply_loss_function: bool = True
    # ITERATIVE_PCG controls: per-column relative residual tolerance and
    # PCG iteration cap (0 -> num_effective_parameters).
    iterative_tolerance: float = 1e-10
    iterative_max_iterations: int = 0
    device: Optional[object] = None
    dtype: Optional[torch.dtype] = None


class _ColumnSubsetMatrix:
    """Dense view of selected columns of the (symmetric) covariance, sliced
    like the full matrix (the SPARSE_QR and ITERATIVE_PCG results)."""

    def __init__(self, cols: np.ndarray, values: np.ndarray):
        self._col_map = {int(c): k for k, c in enumerate(cols)}
        self._values = values  # [n, len(cols)]

    def __getitem__(self, key):
        rows, cols = key
        try:
            col_idx = [self._col_map[c] for c in range(cols.start, cols.stop)]
        except KeyError as e:
            raise ValueError("covariance block was not requested in compute()") from e
        return self._values[rows, :][:, col_idx]


class Covariance:
    """reference: Covariance (covariance.h)."""

    def __init__(self, options: Optional[CovarianceOptions] = None):
        self.options = options or CovarianceOptions()
        self._cov = None  # tangent-space covariance (dense or column subset)
        self._program = None
        self._problem = None
        # ITERATIVE_PCG's last run: PCG steps per column, device reads,
        # seconds, and the kernel launches (cuda_lib) inside the PCG
        self.pcg_stats = None

    def compute(self, covariance_blocks: Sequence[tuple], problem) -> bool:
        """Compute covariance for the given (block_i, block_j) pairs.

        reference: Covariance::Compute. Returns False when JᵀJ is rank
        deficient beyond the allowed null space (ITERATIVE_PCG: on a PCG
        breakdown, or when a column hits the iteration cap, with a warning).
        """
        program = problem.compile(self.options.device)
        ev = Evaluator(program, self.options.dtype)
        _, _, jac, _ = ev.evaluate_groups(
            program.state_vector(ev.dtype), apply_loss=self.options.apply_loss_function
        )
        algo = self.options.algorithm_type
        if algo == CovarianceAlgorithmType.SPARSE_QR:
            ok = self._compute_sparse(jac, program, covariance_blocks)
        elif algo == CovarianceAlgorithmType.ITERATIVE_PCG:
            ok = self._compute_iterative(jac, program, covariance_blocks)
        else:
            ok = self._compute_dense(jac)
        if not ok:
            return False
        self._program = program
        self._problem = problem
        return True

    def _compute_dense(self, jac) -> bool:
        """DENSE_SVD with eigenvalue thresholding (covariance_impl.cc
        ComputeCovarianceValuesUsingDenseSVD; ceres_tpu/covariance.py:90-100)."""
        dense_j = read(jac.to_dense()).double().numpy()
        jtj = dense_j.T @ dense_j
        w, v = np.linalg.eigh(jtj)
        max_w = float(np.max(w)) if w.size else 0.0
        tol = self.options.min_reciprocal_condition_number * max_w
        rank_deficiency = int(np.sum(w <= tol))
        if self.options.null_space_rank >= 0 and rank_deficiency > self.options.null_space_rank:
            return False
        inv_w = np.where(w > tol, 1.0 / np.maximum(w, 1e-300), 0.0)
        self._cov = (v * inv_w) @ v.T
        return True

    def _compute_sparse(self, jac, program, covariance_blocks) -> bool:
        """SPARSE_QR: SuperLU of JᵀJ on the host, solves for the tangent
        columns the requested pairs touch, rank deficiency from the
        factor's diagonal (ceres_tpu/covariance.py:108-150)."""
        (vals, cols, row_ptr), _, _ = host_crs(jac)
        n = jac.num_cols
        j = sp.csr_matrix((vals, cols, row_ptr), shape=(jac.num_rows, n))
        jtj = (j.T @ j).tocsc()
        cols_wanted = self._wanted_cols(program, covariance_blocks)
        try:
            lu = spla.splu(jtj)
        except RuntimeError:
            return False  # singular factorization
        du = np.abs(lu.U.diagonal())
        max_d = float(du.max()) if du.size else 0.0
        rank_deficiency = int(np.sum(du <= self.options.min_reciprocal_condition_number * max_d))
        if self.options.null_space_rank >= 0 and rank_deficiency > self.options.null_space_rank:
            return False
        rhs = np.zeros((n, len(cols_wanted)))
        rhs[cols_wanted, np.arange(len(cols_wanted))] = 1.0
        self._cov = _ColumnSubsetMatrix(cols_wanted, lu.solve(rhs))
        return True

    def _wanted_cols(self, program, covariance_blocks) -> np.ndarray:
        """Union of tangent columns the requested block pairs touch."""
        wanted = set()
        for bi, bj in covariance_blocks:
            for b in (bi, bj):
                off = int(program.t_offsets[b])
                if off < 0:
                    raise ValueError(f"parameter block {b} is constant or removed")
                wanted.update(range(off, off + int(program.tangent_sizes[b])))
        return np.array(sorted(wanted), dtype=np.int64)

    def _compute_iterative(self, jac, program, covariance_blocks) -> bool:
        """ITERATIVE_PCG: (JᵀJ) X = E for all requested tangent columns in
        one batched PCG on the device (ceres_tpu/covariance.py:165-231).
        The tolerance is floored at 50 eps of the Jacobian's dtype; rank
        deficiency is reported only on a PCG breakdown (p'Ap <= 0), and a
        column that exhausts the iteration cap returns False with a
        warning."""
        cols_wanted = self._wanted_cols(program, covariance_blocks)
        n = program.num_effective_parameters
        dtype = jac._dtype()
        dev = jac._device()
        prec = BlockDiagSolver(program, jac.block_diag_jtj())
        max_iters = self.options.iterative_max_iterations or n
        tol = max(self.options.iterative_tolerance, 50.0 * float(torch.finfo(dtype).eps))
        k = len(cols_wanted)
        es = torch.zeros((k, n), dtype=dtype, device=dev)
        es[torch.arange(k, device=dev), torch.as_tensor(cols_wanted, device=dev)] = 1.0
        t0, before = time.perf_counter(), counts()
        res = conjugate_gradients(
            matvec=jac.jtj_multiply_batched,
            b=es,
            preconditioner=prec.apply_batched,
            max_iterations=max_iters,
            tolerance=tol,
            batched=True,
        )
        xs, its, converged, breakdown = _read_result(res)
        counted = counts() - before
        self.pcg_stats = {
            "iterations": its.numpy().copy(), "reads": counted["Device::Read"],
            "seconds": time.perf_counter() - t0,
            "launches": {name: n for name, n in counted.items() if name in cuda_lib.LAUNCHES},
        }
        if bool(breakdown.any()):
            return False  # JᵀJ (numerically) rank deficient
        if not bool(converged.all()):
            logging.getLogger(__name__).warning(
                "Covariance ITERATIVE_PCG: %d/%d columns hit the iteration "
                "cap (%d) before reaching tolerance %.2e; raise "
                "iterative_max_iterations or loosen iterative_tolerance.",
                int((~converged).sum()), k, max_iters, tol,
            )
            return False  # not converged (distinct from breakdown, see log)
        self._cov = _ColumnSubsetMatrix(cols_wanted, xs.double().numpy().T)
        return True

    def _tangent_slice(self, block: int):
        program = self._program
        off = int(program.t_offsets[block])
        if off < 0:
            raise ValueError(f"parameter block {block} is constant or removed")
        return off, int(program.tangent_sizes[block])

    def get_covariance_block(self, block_i: int, block_j: int, tangent: bool = True):
        """Covariance block (in tangent space by default; lifted to ambient
        via the plus Jacobian otherwise — reference
        GetCovarianceBlockInTangentSpace / GetCovarianceBlock), as numpy."""
        if self._cov is None:
            raise RuntimeError("call compute() first")
        oi, si = self._tangent_slice(block_i)
        oj, sj = self._tangent_slice(block_j)
        cov_t = self._cov[oi : oi + si, oj : oj + sj]
        if tangent:
            return cov_t
        return self._plus_jacobian(block_i) @ cov_t @ self._plus_jacobian(block_j).T

    def _plus_jacobian(self, block: int) -> np.ndarray:
        values = self._problem.parameter_block_value(block)
        manifold = self._problem.get_manifold(block)
        if manifold is None:
            return np.eye(values.shape[0])
        x = torch.as_tensor(values, dtype=torch.float64)
        return manifold.plus_jacobian(x).numpy()


def _read_result(res):
    """The batched PCG's x, iterations, converged and breakdown in one
    read of the device."""
    k, n = res.x.shape
    flat = torch.cat([
        res.x.reshape(-1), res.iterations.to(res.x.dtype),
        res.converged.to(res.x.dtype), res.breakdown.to(res.x.dtype),
    ])
    host = read(flat)
    return (host[: k * n].reshape(k, n), host[k * n : k * n + k].to(torch.int64),
            host[k * n + k : k * n + 2 * k] != 0, host[k * n + 2 * k :] != 0)
