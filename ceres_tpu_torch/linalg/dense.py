"""Dense linear solvers for the trust-region step.

Port of `ceres_tpu.linalg.dense` (reference: DenseQRSolver,
dense_qr_solver.cc; DenseNormalCholeskySolver,
dense_normal_cholesky_solver.cc; CUDADenseCholeskyMixedPrecision,
dense_cholesky.h:246, with DenseIterativeRefiner, iterative_refiner.cc:74-101).
The (small) dense Jacobian is materialized from the block groups and solved
with PyTorch's QR and Cholesky (cuSOLVER on a card): the JAX package leaves
these to XLA's linalg and has no Pallas kernel for them.

All solvers answer: minimize ||J step + r||² + ||D step||², i.e.
(JᵀJ + DᵀD) step = -Jᵀr, returning the step in tangent space. A failed
factorization gives NaN, as jax.scipy's does, and reads nothing from the
device.
"""

from __future__ import annotations

import torch


def solve_dense_qr(dense_j, res_flat, dsq):
    """QR on the D-augmented system [J; D] step = [-r; 0]
    (dense_qr_solver.cc:40-120, the augmented-row formulation)."""
    num_eff = dense_j.shape[1]
    a = torch.cat([dense_j, torch.diag(torch.sqrt(dsq))])
    b = torch.cat([-res_flat, res_flat.new_zeros(num_eff)])
    q, r = torch.linalg.qr(a)
    return torch.linalg.solve_triangular(r, (q.T @ b)[:, None], upper=True)[:, 0]


def _cholesky_solve(lhs, rhs):
    """x with lhs x = rhs through a Cholesky factor; NaN where the factor
    fails."""
    chol, info = torch.linalg.cholesky_ex(lhs)
    x = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def solve_dense_normal_cholesky(dense_j, res_flat, dsq):
    """Cholesky on JᵀJ + diag(dsq) (dense_normal_cholesky_solver.cc)."""
    jtj = dense_j.T @ dense_j + torch.diag(dsq)
    return _cholesky_solve(jtj, -(dense_j.T @ res_flat))


def cholesky_solve_mixed(lhs, rhs, refine_iterations: int = 3, factor_dtype=torch.float32):
    """x with lhs x = rhs (lhs SPD [n, n], rhs [n]) from a `factor_dtype`
    Cholesky factor and `refine_iterations` sweeps x += L⁻ᵀL⁻¹ (rhs − lhs x)
    in lhs's dtype. A failed factorization gives NaN (no host read).
    DENSE_SCHUR uses it on the reduced camera system under mixed-precision
    solves."""
    work_dtype = lhs.dtype
    chol, info = torch.linalg.cholesky_ex(lhs.to(factor_dtype))

    def low_solve(v):
        return torch.cholesky_solve(v.to(factor_dtype)[:, None], chol)[:, 0].to(work_dtype)

    x = low_solve(rhs)
    for _ in range(refine_iterations):
        x = x + low_solve(rhs - lhs @ x)
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def solve_dense_normal_cholesky_mixed(dense_j, res_flat, dsq, refine_iterations: int = 3):
    """solve_dense_normal_cholesky with the normal equations formed in the
    working dtype, factored in float32 and the solution refined back to the
    working precision (DenseNormalCholeskySolver with
    use_mixed_precision_solves)."""
    jtj = dense_j.T @ dense_j + torch.diag(dsq)
    return cholesky_solve_mixed(jtj, -(dense_j.T @ res_flat), refine_iterations)
