"""Dense solves of the port: the mixed-precision Cholesky solve.

Port of `ceres_tpu.linalg.dense.cholesky_solve_mixed` (reference:
CUDADenseCholeskyMixedPrecision, dense_cholesky.h:246, and
DenseIterativeRefiner, iterative_refiner.cc:74-101): the factorization and
the triangular solves run in float32, the residual b − A x of each
refinement sweep in the working dtype. DENSE_SCHUR uses it on the reduced
camera system under mixed-precision solves. The JAX function is
`jax.scipy` and no Pallas kernel, so the factorization here is PyTorch's
(cuSOLVER on a card). DENSE_QR and DENSE_NORMAL_CHOLESKY are not ported
(ROADMAP Queue A item 5).
"""

from __future__ import annotations

import torch


def cholesky_solve_mixed(lhs, rhs, refine_iterations: int = 3, factor_dtype=torch.float32):
    """x with lhs x = rhs (lhs SPD [n, n], rhs [n]) from a `factor_dtype`
    Cholesky factor and `refine_iterations` sweeps x += L⁻ᵀL⁻¹ (rhs − lhs x)
    in lhs's dtype. A failed factorization gives NaN (no host read)."""
    work_dtype = lhs.dtype
    chol, info = torch.linalg.cholesky_ex(lhs.to(factor_dtype))

    def low_solve(v):
        return torch.cholesky_solve(v.to(factor_dtype)[:, None], chol)[:, 0].to(work_dtype)

    x = low_solve(rhs)
    for _ in range(refine_iterations):
        x = x + low_solve(rhs - lhs @ x)
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))
