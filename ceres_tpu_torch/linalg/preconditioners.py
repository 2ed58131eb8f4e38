"""Batched block-diagonal inverses and solves, and the preconditioners of
CGNR.

Port of `ceres_tpu.linalg.preconditioners` (reference:
block_jacobi_preconditioner.cc). Blocks live as TRANSPOSED
per-class tables [s*s, count]; blocks of size <= 3 invert in closed form,
larger ones through one batched Cholesky and two triangular solves
(torch.linalg, as the JAX package leaves them to XLA). Blocks that come out non-finite or fail to factor
degrade to the clamped-diagonal inverse.
"""

from __future__ import annotations

import torch


def diag_rows(s, device):
    """The rows i*s + i of a block's diagonal in an [s*s, cnt] table, made on
    `device` (no host upload: the solver loops run with no synchronizing
    copy)."""
    return torch.arange(s, device=device) * (s + 1)


def _inverse_T(table, s, eps_scale=1e-14):
    """Invert SPD blocks stored transposed: [s*s, cnt] -> [s*s, cnt]. A tiny
    ridge keeps all-zero blocks finite."""
    cnt = table.shape[1]
    eps = eps_scale * torch.clamp_min(table.abs().amax(dim=0), 1.0) + 1e-300
    a = table.index_add(0, diag_rows(s, table.device), eps[None, :].expand(s, cnt))

    def e(i, j):
        return a[i * s + j]

    def _repair_small(inv):
        diag = torch.stack([e(i, i) for i in range(s)])  # [s, cnt]
        dmax = diag.abs().amax(dim=0, keepdim=True)
        dclamp = torch.maximum(diag, 1e-6 * torch.clamp_min(dmax, 1e-30))
        zero = torch.zeros_like(dclamp[0])
        diag_inv = torch.stack(
            [1.0 / dclamp[i] if i == j else zero for i in range(s) for j in range(s)]
        )
        finite = torch.isfinite(inv)
        ok = finite.all(dim=0, keepdim=True)
        return torch.where(ok, torch.where(finite, inv, torch.zeros_like(inv)), diag_inv)

    if s == 1:
        return _repair_small(1.0 / a)
    if s == 2:
        det = e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)
        det = torch.where(det != 0, det, torch.ones_like(det))
        return _repair_small(torch.stack([e(1, 1), -e(0, 1), -e(1, 0), e(0, 0)]) / det)
    if s == 3:
        c00 = e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)
        c01 = e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2)
        c02 = e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)
        c10 = e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2)
        c11 = e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0)
        c12 = e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)
        c20 = e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)
        c21 = e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1)
        c22 = e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)
        det = e(0, 0) * c00 + e(0, 1) * c10 + e(0, 2) * c20
        det = torch.where(det != 0, det, torch.ones_like(det))
        inv = torch.stack([c00, c01, c02, c10, c11, c12, c20, c21, c22]) / det
        return _repair_small(inv)
    # general case: batched Cholesky inverse, the identity solved through
    # both triangles as jax.scipy.linalg.cho_solve does (cuBLAS trsm, which
    # a CUDA graph can capture; torch.cholesky_solve's batched MAGMA path
    # cannot be captured)
    eye = torch.eye(s, dtype=table.dtype, device=table.device)
    rows = table.T.reshape(cnt, s, s) + eps[:, None, None] * eye
    chol, info = torch.linalg.cholesky_ex(rows)
    inv = torch.linalg.solve_triangular(
        chol.mT, torch.linalg.solve_triangular(chol, eye.expand(cnt, s, s), upper=False),
        upper=True,
    )
    diag = torch.diagonal(rows, dim1=1, dim2=2)  # [cnt, s]
    dmax = diag.abs().amax(dim=1, keepdim=True)
    dclamp = torch.maximum(diag, 1e-6 * torch.clamp_min(dmax, 1e-30))
    diag_inv = torch.diag_embed(1.0 / dclamp)
    finite = torch.isfinite(inv)
    ok = ((info == 0)[:, None, None]) & finite.all(dim=2, keepdim=True).all(dim=1, keepdim=True)
    inv = torch.where(ok, torch.where(finite, inv, torch.zeros_like(inv)), diag_inv)
    return inv.reshape(cnt, s * s).T.contiguous()


def apply_block_T(inv_table, vt, s):
    """Apply per-block [s, s] matrices (transposed table [s*s, cnt]) to
    per-block vectors vt [s, cnt] -> [s, cnt]."""
    return torch.stack(
        [sum(inv_table[i * s + j] * vt[j] for j in range(s)) for i in range(s)]
    )


class BlockDiagSolver:
    """Inverted block-diagonal operator over tangent-size classes: the
    Jacobi preconditioner and the (EᵀE)⁻¹ inner solve of implicit Schur."""

    def __init__(self, program, tables_per_class, only_classes=None):
        self.program = program
        self.inv_tables = {}
        self._records = {}
        for cls, table in enumerate(tables_per_class):
            if table is None or (only_classes is not None and cls not in only_classes):
                continue
            self.inv_tables[cls] = _inverse_T(table, program.tangent_class_sizes[cls])

    @classmethod
    def from_inverse_tables(cls, program, inv_tables: dict):
        self = cls.__new__(cls)
        self.program = program
        self.inv_tables = dict(inv_tables)
        self._records = {}
        return self

    def inv_records(self, cls):
        """The inverse blocks of class `cls` point-major, [cnt, s*s]: each
        block's entries in one record, the table kernel B5 gathers slot by
        slot. Made once per solver."""
        if cls not in self._records:
            self._records[cls] = self.inv_tables[cls].T.contiguous()
        return self._records[cls]

    @property
    def classes(self):
        return sorted(self.inv_tables.keys())

    def apply_t(self, tv):
        """M⁻¹ on a tvec (per-class [s, cnt+1] tables); zero-width stand-ins
        and classes without a table pass through."""
        out = []
        for cls, t in enumerate(tv):
            inv = self.inv_tables.get(cls)
            if inv is None or t.shape[1] == 0:
                out.append(t)
                continue
            w = inv.shape[1]
            y = apply_block_T(inv, t[:, :w], t.shape[0])
            if t.shape[1] > w:
                y = torch.cat([y, t.new_zeros((t.shape[0], t.shape[1] - w))], dim=1)
            out.append(y)
        return out

    def apply_batched(self, r):
        """M⁻¹ on k flat tangent vectors [k, num_eff], the same operator for
        every row (the covariance's batched PCG)."""
        k = r.shape[0]
        out = []
        for cls in range(len(self.program.tangent_class_sizes)):
            base, cnt, s = self.program.tangent_class_slice(cls)
            seg = r[:, base : base + cnt * s]
            inv = self.inv_tables.get(cls)
            if inv is not None:
                vt = seg.reshape(k, cnt, s).permute(2, 0, 1)  # [s, k, cnt]
                seg = apply_block_T(inv, vt, s).permute(1, 2, 0).reshape(k, -1)
            out.append(seg)
        return torch.cat(out, dim=1)

    def __call__(self, r):
        """M⁻¹ on a flat tangent vector."""
        from ..evaluator import tangent_tables

        out = []
        for cls, seg in enumerate(tangent_tables(self.program, r)):
            inv = self.inv_tables.get(cls)
            if inv is None:
                out.append(seg.reshape(-1))
            else:
                s = self.program.tangent_class_sizes[cls]
                out.append(apply_block_T(inv, seg.T, s).T.reshape(-1))
        return torch.cat(out)


def identity_preconditioner():
    return lambda r: r


class BlockJacobiPreconditioner:
    """M = block-diag(JᵀJ + diag(dsq)) over every free parameter block of
    every tangent class (reference: block_jacobi_preconditioner.cc)."""

    def __init__(self, program, jac, dsq=None):
        self._solver = BlockDiagSolver(program, jac.block_diag_jtj(dsq=dsq))

    @property
    def inv_tables(self):
        return self._solver.inv_tables

    def __call__(self, r):
        return self._solver(r)


def make_preconditioner(kind, program, jac, dsq=None):
    """IDENTITY or JACOBI for CGNR (ceres_tpu/linalg/preconditioners.py:207)."""
    from ..types import PreconditionerType

    if kind == PreconditionerType.IDENTITY:
        return identity_preconditioner()
    if kind == PreconditionerType.JACOBI:
        return BlockJacobiPreconditioner(program, jac, dsq=dsq)
    raise NotImplementedError(f"preconditioner {kind} not implemented for this solver")
