"""Batched block-diagonal inverses and solves.

Port of the block-diagonal part of `ceres_tpu.linalg.preconditioners`
(reference: block_jacobi_preconditioner.cc). Blocks live as TRANSPOSED
per-class tables [s*s, count]; blocks of size <= 3 invert in closed form,
larger ones through one batched Cholesky (torch.linalg, as the JAX package
leaves them to XLA). Blocks that come out non-finite or fail to factor
degrade to the clamped-diagonal inverse.
"""

from __future__ import annotations

import numpy as np
import torch


def _diag_rows(s, device):
    return torch.as_tensor(np.arange(s) * s + np.arange(s), device=device)


def _inverse_T(table, s, eps_scale=1e-14):
    """Invert SPD blocks stored transposed: [s*s, cnt] -> [s*s, cnt]. A tiny
    ridge keeps all-zero blocks finite."""
    cnt = table.shape[1]
    eps = eps_scale * torch.clamp_min(table.abs().amax(dim=0), 1.0) + 1e-300
    a = table.index_add(0, _diag_rows(s, table.device), eps[None, :].expand(s, cnt))

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
    # general case: batched Cholesky inverse
    eye = torch.eye(s, dtype=table.dtype, device=table.device)
    rows = table.T.reshape(cnt, s, s) + eps[:, None, None] * eye
    chol, info = torch.linalg.cholesky_ex(rows)
    inv = torch.cholesky_solve(eye.expand(cnt, s, s), chol)
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
