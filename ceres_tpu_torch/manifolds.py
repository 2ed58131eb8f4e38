"""Manifolds: the base class, the Euclidean, quaternion and product
manifolds.

Port of the part of `ceres_tpu.manifolds` the bundle-adjustment paths use
(reference: include/ceres/manifold.h, product_manifold.h). Operations act
on a single block, written with `torch.where` selects on safe operands; the
evaluator batches them with `torch.func.vmap`. Every manifold is a hashable
value object: the Program groups blocks by manifold equality.
"""

from __future__ import annotations

import dataclasses

import torch


class Manifold:
    """Base manifold. Subclasses are hashable value objects: two equal
    instances may share one evaluation batch."""

    @property
    def ambient_size(self) -> int:
        raise NotImplementedError

    @property
    def tangent_size(self) -> int:
        raise NotImplementedError

    def plus(self, x, delta):
        """x [+] delta -> ambient point."""
        raise NotImplementedError

    def plus_jacobian(self, x):
        """d Plus(x, delta) / d delta at delta = 0: [ambient, tangent]."""
        raise NotImplementedError

    def minus(self, y, x):
        raise NotImplementedError

    def minus_jacobian(self, x):
        raise NotImplementedError

    def apply_plus_jacobian(self, jac_ambient, x):
        """jac_ambient [..., ambient] @ plus_jacobian(x) -> [..., tangent]."""
        return jac_ambient @ self.plus_jacobian(x)


@dataclasses.dataclass(frozen=True)
class EuclideanManifold(Manifold):
    """R^n with Plus = +. reference: manifold.h EuclideanManifold."""

    size: int

    @property
    def ambient_size(self) -> int:
        return self.size

    @property
    def tangent_size(self) -> int:
        return self.size

    def plus(self, x, delta):
        return x + delta

    def plus_jacobian(self, x):
        return torch.eye(self.size, dtype=x.dtype, device=x.device)

    def minus(self, y, x):
        return y - x

    def minus_jacobian(self, x):
        return torch.eye(self.size, dtype=x.dtype, device=x.device)

    def apply_plus_jacobian(self, jac_ambient, x):
        return jac_ambient


def _quat_prod(a, b, order):
    """Hamilton product a ⊗ b with index order (w, x, y, z positions)."""
    w, x, y, z = order
    out = [None] * 4
    out[w] = a[w] * b[w] - a[x] * b[x] - a[y] * b[y] - a[z] * b[z]
    out[x] = a[w] * b[x] + a[x] * b[w] + a[y] * b[z] - a[z] * b[y]
    out[y] = a[w] * b[y] - a[x] * b[z] + a[y] * b[w] + a[z] * b[x]
    out[z] = a[w] * b[z] + a[x] * b[y] - a[y] * b[x] + a[z] * b[w]
    return torch.stack(out)


class _QuaternionBase(Manifold):
    """Unit quaternion manifold; the subclass fixes the component order.

    Plus(x, delta) = exp(delta) ⊗ x with rotation angle |delta|
    (reference: manifold.cc:27-67 QuaternionPlusImpl). Every constant takes
    its operand's device and dtype, and the exp map's zero test is a
    select, so `plus` runs inside a captured CUDA graph without a sync."""

    _order: tuple  # (w, x, y, z) index positions

    @property
    def ambient_size(self) -> int:
        return 4

    @property
    def tangent_size(self) -> int:
        return 3

    def _exp(self, delta):
        w, x, y, z = self._order
        norm2 = (delta * delta).sum()
        norm = torch.sqrt(norm2)
        nonzero = norm2 > 0
        one = torch.ones_like(norm)
        # sin(t)/t, exact at 0 via a select on safe operands
        sinc = torch.where(nonzero, torch.sin(norm) / torch.where(nonzero, norm, one), one)
        q = [None] * 4
        q[w] = torch.cos(norm)
        q[x] = sinc * delta[0]
        q[y] = sinc * delta[1]
        q[z] = sinc * delta[2]
        return torch.stack(q)

    def plus(self, x, delta):
        return _quat_prod(self._exp(delta), x, self._order)

    def plus_jacobian(self, x):
        # d/d delta_i at 0 of exp(delta) ⊗ x = e_i ⊗ x for the imaginary
        # units e_i (manifold.cc QuaternionPlusJacobianImpl)
        w, xi, y, z = self._order
        cols = []
        for unit_pos in (xi, y, z):
            e = torch.zeros(4, dtype=x.dtype, device=x.device)
            e[unit_pos] = 1.0
            cols.append(_quat_prod(e, x, self._order))
        return torch.stack(cols, dim=1)

    def _conj(self, q):
        w = self._order[0]
        return torch.stack([q[i] if i == w else -q[i] for i in range(4)])

    def minus(self, y_, x):
        # y ⊗ x^{-1}; delta = atan2(|im|, re) / |im| * im
        w, xi, yi, z = self._order
        d = _quat_prod(y_, self._conj(x), self._order)
        im = torch.stack([d[xi], d[yi], d[z]])
        im_norm2 = (im * im).sum()
        im_norm = torch.sqrt(im_norm2)
        nonzero = im_norm2 > 0
        one = torch.ones_like(im_norm)
        scale = torch.where(
            nonzero, torch.atan2(im_norm, d[w]) / torch.where(nonzero, im_norm, one), one
        )
        return scale * im

    def minus_jacobian(self, x):
        # d Minus(y, x) / dy at y = x: plus_jacobian(x)ᵀ for a unit quaternion
        return self.plus_jacobian(x).T


@dataclasses.dataclass(frozen=True)
class QuaternionManifold(_QuaternionBase):
    """[w, x, y, z] ordering (reference: manifold.h QuaternionManifold)."""

    _order = (0, 1, 2, 3)


@dataclasses.dataclass(frozen=True)
class EigenQuaternionManifold(_QuaternionBase):
    """[x, y, z, w] ordering (reference: manifold.h EigenQuaternionManifold)."""

    _order = (3, 0, 1, 2)


def _block_diag(blocks):
    """torch.block_diag written with cat and zeros of the blocks' own
    dtype and device."""
    cols = sum(b.shape[1] for b in blocks)
    rows, off = [], 0
    for b in blocks:
        parts = [b.new_zeros((b.shape[0], off)), b, b.new_zeros((b.shape[0], cols - off - b.shape[1]))]
        rows.append(torch.cat(parts, dim=1))
        off += b.shape[1]
    return torch.cat(rows, dim=0)


@dataclasses.dataclass(frozen=True, init=False)
class ProductManifold(Manifold):
    """Cartesian product of manifolds (reference: product_manifold.h)."""

    manifolds: tuple

    def __init__(self, *manifolds: Manifold):
        object.__setattr__(self, "manifolds", tuple(manifolds))
        if not manifolds:
            raise ValueError("ProductManifold needs at least one factor")

    @property
    def ambient_size(self) -> int:
        return sum(m.ambient_size for m in self.manifolds)

    @property
    def tangent_size(self) -> int:
        return sum(m.tangent_size for m in self.manifolds)

    @staticmethod
    def _split(x, sizes):
        out, off = [], 0
        for s in sizes:
            out.append(x[off : off + s])
            off += s
        return out

    def plus(self, x, delta):
        xs = self._split(x, [m.ambient_size for m in self.manifolds])
        ds = self._split(delta, [m.tangent_size for m in self.manifolds])
        return torch.cat([m.plus(xi, di) for m, xi, di in zip(self.manifolds, xs, ds)])

    def plus_jacobian(self, x):
        xs = self._split(x, [m.ambient_size for m in self.manifolds])
        return _block_diag([m.plus_jacobian(xi) for m, xi in zip(self.manifolds, xs)])

    def minus(self, y, x):
        ys = self._split(y, [m.ambient_size for m in self.manifolds])
        xs = self._split(x, [m.ambient_size for m in self.manifolds])
        return torch.cat([m.minus(yi, xi) for m, yi, xi in zip(self.manifolds, ys, xs)])

    def minus_jacobian(self, x):
        xs = self._split(x, [m.ambient_size for m in self.manifolds])
        return _block_diag([m.minus_jacobian(xi) for m, xi in zip(self.manifolds, xs)])
