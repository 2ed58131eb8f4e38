"""Manifolds: smooth (over-)parameterizations with Plus and Minus.

Port of `ceres_tpu.manifolds` (reference: include/ceres/manifold.h,
sphere_manifold.h, line_manifold.h, product_manifold.h,
autodiff_manifold.h, manifold_test_utils.h). Operations act on a single
block, written with `torch.where` selects on safe operands; the evaluator
batches them with `torch.func.vmap`. Every constant takes its operand's
device and dtype and no operation reads the device, so `plus` runs inside a
captured CUDA graph. Every manifold is a hashable value object: the
Program groups blocks by manifold equality.

On a card, B1 generic traces a group's `plus_jacobian` (functor_codegen.py):
SubsetManifold's is a constant and the group runs the kernel, as on JAX's
B1; which path the others take is written in PERF.md.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
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


@dataclasses.dataclass(frozen=True, eq=True)
class SubsetManifold(Manifold):
    """Euclidean with a subset of coordinates held constant (reference:
    manifold.h SubsetManifold): the constant coordinates have zero columns
    in the plus-Jacobian and no tangent coordinate. Written with selects
    and stacks of one-element slices (no index tensor to upload)."""

    size: int
    constant_indices: tuple

    def __post_init__(self):
        ci = tuple(sorted(set(int(i) for i in self.constant_indices)))
        object.__setattr__(self, "constant_indices", ci)
        for i in ci:
            if not 0 <= i < self.size:
                raise ValueError(f"constant index {i} out of range [0,{self.size})")

    @property
    def ambient_size(self) -> int:
        return self.size

    @property
    def tangent_size(self) -> int:
        return self.size - len(self.constant_indices)

    def _free_indices(self) -> list:
        return [i for i in range(self.size) if i not in self.constant_indices]

    def plus(self, x, delta):
        tangent = {i: j for j, i in enumerate(self._free_indices())}
        return torch.cat([x[i : i + 1] + delta[tangent[i] : tangent[i] + 1] if i in tangent
                          else x[i : i + 1] for i in range(self.size)])

    def plus_jacobian(self, x):
        eye = torch.eye(self.size, dtype=x.dtype, device=x.device)
        return torch.stack([eye[:, i] for i in self._free_indices()], dim=1)

    def minus(self, y, x):
        d = y - x
        return torch.cat([d[i : i + 1] for i in self._free_indices()])

    def minus_jacobian(self, x):
        return self.plus_jacobian(x).T

    def apply_plus_jacobian(self, jac_ambient, x):
        return torch.stack([jac_ambient[..., i] for i in self._free_indices()], dim=-1)


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


def _householder(x):
    """Householder vector (v, beta) with H = I - beta v v' zeroing the head of
    x (reference: householder_vector.h:48-82), branch-free as
    ceres_tpu/manifolds.py:246."""
    sigma = (x[:-1] * x[:-1]).sum()
    x_pivot = x[-1]
    mu = torch.sqrt(x_pivot * x_pivot + sigma)
    one = torch.ones_like(sigma)
    v_pivot_neg = x_pivot - mu
    v_pivot_pos = -sigma / torch.where(x_pivot + mu != 0, x_pivot + mu, one)
    v_pivot = torch.where(x_pivot <= 0, v_pivot_neg, v_pivot_pos)
    beta_main = 2.0 * v_pivot * v_pivot / (sigma + v_pivot * v_pivot)
    degenerate = sigma <= torch.finfo(x.dtype).eps
    beta = torch.where(degenerate, torch.where(x_pivot < 0, 2.0 * one, 0.0 * one), beta_main)
    safe_v_pivot = torch.where(degenerate, one, v_pivot)
    v = torch.cat([torch.where(degenerate, x[:-1], x[:-1] / safe_v_pivot), one.reshape(1)])
    return v, beta


def _apply_householder(y, v, beta):
    return y - v * (beta * (v * y).sum())


def _sphere_exp(delta):
    """[sinc(|delta|) delta, cos |delta|], exact at 0 via selects."""
    norm2 = (delta * delta).sum()
    norm = torch.sqrt(norm2)
    nonzero = norm2 > 0
    one = torch.ones_like(norm)
    sinc = torch.where(nonzero, torch.sin(norm) / torch.where(nonzero, norm, one), one)
    return torch.cat([sinc * delta, torch.cos(norm).reshape(1)])


def _sphere_log(hy):
    """The tangent of a unit point hy in the Householder frame:
    atan2(|head|, last) / |head| * head, and [0.., 0 or pi] where the head
    is zero (ceres_tpu/manifolds.py:304-314)."""
    head, last = hy[:-1], hy[-1]
    hn2 = (head * head).sum()
    hn = torch.sqrt(hn2)
    nonzero = hn2 > 0
    one = torch.ones_like(hn)
    scale = torch.where(nonzero, torch.atan2(hn, last) / torch.where(nonzero, hn, one), 0.0 * one)
    corner = torch.where(last >= 0, 0.0 * one, math.pi * one).reshape(1)
    deg = torch.cat([torch.zeros_like(head[:-1]), corner])
    return torch.where(nonzero, scale * head, deg)


def _norm(x):
    return torch.sqrt((x * x).sum())


def _householder_matrix(x):
    v, beta = _householder(x)
    n = x.shape[0]
    return torch.eye(n, dtype=x.dtype, device=x.device) - beta * (v[:, None] * v[None, :])


@dataclasses.dataclass(frozen=True)
class SphereManifold(Manifold):
    """Sphere of radius |x| in R^n, tangent n - 1 (reference:
    sphere_manifold.h, internal/sphere_manifold_functions.h)."""

    size: int

    def __post_init__(self):
        if self.size < 2:
            raise ValueError("SphereManifold needs ambient size >= 2")

    @property
    def ambient_size(self) -> int:
        return self.size

    @property
    def tangent_size(self) -> int:
        return self.size - 1

    def plus(self, x, delta):
        v, beta = _householder(x)
        return _norm(x) * _apply_householder(_sphere_exp(delta), v, beta)

    def plus_jacobian(self, x):
        return _norm(x) * _householder_matrix(x)[:, : self.tangent_size]

    def minus(self, y, x):
        v, beta = _householder(x)
        return _sphere_log(_apply_householder(y, v, beta) / _norm(x))

    def minus_jacobian(self, x):
        return _householder_matrix(x)[: self.tangent_size, :] / _norm(x)


@dataclasses.dataclass(frozen=True)
class LineManifold(Manifold):
    """A line in R^n as (origin, direction) in R^2n, tangent 2(n - 1)
    (reference: line_manifold.h): Plus moves the origin in the hyperplane
    orthogonal to the direction and rotates the direction on its sphere,
    both in the direction's Householder frame."""

    size: int  # the dimension of the space the line lives in

    def __post_init__(self):
        if self.size < 2:
            raise ValueError("LineManifold needs space dimension >= 2")

    @property
    def ambient_size(self) -> int:
        return 2 * self.size

    @property
    def tangent_size(self) -> int:
        return 2 * (self.size - 1)

    def plus(self, x, delta):
        n = self.size
        origin, direction = x[:n], x[n:]
        do, dd = delta[: n - 1], delta[n - 1 :]
        v, beta = _householder(direction)
        origin_new = origin + _apply_householder(torch.cat([do, torch.zeros_like(do[:1])]), v, beta)
        direction_new = _norm(direction) * _apply_householder(_sphere_exp(dd), v, beta)
        return torch.cat([origin_new, direction_new])

    def plus_jacobian(self, x):
        n = self.size
        direction = x[n:]
        h = _householder_matrix(direction)[:, : n - 1]
        z = torch.zeros_like(h)
        return torch.cat([torch.cat([h, z], dim=1), torch.cat([z, _norm(direction) * h], dim=1)])

    def minus(self, y, x):
        n = self.size
        xo, xd = x[:n], x[n:]
        yo, yd = y[:n], y[n:]
        v, beta = _householder(xd)
        ho = _apply_householder(yo - xo, v, beta)
        hd = _apply_householder(yd, v, beta) / _norm(xd)
        head, last = hd[:-1], hd[-1]
        hn2 = (head * head).sum()
        hn = torch.sqrt(hn2)
        nonzero = hn2 > 0
        one = torch.ones_like(hn)
        scale = torch.where(nonzero, torch.atan2(hn, last) / torch.where(nonzero, hn, one),
                            0.0 * one)
        return torch.cat([ho[: n - 1], scale * head])

    def minus_jacobian(self, x):
        n = self.size
        xd = x[n:]
        h = _householder_matrix(xd)[: n - 1, :]
        z = torch.zeros_like(h)
        return torch.cat([torch.cat([h, z], dim=1), torch.cat([z, h / _norm(xd)], dim=1)])


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


class AutoDiffManifold(Manifold):
    """A manifold from the user's plus and minus functions, its Jacobians
    by torch.func.jacfwd (reference: autodiff_manifold.h;
    ceres_tpu/manifolds.py:447). The functions must be differentiable at
    delta = 0 and y = x."""

    def __init__(self, plus_fn, minus_fn, ambient_size: int, tangent_size: int):
        self._plus_fn = plus_fn
        self._minus_fn = minus_fn
        self._ambient = int(ambient_size)
        self._tangent = int(tangent_size)

    @property
    def ambient_size(self) -> int:
        return self._ambient

    @property
    def tangent_size(self) -> int:
        return self._tangent

    def plus(self, x, delta):
        return self._plus_fn(x, delta)

    def plus_jacobian(self, x):
        from torch.func import jacfwd

        zero = torch.zeros(self._tangent, dtype=x.dtype, device=x.device)
        return jacfwd(lambda d: self._plus_fn(x, d))(zero)

    def minus(self, y, x):
        return self._minus_fn(y, x)

    def minus_jacobian(self, x):
        from torch.func import jacfwd

        return jacfwd(lambda y: self._minus_fn(y, x))(x)

    def __hash__(self):
        return hash((id(self._plus_fn), id(self._minus_fn), self._ambient, self._tangent))

    def __eq__(self, other):
        return (
            isinstance(other, AutoDiffManifold)
            and self._plus_fn is other._plus_fn
            and self._minus_fn is other._minus_fn
            and self._ambient == other._ambient
            and self._tangent == other._tangent
        )


def check_manifold_invariants(manifold: Manifold, x, delta, tol: float = 1e-8):
    """The manifold axioms at (x, delta), in float64 (reference:
    manifold_test_utils.h; ceres_tpu/manifolds.py:493): XPlusZeroIsX,
    XMinusXIsZero, MinusPlusIsIdentity, PlusMinusIsIdentity, and the plus-
    and minus-Jacobians against central differences of Plus and Minus
    (step eps^(1/3), tolerance max(tol, 1e-7, 10 (h^2 + eps / h))).
    Raises AssertionError naming the failed axiom. `delta` should stay in
    the injectivity radius (the reference uses norm <= 0.5)."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    delta = torch.as_tensor(np.asarray(delta, dtype=np.float64))
    eps = float(torch.finfo(x.dtype).eps)
    zero = torch.zeros(manifold.tangent_size, dtype=x.dtype)

    def _close(a, b, name):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        if not np.all(np.isfinite(a)) or err > tol:
            raise AssertionError(
                f"manifold axiom {name} failed: max abs error {err:.3e} > {tol:.1e}"
            )

    _close(manifold.plus(x, zero), x, "XPlusZeroIsX")
    _close(manifold.minus(x, x), zero, "XMinusXIsZero")
    y = manifold.plus(x, delta)
    _close(manifold.minus(y, x), delta, "MinusPlusIsIdentity")
    _close(manifold.plus(x, manifold.minus(y, x)), y, "PlusMinusIsIdentity")

    # central differences, not jacfwd: the selects of Plus and Minus are
    # exact at delta = 0 and y = x but their derivative through the dead
    # branch is not (the reference's matchers difference numerically)
    h = float(eps ** (1.0 / 3.0))

    def _fd_jac(f, z0):
        cols = []
        for i in range(z0.shape[0]):
            e = torch.zeros_like(z0)
            e[i] = h
            cols.append((f(z0 + e) - f(z0 - e)) / (2.0 * h))
        return torch.stack(cols, dim=1)

    jac_tol = max(tol, 1e-7, 10.0 * (h * h + eps / h))
    for name, a, b in (
        ("HasCorrectPlusJacobian", manifold.plus_jacobian(x),
         _fd_jac(lambda d: manifold.plus(x, d), zero)),
        ("HasCorrectMinusJacobian", manifold.minus_jacobian(x),
         _fd_jac(lambda yy: manifold.minus(yy, x), x)),
    ):
        err = float((a - b).abs().max())
        if err > jac_tol:
            raise AssertionError(
                f"manifold axiom {name} failed: max abs error {err:.3e} > {jac_tol:.1e}"
            )
