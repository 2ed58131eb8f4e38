"""Robust loss functions rho(s) with first and second derivatives.

Port of `ceres_tpu.loss` (reference: loss_function.h:87-392,
loss_function.cc:44-175), every loss of it, each `rho` term for term.
Contract: rho(s) -> (rho0, rho1, rho2) with
cost = 0.5 * rho0, rho1 = d rho/ds (clamped to tiny), rho2 = d^2 rho/ds^2.
Branches are `torch.where` on safe operands, so the untaken branch never
produces a NaN.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def _tiny(dtype):
    return torch.finfo(dtype).tiny


class LossFunction:
    """Base class. Instances are hashable value objects; residual blocks with
    equal losses batch into one evaluation group."""

    def rho(self, s):
        """s: tensor of squared residual norms -> (rho0, rho1, rho2)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class TrivialLoss(LossFunction):
    """rho(s) = s (reference: loss_function.cc:44-48)."""

    def rho(self, s):
        return s, torch.ones_like(s), torch.zeros_like(s)


@dataclasses.dataclass(frozen=True)
class HuberLoss(LossFunction):
    """reference: loss_function.cc:50-64; a_=a, b_=a^2."""

    a: float

    def rho(self, s):
        a2 = self.a * self.a
        out = s > a2
        r = torch.sqrt(torch.clamp_min(s, a2))  # safe: only used when s > a2
        rho0 = torch.where(out, 2.0 * self.a * r - a2, s)
        rho1 = torch.where(
            out, torch.clamp_min(self.a / r, _tiny(s.dtype)), torch.ones_like(s)
        )
        rho2 = torch.where(
            out, -rho1 / (2.0 * torch.clamp_min(s, a2)), torch.zeros_like(s)
        )
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class SoftLOneLoss(LossFunction):
    """rho(s) = 2 b (sqrt(1 + s/b) - 1); reference: loss_function.cc:66-73."""

    a: float

    def rho(self, s):
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        tmp = torch.sqrt(total)
        rho0 = 2.0 * b * (tmp - 1.0)
        rho1 = torch.clamp_min(1.0 / tmp, _tiny(s.dtype))
        rho2 = -(c * rho1) / (2.0 * total)
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class CauchyLoss(LossFunction):
    """rho(s) = b log(1 + s/b); reference: loss_function.cc:75-82."""

    a: float

    def rho(self, s):
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        inv = 1.0 / total
        rho0 = b * torch.log(total)
        rho1 = torch.clamp_min(inv, _tiny(s.dtype))
        rho2 = -c * inv * inv
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class ArctanLoss(LossFunction):
    """rho(s) = a atan2(s, a); reference: loss_function.cc:84-91."""

    a: float

    def rho(self, s):
        b = 1.0 / (self.a * self.a)
        inv = 1.0 / (1.0 + s * s * b)
        rho0 = self.a * torch.atan2(s, torch.full_like(s, self.a))
        rho1 = torch.clamp_min(inv, _tiny(s.dtype))
        rho2 = -2.0 * s * b * inv * inv
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class TolerantLoss(LossFunction):
    """reference: loss_function.cc:93-118; a = tolerance, b = transition width."""

    a: float
    b: float

    def rho(self, s):
        c = self.b * math.log1p(math.exp(-self.a / self.b))
        x = (s - self.a) / self.b
        # large-x linearization against overflow (loss_function.cc:101-112)
        big = x > 36.0
        x_safe = torch.where(big, torch.zeros_like(x), x)
        e_x = torch.exp(x_safe)
        rho0 = torch.where(big, s - self.a - c, self.b * torch.log1p(e_x) - c)
        rho1 = torch.where(
            big, torch.ones_like(s), torch.clamp_min(e_x / (1.0 + e_x), _tiny(s.dtype))
        )
        rho2 = torch.where(
            big, torch.zeros_like(s), 0.5 / (self.b * (1.0 + torch.cosh(x_safe)))
        )
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class TukeyLoss(LossFunction):
    """Tukey biweight; reference: loss_function.cc:120-133."""

    a: float

    def rho(self, s):
        a2 = self.a * self.a
        inlier = s <= a2
        zero = torch.zeros_like(s)
        value = torch.where(inlier, 1.0 - s / a2, zero)
        value_sq = value * value
        rho0 = torch.where(inlier, a2 / 3.0 * (1.0 - value_sq * value), torch.full_like(s, a2 / 3.0))
        rho1 = torch.where(inlier, value_sq, zero)
        rho2 = torch.where(inlier, -2.0 / a2 * value, zero)
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class ScaledLoss(LossFunction):
    """a * rho_wrapped(s); reference: loss_function.cc:165-175. A None inner
    loss scales the trivial loss, as the reference's nullptr does."""

    loss: Optional[LossFunction]
    a: float

    def rho(self, s):
        if self.loss is None:
            return self.a * s, self.a * torch.ones_like(s), torch.zeros_like(s)
        r0, r1, r2 = self.loss.rho(s)
        return self.a * r0, self.a * r1, self.a * r2


class LossFunctionWrapper(LossFunction):
    """A wrapper whose inner loss can be swapped between solves (reference:
    loss_function.h LossFunctionWrapper). It compares equal by its inner
    loss, so signature grouping tells its states apart; a swap takes effect
    at the next compile of the Problem."""

    def __init__(self, loss: Optional[LossFunction]):
        self._loss = loss

    def reset(self, loss: Optional[LossFunction]):
        self._loss = loss

    def rho(self, s):
        if self._loss is None:
            return s, torch.ones_like(s), torch.zeros_like(s)
        return self._loss.rho(s)

    def __hash__(self):
        return hash(("LossFunctionWrapper", self._loss))

    def __eq__(self, other):
        return isinstance(other, LossFunctionWrapper) and self._loss == other._loss


@dataclasses.dataclass(frozen=True)
class ComposedLoss(LossFunction):
    """f(g(s)); reference: loss_function.cc:136-163."""

    f: LossFunction
    g: LossFunction

    def rho(self, s):
        g0, g1, g2 = self.g.rho(s)
        f0, f1, f2 = self.f.rho(g0)
        return f0, f1 * g1, f2 * g1 * g1 + f1 * g2


def current_value(loss):
    """`loss` as a value of what it computes now, which compares equal
    only to a loss of the same kind and parameters: a LossFunctionWrapper
    stands for the loss it wraps at the time of the call (reset() swaps it
    in place), a composed loss for its parts."""
    if isinstance(loss, LossFunctionWrapper):
        return ("LossFunctionWrapper", current_value(loss._loss))
    if dataclasses.is_dataclass(loss):
        return (type(loss),) + tuple(
            current_value(getattr(loss, f.name)) for f in dataclasses.fields(loss))
    return loss
