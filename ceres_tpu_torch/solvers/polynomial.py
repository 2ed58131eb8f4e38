"""Interpolating-polynomial fitting and minimization for line search.

Port of `ceres_tpu.solvers.polynomial` (reference: internal/ceres/
polynomial.cc:200-389), kept as the port's own copy: host NumPy on a
handful of coefficients. FindInterpolatingPolynomial fits the
minimal-degree polynomial through a set of (position, value, gradient)
samples (polynomial.cc:305-350); MinimizePolynomial compares the interval's
ends with the real roots of the derivative inside it (:200-260). The
device only evaluates phi and phi'.

Polynomials use the np.polyval convention: coeffs[0] is the highest-degree
coefficient.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class FunctionSample:
    """One line-search sample phi(x) (reference: function_sample.h)."""

    x: float
    value: float = 0.0
    value_is_valid: bool = False
    gradient: float = 0.0
    gradient_is_valid: bool = False

    @staticmethod
    def valued(x: float, value: float) -> "FunctionSample":
        return FunctionSample(x=x, value=value, value_is_valid=True)

    @staticmethod
    def with_gradient(x: float, value: float, gradient: float) -> "FunctionSample":
        return FunctionSample(
            x=x,
            value=value,
            value_is_valid=True,
            gradient=gradient,
            gradient_is_valid=True,
        )


def find_interpolating_polynomial(
    samples: Sequence[FunctionSample],
) -> np.ndarray:
    """Least-squares fit of the minimal-degree interpolating polynomial.

    reference: FindInterpolatingPolynomial (polynomial.cc:305-350): one
    constraint row per valid value/gradient, degree = #constraints - 1.
    """
    num_constraints = sum(
        int(s.value_is_valid) + int(s.gradient_is_valid) for s in samples
    )
    if num_constraints == 0:
        raise ValueError("no valid constraints in samples")
    degree = num_constraints - 1
    rows, rhs = [], []
    for s in samples:
        if s.value_is_valid:
            rows.append([s.x ** (degree - j) for j in range(degree + 1)])
            rhs.append(s.value)
        if s.gradient_is_valid:
            rows.append(
                [
                    (degree - j) * s.x ** (degree - j - 1)
                    if degree - j >= 1
                    else 0.0
                    for j in range(degree + 1)
                ]
            )
            rhs.append(s.gradient)
    coeffs, *_ = np.linalg.lstsq(
        np.asarray(rows, dtype=np.float64),
        np.asarray(rhs, dtype=np.float64),
        rcond=None,
    )
    return coeffs


def evaluate_polynomial(poly: np.ndarray, x: float) -> float:
    return float(np.polyval(poly, x))


def minimize_polynomial(
    poly: np.ndarray, x_min: float, x_max: float
) -> Tuple[float, float]:
    """Minimum of the polynomial over [x_min, x_max].

    reference: MinimizePolynomial (polynomial.cc:200-260) — candidates are
    the interval endpoints plus every real stationary point inside it.
    Returns (argmin, min_value).
    """
    candidates = [x_min, x_max]
    deriv = np.polyder(poly)
    if deriv.size > 1:
        roots = np.roots(deriv)
        for r in roots:
            if abs(r.imag) < 1e-12 * max(1.0, abs(r.real)):
                xr = float(r.real)
                if x_min < xr < x_max:
                    candidates.append(xr)
    values = [evaluate_polynomial(poly, c) for c in candidates]
    k = int(np.argmin(values))
    return candidates[k], values[k]


def minimize_interpolating_polynomial(
    samples: Sequence[FunctionSample], x_min: float, x_max: float
) -> Tuple[float, float]:
    """Fit the interpolant of the samples and minimize it on [x_min, x_max].

    reference: MinimizeInterpolatingPolynomial (polynomial.cc:352-389).
    """
    poly = find_interpolating_polynomial(samples)
    return minimize_polynomial(poly, x_min, x_max)
