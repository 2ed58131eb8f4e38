"""Fields-of-Experts image denoising, in PyTorch.

Port of the FoE part of `ceres_tpu.examples.denoising` (reference:
examples/denoising.cc + fields_of_experts.cc: an FoE MRF prior over image
cliques with robust potentials). `load_foe_file` / `load_pgm` read the
reference's trained filter files (data/{2x2,3x3,5x5}.foe) and its noisy
image (data/ceres_noisy.pgm) where a user has them; the problems take any
`FoEModel` and image. `build_sampled_function_problem` is the
sampled-function example on `interpolation.py`.

Every group of these problems has a functor the generator of
functor_codegen.py traces: on a card each takes kernel B1's generic
instantiation, the K filter groups one shared build.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from ..autodiff import AnalyticCostFunction, CostFunction
from ..loss import CauchyLoss, LossFunction
from ..problem import Problem


def simple_foe_filters():
    """3x3 derivative-like clique filters (stand-in for trained FoE)."""
    fx = np.array([[0, 0, 0], [-1, 1, 0], [0, 0, 0]], dtype=np.float64)
    fy = fx.T.copy()
    lap = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=np.float64) / 4.0
    return [fx, fy, lap]


@dataclasses.dataclass
class FoEModel:
    """Trained Fields-of-Experts prior (fields_of_experts.h:89-135)."""

    size: int                 # clique side length
    x_deltas: np.ndarray      # [size*size] x offset of each clique variable
    y_deltas: np.ndarray      # [size*size] y offset
    alphas: np.ndarray        # [K] per-filter loss weights
    filters: np.ndarray       # [K, size*size] linear filter taps


def load_foe_file(path) -> FoEModel:
    """ASCII .foe reader (format: fields_of_experts.cc LoadFromFile:89-131 —
    `size K`, then x-deltas, y-deltas, alphas, and K filter rows)."""
    with open(path) as f:
        tokens = f.read().split()
    size, k = int(tokens[0]), int(tokens[1])
    nv = size * size
    vals = np.asarray(tokens[2:], dtype=np.float64)
    expected = 2 * nv + k + k * nv
    if vals.size != expected:
        raise ValueError(
            f"{path}: expected {expected} values for size={size} K={k}, got {vals.size}"
        )
    x_deltas = vals[:nv].astype(int)
    y_deltas = vals[nv:2 * nv].astype(int)
    alphas = vals[2 * nv:2 * nv + k]
    filters = vals[2 * nv + k:].reshape(k, nv)
    return FoEModel(size, x_deltas, y_deltas, alphas, filters)


def load_pgm(path) -> np.ndarray:
    """P2/P5 PGM reader (role of examples/pgm_image.h). Returns float64
    [h, w] in [0, maxval]."""
    with open(path, "rb") as f:
        buf = f.read()
    header = []
    pos = 0
    while len(header) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", buf[pos:])
        if m is None:
            raise ValueError(f"{path}: truncated PGM header")
        pos += m.end()
        tok = m.group(1)
        if not tok.startswith(b"#"):
            header.append(tok)
    magic, w, h = header[0], int(header[1]), int(header[2])
    maxval = int(header[3])
    if magic == b"P5":
        dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
        # binary data begins exactly one whitespace char after maxval
        img = np.frombuffer(buf, dtype=dtype, count=w * h, offset=pos + 1)
    elif magic == b"P2":
        img = np.asarray(buf[pos:].split()[: w * h], dtype=np.float64)
    else:
        raise ValueError(f"{path}: not a PGM file (magic {magic!r})")
    return np.asarray(img, dtype=np.float64).reshape(h, w)


def save_pgm(path, img: np.ndarray, maxval: int = 255) -> None:
    """P2 (ASCII) PGM writer, clamping to [0, maxval] like the reference's
    PGMImage<double>::WriteToFile."""
    img = np.clip(np.round(np.asarray(img)), 0, maxval).astype(int)
    h, w = img.shape
    lines = [f"P2\n{w} {h}\n{maxval}\n"]
    lines += [" ".join(str(v) for v in row) + "\n" for row in img]
    with open(path, "w") as f:
        f.writelines(lines)


def synthetic_foe_model(size: int, k: int, seed: int = 0) -> FoEModel:
    """A stand-in for a trained prior of the published shapes (3x3 with
    K = 8, 5x5 with K = 24): zero-mean taps and alphas in [0.5, 2], from
    numpy's generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    taps = rng.normal(size=(k, size * size))
    taps -= taps.mean(axis=1, keepdims=True)
    d = np.arange(size)
    return FoEModel(size, np.tile(d, size), np.repeat(d, size), rng.uniform(0.5, 2.0, k), taps)


def synthetic_noisy_image(h: int, w: int, sigma: float = 20.0, seed: int = 0) -> np.ndarray:
    """A piecewise-smooth image on [0, 255] (smooth gradients across a few
    constant regions) plus Gaussian noise of standard deviation `sigma`,
    float64 [h, w], from numpy's generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0.0, 1.0, h), np.linspace(0.0, 1.0, w), indexing="ij")
    img = 60.0 + 80.0 * xx + 40.0 * np.sin(3.0 * np.pi * yy)
    for _ in range(6):
        cy, cx, r = rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9), rng.uniform(0.05, 0.25)
        img = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r * r, rng.uniform(0.0, 255.0), img)
    return np.clip(img, 0.0, 255.0) + rng.normal(0.0, sigma, (h, w))


@dataclasses.dataclass(frozen=True)
class FieldsOfExpertsLoss(LossFunction):
    """rho(s) = alpha log(1 + s/2) (fields_of_experts.cc:77-85)."""

    alpha: float

    def rho(self, s):
        c = 0.5
        total = 1.0 + s * c
        inv = 1.0 / total
        return (
            self.alpha * torch.log(total),
            self.alpha * c * inv,
            -self.alpha * c * c * inv * inv,
        )


def _clique_ids(h, w, size, x_deltas, y_deltas):
    """[positions, size*size] pixel ids of every clique (rows: clique
    positions, columns: clique variables), as ceres_tpu forms them."""
    pix_id = np.arange(h * w).reshape(h, w)
    span = size - 1
    return np.stack(
        [pix_id[dy : h - span + dy, dx : w - span + dx].reshape(-1)
         for dx, dy in zip(x_deltas, y_deltas)],
        axis=1,
    )


def build_foe_denoising_problem(noisy: np.ndarray, foe: FoEModel, sigma: float = 20.0,
                                analytic: bool = False):
    """Reference CreateProblem (denoising.cc:133-176): per-pixel quadratic
    data term sqrt(1/(2 sigma^2)) (x - y), plus, for every clique position
    and every filter k, a linear residual filter_k . patch under
    FieldsOfExpertsLoss(alpha_k). With `analytic` each clique is an
    AnalyticCostFunction with its closed-form Jacobian, as the reference's
    FieldsOfExpertsCost is an analytic CostFunction; else torch.func (or
    the generator's Jets) differentiates it.

    Returns (problem, pixel_block_ids [h*w])."""
    h, w = noisy.shape
    problem = Problem()
    px = problem.add_parameter_blocks(noisy.reshape(-1, 1))
    coeff = float(np.sqrt(1.0 / (2.0 * sigma * sigma)))

    def data_res(params, data):
        (x,) = params
        (y,) = data
        return coeff * (x - y)

    problem.add_residual_blocks(
        CostFunction(data_res, 1, name="foe_data"), None, px.reshape(-1, 1),
        (noisy.reshape(-1, 1),),
    )
    ids = _clique_ids(h, w, foe.size, foe.x_deltas, foe.y_deltas)
    for k in range(foe.filters.shape[0]):
        fn, jac = foe_clique_functions(foe.filters[k])
        cost = (AnalyticCostFunction(fn, jac, 1, name=f"foe_filter_{k}") if analytic
                else CostFunction(fn, 1, name=f"foe_filter_{k}"))
        problem.add_residual_blocks(
            cost,
            FieldsOfExpertsLoss(float(foe.alphas[k])),
            px[ids.reshape(-1)].reshape(ids.shape),
            (),
        )
    return problem, px


def foe_clique_functions(filt):
    """(functor, closed-form Jacobian) of one filter's clique residual
    filter . patch over the clique's one-pixel blocks: the Jacobian of
    position i is [[filter_i]] (the reference's FieldsOfExpertsCost,
    fields_of_experts.cc:49-74, with the prior weight 1)."""
    taps = torch.tensor(np.asarray(filt, dtype=np.float64))

    def foe_res(params, data, taps=taps):
        vals = torch.stack([p[0] for p in params])
        return torch.stack([torch.dot(taps.to(vals), vals)])

    def foe_jac(params, data, taps=taps):
        return tuple(taps[i : i + 1].to(p).reshape(1, 1) for i, p in enumerate(params))

    return foe_res, foe_jac


def build_denoising_problem(noisy: np.ndarray, filters=None, data_weight=1.0,
                            prior_weight=0.2):
    """min sum_p w_d (x_p - y_p)^2 + w_p sum_f rho((F_f * x)_p)

    Each pixel is one parameter block; each filter application at each
    valid location is one residual block over the filter's nonzero taps of
    its 3x3 clique, batched into one signature group per filter, under
    CauchyLoss(0.3)."""
    filters = filters if filters is not None else simple_foe_filters()
    h, w = noisy.shape
    problem = Problem()
    px = problem.add_parameter_blocks(noisy.reshape(-1, 1))
    pix_id = np.arange(h * w).reshape(h, w)
    sqrt_dw = float(np.sqrt(data_weight))
    sqrt_pw = float(np.sqrt(prior_weight))

    def data_res(params, data):
        (x,) = params
        (y,) = data
        return sqrt_dw * (x - y)

    problem.add_residual_blocks(
        CostFunction(data_res, 1, name="denoise_data"), None, px.reshape(-1, 1),
        (noisy.reshape(-1, 1),),
    )
    for fi, filt in enumerate(filters):
        taps = [(dy, dx, filt[dy, dx]) for dy in range(3) for dx in range(3)
                if filt[dy, dx] != 0.0]
        coeffs = torch.tensor([c for _, _, c in taps], dtype=torch.float64)
        ids = np.stack(
            [pix_id[dy : h - 2 + dy, dx : w - 2 + dx].reshape(-1) for dy, dx, _ in taps], axis=1
        )

        def clique_res(params, data, coeffs=coeffs):
            vals = torch.stack([p[0] for p in params])
            return sqrt_pw * torch.stack([torch.dot(coeffs.to(vals), vals)])

        problem.add_residual_blocks(
            CostFunction(clique_res, 1, name=f"foe_{fi}"), CauchyLoss(0.3),
            px[ids.reshape(-1)].reshape(ids.shape), (),
        )
    return problem, px


def build_sampled_function_problem(samples: np.ndarray, x0: float = 1.0):
    """Minimize an interpolated 1-D sampled function
    (examples/sampled_function/sampled_function.cc;
    ceres_tpu/examples/denoising.py:231): the functor reads the function's
    value through a differentiable cubic interpolator. The generator
    refuses it (a data-dependent index): its group takes the torch.func
    path on a card too. Returns (problem, the block's handle)."""
    from ..interpolation import CubicInterpolator

    interp = CubicInterpolator(samples)

    def res(params, data):
        (x,) = params
        return torch.stack([interp(x[0])])

    problem = Problem()
    b = problem.add_parameter_block([x0])
    problem.add_residual_block(CostFunction(res, 1, name="sampled"), None, [b])
    return problem, b
