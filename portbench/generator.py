"""The benchmark's one traffic generator: a BAL problem from a seed.

A traffic mix is a data file under `portbench/traffic/` that names a
visibility model and its parameters; a configuration (`portbench/configs/`)
gives the counts of cameras, points and observations. A visibility model
is a module of its own, `portbench/visibility/<name>.py`, found by the
name the mix gives, with `draw(config, traffic, seed) -> Generated`.
`generate(config, traffic, seed)` draws the mix's problem from its
`problem_seed` (one problem, as a BAL file is one) and hands it on in the
order `seed` gives: the observations shuffled, the cameras and points
renumbered. So every seed is another order of the same work.

Nothing here imports the port or JAX: the benchmark's data is its own.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Generated:
    """A generated problem: the start (perturbed) parameters, the
    observations, and the true parameters they were drawn from."""

    cameras: np.ndarray  # [num_cameras, 9] start values
    points: np.ndarray  # [num_points, 3] start values
    camera_index: np.ndarray  # [num_obs] int64
    point_index: np.ndarray  # [num_obs] int64
    observations: np.ndarray  # [num_obs, 2]
    cameras_true: np.ndarray
    points_true: np.ndarray


def rng_for(seed: int) -> np.random.Generator:
    """numpy's generator for any whole-number seed (large ones included;
    a negative one is taken modulo 2**64)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def load(kind: str, name: str, root=HERE):
    """The module `<root>/<kind>/<name>.py` (a visibility model, a problem
    builder or a metric reader), loaded from its file."""
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no {kind} module {name!r} under {root}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generate(config: dict, traffic: dict, seed: int, root=HERE) -> Generated:
    """The traffic's problem, drawn from its own `problem_seed`, in the
    order `seed` gives."""
    return permute(draw(config, traffic, traffic["problem_seed"], root), seed)


def draw(config: dict, traffic: dict, seed: int, root=HERE) -> Generated:
    """The problem of the traffic's visibility model, drawn from `seed`."""
    return load("visibility", traffic["visibility"], root).draw(config, traffic, seed)


def permute(g: Generated, seed: int) -> Generated:
    """The same problem with its observations in a seeded order and its
    cameras and points renumbered by seeded permutations."""
    rng = rng_for(seed)
    cam = rng.permutation(g.cameras.shape[0])  # new camera i is old cam[i]
    pt = rng.permutation(g.points.shape[0])
    obs = rng.permutation(g.observations.shape[0])
    cam_new = np.empty_like(cam)
    cam_new[cam] = np.arange(cam.size)
    pt_new = np.empty_like(pt)
    pt_new[pt] = np.arange(pt.size)
    return Generated(g.cameras[cam], g.points[pt], cam_new[g.camera_index[obs]],
                     pt_new[g.point_index[obs]], g.observations[obs],
                     g.cameras_true[cam], g.points_true[pt])


# ---- shared geometry (numpy, float64) ----


def rotate(aa: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Batched Rodrigues rotation of p [n, 3] by angle-axis aa [n, 3]."""
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    small = theta[:, 0] < 1e-12
    axis = aa / np.where(theta > 0, theta, 1.0)
    cos_t = np.cos(theta)
    sin_t = np.sin(theta)
    w_cross_p = np.cross(axis, p)
    dot = np.sum(axis * p, axis=1, keepdims=True)
    out = cos_t * p + sin_t * w_cross_p + (1 - cos_t) * dot * axis
    out[small] = p[small] + np.cross(aa[small], p[small])
    return out


def project(cams: np.ndarray, pts: np.ndarray):
    """(pixel [n, 2], camera-frame z [n]) of points pts [n, 3] seen by
    Snavely cameras cams [n, 9] (BAL: the camera looks down -z)."""
    pc = rotate(cams[:, :3], pts) + cams[:, 3:6]
    xp = -pc[:, 0] / pc[:, 2]
    yp = -pc[:, 1] / pc[:, 2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cams[:, 7] + cams[:, 8] * r2)
    pix = np.stack([cams[:, 6] * distortion * xp, cams[:, 6] * distortion * yp], axis=1)
    return pix, pc[:, 2]
