"""BAL (Bundle Adjustment in the Large) problems: the text loader,
synthetic generation, normalization and perturbation, and assembly into a
Problem with angle-axis or quaternion cameras.

Port of `ceres_tpu.io.bal` (reference: examples/bal_problem.cc). The data
is plain numpy, read from a file or generated from a seed, so both packages
build the same problem from the same `BalProblem` and the tests compare them
array for array. The file format (grail.cs.washington.edu/projects/bal):
header `num_cameras num_points num_observations`, then one observation per
line `cam_idx point_idx x y`, then 9 doubles per camera, then 3 per point.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BalProblem:
    cameras: np.ndarray  # [num_cameras, 9]
    points: np.ndarray  # [num_points, 3]
    camera_index: np.ndarray  # [num_obs]
    point_index: np.ndarray  # [num_obs]
    observations: np.ndarray  # [num_obs, 2]

    @property
    def num_cameras(self) -> int:
        return self.cameras.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.observations.shape[0]

    def normalize(self, median_scale: float = 100.0):
        """Center the reconstruction and scale it to a fixed median absolute
        deviation (bal_problem.cc Normalize)."""
        median = np.median(self.points, axis=0)
        dev = np.abs(self.points - median).sum(axis=1)
        scale = median_scale / np.median(dev)
        self.points = scale * (self.points - median)
        # camera center c = -R' t, so t = -R c; normalize the centers alike
        for i in range(self.num_cameras):
            r = _angle_axis_to_matrix(self.cameras[i, :3])
            center = -r.T @ self.cameras[i, 3:6]
            center = scale * (center - median)
            self.cameras[i, 3:6] = -r @ center

    def perturb(self, rotation_sigma=0.0, translation_sigma=0.0, point_sigma=0.0, seed=0):
        """Add Gaussian noise (bal_problem.cc Perturb); draws the same
        numbers in the same order as ceres_tpu's."""
        rng = np.random.default_rng(seed)
        if point_sigma > 0:
            self.points += rng.normal(0, point_sigma, self.points.shape)
        if translation_sigma > 0:
            self.cameras[:, 3:6] += rng.normal(0, translation_sigma, (self.num_cameras, 3))
        if rotation_sigma > 0:
            self.cameras[:, :3] += rng.normal(0, rotation_sigma, (self.num_cameras, 3))

    def write_ply(self, path):
        """Export the camera centers and points as a PLY point cloud
        (bal_problem.cc WriteToPLYFile): cameras green, points white."""
        with open(path, "w") as f:
            f.write(
                "ply\nformat ascii 1.0\n"
                f"element vertex {self.num_cameras + self.num_points}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n"
            )
            for cam in self.cameras:
                c = -_angle_axis_to_matrix(cam[:3]).T @ cam[3:6]
                f.write(f"{c[0]} {c[1]} {c[2]} 0 255 0\n")
            for p in self.points:
                f.write(f"{p[0]} {p[1]} {p[2]} 255 255 255\n")


def _angle_axis_to_matrix(aa: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(aa)
    if theta < 1e-12:
        k = np.array([[0, -aa[2], aa[1]], [aa[2], 0, -aa[0]], [-aa[1], aa[0], 0]])
        return np.eye(3) + k
    axis = aa / theta
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)


def load_bal(path) -> BalProblem:
    """Parse a BAL text file (examples/bal_problem.cc constructor) with the
    native mmap + from_chars parser (io/native.py) where a C++ compiler is
    on PATH, as ceres_tpu's load_bal takes its native library; with numpy
    (`load_bal_numpy`, the plain version) otherwise. The two give bitwise
    equal arrays."""
    from . import native

    parsed = native.load_bal_native(str(path))
    if parsed is None:
        return load_bal_numpy(path)
    return BalProblem(*parsed)


def load_bal_numpy(path) -> BalProblem:
    """Parse a BAL text file with numpy: every token is read as ceres_tpu's
    loader reads it (indices as int64, values as correctly rounded
    float64)."""
    with open(path) as f:
        tokens = f.read().split()
    num_cameras, num_points, num_obs = (int(t) for t in tokens[:3])
    end = 3 + 4 * num_obs
    table = np.array(tokens[3:end]).reshape(num_obs, 4)
    cam_idx = table[:, 0].astype(np.int64)
    pt_idx = table[:, 1].astype(np.int64)
    obs = table[:, 2:].astype(np.float64)
    rest = np.array(tokens[end : end + 9 * num_cameras + 3 * num_points]).astype(np.float64)
    if rest.size != 9 * num_cameras + 3 * num_points:
        raise ValueError(f"{path}: truncated BAL file")
    cameras = rest[: 9 * num_cameras].reshape(num_cameras, 9)
    points = rest[9 * num_cameras :].reshape(num_points, 3)
    return BalProblem(cameras, points, cam_idx, pt_idx, obs)


class BalFileObservations:
    """The [num_obs, 2] observation payload of a BAL text file, read on
    demand (an io.lazy source): `gather` streams the observation section in
    bounded chunks and keeps only the requested rows, so a rank holds just
    its own shard's rows. One sequential scan per gather, which happens once,
    when the rank builds its shard."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            header = f.readline().split()
            self.num_cameras, self.num_points, self.num_obs = (int(t) for t in header[:3])
            self._obs_start = f.tell()
        self._params_start = None
        self.shape = (self.num_obs, 2)
        self.dtype = np.dtype(np.float64)

    def _stream_chunks(self, f, chunk_lines=1 << 19):
        """(row0, [m, 4] float64) chunks of the observation section."""
        row = 0
        while row < self.num_obs:
            m = min(chunk_lines, self.num_obs - row)
            lines = [f.readline() for _ in range(m)]
            yield row, np.array(b" ".join(lines).split()).astype(np.float64).reshape(m, 4)
            row += m

    def read_indices(self):
        """(camera_index, point_index) int64 arrays of the whole file: the
        metadata every rank needs to build the same Program."""
        cam = np.empty(self.num_obs, dtype=np.int64)
        pt = np.empty(self.num_obs, dtype=np.int64)
        with open(self.path, "rb") as f:
            f.seek(self._obs_start)
            for row0, chunk in self._stream_chunks(f):
                cam[row0 : row0 + chunk.shape[0]] = chunk[:, 0].astype(np.int64)
                pt[row0 : row0 + chunk.shape[0]] = chunk[:, 1].astype(np.int64)
            self._params_start = f.tell()
        return cam, pt

    def read_params(self):
        """(cameras [nc, 9], points [np, 3]) from the file's tail: the solver
        state every rank holds whole."""
        with open(self.path, "rb") as f:
            if self._params_start is None:
                f.seek(self._obs_start)
                for _ in range(self.num_obs):
                    f.readline()
            else:
                f.seek(self._params_start)
            rest = np.array(f.read().split()).astype(np.float64)
        nc, npnt = self.num_cameras, self.num_points
        if rest.size < 9 * nc + 3 * npnt:
            raise ValueError(f"{self.path}: truncated BAL file")
        return rest[: 9 * nc].reshape(nc, 9), rest[9 * nc : 9 * nc + 3 * npnt].reshape(npnt, 3)

    def gather(self, rows) -> np.ndarray:
        rows = np.asarray(rows)
        out = np.empty((rows.shape[0], 2), dtype=np.float64)
        if rows.size == 0:
            return out
        hi = int(rows.max())
        with open(self.path, "rb") as f:
            f.seek(self._obs_start)
            for row0, chunk in self._stream_chunks(f):
                r1 = row0 + chunk.shape[0]
                sel = (rows >= row0) & (rows < r1)
                if sel.any():
                    out[sel] = chunk[rows[sel] - row0, 2:4]
                if r1 > hi:
                    break
        return out


def load_bal_lazy(path) -> BalProblem:
    """A BAL file whose observation payload stays on disk
    (ceres_tpu/io/bal.py:185): indices and parameters are read now (every
    rank needs them to build the same Program), `observations` is a
    LazyRows that a sharded solve reads one rank's rows of."""
    from .lazy import LazyRows

    src = BalFileObservations(path)
    cam_idx, pt_idx = src.read_indices()
    cameras, points = src.read_params()
    return BalProblem(cameras, points, cam_idx, pt_idx, LazyRows(src))


def synthetic_bal(
    num_cameras: int,
    num_points: int,
    num_observations: int,
    seed: int = 0,
    observation_noise: float = 1.0,
    perturb_points: float = 0.05,
    perturb_rotation: float = 0.002,
) -> BalProblem:
    """Generate a BAL-shaped synthetic problem: cameras on a ring of radius
    ~20 looking at a point cloud at the origin, observations = true
    projections + pixel noise, initial parameters perturbed. Draws the same
    random numbers in the same order as ceres_tpu.io.bal.synthetic_bal."""
    rng = np.random.default_rng(seed)

    points_true = rng.normal(0.0, 3.0, (num_points, 3))
    cameras_true = np.zeros((num_cameras, 9))
    for i in range(num_cameras):
        ang = 2 * np.pi * i / num_cameras
        center = np.array([20 * np.cos(ang), 2.0 * np.sin(3 * ang), 20 * np.sin(ang)])
        z = center / np.linalg.norm(center)
        up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        r = np.stack([x, y, z])  # world -> camera
        cameras_true[i, :3] = _matrix_to_angle_axis(r)
        cameras_true[i, 3:6] = -r @ center
        cameras_true[i, 6] = 500.0 + rng.normal(0, 10)
        cameras_true[i, 7] = rng.normal(0, 1e-4)
        cameras_true[i, 8] = rng.normal(0, 1e-6)

    cam_idx = rng.integers(0, num_cameras, num_observations)
    pt_idx = rng.integers(0, num_points, num_observations)
    # every point observed at least twice where possible
    base = np.arange(num_points)
    k = min(2 * num_points, num_observations)
    pt_idx[:k] = np.concatenate([base, base])[:k]

    obs = np.empty((num_observations, 2))
    p = points_true[pt_idx]
    cams = cameras_true[cam_idx]
    pc = _rotate_np(cams[:, :3], p) + cams[:, 3:6]
    xp = -pc[:, 0] / pc[:, 2]
    yp = -pc[:, 1] / pc[:, 2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cams[:, 7] + cams[:, 8] * r2)
    obs[:, 0] = cams[:, 6] * distortion * xp + rng.normal(0, observation_noise, num_observations)
    obs[:, 1] = cams[:, 6] * distortion * yp + rng.normal(0, observation_noise, num_observations)

    cameras = cameras_true.copy()
    points = points_true + rng.normal(0, perturb_points, points_true.shape)
    cameras[:, :3] += rng.normal(0, perturb_rotation, (num_cameras, 3))
    return BalProblem(cameras, points, cam_idx, pt_idx, obs)


def _matrix_to_angle_axis(r: np.ndarray) -> np.ndarray:
    angle = np.arccos(np.clip((np.trace(r) - 1) / 2, -1.0, 1.0))
    if angle < 1e-12:
        return np.zeros(3)
    axis = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / (
        2 * np.sin(angle)
    )
    return angle * axis


def _rotate_np(aa: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Batched numpy Rodrigues rotation (synthetic data generation)."""
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


def build_ba_problem(
    bal: BalProblem,
    loss=None,
    use_quaternions: bool = False,
    use_manifolds: bool = False,
):
    """Assemble a Problem from a BalProblem (reference:
    examples/bundle_adjuster.cc BuildProblem): all observations become one
    signature group of the Snavely functor, tagged for the CUDA evaluation
    kernel. With `use_quaternions` the camera block is
    [q(4) | t(3) | f k1 k2] (q from the angle-axis, in float64 on the host)
    and the functor the quaternion one (tag "snavely_quat");
    `use_manifolds` puts Quaternion x Euclidean(6) on it, else the camera's
    tangent is its 10 ambient coordinates (bundle_adjuster.cc's
    --use_quaternions / --use_manifolds). Returns (problem, camera handles,
    point handles)."""
    import torch
    from torch.func import vmap

    from ..autodiff import CostFunction
    from ..examples.snavely import (
        snavely_reprojection_error,
        snavely_reprojection_error_with_quaternions,
    )
    from ..manifolds import EuclideanManifold, ProductManifold, QuaternionManifold
    from ..problem import Problem
    from ..rotation import angle_axis_to_quaternion

    problem = Problem()
    if use_quaternions:
        aa = torch.tensor(bal.cameras[:, :3], dtype=torch.float64)
        quats = vmap(angle_axis_to_quaternion)(aa).numpy()
        cams10 = np.concatenate([quats, bal.cameras[:, 3:]], axis=1)
        manifold = (
            ProductManifold(QuaternionManifold(), EuclideanManifold(6)) if use_manifolds else None
        )
        cam_ids = problem.add_parameter_blocks(cams10, manifold=manifold)
        cf = CostFunction(
            snavely_reprojection_error_with_quaternions, 2, name="snavely_quat",
            kernel="snavely_quat",
        )
    else:
        cam_ids = problem.add_parameter_blocks(bal.cameras)
        cf = CostFunction(snavely_reprojection_error, 2, name="snavely", kernel="snavely")
    pt_ids = problem.add_parameter_blocks(bal.points)
    param_ids = np.stack([cam_ids[bal.camera_index], pt_ids[bal.point_index]], axis=1)
    problem.add_residual_blocks(cf, loss, param_ids, (bal.observations,))
    return problem, cam_ids, pt_ids
