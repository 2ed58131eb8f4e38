"""Uniform visibility: a frozen copy of ceres_tpu_torch.io.bal.synthetic_bal.

Every observation goes to a uniformly random camera, so every camera pair
shares points and camera loads are even; each point is seen at least
twice. It draws the same numbers in the same order as synthetic_bal, and
also returns the true parameters.
"""

from __future__ import annotations

import numpy as np

import generator


def _matrix_to_angle_axis(r: np.ndarray) -> np.ndarray:
    """synthetic_bal's conversion of one rotation matrix (kept as it is, so
    that this model draws bitwise what synthetic_bal draws)."""
    angle = np.arccos(np.clip((np.trace(r) - 1) / 2, -1.0, 1.0))
    if angle < 1e-12:
        return np.zeros(3)
    axis = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / (
        2 * np.sin(angle)
    )
    return angle * axis


def draw(config: dict, traffic: dict, seed: int) -> generator.Generated:
    """ceres_tpu_torch.io.bal.synthetic_bal(num_cameras, num_points,
    num_observations, seed) with its default noise and perturbation, draw
    for draw; also returns the true parameters."""
    num_cameras = int(config["num_cameras"])
    num_points = int(config["num_points"])
    num_observations = int(config["num_observations"])
    observation_noise = float(traffic["observation_noise"])
    perturb_points = float(traffic["perturb_points"])
    perturb_rotation = float(traffic["perturb_rotation"])
    rng = generator.rng_for(seed)

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
    base = np.arange(num_points)
    k = min(2 * num_points, num_observations)
    pt_idx[:k] = np.concatenate([base, base])[:k]

    obs = np.empty((num_observations, 2))
    pix, _ = generator.project(cameras_true[cam_idx], points_true[pt_idx])
    obs[:, 0] = pix[:, 0] + rng.normal(0, observation_noise, num_observations)
    obs[:, 1] = pix[:, 1] + rng.normal(0, observation_noise, num_observations)

    cameras = cameras_true.copy()
    points = points_true + rng.normal(0, perturb_points, points_true.shape)
    cameras[:, :3] += rng.normal(0, perturb_rotation, (num_cameras, 3))
    return generator.Generated(cameras, points, cam_idx, pt_idx, obs, cameras_true, points_true)
