"""Smaller example problems from the reference's examples/ directory.

reference: circle_fit.cc, ellipse_approximation.cc, robot_pose_mle.cc —
re-implemented as problem builders over synthetic data (the reference's
stdin/datafile inputs are replaced by generators). Port of
ceres_tpu/examples/misc_examples.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..autodiff import CostFunction
from ..loss import CauchyLoss
from ..problem import Problem


# --- circle fit (circle_fit.cc) ------------------------------------------ #

def circle_distance_residual(params, data):
    """Algebraic circle distance with radius parameterized as r = m^2 so it
    stays positive (circle_fit.cc DistanceFromCircleCost)."""
    xy, m = params
    (pt,) = data
    r = m[0] * m[0]
    dx = pt[0] - xy[0]
    dy = pt[1] - xy[1]
    # delta in squared distance (the reference's robust formulation)
    return torch.stack([r * r - (dx * dx + dy * dy)]) / (2.0 * r)


def build_circle_fit_problem(points, loss=CauchyLoss(1.0)):
    problem = Problem()
    cx = float(np.mean(points[:, 0]))
    cy = float(np.mean(points[:, 1]))
    r0 = float(np.mean(np.linalg.norm(points - [cx, cy], axis=1)))
    xy = problem.add_parameter_block([cx, cy])
    m = problem.add_parameter_block([np.sqrt(max(r0, 1e-3))])
    cf = CostFunction(circle_distance_residual, 1, name="circle")
    ids = np.tile([xy, m], (points.shape[0], 1))
    problem.add_residual_blocks(cf, loss, ids, (points,))
    return problem, xy, m


def synthetic_circle_points(cx=2.0, cy=-1.0, r=3.0, n=100, noise=0.05,
                            outliers=5, seed=0):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack(
        [cx + r * np.cos(ang), cy + r * np.sin(ang)], axis=1
    ) + rng.normal(0, noise, (n, 2))
    if outliers:
        pts[rng.choice(n, outliers, replace=False)] += rng.normal(0, 2.0, (outliers, 2))
    return pts


# --- robot pose MLE (robot_pose_mle.cc) ---------------------------------- #
#
# 1-D corridor localization: odometry u_i with noise, range readings y_i to
# the far wall. Parameters: per-step odometry corrections.

ODOMETRY_STDDEV = 0.1
RANGE_STDDEV = 0.01
CORRIDOR_LENGTH = 30.0


def odometry_residual(params, data):
    (odom,) = params
    (meas,) = data
    return torch.stack([(odom[0] - meas[0]) / ODOMETRY_STDDEV])


def range_residual(params, data):
    # params = all odometry values up to step i (cumulative position)
    odoms = torch.cat([p for p in params])
    (obs,) = data
    pos = torch.sum(odoms)
    return torch.stack([(CORRIDOR_LENGTH - pos - obs[0]) / RANGE_STDDEV])


def build_robot_pose_mle_problem(odometry_meas, range_meas):
    """Each step adds one odometry residual + one range residual over the
    pose history (robot_pose_mle.cc OdometryConstraint/RangeConstraint).
    Range residuals have growing arity — each is its own signature group,
    like the reference's DynamicAutoDiffCostFunction instances."""
    problem = Problem()
    odom_ids = [problem.add_parameter_block([float(u)]) for u in odometry_meas]
    cf_odo = CostFunction(odometry_residual, 1, name="odom")
    for i, u in enumerate(odometry_meas):
        problem.add_residual_block(
            cf_odo, None, [odom_ids[i]], (np.array([u]),)
        )
    for i, y in enumerate(range_meas):
        cf_rng = CostFunction(range_residual, 1, name=f"range{i}")
        problem.add_residual_block(
            cf_rng, None, odom_ids[: i + 1], (np.array([y]),)
        )
    return problem, odom_ids


def simulate_robot(n_steps=20, step=1.0, seed=0):
    rng = np.random.default_rng(seed)
    true_positions = np.cumsum(np.full(n_steps, step))
    odometry = step + rng.normal(0, ODOMETRY_STDDEV, n_steps)
    ranges = CORRIDOR_LENGTH - true_positions + rng.normal(0, RANGE_STDDEV, n_steps)
    return odometry, ranges, true_positions


# --- ellipse approximation (ellipse_approximation.cc) --------------------- #

def build_ellipse_approximation_problem(data_points, n_segments=32):
    """Fit a closed piecewise-linear curve to points sampled from an
    ellipse; each data point associates softly with one segment (the
    reference fixes the data-to-segment assignment; we do the same using
    nearest arc-length)."""
    t = np.arctan2(data_points[:, 1], data_points[:, 0] / 2.0)
    seg = ((t + np.pi) / (2 * np.pi) * n_segments).astype(int) % n_segments
    frac = ((t + np.pi) / (2 * np.pi) * n_segments) % 1.0

    problem = Problem()
    ang = np.linspace(-np.pi, np.pi, n_segments, endpoint=False)
    verts0 = np.stack([2.0 * np.cos(ang), np.sin(ang)], axis=1)
    vert_ids = problem.add_parameter_blocks(verts0)

    def seg_residual(params, data):
        a, b = params
        obs, w = data
        pt = (1.0 - w[0]) * a + w[0] * b
        return pt - obs

    cf = CostFunction(seg_residual, 2, name="ellipse_seg")
    ids = np.stack(
        [vert_ids[seg], vert_ids[(seg + 1) % n_segments]], axis=1
    )
    problem.add_residual_blocks(
        cf, None, ids, (data_points, frac[:, None])
    )
    return problem, vert_ids
