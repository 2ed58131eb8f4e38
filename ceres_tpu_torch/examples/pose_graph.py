"""Pose-graph SLAM (2D and 3D): g2o parsing, cost functors, problem build.

Port of `ceres_tpu.examples.pose_graph` (reference:
examples/slam/pose_graph_2d/*, examples/slam/pose_graph_3d/*). 2D poses
are (x, y, yaw) with yaw on SO(2) through angle normalization; 3D poses
are a position and a quaternion [x, y, z, w] on the
EigenQuaternionManifold, as in the reference. Each residual is weighted by
the square root of its edge's information matrix.

The builders store each square-root information matrix flattened, [m, 9]
or [m, 36]: B1 generic takes data leaves of rank ≤ 2 only (as the JAX
package's group_kernel does), and the functors reshape it, so they also
take the [3, 3] / [6, 6] matrix the JAX functors take. On a card both
functors run through B1 generic (functor_codegen.py): the 2D one with its
`floor`, the 3D one with the EigenQuaternion plus-Jacobian of its two
quaternion positions fused in.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..autodiff import CostFunction
from ..manifolds import EigenQuaternionManifold
from ..problem import Problem

# ------------------------------- 2D ---------------------------------- #


def normalize_angle(a):
    """Wrap to [-pi, pi) (pose_graph_2d/normalize_angle.h)."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


def pose_graph_2d_residual(params, data):
    """params = (pose_a [3], pose_b [3]), pose = [x, y, yaw]; data =
    (measurement [3], sqrt_information [3, 3] or [9]) -> [3]
    (pose_graph_2d_error_term.h). One-element slices, not 0-d selects, as
    in examples/snavely.py."""
    pa, pb = params
    meas, sqrt_info = data
    cos_a = torch.cos(pa[2:3])
    sin_a = torch.sin(pa[2:3])
    # R_aᵀ (p_b - p_a)
    dx = pb[0:1] - pa[0:1]
    dy = pb[1:2] - pa[1:2]
    p_ab = torch.cat([cos_a * dx + sin_a * dy, -sin_a * dx + cos_a * dy])
    r_pos = p_ab - meas[:2]
    r_ang = normalize_angle((pb[2:3] - pa[2:3]) - meas[2:3])
    return sqrt_info.reshape(3, 3) @ torch.cat([r_pos, r_ang])


@dataclasses.dataclass
class PoseGraph2D:
    poses: np.ndarray  # [n, 3] (x, y, yaw)
    edges_ij: np.ndarray  # [m, 2]
    measurements: np.ndarray  # [m, 3]
    sqrt_informations: np.ndarray  # [m, 3, 3]


def build_pose_graph_2d_problem(g: PoseGraph2D):
    """reference: pose_graph_2d.cc BuildOptimizationProblem (the first pose
    constant, which fixes the gauge). Returns (problem, pose handles)."""
    problem = Problem()
    ids = problem.add_parameter_blocks(g.poses)
    cf = CostFunction(pose_graph_2d_residual, 3, name="pg2d")
    pid = np.stack([ids[g.edges_ij[:, 0]], ids[g.edges_ij[:, 1]]], axis=1)
    info = np.asarray(g.sqrt_informations).reshape(len(pid), 9)
    problem.add_residual_blocks(cf, None, pid, (g.measurements, info))
    problem.set_parameter_block_constant(ids[0])
    return problem, ids


def synthetic_pose_graph_2d(n: int = 40, noise: float = 0.05, seed: int = 0):
    """A circle trajectory with odometry edges and n // 4 random loop
    closures (ceres_tpu/examples/pose_graph.py:72-97, the same draws).
    Returns (graph, true poses)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    poses_true = np.stack(
        [10 * np.cos(ang), 10 * np.sin(ang), normalize_angle_np(ang + np.pi / 2)], 1
    )
    edges, meas = [], []
    for i in range(n):
        j = (i + 1) % n
        edges.append((i, j))
        meas.append(relative_pose_2d(poses_true[i], poses_true[j]))
    for _ in range(n // 4):
        i, j = rng.integers(0, n, 2)
        if i != j:
            edges.append((i, j))
            meas.append(relative_pose_2d(poses_true[i], poses_true[j]))
    meas = np.asarray(meas) + rng.normal(0, noise, (len(edges), 3))
    sqrt_info = np.tile(np.eye(3) / noise, (len(edges), 1, 1))
    poses_init = poses_true + rng.normal(0, 0.5, poses_true.shape)
    poses_init[0] = poses_true[0]
    return PoseGraph2D(poses_init, np.asarray(edges), meas, sqrt_info), poses_true


def normalize_angle_np(a):
    return a - 2.0 * np.pi * np.floor((a + np.pi) / (2.0 * np.pi))


def relative_pose_2d(pa, pb):
    """pose_b in pose_a's frame, [x, y, yaw]."""
    c, s = np.cos(pa[2]), np.sin(pa[2])
    d = pb[:2] - pa[:2]
    return np.array(
        [c * d[0] + s * d[1], -s * d[0] + c * d[1], normalize_angle_np(pb[2] - pa[2])]
    )


def load_g2o_2d(path) -> PoseGraph2D:
    """VERTEX_SE2 / EDGE_SE2 lines (pose_graph_2d/read_g2o.h)."""
    poses = {}
    edges, meas, infos = [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE2":
                poses[int(tok[1])] = [float(tok[2]), float(tok[3]), float(tok[4])]
            elif tok[0] == "EDGE_SE2":
                edges.append((int(tok[1]), int(tok[2])))
                meas.append([float(tok[3]), float(tok[4]), float(tok[5])])
                # the upper triangle of the information: I11 I12 I13 I22 I23 I33
                v = [float(t) for t in tok[6:12]]
                info = np.array([[v[0], v[1], v[2]], [v[1], v[3], v[4]], [v[2], v[4], v[5]]])
                infos.append(np.linalg.cholesky(info).T)
    pose_arr = np.zeros((max(poses) + 1, 3))
    for k, v in poses.items():
        pose_arr[k] = v
    return PoseGraph2D(pose_arr, np.asarray(edges), np.asarray(meas), np.asarray(infos))


# ------------------------------- 3D ---------------------------------- #


def _conj(q):
    return torch.cat([-q[:3], q[3:]])


def _qmul(a, b):
    """The product of two [x, y, z, w] quaternions."""
    x = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1]
    y = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0]
    z = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3]
    w = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2]
    return torch.stack([x, y, z, w])


def _rotate(q, p):
    t = 2.0 * torch.linalg.cross(q[:3], p)
    return p + q[3] * t + torch.linalg.cross(q[:3], t)


def pose_graph_3d_residual(params, data):
    """params = (position_a [3], q_a [4], position_b [3], q_b [4]), q as
    [x, y, z, w]; data = (t_ab [3], q_ab [4], sqrt_information [6, 6] or
    [36]) -> [6] (pose_graph_3d_error_term.h)."""
    pa, qa, pb, qb = params
    t_ab, q_ab, sqrt_info = data
    qa_inv = _conj(qa)
    p_ab_est = _rotate(qa_inv, pb - pa)
    q_ab_est = _qmul(qa_inv, qb)
    delta_q = _qmul(_conj(q_ab), q_ab_est)
    r = torch.cat([p_ab_est - t_ab, 2.0 * delta_q[:3]])
    return sqrt_info.reshape(6, 6) @ r


@dataclasses.dataclass
class PoseGraph3D:
    positions: np.ndarray  # [n, 3]
    quaternions: np.ndarray  # [n, 4] xyzw
    edges_ij: np.ndarray  # [m, 2]
    t_measurements: np.ndarray  # [m, 3]
    q_measurements: np.ndarray  # [m, 4] xyzw
    sqrt_informations: np.ndarray  # [m, 6, 6]


def build_pose_graph_3d_problem(g: PoseGraph3D):
    """reference: pose_graph_3d.cc BuildOptimizationProblem (the first pose
    constant). Returns (problem, position handles, quaternion handles)."""
    problem = Problem()
    pos_ids = problem.add_parameter_blocks(g.positions)
    q_ids = problem.add_parameter_blocks(g.quaternions, manifold=EigenQuaternionManifold())
    cf = CostFunction(pose_graph_3d_residual, 6, name="pg3d")
    e = g.edges_ij
    pid = np.stack([pos_ids[e[:, 0]], q_ids[e[:, 0]], pos_ids[e[:, 1]], q_ids[e[:, 1]]], axis=1)
    info = np.asarray(g.sqrt_informations).reshape(len(pid), 36)
    problem.add_residual_blocks(cf, None, pid, (g.t_measurements, g.q_measurements, info))
    problem.set_parameter_block_constant(pos_ids[0])
    problem.set_parameter_block_constant(q_ids[0])
    return problem, pos_ids, q_ids


def load_g2o_3d(path) -> PoseGraph3D:
    """VERTEX_SE3:QUAT / EDGE_SE3:QUAT lines (pose_graph_3d/read_g2o.h)."""
    positions, quats = {}, {}
    edges, tm, qm, infos = [], [], [], []
    iu = np.triu_indices(6)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                idx = int(tok[1])
                positions[idx] = [float(t) for t in tok[2:5]]
                quats[idx] = [float(t) for t in tok[5:9]]
            elif tok[0] == "EDGE_SE3:QUAT":
                edges.append((int(tok[1]), int(tok[2])))
                tm.append([float(t) for t in tok[3:6]])
                qm.append([float(t) for t in tok[6:10]])
                # the upper triangle of the information, row by row
                info = np.zeros((6, 6))
                info[iu] = [float(t) for t in tok[10:31]]
                info = info + np.triu(info, 1).T
                infos.append(np.linalg.cholesky(info).T)
    n = max(positions) + 1
    pos, q = np.zeros((n, 3)), np.zeros((n, 4))
    for k, v in positions.items():
        pos[k] = v
    for k, v in quats.items():
        q[k] = v
    return PoseGraph3D(pos, q, np.asarray(edges), np.asarray(tm), np.asarray(qm), np.asarray(infos))
