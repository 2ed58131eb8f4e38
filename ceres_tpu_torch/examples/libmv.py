"""libmv-style examples: homography estimation and Euclidean bundle
adjustment with a shared OpenCV-distortion intrinsics block.

reference: examples/libmv_homography.cc (symmetric-geometric-distance
homography refinement with an absolute-error termination callback) and
examples/libmv_bundle_adjuster.cc (EUC bundle: angle-axis R|t per view,
shared 8-parameter intrinsics block with BundleIntrinsics bit flags choosing
which intrinsics to refine via a subset manifold).

Port of ceres_tpu/examples/libmv.py. All correspondences/observations are
single residual batches, so each evaluation is one group (B1 generic on a
card); the shared intrinsics block is a high-degree f-block exercising the
Schur partition's shared-parameter path. The solves take `device` as every
entry point of the port does (None: the card).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..autodiff import CostFunction
from ..manifolds import SubsetManifold
from ..problem import Problem
from ..rotation import angle_axis_rotate_point
from ..solvers.solver import solve
from ..types import (
    CallbackReturnType,
    LinearSolverType,
    SolverOptions,
)


# ------------------------------------------------------------------ #
# homography (libmv_homography.cc)
# ------------------------------------------------------------------ #


def symmetric_geometric_distance_terms(h, x1, x2):
    """forward = D(H x1, x2), backward = D(H^-1 x2, x1); 4 residuals.

    reference: libmv_homography.cc:110-129.
    """
    x = torch.cat([x1, torch.ones(1, dtype=x1.dtype, device=x1.device)])
    y = torch.cat([x2, torch.ones(1, dtype=x2.dtype, device=x2.device)])
    hx = h @ x
    hinv_y = torch.linalg.inv(h) @ y
    hx = hx / hx[2]
    hinv_y = hinv_y / hinv_y[2]
    return torch.cat([hx[:2] - x2, hinv_y[:2] - x1])


def homography_residual(params, data):
    (h_flat,) = params
    xy = data[0]
    h = h_flat.reshape(3, 3)
    return symmetric_geometric_distance_terms(h, xy[:2], xy[2:])


def symmetric_geometric_distance(h, x1, x2):
    """Scalar D(H x1, x2)^2 + D(H^-1 x2, x1)^2 (libmv_homography.cc:135)."""
    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64))

    r = symmetric_geometric_distance_terms(f64(h), f64(x1), f64(x2))
    return float(torch.sum(r * r))


def homography_dlt(x1, x2):
    """Algebraic (DLT) initialization from >= 4 correspondences.

    Role of Homography2DFromCorrespondencesLinearEuc in the reference: the
    linear estimate refined by the nonlinear solve."""
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    n = x1.shape[0]
    a = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = x1[i]
        u, v = x2[i]
        a[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        a[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    return h / h[2, 2]


class EstimateHomographyOptions:
    """reference: libmv_homography.cc:84-101."""

    def __init__(
        self,
        max_num_iterations: int = 50,
        expected_average_symmetric_distance: float = 1e-16,
    ):
        self.max_num_iterations = max_num_iterations
        self.expected_average_symmetric_distance = (
            expected_average_symmetric_distance
        )


def estimate_homography(x1, x2, options: EstimateHomographyOptions = None, device=None):
    """DLT init + nonlinear symmetric-geometric refinement.

    Mirrors EstimateHomography2DFromCorrespondences
    (libmv_homography.cc:308-356) including the
    TerminationCheckingCallback: stop as soon as the average symmetric
    distance drops below the absolute threshold (an *absolute* test that
    Ceres's relative function_tolerance cannot express).
    Returns (H [3,3], summary).
    """
    options = options or EstimateHomographyOptions()
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    h0 = homography_dlt(x1, x2)

    problem = Problem()
    hb = problem.add_parameter_block(h0.reshape(-1).copy())
    cf = CostFunction(homography_residual, 4, name="homography_sym")
    data = np.concatenate([x1, x2], axis=1)
    pid = np.full((x1.shape[0], 1), hb)
    problem.add_residual_blocks(cf, None, pid, (data,))

    def termination_callback(it_sum):
        # reference: TerminationCheckingCallback::operator()
        # (libmv_homography.cc:273-301) — requires update_state_every_iteration
        h = problem.parameter_block_value(hb).reshape(3, 3)
        d = np.mean(
            [
                symmetric_geometric_distance(h, a, b)
                for a, b in zip(x1, x2)
            ]
        )
        if d <= options.expected_average_symmetric_distance:
            return CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return CallbackReturnType.SOLVER_CONTINUE

    solver_options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_QR,
        max_num_iterations=options.max_num_iterations,
        update_state_every_iteration=True,
        callbacks=[termination_callback],
        device=device,
    )
    summary = solve(solver_options, problem)
    h = problem.parameter_block_value(hb).reshape(3, 3)
    return h / h[2, 2], summary


# ------------------------------------------------------------------ #
# EUC bundle adjustment (libmv_bundle_adjuster.cc)
# ------------------------------------------------------------------ #

# intrinsics block layout (libmv_bundle_adjuster.cc:196-205)
OFFSET_FOCAL_LENGTH = 0
OFFSET_PRINCIPAL_POINT_X = 1
OFFSET_PRINCIPAL_POINT_Y = 2
OFFSET_K1 = 3
OFFSET_K2 = 4
OFFSET_K3 = 5
OFFSET_P1 = 6
OFFSET_P2 = 7
NUM_INTRINSICS = 8


class BundleIntrinsics(enum.IntFlag):
    """Which intrinsics to refine (libmv_bundle_adjuster.cc:174-187)."""

    NO_INTRINSICS = 0
    FOCAL_LENGTH = 1
    PRINCIPAL_POINT = 2
    RADIAL_K1 = 4
    RADIAL_K2 = 8
    RADIAL = 12
    TANGENTIAL_P1 = 16
    TANGENTIAL_P2 = 32
    TANGENTIAL = 48


class BundleConstraints(enum.IntFlag):
    """reference: libmv_bundle_adjuster.cc:189-193."""

    NO_CONSTRAINTS = 0
    NO_TRANSLATION = 1


def apply_radial_distortion(intrinsics, xn, yn):
    """OpenCV polynomial distortion model, normalized -> pixel coordinates.
    reference: ApplyRadialDistortionCameraIntrinsics
    (libmv_bundle_adjuster.cc:459-487)."""
    f = intrinsics[OFFSET_FOCAL_LENGTH]
    cx = intrinsics[OFFSET_PRINCIPAL_POINT_X]
    cy = intrinsics[OFFSET_PRINCIPAL_POINT_Y]
    k1 = intrinsics[OFFSET_K1]
    k2 = intrinsics[OFFSET_K2]
    k3 = intrinsics[OFFSET_K3]
    p1 = intrinsics[OFFSET_P1]
    p2 = intrinsics[OFFSET_P2]
    r2 = xn * xn + yn * yn
    r_coeff = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * r_coeff + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * r_coeff + 2.0 * p2 * xn * yn + p1 * (r2 + 2.0 * yn * yn)
    return f * xd + cx, f * yd + cy


def opencv_reprojection_residual(params, data):
    """reference: OpenCVReprojectionError (libmv_bundle_adjuster.cc:492-560).
    params = (intrinsics [8], R_t [6] angle-axis+translation, X [3])."""
    intrinsics, r_t, x3 = params
    obs = data[0]
    xc = angle_axis_rotate_point(r_t[:3], x3) + r_t[3:]
    xn = xc[0] / xc[2]
    yn = xc[1] / xc[2]
    px, py = apply_radial_distortion(intrinsics, xn, yn)
    return torch.stack([px - obs[0], py - obs[1]])


def euc_bundle_adjust(
    intrinsics,
    cameras_Rt,
    points,
    camera_index,
    point_index,
    observations,
    bundle_intrinsics: BundleIntrinsics = BundleIntrinsics.NO_INTRINSICS,
    bundle_constraints: BundleConstraints = BundleConstraints.NO_CONSTRAINTS,
    solver_options: SolverOptions = None,
    lock_first_camera: bool = False,
    device=None,
):
    """EUC (metric) bundle adjustment with a shared intrinsics block.

    Mirrors EuclideanBundleCommonIntrinsics
    (libmv_bundle_adjuster.cc:568-704): per-view [angle-axis|t] blocks, one
    intrinsics block shared by all observations (constant when
    NO_INTRINSICS, otherwise a SubsetManifold freezes the non-bundled
    coefficients), NO_TRANSLATION freezes t via a SubsetManifold on R_t.
    Mutates/returns updated (intrinsics, cameras_Rt, points) plus summary.
    `device` applies to the default solver options only.
    """
    intrinsics = np.asarray(intrinsics, dtype=np.float64).copy()
    cameras_Rt = np.asarray(cameras_Rt, dtype=np.float64).copy()
    points = np.asarray(points, dtype=np.float64).copy()

    problem = Problem()
    ib = problem.add_parameter_block(intrinsics)
    cam_ids = problem.add_parameter_blocks(cameras_Rt)
    pt_ids = problem.add_parameter_blocks(points)

    if bundle_intrinsics == BundleIntrinsics.NO_INTRINSICS:
        problem.set_parameter_block_constant(ib)
    else:
        constant = []
        flag_of_offset = {
            OFFSET_FOCAL_LENGTH: BundleIntrinsics.FOCAL_LENGTH,
            OFFSET_PRINCIPAL_POINT_X: BundleIntrinsics.PRINCIPAL_POINT,
            OFFSET_PRINCIPAL_POINT_Y: BundleIntrinsics.PRINCIPAL_POINT,
            OFFSET_K1: BundleIntrinsics.RADIAL_K1,
            OFFSET_K2: BundleIntrinsics.RADIAL_K2,
            OFFSET_P1: BundleIntrinsics.TANGENTIAL_P1,
            OFFSET_P2: BundleIntrinsics.TANGENTIAL_P2,
        }
        for off in range(NUM_INTRINSICS):
            flag = flag_of_offset.get(off)
            if flag is None or not (bundle_intrinsics & flag):
                constant.append(off)  # k3 is never bundled, like the ref
        if constant:
            problem.set_manifold(ib, SubsetManifold(NUM_INTRINSICS, constant))

    if bundle_constraints & BundleConstraints.NO_TRANSLATION:
        for c in cam_ids:
            problem.set_manifold(c, SubsetManifold(6, [3, 4, 5]))

    if lock_first_camera and len(camera_index):
        # reference locks the first observed camera against gauge ambiguity
        # (libmv_bundle_adjuster.cc:718-722)
        problem.set_parameter_block_constant(
            cam_ids[int(np.asarray(camera_index)[0])]
        )

    cf = CostFunction(opencv_reprojection_residual, 2, name="opencv_reproj")
    pid = np.stack(
        [
            np.full(len(camera_index), ib),
            cam_ids[np.asarray(camera_index)],
            pt_ids[np.asarray(point_index)],
        ],
        axis=1,
    )
    problem.add_residual_blocks(
        cf, None, pid, (np.asarray(observations, dtype=np.float64),)
    )

    solver_options = solver_options or SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        max_num_iterations=100,
        device=device,
    )
    summary = solve(solver_options, problem)

    intrinsics = problem.parameter_block_value(ib)
    cameras_Rt = np.stack([problem.parameter_block_value(c) for c in cam_ids])
    points = np.stack([problem.parameter_block_value(p) for p in pt_ids])
    return intrinsics, cameras_Rt, points, summary


# ------------------------------------------------------------------ #
# blender/libmv binary problem files (libmv_bundle_adjuster.cc:263-450)
# ------------------------------------------------------------------ #


class LibmvProblem:
    """In-memory form of a blender-dumped BA problem.

    `cameras_Rt[i]` is the [angle-axis | t] 6-vector for image i (rows for
    images without a camera are present but unused); `points[j]` likewise
    indexed by track id. `camera_valid`/`point_valid` mark populated rows.
    """

    def __init__(self, intrinsics, cameras_Rt, camera_valid, points,
                 point_valid, markers, is_image_space):
        self.intrinsics = intrinsics
        self.cameras_Rt = cameras_Rt
        self.camera_valid = camera_valid
        self.points = points
        self.point_valid = point_valid
        self.markers = markers  # [n, 4]: image, track, x, y
        self.is_image_space = is_image_space


def read_libmv_problem(path) -> LibmvProblem:
    """Binary reader for the reference's blender problem dumps.

    Layout (libmv_bundle_adjuster.cc:263-450): leading endianness byte
    'v'/'V', space flag 'P'/'N', 8 float32 intrinsics
    [f, cx, cy, k1, k2, k3, p1, p2], then length-prefixed camera
    (int32 image, 9 float32 column-major R, 3 float32 t), point
    (int32 track, 3 float32 X), and marker (int32 image, int32 track,
    2 float32 xy) tables. All floats are float32 in the file.
    """
    from ..rotation import rotation_matrix_to_angle_axis

    with open(path, "rb") as f:
        buf = f.read()
    endian_flag = buf[0:1]
    if endian_flag == b"v":
        order = "<"
    elif endian_flag == b"V":
        order = ">"
    else:
        raise ValueError(f"{path}: unknown endianness byte {endian_flag!r}")
    space_flag = buf[1:2]
    if space_flag not in (b"P", b"N"):
        raise ValueError(f"{path}: unknown marker space byte {space_flag!r}")
    is_image_space = space_flag == b"P"

    pos = 2

    def read(fmt, count):
        nonlocal pos
        arr = np.frombuffer(buf, dtype=np.dtype(fmt).newbyteorder(order),
                            count=count, offset=pos)
        pos += arr.nbytes
        return arr

    intrinsics = read("f4", 8).astype(np.float64)

    n_cameras = int(read("i4", 1)[0])
    cam_rows = {}
    for _ in range(n_cameras):
        image = int(read("i4", 1)[0])
        r = read("f4", 9).astype(np.float64).reshape(3, 3).T  # column-major
        t = read("f4", 3).astype(np.float64)
        cam_rows[image] = (r, t)

    n_points = int(read("i4", 1)[0])
    pt_rows = {}
    for _ in range(n_points):
        track = int(read("i4", 1)[0])
        pt_rows[track] = read("f4", 3).astype(np.float64)

    n_markers = int(read("i4", 1)[0])
    markers = np.zeros((n_markers, 4), dtype=np.float64)
    for i in range(n_markers):
        image, track = (int(v) for v in read("i4", 2))
        xy = read("f4", 2).astype(np.float64)
        markers[i] = [image, track, xy[0], xy[1]]

    max_image = max(cam_rows) if cam_rows else -1
    if n_markers:
        max_image = max(max_image, int(markers[:, 0].max()))
    cameras_Rt = np.zeros((max_image + 1, 6))
    camera_valid = np.zeros(max_image + 1, dtype=bool)
    for image, (r, t) in cam_rows.items():
        aa = rotation_matrix_to_angle_axis(torch.as_tensor(r)).numpy()
        cameras_Rt[image] = np.concatenate([aa, t])
        camera_valid[image] = True

    max_track = max(pt_rows) if pt_rows else -1
    points = np.zeros((max_track + 1, 3))
    point_valid = np.zeros(max_track + 1, dtype=bool)
    for track, x in pt_rows.items():
        points[track] = x
        point_valid[track] = True

    return LibmvProblem(intrinsics, cameras_Rt, camera_valid, points,
                        point_valid, markers, is_image_space)


def solve_libmv_problem(
    prob: LibmvProblem,
    refine_intrinsics: str = "none",
    solver_options: SolverOptions = None,
    device=None,
):
    """Bundle a loaded blender problem, mirroring main()'s driver
    (libmv_bundle_adjuster.cc:770-820): --refine_intrinsics none|radial,
    first observed camera locked, ITERATIVE_SCHUR + SCHUR_JACOBI with
    nonmonotonic steps. Returns (intrinsics, cameras_Rt, points, summary).
    """
    from ..types import PreconditionerType

    if refine_intrinsics == "radial":
        flags = (BundleIntrinsics.FOCAL_LENGTH | BundleIntrinsics.RADIAL_K1
                 | BundleIntrinsics.RADIAL_K2)
    elif refine_intrinsics in ("none", "", None):
        flags = BundleIntrinsics.NO_INTRINSICS
    else:
        raise ValueError(f"unknown refine_intrinsics {refine_intrinsics!r}")

    # keep only markers whose camera and point both exist (reference skips
    # them one by one at libmv_bundle_adjuster.cc:705-712)
    img = prob.markers[:, 0].astype(int)
    trk = prob.markers[:, 1].astype(int)
    ok = prob.camera_valid[img] & prob.point_valid[trk]
    img, trk = img[ok], trk[ok]
    obs = prob.markers[ok, 2:4]

    # compress to contiguous camera/point rows
    used_cams = np.unique(img)
    used_pts = np.unique(trk)
    cam_of = {c: i for i, c in enumerate(used_cams)}
    pt_of = {p: i for i, p in enumerate(used_pts)}
    camera_index = np.asarray([cam_of[c] for c in img])
    point_index = np.asarray([pt_of[p] for p in trk])

    solver_options = solver_options or SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        use_nonmonotonic_steps=True,
        use_inner_iterations=False,
        max_num_iterations=100,
        device=device,
    )
    intr, cams, pts, summary = euc_bundle_adjust(
        prob.intrinsics,
        prob.cameras_Rt[used_cams],
        prob.points[used_pts],
        camera_index,
        point_index,
        obs,
        bundle_intrinsics=flags,
        solver_options=solver_options,
        lock_first_camera=True,
    )
    new_cams = prob.cameras_Rt.copy()
    new_cams[used_cams] = cams
    new_pts = prob.points.copy()
    new_pts[used_pts] = pts
    return intr, new_cams, new_pts, summary
