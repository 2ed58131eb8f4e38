"""The data-free example modules of the port (misc_examples,
more_garbow_hillstrom, libmv, nist in ceres_tpu_torch/examples) against
ceres_tpu's on the CPU.

- Residuals of every problem at the same inputs within 1e-12 relative (the
  same formulas; exp, log, atan2 and pow of the two libraries differ in
  the last bits).
- Short solves of the same problem in both packages (float64, DENSE_QR or
  the problem's own options): each iteration's cost within 1e-10 relative
  (or 1e-10 of the initial cost, once the cost has fallen to rounding of
  the start's scale) and the same accept/reject sequence, for 5 LM
  iterations: beyond them a converged problem's steps are decided by
  last-bit differences of the two packages.
- End-to-end checks of the port alone, as the JAX package's own tests of
  these modules make them (tests/test_misc_examples.py, test_system.py,
  test_libmv.py, test_nist.py).
- Tests that need the certified NIST files or libmv's problem dumps skip
  when the data is absent, as the JAX package's do.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.examples import libmv as j_libmv
from ceres_tpu.examples import misc_examples as j_misc
from ceres_tpu.examples import more_garbow_hillstrom as j_mgh
from ceres_tpu.examples import nist as j_nist
from ceres_tpu_torch.examples import libmv, misc_examples, more_garbow_hillstrom, nist

torch.set_num_threads(1)
NIST_DIR = "/root/reference/data/nist"
LIBMV_DIR = "/root/reference/data/libmv-ba-problems"


def _costs_match(js, ts, rel=1e-10):
    """Costs within `rel` relative, or `rel` of the initial cost once a
    cost has fallen to where rounding of the start's scale decides it."""
    assert len(js.iterations) == len(ts.iterations)
    floor = rel * js.iterations[0].cost
    for a, b in zip(js.iterations, ts.iterations, strict=True):
        assert a.step_is_successful == b.step_is_successful
        assert b.cost == pytest.approx(a.cost, rel=rel, abs=floor)


def _solve_both(jproblem, tproblem, **kw):
    js = ceres_tpu.solve(ceres_tpu.SolverOptions(**kw), jproblem)
    kw = {k: getattr(ct.LinearSolverType, v.name) if isinstance(v, ceres_tpu.LinearSolverType)
          else v for k, v in kw.items()}
    ts = ct.solve(ct.SolverOptions(device="cpu", **kw), tproblem)
    return js, ts


# -- misc_examples ---------------------------------------------------------- #


def test_circle_fit_matches_jax():
    pts = j_misc.synthetic_circle_points(cx=2.0, cy=-1.0, r=3.0, n=120, outliers=8, seed=1)
    np.testing.assert_array_equal(pts, misc_examples.synthetic_circle_points(
        cx=2.0, cy=-1.0, r=3.0, n=120, outliers=8, seed=1))
    jp, _, _ = j_misc.build_circle_fit_problem(pts)
    tp, xy, m = misc_examples.build_circle_fit_problem(pts)
    js, ts = _solve_both(jp, tp, max_num_iterations=6, fused_execution=False)
    _costs_match(js, ts)
    ts = ct.solve(ct.SolverOptions(max_num_iterations=100, device="cpu"), tp)
    assert ts.final_cost < ts.initial_cost
    cx, cy = tp.parameter_block_value(xy)
    np.testing.assert_allclose([cx, cy, tp.parameter_block_value(m)[0] ** 2], [2.0, -1.0, 3.0],
                               atol=0.1)


def test_robot_pose_mle_matches_jax():
    odometry, ranges, truth = j_misc.simulate_robot(n_steps=12, seed=3)
    jp, _ = j_misc.build_robot_pose_mle_problem(odometry, ranges)
    tp, ids = misc_examples.build_robot_pose_mle_problem(odometry, ranges)
    js, ts = _solve_both(jp, tp, max_num_iterations=4, fused_execution=False)
    _costs_match(js, ts)
    ts = ct.solve(ct.SolverOptions(max_num_iterations=100, device="cpu"), tp)
    assert ts.termination_type == ct.TerminationType.CONVERGENCE
    est = np.cumsum([tp.parameter_block_value(i)[0] for i in ids])
    assert np.abs(est - truth).max() < 0.05


def test_ellipse_approximation_matches_jax():
    rng = np.random.default_rng(5)
    t = rng.uniform(-np.pi, np.pi, 200)
    pts = np.stack([2.0 * np.cos(t), np.sin(t)], axis=1) + rng.normal(0, 0.01, (200, 2))
    jp, _ = j_misc.build_ellipse_approximation_problem(pts, n_segments=24)
    tp, vert_ids = misc_examples.build_ellipse_approximation_problem(pts, n_segments=24)
    js, ts = _solve_both(jp, tp, max_num_iterations=5, fused_execution=False)
    _costs_match(js, ts)
    ts = ct.solve(ct.SolverOptions(max_num_iterations=60, device="cpu"), tp)
    verts = np.stack([tp.parameter_block_value(v) for v in vert_ids])
    assert np.abs((verts[:, 0] / 2.0) ** 2 + verts[:, 1] ** 2 - 1.0).mean() < 0.1


# -- Moré-Garbow-Hillstrom -------------------------------------------------- #

NAMES = [p.name for p in j_mgh.PROBLEMS]


@pytest.mark.parametrize("name", NAMES)
def test_mgh_residuals_at_certified_start(name):
    jt = j_mgh.PROBLEMS[NAMES.index(name)]
    tt = more_garbow_hillstrom.PROBLEMS[NAMES.index(name)]
    assert (tt.name, tt.num_residuals, tt.f_min, tt.constrained_f_min) == (
        jt.name, jt.num_residuals, jt.f_min, jt.constrained_f_min)
    np.testing.assert_array_equal(tt.x0, jt.x0)
    for a, b in ((tt.lower_bounds, jt.lower_bounds), (tt.upper_bounds, jt.upper_bounds),
                 (tt.x_min, jt.x_min)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(NAMES.index(name))
    for x in (jt.x0, jt.x0 * (1.0 + 0.1 * rng.normal(size=jt.x0.shape))):
        want = np.asarray(jt.residual_fn((jnp.asarray(x),), ()))
        got = tt.residual_fn((torch.tensor(x),), ()).numpy()
        assert got.shape == (jt.num_residuals,)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


SHORT = ["rosenbrock", "freudenstein_roth", "beale", "helical_valley", "bard", "box_3d",
         "powell_singular", "wood", "kowalik_osborne", "osborne_1"]


@pytest.mark.parametrize("name", SHORT)
def test_mgh_short_solve_matches_jax(name):
    jp, _ = j_mgh.PROBLEMS[NAMES.index(name)].build()
    tp, _ = more_garbow_hillstrom.PROBLEMS[NAMES.index(name)].build()
    js, ts = _solve_both(jp, tp, linear_solver_type=ceres_tpu.LinearSolverType.DENSE_QR,
                         max_num_iterations=5, function_tolerance=0.0, gradient_tolerance=0.0,
                         parameter_tolerance=0.0)
    _costs_match(js, ts)


@pytest.mark.parametrize("name", ["beale", "box_3d", "wood"])
def test_mgh_constrained_solve_matches_jax(name):
    jp, _ = j_mgh.PROBLEMS[NAMES.index(name)].build(constrained=True)
    tp, b = more_garbow_hillstrom.PROBLEMS[NAMES.index(name)].build(constrained=True)
    js, ts = _solve_both(jp, tp, linear_solver_type=ceres_tpu.LinearSolverType.DENSE_QR,
                         max_num_iterations=5)
    _costs_match(js, ts)
    tt = more_garbow_hillstrom.PROBLEMS[NAMES.index(name)]
    x = tp.parameter_block_value(b)
    assert np.all(x >= tt.lower_bounds) and np.all(x <= tt.upper_bounds)


def test_mgh_unconstrained_problem_refuses_bounds():
    with pytest.raises(ValueError, match="no bound constraints"):
        more_garbow_hillstrom.PROBLEMS[NAMES.index("bard")].build(constrained=True)


@pytest.mark.parametrize("name", ["rosenbrock", "helical_valley", "gaussian", "osborne_2"])
def test_mgh_reaches_certified_cost(name):
    """tests/test_system.py:29's accuracy run on the port."""
    tt = more_garbow_hillstrom.PROBLEMS[NAMES.index(name)]
    problem, _ = tt.build()
    s = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_QR, max_num_iterations=200,
        function_tolerance=1e-14, gradient_tolerance=1e-12, parameter_tolerance=1e-12,
        device="cpu"), problem)
    assert s.termination_type == ct.TerminationType.CONVERGENCE
    assert s.final_cost <= max(tt.f_min * 1.01 + 1e-10, 1e-10)


# -- libmv ------------------------------------------------------------------ #

H_TRUE = np.array([[1.243715, -0.461057, -111.964454], [0.0, 0.617589, -192.379252],
                   [0.0, -0.000983, 1.0]])


def _project(h, x):
    y = (h @ np.concatenate([x, np.ones((x.shape[0], 1))], axis=1).T).T
    return y[:, :2] / y[:, 2:3]


def test_homography_terms_and_dlt_match_jax():
    rng = np.random.default_rng(1)
    x1 = rng.uniform(-100, 100, (8, 2))
    h = np.array([[1.1, 0.02, 3.0], [-0.05, 0.95, -2.0], [1e-4, -2e-4, 1.0]])
    x2 = _project(h, x1) + rng.normal(0, 0.5, (8, 2))
    np.testing.assert_array_equal(libmv.homography_dlt(x1, x2), j_libmv.homography_dlt(x1, x2))
    for a, b in zip(x1, x2):
        want = j_libmv.symmetric_geometric_distance(h, jnp.asarray(a), jnp.asarray(b))
        assert libmv.symmetric_geometric_distance(h, a, b) == pytest.approx(want, rel=1e-12)
        xy = np.concatenate([a, b])
        want = np.asarray(j_libmv.homography_residual((jnp.asarray(h.reshape(-1)),),
                                                      (jnp.asarray(xy),)))
        got = libmv.homography_residual((torch.tensor(h.reshape(-1)),), (torch.tensor(xy),))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_homography_recovery():
    """tests/test_libmv.py:26 on the port: DLT, then the refinement with
    the absolute termination callback."""
    x1 = np.random.default_rng(0).uniform(0, 500, (10, 2))
    h_est, summary = libmv.estimate_homography(
        x1, _project(H_TRUE, x1), libmv.EstimateHomographyOptions(
            max_num_iterations=60, expected_average_symmetric_distance=1e-12), device="cpu")
    np.testing.assert_allclose(h_est, H_TRUE, rtol=1e-4, atol=1e-4)
    assert summary.termination_type in (ct.TerminationType.CONVERGENCE,
                                        ct.TerminationType.USER_SUCCESS)


def _euc_scene(seed=0, k1=-0.05):
    """tests/test_libmv.py:57's scene, observations from the port's model."""
    rng = np.random.default_rng(seed)
    intrinsics = np.array([800.0, 320.0, 240.0, k1, 0.0, 0.0, 0.0, 0.0])
    points = rng.normal(0.0, 1.0, (40, 3)) + np.array([0.0, 0.0, 8.0])
    cams = np.stack([np.concatenate([rng.normal(0, 0.05, 3),
                                     np.array([0.5 * i - 1.0, 0.1 * i, 0.0])
                                     + rng.normal(0, 0.02, 3)]) for i in range(4)])
    ci, pi = np.repeat(np.arange(4), 40), np.tile(np.arange(40), 4)
    obs = np.stack([libmv.opencv_reprojection_residual(
        (torch.tensor(intrinsics), torch.tensor(cams[c]), torch.tensor(points[p])),
        (torch.zeros(2, dtype=torch.float64),)).numpy() for c, p in zip(ci, pi)])
    return intrinsics, cams, points, ci, pi, obs


def test_reprojection_residual_matches_jax():
    intr, cams, pts, ci, pi, obs = _euc_scene()
    for c, p in ((0, 0), (3, 17), (2, 39)):
        args = (intr, cams[c], pts[p])
        want = np.asarray(j_libmv.opencv_reprojection_residual(
            tuple(jnp.asarray(a) for a in args), (jnp.zeros(2),)))
        got = libmv.opencv_reprojection_residual(tuple(torch.tensor(a) for a in args),
                                                 (torch.zeros(2, dtype=torch.float64),))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("case", ["no_intrinsics", "focal_k1", "no_translation"])
def test_euc_bundle_adjust(case):
    """tests/test_libmv.py:85-143 on the port, each solve beside ceres_tpu's
    for its first iterations."""
    intr, cams, pts, ci, pi, obs = _euc_scene()
    rng = np.random.default_rng(3)
    kw = {}
    if case == "no_intrinsics":
        cams = cams + rng.normal(0, 1e-3, cams.shape)
        pts = pts + rng.normal(0, 1e-2, pts.shape)
    elif case == "focal_k1":
        intr = intr.copy()
        intr[0], intr[3] = 780.0, 0.0
        flags = libmv.BundleIntrinsics
        kw["bundle_intrinsics"] = flags.FOCAL_LENGTH | flags.RADIAL_K1
    else:
        cams = cams.copy()
        cams[:, :3] += rng.normal(0, 1e-3, (4, 3))
        kw["bundle_constraints"] = libmv.BundleConstraints.NO_TRANSLATION
    jkw = {k: getattr(j_libmv, type(v).__name__)(int(v)) for k, v in kw.items()}
    short = dict(max_num_iterations=3, fused_execution=False)
    js = j_libmv.euc_bundle_adjust(
        intr, cams, pts, ci, pi, obs, solver_options=ceres_tpu.SolverOptions(
            linear_solver_type=ceres_tpu.LinearSolverType.ITERATIVE_SCHUR, **short), **jkw)[3]
    ts = libmv.euc_bundle_adjust(intr, cams, pts, ci, pi, obs, solver_options=ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR, device="cpu", **short), **kw)[3]
    _costs_match(js, ts, rel=1e-9)
    intr2, cams2, _, s = libmv.euc_bundle_adjust(intr, cams, pts, ci, pi, obs, device="cpu", **kw)
    if case == "no_intrinsics":
        assert s.termination_type == ct.TerminationType.CONVERGENCE and s.final_cost < 1e-6
        np.testing.assert_array_equal(intr2, intr)
    elif case == "focal_k1":
        assert s.final_cost < 1e-5 and abs(intr2[0] - 800.0) < 1.0 and abs(intr2[3] + 0.05) < 5e-3
        np.testing.assert_array_equal(intr2[[1, 2, 4, 5, 6, 7]], intr[[1, 2, 4, 5, 6, 7]])
    else:
        assert s.final_cost < 1e-6
        np.testing.assert_array_equal(cams2[:, 3:], cams[:, 3:])


def _write_libmv_problem(path, scene):
    """A blender problem dump (libmv_bundle_adjuster.cc:263-450) of a scene."""
    intr, cams, pts, ci, pi, obs = scene
    from scipy.spatial.transform import Rotation

    parts = [b"v", b"P", intr.astype("<f4").tobytes(), np.int32(len(cams)).tobytes()]
    for i, c in enumerate(cams):
        r = Rotation.from_rotvec(c[:3]).as_matrix()
        parts += [np.int32(i).tobytes(), r.T.astype("<f4").tobytes(), c[3:].astype("<f4").tobytes()]
    parts.append(np.int32(len(pts)).tobytes())
    for j, p in enumerate(pts):
        parts += [np.int32(j).tobytes(), p.astype("<f4").tobytes()]
    parts.append(np.int32(len(obs)).tobytes())
    for c, p, o in zip(ci, pi, obs):
        parts += [np.array([c, p], "<i4").tobytes(), o.astype("<f4").tobytes()]
    path.write_bytes(b"".join(parts))


def test_read_libmv_problem_matches_jax(tmp_path):
    path = tmp_path / "scene.bin"
    _write_libmv_problem(path, _euc_scene())
    j, t = j_libmv.read_libmv_problem(str(path)), libmv.read_libmv_problem(str(path))
    assert t.is_image_space == j.is_image_space
    for f in ("intrinsics", "camera_valid", "points", "point_valid", "markers"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    np.testing.assert_allclose(t.cameras_Rt, j.cameras_Rt, rtol=1e-12, atol=1e-12)
    _, _, _, s = libmv.solve_libmv_problem(t, refine_intrinsics="radial", device="cpu",
                                           solver_options=None)
    assert s.final_cost <= s.initial_cost
    with pytest.raises(ValueError, match="refine_intrinsics"):
        libmv.solve_libmv_problem(t, refine_intrinsics="tangential", device="cpu")


def test_libmv_problem_01_if_present():
    """tests/test_libmv.py:176 on the port; skips without the dumps."""
    if not os.path.isdir(LIBMV_DIR):
        pytest.skip("libmv problem dumps not mounted")
    p = libmv.read_libmv_problem(os.path.join(LIBMV_DIR, "problem_01.bin"))
    intr, _, _, s = libmv.solve_libmv_problem(p, refine_intrinsics="none", device="cpu")
    assert s.final_cost <= s.initial_cost
    np.testing.assert_array_equal(intr, p.intrinsics)


# -- NIST ------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(j_nist.MODELS))
def test_nist_model_matches_jax(name):
    assert set(nist.MODELS) == set(j_nist.MODELS)
    assert nist.DIFFICULTY == j_nist.DIFFICULTY and nist.NUM_PREDICTORS == j_nist.NUM_PREDICTORS
    rng = np.random.default_rng(len(name))
    b = rng.uniform(0.5, 2.0, 9)
    for _ in range(3):
        x = rng.uniform(0.5, 3.0, nist.NUM_PREDICTORS.get(name, 1))
        x = x[0] if x.size == 1 else x
        want = float(j_nist.MODELS[name](jnp.asarray(b), jnp.asarray(x)))
        got = float(nist.MODELS[name](torch.tensor(b), torch.tensor(x)))
        assert got == pytest.approx(want, rel=1e-12, abs=1e-14)


DAT = """Misra1a synthetic

File Format:   ASCII
               Starting Values   (lines 41 to 42)
               Certified Values  (lines 41 to 42)
               Data              (lines 61 to 74)

Model:         Exponential Class
               2 Parameters (b1 to b2)

               1 Predictor Variable
               14 Observations

          Start 1     Start 2           Parameter     Standard Deviation
  b1 =   500         250           {b1:.15e}  1.0E+00
  b2 =   1.0E-04     5.0E-04       {b2:.15e}  1.0E-06

Residual Sum of Squares:                    {rss:.15e}

Data:   y               x
{rows}
"""


def _synthetic_dat(tmp_path):
    """A Misra1a-shaped .dat file: the model at b = (238.9, 5.5e-4) plus noise."""
    rng = np.random.default_rng(0)
    x = np.linspace(77.6, 789.0, 14)
    y = 238.9 * (1.0 - np.exp(-5.5e-4 * x)) + rng.normal(0, 0.05, 14)
    rows = "\n".join(f"  {a:.10f}  {b:.10f}" for a, b in zip(y, x))
    # the least-squares fit, certified by scipy
    from scipy.optimize import least_squares

    fit = least_squares(lambda b: y - b[0] * (1.0 - np.exp(-b[1] * x)), [250.0, 5e-4],
                        xtol=1e-15, ftol=1e-15, gtol=1e-15, x_scale=[100.0, 1e-4])
    path = tmp_path / "Misra1a.dat"
    path.write_text(DAT.format(b1=fit.x[0], b2=fit.x[1], rss=2 * fit.cost, rows=rows))
    return str(path)


def test_nist_parse_fit_and_summarize_match_jax(tmp_path):
    path = _synthetic_dat(tmp_path)
    jd, td = j_nist.parse_nist_dat(path), nist.parse_nist_dat(path)
    assert (td.name, td.num_predictors, td.certified_cost) == (jd.name, jd.num_predictors,
                                                              jd.certified_cost)
    for f in ("starts", "certified", "data"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    jr = j_nist.fit_nist_dataset(jd)
    tr = nist.fit_nist_dataset(td, device="cpu")
    assert len(tr) == len(jr) == 2
    for a, b in zip(jr, tr):
        assert b.success == a.success and b.lre > 4.0
        assert b.final_cost == pytest.approx(a.final_cost, rel=1e-9)
    results = nist.run_nist(str(tmp_path), device="cpu")
    assert list(results) == ["misra1a"]
    assert nist.summarize_nist(results)["easy"] == (2, 2)
    assert nist.log_relative_error(np.array([1.0]), np.array([1.0])) == 11.0


def test_nist_certified_datasets_if_present():
    """tests/test_nist.py's representative fits on the port; skips without
    the certified files."""
    if not os.path.isdir(NIST_DIR):
        pytest.skip("certified NIST data not mounted")
    results = nist.run_nist(NIST_DIR, names={"misra1a", "chwirut2", "kirby2"}, device="cpu")
    assert all(r.success for rs in results.values() for r in rs)
