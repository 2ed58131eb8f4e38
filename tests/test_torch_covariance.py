"""Covariance (ceres_tpu_torch/covariance.py) and the batched products and
PCG under its ITERATIVE_PCG, against ceres_tpu on the CPU.

- The problems of the JAX package's own covariance tests
  (tests/test_first_order.py:197-300, tests/test_covariance_scale.py) built
  the same way in both packages from numpy: DENSE_SVD and SPARSE_QR blocks
  within 1e-10 relative of ceres_tpu's in float64 (both run the same host
  factorization on the same J; the Jacobians differ by autodiff rounding
  only); ITERATIVE_PCG columns within 1e-8 of the block's scale of
  ceres_tpu's ITERATIVE_PCG (two PCGs over the same operator whose sums
  run in another order), with the same `compute` return, the
  rank-deficient False cases included, with the layout plans engaged (the
  batched B2/B3 plain versions) and without.
- The batched plain versions of B2 and B3 against jax.vmap of
  pallas_onehot.gather_contract / contract_reduce in interpret mode at the
  JAX kernel tests' float32 tolerance 5e-4, and bitwise against k
  single-vector plain calls.
- The batched Jacobian product against k single-vector products (1e-13
  relative: the same sums, one column axis more), and the batched PCG
  against k separate PCGs: the same iterations, convergence and breakdown
  per column (jax.vmap of the JAX loop), x within 1e-12, one read per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu import pallas_onehot as po
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.program import Program as JProgram
from ceres_tpu.types import CovarianceAlgorithmType as JAlgo
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.gather_reduce import (
    contract_reduce_batched,
    contract_reduce_batched_plain,
    contract_reduce_plain,
    gather_contract_batched,
    gather_contract_batched_plain,
    gather_contract_plain,
    lanes_major,
)
from ceres_tpu_torch.jacobian import make_twin
from ceres_tpu_torch.linalg.cg import conjugate_gradients
from ceres_tpu_torch.linalg.preconditioners import BlockDiagSolver
from ceres_tpu_torch.program import Program as TProgram
from ceres_tpu_torch.program import camera_layout
from ceres_tpu_torch.utils.execution_summary import counts

torch.set_num_threads(1)
TOL_F32 = 5e-4
ALGOS = ("DENSE_SVD", "SPARSE_QR", "ITERATIVE_PCG")


def _both(algo, **kw):
    """(ceres_tpu Covariance, port Covariance) with the same options."""
    j = ceres_tpu.Covariance(ceres_tpu.CovarianceOptions(algorithm_type=getattr(JAlgo, algo), **kw))
    t = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=getattr(ct.CovarianceAlgorithmType, algo), device="cpu", **kw))
    return j, t


def _assert_blocks(jc, tc, pairs, rel, tangent=True):
    for bi, bj in pairs:
        want = np.asarray(jc.get_covariance_block(bi, bj, tangent=tangent))
        got = tc.get_covariance_block(bi, bj, tangent=tangent)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300))


# -- the JAX package's small problems ------------------------------------- #


def _regression(pkg, n=30, seed=0):
    """y = a*x + b (tests/test_first_order.py:197)."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, n)
    ys = 2.0 * xs + 1.0 + rng.normal(0, 0.1, n)
    if pkg is ceres_tpu:
        def f(params, data):
            return jnp.stack([data[0][1] - (params[0][0] * data[0][0] + params[0][1])])
    else:
        def f(params, data):
            return torch.stack([data[0][1] - (params[0][0] * data[0][0] + params[0][1])])
    p = pkg.Problem()
    ab = p.add_parameter_block([1.9, 1.1])
    p.add_residual_blocks(pkg.CostFunction(f, 1), None, np.full((n, 1), ab),
                          (np.stack([xs, ys], 1),))
    return p, ab, np.stack([xs, np.ones(n)], axis=1)


@pytest.mark.parametrize("algo", ALGOS)
def test_regression_matches_jax_and_closed_form(algo):
    jp, ab, x_mat = _regression(ceres_tpu)
    tp, ab_t, _ = _regression(ct)
    assert ab == ab_t
    jc, tc = _both(algo)
    assert jc.compute([(ab, ab)], jp) and tc.compute([(ab, ab)], tp)
    _assert_blocks(jc, tc, [(ab, ab)], 1e-10)
    np.testing.assert_allclose(tc.get_covariance_block(ab, ab), np.linalg.inv(x_mat.T @ x_mat),
                               rtol=1e-9)


def _unobserved(pkg):
    """x[1] unobserved: JᵀJ singular (tests/test_first_order.py:222)."""
    stack = jnp.stack if pkg is ceres_tpu else torch.stack
    p = pkg.Problem()
    b = p.add_parameter_block([1.0, 1.0])
    p.add_residual_block(pkg.CostFunction(lambda ps, d: stack([ps[0][0]]), 1), None, [b])
    return p, b


@pytest.mark.parametrize("algo", ALGOS)
def test_rank_deficient_returns_false_as_jax(algo):
    kw = {"iterative_max_iterations": 50} if algo == "ITERATIVE_PCG" else {}
    jc, tc = _both(algo, **kw)
    jp, b = _unobserved(ceres_tpu)
    tp, _ = _unobserved(ct)
    want = jc.compute([(b, b)], jp)
    assert want is False
    assert tc.compute([(b, b)], tp) is want
    with pytest.raises(RuntimeError, match="compute"):
        tc.get_covariance_block(b, b)


def _two_lines(pkg, seed=2, n=40):
    """Two independent regressions in one group (tests/test_first_order.py:234)."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, n)
    ys = 2.0 * xs + 1.0 + rng.normal(0, 0.1, n)
    zs = -0.5 * xs + 0.3 + rng.normal(0, 0.1, n)
    stack = jnp.stack if pkg is ceres_tpu else torch.stack

    def f(params, data):
        ab, cd = params
        (xyz,) = data
        return stack([xyz[1] - (ab[0] * xyz[0] + ab[1]), xyz[2] - (cd[0] * xyz[0] + cd[1])])

    p = pkg.Problem()
    ab = p.add_parameter_block([1.8, 1.2])
    cd = p.add_parameter_block([-0.4, 0.2])
    p.add_residual_blocks(pkg.CostFunction(f, 2), None,
                          np.stack([np.full(n, ab), np.full(n, cd)], axis=1),
                          (np.stack([xs, ys, zs], 1),))
    return p, ab, cd


@pytest.mark.parametrize("algo", ALGOS)
def test_two_blocks_match_jax(algo):
    jp, ab, cd = _two_lines(ceres_tpu)
    tp, _, _ = _two_lines(ct)
    pairs = [(ab, ab), (ab, cd), (cd, cd)]
    jc, tc = _both(algo)
    assert jc.compute(pairs, jp) and tc.compute(pairs, tp)
    _assert_blocks(jc, tc, pairs, 1e-10 if algo != "ITERATIVE_PCG" else 1e-8)


def test_unrequested_and_constant_blocks_raise():
    tp, ab, cd = _two_lines(ct)
    tc = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=ct.CovarianceAlgorithmType.SPARSE_QR, device="cpu"))
    assert tc.compute([(ab, ab)], tp)
    with pytest.raises(ValueError, match="not requested"):
        tc.get_covariance_block(ab, cd)
    tp.set_parameter_block_constant(cd)
    with pytest.raises(ValueError, match="constant"):
        tc.compute([(ab, cd)], tp)


# -- bundle adjustment (tests/test_covariance_scale.py) -------------------- #


def _gauge_fixed(pkg, bal, **kw):
    build = j_build if pkg is ceres_tpu else ct.build_ba_problem
    problem, cams, _ = build(bal, **kw)
    problem.set_parameter_block_constant(cams[0])
    problem.set_parameter_block_constant(cams[1])
    cams = [int(c) for c in cams[2:]]
    return problem, [(c, c) for c in cams[:8]] + [(cams[0], cams[1])]


@pytest.fixture(params=[10**9, 16], ids=["no_plans", "plans"])
def threshold(request, monkeypatch):
    """The layout plans off, and engaged (the onehot camera positions then
    run the batched B2/B3's plain versions), in both packages."""
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", request.param)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", request.param)
    return request.param


BA = synthetic_bal(10, 300, 3000, seed=11, observation_noise=0.5)


# the host algorithms read the same J with or without the plans
@pytest.mark.parametrize("algo,plans", [
    ("DENSE_SVD", True), ("SPARSE_QR", True), ("ITERATIVE_PCG", True), ("ITERATIVE_PCG", False),
])
def test_gauge_fixed_ba_matches_jax(algo, plans, monkeypatch):
    for program in (JProgram, TProgram):
        monkeypatch.setattr(program, "SEG_REDUCE_THRESHOLD", 16 if plans else 10**9)
    kw = {"iterative_max_iterations": 20000}
    jp, pairs = _gauge_fixed(ceres_tpu, BA)
    tp, _ = _gauge_fixed(ct, BA)
    jc, tc = _both(algo, **kw)
    assert jc.compute(pairs, jp) and tc.compute(pairs, tp)
    _assert_blocks(jc, tc, pairs, 1e-10 if algo != "ITERATIVE_PCG" else 1e-8)
    if algo == "ITERATIVE_PCG":
        its = tc.pcg_stats["iterations"]
        assert its.shape == (72,) and its.min() > 0
        assert tc.pcg_stats["reads"] <= its.max() + 1


def test_pcg_rank_deficient_ba_returns_false_as_jax(threshold):
    """Without the gauge fixed JᵀJ is singular
    (tests/test_covariance_scale.py:54): both packages return False."""
    bal = synthetic_bal(6, 80, 400, seed=5, observation_noise=0.0)
    kw = {"iterative_tolerance": 1e-12, "iterative_max_iterations": 200}
    jc, tc = _both("ITERATIVE_PCG", **kw)
    jp, jcams, _ = j_build(bal)
    tp, tcams, _ = ct.build_ba_problem(bal)
    assert jc.compute([(int(jcams[2]), int(jcams[2]))], jp) is False
    assert tc.compute([(int(tcams[2]), int(tcams[2]))], tp) is False


def test_pcg_iteration_cap_warns_and_returns_false(caplog):
    tp, pairs = _gauge_fixed(ct, BA)
    tc = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=ct.CovarianceAlgorithmType.ITERATIVE_PCG, iterative_max_iterations=3,
        device="cpu"))
    with caplog.at_level("WARNING"):
        assert tc.compute(pairs, tp) is False
    assert "hit the iteration cap (3)" in caplog.text
    assert tc.pcg_stats["iterations"].max() == 3


def test_without_loss_matches_jax(threshold):
    """apply_loss_function=False reaches the evaluation (B1's eligibility
    with apply_loss) in both packages: a Huber problem's covariance without
    the loss differs from the one with it and matches ceres_tpu's."""
    out = {}
    for apply_loss in (True, False):
        jp, pairs = _gauge_fixed(ceres_tpu, BA, loss=ceres_tpu.HuberLoss(0.3))
        tp, _ = _gauge_fixed(ct, BA, loss=ct.HuberLoss(0.3))
        jc, tc = _both("ITERATIVE_PCG", apply_loss_function=apply_loss,
                       iterative_max_iterations=20000)
        assert jc.compute(pairs[:2], jp) and tc.compute(pairs[:2], tp)
        _assert_blocks(jc, tc, pairs[:2], 1e-8)
        out[apply_loss] = tc.get_covariance_block(*pairs[0])
    assert np.abs(out[True] - out[False]).max() > 1e-3 * np.abs(out[False]).max()


def test_ambient_block_on_quaternion_cameras_matches_jax():
    """get_covariance_block(tangent=False) lifts a camera block on
    Quaternion x Euclidean(6) through its plus Jacobian, as ceres_tpu."""
    bal = synthetic_bal(6, 60, 400, seed=4, observation_noise=0.5)
    kw = dict(use_quaternions=True, use_manifolds=True)
    jp, pairs = _gauge_fixed(ceres_tpu, bal, **kw)
    tp, _ = _gauge_fixed(ct, bal, **kw)
    jc, tc = _both("DENSE_SVD")
    assert jc.compute(pairs[:3], jp) and tc.compute(pairs[:3], tp)
    _assert_blocks(jc, tc, pairs[:3], 1e-10)
    _assert_blocks(jc, tc, pairs[:3], 1e-10, tangent=False)
    assert tc.get_covariance_block(*pairs[0], tangent=False).shape == (10, 10)
    assert tc.get_covariance_block(*pairs[0]).shape == (9, 9)


# -- the batched kernels' plain versions ----------------------------------- #


def _batched_inputs(seed, n, k, r=2, t=9, ncols=7):
    rng = np.random.default_rng(seed)
    jac = rng.normal(size=(r * t, n)).astype(np.float32)
    rows = rng.integers(0, ncols, n).astype(np.int32)  # includes the dump column
    table = rng.normal(size=(k, t, ncols)).astype(np.float32)
    table[:, :, -1] = 0.0
    u = rng.normal(size=(k, r, n)).astype(np.float32)
    return jac, rows, table, u


@pytest.mark.parametrize("n,k", [(300, 5), (5000, 3)])
def test_gather_contract_batched_matches_vmapped_pallas(monkeypatch, n, k):
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    jac, rows, table, _ = _batched_inputs(0, n, k)
    want = np.asarray(jax.vmap(lambda tb: po.gather_contract(
        jnp.asarray(jac), jnp.asarray(rows), tb, 2))(jnp.asarray(table)))
    layout = camera_layout(rows, table.shape[2]).to("cpu")
    leaf = torch.tensor(jac)
    got = gather_contract_batched(leaf, torch.tensor(rows), lanes_major(torch.tensor(table)), 2,
                                  make_twin(leaf, layout), layout)
    assert got.shape == (k, 2, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("n,k", [(300, 5), (5000, 3)])
def test_contract_reduce_batched_matches_vmapped_pallas(monkeypatch, n, k):
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    jac, rows, table, u = _batched_inputs(1, n, k)
    ncols = table.shape[2]
    want = np.asarray(jax.vmap(lambda uu: po.contract_reduce(
        jnp.asarray(jac), jnp.asarray(rows), uu, ncols, 2))(jnp.asarray(u)))
    layout = camera_layout(rows, ncols).to("cpu")
    got = contract_reduce_batched(make_twin(torch.tensor(jac), layout), layout,
                                  lanes_major(torch.tensor(u)), 2)
    assert got.shape == (k, 9, ncols)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_batched_plain_is_single_plain_per_column(dtype):
    jac, rows, table, u = _batched_inputs(2, 700, 4, t=10, ncols=9)
    vdt = torch.float32 if dtype == torch.bfloat16 else dtype
    jac_t = torch.tensor(jac).to(dtype)
    rows_t = torch.tensor(rows)
    table_t, u_t = torch.tensor(table).to(vdt), torch.tensor(u).to(vdt)
    layout = camera_layout(rows, 9).to("cpu")
    twin = make_twin(jac_t, layout)
    g = gather_contract_batched_plain(jac_t, rows_t, table_t, 2)
    c = contract_reduce_batched_plain(twin, layout, u_t, 2)
    assert g.dtype == c.dtype == vdt
    for e in range(4):
        assert torch.equal(g[e], gather_contract_plain(jac_t, rows_t, table_t[e], 2))
        assert torch.equal(c[e], contract_reduce_plain(twin, layout, u_t[e], 2))
    dump = torch.tensor(rows == 8)
    assert torch.all(g[:, :, dump] == 0)


# -- the batched operator and PCG ------------------------------------------ #


def _ba_jacobian():
    tp, _ = _gauge_fixed(ct, BA, loss=ct.HuberLoss(1.0))
    program = tp.compile("cpu")
    _, _, jac, _ = Evaluator(program, torch.float64).evaluate_groups(
        program.state_vector(torch.float64))
    return program, jac


def test_batched_jtj_is_single_jtj_per_column(threshold):
    program, jac = _ba_jacobian()
    n = program.num_effective_parameters
    rng = np.random.default_rng(3)
    v = torch.tensor(rng.normal(size=(5, n)))
    dsq = torch.tensor(rng.uniform(0.1, 1.0, n))
    got = jac.jtj_multiply_batched(v, dsq)
    want = torch.stack([jac.jtj_multiply(v[e], dsq) for e in range(5)])
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13 * float(want.abs().max()))
    scaled = jac.scale_columns(torch.tensor(rng.uniform(0.5, 2.0, n)))
    got = scaled.jtj_multiply_batched(v)
    want = torch.stack([scaled.jtj_multiply(v[e]) for e in range(5)])
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13 * float(want.abs().max()))


def _lane_major(x, k):
    """x [k, a, b] is a .permute(2, 1, 0) view of a contiguous [b, a, k]."""
    return x.shape[0] == k and x.stride() == (1, k, k * x.shape[1])


def test_batched_products_are_lane_major(threshold):
    """The batched layout: tangent tables and J·V are lane-major views (the
    column axis innermost), Jᵀ takes them as they come, and the batched
    plain versions return the kernels' layout."""
    program, jac = _ba_jacobian()
    n, k = program.num_effective_parameters, 4
    v = torch.tensor(np.random.default_rng(8).normal(size=(k, n)))
    assert all(_lane_major(t, k) for t in jac.tvec_batched(v))
    torch.testing.assert_close(jac.tvec_flat_batched(jac.tvec_batched(v)), v, rtol=0, atol=0)
    u = jac.right_multiply_batched(v)
    assert all(_lane_major(x, k) for x in u)
    for e in range(k):
        single = jac.right_multiply(v[e])
        for x, y in zip(u, single):
            torch.testing.assert_close(x[e], y, rtol=1e-13, atol=1e-13 * float(y.abs().max()))
    got = jac.left_multiply_batched(u)
    want = torch.stack([jac.left_multiply([x[e] for x in u]) for e in range(k)])
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13 * float(want.abs().max()))
    jac_np, rows, table, uu = _batched_inputs(9, 500, k)
    layout = camera_layout(rows, table.shape[2]).to("cpu")
    leaf = torch.tensor(jac_np)
    twin = make_twin(leaf, layout)
    g = gather_contract_batched_plain(leaf, torch.tensor(rows), lanes_major(torch.tensor(table)),
                                      2)
    c = contract_reduce_batched_plain(twin, layout, lanes_major(torch.tensor(uu)), 2)
    assert _lane_major(g, k) and g.shape == (k, 2, 500)
    assert _lane_major(c, k) and c.shape == (k, 9, table.shape[2])


def _three_residual_problem(seed=6, ncam=6, npt=120, nobs=600):
    """A group of 3 residuals over a 4-parameter "camera" and a 2-parameter
    "point": with the plans engaged the camera position is onehot at r = 3,
    t = 4 (the batched kernels' any-(r, t) instantiation on a card)."""
    rng = np.random.default_rng(seed)

    def f(params, data):
        c, x = params
        (d,) = data
        return torch.stack([c[0] * x[0] + c[1] * x[1] - d[0], c[2] * x[0] * x[1] - d[1],
                            c[3] + x[0] * x[0] - c[0] * x[1] - d[2]])

    p = ct.Problem()
    cams = np.array([p.add_parameter_block(rng.normal(size=4)) for _ in range(ncam)])
    pts = np.array([p.add_parameter_block(rng.normal(size=2)) for _ in range(npt)])
    obs_pt = np.concatenate([np.arange(npt), rng.integers(0, npt, nobs - npt)])
    handles = np.stack([cams[rng.integers(0, ncam, nobs)], pts[obs_pt]], axis=1)
    p.add_residual_blocks(ct.CostFunction(f, 3), None, handles, (rng.normal(size=(nobs, 3)),))
    p.set_parameter_block_constant(int(cams[0]))
    return p


def _constant_point_problem():
    """Gauge-fixed BA with one point held constant: no class is all free,
    so no bucket plan; with ONEHOT_MAX_COLS below the point count (the
    test's stand-in for Dubrovnik-356's 226,730 points) the point position
    has no plan (index_select / index_add_) and the cameras stay onehot."""
    tp, _ = _gauge_fixed(ct, BA, loss=ct.HuberLoss(1.0))
    tp.set_parameter_block_constant(int(BA.num_cameras))  # the first point's block
    return tp


@pytest.mark.parametrize("case", ["quaternion_t10", "three_residuals", "constant_point"])
def test_batched_jtj_is_single_jtj_per_column_on_other_shapes(case, monkeypatch):
    """jtj_multiply_batched against jtj_multiply column by column (1e-12
    relative) where the batched layout meets other shapes: quaternion
    cameras without a manifold (tangent 10), a onehot position at r = 3,
    and the no-plan point side of a problem with a constant point."""
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    if case == "quaternion_t10":
        tp, _ = _gauge_fixed(ct, BA, use_quaternions=True, use_manifolds=False)
    elif case == "three_residuals":
        tp = _three_residual_problem()
    else:
        monkeypatch.setattr(TProgram, "ONEHOT_MAX_COLS", 64)
        tp = _constant_point_problem()
    program = tp.compile("cpu")
    _, _, jac, _ = Evaluator(program, torch.float64).evaluate_groups(
        program.state_vector(torch.float64))
    meta = program.groups[0]
    plans = meta.red_plans
    if case == "quaternion_t10":
        assert plans[0] == ("onehot",) and meta.positions[0].tangent_size == 10
    elif case == "three_residuals":
        assert plans[0] == ("onehot",) and meta.num_residuals == 3
        assert meta.positions[0].tangent_size == 4 and plans[1][0] == "bucket"
    else:
        assert plans[0] == ("onehot",) and 1 not in plans
    n = program.num_effective_parameters
    rng = np.random.default_rng(10)
    v = torch.tensor(rng.normal(size=(6, n)))
    dsq = torch.tensor(rng.uniform(0.1, 1.0, n))
    got = jac.jtj_multiply_batched(v, dsq)
    want = torch.stack([jac.jtj_multiply(v[e], dsq) for e in range(6)])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


def test_batched_pcg_is_k_single_pcgs(threshold):
    """Each column of the batched PCG stops where its own PCG stops (the
    columns reach the tolerance at different steps, one column hits the
    cap), with the same x; the host reads one flag per step."""
    program, jac = _ba_jacobian()
    n = program.num_effective_parameters
    prec = BlockDiagSolver(program, jac.block_diag_jtj())
    rng = np.random.default_rng(4)
    b = torch.zeros((6, n), dtype=torch.float64)
    b[0, 0] = b[2, n - 1] = b[3, n // 2] = 1.0  # a camera's, a point's columns
    b[4:] = torch.tensor(rng.normal(size=(2, n)))
    # b[1] = 0: converged at the start, no step
    kw = dict(max_iterations=200, tolerance=1e-8)
    before = counts()
    res = conjugate_gradients(jac.jtj_multiply_batched, b, preconditioner=prec.apply_batched,
                              batched=True, **kw)
    steps = int(res.iterations.max())
    assert (counts() - before)["Device::Read"] <= steps
    singles = [conjugate_gradients(jac.jtj_multiply, b[e], preconditioner=prec, **kw)
               for e in range(6)]
    assert res.iterations.tolist() == [int(s.iterations) for s in singles]
    assert res.converged.tolist() == [bool(s.converged) for s in singles]
    assert res.breakdown.tolist() == [bool(s.breakdown) for s in singles]
    assert res.iterations[1] == 0 and len(set(res.iterations.tolist())) > 2
    for e, s in enumerate(singles):
        torch.testing.assert_close(res.x[e], s.x, rtol=1e-12,
                                   atol=1e-12 * float(s.x.abs().max() + 1e-300))
    capped = conjugate_gradients(jac.jtj_multiply_batched, b, preconditioner=prec.apply_batched,
                                 batched=True, max_iterations=5, tolerance=1e-12)
    assert capped.iterations.tolist() == [0 if e == 1 else 5 for e in range(6)]


def test_batched_preconditioner_is_single_per_column():
    program, jac = _ba_jacobian()
    prec = BlockDiagSolver(program, jac.block_diag_jtj())
    r = torch.tensor(np.random.default_rng(5).normal(size=(3, program.num_effective_parameters)))
    got = prec.apply_batched(r)
    for e in range(3):
        torch.testing.assert_close(got[e], prec(r[e]), rtol=1e-15, atol=0)


@pytest.mark.parametrize("lone", [False, True])
def test_reduced_camera_inverse_is_dense_svd(lone):
    """chip_smoke's independent answer for the covariance run (S⁻¹ from
    the two leaves, a dense Cholesky) against DENSE_SVD's camera blocks,
    with a point seen by one camera only held constant or not (such a
    point empties the automatic Schur partition; the reference assembles
    S itself): 1e-9 of each block's scale (two float64 inversions of a
    system with cond(S) ~3e7)."""
    from chip_smoke import block_gap, camera_block, gauge_fixed_ba, reduced_camera_inverse

    bal = synthetic_bal(10, 300, 3000, seed=11, observation_noise=0.5)
    if lone:
        obs = np.nonzero(bal.point_index == 0)[0]
        bal.camera_index[obs] = bal.camera_index[obs[0]]
    problem, pairs, held = gauge_fixed_ba(bal)
    assert held == int(lone)
    cov = ct.Covariance(ct.CovarianceOptions(device="cpu"))
    assert cov.compute(pairs, problem)
    program = problem.compile("cpu")
    _, _, jac, _ = Evaluator(program, torch.float64).evaluate_groups(
        program.state_vector(torch.float64))
    inv, cond, cam_cls = reduced_camera_inverse(program, jac)
    assert 1e6 < cond < 1e9
    assert block_gap(cov, lambda bi, bj: camera_block(program, inv, cam_cls, bi, bj), pairs) < 1e-9
