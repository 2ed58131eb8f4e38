"""Kernel B4 (ceres_tpu_torch/linalg/schur_kernels.py) and the Schur solve
against ceres_tpu.

- The plain S·y against pallas_schur.sy_apply, run in interpret mode in
  float32 (MIN_LANES lowered so the kernel path engages at small n), at
  5e-4; and against the JAX composed four-product operator in float64 at
  1e-12. So are the plain versions of B4's two passes (t2 against the JAX
  t2, and with the LM diagonal folded in), and they compose to
  sy_apply_plain on ragged layouts of any block sizes.
- For fixed J, D and r, schur_prepare + schur_finish give the same step
  (1e-9 relative) after the same number of PCG iterations.
- The block inverses and PCG against their JAX counterparts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.evaluator import evaluate as j_evaluate
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.linalg import cg as jcg
from ceres_tpu.linalg import pallas_schur as ps
from ceres_tpu.linalg import preconditioners as jpre
from ceres_tpu.linalg import schur as jschur
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.jacobian import make_twin
from ceres_tpu_torch.linalg import cg as tcg
from ceres_tpu_torch.linalg import preconditioners as tpre
from ceres_tpu_torch.linalg import schur as tschur
from ceres_tpu_torch.linalg.schur_kernels import (
    sy_apply,
    sy_apply_plain,
    sy_fold_plain,
    sy_meta,
    sy_point_plain,
    sy_tables,
)
from ceres_tpu_torch.program import Program as TProgram
from test_torch_cuda_kernels import synthetic_sy_case

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def low_threshold(monkeypatch):
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", 16)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)


def _programs(seed=5):
    bal = synthetic_bal(6, 60, 300, seed=seed)
    jprog = j_build(bal, loss=ceres_tpu.HuberLoss(1.0))[0].compile()
    tprog = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0].compile("cpu")
    return jprog, tprog


def _jax_sy_setup(jprog, dtype):
    """JAX Jacobian (E/F views), (E'E + D_e^2)^-1 solver and a camera table y."""
    _c, _r, jac, _g = jax.jit(lambda a, s: j_evaluate(jprog, a, s))(
        jprog.arrays(dtype), jprog.state_vector(dtype)
    )
    e_np, _f = jprog.schur_tangent_masks()
    jac_e, jac_f = jschur.schur_views(jprog, jac)
    ete = jschur.make_ete_solver(jprog, jac_e, 0.1 * jnp.asarray(e_np, dtype))
    f_cls = jprog.tangent_class_of_size[9]
    ncols_f = jprog.tangent_class_counts[f_cls] + 1
    y = np.random.default_rng(0).normal(size=(9, ncols_f))
    y[:, -1] = 0.0
    return jac, jac_e, jac_f, ete, jnp.asarray(y, dtype)


def _port_sy(tprog, jac, ete, y, dtype):
    meta = sy_meta(tprog)
    g = Evaluator(tprog, dtype).arrays["groups"][0]
    F = torch.tensor(np.asarray(jac.jac_groups[0][meta["f_pos"]]))
    E = torch.tensor(np.asarray(jac.jac_groups[0][meta["e_pos"]]))
    minv = torch.tensor(np.asarray(ete.inv_tables[meta["e_cls"]]))
    rows_f = g["t_rows"][meta["f_pos"]]
    y = torch.tensor(np.asarray(y))
    layout = g["csr"][meta["f_pos"]]
    prow = tprog.slot_rows(0, meta["e_pos"], meta["f_pos"], F.device)
    return meta, sy_apply(meta, F, E, rows_f, make_twin(F, layout), make_twin(E, layout), prow,
                          layout, y, minv, sy_tables(meta, F.device))


def test_plain_sy_matches_pallas_sy_apply_f32(monkeypatch):
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    monkeypatch.setattr(ps, "MIN_LANES", 0)
    monkeypatch.setattr(ceres_tpu.pallas_onehot, "MIN_LANES", 0)
    jprog, tprog = _programs()
    jac, jac_e, jac_f, ete, y = _jax_sy_setup(jprog, jnp.float32)
    jmeta = ps.sy_meta(jprog)
    assert jmeta is not None
    arrs = ps.build_sy_arrays(jprog, jac_e, jac_f, jmeta)
    minv = ps.build_minv_segments(ete.inv_tables[jmeta["e_cls"]], jmeta)
    want = np.asarray(ps.sy_apply(jmeta, arrs, minv, y, jnp.float32))
    meta, got = _port_sy(tprog, jac, ete, y, torch.float32)
    assert (meta["e_cls"], meta["f_cls"], meta["te"], meta["tf"]) == (
        jmeta["e_cls"], jmeta["f_cls"], jmeta["te"], jmeta["tf"])
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4 * np.abs(want).max())


def test_plain_sy_matches_composed_f64():
    jprog, tprog = _programs(seed=6)
    jac, jac_e, jac_f, ete, y = _jax_sy_setup(jprog, jnp.float64)
    f_cls = sy_meta(tprog)["f_cls"]
    tv = [jnp.zeros((t, c + 1)) for t, c in zip(jprog.tangent_class_sizes, jprog.tangent_class_counts)]
    tv[f_cls] = y
    t1 = jac_f.right_multiply_t(tv)
    t2 = ete.apply_t(jac_e.left_multiply_t(t1))
    et2 = jac_e.right_multiply_t(t2)
    want = np.asarray(jac_f.left_multiply_t([a - b for a, b in zip(t1, et2)])[f_cls])
    _, got = _port_sy(tprog, jac, ete, y, torch.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("with_dsq", [False, True], ids=["no_dsq", "dsq"])
def test_sy_passes_match_jax_f64(with_dsq):
    """B4's two passes, plain, on the port's tables: t2 (point-major) equals
    JAX's M⁻¹Eᵀ(F y), the fold equals JAX's composed S·y (+ D_f² y with the
    dump column 0), and both equal sy_apply_plain; sy_apply runs it on CPU
    tensors."""
    jprog, tprog = _programs(seed=6)
    jac, jac_e, jac_f, ete, y = _jax_sy_setup(jprog, jnp.float64)
    meta = sy_meta(tprog)
    f_cls, e_cls = meta["f_cls"], meta["e_cls"]
    tv = [jnp.zeros((t, c + 1)) for t, c in zip(jprog.tangent_class_sizes, jprog.tangent_class_counts)]
    tv[f_cls] = y
    t1 = jac_f.right_multiply_t(tv)
    jt2 = ete.apply_t(jac_e.left_multiply_t(t1))
    et2 = jac_e.right_multiply_t(jt2)
    want = np.asarray(jac_f.left_multiply_t([a - b for a, b in zip(t1, et2)])[f_cls]).copy()
    dsq = None
    if with_dsq:
        # nonzero on the dump column too: the result is 0 there all the same
        dsq = np.random.default_rng(1).uniform(0.5, 2.0, want.shape)
        want = want + dsq * np.asarray(y)
        want[:, -1] = 0.0
        dsq = torch.tensor(dsq)
    g = Evaluator(tprog, torch.float64).arrays["groups"][0]
    F = torch.tensor(np.asarray(jac.jac_groups[0][meta["f_pos"]]))
    E = torch.tensor(np.asarray(jac.jac_groups[0][meta["e_pos"]]))
    minv = torch.tensor(np.asarray(ete.inv_tables[e_cls]))
    rows_f, layout = g["t_rows"][meta["f_pos"]], g["csr"][meta["f_pos"]]
    prow = tprog.slot_rows(0, meta["e_pos"], meta["f_pos"], "cpu")
    yt = torch.tensor(np.asarray(y))
    t2 = sy_point_plain(meta, F, E, rows_f, yt, minv)
    cnt_e = minv.shape[1]
    want_t2 = np.asarray(jt2[e_cls])[:, :cnt_e].T
    np.testing.assert_allclose(t2.numpy(), want_t2, rtol=1e-12, atol=1e-12 * np.abs(want_t2).max())
    F_twin, E_twin = make_twin(F, layout), make_twin(E, layout)
    # the fold ignores y's dump column (its slots add only to the dump column)
    y_dump = yt.clone()
    y_dump[:, -1] = 1.5
    got = sy_fold_plain(meta, F_twin, E_twin, prow, layout, y_dump, t2, dsq)
    tol = dict(rtol=1e-12, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, **tol)
    composed = sy_apply_plain(meta, F, E, rows_f, F_twin, layout, yt, minv, dsq)
    np.testing.assert_allclose(got.numpy(), composed.numpy(), **tol)
    on_cpu = sy_apply(meta, F, E, rows_f, F_twin, E_twin, prow, layout, yt, minv,
                      sy_tables(meta, F.device), dsq)
    assert torch.equal(on_cpu, composed)


@pytest.mark.parametrize("r,te,tf", [(2, 3, 9), (1, 1, 1), (2, 8, 16), (4, 3, 8), (3, 5, 6)])
def test_sy_passes_compose_to_plain_on_ragged_layouts(r, te, tf):
    """The plain passes of B4 (what its kernels compute) against the composed
    product, f64, on ragged camera runs and point degrees of any block sizes
    within sy_meta's bounds, with the LM diagonal folded in."""
    (meta, F, E, rows_f, F_twin, E_twin, prow, layout, y, minv,
     dsq) = synthetic_sy_case(r, te, tf, torch.float64, torch.device("cpu"), seed=tf)
    t2 = sy_point_plain(meta, F, E, rows_f, y, minv)
    got = sy_fold_plain(meta, F_twin, E_twin, prow, layout, y, t2, dsq)
    want = sy_apply_plain(meta, F, E, rows_f, F_twin, layout, y, minv, dsq)
    assert torch.all(got[:, -1] == 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


def test_sy_meta_eligibility(monkeypatch):
    _, tprog = _programs()
    meta = sy_meta(tprog)
    assert meta is not None and (meta["r"], meta["te"], meta["tf"]) == (2, 3, 9)
    assert int(meta["pt_start"][-1]) == tprog.tangent_class_counts[meta["e_cls"]]
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 10**9)
    _, no_plans = _programs()
    assert sy_meta(no_plans) is None


def _options(precond):
    """(JAX, port) SolverOptions for ITERATIVE_SCHUR with `precond`."""
    return tuple(
        pkg.SolverOptions(
            linear_solver_type=pkg.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=getattr(pkg.PreconditionerType, precond),
            eta=0.1,
            max_linear_solver_iterations=25,
        )
        for pkg in (ceres_tpu, ct)
    )


@pytest.mark.parametrize("precond", ["JACOBI", "IDENTITY"])
@pytest.mark.parametrize("radius", [1e4, 10.0, 0.1])
def test_schur_step_matches_jax_f64(precond, radius):
    jprog, tprog = _programs(seed=7)
    jopt, topt = _options(precond)
    _c, jres, jjac, jgrad = jax.jit(lambda a, s: j_evaluate(jprog, a, s))(
        jprog.arrays(jnp.float64), jprog.state_vector(jnp.float64)
    )
    jscale = 1.0 / (1.0 + jnp.sqrt(jjac.squared_column_norms()))
    jjs = jjac.scale_columns(jscale)
    jcache = jschur.schur_prepare(jprog, jopt, jjs)
    jdsq = jnp.clip(jcache["colnorm2"], jopt.min_lm_diagonal, jopt.max_lm_diagonal) / radius
    jstep, jits = jschur.schur_finish(jprog, jopt, jjs, jres, jgrad * jscale, jdsq, jcache)

    _c, tres, tjac, tgrad = Evaluator(tprog, torch.float64).evaluate_groups(
        tprog.state_vector(torch.float64)
    )
    tscale = 1.0 / (1.0 + torch.sqrt(tjac.squared_column_norms()))
    tjs = tjac.scale_columns(tscale)
    tcache = tschur.schur_prepare(tprog, topt, tjs)
    tdsq = torch.clamp(tcache["colnorm2"], topt.min_lm_diagonal, topt.max_lm_diagonal) / radius
    tstep, tits = tschur.schur_finish(tprog, topt, tjs, tres, tgrad * tscale, tdsq, tcache)

    assert tits == int(jits) > 0
    want = np.asarray(jstep)
    np.testing.assert_allclose(tstep.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("s", [3, 9])
def test_block_inverse_matches_jax(s):
    rng = np.random.default_rng(s)
    cnt = 12
    a = rng.normal(size=(cnt, s, s))
    blocks = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(s)
    blocks[0] = 0.0  # all-zero block: ridge keeps it finite
    table = blocks.reshape(cnt, s * s).T.copy()
    want = np.asarray(jpre._inverse_T(jnp.asarray(table), s))
    got = tpre._inverse_T(torch.tensor(table), s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    vt = rng.normal(size=(s, cnt))
    np.testing.assert_allclose(
        tpre.apply_block_T(torch.tensor(got), torch.tensor(vt), s).numpy(),
        np.asarray(jpre.apply_block_T(jnp.asarray(want), jnp.asarray(vt), s)),
        rtol=1e-9, atol=1e-12,
    )


@pytest.mark.parametrize("q_tolerance", [0.0, 0.1])
def test_conjugate_gradients_matches_jax(q_tolerance):
    rng = np.random.default_rng(4)
    m = rng.normal(size=(30, 30))
    a = m @ m.T + 30 * np.eye(30)
    b = rng.normal(size=30)
    d = np.diag(a)
    want = jcg.conjugate_gradients(
        lambda x: jnp.asarray(a) @ x, jnp.asarray(b), preconditioner=lambda r: r / jnp.asarray(d),
        max_iterations=25, tolerance=1e-10, q_tolerance=q_tolerance,
    )
    ta, td = torch.tensor(a), torch.tensor(d)
    got = tcg.conjugate_gradients(
        lambda x: ta @ x, torch.tensor(b), preconditioner=lambda r: r / td,
        max_iterations=25, tolerance=1e-10, q_tolerance=q_tolerance,
    )
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10, atol=1e-12)
