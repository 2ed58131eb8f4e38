"""Kernel B5 (SCHUR_JACOBI blocks) and schur_solve of ceres_tpu_torch
against ceres_tpu.

- p0_apply (its plain version on CPU tensors, on the camera-ordered twins)
  against pallas_schur.p0_apply, run in interpret mode in float32
  (MIN_LANES lowered so the kernel path engages at small n), at 5e-4;
  against schur_jacobi_blocks of both packages in float64 at 1e-12; and
  against its lane-order function in float64 at 1e-12, on ragged camera
  runs with an empty camera, for several (tf, te), and on the twins of a
  second evaluation and of materialize_scale (twin staleness).
- schur_prepare + schur_finish with SCHUR_JACOBI give the same step (1e-9
  relative) after the same number of PCG iterations, on the layout plans
  (B5's path) and without them (schur_jacobi_blocks' path), on a problem
  with no point seen by one camera only (seed 6). Such a point's EᵀE is
  singular and the cached correction's ridge inverse (100·eps) amplifies
  rounding, so on a problem that has them (seed 7) the reference disagrees
  with itself once its observations are summed in another order: blocks at
  ~7e-5, step at ~2e-6 (test_lone_points_reference_against_itself). There
  the port is held at LONE_TOL.
- schur_solve gives the same step (1e-9) and iteration count for every
  configuration it serves.
"""

import dataclasses

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
from ceres_tpu.linalg import pallas_schur as ps
from ceres_tpu.linalg import schur as jschur
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.jacobian import make_twin
from ceres_tpu_torch.linalg import schur as tschur
from ceres_tpu_torch.linalg.preconditioners import BlockDiagSolver
from ceres_tpu_torch.linalg.schur_kernels import p0_apply, sy_meta
from ceres_tpu_torch.program import Program as TProgram
from ceres_tpu_torch.program import camera_layout

torch.set_num_threads(1)

PLANS, NO_PLANS = 16, 10**9  # SEG_REDUCE_THRESHOLD with and without layout plans
LONE = 7  # a seed whose problem has points seen by one camera only
# (blocks, step) tolerance on the LONE problem: about 10x the gap between
# the reference and itself with its observations permuted (~7e-5, ~2e-6)
LONE_TOL = (1e-3, 1e-4)


def single_camera_points(bal):
    """Points whose observations all come from one camera (singular EᵀE)."""
    lo = np.full(bal.num_points, np.iinfo(np.int64).max)
    hi = np.full(bal.num_points, -1)
    np.minimum.at(lo, bal.point_index, bal.camera_index)
    np.maximum.at(hi, bal.point_index, bal.camera_index)
    return int((lo == hi).sum())


def _bal(seed):
    bal = synthetic_bal(6, 60, 300, seed=seed)
    assert (single_camera_points(bal) > 0) == (seed == LONE)
    return bal


def _programs(seed, threshold=PLANS, monkeypatch=None, bal=None):
    if monkeypatch is not None:
        monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", threshold)
        monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", threshold)
    bal = _bal(seed) if bal is None else bal
    jprog = j_build(bal, loss=ceres_tpu.HuberLoss(1.0))[0].compile()
    tprog = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0].compile("cpu")
    return jprog, tprog


def _jax_eval(jprog, dtype):
    return jax.jit(lambda a, s: j_evaluate(jprog, a, s))(
        jprog.arrays(dtype), jprog.state_vector(dtype)
    )


def _port_eval(tprog, dtype):
    return Evaluator(tprog, dtype).evaluate_groups(tprog.state_vector(dtype))


def _to_torch(x):
    return torch.tensor(np.asarray(x))


def _port_p0(tprog, jac_groups, minv, dtype):
    """p0_apply on the given (materialized) leaves and inverse table."""
    meta = sy_meta(tprog)
    garr = Evaluator(tprog, dtype).arrays["groups"][0]
    layout = garr["csr"][meta["f_pos"]]
    f_pos, e_pos = meta["f_pos"], meta["e_pos"]
    return p0_apply(
        meta, make_twin(_to_torch(jac_groups[0][f_pos]), layout),
        make_twin(_to_torch(jac_groups[0][e_pos]), layout),
        tprog.slot_rows(0, e_pos, f_pos, "cpu"), layout, _to_torch(minv).T.contiguous(),
    )


def _lane_p0(meta, F, E, rows_f, rows_e, minv):
    """B5's function in lane order: the per-lane FᵀF − (EᵀF)ᵀ M⁻¹ (EᵀF)
    (zero correction where the point row is outside the table), then
    index_add_ by camera, dump column dropped."""
    r, te, tf, cnt_f = meta["r"], meta["te"], meta["tf"], meta["cnt_f"]
    n = F.shape[1]
    live = (rows_e >= 0) & (rows_e < minv.shape[1])
    m = minv[:, torch.where(live, rows_e, torch.zeros_like(rows_e))]
    m = torch.where(live[None, :], m, torch.zeros_like(m)).reshape(te, te, n)
    ej, fj = E.reshape(r, te, n), F.reshape(r, tf, n)
    etf = (ej[:, :, None, :] * fj[:, None, :, :]).sum(dim=0)
    corr = (etf[:, :, None, :] * (m[:, :, None, :] * etf[None]).sum(dim=1)[:, None]).sum(dim=0)
    total = ((fj[:, :, None, :] * fj[:, None, :, :]).sum(dim=0) - corr).reshape(tf * tf, n)
    out = torch.zeros((tf * tf, cnt_f + 1), dtype=F.dtype)
    return out.index_add_(1, rows_f.long(), total)[:, :cnt_f]


def _close_t(got, want, tol):
    _close(got.numpy(), want.numpy(), tol)


# observations per camera: ragged runs around the 32-slot padding, one
# camera with none (column 4), the dump column last
RAGGED = (1, 31, 32, 33, 0, 700, 9)


@pytest.mark.parametrize("tf,te", [(6, 3), (9, 3), (16, 8)])
def test_twin_p0_matches_lane_order_f64(tf, te):
    rng = np.random.default_rng(tf * 10 + te)
    rows_f = rng.permutation(np.repeat(np.arange(len(RAGGED)), RAGGED)).astype(np.int32)
    n, cnt_f, cnt_e, r = rows_f.size, len(RAGGED) - 1, 50, 2
    # point rows include -1 and cnt_e (constant points): FᵀF only
    rows_e = torch.tensor(rng.integers(-1, cnt_e + 1, n), dtype=torch.int32)
    F = torch.tensor(rng.normal(size=(r * tf, n)))
    E = torch.tensor(rng.normal(size=(r * te, n)))
    minv = torch.tensor(rng.normal(size=(te * te, cnt_e)))
    layout = camera_layout(rows_f, cnt_f + 1).to("cpu")
    live = layout.perm >= 0
    prow = torch.where(live, rows_e[layout.perm.clamp(min=0).long()], -1).to(torch.int32)
    meta = {"r": r, "te": te, "tf": tf, "cnt_f": cnt_f}
    got = p0_apply(meta, make_twin(F, layout), make_twin(E, layout), prow, layout,
                   minv.T.contiguous())
    assert tuple(got.shape) == (tf * tf, cnt_f)
    assert torch.all(got[:, 4] == 0)  # the camera without observations
    _close_t(got, _lane_p0(meta, F, E, torch.tensor(rows_f), rows_e, minv), 1e-12)


def test_twins_follow_new_leaves(monkeypatch):
    """Twin staleness: after a second evaluation at another state, and after
    materialize_scale, the twins are those of the new leaves, and B3 (the
    gradient's camera part) and B5 on them equal the lane-order functions
    of the new leaves."""
    _, tprog = _programs(6, monkeypatch=monkeypatch)
    meta = sy_meta(tprog)
    f_pos, e_pos, f_cls, cnt_f = meta["f_pos"], meta["e_pos"], meta["f_cls"], meta["cnt_f"]
    ev = Evaluator(tprog, torch.float64)
    garr = ev.arrays["groups"][0]
    layout, rows_f, rows_e = garr["csr"][f_pos], garr["t_rows"][f_pos], garr["t_rows"][e_pos]
    x0 = tprog.state_vector(torch.float64)
    _c, _r, jac0, _g = ev.evaluate_groups(x0)
    step = torch.tensor(np.random.default_rng(3).normal(size=tprog.num_effective_parameters))
    _c, res1, jac1, grad1 = ev.evaluate_groups(ev.plus(x0, 1e-2 * step))
    F1 = jac1.leaf(0, f_pos)
    assert not torch.equal(F1, jac0.leaf(0, f_pos))
    assert torch.equal(jac1.twin(0, f_pos), make_twin(F1, layout))
    base, cnt, s = tprog.tangent_class_slice(f_cls)
    x = F1.reshape(2, s, -1) * res1[0][:, None, :]
    want = torch.zeros((s, cnt + 1), dtype=F1.dtype).index_add_(1, rows_f.long(), x.sum(dim=0))
    _close_t(grad1[base : base + cnt * s].reshape(cnt, s).T, want[:, :cnt], 1e-12)

    minv = torch.tensor(np.random.default_rng(4).normal(size=(9, tprog.tangent_class_counts[meta["e_cls"]])))
    jms = []
    for jac in (jac0, jac1):
        jm = jac.scale_columns(1.0 / (1.0 + torch.sqrt(jac.squared_column_norms()))).materialize_scale()
        Fm, Em = jm.leaf(0, f_pos), jm.leaf(0, e_pos)
        assert torch.equal(jm.twin(0, f_pos), make_twin(Fm, layout))
        assert torch.equal(jm.twin(0, e_pos, f_pos), make_twin(Em, layout))
        ete = BlockDiagSolver.from_inverse_tables(tprog, {meta["e_cls"]: minv})
        got = tschur._p0_tables(tprog, jm, meta, ete)[f_cls]
        _close_t(got, _lane_p0(meta, Fm, Em, rows_f, rows_e, minv), 1e-12)
        jms.append(got)
    assert not torch.allclose(jms[0], jms[1])


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("seed", [6, 8])
def test_plain_p0_matches_pallas_p0_apply_f32(monkeypatch, seed):
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", PLANS)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", PLANS)
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    monkeypatch.setattr(ps, "MIN_LANES", 0)
    monkeypatch.setattr(ceres_tpu.pallas_onehot, "MIN_LANES", 0)
    jprog, tprog = _programs(seed)
    _c, _r, jac, _g = _jax_eval(jprog, jnp.float32)
    jac_e, jac_f = jschur.schur_views(jprog, jac)
    e_mask = jnp.asarray(jprog.schur_tangent_masks()[0], jnp.float32)
    ete = jschur.make_ete_solver(jprog, jac_e, 0.1 * e_mask)
    jmeta = ps.sy_meta(jprog)
    assert jmeta is not None
    minv = ete.inv_tables[jmeta["e_cls"]]
    want = ps.p0_apply(
        jmeta, ps.build_sy_arrays(jprog, jac_e, jac_f, jmeta), ps.build_minv_segments(minv, jmeta)
    )
    got = _port_p0(tprog, jac.jac_groups, minv, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want, 5e-4)


@pytest.mark.parametrize("impl", ["p0_apply", "schur_jacobi_blocks"])
@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "col_scaled"])
def test_p0_matches_jax_schur_jacobi_blocks_f64(monkeypatch, impl, scaled):
    """Both port routes to the SCHUR_JACOBI blocks (no LM diagonal) against
    the JAX package's composed schur_jacobi_blocks, with and without a lazy
    column scale."""
    jprog, tprog = _programs(6, monkeypatch=monkeypatch)
    _c, _r, jjac, _g = _jax_eval(jprog, jnp.float64)
    _c, _r, tjac, _g = _port_eval(tprog, torch.float64)
    if scaled:
        jjac = jjac.scale_columns(1.0 / (1.0 + jnp.sqrt(jjac.squared_column_norms())))
        tjac = tjac.scale_columns(1.0 / (1.0 + torch.sqrt(tjac.squared_column_norms())))
    e_np = jprog.schur_tangent_masks()[0]
    j_e, j_f = jschur.schur_views(jprog, jjac)
    jete = jschur.make_ete_solver(jprog, j_e, 0.1 * jnp.asarray(e_np))
    zero = jnp.zeros(jprog.num_effective_parameters)
    f_cls = sy_meta(tprog)["f_cls"]
    want = jschur.schur_jacobi_blocks(jprog, j_e, j_f, jete, zero)[f_cls]

    t_e, t_f = tschur.schur_views(tprog, tjac)
    tete = tschur.make_ete_solver(tprog, t_e, 0.1 * torch.tensor(e_np, dtype=torch.float64))
    if impl == "p0_apply":
        meta = sy_meta(tprog)
        assert meta is not None
        got = tschur._p0_tables(tprog, tjac.materialize_scale(), meta, tete)[f_cls]
    else:
        got = tschur.schur_jacobi_blocks(
            tprog, t_e, t_f, tete, torch.zeros(tprog.num_effective_parameters, dtype=torch.float64)
        )[f_cls]
    _close(got.numpy(), want, 1e-12)


def _options(precond, **kw):
    """(JAX, port) SolverOptions for a Schur solve."""
    return tuple(
        pkg.SolverOptions(**{
            "linear_solver_type": pkg.LinearSolverType.ITERATIVE_SCHUR,
            "preconditioner_type": getattr(pkg.PreconditionerType, precond),
            "eta": 0.1,
            "max_linear_solver_iterations": 25,
            **{k: (getattr(pkg.LinearSolverType, v) if k == "linear_solver_type" else v)
               for k, v in kw.items()},
        })
        for pkg in (ceres_tpu, ct)
    )


def _scaled_problem(jprog, tprog):
    """Both packages' (scaled Jacobian, residuals, scaled gradient)."""
    _c, jres, jjac, jgrad = _jax_eval(jprog, jnp.float64)
    jscale = 1.0 / (1.0 + jnp.sqrt(jjac.squared_column_norms()))
    _c, tres, tjac, tgrad = _port_eval(tprog, torch.float64)
    tscale = 1.0 / (1.0 + torch.sqrt(tjac.squared_column_norms()))
    return (
        (jjac.scale_columns(jscale), jres, jgrad * jscale),
        (tjac.scale_columns(tscale), tres, tgrad * tscale),
    )


def _jax_schur_jacobi(jprog, radius):
    """The JAX package's SCHUR_JACOBI prepare + finish on its Jacobi-scaled
    f64 Jacobian: (camera blocks without the LM diagonal, step, PCG count)."""
    jopt, _ = _options("SCHUR_JACOBI")
    _c, jres, jjac, jgrad = _jax_eval(jprog, jnp.float64)
    jscale = 1.0 / (1.0 + jnp.sqrt(jjac.squared_column_norms()))
    jjs, jgs = jjac.scale_columns(jscale), jgrad * jscale
    jcache = jschur.schur_prepare(jprog, jopt, jjs)
    jdsq = jnp.clip(jcache["colnorm2"], jopt.min_lm_diagonal, jopt.max_lm_diagonal) / radius
    jstep, jits = jschur.schur_finish(jprog, jopt, jjs, jres, jgs, jdsq, jcache)
    return _camera_table(jcache["p0"]), np.asarray(jstep), int(jits)


def _camera_table(tables):
    """The [81, cameras] table of a per-class list of block tables."""
    return next(np.asarray(t) for t in tables if t is not None and t.shape[0] == 81)


@pytest.mark.parametrize("threshold", [PLANS, NO_PLANS], ids=["plans", "no_plans"])
@pytest.mark.parametrize(
    "seed,radius", [(6, 1e4), (6, 10.0), (6, 0.1), (LONE, 10.0)],
    ids=["1e4", "10", "0.1", "lone_points_10"],
)
def test_schur_jacobi_step_matches_jax_f64(monkeypatch, threshold, seed, radius):
    jprog, tprog = _programs(seed, threshold, monkeypatch)
    assert (sy_meta(tprog) is not None) == (threshold == PLANS)
    _jopt, topt = _options("SCHUR_JACOBI")
    jp0, jstep, jits = _jax_schur_jacobi(jprog, radius)
    _c, tres, tjac, tgrad = _port_eval(tprog, torch.float64)
    tscale = 1.0 / (1.0 + torch.sqrt(tjac.squared_column_norms()))
    tjs, tgs = tjac.scale_columns(tscale), tgrad * tscale
    tcache = tschur.schur_prepare(tprog, topt, tjs)
    tdsq = torch.clamp(tcache["colnorm2"], topt.min_lm_diagonal, topt.max_lm_diagonal) / radius
    tstep, tits = tschur.schur_finish(tprog, topt, tjs, tres, tgs, tdsq, tcache)
    assert tits == jits > 0
    p0_tol, step_tol = LONE_TOL if seed == LONE else (1e-12, 1e-9)
    _close(_camera_table(tcache["p0"]), jp0, p0_tol)
    _close(tstep.numpy(), jstep, step_tol)


def test_lone_points_reference_against_itself(monkeypatch):
    """The witness for LONE_TOL: the JAX package's SCHUR_JACOBI blocks and
    step on the LONE problem move by more than the strict tolerances when
    only the order of the observations changes (the same problem, another
    summation order), and stay within LONE_TOL."""
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", PLANS)
    bal = _bal(LONE)
    perm = np.random.default_rng(1).permutation(len(bal.point_index))
    permuted = dataclasses.replace(
        bal, camera_index=bal.camera_index[perm], point_index=bal.point_index[perm],
        observations=bal.observations[perm],
    )
    runs = [
        _jax_schur_jacobi(j_build(b, loss=ceres_tpu.HuberLoss(1.0))[0].compile(), 10.0)
        for b in (bal, permuted)
    ]
    (p0_a, step_a, its_a), (p0_b, step_b, its_b) = runs
    assert its_a == its_b > 0
    gaps = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in ((p0_a, p0_b), (step_a, step_b))]
    assert gaps[0] > 1e-12 and gaps[1] > 1e-9
    assert gaps[0] <= LONE_TOL[0] and gaps[1] <= LONE_TOL[1]


SOLVE_CASES = {
    "identity": ("IDENTITY", {}),
    "jacobi": ("JACOBI", {}),
    "schur_jacobi": ("SCHUR_JACOBI", {}),
    "power_series": ("SCHUR_POWER_SERIES_EXPANSION", {}),
    "spse_init": ("SCHUR_JACOBI", {"use_spse_initialization": True}),
    "explicit": ("JACOBI", {"use_explicit_schur_complement": True}),
    "dense_schur": ("JACOBI", {"linear_solver_type": "DENSE_SCHUR"}),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_schur_solve_matches_jax_f64(monkeypatch, case):
    precond, kw = SOLVE_CASES[case]
    radius = 10.0
    jprog, tprog = _programs(8, PLANS, monkeypatch)
    jopt, topt = _options(precond, **kw)
    (jjs, jres, jgs), (tjs, tres, tgs) = _scaled_problem(jprog, tprog)
    jdsq = jnp.clip(jjs.squared_column_norms(), jopt.min_lm_diagonal, jopt.max_lm_diagonal) / radius
    jstep, jits = jschur.schur_solve(jprog, jopt, jjs, jres, jgs, jdsq)
    tdsq = torch.clamp(tjs.squared_column_norms(), topt.min_lm_diagonal, topt.max_lm_diagonal) / radius
    tstep, tits = tschur.schur_solve(tprog, topt, tjs, tres, tgs, tdsq)
    assert tits == int(jits) > 0
    _close(tstep.numpy(), jstep, 1e-9)


@pytest.mark.parametrize(
    "kw",
    [
        {"preconditioner_type": "CLUSTER_JACOBI"},
        {"preconditioner_type": "CLUSTER_TRIDIAGONAL"},
        {"use_mixed_precision_solves": True},
    ],
    ids=["cluster_jacobi", "cluster_tridiagonal", "mixed_precision"],
)
def test_schur_solve_refuses_unported_branches(monkeypatch, kw):
    _, tprog = _programs(8, PLANS, monkeypatch)
    kw = {k: getattr(ct.PreconditionerType, v) if k == "preconditioner_type" else v
          for k, v in kw.items()}
    opt = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR, **kw)
    _c, tres, tjac, tgrad = _port_eval(tprog, torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tschur.schur_solve(tprog, opt, tjac, tres, tgrad, torch.ones_like(tgrad))
