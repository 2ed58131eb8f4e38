"""The host sparse solvers of the port against ceres_tpu's:
SPARSE_NORMAL_CHOLESKY and the SUBSET preconditioner (linalg/sparse.py),
SPARSE_SCHUR (linalg/explicit_schur.py), and their step functions.

- `solve_sparse_normal_cholesky` on the same scaled Jacobian, dsq and
  gradient (a small bundle adjustment problem and a small 2D pose graph):
  1e-10 relative; `SubsetPreconditioner`'s apply on the same rows: 1e-12;
- the explicit Schur plan (slots, BSR structure, diagonal slots) equal to
  the JAX plan's, with the layout plans and without; the assembled S
  against the JAX blocks (1e-12) and against the implicit operator
  (tests/test_explicit_schur.py's check); the SPARSE_SCHUR step against
  the JAX one and against DENSE_SCHUR (1e-10);
- the fallback of a problem that is not BA-shaped to schur_solve, and its
  record in the execution summary;
- whole LM solves on SPARSE_NORMAL_CHOLESKY, SPARSE_SCHUR and CGNR + SUBSET
  against ceres_tpu.solve: per-iteration cost to 1e-10 relative, equal PCG
  counts and decisions. The SUBSET solves start at radius 1: with the
  default 1e4, D² = diag(JᵀJ)/1e4 leaves the columns that Q does not reach
  nearly unpreconditioned, the preconditioned operator then has
  eigenvalues ~1e4, and PCG amplifies rounding (ceres_tpu against itself,
  with the same preconditioner applied through a dense inverse, moves its
  step by ~1e-4 on the pose graph); radius 1 keeps D² at diag(JᵀJ) and the
  two packages within 1e-14;
- a SUBSET solve without residual_blocks_for_subset_preconditioner raises
  the JAX package's ValueError; the host factorizations are counted reads
  and execution-summary records."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.examples import pose_graph as jpg
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.linalg import explicit_schur as jes
from ceres_tpu.linalg import sparse as jsp
from ceres_tpu.linalg.schur import make_ete_solver as j_make_ete
from ceres_tpu.linalg.schur import schur_views as j_views
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.examples import pose_graph as tpg
from ceres_tpu_torch.linalg import explicit_schur as tes
from ceres_tpu_torch.linalg import sparse as tsp
from ceres_tpu_torch.linalg.schur import make_ete_solver as t_make_ete
from ceres_tpu_torch.linalg.schur import schur_views as t_views
from ceres_tpu_torch.program import Program as TProgram
from ceres_tpu_torch.utils.execution_summary import ExecutionSummary, counts, recording

torch.set_num_threads(1)
F64 = torch.float64


def _problems(name):
    """(JAX problem, port problem) of the same data."""
    if name == "pose2d":
        g, _ = jpg.synthetic_pose_graph_2d(n=30, noise=0.05, seed=1)
        return jpg.build_pose_graph_2d_problem(g)[0], tpg.build_pose_graph_2d_problem(g)[0]
    bal = synthetic_bal(8, 60, 300, seed=3, perturb_points=0.05)
    return (j_build(bal, loss=ceres_tpu.HuberLoss(1.0))[0],
            ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0])


def _evaluated(name, plans=False, monkeypatch=None):
    """Both packages' Programs, Jacobians, residuals and gradients at the
    start, with a seeded column scale and LM diagonal."""
    if plans:
        monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", 16)
        monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    jp, tp = _problems(name)
    jprog, tprog = jp.compile(), tp.compile("cpu")
    _, jres, jjac, jg = jprog.evaluator().evaluate_groups(jprog.state_vector())
    _, tres, tjac, tg = Evaluator(tprog, F64).evaluate_groups(tprog.state_vector(F64))
    n = tprog.num_effective_parameters
    rng = np.random.default_rng(0)
    scale, dsq = rng.uniform(0.5, 2.0, n), rng.uniform(0.1, 1.0, n)
    return dict(
        jp=jp, tp=tp, jprog=jprog, tprog=tprog, jres=jres, tres=tres,
        jjac=jjac.scale_columns(jnp.asarray(scale)), tjac=tjac.scale_columns(torch.tensor(scale)),
        jg=jg * scale, tg=tg * torch.tensor(scale), jdsq=jnp.asarray(dsq), tdsq=torch.tensor(dsq),
    )


@pytest.mark.parametrize("name", ["ba", "pose2d"])
def test_sparse_normal_cholesky_matches_jax(name):
    e = _evaluated(name)
    want = np.asarray(jsp.solve_sparse_normal_cholesky(e["jjac"], e["jres"], e["jg"], e["jdsq"]))
    records = ExecutionSummary()
    before = counts()
    with recording(records):
        got = tsp.solve_sparse_normal_cholesky(e["tjac"], e["tres"], e["tg"], e["tdsq"])
    # the Jacobian, dsq and the gradient cross in one read
    assert (counts() - before)["Device::Read"] == 1
    assert records.calls("SparseCholesky::Factorize") == 1
    assert records.nbytes("SparseCholesky::Read") > 8 * (len(e["tg"]) * 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("name", ["ba", "pose2d"])
def test_subset_preconditioner_matches_jax(name):
    e = _evaluated(name)
    handles = list(range(0, e["tprog"].num_residual_blocks, 2))
    jrows, trows = e["jp"].residual_rows_for_handles(handles), e["tp"].residual_rows_for_handles(handles)
    np.testing.assert_array_equal(jrows, trows)
    jprec = jsp.SubsetPreconditioner(e["jjac"], jrows, e["jdsq"])
    before = counts()
    tprec = tsp.SubsetPreconditioner(e["tjac"], trows, e["tdsq"])
    v = np.random.default_rng(1).normal(size=e["tprog"].num_effective_parameters)
    want = np.asarray(jprec(jnp.asarray(v)))
    got = tprec(torch.tensor(v))
    # one read for the factorization, one per application
    assert (counts() - before)["Device::Read"] == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def _schur_pieces(e):
    """Both packages' E/F views (scale folded in), (EᵀE + D_e²)⁻¹, FᵀF + D_f²
    and plans."""
    out = {}
    for side, views, make_ete, plan_cls in (
        ("j", j_views, j_make_ete, jes.ExplicitSchurPlan),
        ("t", t_views, t_make_ete, tes.ExplicitSchurPlan),
    ):
        prog, jac, dsq = e[side + "prog"], e[side + "jac"], e[side + "dsq"]
        jac_e, jac_f = views(prog, jac)
        jac_e, jac_f = jac_e.materialize_scale(), jac_f.materialize_scale()
        e_np, f_np = prog.schur_tangent_masks()
        e_mask = jnp.asarray(e_np) if side == "j" else torch.tensor(e_np)
        f_mask = jnp.asarray(f_np) if side == "j" else torch.tensor(f_np)
        ete = make_ete(prog, jac_e, dsq * e_mask)
        plan = plan_cls.get(prog, jac_e, jac_f)
        ftf = jac_f.block_diag_jtj(dsq=dsq * f_mask)[plan.cam_cls]
        out[side] = dict(jac_e=jac_e, jac_f=jac_f, ete=ete, plan=plan, ftf=ftf,
                         dsq_f=dsq * f_mask)
    return out


@pytest.mark.parametrize("plans", [False, True], ids=["no_plans", "plans"])
def test_explicit_schur_plan_and_blocks_match_jax(monkeypatch, plans):
    e = _evaluated("ba", plans, monkeypatch)
    s = _schur_pieces(e)
    jplan, tplan = s["j"]["plan"], s["t"]["plan"]
    assert (tplan.n_slots, tplan.n_cams, tplan.tf, tplan.te) == (
        jplan.n_slots, jplan.n_cams, jplan.tf, jplan.te)
    for f in ("bsr_cols", "bsr_indptr", "diag_slots"):
        np.testing.assert_array_equal(getattr(tplan, f), getattr(jplan, f))
    want = np.asarray(jplan.assemble(s["j"]["jac_e"], s["j"]["jac_f"], s["j"]["ete"], s["j"]["ftf"]))
    got = tplan.assemble(s["t"]["jac_e"], s["t"]["jac_f"], s["t"]["ete"], s["t"]["ftf"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    # against the implicit operator S y = Fᵀ(F y − E M⁻¹ Eᵀ F y) + D_f² y
    t = s["t"]
    tf, nc = tplan.tf, tplan.n_cams
    dense = np.zeros((nc * tf, nc * tf))
    rows = np.repeat(np.arange(nc), np.diff(tplan.bsr_indptr))
    for k in range(tplan.n_slots):
        c = tplan.bsr_cols[k]
        dense[rows[k] * tf:(rows[k] + 1) * tf, c * tf:(c + 1) * tf] = got[k].numpy()
    base = int(e["tprog"].tangent_class_bases[tplan.cam_cls])
    for j in range(0, nc * tf, 5):
        y = torch.zeros(e["tprog"].num_effective_parameters, dtype=F64)
        y[base + j] = 1.0
        t1 = t["jac_f"].right_multiply(y)
        et2 = t["jac_e"].right_multiply(t["ete"](t["jac_e"].left_multiply(t1)))
        col = t["jac_f"].left_multiply([a - b for a, b in zip(t1, et2)]) + t["dsq_f"] * y
        np.testing.assert_allclose(dense[:, j], col[base:base + nc * tf].numpy(), rtol=1e-10,
                                   atol=1e-10 * np.abs(dense).max())


def test_sparse_schur_step_matches_jax_and_dense_schur():
    from ceres_tpu_torch.linalg.schur import schur_solve as t_schur_solve

    e = _evaluated("ba")
    jo = ceres_tpu.SolverOptions(linear_solver_type=ceres_tpu.LinearSolverType.SPARSE_SCHUR)
    to = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.SPARSE_SCHUR)
    want, _ = jes.solve_sparse_schur(e["jprog"], jo, e["jjac"], e["jres"], e["jg"], e["jdsq"])
    got, iters = tes.solve_sparse_schur(e["tprog"], to, e["tjac"], e["tres"], e["tg"], e["tdsq"])
    want = np.asarray(want)
    assert int(iters) == 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    dense_opts = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR)
    dense, _ = t_schur_solve(e["tprog"], dense_opts, e["tjac"], e["tres"], e["tg"], e["tdsq"])
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def _two_e_class_problem(pkg):
    """tests/test_schur_fallbacks.py's shape: points of two sizes, so two
    e-block classes, which the explicit plan refuses."""
    rng = np.random.default_rng(0)
    p = pkg.Problem()
    cams = [p.add_parameter_block(rng.normal(size=4)) for _ in range(3)]
    pts3 = [p.add_parameter_block(rng.normal(size=3)) for _ in range(5)]
    pts2 = [p.add_parameter_block(rng.normal(size=2)) for _ in range(5)]
    if pkg is ceres_tpu:
        def f3(params, data):
            cam, pt = params
            return cam[:3] * (1.0 + pt[0]) + pt - data[0]

        def f2(params, data):
            cam, pt = params
            return cam[:2] * (1.0 + pt[0]) + pt - data[0]
    else:
        def f3(params, data):
            cam, pt = params
            return cam[:3] * (1.0 + pt[0:1]) + pt - data[0]

        def f2(params, data):
            cam, pt = params
            return cam[:2] * (1.0 + pt[0:1]) + pt - data[0]
    cf3, cf2 = pkg.CostFunction(f3, 3, name="f3"), pkg.CostFunction(f2, 2, name="f2")
    for pts, cf, r in ((pts3, cf3, 3), (pts2, cf2, 2)):
        for i, pt in enumerate(pts):
            for cam in (cams[i % 3], cams[(i + 1) % 3]):
                p.add_residual_block(cf, None, [cam, pt], (rng.normal(size=r),))
    return p


def _lm(pkg, solver, precond="JACOBI", iters=5, **kw):
    return pkg.SolverOptions(
        linear_solver_type=getattr(pkg.LinearSolverType, solver),
        preconditioner_type=getattr(pkg.PreconditionerType, precond),
        max_num_iterations=iters, eta=0.1, max_linear_solver_iterations=25,
        function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0, **kw)


def _assert_same_iterations(ts, js, rel=1e-10):
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        assert a.cost == pytest.approx(b.cost, rel=rel, abs=1e-30)
        rtol = rel + (1e-13 * b.cost / abs(b.cost_change) if b.cost_change else 0.0)
        assert a.trust_region_radius == pytest.approx(b.trust_region_radius, rel=rtol)
        assert (a.linear_solver_iterations, a.step_is_valid, a.step_is_successful) == (
            b.linear_solver_iterations, b.step_is_valid, b.step_is_successful)


def test_sparse_schur_falls_back_on_a_shape_that_is_not_ba():
    from ceres_tpu_torch.linalg.visibility import _camera_streams

    tp = _two_e_class_problem(ct)
    prog = tp.compile("cpu")
    _, _, jac, _ = Evaluator(prog, F64).evaluate_groups(prog.state_vector(F64))
    with pytest.raises(ValueError):
        _camera_streams(prog, *t_views(prog, jac))
    js = ceres_tpu.solve(_lm(ceres_tpu, "SPARSE_SCHUR"), _two_e_class_problem(ceres_tpu))
    ts = ct.solve(_lm(ct, "SPARSE_SCHUR", device="cpu"), tp)
    _assert_same_iterations(ts, js)
    ex = ts.execution_summary
    assert ex.calls("SparseSchur::Fallback") == 5 and ex.calls("SparseSchur::Explicit") == 0


SOLVES = {
    # case: (problem, linear solver, preconditioner, extra options)
    "ba-sparse_normal_cholesky": ("ba", "SPARSE_NORMAL_CHOLESKY", "JACOBI", {}),
    "pose2d-sparse_normal_cholesky": ("pose2d", "SPARSE_NORMAL_CHOLESKY", "JACOBI", {}),
    "ba-sparse_schur": ("ba", "SPARSE_SCHUR", "JACOBI", {}),
    "ba-cgnr_subset": ("ba", "CGNR", "SUBSET", {"initial_trust_region_radius": 1.0}),
    "pose2d-cgnr_subset": ("pose2d", "CGNR", "SUBSET", {"initial_trust_region_radius": 1.0}),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_matches_jax_per_iteration(case):
    name, solver, precond, extra = SOLVES[case]
    jp, tp = _problems(name)
    if precond == "SUBSET":
        # every other residual block (BA: half the observations; the pose
        # graph: half its odometry and loop closures)
        extra = dict(extra, residual_blocks_for_subset_preconditioner=list(
            range(0, tp.num_residual_blocks(), 2)))
    js = ceres_tpu.solve(_lm(ceres_tpu, solver, precond, **extra), jp)
    before = counts()
    ts = ct.solve(_lm(ct, solver, precond, device="cpu", **extra), tp)
    assert not ts.used_fused_execution and not js.used_fused_execution
    _assert_same_iterations(ts, js)
    assert ts.final_cost < ts.initial_cost
    # every host factorization in the execution summary, with its bytes
    ex = ts.execution_summary
    name = {"SPARSE_NORMAL_CHOLESKY": "SparseCholesky", "SPARSE_SCHUR": "SparseSchur",
            "CGNR": "SubsetPreconditioner"}[solver]
    assert ex.calls(f"{name}::Read") == 5 and ex.nbytes(f"{name}::Read") > 0
    assert ex.calls("Device::Read") == ts.num_device_reads == (counts() - before)["Device::Read"]
    if solver == "CGNR":
        pcg = sum(it.linear_solver_iterations for it in ts.iterations)
        assert ex.calls("SubsetPreconditioner::Apply") >= pcg


def test_subset_without_rows_raises_like_jax():
    jp, tp = _problems("ba")
    with pytest.raises(ValueError, match="residual_blocks_for_subset_preconditioner"):
        ceres_tpu.solve(_lm(ceres_tpu, "CGNR", "SUBSET"), jp)
    with pytest.raises(ValueError, match="residual_blocks_for_subset_preconditioner"):
        ct.solve(_lm(ct, "CGNR", "SUBSET", device="cpu"), tp)
