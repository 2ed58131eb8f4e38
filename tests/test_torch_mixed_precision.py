"""Mixed-precision solves (use_mixed_precision_solves) of ceres_tpu_torch
against ceres_tpu, on the CPU.

The port's bfloat16 path rounds the vector operands of each leaf product to
bfloat16 where the JAX kernels cast them to the leaf type and forms the
products exactly in float32; the JAX kernels also round those products (and
some sums) to bfloat16. So the two bfloat16 results are held to each other
at a stated tolerance, not bitwise, and each test also shows that the
port's result is not its float32 one:

- (a) the plain bfloat16 S·y (kernel B4's plain version) against
  pallas_schur.sy_apply on bfloat16 segments in interpret mode; (b) the
  plain bfloat16 B2 and B3 against pallas_onehot's kernels in interpret
  mode; (i) the composed S·y of a problem with a second residual group (a
  camera prior), where neither package's sy_meta engages;
- (c) cholesky_solve_mixed against JAX's; (h) DENSE_SCHUR's mixed step
  and its refinement count (its JAX comparison is in
  test_torch_schur_jacobi.py::test_schur_solve_mixed_matches_jax);
- (d) whole mixed LM solves against ceres_tpu's (final cost 1e-3, the bar
  of tests/test_lazy_scale_mixed_precision.py), (e) the fused loop against
  the host loop, (f) the precision gate of tests/test_precision_gate.py on
  the port (mixed float32 against float64, 1e-6);
- (g) the prepare cache under mixed: bfloat16 leaves and twins, the
  SCHUR_JACOBI tables bitwise those of the run without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu import pallas_onehot as po
from ceres_tpu.examples import snavely as j_snavely
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.jacobian import BlockJacobian as JBlockJacobian
from ceres_tpu.linalg import dense as jdense
from ceres_tpu.linalg import pallas_schur as ps
from ceres_tpu.linalg import schur as jschur
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.examples import snavely as t_snavely
from ceres_tpu_torch.gather_reduce import (
    contract_reduce,
    contract_reduce_plain,
    gather_contract,
    gather_contract_plain,
    leaf_operand,
    widen,
)
from ceres_tpu_torch.jacobian import gather_T_t, make_twin, reduce_T
from ceres_tpu_torch.linalg import dense as tdense
from ceres_tpu_torch.linalg import schur as tschur
from ceres_tpu_torch.linalg.preconditioners import apply_block_T
from ceres_tpu_torch.linalg.schur_kernels import (
    sy_apply,
    sy_apply_plain,
    sy_fold_plain,
    sy_meta,
    sy_point_plain,
    sy_tables,
)
from ceres_tpu_torch.program import Program as TProgram
from ceres_tpu_torch.program import camera_layout

torch.set_num_threads(1)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def plans(monkeypatch):
    """Layout plans (bucket / onehot, the fused S·y) at small n in both
    packages."""
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", 16)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    monkeypatch.setattr(ps, "MIN_LANES", 0)
    monkeypatch.setattr(po, "MIN_LANES", 0)


def _gap(a, b, scale):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / scale)


# ---------------------------------------------------------------- (a) --- #


def _jax_jacobian(jprog, tjac):
    """The port's leaves as a ceres_tpu BlockJacobian of the same Program
    layout (both packages order lanes alike), so that both packages' kernels
    read the same inputs without compiling ceres_tpu's evaluation."""
    groups = [tuple(jnp.asarray(leaf.numpy()) for leaf in g) for g in tjac.jac_groups]
    return JBlockJacobian.build(jprog, jprog.arrays(jnp.asarray(groups[0][0]).dtype), groups)


def _sy_setup(seed=5):
    """The problem of test_torch_schur.py::test_plain_sy_matches_pallas_sy_apply_f32:
    the float32 Jacobian (as ceres_tpu views and the port's leaves), the
    port's (EᵀE + 0.1)⁻¹ table and a camera table y."""
    bal = synthetic_bal(6, 60, 300, seed=seed)
    jprog = j_build(bal, loss=ceres_tpu.HuberLoss(1.0))[0].compile()
    tprog = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0].compile("cpu")
    f32 = torch.float32
    _c, _r, tjac, _g = Evaluator(tprog, f32).evaluate_groups(tprog.state_vector(f32))
    jac_e, jac_f = jschur.schur_views(jprog, _jax_jacobian(jprog, tjac))
    e_mask = torch.tensor(tprog.schur_tangent_masks()[0], dtype=f32)
    ete = tschur.make_ete_solver(tprog, tschur.schur_views(tprog, tjac)[0], 0.1 * e_mask)
    ncols_f = jprog.tangent_class_counts[jprog.tangent_class_of_size[9]] + 1
    y = np.random.default_rng(0).normal(size=(9, ncols_f)).astype(np.float32)
    y[:, -1] = 0.0
    return jprog, tprog, tjac, jac_e, jac_f, ete, y


def _port_sy_inputs(tprog, tjac, ete, leaf_dtype):
    meta = sy_meta(tprog)
    g = Evaluator(tprog, torch.float32).arrays["groups"][0]
    F = tjac.jac_groups[0][meta["f_pos"]].to(leaf_dtype)
    E = tjac.jac_groups[0][meta["e_pos"]].to(leaf_dtype)
    layout = g["csr"][meta["f_pos"]]
    prow = tprog.slot_rows(0, meta["e_pos"], meta["f_pos"], "cpu")
    return meta, F, E, g["t_rows"][meta["f_pos"]], layout, prow, ete.inv_tables[meta["e_cls"]]


def test_bf16_sy_matches_pallas_bf16_sy(interpret):
    """Measured on this setup, relative to the largest |S·y|: JAX bf16 vs
    JAX f32 3.2e-3 (port f32 vs JAX f32: 8.4e-7); port bf16 vs JAX bf16
    1.5e-3; port bf16 vs port f32 3.0e-3; against exact arithmetic on the
    same bfloat16 leaves, port 1.95e-3, JAX 1.95e-3, and 3.3e-3 with the
    unrounded t1 subtracted in diff."""
    jprog, tprog, tjac, jac_e, jac_f, ete, y = _sy_setup()
    jmeta = ps.sy_meta(jprog)
    assert jmeta is not None
    arrs = ps.build_sy_arrays(jprog, jac_e, jac_f, jmeta)
    arrs16 = [(f.astype(jnp.bfloat16), e.astype(jnp.bfloat16), r) for f, e, r in arrs]
    minv_segs = ps.build_minv_segments(jnp.asarray(ete.inv_tables[jmeta["e_cls"]].numpy()), jmeta)
    j16 = np.asarray(ps.sy_apply(jmeta, arrs16, minv_segs, jnp.asarray(y), jnp.bfloat16))
    yt = torch.tensor(y)
    out = {}
    for dt in (BF16, torch.float32):
        meta, F, E, rows_f, layout, prow, minv = _port_sy_inputs(tprog, tjac, ete, dt)
        out[dt] = sy_apply(meta, F, E, rows_f, make_twin(F, layout), make_twin(E, layout), prow,
                           layout, yt, minv, sy_tables(meta, "cpu"))
    assert out[BF16].dtype == torch.float32
    scale = float(out[torch.float32].abs().max())
    assert _gap(out[BF16], j16, scale) <= 2e-3
    assert _gap(out[BF16], out[torch.float32], scale) > 1e-4  # the leaves were bfloat16
    assert _gap(out[BF16], j16, scale) < 0.6 * _gap(out[torch.float32], j16, scale)
    # against exact arithmetic on the bfloat16 leaves: no worse than JAX
    meta, F, E, rows_f, layout, prow, minv = _port_sy_inputs(tprog, tjac, ete, BF16)
    F64, E64 = F.double(), E.double()
    exact = sy_apply_plain(meta, F64, E64, rows_f, make_twin(F64, layout), layout,
                           yt.double(), minv.double())
    assert _gap(out[BF16], exact, scale) <= 1.05 * _gap(j16, exact, scale)
    # diff = t1 − E t2 with the unrounded t1 while t2 came from the rounded
    # one is no longer a projection: measured 3.3e-3 against exact
    # arithmetic, which is why both passes subtract the rounded t1
    r, te, n = meta["r"], meta["te"], F.shape[1]
    plan = ("bucket", meta["buckets"])
    t1 = gather_contract_plain(F, rows_f, yt, r)
    e3 = widen(E).reshape(r, te, n)
    s = reduce_T(plan, (e3 * leaf_operand(t1, BF16)[:, None, :]).sum(dim=0), None, minv.shape[1])
    et2 = (e3 * leaf_operand(gather_T_t(plan, apply_block_T(minv, s, te), None), BF16)[None]).sum(1)
    unrounded = contract_reduce_plain(make_twin(F, layout), layout, t1 - et2, r)
    unrounded[:, -1] = 0
    assert _gap(unrounded, exact, scale) > 1.3 * _gap(out[BF16], exact, scale)
    # B4's two passes compose to the bfloat16 S·y
    t2 = sy_point_plain(meta, F, E, rows_f, yt, minv)
    fold = sy_fold_plain(meta, make_twin(F, layout), make_twin(E, layout), prow, layout, yt, t2)
    assert _gap(fold, out[BF16], scale) <= 1e-6


# ---------------------------------------------------------------- (b) --- #


def _onehot_inputs(seed, n, r=2, t=9, ncols=7):
    rng = np.random.default_rng(seed)
    jac = rng.normal(size=(r * t, n)).astype(np.float32)
    rows = rng.integers(0, ncols, n).astype(np.int32)
    table = rng.normal(size=(t, ncols)).astype(np.float32)
    table[:, -1] = 0.0
    u = rng.normal(size=(r, n)).astype(np.float32)
    return jac, rows, table, u


@pytest.mark.parametrize("n", [300, 5000])
def test_bf16_gather_contract_matches_pallas(interpret, n):
    """B2 on bfloat16 leaves: both packages round the table to bfloat16 and
    form exact products, so they agree to float32 rounding (measured
    ~1e-7); the float32 result is ~1e-3 away."""
    jac, rows, table, _ = _onehot_inputs(0, n)
    want = np.asarray(po.gather_contract(
        jnp.asarray(jac, jnp.bfloat16), jnp.asarray(rows), jnp.asarray(table), 2))
    jt, rt, tt = torch.tensor(jac), torch.tensor(rows), torch.tensor(table)
    got = gather_contract(jt.to(BF16), rt, tt, 2)
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert _gap(got, want, scale) <= 1e-5
    assert _gap(got, gather_contract(jt, rt, tt, 2), scale) > 1e-4


@pytest.mark.parametrize("n", [300, 5000])
def test_bf16_contract_reduce_matches_pallas(interpret, n):
    """B3 on bfloat16 leaves: both round u to bfloat16; JAX also rounds each
    product and their sum over r to bfloat16, the port keeps them exact. So
    the port is exact arithmetic on the rounded inputs up to float32 sums
    (measured <= 4.7e-7 of the largest output, seeds 1-3 at both n), and
    its gap to JAX is JAX's own rounding (measured 1.7e-3 to 2.0e-3, equal
    to JAX's gap to exact arithmetic; the float32 results are 2.0e-3 to
    3.4e-3 away)."""
    jac, rows, table, u = _onehot_inputs(1, n)
    ncols = table.shape[1]
    want = np.asarray(po.contract_reduce(
        jnp.asarray(jac, jnp.bfloat16), jnp.asarray(rows), jnp.asarray(u), ncols, 2))
    layout = camera_layout(rows, ncols).to("cpu")
    jt, ut = torch.tensor(jac), torch.tensor(u)
    got = contract_reduce(make_twin(jt.to(BF16), layout), layout, ut, 2)
    assert got.dtype == torch.float32 and got.shape == (9, ncols)
    scale = float(np.abs(want).max())
    exact = contract_reduce(make_twin(jt.to(BF16).double(), layout), layout,
                            ut.to(BF16).double(), 2)
    assert _gap(got, exact, scale) <= 1e-6
    assert _gap(got, want, scale) <= 2.5e-3
    f32 = contract_reduce(make_twin(jt, layout), layout, ut, 2)
    assert _gap(got, f32, scale) > 1e-4
    # the segmented sum (u = None) of a bfloat16 twin, in float32
    twin = make_twin(jt[:9].contiguous().to(BF16), layout)
    plain = contract_reduce_plain(twin, layout, None, 1)
    assert plain.dtype == torch.float32
    lane = torch.zeros((9, ncols)).index_add_(1, torch.tensor(rows).long(), jt[:9].to(BF16).float())
    assert _gap(plain, lane, float(lane.abs().max())) <= 1e-6


# ---------------------------------------------------------------- (c) --- #


@pytest.mark.parametrize("sweeps", [0, 3])
def test_cholesky_solve_mixed_matches_jax(sweeps):
    """The matrix of tests/test_linear_solvers_direct.py:121-136 in float64:
    with no sweep both packages give a float32-factor solution (error > 1e-7
    against the truth); three sweeps refine both to float64 accuracy."""
    rng = np.random.default_rng(3)
    n = 60
    a = rng.normal(size=(n, n))
    lhs = a.T @ a + 1e-3 * np.eye(n)
    x_true = rng.normal(size=n)
    rhs = lhs @ x_true
    want = np.asarray(jdense.cholesky_solve_mixed(jnp.asarray(lhs), jnp.asarray(rhs), sweeps))
    got = tdense.cholesky_solve_mixed(torch.tensor(lhs), torch.tensor(rhs), sweeps)
    assert got.dtype == torch.float64
    err = np.linalg.norm(got.numpy() - x_true) / np.linalg.norm(x_true)
    j_err = np.linalg.norm(want - x_true) / np.linalg.norm(x_true)
    if sweeps == 0:
        assert err > 1e-7 and j_err > 1e-7
        assert err < 10 * j_err
    else:
        assert err < 1e-11 and j_err < 1e-11
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


def test_cholesky_solve_mixed_failed_factor_is_nan():
    lhs = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)  # indefinite
    assert torch.isnan(tdense.cholesky_solve_mixed(lhs, torch.ones(2, dtype=torch.float64))).all()


# ---------------------------------------------------------------- (d) --- #


def _lm(pkg, precond, **kw):
    return pkg.SolverOptions(
        linear_solver_type=pkg.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=getattr(pkg.PreconditionerType, precond),
        max_num_iterations=10,
        use_mixed_precision_solves=True,
        **kw,
    )


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("precond", ["SCHUR_JACOBI", "JACOBI"])
def test_mixed_solve_matches_jax(precond, fused):
    """Measured gaps 5e-6 to 7e-5 (plans engaged, 10 iterations)."""
    bal = synthetic_bal(6, 50, 200, seed=2)
    jp = j_build(bal, loss=ceres_tpu.HuberLoss(1.0))[0]
    tp = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]
    js = ceres_tpu.solve(_lm(ceres_tpu, precond, fused_execution=fused, dtype=jnp.float32), jp)
    ts = ct.solve(_lm(ct, precond, fused_execution=fused, dtype=torch.float32, device="cpu"), tp)
    assert ts.used_fused_execution == js.used_fused_execution == fused
    assert ts.final_cost < 0.5 * ts.initial_cost
    assert abs(ts.final_cost - js.final_cost) <= 1e-3 * max(1.0, abs(js.final_cost))


# ---------------------------------------------------------------- (e) --- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("precond", ["SCHUR_JACOBI", "JACOBI", "IDENTITY"])
def test_mixed_fused_loop_matches_host_loop(precond, dtype):
    bal = synthetic_bal(6, 50, 200, seed=2)
    runs = [
        ct.solve(_lm(ct, precond, fused_execution=fused, dtype=dtype, device="cpu"),
                 ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0])
        for fused in (False, True)
    ]
    assert [s.used_fused_execution for s in runs] == [False, True]
    host, fused = runs
    assert len(host.iterations) == len(fused.iterations) == 11
    for a, b in zip(fused.iterations, host.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-12)
        assert a.linear_solver_iterations == b.linear_solver_iterations
        assert a.step_is_successful == b.step_is_successful


# ---------------------------------------------------------------- (f) --- #


def test_port_precision_gate_mixed_f32_vs_f64():
    """tests/test_precision_gate.py on the port: the mixed float32 solve
    ends within Ceres' default function tolerance (1e-6) of the float64
    solve, on that test's problem and options."""
    bal = synthetic_bal(24, 600, 3000, seed=11)
    costs = {}
    for dtype, mixed in ((torch.float64, False), (torch.float32, True)):
        s = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            max_num_iterations=60, dtype=dtype, use_mixed_precision_solves=mixed,
            device="cpu"), ct.build_ba_problem(bal)[0])
        assert s.termination_type in (
            ct.TerminationType.CONVERGENCE, ct.TerminationType.NO_CONVERGENCE)
        costs[mixed] = s.final_cost
    assert abs(costs[True] - costs[False]) / costs[False] <= 1e-6


# ---------------------------------------------------------------- (g) --- #


def _scaled_jacobian(tprog, dtype):
    _c, res, jac, grad = Evaluator(tprog, dtype).evaluate_groups(tprog.state_vector(dtype))
    scale = 1.0 / (1.0 + torch.sqrt(jac.squared_column_norms()))
    return jac.scale_columns(scale), res, grad * scale


@pytest.mark.parametrize("precond", ["SCHUR_JACOBI", "JACOBI", "IDENTITY"])
def test_prepare_cache_under_mixed(precond):
    bal = synthetic_bal(6, 60, 300, seed=6)
    tprog = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0].compile("cpu")
    meta = sy_meta(tprog)
    assert meta is not None
    jac_s, _res, _grad = _scaled_jacobian(tprog, torch.float32)
    caches = {
        mixed: tschur.schur_prepare(tprog, ct.SolverOptions(
            preconditioner_type=getattr(ct.PreconditionerType, precond),
            use_mixed_precision_solves=mixed), jac_s)
        for mixed in (False, True)
    }
    full, mixed = caches[False], caches[True]
    for a, b in zip(full["p0"] or [], mixed["p0"] or []):
        assert (a is None and b is None) or (a.dtype == torch.float32 and torch.equal(a, b))
    assert (full["p0"] is None) == (precond == "IDENTITY")
    for k in ("colnorm2",):
        assert torch.equal(full[k], mixed[k])
    leaves = [j for jacs in mixed["jac_mv_groups"] for j in jacs]
    assert leaves and all(j.dtype == BF16 for j in leaves)
    for a, b in zip([j for jacs in full["jac_mv_groups"] for j in jacs], leaves):
        assert torch.equal(a.to(BF16), b)
    # F's twin, and E's in F's camera order (B4's slot pass), in bfloat16
    keys = {(0, meta["f_pos"], meta["f_pos"]), (0, meta["e_pos"], meta["f_pos"])}
    assert keys <= set(mixed["jac_mv_twins"]) and set(mixed["jac_mv_twins"]) == set(full["jac_mv_twins"])
    for key, twin in mixed["jac_mv_twins"].items():
        assert twin.dtype == BF16 and torch.equal(full["jac_mv_twins"][key].to(BF16), twin)


# ---------------------------------------------------------------- (h) --- #


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_dense_schur_mixed_refines(monkeypatch, refine):
    """DENSE_SCHUR under mixed: the dense S in float64, factored in float32
    and refined in float64 max(1, max_num_refinement_iterations or 3) times
    (ceres_tpu/linalg/schur.py:905-913); the step is the float64 factor's.
    Against ceres_tpu's mixed DENSE_SCHUR step:
    test_torch_schur_jacobi.py::test_schur_solve_mixed_matches_jax[dense_schur],
    beside the float64 dense case whose compiled JAX path it shares."""
    sweeps = []

    def recording(lhs, rhs, refine_iterations):
        sweeps.append(refine_iterations)
        return tdense.cholesky_solve_mixed(lhs, rhs, refine_iterations)

    monkeypatch.setattr(tschur, "cholesky_solve_mixed", recording)
    tprog = ct.build_ba_problem(synthetic_bal(6, 60, 300, seed=8),
                                loss=ct.HuberLoss(1.0))[0].compile("cpu")
    tjs, tres, tgs = _scaled_jacobian(tprog, torch.float64)
    steps = []
    for mixed in (True, False):
        topt = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                                use_mixed_precision_solves=mixed,
                                max_num_refinement_iterations=refine)
        dsq = torch.clamp(tjs.squared_column_norms(), topt.min_lm_diagonal,
                          topt.max_lm_diagonal) / 10.0
        step, its = tschur.schur_solve(tprog, topt, tjs, tres, tgs, dsq)
        assert int(its) == 1
        steps.append(step.numpy())
    assert sweeps == [max(1, refine or 3)]
    scale = float(np.abs(steps[1]).max())
    assert _gap(steps[0], steps[1], scale) <= (1e-6 if refine == 1 else 1e-9)


# ---------------------------------------------------------------- (i) --- #


def _prior_problem(pkg, bal, weight=0.3):
    """BAL with a second residual group: a prior pulling every camera toward
    its start. The prior group comes first: ceres_tpu's Program rebinds its
    group table while it plans a group (ceres_tpu/program.py:607 against
    :518), so a planned group followed by another fails to compile there."""
    snavely = j_snavely if pkg is ceres_tpu else t_snavely
    problem = pkg.Problem()
    cams = problem.add_parameter_blocks(bal.cameras)
    pts = problem.add_parameter_blocks(bal.points)

    def prior(params, data):
        return weight * (params[0] - data[0])

    problem.add_residual_blocks(pkg.CostFunction(prior, 9), None, cams[:, None], (bal.cameras,))
    kernel = {} if pkg is ceres_tpu else {"kernel": "snavely"}
    problem.add_residual_blocks(
        pkg.CostFunction(snavely.snavely_reprojection_error, 2, **kernel), pkg.HuberLoss(1.0),
        np.stack([cams[bal.camera_index], pts[bal.point_index]], axis=1), (bal.observations,),
    )
    return problem


def test_composed_path_sy_mixed_matches_jax():
    """A problem with a camera prior group: neither package's sy_meta
    engages, so S·y is the composed products (B2 and B3 on bfloat16 leaves
    on the camera position's onehot plan). Port vs JAX on the same mixed
    operator; measured, relative to the largest entry: 1.8e-3 (JAX rounds
    the products), against 3.1e-3 between the port's mixed and float32
    S·y and 3.1e-3 between the port's float32 and JAX's mixed S·y."""
    bal = synthetic_bal(6, 60, 300, seed=6)
    jprog = _prior_problem(ceres_tpu, bal).compile()
    tprog = _prior_problem(ct, bal).compile("cpu")
    assert len(tprog.groups) == len(jprog.groups) == 2
    assert ps.sy_meta(jprog) is None and sy_meta(tprog) is None
    f_cls = tprog.tangent_class_of_size[9]
    ba = tprog.groups[1]  # the camera position of the BA group is on the onehot plan
    assert ba.red_plans[[pm.t_cls for pm in ba.positions].index(f_cls)][0] == "onehot"
    f32 = torch.float32
    _c, _r, tjac, _g = Evaluator(tprog, f32).evaluate_groups(tprog.state_vector(f32))
    tjm = tjac.scale_columns(1.0 / (1.0 + torch.sqrt(tjac.squared_column_norms()))).materialize_scale()
    e_np = tprog.schur_tangent_masks()[0]
    rng = np.random.default_rng(1)
    y = rng.normal(size=(9, tprog.tangent_class_counts[f_cls] + 1)).astype(np.float32)
    y[:, -1] = 0

    def jax_sy(jm):
        j_e, _ = jschur.schur_views(jprog, jm)
        jete = jschur.make_ete_solver(jprog, j_e, 0.1 * jnp.asarray(e_np, jnp.float32))
        j_e16, j_f16 = jschur.schur_views(jprog, jm.astype(jnp.bfloat16))
        tv = [jnp.zeros((t, c + 1), jnp.float32)
              for t, c in zip(jprog.tangent_class_sizes, jprog.tangent_class_counts)]
        tv[f_cls] = jnp.asarray(y)
        t1 = j_f16.right_multiply_t(tv)
        et2 = j_e16.right_multiply_t(jete.apply_t(j_e16.left_multiply_t(t1)))
        return j_f16.left_multiply_t([a - b for a, b in zip(t1, et2)])[f_cls]

    want = np.asarray(jax.jit(jax_sy)(_jax_jacobian(jprog, tjm)))
    t_e, _t_f = tschur.schur_views(tprog, tjm)
    tete = tschur.make_ete_solver(tprog, t_e, 0.1 * torch.tensor(e_np, dtype=f32))
    f_set = tschur._pure_class_split(tprog)[0]
    zero = [torch.zeros((t, cnt + 1 if c in f_set else 0)) for c, (t, cnt)
            in enumerate(zip(tprog.tangent_class_sizes, tprog.tangent_class_counts))]
    ytv = list(zero)
    ytv[f_cls] = torch.tensor(y)
    got = {dt: tschur._s_apply_t(tprog, tjm.astype(dt), tete, zero, f_set)(ytv)[f_cls]
           for dt in (BF16, f32)}
    assert got[BF16].dtype == f32
    scale = float(np.abs(want).max())
    assert _gap(got[BF16], want, scale) <= 2.5e-3
    assert _gap(got[BF16], got[f32], scale) > 1e-4
    assert _gap(got[BF16], want, scale) < 0.6 * _gap(got[f32], want, scale)
