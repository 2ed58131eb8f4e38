"""The modeling surface of ceres_tpu_torch.Problem against ceres_tpu's, in
float64 on the CPU: single adds, set_manifold, constant/variable and value
changes, the block queries, removals, residual_rows_for_handles, and
Problem.evaluate (whole and on a residual subset, with the loss and
without) at 1e-12; then a solve after remove_parameter_block per iteration.

ceres_tpu's block store writes a removed block's stale values at state
offset 0 when it lowers the Program (its `_BlockStore.fill_state` keeps
blocks whose offset is 0, and a removed block's is 0), unless the block at
offset 0 was touched on its own since, which rewrites it. The parity tests
read every block's value first, in both packages (which touches each block
in ceres_tpu); `test_removed_block_leaves_the_state_alone` shows the port
without that reading (ROADMAP Queue C).
"""

import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch.program import Program as TProgram

torch.set_num_threads(1)
RTOL = 1e-12


def point_quat(params, data):
    """3 residuals of a 3-vector and a 4-vector (array code both packages
    can run)."""
    x, q = params
    return x * q[0] + q[1:] * q[1:] - data[0]


def point_pair(params, data):
    x, y = params
    return x[:2] * y - data[0]


def _build(pkg):
    """The same problem, one add at a time, in package `pkg`: the handles
    and a log of what each step returned."""
    rng = np.random.default_rng(11)
    p = pkg.Problem()
    log = []
    a = p.add_parameter_block([1.0, 2.0, 3.0])
    b = p.add_parameter_block([0.5, -1.0, 2.0, 0.3])
    c = p.add_parameter_block([0.1, 0.2])
    pts = p.add_parameter_blocks(rng.normal(size=(6, 3)))
    p.set_manifold(b, pkg.QuaternionManifold())
    f_pq = pkg.CostFunction(point_quat, 3, name="point_quat")
    f_pp = pkg.CostFunction(point_pair, 2, name="point_pair")
    handles = []
    for x in [a, *pts]:
        handles.append(p.add_residual_block(f_pq, pkg.HuberLoss(0.5), [x, b], (rng.normal(size=3),)))
    for x in pts[::2]:
        handles.append(p.add_residual_block(f_pp, None, [x, c], (rng.normal(size=2),)))
    log.append(("handles", [int(h) for h in handles]))
    log.append(("counts", _counts(p)))
    p.set_parameter_block_constant(c)
    log.append(("constant", _counts(p), p.is_parameter_block_constant(c)))
    p.set_parameter_block_variable(c)
    log.append(("variable", _counts(p), p.is_parameter_block_constant(c)))
    p.set_parameter_block_constant(pts[5])
    p.set_parameter_block_value(pts[1], [0.3, -0.2, 0.9])
    p.remove_parameter_block(int(pts[3]))
    p.remove_residual_block(handles[2])
    with pytest.raises(KeyError):
        p.remove_residual_block(handles[2])
    with pytest.raises(ValueError) as err:
        p.add_residual_block(f_pp, None, [pts[3], c], (np.zeros(2),))
    log.append(("add removed", str(err.value)))
    with pytest.raises(ValueError) as err:
        p.set_manifold(a, pkg.QuaternionManifold())
    log.append(("set_manifold size", str(err.value)))
    live = [int(h) for h in handles if _blocks_of(p, h) is not None]
    log.append(("after removals", _counts(p), live))
    log.append(("blocks of", [p.parameter_blocks_for_residual_block(h) for h in live]))
    blocks = [int(x) for x in [a, b, c, *pts] if int(x) != int(pts[3])]
    log.append(("residuals of", [p.residual_blocks_for_parameter_block(x) for x in blocks]))
    log.append(("values", [p.parameter_block_value(x).tolist() for x in blocks]))
    p.mark_structure_dirty()
    return p, live, log


def _blocks_of(p, h):
    """The blocks of residual block h, None once it is gone."""
    try:
        return p.parameter_blocks_for_residual_block(h)
    except KeyError:
        return None


def _counts(p):
    return (p.num_parameter_blocks(), p.num_parameters(), p.num_effective_parameters(),
            p.num_residual_blocks(), p.num_residuals())


def test_single_adds_changes_queries_and_removals_match_jax():
    jp, jlive, jlog = _build(ceres_tpu)
    tp, tlive, tlog = _build(ct)
    assert tlive == jlive and len(tlive) == 8
    for a, b in zip(tlog, jlog, strict=True):
        assert a == b
    np.testing.assert_array_equal(
        tp.residual_rows_for_handles(tlive[::3]),
        jp.residual_rows_for_handles(jlive[::3]))


def _close_evaluations(got, want):
    (tc, tr, tg, (tv, tcol, tptr)), (jc, jr, jg, (jv, jcol, jptr)) = got, want
    assert tc == pytest.approx(jc, rel=RTOL)
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=RTOL, atol=RTOL * np.abs(jr).max())
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=RTOL, atol=RTOL * np.abs(jg).max())
    np.testing.assert_array_equal(tcol, jcol)
    np.testing.assert_array_equal(tptr, jptr)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=RTOL, atol=RTOL * np.abs(jv).max())


@pytest.mark.parametrize("loss", [True, False], ids=["loss", "no_loss"])
@pytest.mark.parametrize("subset", [False, True], ids=["whole", "subset"])
def test_evaluate_matches_jax(loss, subset):
    jp, jlive, _ = _build(ceres_tpu)
    tp, tlive, _ = _build(ct)
    sel = tlive[1::2] if subset else None
    want = jp.evaluate(apply_loss_function=loss, residual_blocks=sel)
    got = tp.evaluate(apply_loss_function=loss, residual_blocks=sel, device="cpu")
    assert isinstance(got[0], float) and isinstance(got[1], np.ndarray)
    assert got[1].shape == np.asarray(want[1]).shape
    _close_evaluations(got, want)
    assert got[3][2][-1] == got[3][0].size


def test_evaluate_defaults_to_the_card(monkeypatch):
    """Problem.evaluate runs on the card unless the caller names the CPU:
    with no card visible it raises (no silent CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp, tlive, _ = _build(ct)
    for kw in ({}, {"residual_blocks": tlive[:2]}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tp.evaluate(**kw)
    assert np.isfinite(tp.evaluate(device="cpu")[0])


def _bal():
    return synthetic_bal(8, 60, 300, seed=3, perturb_points=0.05)


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("removed", ["camera", "point"])
def test_solve_after_remove_parameter_block_matches_jax(monkeypatch, removed, fused):
    """JACOBI: removing a camera leaves points seen by one camera only, whose
    singular EᵀE makes SCHUR_JACOBI's cached correction (a 100·eps ridge)
    amplify rounding, the reference against itself included (ROADMAP Queue
    C, tests/test_torch_schur_jacobi.py LONE_TOL)."""
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", 16)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    sums, values = [], []
    for pkg, build in ((ceres_tpu, j_build), (ct, ct.build_ba_problem)):
        problem, cams, pts = build(_bal(), loss=pkg.HuberLoss(1.0))
        problem.remove_parameter_block(int(cams[2] if removed == "camera" else pts[7]))
        alive = [int(h) for h in np.concatenate([cams, pts])
                 if int(h) != int(cams[2] if removed == "camera" else pts[7])]
        values.append([problem.parameter_block_value(h) for h in alive])
        kw = {"device": "cpu"} if pkg is ct else {}
        sums.append(pkg.solve(pkg.SolverOptions(
            linear_solver_type=pkg.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=pkg.PreconditionerType.JACOBI, max_num_iterations=5,
            eta=0.1, max_linear_solver_iterations=25, function_tolerance=0.0,
            gradient_tolerance=0.0, parameter_tolerance=0.0, fused_execution=fused, **kw),
            problem))
    np.testing.assert_array_equal(np.concatenate(values[0]), np.concatenate(values[1]))
    js, ts = sums
    assert ts.num_residual_blocks == js.num_residual_blocks < 300
    assert ts.num_parameter_blocks == js.num_parameter_blocks == 67
    assert len(ts.iterations) == len(js.iterations) == 6
    for a, b in zip(ts.iterations, js.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-10)
        assert a.linear_solver_iterations == b.linear_solver_iterations
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)


def test_removed_block_leaves_the_state_alone():
    """After remove_parameter_block every live block starts from its own
    values and a solve writes nothing into the removed block. ceres_tpu,
    lowered without first touching the block at offset 0, starts that
    block from the removed block's values (ROADMAP Queue C)."""
    bal = synthetic_bal(4, 20, 80, seed=5)
    tp, _, tpts = ct.build_ba_problem(bal)
    jp, _, jpts = j_build(bal)
    tp.remove_parameter_block(int(tpts[-1]))
    jp.remove_parameter_block(int(jpts[-1]))
    tprog, jprog = tp.compile("cpu"), jp.compile()
    first = [b for b in range(len(tprog.x_offsets))
             if tprog.x_offsets[b] == 0 and b != int(tpts[-1])]
    assert len(first) == 1
    for b in range(len(tprog.x_offsets)):
        if b != int(tpts[-1]):
            o, s = tprog.x_offsets[b], tprog.sizes[b]
            np.testing.assert_array_equal(tprog.state0[o : o + s], tp.parameter_block_value(b))
    # the reference's stale write, witnessed
    assert jprog.x_offsets[first[0]] == 0
    np.testing.assert_array_equal(jprog.state0[:3], bal.points[-1])
    ct.solve(ct.SolverOptions(max_num_iterations=2, device="cpu",
                              linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR), tp)
    np.testing.assert_array_equal(tp.parameter_block_value(int(tpts[-1])), bal.points[-1])
