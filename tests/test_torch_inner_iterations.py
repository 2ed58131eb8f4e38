"""The port's inner iterations (solvers/inner_iterations.py), the host
loop's problem dump and check_gradients against ceres_tpu's, in float64 on
the CPU.

- one sweep (make_inner_iteration_fn) against JAX's at the same state and
  damping, 1e-12, with and without the layout plans, on angle-axis and
  quaternion BA (B1's plain version gives the e-leaf), and on Powell's
  function (a functor of B1 generic; the torch.func path on the CPU);
- solves with use_inner_iterations (ITERATIVE_SCHUR + SCHUR_JACOBI, CGNR):
  per iteration cost and radius within 1e-10, num_inner_iteration_steps
  equal; the inner_iteration_tolerance switch-off
  (tests/test_inner_iterations.py:47-68); inner_iteration_ordering, which
  leaves the LM's own partition and the Program's schur_cache alone;
- both options take the host loop (the fused loop's clauses,
  ceres_tpu/solvers/fused_loop.py:111, 114);
- trust_region_minimizer_iterations_to_dump: the two packages' .npz files
  equal within 1e-12 (of each array's largest entry), cols and row_ptr
  exactly;
- check_gradients passes and fails as JAX's does, max_relative_error
  within 1e-6, and a failed check ends the solve before any evaluation."""

import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.program import Program as JProgram
from ceres_tpu.solvers.inner_iterations import make_inner_iteration_fn as j_make
from ceres_tpu_torch.evaluator import Evaluator as TEvaluator
from ceres_tpu_torch.program import Program as TProgram
from ceres_tpu_torch.solvers.inner_iterations import make_inner_iteration_fn as t_make

torch.set_num_threads(1)
TOL = 1e-10

# test_torch_solve.py's SCHUR_JACOBI problem: no point seen by one camera
# only (the SCHUR_JACOBI ridge, tests/test_torch_schur_jacobi.py)
BAL = synthetic_bal(8, 60, 300, seed=3, perturb_points=0.05)


def _lm(pkg, **kw):
    base = dict(
        linear_solver_type=pkg.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=pkg.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=6, eta=0.1, max_linear_solver_iterations=25,
        function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
        use_inner_iterations=True,
    )
    return pkg.SolverOptions(**{**base, **kw})


def _problems(quaternion=False):
    kw = dict(use_quaternions=True, use_manifolds=True) if quaternion else {}
    jp = j_build(BAL, loss=ceres_tpu.HuberLoss(1.0), **kw)
    tp = ct.build_ba_problem(BAL, loss=ct.HuberLoss(1.0), **kw)
    return jp, tp


@pytest.mark.parametrize("threshold", [16, 10**9], ids=["plans", "no_plans"])
@pytest.mark.parametrize("quaternion", [False, True], ids=["angle_axis", "quaternion"])
@pytest.mark.parametrize("damping", [1e-4, 1e-2])
def test_sweep_matches_jax(monkeypatch, threshold, quaternion, damping):
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", threshold)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", threshold)
    (jp, _, _), (tp, _, _) = _problems(quaternion)
    jprog, tprog = jp.compile(), tp.compile("cpu")
    options = ct.SolverOptions(use_inner_iterations=True)
    jev = ceres_tpu.evaluator.Evaluator(jprog)
    j_sweep = j_make(jprog, ceres_tpu.SolverOptions(use_inner_iterations=True))
    want = np.asarray(j_sweep(jev.arrays, jprog.state_vector(), damping))
    t_sweep = t_make(tprog, options, TEvaluator(tprog, torch.float64))
    got = t_sweep(tprog.state_vector(torch.float64), torch.tensor(damping, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert not np.array_equal(want, np.asarray(jprog.state_vector()))


def test_sweep_on_a_generic_functor_matches_jax():
    """Powell's function: B1 generic's plain version (torch.func) gives the
    e-leaf; the partition eliminates single-residual 1-D blocks."""
    from ceres_tpu.examples.test_functions import build_powell_problem as j_powell
    from ceres_tpu_torch.examples.test_functions import build_powell_problem as t_powell

    jprog, tprog = j_powell()[0].compile(), t_powell()[0].compile("cpu")
    j_sweep = j_make(jprog, ceres_tpu.SolverOptions(use_inner_iterations=True))
    t_sweep = t_make(tprog, ct.SolverOptions(use_inner_iterations=True), TEvaluator(tprog))
    assert (j_sweep is None) == (t_sweep is None)
    if j_sweep is None:
        return
    want = np.asarray(j_sweep(ceres_tpu.evaluator.Evaluator(jprog).arrays, jprog.state_vector(), 1e-4))
    got = t_sweep(tprog.state_vector(torch.float64), torch.tensor(1e-4, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def _match(sj, st, tol=TOL):
    assert len(sj.iterations) == len(st.iterations)
    for a, b in zip(sj.iterations, st.iterations):
        assert b.cost == pytest.approx(a.cost, rel=tol)
        # the radius follows rho, whose relative error is the costs'
        # rounding amplified by cost / |change| (test_torch_solve.py)
        rtol = tol + (1e-13 * a.cost / abs(a.cost_change) if a.cost_change else 0.0)
        assert b.trust_region_radius == pytest.approx(a.trust_region_radius, rel=rtol)
        assert (b.linear_solver_iterations, b.step_is_successful) == (
            a.linear_solver_iterations, a.step_is_successful)
    assert st.num_inner_iteration_steps == sj.num_inner_iteration_steps


@pytest.mark.parametrize("solver", ["ITERATIVE_SCHUR", "CGNR"])
@pytest.mark.parametrize("threshold", [16, 10**9], ids=["plans", "no_plans"])
def test_inner_iteration_solve_matches_jax(monkeypatch, solver, threshold):
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", threshold)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", threshold)
    (jp, _, _), (tp, _, _) = _problems()
    kw = lambda pkg: dict(linear_solver_type=getattr(pkg.LinearSolverType, solver))  # noqa: E731
    sj = ceres_tpu.solve(_lm(ceres_tpu, **kw(ceres_tpu)), jp)
    st = ct.solve(_lm(ct, device="cpu", **kw(ct)), tp)
    _match(sj, st)
    assert st.num_inner_iteration_steps > 0
    assert st.used_fused_execution is False
    assert st.final_cost < st.initial_cost


def test_inner_iteration_tolerance_matches_jax():
    """tests/test_inner_iterations.py:47-68: a tolerance of 1.0 switches
    the refinement off after its first pass; 0 keeps it on."""
    for tol, check in ((1.0, lambda n: n == 1), (0.0, lambda n: n > 1)):
        (jp, _, _), (tp, _, _) = _problems()
        sj = ceres_tpu.solve(_lm(ceres_tpu, inner_iteration_tolerance=tol), jp)
        st = ct.solve(_lm(ct, device="cpu", inner_iteration_tolerance=tol), tp)
        _match(sj, st)
        assert check(st.num_inner_iteration_steps)


@pytest.mark.parametrize("refined", ["points", "cameras"])
def test_inner_iteration_ordering_matches_jax_and_leaves_the_partition(refined):
    """Group 0 of inner_iteration_ordering picks the refined blocks: the
    points, or the cameras (also an independent set: no observation sees
    two cameras), while the LM eliminates the points. The inner partition
    neither reads nor writes the Program's cached one."""
    (jp, jc, jpts), (tp, tc, tpts) = _problems()

    def ordering(pkg, first, second):
        o = pkg.ParameterBlockOrdering()
        for group, handles in enumerate((first, second)):
            for h in handles:
                o.add_element_to_group(int(h), group)
        return o

    if refined == "points":
        jo, to = ordering(ceres_tpu, jpts, jc), ordering(ct, tpts, tc)
    else:
        jo, to = ordering(ceres_tpu, jc, jpts), ordering(ct, tc, tpts)
    program = tp.compile("cpu")
    sj = ceres_tpu.solve(_lm(ceres_tpu, inner_iteration_ordering=jo), jp)
    st = ct.solve(_lm(ct, device="cpu", inner_iteration_ordering=to), tp)
    _match(sj, st)
    assert st.num_inner_iteration_steps > 0
    # the LM's own partition (the points eliminated) is the cached one, and
    # the Schur tables built from it stay
    assert program.schur_cache["partition"][1] == [(1,)]
    assert {"partition", "masks"} <= set(program.schur_cache)
    _, inner_e, _ = program.compute_schur_partition(
        user_e_override=[int(h) for h in (tpts if refined == "points" else tc)])
    assert inner_e == ([(1,)] if refined == "points" else [(0,)])
    assert program.schur_cache["partition"][1] == [(1,)]


def test_dump_matches_jax(tmp_path):
    (jp, _, _), (tp, _, _) = _problems()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    kw = dict(use_inner_iterations=False, max_num_iterations=3)
    ceres_tpu.solve(_lm(ceres_tpu, trust_region_minimizer_iterations_to_dump=(1, 3),
                        trust_region_problem_dump_directory=str(jdir), **kw), jp)
    s = ct.solve(_lm(ct, device="cpu", trust_region_minimizer_iterations_to_dump=(1, 3),
                     trust_region_problem_dump_directory=str(tdir), **kw), tp)
    assert s.used_fused_execution is False
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir()) == [
        "ceres_tpu_problem_001.npz", "ceres_tpu_problem_003.npz"]
    for name in names:
        want, got = np.load(jdir / name), np.load(tdir / name)
        assert sorted(want.files) == sorted(got.files)
        for key in ("jacobian_cols", "jacobian_row_ptr"):
            np.testing.assert_array_equal(got[key], want[key])
        # within 1e-12 of each array's largest entry: iteration 3's state
        # carries two steps' rounding
        for key in ("jacobian_values", "residuals", "gradient", "scale", "trust_region_radius"):
            scale = max(float(np.abs(want[key]).max()), 1.0)
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("option", [
    dict(use_inner_iterations=True), dict(trust_region_minimizer_iterations_to_dump=(2,))])
def test_options_take_the_host_loop(tmp_path, option):
    """The fused loop would accept the option and ignore it."""
    from ceres_tpu_torch.solvers import fused_loop

    option = dict(option)
    if "trust_region_minimizer_iterations_to_dump" in option:
        option["trust_region_problem_dump_directory"] = str(tmp_path)
    options = _lm(ct, device="cpu", **{"use_inner_iterations": False, **option})
    assert options.fused_execution
    assert not fused_loop.eligible(options, object())
    s = ct.solve(options, _problems()[1][0])
    assert s.used_fused_execution is False


# ---- check_gradients ------------------------------------------------------ #


class _BadSquare(torch.autograd.Function):
    """v² with the wrong forward derivative 3 dv (the custom_jvp of
    tests/test_gradient_check_mode.py:29-49); jacfwd vmaps the jvp."""

    generate_vmap_rule = True

    @staticmethod
    def forward(v):
        return v * v

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, dv):
        return 3.0 * dv


def _check_problems(pkg, bad):
    p = pkg.Problem()
    if bad:
        import jax

        if pkg is ceres_tpu:
            @jax.custom_jvp
            def sq(v):
                return v * v

            @sq.defjvp
            def sq_jvp(primals, tangents):
                (v,), (dv,) = primals, tangents
                return v * v, 3.0 * dv
        else:
            sq = _BadSquare.apply
        y = p.add_parameter_block(np.array([2.0]))
        p.add_residual_block(pkg.CostFunction(lambda ps, d: sq(ps[0]), 1, name="bad"), None, [y])
    else:
        target = np.array([1.0, -2.0])
        x = p.add_parameter_block(np.array([3.0, 1.0]))
        lib = np if pkg is ceres_tpu else torch
        p.add_residual_block(
            pkg.CostFunction(lambda ps, d: ps[0] - lib.asarray(target), 2), None, [x])
    return p


@pytest.mark.parametrize("bad", [False, True], ids=["pass", "fail"])
def test_check_gradients_solve_matches_jax(monkeypatch, bad):
    kw = lambda pkg: dict(check_gradients=True,  # noqa: E731
                          linear_solver_type=pkg.LinearSolverType.DENSE_QR)
    sj = ceres_tpu.solve(ceres_tpu.SolverOptions(**kw(ceres_tpu)), _check_problems(ceres_tpu, bad))
    tp = _check_problems(ct, bad)
    if bad:
        import ceres_tpu_torch.solvers.solver as solver_mod

        def no_evaluator(*args, **kwargs):
            raise AssertionError("the solve evaluated the problem after a failed check")

        monkeypatch.setattr(solver_mod, "Evaluator", no_evaluator)
    st = ct.solve(ct.SolverOptions(device="cpu", **kw(ct)), tp)
    assert st.termination_type.value == sj.termination_type.value
    if bad:
        assert "Gradient check failed for cost function 'bad'" in st.message
        assert st.message.split("\n")[0] == sj.message.split("\n")[0]
    else:
        assert st.final_cost == pytest.approx(sj.final_cost, abs=1e-20)


def test_check_gradients_errors_match_jax():
    """check_gradients itself on the wrong rule: max_relative_error within
    1e-6 of JAX's, both Jacobians within 1e-9."""
    from ceres_tpu.gradient_checker import check_gradients as j_check

    jp, tp = _check_problems(ceres_tpu, True), _check_problems(ct, True)
    jprog, tprog = jp.compile(), tp.compile("cpu")
    x = [np.array([2.0])]
    want = j_check(jprog.groups[0].cost_function, x)
    got = ct.check_gradients(tprog.groups[0].cost_function, x)
    assert not got.ok and not want.ok
    assert got.max_relative_error == pytest.approx(want.max_relative_error, rel=1e-6)
    for a, b in zip(got.jacobians + got.numeric_jacobians, want.jacobians + want.numeric_jacobians):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("quaternion", [False, True], ids=["angle_axis", "quaternion"])
def test_check_gradients_on_ba_matches_jax(quaternion):
    """The Snavely functor at the first block's values, in the tangent
    space of the quaternion camera's manifold: the same verdict and errors
    (within 1e-6) as JAX's; central differences at the default step come
    within 5e-5 of its autodiff, so the solve checks at 1e-4."""
    from ceres_tpu.gradient_checker import check_gradients as j_check

    (jp, _, _), (tp, _, _) = _problems(quaternion)
    tprog = tp.compile("cpu")
    jprog = jp.compile()
    for jm, ji, tm, ti in zip(jprog.groups, jprog.group_idx, tprog.groups, tprog.group_idx):
        params = [tprog.state0[tprog.x_offsets[ids[0]]: tprog.x_offsets[ids[0]] + pm.size]
                  for pm, ids in zip(tm.positions, ti["block_ids"])]
        data = tuple(d[0] for d in ti["data"])
        want = j_check(jm.cost_function, params, data, [pm.manifold for pm in jm.positions],
                       relative_precision=1e-4)
        got = ct.check_gradients(tm.cost_function, params, data,
                                 [pm.manifold for pm in tm.positions], relative_precision=1e-4)
        assert got.ok
        assert got.ok == want.ok
        assert got.max_relative_error == pytest.approx(want.max_relative_error, rel=1e-6, abs=1e-12)
        for a, b in zip(got.jacobians + got.numeric_jacobians,
                        want.jacobians + want.numeric_jacobians):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)
    s = ct.solve(_lm(ct, device="cpu", check_gradients=True, use_inner_iterations=False,
                     gradient_check_relative_precision=1e-4, max_num_iterations=2), tp)
    assert s.termination_type != ct.TerminationType.FAILURE


def test_check_gradients_catches_a_wrong_custom_rule():
    def f(params, data):
        (x,) = params
        return torch.stack([_BadSquare.apply(x[0])])

    res = ct.check_gradients(ct.CostFunction(f, 1), [np.array([2.0])])  # 3 against 4
    assert not res.ok and res.max_relative_error > 0.1
    assert "parameter block 0" in res.error_log
