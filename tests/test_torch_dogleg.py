"""The port's dogleg strategy (solvers/dogleg.py) against ceres_tpu's.

- `_eigh2` and `_boundary_minimizer_2d` against the JAX ones on seeded 2x2
  SPD systems (1e-12), and `_solve2` against numpy;
- TRADITIONAL and SUBSPACE solves on Rosenbrock (DENSE_QR and
  DENSE_NORMAL_CHOLESKY: the dense GN) and
  on a small bundle adjustment problem (ITERATIVE_SCHUR options, so the GN
  is CGNR + JACOBI with the residual tolerance eta), on the fused loop and
  on the host loop, against ceres_tpu.solve: per-iteration cost, radius,
  PCG count and decisions to 1e-10. The BA solves start at radius 1, so
  the steps reach the dogleg and subspace branches (at the default 1e4
  every step is the Gauss-Newton point); Rosenbrock runs 14 iterations,
  while its cost is still far from 0 (relative cost differences of
  numbers near 0 say nothing);
- the prepare runs once per Jacobian across rejected steps
  (tests/test_dogleg.py:130-160), on both loops;
- fused and host loops agree to 1e-12, the fused loop within 2 + PCG steps
  reads per iteration;
- every non-dense linear solver (and preconditioner, SUBSET included)
  gives the same GN (CGNR + JACOBI), so DOGLEG runs bitwise the same on
  each; the step-kind log names the branches taken."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.solvers import dogleg as jdl
from ceres_tpu_torch.solvers import dogleg as tdl

torch.set_num_threads(1)
F64 = torch.float64


def _spd_systems(seed, count=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = rng.normal(size=(2, 2))
        b = a.T @ a + np.diag(rng.uniform(1e-6, 1.0, 2))
        g = rng.normal(size=2) * 10.0 ** rng.integers(-2, 3)
        radius = float(10.0 ** rng.uniform(-2, 2))
        y_unc = np.linalg.solve(b, -g)
        if np.linalg.norm(y_unc) <= radius:
            radius = 0.5 * np.linalg.norm(y_unc)
        out.append((b, g, radius))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_eigh2_matches_jax(seed):
    for b, _, _ in _spd_systems(seed):
        jl, jq = jdl._eigh2(jnp.asarray(b))
        tl, tq = tdl._eigh2(torch.tensor(b))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-12, atol=1e-12)
    # the degenerate branch (c = 0)
    for d in ([2.0, 1.0], [1.0, 2.0]):
        _, tq = tdl._eigh2(torch.tensor(np.diag(d)))
        _, jq = jdl._eigh2(jnp.asarray(np.diag(d)))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("seed", range(8))
def test_boundary_minimizer_matches_jax(seed):
    for b, g, radius in _spd_systems(seed):
        want = np.asarray(jdl._boundary_minimizer_2d(jnp.asarray(b), jnp.asarray(g), radius))
        got = tdl._boundary_minimizer_2d(torch.tensor(b), torch.tensor(g),
                                         torch.tensor(radius, dtype=F64))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * radius)
        np.testing.assert_allclose(np.linalg.norm(got.numpy()), radius, rtol=1e-12)


def test_solve2_matches_numpy():
    rng = np.random.default_rng(5)
    for _ in range(20):
        h, rhs = rng.normal(size=(2, 2)), rng.normal(size=2)
        np.testing.assert_allclose(tdl._solve2(torch.tensor(h), torch.tensor(rhs)).numpy(),
                                   np.linalg.solve(h, rhs), rtol=1e-10, atol=1e-12)


def _rosenbrock(pkg):
    if pkg is ceres_tpu:
        def res(params, data):
            (xy,) = params
            return jnp.stack([10.0 * (xy[1] - xy[0] ** 2), 1.0 - xy[0]])
    else:
        def res(params, data):
            (xy,) = params
            return torch.cat([10.0 * (xy[1:2] - xy[0:1] ** 2), 1.0 - xy[0:1]])
    p = pkg.Problem()
    b = p.add_parameter_block(np.array([-1.2, 1.0]))
    p.add_residual_block(pkg.CostFunction(res, 2, name="rosen"), None, [b])
    return p


def _ba(pkg, seed=3):
    bal = synthetic_bal(8, 60, 300, seed=seed, perturb_points=0.05)
    if pkg is ceres_tpu:
        return j_build(bal, loss=ceres_tpu.HuberLoss(1.0))[0]
    return ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]


PROBLEMS = {
    # name: (builder, options)
    "rosenbrock": (_rosenbrock, dict(linear_solver_type="DENSE_QR", max_num_iterations=14)),
    "rosenbrock_normal": (_rosenbrock, dict(linear_solver_type="DENSE_NORMAL_CHOLESKY",
                                            max_num_iterations=14)),
    "ba": (_ba, dict(linear_solver_type="ITERATIVE_SCHUR", preconditioner_type="SCHUR_JACOBI",
                     initial_trust_region_radius=1.0, max_num_iterations=8, eta=0.1,
                     max_linear_solver_iterations=25)),
}


def _options(pkg, kind, **kw):
    enums = {"linear_solver_type": pkg.LinearSolverType,
             "preconditioner_type": pkg.PreconditionerType}
    kw = {k: getattr(enums[k], v) if k in enums else v for k, v in kw.items()}
    base = dict(function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
                logging_type=pkg.LoggingType.SILENT)
    return pkg.SolverOptions(
        trust_region_strategy_type=pkg.TrustRegionStrategyType.DOGLEG,
        dogleg_type=getattr(pkg.DoglegType, kind), **{**base, **kw})


def _assert_same_iterations(ts, js, rel):
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        assert a.cost == pytest.approx(b.cost, rel=rel, abs=1e-300)
        assert a.trust_region_radius == pytest.approx(b.trust_region_radius, rel=rel)
        assert (a.linear_solver_iterations, a.step_is_valid, a.step_is_successful) == (
            b.linear_solver_iterations, b.step_is_valid, b.step_is_successful)


_JAX = {}


def _jax_solve(name, kind):
    if (name, kind) not in _JAX:
        build, opts = PROBLEMS[name]
        _JAX[name, kind] = ceres_tpu.solve(_options(ceres_tpu, kind, **opts), build(ceres_tpu))
    return _JAX[name, kind]


def _port_solve(name, kind, **extra):
    build, opts = PROBLEMS[name]
    return ct.solve(_options(ct, kind, device="cpu", **opts, **extra), build(ct))


@pytest.mark.parametrize("loop", ["fused", "host"])
@pytest.mark.parametrize("kind", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_dogleg_solve_matches_jax(name, kind, loop):
    js = _jax_solve(name, kind)
    ts = _port_solve(name, kind, fused_execution=loop == "fused")
    assert ts.used_fused_execution == (loop == "fused")
    _assert_same_iterations(ts, js, 1e-10)
    assert ts.final_cost < ts.initial_cost


@pytest.mark.parametrize("kind", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
def test_fused_loop_matches_host_loop(kind):
    runs = [_port_solve("ba", kind, fused_execution=f) for f in (True, False)]
    _assert_same_iterations(runs[0], runs[1], 1e-12)
    # the fused loop's read budget: its prepare's PCG runs in the iteration
    # that takes the cache
    for it in runs[0].iterations[1:]:
        assert it.num_device_reads <= 2 + it.linear_solver_iterations


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_gauss_newton_reused_across_rejections(monkeypatch, fused):
    """One prepare per Jacobian at most, and fewer prepares than step
    attempts (tests/test_dogleg.py:130-160, with its forcing radius)."""
    calls = {"n": 0}
    make = tdl.make_dogleg_step_fn

    def counting(*args):
        step_fn = make(*args)
        inner = step_fn.prepare

        def prepare(*a):
            calls["n"] += 1
            return inner(*a)

        step_fn.prepare = prepare
        return step_fn

    monkeypatch.setattr(tdl, "make_dogleg_step_fn", counting)
    s = ct.solve(_options(ct, "SUBSPACE_DOGLEG", linear_solver_type="DENSE_QR",
                          max_num_iterations=100, initial_trust_region_radius=1e8,
                          function_tolerance=1e-12, gradient_tolerance=1e-12,
                          parameter_tolerance=1e-12, fused_execution=fused, device="cpu"),
                 _rosenbrock(ct))
    attempts = s.num_successful_steps + s.num_unsuccessful_steps
    assert s.used_fused_execution == fused and s.num_unsuccessful_steps > 0
    assert 0 < calls["n"] <= s.num_jacobian_evaluations and calls["n"] < attempts


def test_every_linear_solver_takes_the_cgnr_gauss_newton():
    """The JAX dogleg takes its GN from CGNR + JACOBI for every linear solver
    but the dense two (ceres_tpu/solvers/dogleg.py:105-129): the same
    iterations, bitwise, on each, and the fused loop for all (the dogleg
    step function is device-only even where the LM one factors on the
    host)."""
    runs = {}
    for solver, precond in (("ITERATIVE_SCHUR", "SCHUR_JACOBI"), ("CGNR", "JACOBI"),
                            ("CGNR", "SUBSET"), ("DENSE_SCHUR", "SCHUR_JACOBI"),
                            ("SPARSE_SCHUR", "SCHUR_JACOBI"),
                            ("SPARSE_NORMAL_CHOLESKY", "JACOBI")):
        opts = dict(PROBLEMS["ba"][1], linear_solver_type=solver, preconditioner_type=precond,
                    max_num_iterations=4, residual_blocks_for_subset_preconditioner=[0, 1])
        runs[solver, precond] = ct.solve(
            _options(ct, "SUBSPACE_DOGLEG", device="cpu", **opts), _ba(ct))
    ref = runs.pop(("ITERATIVE_SCHUR", "SCHUR_JACOBI"))
    for s in runs.values():
        assert s.used_fused_execution
        for a, b in zip(s.iterations, ref.iterations, strict=True):
            assert (a.cost, a.linear_solver_iterations, a.trust_region_radius) == (
                b.cost, b.linear_solver_iterations, b.trust_region_radius)


@pytest.mark.parametrize("kind", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
def test_step_kinds_are_logged(kind):
    """Each finish logs the branch it took: one entry per iteration, the
    Gauss-Newton point exactly where it lies inside the radius."""
    program = _ba(ct).compile("cpu")
    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.solvers.trust_region import TrustRegionMinimizer

    opts = _options(ct, kind, device="cpu", **PROBLEMS["ba"][1])
    ev = Evaluator(program, F64)
    minimizer = TrustRegionMinimizer(program, opts, ev)
    summary = ct.Summary()
    minimizer.minimize(program.state_vector(F64), summary)
    kinds = minimizer._step_fn.step_kinds.tolist()
    n = len(summary.iterations) - 1
    assert int(minimizer._step_fn.step_count) == n and all(k >= 0 for k in kinds[:n])
    names = {tdl.STEP_KINDS[k] for k in kinds[:n]}
    assert "gauss-newton" in names
    assert names & {"dogleg" if kind == "TRADITIONAL_DOGLEG" else "subspace", "cauchy"}
