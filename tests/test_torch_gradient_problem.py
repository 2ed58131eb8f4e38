"""The port's first-order API (gradient_problem.py) against ceres_tpu's, in
float64 on the CPU.

- Rosenbrock's function from (-1.2, 1) for the four directions with the
  settings of tests/test_first_order.py:42-70: LBFGS and BFGS end within
  1e-10 of JAX's x, iteration by iteration within 1e-10. NCG and steepest
  descent run 168 and 2000 iterations there, over which the WOLFE search's
  CUBIC fit amplifies a last-bit difference of f (XLA and torch round
  100 (y - x²)² + (1 - x)² differently) until the paths part: they meet
  the JAX test's own bounds on x, and over their first 12 iterations they
  agree with JAX to 1e-10, or else to 10x the distance of ceres_tpu from
  its own run from a start one ulp away;
- a unit quaternion on QuaternionManifold (the gradient PlusJacobianᵀ g,
  the step Plus) and numeric_diff_first_order (CENTRAL, FORWARD), each
  against the JAX package, with the same rule (per-iteration costs
  relative to the cost, or to 1e-6 of the initial cost near 0);
- with no device named and no card visible the solve raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.manifolds import QuaternionManifold as JQuaternion

torch.set_num_threads(1)
TOL = 1e-10


def rosenbrock(x):
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


def _options(pkg, device=None, **kw):
    t = pkg.types
    kw = dict(kw)
    kw["line_search_direction_type"] = getattr(t.LineSearchDirectionType, kw["line_search_direction_type"])
    if device is not None:
        kw["device"] = device
    return pkg.SolverOptions(minimizer_type=t.MinimizerType.LINE_SEARCH, **kw)


def _gap(a, b):
    """Largest per-iteration cost difference, relative to the cost, and
    to 1e-6 of the initial cost where the cost nears 0 (a relative
    difference of numbers near 0 says nothing)."""
    assert len(a.iterations) == len(b.iterations)
    floor = 1e-6 * abs(a.iterations[0].cost)
    return max(abs(x.cost - y.cost) / max(abs(x.cost), floor) for x, y in zip(a.iterations, b.iterations))


def _close(want, got, want_nudged):
    """Per-iteration costs within 1e-10, or else within 10x the distance of
    ceres_tpu's run `want` from its run `want_nudged` from a start one ulp
    away: how far the reference itself carries a last-bit difference."""
    gap = _gap(want[1], got[1])
    if gap > TOL:
        self_gap = _gap(want[1], want_nudged()[1])
        assert gap <= 10.0 * self_gap, f"port vs JAX {gap:.3e}, JAX vs itself {self_gap:.3e}"


X0 = np.array([-1.2, 1.0])
X0_NUDGED = np.array([np.nextafter(-1.2, -2.0), 1.0])


TOLS = dict(function_tolerance=1e-14, gradient_tolerance=1e-10, parameter_tolerance=1e-14)


@pytest.mark.parametrize("direction", ["LBFGS", "BFGS"])
def test_rosenbrock_quasi_newton_matches_jax(direction):
    kw = dict(line_search_direction_type=direction, max_num_iterations=300, **TOLS)
    xj, sj = ceres_tpu.solve_gradient_problem(
        _options(ceres_tpu, **kw), ceres_tpu.GradientProblem(rosenbrock, size=2), np.array([-1.2, 1.0]))
    xt, st = ct.solve_gradient_problem(
        _options(ct, "cpu", **kw), ct.GradientProblem(rosenbrock, size=2), np.array([-1.2, 1.0]))
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=0, atol=1e-10)
    assert _gap(sj, st) <= TOL
    assert st.termination_type.value == sj.termination_type.value
    np.testing.assert_allclose(xt, [1.0, 1.0], atol=1e-4)


@pytest.mark.parametrize("direction, maxit", [
    ("NONLINEAR_CONJUGATE_GRADIENT", 300), ("STEEPEST_DESCENT", 2000)])
def test_rosenbrock_gradient_directions_match_jax(direction, maxit):
    def run(pkg, iters, device=None, x0=X0):
        kw = dict(line_search_direction_type=direction, max_num_iterations=iters, **TOLS)
        return pkg.solve_gradient_problem(
            _options(pkg, device, **kw), pkg.GradientProblem(rosenbrock, size=2), x0)

    _close(run(ceres_tpu, 12), run(ct, 12, "cpu"), lambda: run(ceres_tpu, 12, x0=X0_NUDGED))
    # the full run meets tests/test_first_order.py's bounds
    x, s = run(ct, maxit, "cpu")
    if direction == "STEEPEST_DESCENT":
        np.testing.assert_allclose(x, [1.0, 1.0], atol=0.1)
        assert s.final_cost < 5e-3
        assert s.num_residual_evaluations + s.num_jacobian_evaluations <= 1.5 * maxit
    else:
        np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-4)


def _quat_objective(lib):
    target = lib.asarray(np.array([0.3, -0.5, 0.7, 0.2]))

    def f(q):
        return 0.5 * lib.sum((q - target) ** 2) + 0.1 * q[1] * q[2]
    return f


@pytest.mark.parametrize("direction", ["LBFGS", "STEEPEST_DESCENT"])
def test_quaternion_manifold_matches_jax(direction):
    q0 = np.array([0.6, 0.0, 0.8, 0.0])
    # stop at a gradient of 1e-8: below it the runs sit at the cost's
    # rounding floor, where one may still find a step and the other not
    kw = dict(line_search_direction_type=direction, max_num_iterations=15,
              **dict(TOLS, gradient_tolerance=1e-8))

    def run_jax(x0=q0):
        return ceres_tpu.solve_gradient_problem(
            _options(ceres_tpu, **kw), ceres_tpu.GradientProblem(_quat_objective(jnp), JQuaternion()),
            x0)

    want = run_jax()
    xt, st = ct.solve_gradient_problem(
        _options(ct, "cpu", **kw), ct.GradientProblem(_quat_objective(torch), ct.QuaternionManifold()),
        q0)
    _close(want, (xt, st), lambda: run_jax(np.array([np.nextafter(0.6, 1.0), 0.0, 0.8, 0.0])))
    np.testing.assert_allclose(xt, np.asarray(want[0]), rtol=0, atol=1e-10)
    assert st.termination_type.value == want[1].termination_type.value
    assert np.linalg.norm(xt) == pytest.approx(1.0, abs=1e-12)
    assert st.final_cost < st.initial_cost
    assert st.num_effective_parameters == 3


@pytest.mark.parametrize("method", ["CENTRAL", "FORWARD"])
def test_numeric_diff_first_order_matches_jax(method):
    kw = dict(line_search_direction_type="LBFGS", max_num_iterations=25, **TOLS)

    def run(pkg, device=None, x0=X0):
        wrapped = (ceres_tpu.gradient_problem if pkg is ceres_tpu else ct).numeric_diff_first_order(
            rosenbrock, method)
        return pkg.solve_gradient_problem(
            _options(pkg, device, **kw), pkg.GradientProblem(wrapped, size=2), x0)

    want, got = run(ceres_tpu), run(ct, "cpu")
    _close(want, got, lambda: run(ceres_tpu, x0=X0_NUDGED))
    assert got[1].final_cost < 1e-3 * got[1].initial_cost


def test_numeric_gradient_matches_jax_at_a_point():
    from torch.func import grad

    x = np.array([-1.2, 1.0])
    for method in ("CENTRAL", "FORWARD"):
        import jax

        want = jax.grad(ceres_tpu.gradient_problem.numeric_diff_first_order(rosenbrock, method))(
            jnp.asarray(x))
        got = grad(ct.numeric_diff_first_order(rosenbrock, method))(torch.tensor(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-9)


def test_gradient_problem_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    options = ct.SolverOptions(minimizer_type=ct.MinimizerType.LINE_SEARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ct.solve_gradient_problem(options, ct.GradientProblem(rosenbrock, size=2), [-1.2, 1.0])


def test_gradient_problem_needs_a_size():
    with pytest.raises(ValueError):
        ct.GradientProblem(rosenbrock)
