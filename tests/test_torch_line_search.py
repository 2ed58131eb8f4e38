"""The port's line-search minimizer (solvers/line_search.py, and its copy of
solvers/polynomial.py) against ceres_tpu's, in float64 on the CPU.

- polynomial.py: the cases of tests/test_polynomial.py on both sides, the
  fits' coefficients and minimizers to 1e-12;
- the solves: every direction (steepest descent, NCG Fletcher-Reeves,
  Polak-Ribiere and Hestenes-Stiefel, LBFGS with and without eigenvalue
  scaling, BFGS) x ARMIJO / WOLFE x BISECTION / QUADRATIC / CUBIC, on a
  small bundle adjustment problem (Huber loss, the layout plans engaged)
  and on the exponential curve fit. Per iteration the cost and the step
  size agree to 1e-10 relative, and the residual and gradient evaluation
  counts are equal. Where the port is further from JAX than 1e-10, the
  case holds it to 10x the distance of ceres_tpu from itself, on the same
  problem with its residual blocks permuted (two permutations, measured
  in the test): the line search amplifies the rounding of the sampled
  costs, most of all CUBIC, whose least-squares fit on a Vandermonde
  system over a short bracket moves ceres_tpu against itself by up to
  ~1e-6 on the BA problem (a reference behaviour, ROADMAP Queue C);
- a restart (Polak-Ribiere under ARMIJO on Rosenbrock's residuals: the
  direction is not a descent direction at iteration 2);
- the read budget: at most 2 + trials reads per iteration, one more on a
  restart."""

import dataclasses

import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.examples.test_functions import build_curve_fitting_problem as j_curve
from ceres_tpu.examples.test_functions import make_curve_fitting_data
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.program import Program as JProgram
from ceres_tpu.solvers import line_search as jls
from ceres_tpu.solvers import polynomial as jpoly
from ceres_tpu_torch.examples.test_functions import build_curve_fitting_problem as t_curve
from ceres_tpu_torch.program import Program as TProgram
from ceres_tpu_torch.solvers import line_search as tls
from ceres_tpu_torch.solvers import polynomial as tpoly

torch.set_num_threads(1)
TOL = 1e-10

# ---- polynomial.py ------------------------------------------------------ #

CUBIC = np.array([1.0, -6.0, 9.0, 1.0])
QUAD = np.array([2.0, -12.0, 23.0])


def _samples(mod, kind):
    def val(c, x):
        return float(np.polyval(c, x))

    d = np.polyder
    s = mod.FunctionSample
    return {
        "value_gradient_value": [s.with_gradient(0.0, val(QUAD, 0.0), -12.0),
                                 s.valued(4.0, val(QUAD, 4.0))],
        "two_hermite": [s.with_gradient(0.5, val(CUBIC, 0.5), val(d(CUBIC), 0.5)),
                        s.with_gradient(4.0, val(CUBIC, 4.0), val(d(CUBIC), 4.0))],
        "gradient_three_values": [
            s.with_gradient(0.0, 7.0, 2.0), s.valued(1.0, 7.0), s.valued(3.0, 13.0)],
    }[kind]


@pytest.mark.parametrize("kind", ["value_gradient_value", "two_hermite", "gradient_three_values"])
def test_find_interpolating_polynomial_matches_jax(kind):
    want = jpoly.find_interpolating_polynomial(_samples(jpoly, kind))
    got = tpoly.find_interpolating_polynomial(_samples(tpoly, kind))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    lo, hi = 0.5, 4.0
    assert tpoly.minimize_interpolating_polynomial(_samples(tpoly, kind), lo, hi) == pytest.approx(
        jpoly.minimize_interpolating_polynomial(_samples(jpoly, kind), lo, hi), rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("poly, lo, hi", [
    (QUAD, 0.0, 10.0), (np.array([4.0, 0.0]), 1.0, 2.0), (CUBIC, 0.5, 4.0), (CUBIC, -3.0, 0.5),
])
def test_minimize_polynomial_matches_jax(poly, lo, hi):
    got = tpoly.minimize_polynomial(poly, lo, hi)
    assert got == pytest.approx(jpoly.minimize_polynomial(poly, lo, hi), rel=1e-12, abs=1e-12)
    assert tpoly.evaluate_polynomial(poly, got[0]) == jpoly.evaluate_polynomial(poly, got[0])


@pytest.mark.parametrize("case", [
    dict(a_lo=1.0, a_hi=4.5, interpolation="CUBIC", g_hi=True),
    dict(a_lo=1.0, a_hi=4.5, interpolation="QUADRATIC"),
    dict(a_lo=0.0, a_hi=4.5, interpolation="CUBIC", extra_sample=2.0),
    dict(a_lo=1.0, a_hi=3.0, interpolation="BISECTION"),
    dict(a_lo=1.0, a_hi=3.0, interpolation="CUBIC", f_hi=float("nan")),
], ids=["cubic_hermite", "quadratic", "cubic_extra_sample", "bisection", "nonfinite_hi"])
def test_interpolate_step_matches_jax(case):
    phi, dphi = np.poly1d(CUBIC), np.poly1d(np.polyder(CUBIC))
    a_lo, a_hi = case["a_lo"], case["a_hi"]
    kw = {}
    if case.get("g_hi"):
        kw["g_hi"] = dphi(a_hi)
    if "extra_sample" in case:
        kw["extra_sample"] = (case["extra_sample"], phi(case["extra_sample"]))
    args = (a_lo, phi(a_lo), dphi(a_lo), a_hi, case.get("f_hi", phi(a_hi)), case["interpolation"])
    want = jls._interpolate_step(*args, **kw)
    assert tls._interpolate_step(*args, **kw) == pytest.approx(want, rel=1e-12, abs=1e-12)


# ---- the solves ----------------------------------------------------------- #

DIRECTIONS = {
    "steepest_descent": dict(line_search_direction_type="STEEPEST_DESCENT"),
    "ncg_fletcher_reeves": dict(line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
                                nonlinear_conjugate_gradient_type="FLETCHER_REEVES"),
    "ncg_polak_ribiere": dict(line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
                              nonlinear_conjugate_gradient_type="POLAK_RIBIERE"),
    "ncg_hestenes_stiefel": dict(line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
                                 nonlinear_conjugate_gradient_type="HESTENES_STIEFEL"),
    "lbfgs": dict(line_search_direction_type="LBFGS"),
    "lbfgs_scaled": dict(line_search_direction_type="LBFGS",
                         use_approximate_eigenvalue_bfgs_scaling=True),
    "bfgs": dict(line_search_direction_type="BFGS"),
}
ENUMS = {
    "line_search_direction_type": "LineSearchDirectionType",
    "nonlinear_conjugate_gradient_type": "NonlinearConjugateGradientType",
    "line_search_type": "LineSearchType",
    "line_search_interpolation_type": "LineSearchInterpolationType",
}


def _options(pkg, device=None, **kw):
    types = pkg.types
    kw = {k: getattr(getattr(types, ENUMS[k]), v) if k in ENUMS else v for k, v in kw.items()}
    if device is not None:
        kw["device"] = device
    return pkg.SolverOptions(minimizer_type=types.MinimizerType.LINE_SEARCH, **kw)


BAL = synthetic_bal(6, 40, 200, seed=2)


def _permuted(bal, seed=0):
    perm = np.random.default_rng(seed).permutation(len(bal.observations))
    return dataclasses.replace(bal, camera_index=bal.camera_index[perm],
                               point_index=bal.point_index[perm],
                               observations=bal.observations[perm])


PROBLEMS = {
    # (JAX build, its permuted twin by seed, port build, iterations)
    "ba": (lambda: j_build(BAL, loss=ceres_tpu.HuberLoss(1.0))[0],
           lambda seed: j_build(_permuted(BAL, seed), loss=ceres_tpu.HuberLoss(1.0))[0],
           lambda: ct.build_ba_problem(BAL, loss=ct.HuberLoss(1.0))[0], 6),
    "curve": (lambda: j_curve()[0],
              lambda seed: j_curve(data=make_curve_fitting_data()[
                  np.random.default_rng(seed).permutation(67)])[0],
              lambda: t_curve()[0], 8),
}


def _gap(a, b):
    """Largest relative per-iteration difference of cost and step size."""
    assert len(a.iterations) == len(b.iterations)
    return max(
        max(abs(x.cost - y.cost) / abs(x.cost), abs(x.step_size - y.step_size) / max(abs(x.step_size), 1e-300))
        for x, y in zip(a.iterations, b.iterations)
    )


@pytest.fixture
def planned(monkeypatch):
    # the layout plans (bucket points, onehot cameras: kernel B3's path)
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", 16)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)


@pytest.mark.parametrize("interpolation", ["BISECTION", "QUADRATIC", "CUBIC"])
@pytest.mark.parametrize("search", ["ARMIJO", "WOLFE"])
@pytest.mark.parametrize("direction", list(DIRECTIONS))
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_line_search_solve_matches_jax(planned, problem, direction, search, interpolation):
    j_make, j_perm, t_make, iters = PROBLEMS[problem]
    kw = dict(DIRECTIONS[direction], line_search_type=search,
              line_search_interpolation_type=interpolation, max_num_iterations=iters)
    want = ceres_tpu.solve(_options(ceres_tpu, **kw), j_make())
    got = ct.solve(_options(ct, "cpu", **kw), t_make())
    gap = _gap(want, got)
    if gap > TOL:
        # as close as ceres_tpu is to itself on the permuted problem
        self_gap = max(_gap(want, ceres_tpu.solve(_options(ceres_tpu, **kw), j_perm(seed)))
                       for seed in (0, 1))
        assert gap <= 10.0 * self_gap, f"port vs JAX {gap:.3e}, JAX vs itself {self_gap:.3e}"
    assert got.num_residual_evaluations == want.num_residual_evaluations
    assert got.num_jacobian_evaluations == want.num_jacobian_evaluations
    assert got.termination_type.value == want.termination_type.value
    assert got.final_cost < got.initial_cost
    for it in got.iterations[1:]:
        assert it.num_device_reads <= 3 + it.line_search_iterations


def test_restart_matches_jax():
    """Polak-Ribiere under ARMIJO on Rosenbrock's residuals: non-descent
    directions restart from steepest descent (one more read that
    iteration), the L-BFGS-free state reset, the first step policy again."""
    from ceres_tpu.examples.test_functions import rosenbrock_residuals as j_res
    from ceres_tpu_torch.examples.test_functions import rosenbrock_residuals as t_res

    def build(pkg, fn):
        p = pkg.Problem()
        b = p.add_parameter_block(np.array([-1.2, 1.0]))
        p.add_residual_block(pkg.CostFunction(fn, 2), None, [b])
        return p

    kw = dict(DIRECTIONS["ncg_polak_ribiere"], line_search_type="ARMIJO",
              line_search_interpolation_type="QUADRATIC", max_num_iterations=8)
    want = ceres_tpu.solve(_options(ceres_tpu, **kw), build(ceres_tpu, j_res))
    got = ct.solve(_options(ct, "cpu", **kw), build(ct, t_res))
    assert _gap(want, got) <= TOL
    assert got.num_residual_evaluations == want.num_residual_evaluations
    restarts = [it.iteration for it in got.iterations[1:]
                if it.num_device_reads == 3 + it.line_search_iterations]
    assert restarts, "no iteration restarted"
    assert all(it.num_device_reads in (2 + it.line_search_iterations, 3 + it.line_search_iterations)
               for it in got.iterations[1:])


def test_line_search_non_finite_start_fails():
    """The minimizer's edge exits: a non-finite initial cost fails the
    solve, as in the JAX package."""
    def bad(params, data):
        return torch.sqrt(params[0] - 10.0)

    p = ct.Problem()
    b = p.add_parameter_block(np.array([1.0]))
    p.add_residual_block(ct.CostFunction(bad, 1), None, [b])
    s = ct.solve(_options(ct, "cpu"), p)
    assert s.termination_type == ct.TerminationType.FAILURE
    assert "not finite" in s.message


def test_line_search_float32_decreases_cost():
    problem = ct.build_ba_problem(BAL, loss=ct.HuberLoss(1.0))[0]
    s = ct.solve(_options(ct, "cpu", dtype=torch.float32, max_num_iterations=5), problem)
    assert all(np.isfinite(it.cost) for it in s.iterations)
    assert s.final_cost < s.initial_cost


def test_lbfgs_two_loop_matches_dense_bfgs_on_one_pair():
    """With one (s, y) pair and eigenvalue scaling off, the two-loop
    recursion is the BFGS update of the identity applied to g."""
    rng = np.random.default_rng(3)
    s, y, g = (torch.tensor(rng.normal(size=6)) for _ in range(3))
    y = y + 2.0 * s  # s'y > 0
    mem = tls._LBFGSMemory(5, False)
    sy = torch.dot(s, y)
    mem.update(s, y, sy, float(sy))
    rho = 1.0 / sy
    v = torch.eye(6, dtype=s.dtype) - rho * torch.outer(s, y)
    h = v @ v.T + rho * torch.outer(s, s)
    np.testing.assert_allclose(mem.apply(g).numpy(), (h @ g).numpy(), rtol=1e-12, atol=1e-12)
    mem.update(s, -y, -sy, -float(sy))  # negative curvature: skipped
    assert len(mem.s_list) == 1


@pytest.mark.parametrize("kind", ["steepest_descent", "ncg_hestenes_stiefel", "bfgs"])
def test_callbacks_end_the_line_search(kind):
    problem = t_curve()[0]
    seen = []

    def cb(it):
        seen.append(it.iteration)
        return ct.types.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY if it.iteration == 2 \
            else ct.types.CallbackReturnType.SOLVER_CONTINUE

    s = ct.solve(_options(ct, "cpu", callbacks=[cb], **DIRECTIONS[kind]), problem)
    assert seen == [1, 2]
    assert s.termination_type == ct.TerminationType.USER_SUCCESS
