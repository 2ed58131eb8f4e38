"""TinySolver (ceres_tpu_torch/tiny_solver.py) against ceres_tpu's on the CPU.

The same starts, drawn with numpy, go through ceres_tpu.tiny_solve /
tiny_solve_batched and the port's. Every lane must take the same number of
iterations and end with the same `converged` (the LM decisions are the
same), with x within 1e-10 relative (two autodiffs and two dense solves
of the same small systems, whose last bits differ) and the cost within
1e-10 of the larger of 1 and the cost. Batched lanes freeze when done, so
each equals its own single solve. A singular start (the damped normal
matrix exactly singular: the step rejected, as jnp.linalg.solve's inf/NaN
step is) and the cost-function adapter are covered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.tiny_solver import cost_function_adapter as j_adapter
from ceres_tpu_torch.tiny_solver import cost_function_adapter as t_adapter
from ceres_tpu_torch.utils.execution_summary import counts

torch.set_num_threads(1)


def _stack(xp):
    return jnp.stack if xp is jnp else torch.stack


def rosenbrock(xp):
    return lambda x: _stack(xp)([10.0 * (x[1] - x[0] * x[0]), 1.0 - x[0]])


def freudenstein_roth(xp):
    return lambda x: _stack(xp)([
        -13.0 + x[0] + ((5.0 - x[1]) * x[1] - 2.0) * x[1],
        -29.0 + x[0] + ((x[1] + 1.0) * x[1] - 14.0) * x[1],
    ])


def powell_singular(xp):
    sqrt = np.sqrt
    return lambda x: _stack(xp)([
        x[0] + 10.0 * x[1], sqrt(5.0) * (x[2] - x[3]), (x[1] - 2.0 * x[2]) ** 2,
        sqrt(10.0) * (x[0] - x[3]) ** 2,
    ])


def beale(xp):
    return lambda x: _stack(xp)([
        1.5 - x[0] * (1.0 - x[1]), 2.25 - x[0] * (1.0 - x[1] ** 2),
        2.625 - x[0] * (1.0 - x[1] ** 3),
    ])


def curve(xp):
    """tests/test_first_order.py:89's problem."""
    return lambda x: _stack(xp)([x[0] + 2 * x[1], x[1] - x[0] ** 2, x[0] - 1.0])


PROBLEMS = {
    "rosenbrock": (rosenbrock, 2, 5.0), "freudenstein_roth": (freudenstein_roth, 2, 20.0),
    "powell_singular": (powell_singular, 4, 3.0), "beale": (beale, 2, 4.0),
    "curve": (curve, 2, 5.0),
}
# "tight" stops short of the last bits: at 1e-14 (the curve test's
# setting) a stopping test compares cost changes at the level of rounding,
# where the two packages' last bits decide a lane's final iteration. Its
# cap stays at the default 50: a Beale lane that runs down the valley
# toward x0 -> -inf (no minimum there) drifts by rounding, ~1.3e-10
# relative after 100 iterations

OPTIONS = {
    "default": {},
    "tight": dict(max_num_iterations=50, function_tolerance=1e-11, parameter_tolerance=1e-11,
                  gradient_tolerance=1e-11),
    "short": dict(max_num_iterations=3, initial_trust_region_radius=1.0),
}


def _assert_same(j, t):
    np.testing.assert_array_equal(t.iterations.numpy(), np.asarray(j.iterations))
    np.testing.assert_array_equal(t.converged.numpy(), np.asarray(j.converged))
    jx = np.asarray(j.x)
    np.testing.assert_allclose(t.x.numpy(), jx, rtol=0, atol=1e-10 * max(np.abs(jx).max(), 1.0))
    jc = np.asarray(j.cost)
    np.testing.assert_allclose(t.cost.numpy(), jc, rtol=0, atol=1e-10 * max(np.abs(jc).max(), 1.0))


@pytest.mark.parametrize("opts", OPTIONS)
@pytest.mark.parametrize("name", PROBLEMS)
def test_batched_lanes_match_jax(name, opts):
    make, p, box = PROBLEMS[name]
    x0 = np.random.default_rng(len(name)).uniform(-box, box, (24, p))
    jo, to = ceres_tpu.TinySolverOptions(**OPTIONS[opts]), ct.TinySolverOptions(**OPTIONS[opts])
    j = ceres_tpu.tiny_solve_batched(make(jnp), jnp.asarray(x0), jo)
    before = counts()
    t = ct.tiny_solve_batched(make(torch), torch.tensor(x0), to)
    # one read per iteration of the slowest lane, and one to see it done
    its = t.iterations.numpy()
    assert (counts() - before)["Device::Read"] == its.max() + (its.max() < to.max_num_iterations)
    assert t.x.shape == (24, p) and t.iterations.dtype == torch.int32
    _assert_same(j, t)
    if opts == "default":
        assert len(set(its.tolist())) > 1  # lanes stop at different iterations
    for e in (0, 7):
        s = ct.tiny_solve(make(torch), torch.tensor(x0[e]), to)
        assert int(s.iterations) == its[e] and bool(s.converged) == bool(t.converged[e])
        torch.testing.assert_close(s.x, t.x[e], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", PROBLEMS)
def test_single_solve_matches_jax(name):
    make, p, box = PROBLEMS[name]
    x0 = np.random.default_rng(3).uniform(-box, box, p)
    j = ceres_tpu.tiny_solve(make(jnp), jnp.asarray(x0))
    t = ct.tiny_solve(make(torch), x0, device="cpu")
    assert t.x.shape == (p,) and t.iterations.shape == ()
    _assert_same(j, t)


def test_curve_matches_scipy():
    """tests/test_first_order.py:89 on the port."""
    from scipy.optimize import least_squares

    t = ct.tiny_solve(curve(torch), torch.tensor([3.0, -2.0], dtype=torch.float64),
                      ct.TinySolverOptions(max_num_iterations=100, function_tolerance=1e-14,
                                           parameter_tolerance=1e-14, gradient_tolerance=1e-12))
    assert bool(t.converged)
    ref = least_squares(lambda x: np.array([x[0] + 2 * x[1], x[1] - x[0] ** 2, x[0] - 1.0]),
                        [3.0, -2.0], method="lm", xtol=1e-14, ftol=1e-14)
    np.testing.assert_allclose(t.x.numpy(), ref.x, atol=1e-6)


def unobserved(xp):
    """x[1] enters no residual: JᵀJ is singular."""
    return lambda x: _stack(xp)([x[0] - 1.0])


def test_singular_start_rejects_steps_as_jax():
    """With an infinite trust region the damping vanishes and the normal
    matrix of `unobserved` is exactly singular at every iteration: JAX's
    solve gives a non-finite step, torch.linalg.solve would raise; both
    reject every step and stop at the cap with x unchanged."""
    opts = dict(initial_trust_region_radius=float("inf"), max_num_iterations=7)
    x0 = np.array([[3.0, 2.0], [-1.0, 0.5]])
    j = ceres_tpu.tiny_solve_batched(unobserved(jnp), jnp.asarray(x0),
                                     ceres_tpu.TinySolverOptions(**opts))
    t = ct.tiny_solve_batched(unobserved(torch), torch.tensor(x0), ct.TinySolverOptions(**opts))
    _assert_same(j, t)
    assert t.iterations.tolist() == [7, 7] and not t.converged.any()
    np.testing.assert_array_equal(t.x.numpy(), x0)
    s = ct.tiny_solve(unobserved(torch), torch.tensor(x0[0]), ct.TinySolverOptions(**opts))
    assert int(s.iterations) == 7 and torch.equal(s.x, t.x[0])


def test_singular_lane_beside_regular_lanes():
    """A lane whose Jacobian is singular at its start (Powell's function at
    its minimum, where J has rank 2) beside ordinary lanes."""
    x0 = np.array([[0.0, 0.0, 0.0, 0.0], [3.0, -1.0, 0.0, 1.0], [1.0, 2.0, -1.0, 0.5]])
    j = ceres_tpu.tiny_solve_batched(powell_singular(jnp), jnp.asarray(x0))
    t = ct.tiny_solve_batched(powell_singular(torch), torch.tensor(x0))
    _assert_same(j, t)


def test_cost_function_adapter_matches_jax():
    target = np.array([1.0, -2.0, 3.0])
    jcost = ceres_tpu.CostFunction(lambda ps, d: ps[0] - d[0], 3)
    tcost = ct.CostFunction(lambda ps, d: ps[0] - d[0], 3)
    j = ceres_tpu.tiny_solve(j_adapter(jcost, (jnp.asarray(target),)), jnp.zeros(3))
    t = ct.tiny_solve(t_adapter(tcost, (torch.tensor(target),)),
                      torch.zeros(3, dtype=torch.float64))
    _assert_same(j, t)
    np.testing.assert_allclose(t.x.numpy(), target, atol=1e-8)
    assert bool(t.converged)


def test_default_device_is_the_card():
    """A start that is not a tensor runs on the card unless the caller names
    the CPU (utils.dtypes.resolve_device)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ct.tiny_solve(curve(torch), [3.0, -2.0])
    assert ct.tiny_solve(curve(torch), [3.0, -2.0], device="cpu").x.device.type == "cpu"
