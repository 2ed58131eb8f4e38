"""The port's cost-function adapters (cost_functions.py), AnalyticCostFunction
and the evaluation callback, in float64 on the CPU: the cases of
tests/test_cost_functions.py on the port, each against ceres_tpu where
both packages compute a value (the residuals, the solve's final state), and
the callback's (new_point, evaluate_jacobians) sequence on a small LM solve
equal to ceres_tpu's. A Problem with a callback takes the host loop
(fused_loop.eligible), as in the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu import cost_functions as jcf
from ceres_tpu.autodiff import batched_value_and_jacobians as j_bvj
from ceres_tpu_torch import cost_functions as tcf
from ceres_tpu_torch.autodiff import batched_value_and_jacobians as t_bvj

torch.set_num_threads(1)
A = np.array([[2.0, 0.0], [0.0, 3.0], [1.0, 1.0]])
B = np.array([1.0, -1.0])


def test_normal_prior():
    cf = tcf.normal_prior(A, B)
    x = np.array([2.0, 1.0])
    r = cf.fn((torch.tensor(x),), ()).numpy()
    np.testing.assert_allclose(r, A @ (x - B))
    np.testing.assert_allclose(r, np.asarray(jcf.normal_prior(A, B).fn((jnp.asarray(x),), ())),
                               rtol=1e-15)
    p = ct.Problem()
    h = p.add_parameter_block([5.0, 5.0])
    p.add_residual_block(cf, None, [h])
    ct.solve(ct.SolverOptions(max_num_iterations=50, device="cpu"), p)
    np.testing.assert_allclose(p.parameter_block_value(h), B, atol=1e-8)
    with pytest.raises(ValueError, match=r"A must be \[k, n\] and b \[n\]"):
        tcf.normal_prior(A, np.ones(3))


def _base2(pkg):
    stack = jnp.stack if pkg is ceres_tpu else torch.stack

    def base(params, data):
        (x,) = params
        return stack([x[0], x[1]])

    return base


@pytest.mark.parametrize("case", ["conditioned", "to_functor", "scaled"])
def test_adapters_match_jax(case):
    x = np.array([3.0, 4.0])
    out = []
    for pkg, mod, arr, sin in ((ceres_tpu, jcf, jnp.asarray, jnp.sin),
                               (ct, tcf, torch.tensor, torch.sin)):
        base = pkg.CostFunction(_base2(pkg), 2)
        if case == "conditioned":
            cf = mod.conditioned_cost_function(base, [lambda r: 2.0 * r + 1.0, sin])
            want = [7.0, np.sin(4.0)]
        elif case == "scaled":
            cf = mod.scaled_cost_function(base, 3.0)
            want = [9.0, 12.0]
        else:
            inner = mod.cost_function_to_functor(base)
            cf = pkg.CostFunction(lambda p, d, inner=inner: inner((p[0],)) + 1.0, 2)
            want = [4.0, 5.0]
        r = np.asarray(cf.fn((arr(x),), ()))
        np.testing.assert_allclose(r, want, rtol=1e-15)
        out.append(r)
    np.testing.assert_array_equal(out[0], out[1])
    if case == "conditioned":
        with pytest.raises(ValueError, match="one conditioner per residual"):
            tcf.conditioned_cost_function(ct.CostFunction(_base2(ct), 2), [None])


def _analytic(pkg):
    np_ = jnp if pkg is ceres_tpu else torch

    def fn(params, data):
        (x,) = params
        return np_.stack([3.0 * x[0] + x[1] ** 2 - data[0][0], np_.sin(x[0]) * x[1]])

    def jac(params, data):
        (x,) = params
        three = 3.0 + 0.0 * x[0]
        return (np_.stack([np_.stack([three, 2.0 * x[1]]),
                           np_.stack([np_.cos(x[0]) * x[1], np_.sin(x[0])])]),)

    return fn, jac


def test_analytic_cost_function_jacobian_and_solve():
    """AnalyticCostFunction routes the user's Jacobian through torch.func
    (helloworld_analytic_diff.cc): the values and Jacobians equal autodiff's
    and ceres_tpu's, and a solve reaches zero cost at ceres_tpu's point."""
    x = np.array([[0.7, -1.3]])
    d = np.array([[2.0]])
    fn, jac = _analytic(ct)
    cf = ct.AnalyticCostFunction(fn, jac, 2)
    vals, jacs = t_bvj(cf.fn, (torch.tensor(x),), (torch.tensor(d),))
    vals_ad, jacs_ad = t_bvj(fn, (torch.tensor(x),), (torch.tensor(d),))
    np.testing.assert_allclose(vals.numpy(), vals_ad.numpy(), atol=1e-12)
    np.testing.assert_allclose(jacs[0].numpy(), jacs_ad[0].numpy(), atol=1e-12)
    jfn, jjac = _analytic(ceres_tpu)
    jv, jj = j_bvj(ceres_tpu.AnalyticCostFunction(jfn, jjac, 2).fn, (jnp.asarray(x),),
                   (jnp.asarray(d),))
    np.testing.assert_allclose(jacs[0].numpy(), np.asarray(jj[0]), rtol=1e-14, atol=1e-14)
    finals = []
    for pkg, (f, j) in ((ct, (fn, jac)), (ceres_tpu, (jfn, jjac))):
        p = pkg.Problem()
        h = p.add_parameter_block([0.5, 0.5])
        p.add_residual_block(pkg.AnalyticCostFunction(f, j, 2), None, [h], data=(np.array([2.0]),))
        kw = {"device": "cpu"} if pkg is ct else {}
        s = pkg.solve(pkg.SolverOptions(max_num_iterations=60, **kw), p)
        assert s.final_cost < 1e-14
        finals.append(np.asarray(p.parameter_block_value(h)))
    np.testing.assert_allclose(finals[0], finals[1], rtol=1e-9, atol=1e-12)


def test_analytic_cost_function_wrong_jac_count():
    def fn(params, data):
        (x,) = params
        return x * 2.0

    def bad_jac(params, data):
        return (torch.eye(2, dtype=torch.float64), torch.eye(2, dtype=torch.float64))

    cf = ct.AnalyticCostFunction(fn, bad_jac, 2)
    with pytest.raises(ValueError, match="Jacobians"):
        t_bvj(cf.fn, (torch.ones((1, 2), dtype=torch.float64),), ())


@pytest.mark.parametrize("kind", [None, "analytic", "numeric"])
def test_adapters_keep_the_rule_tag(kind):
    """CostFunction.rule names the rule the functor carries; the
    conditioned and scaled adapters keep their wrapped function's, as the
    rule itself stays inside their functor."""

    def fn(params, data):
        (x,) = params
        return x * 2.0

    cf = {None: lambda: ct.CostFunction(fn, 2),
          "analytic": lambda: ct.AnalyticCostFunction(
              fn, lambda p, d: (2.0 * torch.eye(2, dtype=p[0].dtype),), 2),
          "numeric": lambda: ct.NumericDiffCostFunction(fn, 2)}[kind]()
    assert cf.rule == kind
    assert tcf.scaled_cost_function(cf, 0.5).rule == kind
    assert tcf.conditioned_cost_function(cf, [None, torch.tanh]).rule == kind
    assert tcf.normal_prior(A, B).rule is None


def _callback_problem(pkg, calls):
    np_ = jnp if pkg is ceres_tpu else torch

    def f(params, data):
        (x,) = params
        return np_.stack([x[0] - 1.0, 10.0 * (x[1] - x[0] ** 2)])

    p = pkg.Problem(evaluation_callback=lambda new_point, jac: calls.append((new_point, jac)))
    h = p.add_parameter_block([-1.2, 1.0])
    p.add_residual_block(pkg.CostFunction(f, 2), None, [h])
    return p


@pytest.mark.parametrize("linear_solver", ["DENSE_QR", "ITERATIVE_SCHUR"])
def test_evaluation_callback_sequence_matches_jax(linear_solver):
    """The callback fires before every evaluation, (True, False) for a
    cost and (True, True) for a Jacobian, in ceres_tpu's order; the solve
    takes the host loop, where the same options without a callback take
    the fused loop."""
    seqs, sums = [], []
    for pkg in (ceres_tpu, ct):
        calls = []
        kw = {"device": "cpu"} if pkg is ct else {}
        sums.append(pkg.solve(pkg.SolverOptions(
            linear_solver_type=getattr(pkg.LinearSolverType, linear_solver),
            max_num_iterations=12, **kw), _callback_problem(pkg, calls)))
        seqs.append(calls)
    assert any(j for _, j in seqs[1]) and any(not j for _, j in seqs[1])
    assert all(new for new, _ in seqs[1])
    assert seqs[0] == seqs[1]
    assert [it.cost for it in sums[0].iterations] == pytest.approx(
        [it.cost for it in sums[1].iterations], rel=1e-10, abs=1e-20)
    assert sums[1].used_fused_execution is False
    p = _callback_problem(ct, [])
    p.evaluation_callback = None
    s = ct.solve(ct.SolverOptions(linear_solver_type=getattr(ct.LinearSolverType, linear_solver),
                                  max_num_iterations=12, device="cpu"), p)
    assert s.used_fused_execution is True
