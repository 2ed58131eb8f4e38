"""The port's Jacobian rules (autodiff.RuleFunctor: analytic_diff,
numeric_diff, AnalyticCostFunction, NumericDiffCostFunction) against
ceres_tpu's custom_jvp wrappers, in float64 on the CPU, and B1 generic's
custom-Jacobian branch on the generator's side.

- Per-block Jacobians of a two-block functor (sin, cos, products, data)
  through torch.func (evaluator's batched jacfwd) against JAX's linearize:
  analytic within 1e-12; FORWARD and CENTRAL within 1e-8 (the measured gap
  is ~2e-10 for CENTRAL and ~3e-9 for FORWARD: fn's last-bit differences
  between XLA and torch, divided by the step); RIDDERS within 1e-6 (its
  ten extrapolations amplify those differences further; measured ~1e-7).
- A deliberately wrong analytic rule (3x the true Jacobian): the port's
  Jacobian equals JAX's XLA path's, JAX's B1 Pallas kernel's in interpret
  mode (float32, 5e-4, as tests/test_pallas_eval.py runs it) and 3x the
  autodiff Jacobian.
- The generator (functor_codegen): an analytic group's IR, run by
  `run_ir` with the kernel's dual-number rules, gives the rule's Jacobian
  (the 3x one too) at 1e-12, also when the rule sits inside a scaled or
  conditioned functor; a numeric group, and a functor that nests one, has
  no program.
- The shape errors' messages equal JAX's.
- LM on a small bundle adjustment with the Snavely functor as a
  NumericDiffCostFunction (CENTRAL) and as an AnalyticCostFunction (its
  jac the functor's jacfwd): per-iteration cost against ceres_tpu's within
  1e-10, or 10x the distance of ceres_tpu from itself (measured in the
  test: the problem with its observations permuted and, for the numeric
  functor, ceres_tpu's solve run eagerly)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu import autodiff as jad
from ceres_tpu import pallas_eval
from ceres_tpu.evaluator import evaluate as j_evaluate
from ceres_tpu.examples.snavely import snavely_reprojection_error as j_snavely
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu_torch import autodiff as tad
from ceres_tpu_torch import functor_codegen
from ceres_tpu_torch.cost_functions import conditioned_cost_function, scaled_cost_function
from ceres_tpu_torch.evaluator import Evaluator, group_eval_plain, state_tables
from ceres_tpu_torch.examples.snavely import snavely_reprojection_error as t_snavely

torch.set_num_threads(1)
F64 = torch.float64
RNG_SEED = 3
N = 6


def jfn(params, data):
    x, y = params
    (d,) = data
    return jnp.stack([jnp.sin(x[0]) * y[1] + x[1] * d[0],
                      x[0] * x[1] - jnp.cos(y[0]) * d[1],
                      y[0] * y[1] * x[1]])


def tfn(params, data):
    x, y = params
    (d,) = data
    return torch.stack([torch.sin(x[0]) * y[1] + x[1] * d[0],
                        x[0] * x[1] - torch.cos(y[0]) * d[1],
                        y[0] * y[1] * x[1]])


def _jjac(scale):
    def jac(params, data):
        x, y = params
        (d,) = data
        z = jnp.zeros_like(x[0])
        jx = jnp.stack([jnp.stack([jnp.cos(x[0]) * y[1], d[0]]), jnp.stack([x[1], x[0]]),
                        jnp.stack([z, y[0] * y[1]])])
        jy = jnp.stack([jnp.stack([z, jnp.sin(x[0])]), jnp.stack([jnp.sin(y[0]) * d[1], z]),
                        jnp.stack([y[1] * x[1], y[0] * x[1]])])
        return (scale * jx, scale * jy)
    return jac


def _tjac(scale):
    def jac(params, data):
        x, y = params
        (d,) = data
        z = torch.zeros_like(x[0])
        jx = torch.stack([torch.stack([torch.cos(x[0]) * y[1], d[0]]),
                          torch.stack([x[1], x[0]]), torch.stack([z, y[0] * y[1]])])
        jy = torch.stack([torch.stack([z, torch.sin(x[0])]),
                          torch.stack([torch.sin(y[0]) * d[1], z]),
                          torch.stack([y[1] * x[1], y[0] * x[1]])])
        return (scale * jx, scale * jy)
    return jac


def _inputs():
    rng = np.random.default_rng(RNG_SEED)
    return (rng.uniform(0.3, 1.5, (N, 2)), rng.uniform(0.3, 1.5, (N, 2))), rng.normal(size=(N, 2))


def _cost_functions(kind, scale=1.0):
    if kind == "analytic":
        return (jad.AnalyticCostFunction(jfn, _jjac(scale), 3),
                ct.AnalyticCostFunction(tfn, _tjac(scale), 3))
    if kind == "autodiff":
        return jad.CostFunction(jfn, 3), ct.CostFunction(tfn, 3)
    return (jad.NumericDiffCostFunction(jfn, 3, method=kind),
            ct.NumericDiffCostFunction(tfn, 3, method=kind))


def _jacobians(kind, scale=1.0):
    (x, y), d = _inputs()
    jcf, tcf = _cost_functions(kind, scale)
    jr, jj = jad.batched_value_and_jacobians(jcf.fn, (jnp.asarray(x), jnp.asarray(y)),
                                             (jnp.asarray(d),))
    tr, tj = tad.batched_value_and_jacobians(
        tcf.fn, (torch.tensor(x), torch.tensor(y)), (torch.tensor(d),))
    return ((np.asarray(jr), [np.asarray(j) for j in jj]),
            (tr.numpy(), [j.numpy() for j in tj]))


@pytest.mark.parametrize("kind,tol", [("analytic", 1e-12), ("FORWARD", 1e-8), ("CENTRAL", 1e-8),
                                      ("RIDDERS", 1e-6)])
def test_rule_jacobians_match_jax(kind, tol):
    (jr, jj), (tr, tj) = _jacobians(kind)
    np.testing.assert_allclose(tr, jr, rtol=1e-14, atol=1e-14)
    (_, auto), _ = _jacobians("autodiff")
    for a, b, c in zip(tj, jj, auto):
        assert a.shape == b.shape == (N, 3, 2)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max()))
        # and each is a Jacobian of the functor
        np.testing.assert_allclose(a, c, rtol=0, atol=max(tol, 1e-5) * max(1.0, np.abs(c).max()))


def test_wrong_rule_is_computed_as_written():
    """3x the true Jacobian: the port computes the rule, as JAX does."""
    (_, jj), (_, tj) = _jacobians("analytic", 3.0)
    (_, auto), _ = _jacobians("autodiff")
    for a, b, c in zip(tj, jj, auto):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(a, 3.0 * c, rtol=1e-13, atol=1e-13)


def _problems(kind, scale=1.0, loss=True):
    (x, y), d = _inputs()
    jcf, tcf = _cost_functions(kind, scale)
    out = []
    for pkg, cf in ((ceres_tpu, jcf), (ct, tcf)):
        p = pkg.Problem()
        bx, by = p.add_parameter_blocks(x), p.add_parameter_blocks(y)
        p.add_residual_blocks(cf, pkg.CauchyLoss(1.0) if loss else None,
                              np.stack([bx, by], axis=1), (d,))
        out.append(p)
    return out


@pytest.mark.parametrize("with_jacobian", [True, False], ids=["jac", "residual_only"])
def test_wrong_rule_on_jax_b1_interpret(monkeypatch, with_jacobian):
    """JAX's B1 Pallas kernel (interpret mode, float32) runs the inlined
    3x rule; the port's B1 generic plain version (torch.func through the
    rule) agrees with it, and the leaves are 3x those of the autodiff
    functor's JAX evaluation."""
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    jp, tp = _problems("analytic", 3.0)
    ja, _ = _problems("autodiff", 1.0)
    out = {}
    for name, p in (("rule", jp), ("auto", ja)):
        jprog = p.compile()
        arrays = jprog.arrays(jnp.float32)
        assert pallas_eval.group_kernel(jprog.groups[0], arrays["groups"][0], jnp.float32, True,
                                        with_jacobian=with_jacobian) is not None
        out[name] = jax.jit(lambda a, s, jprog=jprog: j_evaluate(
            jprog, a, s, with_jacobian=with_jacobian))(arrays, jprog.state_vector(jnp.float32))
    tprog = tp.compile("cpu")
    tev = Evaluator(tprog, torch.float32)
    st = state_tables(tprog, tprog.state_vector(torch.float32))
    cost, res, leaves = group_eval_plain(tprog.groups[0], tev.arrays["groups"][0], st,
                                         with_jacobian, True)
    c1, r1, j1, _ = out["rule"]
    tol = 5e-4
    assert abs(float(cost) - float(c1)) <= tol * (1.0 + abs(float(c1)))
    np.testing.assert_allclose(res.numpy(), np.asarray(r1[0]), rtol=tol, atol=tol)
    if with_jacobian:
        for a, b, c in zip(leaves, j1.jac_groups[0], out["auto"][2].jac_groups[0]):
            scale = max(1.0, float(jnp.max(jnp.abs(b))))
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol * scale)
            np.testing.assert_allclose(np.asarray(b), 3.0 * np.asarray(c), rtol=tol,
                                       atol=tol * scale)


def _nested(kind):
    tcf = _cost_functions(kind, 3.0)[1]
    return {"top": tcf, "scaled": scaled_cost_function(tcf, 0.5),
            "conditioned": conditioned_cost_function(tcf, [lambda r: 2.0 * r, None, torch.sin])}


@pytest.mark.parametrize("wrapper", ["top", "scaled", "conditioned"])
@pytest.mark.parametrize("kind", ["analytic", "CENTRAL"])
def test_generator_runs_the_rule(kind, wrapper):
    """The generated IR of an analytic group gives the rule's (3x)
    Jacobian, chained through the wrapper, against the torch.func path at
    1e-12, and never the primal's; a numeric rule, alone or nested, is not
    generated."""
    (x, y), d = _inputs()
    cf = _nested(kind)[wrapper]
    p = ct.Problem()
    bx, by = p.add_parameter_blocks(x), p.add_parameter_blocks(y)
    p.add_residual_blocks(cf, ct.CauchyLoss(1.0), np.stack([bx, by], axis=1), (d,))
    program = p.compile("cpu")
    ev = Evaluator(program, F64)
    meta, garr = program.groups[0], ev.arrays["groups"][0]
    prog = functor_codegen.group_program(meta, garr, F64, True)
    if kind != "analytic":
        assert prog is None
        return
    assert prog is not None and prog.has_rule
    st = state_tables(program, program.state_vector(F64))
    _, res, jacs = group_eval_plain(meta, garr, st, True, False)
    auto = tad.batched_value_and_jacobians(
        _nested("autodiff")[wrapper].fn, (torch.tensor(x), torch.tensor(y)), (torch.tensor(d),))[1]
    for b in range(N):
        r_ir, j_ir, _ = functor_codegen.run_ir(prog, [x[b], y[b]], [d[b]])
        np.testing.assert_allclose(r_ir, res[:, b].numpy(), rtol=1e-12, atol=1e-12)
        want = np.concatenate([jacs[p][:, b].numpy().reshape(3, 2) for p in range(2)], axis=1)
        np.testing.assert_allclose(j_ir, want, rtol=1e-12, atol=1e-12)
        primal = np.concatenate([auto[p][b].numpy() for p in range(2)], axis=1)
        np.testing.assert_allclose(j_ir, 3.0 * primal, rtol=1e-12, atol=1e-12)
        r_only, _, _ = functor_codegen.run_ir(prog, [x[b], y[b]], [d[b]], with_jacobian=False)
        np.testing.assert_array_equal(r_only, r_ir)


@pytest.mark.parametrize("case", ["count", "shape"])
def test_shape_errors_match_jax(case):
    (x, y), d = _inputs()

    def bad(pkg_np):
        def jac(params, data):
            e = pkg_np.eye(2, dtype=pkg_np.float64) if pkg_np is jnp else torch.eye(2, dtype=F64)
            if case == "count":
                return (e,)
            return (e, e)
        return jac

    msgs = []
    jcf = jad.AnalyticCostFunction(jfn, bad(jnp), 3)
    with pytest.raises(ValueError) as je:
        jad.batched_value_and_jacobians(jcf.fn, (jnp.asarray(x), jnp.asarray(y)),
                                        (jnp.asarray(d),))
    msgs.append(str(je.value))
    tcf = ct.AnalyticCostFunction(tfn, bad(torch), 3)
    with pytest.raises(ValueError) as te:
        tad.batched_value_and_jacobians(tcf.fn, (torch.tensor(x), torch.tensor(y)),
                                        (torch.tensor(d),))
    msgs.append(str(te.value))
    assert msgs[0] == msgs[1]
    assert ("Jacobians for 2 parameter blocks" if case == "count" else "expected") in msgs[0]


# ---- LM on a small bundle adjustment ------------------------------------ #

BAL = synthetic_bal(5, 30, 120, seed=4)


def _permuted(bal, seed):
    perm = np.random.default_rng(seed).permutation(len(bal.observations))
    return dataclasses.replace(bal, camera_index=bal.camera_index[perm],
                               point_index=bal.point_index[perm],
                               observations=bal.observations[perm])


def _ba(pkg, bal, kind):
    if pkg is ceres_tpu:
        fn = j_snavely
        cf = (jad.NumericDiffCostFunction(fn, 2, method="CENTRAL") if kind == "numeric" else
              jad.AnalyticCostFunction(fn, lambda p, d: jax.jacfwd(
                  lambda *q: fn(q, d), argnums=(0, 1))(*p), 2))
    else:
        fn = t_snavely
        cf = (ct.NumericDiffCostFunction(fn, 2, method="CENTRAL") if kind == "numeric" else
              ct.AnalyticCostFunction(fn, lambda p, d: torch.func.jacfwd(
                  lambda *q: fn(q, d), argnums=(0, 1))(*p), 2))
    p = pkg.Problem()
    cams = p.add_parameter_blocks(bal.cameras)
    pts = p.add_parameter_blocks(bal.points)
    p.add_residual_blocks(cf, pkg.HuberLoss(1.0),
                          np.stack([cams[bal.camera_index], pts[bal.point_index]], axis=1),
                          (bal.observations,))
    return p


def _options(pkg, **kw):
    types = pkg.types if hasattr(pkg, "types") else pkg
    return pkg.SolverOptions(
        linear_solver_type=types.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=types.PreconditionerType.JACOBI,
        max_num_iterations=3, function_tolerance=0.0, gradient_tolerance=0.0,
        parameter_tolerance=0.0, **kw)


def _gap(a, b):
    assert len(a.iterations) == len(b.iterations)
    return max(abs(x.cost - y.cost) / abs(x.cost) for x, y in zip(a.iterations, b.iterations))


@pytest.mark.parametrize("kind", ["numeric", "analytic"])
def test_ba_solve_matches_jax(kind):
    """The analytic solves agree to ~1e-15. The numeric ones part at the
    first step (~3e-4): synthetic_bal's cameras have translations of 0
    (and ~1e-16), whose central differences take the 1e-12 floor of the
    step, so one ulp of difference in fn (XLA's fused, jitted arithmetic
    against torch's eager ops) moves those columns by ~1e-3. ceres_tpu's
    own solve moves as far when its evaluation runs eagerly
    (jax.disable_jit: ~3e-4 from its jitted solve, ~1e-6 from the port's),
    so that is the self-gap the port is held to here; observation
    permutations do not change a block's arithmetic."""
    want = ceres_tpu.solve(_options(ceres_tpu), _ba(ceres_tpu, BAL, kind))
    got = ct.solve(_options(ct, device="cpu"), _ba(ct, BAL, kind))
    gap = _gap(want, got)
    if gap > 1e-10:
        gaps = [_gap(want, ceres_tpu.solve(_options(ceres_tpu),
                                           _ba(ceres_tpu, _permuted(BAL, s), kind)))
                for s in (0, 1)]
        if kind == "numeric":
            with jax.disable_jit():
                gaps.append(_gap(want, ceres_tpu.solve(_options(ceres_tpu),
                                                       _ba(ceres_tpu, BAL, kind))))
        self_gap = max(gaps)
        assert gap <= 10.0 * self_gap, f"port vs JAX {gap:.3e}, JAX vs itself {self_gap:.3e}"
    assert got.final_cost < got.initial_cost
    for a, b in zip(got.iterations, want.iterations):
        assert a.linear_solver_iterations == b.linear_solver_iterations


def test_central_differences_in_rounding_units():
    """chip_smoke.fd_rounding_excess's units (the rounding bound eps |f| / h
    of a central difference) on a Snavely group: against the exact
    Jacobian, the columns at the step's 1e-12 floor (the camera
    translations of 0) stay within a unit or two, the rest within tens
    (the rotation carries values larger than |f|). The card's check holds
    its finite differences to the CPU's at 8 and 64 of these units."""
    from chip_smoke import fd_rounding_excess, numeric_ba_problem

    bal = ct.synthetic_bal(16, 500, 4000, seed=1)
    jacs = {}
    for kind in ("numeric", "exact"):
        if kind == "numeric":
            p = numeric_ba_problem(bal)
        else:
            p = ct.Problem()
            cams = p.add_parameter_blocks(bal.cameras)
            pts = p.add_parameter_blocks(bal.points)
            p.add_residual_blocks(ct.CostFunction(t_snavely, 2), ct.HuberLoss(1.0),
                                  np.stack([cams[bal.camera_index], pts[bal.point_index]], 1),
                                  (bal.observations,))
        program = p.compile("cpu")
        ev = Evaluator(program, torch.float64)
        _, res, jacs[kind], _ = ev.evaluate_groups(program.state_vector(torch.float64))
    garr = ev.arrays["groups"][0]
    st = state_tables(program, program.state_vector(torch.float64))
    params = [st[pm.a_cls][rows] for pm, rows in zip(program.groups[0].positions, garr["a_rows"])]
    scale = garr["data"][0].abs().max(dim=1).values + res[0].abs().max(dim=0).values
    at_floor, above = fd_rounding_excess(jacs["numeric"].jac_groups[0],
                                         jacs["exact"].jac_groups[0], params, scale)
    print(f"central differences vs the exact Jacobian: {at_floor:.2f} units at the floor, "
          f"{above:.2f} above it")
    assert 0.0 < at_floor <= 2.0 and 8.0 < above <= 128.0
