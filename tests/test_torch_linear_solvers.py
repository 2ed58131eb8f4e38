"""DENSE_QR, DENSE_NORMAL_CHOLESKY and CGNR of the port against ceres_tpu's.

The same problem (made from numpy seeds) is solved by both packages in
float64 with LM, and every iteration must agree: cost to 1e-10 relative,
the radius (its tolerance scaled by cost / |cost change|, as in
test_torch_solve.py), the PCG count and the accept/reject decision.
- DENSE_QR and DENSE_NORMAL_CHOLESKY on Powell's function and on the
  exponential curve fit (examples/test_functions.py), and
  DENSE_NORMAL_CHOLESKY under use_mixed_precision_solves (a float32 factor
  refined in float64);
- CGNR with JACOBI on a small bundle adjustment problem, with IDENTITY on
  the small denoising problem of examples/denoising.build_denoising_problem
  and on Fields-of-Experts priors (3x3 and 5x5 cliques, PCG <= 10 steps),
  and with JACOBI under use_mixed_precision_solves (bfloat16 leaves in the
  matvec): held, as ceres_tpu's own mixed tests hold it, at 1e-3 of the
  JAX package's cost, since the two packages round the bfloat16 products
  at different places (the port forms each product exactly in float32,
  gather_reduce.leaf_operand; JAX in bfloat16);
- the fused loop against the host loop at 1e-12, with the same PCG counts
  and decisions.
The pieces: `jtj_multiply` against `to_dense` on many-position groups of
one class (the Fields-of-Experts cliques, no layout plan), and
`make_preconditioner` for IDENTITY and JACOBI against ceres_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.examples import test_functions as jtf
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.linalg.preconditioners import make_preconditioner as j_make_preconditioner
from ceres_tpu_torch import interop
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.examples import denoising as tdn
from ceres_tpu_torch.examples import test_functions as ttf
from ceres_tpu_torch.linalg.preconditioners import make_preconditioner
from ceres_tpu_torch.program import Program as TProgram

torch.set_num_threads(1)
F64 = torch.float64


def _options(pkg, solver, precond="JACOBI", **kw):
    base = dict(
        linear_solver_type=getattr(pkg.LinearSolverType, solver),
        preconditioner_type=getattr(pkg.PreconditionerType, precond),
        max_num_iterations=6,
        eta=0.1,
        max_linear_solver_iterations=25,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
    )
    return pkg.SolverOptions(**{**base, **kw})


def _problems(name):
    """(JAX problem, port problem) of the same data."""
    if name == "powell":
        return jtf.build_powell_problem()[0], ttf.build_powell_problem()[0]
    if name == "denoise":
        from ceres_tpu.examples import denoising as jdn

        img = tdn.synthetic_noisy_image(12, 10, seed=4) / 255.0
        return jdn.build_denoising_problem(img)[0], tdn.build_denoising_problem(img)[0]
    if name in ("foe3", "foe5"):
        from ceres_tpu.examples import denoising as jdn

        size, k = (3, 3) if name == "foe3" else (5, 2)
        foe = tdn.synthetic_foe_model(size, k, seed=0)
        img = tdn.synthetic_noisy_image(24, 20, sigma=20.0, seed=0)
        jfoe = jdn.FoEModel(**{f: getattr(foe, f) for f in
                               ("size", "x_deltas", "y_deltas", "alphas", "filters")})
        return (jdn.build_foe_denoising_problem(img, jfoe, sigma=20.0)[0],
                tdn.build_foe_denoising_problem(img, interop.foe_model(jfoe), sigma=20.0)[0])
    if name == "curve":
        data = jtf.make_curve_fitting_data(seed=5)
        return (jtf.build_curve_fitting_problem(data, m0=0.0, c0=0.0)[0],
                ttf.build_curve_fitting_problem(data, m0=0.0, c0=0.0)[0])
    bal = synthetic_bal(8, 60, 300, seed=3, perturb_points=0.05)
    return (j_build(bal, loss=ceres_tpu.HuberLoss(1.0))[0],
            ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0])


def assert_same_iterations(ts, js, rel=1e-10, pcg=True):
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        assert a.cost == pytest.approx(b.cost, rel=rel, abs=1e-30)
        rtol = rel + (1e-13 * b.cost / abs(b.cost_change) if b.cost_change else 0.0)
        assert a.trust_region_radius == pytest.approx(b.trust_region_radius, rel=rtol)
        if pcg:
            assert a.linear_solver_iterations == b.linear_solver_iterations
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)


SOLVE_CASES = {
    # case: (problem, solver, preconditioner, extra options, tolerance)
    "powell-dense_qr": ("powell", "DENSE_QR", "JACOBI", {}, 1e-10),
    "powell-dense_normal_cholesky": ("powell", "DENSE_NORMAL_CHOLESKY", "JACOBI", {}, 1e-10),
    "curve-dense_qr": ("curve", "DENSE_QR", "JACOBI", {}, 1e-10),
    "curve-dense_normal_cholesky": ("curve", "DENSE_NORMAL_CHOLESKY", "JACOBI", {}, 1e-10),
    "curve-dense_normal_cholesky-mixed": (
        "curve", "DENSE_NORMAL_CHOLESKY", "JACOBI", {"use_mixed_precision_solves": True}, 1e-10),
    "ba-cgnr-jacobi": ("ba", "CGNR", "JACOBI", {}, 1e-10),
    # unpreconditioned CG on the BA problem is ill-conditioned enough that
    # the two packages' rounding grows to 1e-8 within 25 steps: the simple
    # denoising problem, whose data term keeps it well conditioned, and the
    # Fields-of-Experts priors at PCG <= 10 steps (at 25 steps both packages
    # take 25 steps with the same decisions on these images, and their
    # costs part by up to 8.3e-5 on the 5x5 prior, 1.5e-11 on the 3x3; at
    # 10 steps by at most 1.9e-14, two seeds each)
    "denoise-cgnr-identity": ("denoise", "CGNR", "IDENTITY", {}, 1e-10),
    "foe3-cgnr-identity": (
        "foe3", "CGNR", "IDENTITY", {"max_linear_solver_iterations": 10}, 1e-10),
    "foe5-cgnr-identity": (
        "foe5", "CGNR", "IDENTITY", {"max_linear_solver_iterations": 10}, 1e-10),
    "ba-cgnr-jacobi-mixed": ("ba", "CGNR", "JACOBI", {"use_mixed_precision_solves": True}, 1e-3),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_matches_jax_per_iteration(case):
    name, solver, precond, extra, tol = SOLVE_CASES[case]
    jp, tp = _problems(name)
    js = ceres_tpu.solve(_options(ceres_tpu, solver, precond, **extra), jp)
    ts = ct.solve(_options(ct, solver, precond, device="cpu", **extra), tp)
    assert ts.used_fused_execution == js.used_fused_execution
    assert_same_iterations(ts, js, rel=tol, pcg=tol <= 1e-10)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=tol, abs=1e-30)
    assert ts.final_cost < ts.initial_cost


@pytest.mark.parametrize("case", ["powell-dense_qr", "curve-dense_normal_cholesky-mixed",
                                  "ba-cgnr-jacobi", "denoise-cgnr-identity"])
def test_fused_loop_matches_host_loop(case):
    name, solver, precond, extra, _ = SOLVE_CASES[case]
    runs = []
    for fused in (True, False):
        tp = _problems(name)[1]
        runs.append(ct.solve(_options(ct, solver, precond, device="cpu", fused_execution=fused,
                                      **extra), tp))
    assert runs[0].used_fused_execution and not runs[1].used_fused_execution
    assert_same_iterations(runs[0], runs[1], rel=1e-12)
    # the fused loop's read budget: 2 + PCG steps per iteration
    for it in runs[0].iterations[1:]:
        assert it.num_device_reads <= 2 + it.linear_solver_iterations


def _foe_program(monkeypatch, threshold, onehot_max):
    """A small Fields-of-Experts problem (5 x 5 cliques: 25 positions of the
    pixel class; a bucket plan on the owner position when the layout plans
    engage, and the onehot plan on the others only when the class has at
    most `onehot_max` rows, which at 512 x 512 it has not)."""
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", threshold)
    monkeypatch.setattr(TProgram, "ONEHOT_MAX_COLS", onehot_max)
    rng = np.random.default_rng(2)
    d = np.arange(5)
    foe = tdn.FoEModel(5, np.tile(d, 5), np.repeat(d, 5), rng.uniform(0.5, 2.0, 2),
                       rng.normal(size=(2, 25)))
    return tdn.build_foe_denoising_problem(rng.uniform(0, 255, (12, 10)), foe)[0].compile("cpu")


@pytest.mark.parametrize("threshold,onehot_max,plans", [
    (16, 8, {"bucket"}), (16, TProgram.ONEHOT_MAX_COLS, {"bucket", "onehot"}), (10**9, 8, set()),
], ids=["bucket", "bucket_onehot", "no_plans"])
def test_jtj_multiply_matches_dense(monkeypatch, threshold, onehot_max, plans):
    program = _foe_program(monkeypatch, threshold, onehot_max)
    assert {p[0] for p in program.groups[1].red_plans.values()} == plans
    ev = Evaluator(program, F64)
    _, _, jac, _ = ev.evaluate_groups(program.state_vector(F64))
    rng = np.random.default_rng(0)
    n = program.num_effective_parameters
    scale = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=F64)
    dsq = torch.tensor(rng.uniform(0.1, 1.0, n), dtype=F64)
    v = torch.tensor(rng.normal(size=n), dtype=F64)
    jac_s = jac.scale_columns(scale)
    dense = jac_s.to_dense()
    want = dense.T @ (dense @ v) + dsq * v
    got = jac_s.jtj_multiply(v, dsq)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))
    torch.testing.assert_close(jac_s.jtj_multiply(v), dense.T @ (dense @ v), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("kind", ["IDENTITY", "JACOBI"])
def test_make_preconditioner_matches_jax(kind):
    """JACOBI over every class (cameras and points) and IDENTITY, on the
    same scaled Jacobian and D², against ceres_tpu's."""
    from ceres_tpu.evaluator import evaluate as j_evaluate

    jp, tp = _problems("ba")
    jprog = jp.compile()
    tprog = tp.compile("cpu")
    _, _, jjac, _ = j_evaluate(jprog, jprog.arrays(jnp.float64), jprog.state_vector(jnp.float64))
    _, _, tjac, _ = Evaluator(tprog, F64).evaluate_groups(tprog.state_vector(F64))
    rng = np.random.default_rng(1)
    n = tprog.num_effective_parameters
    dsq, r = rng.uniform(0.1, 1.0, n), rng.normal(size=n)
    jm = j_make_preconditioner(getattr(ceres_tpu.PreconditionerType, kind), jprog, jjac,
                               dsq=jnp.asarray(dsq))
    tm = make_preconditioner(getattr(ct.PreconditionerType, kind), tprog, tjac,
                             dsq=torch.tensor(dsq, dtype=F64))
    want = np.asarray(jm(jnp.asarray(r)))
    got = tm(torch.tensor(r, dtype=F64)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
