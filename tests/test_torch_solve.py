"""End to end: the port's LM + ITERATIVE_SCHUR solve against ceres_tpu's,
plus the package-level guarantees.

The same synthetic_bal (Huber(1.0), eta 0.1, PCG <= 25, 5 iterations,
float64, tolerances off so all 5 iterations run) is solved by both
packages; the JAX side runs its host loop (fused_execution=False). Every
iteration must agree: cost to 1e-10 relative, trust-region radius, PCG
iteration count and the accept/reject decision. The preconditioner cases:
JACOBI and SCHUR_JACOBI through the prepare/finish split (with the layout
plans, where kernels B4/B5 sit, and without), and SCHUR_JACOBI with the
power-series warm start, which only schur_solve runs. The SCHUR_JACOBI
problems have no point seen by one camera only (see
test_torch_schur_jacobi.py)."""

import pathlib
import re

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
REPO = pathlib.Path(__file__).resolve().parents[1]

LM = dict(
    max_num_iterations=5,
    eta=0.1,
    max_linear_solver_iterations=25,
    function_tolerance=0.0,
    gradient_tolerance=0.0,
    parameter_tolerance=0.0,
)


def _options(pkg, **kw):
    base = dict(
        linear_solver_type=pkg.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=pkg.PreconditionerType.JACOBI,
        **LM,
    )
    return pkg.SolverOptions(**{**base, **kw})


@pytest.mark.parametrize(
    "case",
    [
        ("huber_plans", 16, True, 3, 0.05, "JACOBI", {}),
        ("noloss_plans", 16, False, 5, 0.5, "JACOBI", {}),
        ("huber_fallback", 10**9, True, 4, 0.05, "JACOBI", {}),
        ("schur_jacobi_plans", 16, True, 3, 0.05, "SCHUR_JACOBI", {}),
        ("schur_jacobi_fallback", 10**9, True, 4, 0.05, "SCHUR_JACOBI", {}),
        ("spse_init_plans", 16, True, 3, 0.05, "SCHUR_JACOBI",
         {"use_spse_initialization": True}),
    ],
    ids=lambda c: c[0],
)
def test_lm_solve_matches_jax_per_iteration(monkeypatch, case):
    _name, threshold, huber, seed, perturb, precond, extra = case
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", threshold)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", threshold)
    bal = synthetic_bal(8, 60, 300, seed=seed, perturb_points=perturb)
    jp, _, _ = j_build(bal, loss=ceres_tpu.HuberLoss(1.0) if huber else None)
    tp, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0) if huber else None)
    js = ceres_tpu.solve(_options(
        ceres_tpu, fused_execution=False,
        preconditioner_type=getattr(ceres_tpu.PreconditionerType, precond), **extra), jp)
    ts = ct.solve(_options(
        ct, device="cpu", preconditioner_type=getattr(ct.PreconditionerType, precond), **extra), tp)
    assert not js.used_fused_execution and not ts.used_fused_execution
    assert len(ts.iterations) == len(js.iterations) == 6
    for a, b in zip(ts.iterations, js.iterations):
        assert a.iteration == b.iteration
        assert a.cost == pytest.approx(b.cost, rel=1e-10)
        # the radius follows rho = cost change / model cost change, whose
        # relative error is the costs' rounding amplified by cost / |change|
        rtol = 1e-10 + (1e-13 * b.cost / abs(b.cost_change) if b.cost_change else 0.0)
        assert a.trust_region_radius == pytest.approx(b.trust_region_radius, rel=rtol)
        assert a.linear_solver_iterations == b.linear_solver_iterations
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-10)
    assert ts.termination_type.value == js.termination_type.value
    assert (ts.num_successful_steps, ts.num_unsuccessful_steps) == (
        js.num_successful_steps, js.num_unsuccessful_steps)


def test_no_jax_import_in_port():
    """The port imports no JAX. A static check: where site customization
    imports jax into every interpreter (tests/conftest.py), a subprocess
    check could not tell."""
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ceres_tpu\b|from\s+ceres_tpu\b|from\s+ceres_tpu\s)", re.M)
    scripts = ["chip_smoke.py", "profile_torch_solve.py"]
    files = sorted((REPO / "ceres_tpu_torch").rglob("*.py")) + [REPO / f for f in scripts]
    assert len(files) > 15
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_solve_writes_state_back_and_reports():
    bal = synthetic_bal(6, 40, 200, seed=1)
    problem, cams, pts = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    s = ct.solve(_options(ct, device="cpu", max_num_iterations=3), problem)
    assert s.final_cost < s.initial_cost
    assert s.num_residuals == 400 and s.num_residual_blocks == 200
    assert s.linear_solver_type_used == ct.LinearSolverType.ITERATIVE_SCHUR
    assert not np.array_equal(problem.parameter_block_value(pts[0]), bal.points[0])
    report = s.full_report()
    assert "Evaluator::Jacobian" in report and "LinearSolver::Solve" in report
    # re-solving starts from the written-back state
    s2 = ct.solve(_options(ct, device="cpu", max_num_iterations=1), problem)
    assert s2.initial_cost == pytest.approx(s.final_cost, rel=1e-12)


def test_solve_is_deterministic():
    bal = synthetic_bal(6, 40, 200, seed=2)
    out = []
    for _ in range(2):
        problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
        ct.solve(_options(ct, device="cpu", max_num_iterations=3), problem)
        out.append(problem.compile("cpu").state0.copy())
    np.testing.assert_array_equal(out[0], out[1])


def test_float32_solve_decreases_cost():
    bal = synthetic_bal(6, 40, 200, seed=3)
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    s = ct.solve(_options(ct, device="cpu", dtype=torch.float32), problem)
    assert all(np.isfinite(it.cost) for it in s.iterations)
    assert s.final_cost < 0.5 * s.initial_cost


def test_invalid_and_unsupported_options():
    problem, _, _ = ct.build_ba_problem(synthetic_bal(3, 10, 30, seed=4))
    s = ct.solve(ct.SolverOptions(max_num_iterations=-1, device="cpu"), problem)
    assert s.termination_type == ct.TerminationType.FAILURE and "Invalid" in s.message
    with pytest.raises(NotImplementedError):
        ct.solve(ct.SolverOptions(device="cpu"), problem)  # DENSE_QR: not ported
    with pytest.raises(NotImplementedError):
        ct.solve(
            _options(ct, device="cpu", preconditioner_type=ct.PreconditionerType.CLUSTER_JACOBI),
            problem,
        )


def test_empty_problem_converges():
    p = ct.Problem()
    p.add_parameter_blocks(np.zeros((2, 3)))
    s = ct.solve(_options(ct, device="cpu"), p)
    assert s.termination_type == ct.TerminationType.CONVERGENCE


@pytest.mark.parametrize("device,expect", [(None, RuntimeError), ("cpu", "cpu")])
def test_solve_never_falls_back_to_the_cpu(monkeypatch, device, expect):
    """With no device named, solve runs on the card; with no card visible it
    raises and leaves the problem as it was. A named "cpu" runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bal = synthetic_bal(4, 20, 80, seed=5)
    problem, _, pts = ct.build_ba_problem(bal)
    options = _options(ct, device=device, max_num_iterations=1)
    if expect is RuntimeError:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ct.solve(options, problem)
        np.testing.assert_array_equal(problem.parameter_block_value(pts[0]), bal.points[0])
    else:
        assert ct.solve(options, problem).final_cost < np.inf
        assert problem.compile("cpu").device == torch.device(expect)


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
