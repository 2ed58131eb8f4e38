"""Sharded solves on the card: B1's masked launches against their plain
versions, a 2-rank gloo solve on one card, a 1-rank NCCL solve on the
fused loop.

These tests need an NVIDIA GPU and skip without one; the file imports no
JAX (`python -m pytest --noconftest tests/test_torch_cuda_sharding.py`).
B1's tolerances are those of tests/test_torch_cuda_kernels.py (float32
2e-4, float64 1e-11 of the plain version's largest magnitude); a masked
lane must come out exactly 0, an unmasked one bitwise the unmasked
launch's, and a mask of ones bitwise the launch without a mask."""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch import cuda_lib, eval_kernel, functor_codegen
from ceres_tpu_torch.evaluator import Evaluator, group_eval_plain, state_tables
from ceres_tpu_torch.utils import execution_summary as es

import torch_mp
from torch_mp_worker import solve_options, solve_problem, summary_record

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _mask(n, device, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=g) >= 0.125).to(dtype).to(device)


def _check_masked(launch, plain, mask, tol):
    """launch(mask) against plain(mask): within tol, masked lanes exactly 0,
    unmasked lanes bitwise launch(None)'s, and a mask of ones bitwise
    launch(None)."""
    got, want, free = launch(mask), plain(mask), launch(None)
    ones = launch(torch.ones_like(mask))
    torch.cuda.synchronize()
    dead = mask == 0
    assert bool(dead.any()) and not bool(dead.all())
    outs = [(got[1], want[1], free[1], ones[1])] + list(zip(got[2], want[2], free[2], ones[2]))
    for g, w, f, o in outs:
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())
        assert bool((g[:, dead] == 0).all())
        assert torch.equal(g[:, ~dead], f[:, ~dead])
        assert torch.equal(o, f)
    assert abs(float(got[0]) - float(want[0])) <= tol * abs(float(want[0]))
    assert torch.equal(ones[0], free[0])


def _snavely_args(card, dtype, quaternion, with_jac):
    bal = ct.synthetic_bal(32, 4000, 40_000, seed=5)
    problem = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), use_quaternions=quaternion,
                                  use_manifolds=quaternion)[0]
    program = problem.compile(card)
    g = Evaluator(program, dtype).arrays["groups"][0]
    st = state_tables(program, program.state_vector(dtype))
    cam, pt = (pm.a_cls for pm in program.groups[0].positions)
    return (st[cam], g["a_rows"][0], st[pt], g["a_rows"][1], g["data"][0], ct.HuberLoss(1.0),
            with_jac)


@pytest.mark.parametrize("with_jac", [True, False], ids=["jac", "residual_only"])
@pytest.mark.parametrize("model", ["snavely", "quat_manifold", "quat_nomanifold"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_snavely_matches_plain(card, dtype, model, with_jac):
    tol = 2e-4 if dtype == torch.float32 else 1e-11
    args = _snavely_args(card, dtype, model != "snavely", with_jac)
    mask = _mask(args[1].shape[0], card, dtype)
    name = {"snavely": "eval_snavely", "quat_manifold": "eval_snavely_quat",
            "quat_nomanifold": "eval_snavely_quat_nomanifold"}[model]
    if model == "snavely":
        launch = lambda m: eval_kernel.snavely_evaluate(*args, m)  # noqa: E731
        plain = lambda m: eval_kernel.snavely_evaluate_plain(*args, m)  # noqa: E731
    else:
        manifold = model == "quat_manifold"
        launch = lambda m: eval_kernel.snavely_quat_evaluate(*args, manifold, m)  # noqa: E731
        plain = lambda m: eval_kernel.snavely_quat_evaluate_plain(*args, manifold, m)  # noqa: E731
    before = es.counts()
    _check_masked(launch, plain, mask, tol)
    after = es.counts()
    assert after[name + "_masked"] == before[name + "_masked"] + 2
    assert after[name] == before[name] + 1


@pytest.mark.parametrize("analytic", [False, True], ids=["autodiff", "analytic"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_generic_matches_plain(card, dtype, analytic):
    from chip_smoke import build_foe

    tol = 2e-4 if dtype == torch.float32 else 1e-11
    program = build_foe(40, 36, 3, 2, seed=4, analytic=analytic).compile(card)
    ev = Evaluator(program, dtype)
    st = state_tables(program, program.state_vector(dtype))
    for gi, meta in enumerate(program.groups):
        garr = dict(ev.arrays["groups"][gi])
        prog = functor_codegen.group_program(meta, garr, dtype, True)
        mask = _mask(meta.n, card, dtype, seed=gi)
        for with_jac in (True, False):
            def run(fn, m, with_jac=with_jac):
                g = dict(garr, mask=m) if m is not None else garr
                return fn(g, with_jac)

            _check_masked(
                lambda m: run(lambda g, j: eval_kernel.generic_evaluate(prog, meta, g, st, j), m),
                lambda m: run(lambda g, j: group_eval_plain(meta, g, st, j, True), m),
                mask, tol,
            )


def _unsharded(card, case):
    s = ct.solve(solve_options(ct, case, device=card, dtype=torch.float64),
                 solve_problem(ct, case))
    return summary_record(s)


def test_two_gloo_ranks_on_one_card(card, tmp_path):
    cuda_lib.library()  # built before the ranks start
    case = "ischur_schur_jacobi"
    started = torch_mp.start_ranks(str(tmp_path), 2, {
        "mesh": "global", "threshold": 16, "cases": [case], "device": "cuda:0",
    })
    from ceres_tpu_torch.program import Program

    saved, Program.SEG_REDUCE_THRESHOLD = Program.SEG_REDUCE_THRESHOLD, 16
    try:
        want = _unsharded(card, case)
    finally:
        Program.SEG_REDUCE_THRESHOLD = saved
    ranks = [r[case] for r in torch_mp.collect(started)]
    assert ranks[0] == ranks[1]
    got = ranks[0]
    assert not got["used_fused_execution"]
    assert got["linear_solver_iterations"] == want["linear_solver_iterations"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-6)


def test_one_nccl_rank_runs_fused(card, tmp_path):
    """A 1-rank NCCL mesh takes the fused loop, its all-reduces captured in
    the graphs, and reads at most 2 + PCG steps per iteration."""
    cuda_lib.library()
    case = "ischur_schur_jacobi"
    started = torch_mp.start_ranks(str(tmp_path), 1, {
        "mesh": "global", "threshold": 16, "cases": [case], "device": "cuda:0",
        "backend": "nccl",
    })
    got = torch_mp.collect(started)[0][case]
    assert got["used_fused_execution"]
    for reads, pcg in zip(got["num_device_reads"][1:], got["linear_solver_iterations"][1:]):
        assert reads <= 2 + pcg
    from ceres_tpu_torch.program import Program

    saved, Program.SEG_REDUCE_THRESHOLD = Program.SEG_REDUCE_THRESHOLD, 16
    try:
        want = _unsharded(card, case)
    finally:
        Program.SEG_REDUCE_THRESHOLD = saved
    assert got["linear_solver_iterations"] == want["linear_solver_iterations"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-10)
