"""Sharded solves of the port (parallel/) against ceres_tpu's.

- the shard layout (Program.build_shard_layout) equals JAX's exactly;
- kernel B1's mask: the plain versions of the Snavely (angle-axis and
  quaternion) and generic (autodiff and analytic) instantiations with a
  lane mask against JAX's masked GroupKernel in interpret mode (float32,
  5e-4) and its XLA path (float64, 1e-12), masked lanes exactly 0;
- the sharded evaluation on 2 ranks (gloo, spawned processes that import
  only the port: tests/torch_mp_worker.py, each under a timeout) against
  ceres_tpu.parallel.sharding.ShardedEvaluator on a 2-device mesh of
  conftest's virtual CPU devices (tests/test_sharding.py:44-70's
  tolerances);
- 2-rank solves (ITERATIVE_SCHUR + SCHUR_JACOBI, CGNR + JACOBI, DOGLEG,
  CLUSTER_JACOBI, SUBSET's downgrade) per iteration against JAX's sharded
  solve (1e-10) and the port's unsharded one (1e-6), every rank's summary
  bitwise the same (lockstep), on the host loop (a gloo mesh);
- a rank's device: never the CPU unless named (initialize raises with no
  card and no device; solve refuses an options.device that is not the
  mesh's).
The layout and the solves lower SEG_REDUCE_THRESHOLD to 16 in both
packages, so the bucket plans, and with them the "bucket_sharded" windows
and the pad lanes, are in play. The problems are ones where ceres_tpu's
shard windows are right: its window clamp (ceres_tpu/jacobian.py:260-261)
gathers a last shard's lanes from the wrong rows where a bucket does not
split evenly (ROADMAP Queue C); test_windows_of_an_uneven_last_shard holds
the port to its unsharded evaluation on such a case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.evaluator import evaluate as j_evaluate
from ceres_tpu.examples import denoising as jdn
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.parallel.sharding import ShardedEvaluator as JShardedEvaluator
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch import interop
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.evaluator import evaluate as t_evaluate
from ceres_tpu_torch.examples import denoising as tdn
from ceres_tpu_torch.parallel import distributed, sharding
from ceres_tpu_torch.program import Program as TProgram

import torch_mp
from torch_mp_worker import (
    EVAL_CASE,
    PORT_ONLY_CASES,
    SOLVE_CASES,
    constrain,
    solve_options,
    solve_problem,
    summary_record,
)

torch.set_num_threads(1)
F64 = torch.float64
THRESHOLD = 16


@pytest.fixture
def low_threshold(monkeypatch):
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", THRESHOLD)


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
def test_shard_layout_matches_jax(low_threshold, ndev):
    bal = synthetic_bal(6, 50, 203, seed=2)
    jl = j_build(bal)[0].compile().build_shard_layout(ndev)
    tl = ct.build_ba_problem(bal)[0].compile("cpu").build_shard_layout(ndev)
    assert jl.keys() == tl.keys()
    assert any(lay["shard_buckets"] is not None for lay in tl.values())
    for gi in jl:
        np.testing.assert_array_equal(tl[gi]["perm"], jl[gi]["perm"])
        assert tl[gi]["lanes_per_shard"] == jl[gi]["lanes_per_shard"]
        assert tl[gi]["shard_buckets"] == jl[gi]["shard_buckets"]


def test_windows_of_an_uneven_last_shard(low_threshold):
    """3 shards of a problem whose last bucket (8 points) splits 3/3/2: the
    last shard's window has a pad entity. Each shard's cost and gradient,
    summed, equal the unsharded evaluation (ceres_tpu's sharded cost is off
    by a factor of ~500 here)."""
    program = ct.build_ba_problem(synthetic_bal(6, 50, 203, seed=3))[0].compile("cpu")
    gi = next(i for i, m in enumerate(program.groups) if m.owner >= 0)
    plan = program.groups[gi].red_plans[program.groups[gi].owner][1]
    assert plan[-1][1] % 3 != 0
    state = program.state_vector(F64)
    cost1, _, _, grad1 = Evaluator(program, F64).evaluate_groups(state)

    class OneRank:  # a mesh of one rank standing for shard `rank` of 3
        size, psum, psum_tables = 3, staticmethod(lambda x: x), staticmethod(lambda t: t)

        def __init__(self, shard):
            self.rank = shard

    cost, grad, pads = 0.0, 0.0, 0
    for s in range(3):
        arrays = sharding.build_shard_arrays(program, OneRank(s), F64)
        c, _, _, g = t_evaluate(program, arrays, state)
        cost, grad = cost + c, grad + g
        pads += int((arrays["groups"][gi]["mask"] == 0).sum())
        live = [b[4] for b in arrays["groups"][gi]["plans"][program.groups[gi].owner][1]]
        assert s < 2 or live[-1] < plan[-1][1] // 3 + 1
    assert pads > 0
    np.testing.assert_allclose(float(cost), float(cost1), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), grad1.numpy(), rtol=1e-10, atol=1e-9)


# ------------------------------------------------------------ B1's mask


def _mask(n, seed):
    return (np.random.default_rng(seed).random(n) >= 0.125).astype(np.float64)


def _b1_problems(case):
    bal = synthetic_bal(5, 30, 90, seed=4)
    img = tdn.synthetic_noisy_image(9, 8, seed=3)
    foe = tdn.synthetic_foe_model(3, 2, seed=1)
    jfoe = jdn.FoEModel(**{f: getattr(foe, f) for f in
                           ("size", "x_deltas", "y_deltas", "alphas", "filters")})
    if case == "snavely":
        return (j_build(bal, loss=ceres_tpu.HuberLoss(1.0))[0],
                ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0])
    if case == "quaternion":
        return (j_build(bal, loss=ceres_tpu.HuberLoss(1.0), use_quaternions=True,
                        use_manifolds=True)[0],
                ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), use_quaternions=True,
                                    use_manifolds=True)[0])
    # B1 generic: autodiff, and the port's analytic cliques against JAX's
    # autodiff ones (the same Jacobian)
    return (jdn.build_foe_denoising_problem(img, jfoe)[0],
            tdn.build_foe_denoising_problem(img, interop.foe_model(jfoe),
                                            analytic=case == "foe3_analytic")[0])


B1_CASES = ["snavely", "quaternion", "foe3", "foe3_analytic"]


def _masked(jp, tp, jdtype, tdtype, with_jacobian):
    jprog, tprog = jp.compile(), tp.compile("cpu")
    arrays = jprog.arrays(jdtype)
    ev = Evaluator(tprog, tdtype)
    masks = [_mask(m.n, 7 + gi) for gi, m in enumerate(tprog.groups)]
    for g, tg, m in zip(arrays["groups"], ev.arrays["groups"], masks):
        g["mask"] = jnp.asarray(m, jdtype)
        tg["mask"] = torch.as_tensor(m, dtype=tdtype)
    want = jax.jit(lambda a, s: j_evaluate(jprog, a, s, with_jacobian=with_jacobian))(
        arrays, jprog.state_vector(jdtype))
    got = t_evaluate(tprog, ev.arrays, tprog.state_vector(tdtype), with_jacobian=with_jacobian)
    return want, got, masks


def _check_masked(want, got, masks, tol, with_jacobian):
    c1, r1, j1, g1 = want
    c2, r2, j2, g2 = got
    assert abs(float(c1) - float(c2)) <= tol * (1.0 + abs(float(c1)))
    for a, b, m in zip(r2, r1, masks):
        assert (a.numpy()[:, m == 0] == 0).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol * max(1.0, float(jnp.max(jnp.abs(b)))))
    if with_jacobian:
        np.testing.assert_allclose(g2.numpy(), np.asarray(g1), rtol=tol,
                                   atol=tol * float(jnp.max(jnp.abs(g1))))
        for ga, gb, m in zip(j2.jac_groups, j1.jac_groups, masks):
            for ta, tb in zip(ga, gb):
                assert (ta.numpy()[:, m == 0] == 0).all()
                np.testing.assert_allclose(ta.numpy(), np.asarray(tb), rtol=tol,
                                           atol=tol * max(1.0, float(jnp.max(jnp.abs(tb)))))


@pytest.mark.parametrize("with_jacobian", [True, False], ids=["jac", "residual_only"])
@pytest.mark.parametrize("case", B1_CASES)
def test_masked_b1_plain_matches_pallas_group_kernel_f32(monkeypatch, case, with_jacobian):
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    # the JAX FoE functors close over float64 taps under x64, which would
    # promote the float32 kernel's values: that side runs without it
    with jax.enable_x64(not case.startswith("foe")):
        jp, tp = _b1_problems(case)
        want, got, masks = _masked(jp, tp, jnp.float32, torch.float32, with_jacobian)
    _check_masked(want, got, masks, 5e-4, with_jacobian)


@pytest.mark.parametrize("case", B1_CASES)
def test_masked_b1_plain_matches_xla_f64(case):
    jp, tp = _b1_problems(case)
    want, got, masks = _masked(jp, tp, jnp.float64, F64, True)
    _check_masked(want, got, masks, 1e-12, True)


# ------------------------------------------------------ the rank's device


@pytest.mark.parametrize("backend", [None, "gloo", "nccl"])
def test_initialize_without_a_card_or_a_device_raises(monkeypatch, backend):
    """No device named and no card visible: raise before joining a group,
    never a rank on the CPU that nobody asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        distributed.initialize(backend, "tcp://localhost:1", 1, 0)
    assert not torch.distributed.is_initialized()


def test_solve_refuses_an_options_device_that_is_not_the_meshs():
    class CpuMesh:  # a mesh whose rank lives on the CPU
        axis_names, device = ("dp",), torch.device("cpu")

    problem = ct.build_ba_problem(synthetic_bal(6, 50, 203, seed=3))[0]
    with pytest.raises(ValueError, match="not the mesh's device"):
        ct.solve(solve_options(ct, "ischur_schur_jacobi", mesh=CpuMesh(), device="cuda:0"),
                 problem)


# ----------------------------------------------- 2 spawned ranks (gloo)

CASES = ["eval"] + list(SOLVE_CASES) + list(PORT_ONLY_CASES)
# the per-iteration bar against ceres_tpu's sharded solve: 1e-10, but the
# mixed-precision solves, whose bfloat16 products round differently in the
# two packages (test_torch_mixed_precision.py's bar of 1e-3), and the line
# search, which amplifies summation-order rounding: there 10x ceres_tpu's
# own gap between its sharded and unsharded solves, measured here (as
# test_torch_line_search.py holds the port to 10x JAX's permuted gap)
JAX_RTOL = {"mixed_precision": 1e-3}
SELF_GAP_CASES = ("line_search",)
# the bar against the port's unsharded solve: 1e-6, but the mixed-precision
# solves, whose PCG counts the shards' summation order moves
PORT_RTOL = {"mixed_precision": 1e-3}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return torch_mp.start_ranks(
        str(tmp_path_factory.mktemp("ranks")), 2,
        {"mesh": "global", "threshold": THRESHOLD, "cases": CASES},
    )


@pytest.fixture(scope="module")
def references(started):
    """JAX's sharded results on a 2-device mesh and the port's unsharded
    solves, computed while the ranks run."""
    saved = JProgram.SEG_REDUCE_THRESHOLD, TProgram.SEG_REDUCE_THRESHOLD
    JProgram.SEG_REDUCE_THRESHOLD = TProgram.SEG_REDUCE_THRESHOLD = THRESHOLD
    try:
        mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
        seed, n_obs = EVAL_CASE
        program = j_build(synthetic_bal(6, 50, n_obs, seed=seed))[0].compile()
        state = program.state_vector()
        ev = JShardedEvaluator(program, mesh, dtype=state.dtype)
        cost, _, jac, grad = ev.evaluate_groups(state)
        v = jnp.asarray(np.random.default_rng(0).normal(0, 1, program.num_effective_parameters))
        delta = jnp.asarray(
            np.random.default_rng(1).normal(0, 0.01, program.num_effective_parameters))
        refs = {"eval": {
            "cost": float(cost), "gradient": np.asarray(grad),
            "jtj": np.asarray(jac.jtj_multiply(v)),
            "column_norms": np.asarray(jac.squared_column_norms()),
            "plus": np.asarray(ev.plus(state, delta)),
        }}
        for case, (_opts, seed) in SOLVE_CASES.items():
            bal = synthetic_bal(6, 50, 203, seed=seed)
            jp, _, jpts = j_build(bal, loss=ceres_tpu.HuberLoss(1.0))
            s_jax = ceres_tpu.solve(solve_options(ceres_tpu, case, mesh=mesh),
                                    constrain(jp, jpts, case))
            # unsharded, SUBSET needs its rows: the downgrade's JACOBI stands in
            unsharded = "cgnr_jacobi" if case == "subset" else case
            s_port = ct.solve(solve_options(ct, unsharded, device="cpu", dtype=F64),
                              solve_problem(ct, case, bal))
            refs[case] = {"jax": summary_record(s_jax), "port": summary_record(s_port)}
            if case in SELF_GAP_CASES:
                jp, _, jpts = j_build(bal, loss=ceres_tpu.HuberLoss(1.0))
                s_one = ceres_tpu.solve(solve_options(ceres_tpu, case), constrain(jp, jpts, case))
                refs[case]["jax_self_gap"] = _gap(summary_record(s_one), refs[case]["jax"])
        for case in PORT_ONLY_CASES:
            refs[case] = {"port": summary_record(ct.solve(
                solve_options(ct, case, device="cpu", dtype=F64), solve_problem(ct, case)))}
        return refs
    finally:
        JProgram.SEG_REDUCE_THRESHOLD, TProgram.SEG_REDUCE_THRESHOLD = saved


@pytest.fixture(scope="module")
def ranks(references, started):
    return torch_mp.collect(started)


def test_sharded_evaluation_matches_jax(references, ranks):
    want, got = references["eval"], ranks[0]["eval"]
    for key in ("cost", "gradient", "jtj", "column_norms", "plus"):
        gap = np.max(np.abs(np.asarray(got[key]) - want[key]) / np.maximum(np.abs(want[key]), 1e-300))
        print(f"sharded evaluation: {key} largest rel gap to ceres_tpu's {gap:.3e}")
    assert got["plans"] == {1: "bucket_sharded", 0: "onehot"}
    assert ranks[0]["eval"]["lanes"] == ranks[1]["eval"]["lanes"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-12)
    np.testing.assert_allclose(got["gradient"], want["gradient"], rtol=1e-10)
    np.testing.assert_allclose(got["jtj"], want["jtj"], rtol=1e-9)
    np.testing.assert_allclose(got["column_norms"], want["column_norms"], rtol=1e-10)
    np.testing.assert_allclose(got["plus"], want["plus"], rtol=1e-12)
    for r in ranks:  # the reductions reach every rank
        np.testing.assert_array_equal(r["eval"]["gradient"], got["gradient"])


def _gap(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got["cost"], want["cost"]))


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_sharded_solve_matches_jax_and_unsharded(references, ranks, case):
    got, want, port = ranks[0][case], references[case]["jax"], references[case]["port"]
    print(f"{case}: largest per-iteration gap to ceres_tpu's sharded solve "
          f"{_gap(got, want):.3e}, to the port's unsharded one {_gap(got, port):.3e}")
    if case not in JAX_RTOL:
        assert got["linear_solver_iterations"] == want["linear_solver_iterations"]
    assert got["step_is_successful"] == want["step_is_successful"]
    assert len(got["cost"]) == len(want["cost"])
    rtol = JAX_RTOL.get(case, 1e-10)
    if case in SELF_GAP_CASES:
        print(f"{case}: ceres_tpu's own sharded/unsharded gap {references[case]['jax_self_gap']:.3e}")
        rtol = max(rtol, 10 * references[case]["jax_self_gap"])
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=rtol)
    np.testing.assert_allclose(got["cost"], port["cost"], rtol=PORT_RTOL.get(case, 1e-6))
    assert got["all_reduces"] > 0


@pytest.mark.parametrize("case", list(PORT_ONLY_CASES))
def test_sharded_solve_without_a_jax_counterpart_matches_unsharded(references, ranks, case):
    got, port = ranks[0][case], references[case]["port"]
    print(f"{case}: largest per-iteration gap to the port's unsharded solve {_gap(got, port):.3e}")
    assert got["step_is_successful"] == port["step_is_successful"]
    np.testing.assert_allclose(got["cost"], port["cost"], rtol=1e-6)
    assert got["all_reduces"] > 0


@pytest.mark.parametrize("case", list(SOLVE_CASES) + list(PORT_ONLY_CASES))
def test_ranks_stay_in_lockstep(ranks, case):
    assert ranks[0][case] == ranks[1][case]


# the cases that take the host loop on one process too (fused_loop.eligible)
HOST_LOOP_CASES = ("line_search", "inner_iterations")


@pytest.mark.parametrize("case", list(SOLVE_CASES) + list(PORT_ONLY_CASES))
def test_gloo_mesh_takes_the_host_loop(references, ranks, case):
    assert not ranks[0][case]["used_fused_execution"]
    assert references[case]["port"]["used_fused_execution"] == (case not in HOST_LOOP_CASES)


def test_subset_downgrades_with_warning(ranks):
    assert any("downgrading to JACOBI" in m for m in ranks[0]["subset"]["warnings"])
    assert ranks[0]["subset"]["cost"] == ranks[0]["cgnr_jacobi"]["cost"]
