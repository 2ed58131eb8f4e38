"""The fused loop's device side on the card: the PCG iteration, the
finish's head and tail, the evaluation, its prepare and the fused loop's
decide replayed from CUDA graphs, the launch counts under replay (and
that a capture takes back what it counted, at BAL-1778's size), and the
read budget, unbounded, bounded, with the line search and with CGNR on a
Fields-of-Experts problem (every group B1 generic); DOGLEG's prepare and
finish graphs and its read budget; SPARSE_SCHUR's S bitwise across
assemblies; the host solvers' counted reads; the pose graphs on B1
generic; the no-plan reduce (index_add_) bitwise from run to run; the line-search
minimizer's read budget; the inner-iteration sweep against the CPU; the
covariance's ITERATIVE_PCG against the CPU (the batched B2/B3), the batched
PCG's read budget, and the batched TinySolver against the CPU.

These tests need an NVIDIA GPU and skip without one. The file imports no
JAX: `python -m pytest --noconftest tests/test_torch_cuda_loop.py` runs it
on a machine that has only PyTorch. A replay runs the kernels the eager
iteration launched, on the same inputs, so the two agree bitwise (every
kernel of the iteration is deterministic: B4 has no atomics)."""

import dataclasses

import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch import cuda_lib
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.linalg import schur as tschur
from ceres_tpu_torch.solvers.trust_region import TrustRegionMinimizer
from ceres_tpu_torch.utils import execution_summary as es
from ceres_tpu_torch.utils import graphs as tgraphs
from ceres_tpu_torch.utils.graphs import StepGraph

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graphs and kernels have no CPU mode")
    return torch.device("cuda")


def _options(dtype, **kw):
    base = dict(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        eta=0.1, max_linear_solver_iterations=25, max_num_iterations=4,
        function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
        fused_execution_chunk_iters=1, logging_type=ct.LoggingType.SILENT,
        device="cuda", dtype=dtype,
    )
    return ct.SolverOptions(**{**base, **kw})


def _problem(seed=2):
    # 40,000 observations: the layout plans engage, so B4 is the matvec
    bal = ct.synthetic_bal(32, 4000, 40_000, seed=seed)
    return ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]


def _finish_case(card, dtype):
    """(program, options, jac_s, grad_s, cache) of one Jacobi-scaled
    Jacobian, prepared for SCHUR_JACOBI."""
    program = _problem().compile(card)
    ev = Evaluator(program, dtype)
    _, _, jac, grad = ev.evaluate_groups(program.state_vector(dtype))
    scale = 1.0 / (1.0 + torch.sqrt(jac.squared_column_norms()))
    options = _options(dtype)
    jac_s = jac.scale_columns(scale)
    return program, options, jac_s, grad * scale, tschur.schur_prepare(program, options, jac_s)


def _solve_step(program, options, jac_s, grad_s, cache, radius, graph=None):
    dsq = torch.clamp(cache["colnorm2"], options.min_lm_diagonal, options.max_lm_diagonal) / radius
    inter = tschur.schur_finish_rhs(program, options, jac_s, grad_s, dsq, cache)
    return tschur.schur_finish_solve(program, options, jac_s, grad_s, dsq, cache, inter, graph)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pcg_graph_replays_equal_the_eager_iterations(card, dtype):
    case = _finish_case(card, dtype)
    graph = StepGraph("pcg")
    g0 = es.counts()
    graphed = [_solve_step(*case, radius, graph) for radius in (1e4, 1e2, 1e4)]
    g1 = es.counts()
    eager = [_solve_step(*case, radius) for radius in (1e4, 1e2, 1e4)]
    torch.cuda.synchronize()
    for (s_g, it_g), (s_e, it_e) in zip(graphed, eager):
        assert int(it_g) == int(it_e) >= 2
        assert torch.equal(s_g, s_e)
    # each solve's inverse tables are new tensors here (no head graph), so
    # each solve captures anew: its first iteration is the eager warm-up,
    # every other iteration a replay
    assert g1["CUDAGraph::Capture"] - g0["CUDAGraph::Capture"] == 3
    replays = g1["CUDAGraph::Replay pcg"] - g0["CUDAGraph::Replay pcg"]
    assert replays == sum(int(it) for _, it in graphed) - 3


def test_launch_counts_under_replay(card):
    case = _finish_case(card, torch.float32)
    graph = StepGraph("pcg")
    es.reset_counts()
    iters = [int(_solve_step(*case, radius, graph)[1]) for radius in (1e4, 3e3, 1e3)]
    counts = es.counts()
    assert graph.counts_per_replay == {"schur_sy": 1}
    # one S·y for r0 = b - A x0 per solve, one per PCG iteration (the
    # warm-up eager, the others replayed): N replays count N launches
    assert counts["schur_sy"] == sum(1 + k for k in iters)


def test_a_capture_takes_back_what_it_counted_at_bal_1778(card):
    """chip_smoke's main run (BAL-1778 whole, float32, SCHUR_JACOBI, the
    fused loop one iteration a chunk) twice from the same start: the first
    solve warms up and captures its six graphs, the second replays them.
    Each capture takes back the one counter-table diff it counted and each
    replay adds it once, so the two solves count the same launches, and
    each graph's replays in the second are its replays and captures in the
    first."""
    from chip_smoke import NUM_OBSERVATIONS, NUM_POINTS, lm_options

    bal = ct.synthetic_bal(1778, NUM_POINTS, NUM_OBSERVATIONS, seed=0)
    problem = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]
    program = problem.compile("cuda")
    x0 = program.state0.copy()
    options = lm_options("cuda", torch.float32, fused_execution_chunk_iters=1)
    summaries, launches, graphs = [], [], []
    for _ in range(2):
        program.write_state_back(x0)
        before = es.counts()
        summaries.append(ct.solve(options, problem))
        counted = es.counts() - before
        launches.append({k: n for k, n in counted.items() if k in cuda_lib.LAUNCHES})
        graphs.append({k: n for k, n in counted.items() if k.startswith("CUDAGraph::")})
    first, second = summaries
    assert first.used_fused_execution and second.used_fused_execution
    assert [(it.cost, it.linear_solver_iterations) for it in second.iterations] == [
        (it.cost, it.linear_solver_iterations) for it in first.iterations]
    assert graphs[0]["CUDAGraph::Capture"] == 6 and "CUDAGraph::Capture" not in graphs[1]
    for name, n in graphs[1].items():
        if name.startswith("CUDAGraph::Replay "):
            captured = first.execution_summary.calls(name.replace("Replay", "Capture"))
            assert n == graphs[0].get(name, 0) + captured, name
    assert launches[0] == launches[1]
    assert launches[1]["eval_snavely"] > 0 and launches[1]["schur_sy"] > 0
    print(f"BAL-1778 launches: {launches[1]}")


def _bounded_problem(seed):
    """The problem of _problem with an upper bound a little above the start
    on coordinate 1 of every other point: below the optimum for some."""
    bal = ct.synthetic_bal(32, 4000, 40_000, seed=seed)
    problem, _, pts = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    for i in range(0, 4000, 2):
        problem.set_parameter_upper_bound(pts[i], 1, bal.points[i, 1] + 0.002)
    return problem


def _cluster(kind, clustering):
    return {"preconditioner_type": getattr(ct.PreconditionerType, kind),
            "visibility_clustering_type": getattr(ct.VisibilityClusteringType, clustering)}


def _foe_problem(seed):
    """A Fields-of-Experts denoising problem (200 x 180, 3x3 cliques, K =
    3): every group B1 generic, the layout plans engaged (35,244 cliques
    per filter), no onehot plan on the pixel class."""
    from ceres_tpu_torch.examples import denoising

    img = denoising.synthetic_noisy_image(200, 180, seed=seed)
    return denoising.build_foe_denoising_problem(
        img, denoising.synthetic_foe_model(3, 3, seed=seed))[0]


LOOP_CASES = {
    # (problem, options, graphs replayed besides the PCG's: per iteration,
    # per accepted step); the PCG replays where the finish's head does
    "plain": (_problem, {}, ("finish_head", "finish_tail", "decide"), ("evaluate", "prepare")),
    # the step unsplit and eager, the line search eager
    "bounded": (_bounded_problem, {}, ("decide",), ("evaluate",)),
    "line_search": (
        _problem, {"trust_region_use_line_search": True},
        ("finish_head", "finish_tail", "decide"), ("evaluate", "prepare"),
    ),
    # the visibility preconditioners: the step unsplit (schur_solve), eager
    "cluster_jacobi": (
        _problem, _cluster("CLUSTER_JACOBI", "CANONICAL_VIEWS"), ("decide",), ("evaluate",)),
    # CGNR, unsplit: its head, PCG iteration and tail graphs (PCG <= 10
    # steps: the prior's normal equations are ill-conditioned, and a 25-step
    # PCG amplifies the card's and the CPU's different summation orders)
    "cgnr": (
        _foe_problem, {"linear_solver_type": ct.LinearSolverType.CGNR,
                       "preconditioner_type": ct.PreconditionerType.JACOBI,
                       "max_linear_solver_iterations": 10},
        ("cgnr_head", "cgnr_tail", "decide"), ("evaluate",)),
    "cluster_tridiagonal": (
        _problem, _cluster("CLUSTER_TRIDIAGONAL", "SINGLE_LINKAGE"), ("decide",), ("evaluate",)),
}


# how far two CGNR runs of one minimizer may part, relative, per iteration:
# a few ulps. Observed: 0 in 6 runs of each dtype on an H100 (no two
# cliques of one position share a pixel, so each index_add_ of the matvec
# adds once to each entry and its atomics never meet)
CGNR_RUN_SPREAD = {torch.float32: 1e-6, torch.float64: 1e-13}


@pytest.mark.parametrize("case", list(LOOP_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_loop_syncs_only_through_counted_reads(card, dtype, case):
    """The fused loop runs under set_sync_debug_mode("error"): only the
    counting read helper may synchronize, and an LM iteration reads at most
    2 + its PCG iterations times (the line search adds one to start and one
    per cost evaluation). A first run of the same minimizer fills the
    Program's one-time device tables (the visibility plan's among them) and
    captures every graph (a capture synchronizes); the Evaluator's uploads
    happen before the mode is set. In float64 the run matches the CPU's to
    1e-9 with equal PCG counts."""
    make_problem, extra, per_iter, per_accept = LOOP_CASES[case]
    options = _options(dtype, **extra)
    program = make_problem(3).compile(card)
    assert program.has_bounds == (case == "bounded")
    ev = Evaluator(program, dtype)
    minimizer = TrustRegionMinimizer(program, options, ev)
    warm = ct.Summary()
    minimizer.minimize(program.state_vector(dtype), warm)
    assert warm.used_fused_execution and warm.num_successful_steps >= 2
    state = program.state_vector(dtype)
    summary = ct.Summary()
    g0 = es.counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        minimizer.minimize(state, summary)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g1 = es.counts()
    assert summary.used_fused_execution and len(summary.iterations) == 5
    costs, warm_costs = ([it.cost for it in s.iterations] for s in (summary, warm))
    if case == "cgnr":
        # CGNR runs are not required to be bitwise (index_add_ adds
        # atomically on the card); held to a few float32 (float64) ulps
        spread = max(abs(x - y) / abs(y) for x, y in zip(costs, warm_costs))
        assert spread <= CGNR_RUN_SPREAD[dtype], spread
        assert ([it.linear_solver_iterations for it in summary.iterations]
                == [it.linear_solver_iterations for it in warm.iterations])
    else:
        assert costs == warm_costs
    ls = summary.num_line_search_steps
    assert (ls > 0) == (case in ("bounded", "line_search"))
    budget = [2 + it.linear_solver_iterations for it in summary.iterations[1:]]
    reads = [it.num_device_reads for it in summary.iterations[1:]]
    if ls == 0:
        assert all(r <= b for r, b in zip(reads, budget))
    assert sum(reads) <= sum(budget) + (len(reads) + ls if ls else 0)
    pcg = int("finish_head" in per_iter or "cgnr_head" in per_iter)
    for it in summary.iterations[1:]:
        assert it.num_graph_replays == (
            pcg * it.linear_solver_iterations + len(per_iter)
            + len(per_accept) * it.step_is_successful
        )
    by = g1 - g0
    assert by["CUDAGraph::Replay pcg"] == pcg * sum(
        it.linear_solver_iterations for it in summary.iterations)
    assert all(by[f"CUDAGraph::Replay {name}"] == 4 for name in per_iter)
    # the first evaluation (and its prepare) replays too
    assert all(by[f"CUDAGraph::Replay {name}"] == summary.num_successful_steps + 1
               for name in per_accept)
    assert by["CUDAGraph::Capture"] == 0
    if dtype == torch.float64:
        problem_cpu = make_problem(3)
        cpu = ct.solve(_options(dtype, **{**extra, "device": "cpu"}), problem_cpu)
        assert len(cpu.iterations) == len(summary.iterations)
        for a, b in zip(summary.iterations, cpu.iterations):
            assert a.cost == pytest.approx(b.cost, rel=1e-9)
            assert a.linear_solver_iterations == b.linear_solver_iterations
            assert a.step_is_successful == b.step_is_successful
        assert summary.num_line_search_steps == cpu.num_line_search_steps


@pytest.mark.parametrize("dtype", DTYPES)
def test_mixed_fused_loop_syncs_only_through_counted_reads(card, dtype):
    """use_mixed_precision_solves on the fused loop under
    set_sync_debug_mode("error"): at most 2 + its PCG iterations reads per
    iteration, the PCG graph replays B4's bfloat16 instantiation and never
    its float32 one, and in float64 the run follows the CPU's (the matvec's
    float32 sums run in another order on the card: cost 1e-6, the same PCG
    counts and decisions)."""
    options = _options(dtype, use_mixed_precision_solves=True)
    program = _problem().compile(card)
    minimizer = TrustRegionMinimizer(program, options, Evaluator(program, dtype))
    warm = ct.Summary()
    minimizer.minimize(program.state_vector(dtype), warm)
    assert warm.used_fused_execution and warm.num_successful_steps >= 2
    state = program.state_vector(dtype)
    summary = ct.Summary()
    g0 = es.counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        minimizer.minimize(state, summary)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = es.counts() - g0
    assert counts["CUDAGraph::Capture"] == 0
    assert [it.cost for it in summary.iterations] == [it.cost for it in warm.iterations]
    for it in summary.iterations[1:]:
        assert it.num_device_reads <= 2 + it.linear_solver_iterations
    pcg = sum(it.linear_solver_iterations for it in summary.iterations)
    assert counts["schur_sy_bf16"] >= pcg > 0 and counts["schur_sy"] == 0
    assert counts["schur_p0"] > 0  # the SCHUR_JACOBI blocks stay float32
    if dtype == torch.float64:
        cpu = ct.solve(_options(dtype, use_mixed_precision_solves=True, device="cpu"), _problem())
        assert len(cpu.iterations) == len(summary.iterations)
        for a, b in zip(summary.iterations, cpu.iterations):
            assert a.cost == pytest.approx(b.cost, rel=1e-6)
            assert a.linear_solver_iterations == b.linear_solver_iterations
            assert a.step_is_successful == b.step_is_successful


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_graphs_equal_the_eager_fused_loop(card, dtype, monkeypatch):
    """The fused loop with its graphs (evaluate, prepare, the finish's head,
    PCG iteration and tail, decide) against the same loop run eagerly: the
    replays run the kernels the eager calls launch, on the same inputs, so
    every iteration agrees bitwise."""
    graphed = ct.solve(_options(dtype), _problem(seed=4))
    with monkeypatch.context() as m:
        m.setattr(tgraphs, "step_graph", lambda name, device: None)
        m.setattr(tgraphs, "fn_graph", lambda name, device: None)
        eager = ct.solve(_options(dtype), _problem(seed=4))
    assert graphed.num_graph_replays > 0 and eager.num_graph_replays == 0
    for a, b in zip(graphed.iterations, eager.iterations, strict=True):
        assert (a.cost, a.trust_region_radius, a.gradient_max_norm, a.step_norm) == (
            b.cost, b.trust_region_radius, b.gradient_max_norm, b.step_norm)
        assert a.linear_solver_iterations == b.linear_solver_iterations


@pytest.mark.parametrize("kind", ["CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_visibility_builds_are_bitwise_equal(card, dtype, kind):
    """Two builds of a visibility preconditioner from the same Jacobian give
    bitwise-equal factors and applies: the pair blocks are summed per
    destination in a fixed order (segment_reduce over host-sorted pairs,
    then one add per block), with no atomics racing."""
    from ceres_tpu_torch.linalg.visibility import VisibilityPreconditioner

    program, options, jac_s, grad_s, _cache = _finish_case(card, dtype)
    dsq = torch.clamp(jac_s.squared_column_norms(), 1e-6, 1e32) / 1e3
    e_mask, f_mask = tschur._masks(program, dsq)
    jac_e, jac_f = tschur.schur_views(program, jac_s.materialize_scale())
    ete = tschur.make_ete_solver(program, jac_e, dsq * e_mask)
    clustering = ct.VisibilityClusteringType.CANONICAL_VIEWS
    if kind == "CLUSTER_TRIDIAGONAL":
        clustering = ct.VisibilityClusteringType.SINGLE_LINKAGE
    kind = getattr(ct.PreconditionerType, kind)
    builds = [VisibilityPreconditioner(program, jac_e, jac_f, ete, dsq * f_mask, kind, clustering)
              for _ in range(2)]
    for a, b in zip(builds[0].factors, builds[1].factors, strict=True):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    r = grad_s * f_mask
    assert torch.equal(builds[0](r), builds[1](r))


@pytest.mark.parametrize("dtype", DTYPES)
def test_explicit_schur_assembly_is_bitwise(card, dtype):
    """SPARSE_SCHUR's S from the same Jacobian twice: bitwise equal (each
    slot's pair blocks summed in a fixed order, segment_reduce over
    host-sorted pairs, then one add per slot), and finite."""
    from ceres_tpu_torch.linalg.explicit_schur import ExplicitSchurPlan

    program, _options_, jac_s, _grad_s, _cache = _finish_case(card, dtype)
    dsq = torch.clamp(jac_s.squared_column_norms(), 1e-6, 1e32) / 1e3
    e_mask, f_mask = tschur._masks(program, dsq)
    jac_e, jac_f = (v.materialize_scale() for v in tschur.schur_views(program, jac_s))
    ete = tschur.make_ete_solver(program, jac_e, dsq * e_mask)
    plan = ExplicitSchurPlan.get(program, jac_e, jac_f)
    ftf = jac_f.block_diag_jtj(dsq=dsq * f_mask)[plan.cam_cls]
    s1, s2 = (plan.assemble(jac_e, jac_f, ete, ftf) for _ in range(2))
    assert torch.isfinite(s1).all() and torch.equal(s1, s2)


def _dogleg(kind, dtype):
    return _options(dtype, trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
                    dogleg_type=getattr(ct.DoglegType, kind), initial_trust_region_radius=1.0)


@pytest.mark.parametrize("kind", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dogleg_fused_loop_syncs_only_through_counted_reads(card, dtype, kind):
    """DOGLEG on the fused loop under set_sync_debug_mode("error"), after a
    first run that captures every graph: the prepare (its head, PCG and
    Cauchy graphs) runs in the iteration that takes its cache, so an
    iteration reads at most 2 + its PCG steps; the finish and decide replay
    once per iteration; the run repeats the first bitwise; B1-B3 run, B4
    and B5 do not. In float64 it matches the CPU's to 1e-9."""
    options = _dogleg(kind, dtype)
    program = _problem(3).compile(card)
    minimizer = TrustRegionMinimizer(program, options, Evaluator(program, dtype))
    warm = ct.Summary()
    minimizer.minimize(program.state_vector(dtype), warm)
    state = program.state_vector(dtype)
    summary = ct.Summary()
    g0 = es.counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        minimizer.minimize(state, summary)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = es.counts() - g0
    assert summary.used_fused_execution and len(summary.iterations) == 5
    assert [it.cost for it in summary.iterations] == [it.cost for it in warm.iterations]
    for it in summary.iterations[1:]:
        assert it.num_device_reads <= 2 + it.linear_solver_iterations
    assert counts["CUDAGraph::Replay dogleg_finish"] == counts["CUDAGraph::Replay decide"] == 4
    prepares = 1 + sum(it.step_is_successful for it in summary.iterations[1:-1])
    assert counts["CUDAGraph::Replay dogleg_head"] == counts["CUDAGraph::Replay dogleg_cauchy"] \
        == prepares
    assert counts["CUDAGraph::Capture"] == 0
    assert all(counts[k] > 0 for k in ("eval_snavely", "gather_contract", "contract_reduce"))
    assert counts["schur_sy"] == counts["schur_p0"] == 0
    if dtype == torch.float64:
        cpu = ct.solve(dataclasses.replace(options, device="cpu"), _problem(3))
        for a, b in zip(summary.iterations, cpu.iterations, strict=True):
            assert a.cost == pytest.approx(b.cost, rel=1e-9)
            assert (a.linear_solver_iterations, a.step_is_successful) == (
                b.linear_solver_iterations, b.step_is_successful)


HOST_SOLVERS = {
    "sparse_normal_cholesky": ({"linear_solver_type": ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY},
                               "SparseCholesky"),
    "sparse_schur": ({"linear_solver_type": ct.LinearSolverType.SPARSE_SCHUR}, "SparseSchur"),
    "cgnr_subset": ({"linear_solver_type": ct.LinearSolverType.CGNR,
                     "preconditioner_type": ct.PreconditionerType.SUBSET,
                     "initial_trust_region_radius": 1.0,
                     "residual_blocks_for_subset_preconditioner": list(range(0, 40_000, 2))},
                    "SubsetPreconditioner"),
}


@pytest.mark.parametrize("case", list(HOST_SOLVERS))
def test_host_factorizations_are_counted_reads(card, case):
    """The host solvers in float64 on the card: what each factorization
    brings over is a counted read (the solve's reads equal the count its
    execution summary records), each step's read and factorization are
    recorded with their bytes, and the iterations match the CPU's to
    1e-9."""
    extra, name = HOST_SOLVERS[case]
    summary = ct.solve(_options(torch.float64, **extra), _problem(3))
    cpu = ct.solve(_options(torch.float64, device="cpu", **extra), _problem(3))
    ex = summary.execution_summary
    assert not summary.used_fused_execution
    assert ex.calls("Device::Read") == summary.num_device_reads
    assert ex.calls(f"{name}::Read") == summary.num_linear_solves
    assert ex.nbytes(f"{name}::Read") > 0
    if case == "sparse_schur":
        assert ex.calls("SparseSchur::Explicit") == summary.num_linear_solves
    for a, b in zip(summary.iterations, cpu.iterations, strict=True):
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
        assert (a.linear_solver_iterations, a.step_is_successful) == (
            b.linear_solver_iterations, b.step_is_successful)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_pose_graphs_launch_b1_generic(card, tmp_path, dim):
    """Both pose graphs on SPARSE_NORMAL_CHOLESKY in float64: the group
    takes B1 generic at every evaluation, and the iterations match the
    CPU's to 1e-9."""
    from chip_smoke import small_sphere_problem

    from ceres_tpu_torch.examples import pose_graph

    def build():
        if dim == "2d":
            g, _ = pose_graph.synthetic_pose_graph_2d(n=200, seed=0)
            return pose_graph.build_pose_graph_2d_problem(g)[0]
        return small_sphere_problem(str(tmp_path))[0]

    options = dict(linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY)
    es.reset_counts()
    summary = ct.solve(_options(torch.float64, **options), build())
    counts = es.counts()
    cpu = ct.solve(_options(torch.float64, device="cpu", **options), build())
    assert counts["eval_generic"] == summary.num_jacobian_evaluations > 0
    assert counts["eval_generic_residual"] == summary.num_residual_evaluations
    for a, b in zip(summary.iterations, cpu.iterations, strict=True):
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
    assert summary.final_cost < summary.initial_cost


def _sphere_problem(tmp_path):
    """The sphere2500-shaped 3D pose graph (chip_smoke.SPHERE_RINGS: 2,500
    poses, 4,949 edges), below SEG_REDUCE_THRESHOLD: its Jᵀ reductions take
    the no-plan branch of jacobian.reduce_T."""
    from chip_smoke import SPHERE_RINGS, write_sphere_g2o

    from ceres_tpu_torch.examples import pose_graph

    path = tmp_path / "sphere.g2o"
    if not path.exists():
        write_sphere_g2o(str(path), *SPHERE_RINGS, seed=0)
    return pose_graph.build_pose_graph_3d_problem(pose_graph.load_g2o_3d(str(path)))[0]


DETERMINISM_CASES = {
    "sparse_normal_cholesky": {"linear_solver_type": ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY},
    "cgnr_jacobi": {"linear_solver_type": ct.LinearSolverType.CGNR,
                    "preconditioner_type": ct.PreconditionerType.JACOBI},
    "lbfgs": {"minimizer_type": ct.MinimizerType.LINE_SEARCH,
              "line_search_direction_type": ct.LineSearchDirectionType.LBFGS},
}


@pytest.mark.parametrize("case", list(DETERMINISM_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_no_plan_reduce_is_bitwise_from_run_to_run(card, tmp_path, dtype, case):
    """Two solves of the sphere2500-shaped graph on the card are bitwise
    equal, per iteration and in the final state, though its Jᵀ reductions
    take index_add_, whose atomics meet where edges share a pose (the
    guard of the ROADMAP Queue C item: measured, not a fault)."""
    runs = []
    for _ in range(2):
        problem = _sphere_problem(tmp_path)
        summary = ct.solve(_options(dtype, max_num_iterations=5, **DETERMINISM_CASES[case]),
                           problem)
        assert summary.final_cost < summary.initial_cost
        runs.append(([it.cost for it in summary.iterations], problem.compile().state0.copy()))
    assert runs[0][0] == runs[1][0]
    assert (runs[0][1] == runs[1][1]).all()


LINE_SEARCH = dict(minimizer_type=ct.MinimizerType.LINE_SEARCH,
                   line_search_direction_type=ct.LineSearchDirectionType.LBFGS,
                   line_search_type=ct.LineSearchType.WOLFE, max_num_iterations=6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_line_search_syncs_only_through_counted_reads(card, dtype):
    """L-BFGS + WOLFE under set_sync_debug_mode("error"), after a first run
    that captures the evaluate graph: an iteration reads at most 2 + its
    line-search trials (3 + trials on a restart); the run repeats the first
    bitwise; B1 and B3 run, B4 and B5 do not; the gradient's graph replays
    once per gradient evaluation. In float64 it matches the CPU's to 1e-9."""
    from ceres_tpu_torch.solvers.line_search import LineSearchMinimizer

    options = _options(dtype, **LINE_SEARCH)
    program = _problem(3).compile(card)
    minimizer = LineSearchMinimizer(program, options, Evaluator(program, dtype))
    warm = ct.Summary()
    minimizer.minimize(program.state_vector(dtype), warm)
    state = program.state_vector(dtype)
    summary = ct.Summary()
    g0 = es.counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        minimizer.minimize(state, summary)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = es.counts() - g0
    assert len(summary.iterations) == 7
    assert [it.cost for it in summary.iterations] == [it.cost for it in warm.iterations]
    for it in summary.iterations[1:]:
        assert it.line_search_iterations >= 1
        assert it.num_device_reads - it.line_search_iterations in (2, 3)
        assert it.num_graph_replays == it.line_search_iterations  # one gradient per trial
    assert counts["CUDAGraph::Replay evaluate"] == summary.num_jacobian_evaluations
    assert counts["CUDAGraph::Capture"] == 0
    assert counts["eval_snavely"] == summary.num_jacobian_evaluations + summary.num_residual_evaluations
    assert counts["contract_reduce"] > 0
    assert counts["schur_sy"] == counts["schur_p0"] == 0
    if dtype == torch.float64:
        cpu = ct.solve(dataclasses.replace(options, device="cpu"), _problem(3))
        for a, b in zip(summary.iterations, cpu.iterations, strict=True):
            assert a.cost == pytest.approx(b.cost, rel=1e-9)
            assert a.step_size == pytest.approx(b.step_size, rel=1e-7)
        assert summary.num_jacobian_evaluations == cpu.num_jacobian_evaluations


def test_inner_iteration_sweep_matches_the_cpu(card):
    """One sweep on the card (B1's e-leaf, B3's reduce of the camera-free
    point blocks through the bucket plan) against the CPU's plain version in
    float64, 1e-10; then LM with use_inner_iterations on the host loop, the
    sweep from its graph, per iteration within 1e-9 of the CPU with equal
    inner-iteration steps."""
    from ceres_tpu_torch.solvers.inner_iterations import make_inner_iteration_fn

    dtype = torch.float64
    options = _options(dtype, use_inner_iterations=True)
    sweeps = {}
    for dev in ("cuda", "cpu"):
        program = _problem(3).compile(dev)
        sweep = make_inner_iteration_fn(program, options, Evaluator(program, dtype))
        sweeps[dev] = sweep(program.state_vector(dtype),
                            torch.tensor(1e-4, dtype=dtype, device=dev)).cpu()
    err = ((sweeps["cuda"] - sweeps["cpu"]).abs().max() / sweeps["cpu"].abs().max()).item()
    assert err <= 1e-10, err
    g0 = es.counts()
    summary = ct.solve(options, _problem(3))
    g1 = es.counts()
    cpu = ct.solve(dataclasses.replace(options, device="cpu"), _problem(3))
    assert not summary.used_fused_execution
    assert summary.num_inner_iteration_steps == cpu.num_inner_iteration_steps > 0
    assert (g1 - g0)["CUDAGraph::Replay inner_sweep"] >= summary.num_inner_iteration_steps
    for a, b in zip(summary.iterations, cpu.iterations, strict=True):
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
        assert (a.linear_solver_iterations, a.step_is_successful) == (
            b.linear_solver_iterations, b.step_is_successful)


def _gauge_fixed_covariance_problem():
    """A BA problem large enough for the layout plans, gauge fixed, with
    the points seen by fewer than two cameras constant; 8 camera blocks and
    one cross block (chip_smoke.gauge_fixed_ba)."""
    from chip_smoke import gauge_fixed_ba

    problem, pairs, _ = gauge_fixed_ba(ct.synthetic_bal(32, 8000, 40_000, seed=3))
    return problem, pairs


def test_iterative_pcg_covariance_matches_cpu(card):
    import numpy as np

    covs = {}
    for dev in ("cpu", card):
        problem, pairs = _gauge_fixed_covariance_problem()
        covs[str(dev)] = cov = ct.Covariance(ct.CovarianceOptions(
            algorithm_type=ct.CovarianceAlgorithmType.ITERATIVE_PCG,
            iterative_max_iterations=20_000, device=dev))
        assert cov.compute(pairs, problem)
    gpu, cpu = covs["cuda"], covs["cpu"]
    assert np.array_equal(gpu.pcg_stats["iterations"], cpu.pcg_stats["iterations"])
    launches = gpu.pcg_stats["launches"]
    assert launches["gather_contract_batched"] > 0 and launches["contract_reduce_batched"] > 0
    assert "gather_contract" not in launches and "contract_reduce" not in launches
    assert gpu.pcg_stats["reads"] <= int(gpu.pcg_stats["iterations"].max()) + 1
    for bi, bj in pairs:
        want = cpu.get_covariance_block(bi, bj)
        np.testing.assert_allclose(gpu.get_covariance_block(bi, bj), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())


def test_batched_pcg_syncs_only_through_counted_reads(card):
    """The covariance's batched PCG reads one flag per step and synchronizes
    nowhere else."""
    from ceres_tpu_torch.linalg.cg import conjugate_gradients
    from ceres_tpu_torch.linalg.preconditioners import BlockDiagSolver

    problem, _ = _gauge_fixed_covariance_problem()
    program = problem.compile(card)
    _, _, jac, _ = Evaluator(program, torch.float64).evaluate_groups(
        program.state_vector(torch.float64))
    prec = BlockDiagSolver(program, jac.block_diag_jtj())
    b = torch.zeros((12, program.num_effective_parameters), dtype=torch.float64, device=card)
    b[torch.arange(12, device=card), torch.arange(12, device=card) * 7] = 1.0
    torch.cuda.synchronize()
    reads = es.counts()["Device::Read"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = conjugate_gradients(jac.jtj_multiply_batched, b, preconditioner=prec.apply_batched,
                                  max_iterations=200, tolerance=1e-10, batched=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps = int(res.iterations.max())
    assert steps < 200 and es.counts()["Device::Read"] - reads == steps
    assert bool(res.converged.all()) and not bool(res.breakdown.any())


def test_tiny_solve_batched_matches_cpu(card):
    import numpy as np

    def freudenstein_roth(x):
        return torch.stack([-13.0 + x[0] + ((5.0 - x[1]) * x[1] - 2.0) * x[1],
                            -29.0 + x[0] + ((x[1] + 1.0) * x[1] - 14.0) * x[1]])

    x0 = np.random.default_rng(2).uniform(-20, 20, (4096, 2))
    gpu = ct.tiny_solve_batched(freudenstein_roth, torch.tensor(x0, device=card))
    cpu = ct.tiny_solve_batched(freudenstein_roth, torch.tensor(x0))
    assert torch.equal(gpu.iterations.cpu(), cpu.iterations)
    assert torch.equal(gpu.converged.cpu(), cpu.converged)
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=1e-10, atol=1e-10)
    one = ct.tiny_solve(freudenstein_roth, x0[0], device=card)
    assert int(one.iterations) == int(cpu.iterations[0]) and one.x.device.type == "cuda"
