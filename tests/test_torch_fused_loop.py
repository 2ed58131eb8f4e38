"""The port's fused device loop (ceres_tpu_torch/solvers/fused_loop.py)
against its own host loop and against the JAX package's fused loop; bounds,
the projected line search and the device-resident PCG.

CPU, float64, small problems (synthetic_bal(6, 50, 200, seed=4), the
problem of tests/test_fused_loop.py). Tolerances: the port's fused loop
makes the host loop's decisions in the same float64 arithmetic, so their
per-iteration costs agree to 1e-12 relative; against the JAX package the
sums run in another order, so costs agree to 1e-10 and the radius to 1e-10
plus the costs' rounding amplified by cost / |cost change| (as in
tests/test_torch_solve.py). PCG counts and accept flags are equal
everywhere."""

import gc
import weakref

import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.linalg.cg import conjugate_gradients as j_cg
from ceres_tpu_torch.linalg.cg import conjugate_gradients as t_cg
from ceres_tpu_torch.program import Program as TProgram
from ceres_tpu_torch.utils import graphs as tgraphs
from ceres_tpu_torch.utils.execution_summary import counts
from ceres_tpu_torch.utils.graphs import FnGraph, StepGraph

torch.set_num_threads(1)

# points whose coordinate 1 gets an upper bound a little above its starting
# value: below the optimum for about half of them
BOUNDED_POINTS = tuple(range(0, 50, 2))
SLACK = 0.002


def _options(pkg, **kw):
    base = dict(
        linear_solver_type=pkg.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=pkg.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=25,
    )
    if pkg is ct:
        base["device"] = "cpu"
    return pkg.SolverOptions(**{**base, **kw})


def _solve(pkg, bounded=False, seed=4, **kw):
    bal = synthetic_bal(6, 50, 200, seed=seed)
    build = ct.build_ba_problem if pkg is ct else j_build
    problem, _, pts = build(bal)
    if bounded:
        for i in BOUNDED_POINTS:
            problem.set_parameter_upper_bound(pts[i], 1, bal.points[i, 1] + SLACK)
    summary = pkg.solve(_options(pkg, **kw), problem)
    return summary, problem, pts, bal


def _assert_same_run(a, b, cost_rel, radius=False):
    assert len(a.iterations) == len(b.iterations)
    for x, y in zip(a.iterations, b.iterations):
        assert x.iteration == y.iteration
        assert x.cost == pytest.approx(y.cost, rel=cost_rel)
        assert x.linear_solver_iterations == y.linear_solver_iterations
        assert (x.step_is_valid, x.step_is_successful) == (y.step_is_valid, y.step_is_successful)
        if radius:
            rtol = cost_rel + (1e-13 * y.cost / abs(y.cost_change) if y.cost_change else 0.0)
            assert x.trust_region_radius == pytest.approx(y.trust_region_radius, rel=rtol)
    assert a.termination_type.value == b.termination_type.value
    assert (a.num_successful_steps, a.num_unsuccessful_steps) == (
        b.num_successful_steps, b.num_unsuccessful_steps)
    assert a.final_cost == pytest.approx(b.final_cost, rel=cost_rel)


@pytest.mark.parametrize("nonmono", [False, True])
def test_fused_matches_host_loop(nonmono):
    kw = dict(use_nonmonotonic_steps=nonmono, max_consecutive_nonmonotonic_steps=3)
    fused = _solve(ct, **kw)[0]
    host = _solve(ct, fused_execution=False, **kw)[0]
    assert fused.used_fused_execution and not host.used_fused_execution
    _assert_same_run(fused, host, 1e-12, radius=True)
    assert fused.num_residual_evaluations == fused.num_linear_solves


CASES = {
    "plain": {},
    "nonmonotonic": dict(use_nonmonotonic_steps=True, max_consecutive_nonmonotonic_steps=3),
    "line_search": dict(trust_region_use_line_search=True),
    "bounded": dict(bounded=True),
    # a negative LM diagonal makes S indefinite: valid and invalid steps
    # mixed, then five invalid ones in a row
    "invalid_steps": dict(min_lm_diagonal=-1e3, max_lm_diagonal=-1e3, max_num_iterations=10),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
@pytest.mark.parametrize("case", list(CASES))
def test_loop_matches_jax(case, fused):
    """Each loop of the port against the same loop of the JAX package."""
    kw = dict(CASES[case], fused_execution=fused)
    ts, tp, pts, bal = _solve(ct, **kw)
    js = _solve(ceres_tpu, **kw)[0]
    assert ts.used_fused_execution == js.used_fused_execution == fused
    _assert_same_run(ts, js, 1e-10, radius=True)
    assert ts.num_line_search_steps == js.num_line_search_steps
    if case == "bounded":
        # the state stays in the box, and the box holds some coordinates
        ys = np.array([tp.parameter_block_value(pts[i])[1] for i in BOUNDED_POINTS])
        caps = bal.points[list(BOUNDED_POINTS), 1] + SLACK
        assert np.all(ys <= caps)
        assert np.sum(ys == caps) >= 2
    if case == "line_search":
        assert ts.num_line_search_steps > 0
    if case == "invalid_steps":
        assert ts.termination_type == ct.TerminationType.FAILURE
        flags = [it.step_is_valid for it in ts.iterations[1:]]
        assert True in flags and flags[-5:] == [False] * 5


@pytest.mark.parametrize("chunk", [3, 20])
def test_chunk_length_does_not_change_the_run(chunk):
    one = _solve(ct, fused_execution_chunk_iters=1)[0]
    other = _solve(ct, fused_execution_chunk_iters=chunk)[0]
    assert len(one.iterations) == len(other.iterations)
    for x, y in zip(one.iterations, other.iterations):
        assert (x.cost, x.trust_region_radius, x.gradient_max_norm, x.step_norm) == (
            y.cost, y.trust_region_radius, y.gradient_max_norm, y.step_norm)
        assert (x.linear_solver_iterations, x.step_is_successful) == (
            y.linear_solver_iterations, y.step_is_successful)
    assert one.termination_type == other.termination_type
    calls = other.execution_summary.calls("FusedLoop::Chunk")
    assert calls == -(-(len(other.iterations) - 1) // chunk)


def test_max_num_iterations_ends_with_no_convergence():
    s = _solve(ct, max_num_iterations=3, function_tolerance=0.0, gradient_tolerance=0.0,
               parameter_tolerance=0.0)[0]
    assert s.used_fused_execution
    assert s.termination_type == ct.TerminationType.NO_CONVERGENCE
    assert s.message == "Maximum number of iterations reached."
    assert len(s.iterations) == 4


@pytest.mark.parametrize("chunk", [1, 20])
def test_fused_read_budget(chunk):
    """At most 2 + (PCG iterations) device reads per LM iteration (the CPU
    counts reads as the card does), one for iteration 0."""
    before = counts()
    s = _solve(ct, fused_execution_chunk_iters=chunk, max_num_iterations=8,
               function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0)[0]
    assert s.iterations[0].num_device_reads == 1
    for it in s.iterations[1:]:
        assert 1 <= it.num_device_reads <= 2 + it.linear_solver_iterations
    assert s.num_device_reads == (counts() - before)["Device::Read"] == sum(it.num_device_reads for it in s.iterations)
    assert s.num_graph_replays == 0  # graphs run on a card only


def test_not_fused_where_the_jax_package_is_not():
    for pkg in (ct, ceres_tpu):
        s = _solve(pkg, callbacks=[lambda it: None], max_num_iterations=2)[0]
        assert not s.used_fused_execution


def test_bound_tables_and_plus_match_jax():
    from ceres_tpu.evaluator import plus as j_plus
    from ceres_tpu_torch.evaluator import Evaluator

    bal = synthetic_bal(6, 50, 200, seed=4)
    tp, tcams, tpts = ct.build_ba_problem(bal)
    jp, jcams, jpts = j_build(bal)
    for p, pts, cams in ((tp, tpts, tcams), (jp, jpts, jcams)):
        p.set_parameter_upper_bound(pts[3], 1, 0.25)
        p.set_parameter_lower_bound(pts[7], 0, -0.5)
        p.set_parameter_lower_bound(cams[2], 6, 480.0)
    assert tp.get_parameter_upper_bound(tpts[3], 1) == 0.25
    assert tp.get_parameter_lower_bound(tpts[3], 1) == -np.inf
    tprog, jprog = tp.compile("cpu"), jp.compile()
    assert tprog.has_bounds and jprog.has_bounds
    np.testing.assert_array_equal(tprog.lower_bound, jprog.lower_bound)
    np.testing.assert_array_equal(tprog.upper_bound, jprog.upper_bound)
    for a, b in zip(tprog.bound_coordinate_maps(), jprog.bound_coordinate_maps()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    delta = rng.normal(0.0, 2.0, tprog.num_effective_parameters)
    ev = Evaluator(tprog, torch.float64)
    got = ev.plus(tprog.state_vector(torch.float64), torch.as_tensor(delta)).numpy()
    want = np.asarray(j_plus(jprog, jprog.arrays(np.float64), jprog.state0, delta))
    np.testing.assert_array_equal(got, want)
    assert np.all(got <= jprog.upper_bound) and np.all(got >= jprog.lower_bound)


def test_non_finite_initial_cost_names_the_block():
    bal = synthetic_bal(6, 50, 200, seed=4)
    bal.observations[17, 0] = np.nan
    ts = ct.solve(_options(ct), ct.build_ba_problem(bal)[0])
    js = ceres_tpu.solve(_options(ceres_tpu), j_build(bal)[0])
    assert ts.termination_type == ct.TerminationType.FAILURE
    assert ts.message.startswith("Initial cost evaluation failed (non-finite).")
    assert "1/200 residual blocks non-finite" in ts.message
    assert ts.message == js.message


def _spd_system(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, n))
    a = q @ q.T + n * np.diag(rng.uniform(0.1, 2.0, n))
    b = rng.normal(size=n)
    return a.astype(dtype), b.astype(dtype), (1.0 / np.diag(a)).astype(dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize(
    "stop",
    [dict(tolerance=1e-6, q_tolerance=0.0), dict(tolerance=0.0, q_tolerance=0.1),
     dict(tolerance=0.0, q_tolerance=0.0, max_iterations=3, min_iterations=2)],
    ids=["residual", "q_test", "max_iterations"],
)
def test_device_pcg_matches_jax(dtype, tol, stop):
    import jax.numpy as jnp

    a, b, dinv = _spd_system(24, dtype)
    kw = {"max_iterations": 50, **stop}
    ja, jd = jnp.asarray(a), jnp.asarray(dinv)
    want = j_cg(lambda v: ja @ v, jnp.asarray(b), preconditioner=lambda r: jd * r, **kw)
    ta, td = torch.as_tensor(a), torch.as_tensor(dinv)
    before = counts()
    got = t_cg(lambda v: ta @ v, torch.as_tensor(b), preconditioner=lambda r: td * r, **kw)
    iters = int(want.iterations)
    assert int(got.iterations) == iters and 0 < iters
    assert (counts() - before)["Device::Read"] <= iters  # one flag per iteration, none after the last
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=tol * float(np.abs(np.asarray(want.x)).max()))
    assert bool(got.breakdown) == bool(want.breakdown)
    assert bool(got.converged) == bool(want.converged)


class _EagerStepGraph(StepGraph):
    """A StepGraph whose steps all run eagerly: its copied state and its
    fixed operands, without the card's capture."""

    def step(self, fn):
        self._advance(fn)


def test_pcg_graph_bookkeeping_on_cpu(monkeypatch):
    """The graph path's bookkeeping (the fixed operands read in place, the
    copied state, b and tol_r, the copies handed back) gives the plain
    path's run exactly. On a card the same bookkeeping runs under capture
    (tests/test_torch_cuda_loop.py)."""
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    plain = _solve(ct, max_num_iterations=6)[0]
    holder = _EagerStepGraph("pcg")
    monkeypatch.setattr(tgraphs, "step_graph", lambda name, device: holder)
    graphed = _solve(ct, max_num_iterations=6)[0]
    # the fixed operands: kernel B4's inputs and the preconditioner's inverses
    assert holder.copies is not None and len(holder._fixed) > 12
    assert [it.cost for it in graphed.iterations] == [it.cost for it in plain.iterations]
    assert [it.linear_solver_iterations for it in graphed.iterations] == [
        it.linear_solver_iterations for it in plain.iterations]


class _EagerFnGraph(FnGraph):
    """An FnGraph whose calls all run eagerly, with a capture's effects: its
    copies of the inputs, the fixed inputs read where they are, and every
    "replay" writing into the same output tensors, which the caller sees
    change in place. The captured function, which a replay calls again, is
    kept in `fns` (it holds the solve's Evaluator, and so the workspace
    that holds this graph)."""

    replays = 0

    def __init__(self, name, fns):
        super().__init__(name)
        self._fns = fns

    def _warm_up(self, fn):
        return fn()

    def _capture(self, fn):
        self._fns[self.name] = fn
        self._graph = "eager"
        return fn()

    def _replay(self):
        new = [t for t in torch.utils._pytree.tree_flatten(self._fns[self.name]())[0]
               if isinstance(t, torch.Tensor)]
        old = [t for t in self._out[0] if isinstance(t, torch.Tensor)]
        for o, n in zip(old, new, strict=True):
            o.copy_(n)
        self.replays += 1


def _graph_bookkeeping(monkeypatch, names, **kw):
    plain = _solve(ct, **kw)[0]
    made, fns = [], {}

    def fn_graph(name, device):
        made.append(_EagerFnGraph(name, fns))
        return made[-1]

    monkeypatch.setattr(tgraphs, "fn_graph", fn_graph)
    gc.disable()
    try:
        graphed = _solve(ct, **kw)[0]
        used = [g for g in made if g.captured]
        assert sorted(g.name for g in used) == names
        assert all(g.replays > 0 for g in used)
        # the graphs (and on a card their memory pools) go with the solved
        # Problem's workspace, without waiting for a gc pass
        refs = [weakref.ref(g) for g in made]
        made.clear()
        fns.clear()
        del used
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
    _assert_same_run(graphed, plain, 0.0)
    assert [it.gradient_max_norm for it in graphed.iterations] == [
        it.gradient_max_norm for it in plain.iterations]
    assert graphed.num_line_search_steps == plain.num_line_search_steps


@pytest.mark.parametrize("nonmono", [False, True])
def test_fused_graph_bookkeeping_on_cpu(monkeypatch, nonmono):
    """The fused loop with its evaluate, prepare, decide and finish
    functions behind graphs (copies of the copied inputs, fixed inputs read
    in place, outputs rewritten in place on every call after the first)
    gives the plain loop's run exactly. On a card the same bookkeeping runs
    under capture (tests/test_torch_cuda_loop.py)."""
    _graph_bookkeeping(
        monkeypatch, ["decide", "evaluate", "finish_head", "finish_tail", "prepare"],
        use_nonmonotonic_steps=nonmono, max_consecutive_nonmonotonic_steps=3,
        fused_execution_chunk_iters=2,
    )


@pytest.mark.parametrize("case", ["bounded", "line_search"])
def test_fused_graph_bookkeeping_bounded_on_cpu(monkeypatch, case):
    """The same with bounds (the step unsplit and eager, only decide and
    evaluate behind graphs) and with the line search (which runs eagerly
    between the finish graphs and decide)."""
    names = {
        "bounded": ["decide", "evaluate"],
        "line_search": ["decide", "evaluate", "finish_head", "finish_tail", "prepare"],
    }[case]
    _graph_bookkeeping(monkeypatch, names, fused_execution_chunk_iters=2, **CASES[case])
