"""Program.write_state_back: a state vector written into the Problem's
blocks through the Program's write-back plan (one row index per add of the
block store, built at the first write-back and kept for the Program's
life).

Every live block reads its slice of the state, `state[x_offsets[b] :
x_offsets[b] + size]`, bitwise (the per-block rule of the JAX package's
`Program.write_state_back`), a removed block keeps its values, the
Program's state is a new array on every call, and a solve's final state is
one no later solve writes into. A solve's Summary counts what the Program
holds, which are the Problem's counts.

The file imports no JAX: `python -m pytest --noconftest
tests/test_torch_write_back.py` runs it on a machine that has only PyTorch."""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct

F64 = torch.float64


def _pair(params, data):
    x, y = params
    return x[:1] * y[:1] + x[-1:] - data[0]


PAIR = ct.CostFunction(_pair, 1, name="pair")

# what each problem holds besides bulk adds of sizes 9, 3 and 6
CASES = {
    "two_bulk": set(),
    "single_blocks": {"single"},
    "removed": {"removed"},
    "constant": {"constant"},
    "quaternion": {"quaternion"},
    "bounds": {"bounds"},
    "all": {"single", "removed", "constant", "quaternion", "bounds"},
}


def _build(features, seed=5):
    """(problem, handles): three bulk adds whose blocks have uneven
    degrees, plus what `features` names. The features leave the third
    add's class alone, so its class rows stay in degree order: a
    permutation of the add's rows."""
    rng = np.random.default_rng(seed)
    p = ct.Problem()
    cams = [int(h) for h in p.add_parameter_blocks(rng.normal(size=(7, 9)))]
    pts = [int(h) for h in p.add_parameter_blocks(rng.normal(size=(40, 3)))]
    handles = cams + pts + [int(h) for h in p.add_parameter_blocks(rng.normal(size=(30, 6)))]
    if "single" in features:
        handles += [p.add_parameter_block(rng.normal(size=s)) for s in (3, 9, 2, 2)]
    if "quaternion" in features:
        q = rng.normal(size=(5, 4))
        quats = p.add_parameter_blocks(q / np.linalg.norm(q, axis=1, keepdims=True),
                                       ct.QuaternionManifold())
        handles += [int(h) for h in quats]
        one = rng.normal(size=4)
        handles.append(p.add_parameter_block(one / np.linalg.norm(one), ct.QuaternionManifold()))
    for _ in range(150):
        a, b = rng.choice(handles, size=2, replace=False)
        a = int(a) if rng.random() < 0.6 else cams[int(rng.integers(len(cams)))]
        if a != b:
            p.add_residual_block(PAIR, None, [a, int(b)], (rng.normal(size=1),))
    if "constant" in features:
        for b in (cams[1], pts[3], pts[17], *handles[78:80]):
            p.set_parameter_block_constant(b)
    if "bounds" in features:
        for b in pts[:6]:
            p.set_parameter_lower_bound(b, 0, -0.5)
            p.set_parameter_upper_bound(b, 2, 0.5)
    if "removed" in features:
        for b in (pts[0], pts[11], pts[12], cams[4]):
            p.remove_parameter_block(b)
        if "single" in features:
            p.remove_parameter_block(handles[77])
    return p, handles


def _values(problem, handles):
    return {b: problem.parameter_block_value(b) for b in handles}


@pytest.mark.parametrize("case", list(CASES))
def test_each_live_block_reads_its_slice_of_the_state(case):
    problem, handles = _build(CASES[case])
    program = problem.compile("cpu")
    removed = {b for b in handles if b in problem._blocks.removed}
    assert bool(removed) == ("removed" in CASES[case])
    before = _values(problem, handles)
    rng = np.random.default_rng(1)
    for _ in range(2):  # the plan's build, then its reuse
        state = rng.standard_normal(program.num_parameters)
        program.write_state_back(state)
        for b in handles:
            value = problem.parameter_block_value(b)
            if b in removed:
                assert np.array_equal(value, before[b]), b
                continue
            o = int(program.x_offsets[b])
            assert np.array_equal(value, state[o : o + value.size]), b
        assert np.array_equal(program.state0, state)
    # the third add's rows were written out of order
    rows = program.a_row[47:77]
    assert np.array_equal(np.sort(rows), np.arange(30)) and not np.array_equal(rows, np.arange(30))



@pytest.mark.parametrize("case", list(CASES))
def test_the_summary_counts_are_the_problems(case):
    """A solve takes its Summary's block, parameter and residual counts
    from the Program it compiled: the Problem's on every layout, removed,
    constant and manifold blocks included."""
    problem, _ = _build(CASES[case])
    s = ct.solve(ct.SolverOptions(linear_solver_type=ct.LinearSolverType.DENSE_QR,
                                  max_num_iterations=1, logging_type=ct.LoggingType.SILENT,
                                  device="cpu", dtype=F64), problem)
    assert (s.num_parameter_blocks, s.num_parameters, s.num_effective_parameters,
            s.num_residual_blocks, s.num_residuals) == (
        problem.num_parameter_blocks(), problem.num_parameters(),
        problem.num_effective_parameters(), problem.num_residual_blocks(),
        problem.num_residuals())

def test_the_state_is_a_new_array_on_every_write_back():
    problem, handles = _build(set())
    program = problem.compile("cpu")
    rng = np.random.default_rng(2)
    held = program.state0
    held_values = held.copy()
    state = rng.standard_normal(program.num_parameters)
    program.write_state_back(state)
    assert program.state0 is not held and np.array_equal(held, held_values)
    kept, kept_values = program.state0, program.state0.copy()
    blocks = _values(problem, handles)
    state[:] = 7.0  # the caller's array, changed afterwards
    assert np.array_equal(program.state0, kept_values)
    after = _values(problem, handles)
    assert all(np.array_equal(after[b], blocks[b]) for b in handles)
    program.write_state_back(rng.standard_normal(program.num_parameters))
    assert np.array_equal(kept, kept_values)


def _ba(seed=3):
    bal = ct.synthetic_bal(8, 60, 300, seed=seed)
    return ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))


def _options(**kw):
    base = dict(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI, max_num_iterations=3,
        function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
        logging_type=ct.LoggingType.SILENT, device="cpu", dtype=F64,
    )
    return ct.SolverOptions(**{**base, **kw})


def test_a_value_set_after_a_write_back_reaches_the_next_solve():
    problem, cams, _ = _ba()
    options = _options()
    ct.solve(options, problem)
    program = problem.compile("cpu")
    program.write_state_back(program.state0 * 1.001)
    cam = problem.parameter_block_value(int(cams[2])) + 0.01
    problem.set_parameter_block_value(int(cams[2]), cam)
    o = int(program.x_offsets[int(cams[2])])
    assert np.array_equal(program.state0[o : o + 9], cam)
    start = program.state0.copy()
    again = ct.solve(options, problem)
    # a fresh Problem at the same values starts from the same cost
    twin, _, _ = _ba()
    twin_program = twin.compile("cpu")
    twin_program.write_state_back(start)
    fresh = ct.solve(options, twin)
    assert again.initial_cost == fresh.initial_cost
    assert np.array_equal(program.state0, twin_program.state0)


@pytest.mark.parametrize("dtype,iterations", [(torch.float32, 3), (F64, 3), (F64, 0)])
def test_a_kept_final_state_is_not_written_by_later_solves(dtype, iterations):
    """The solve's end keeps the final state's host copy as the Program's
    state uncopied where it is fresh (float32, or a card), and copies it
    where it is the solve's own tensor (float64 on the CPU, which with no
    iteration shares the memory of the state the solve started from)."""
    problem, cams, pts = _ba()
    options = _options(dtype=dtype, max_num_iterations=iterations)
    program = problem.compile("cpu")
    x0 = program.state0.copy()
    kept = []
    for _ in range(3):
        program.write_state_back(x0)
        started = program.state0
        ct.solve(options, problem)
        assert not np.shares_memory(program.state0, started)
        kept.append((program.state0, program.state0.copy()))
        for b in (*cams, *pts):
            o = int(program.x_offsets[b])
            value = problem.parameter_block_value(int(b))
            assert np.array_equal(value, program.state0[o : o + value.size])
    for state, values in kept:
        assert np.array_equal(state, values)
    assert np.array_equal(kept[0][0], x0) == (iterations == 0)
    assert np.array_equal(kept[0][1], kept[2][1])
