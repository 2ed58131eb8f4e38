"""ceres_tpu_torch.ParameterBlockOrdering and linear_solver_ordering against
ceres_tpu, in float64 on the CPU.

- The ordering's surface (add, move, remove, clear, reverse, the group
  queries, eliminated_blocks) gives the JAX package's answers after the
  same operations.
- Eliminating the points (the automatic partition's choice), as a flat
  handle sequence or as a ParameterBlockOrdering, gives costs and PCG counts
  bitwise equal to the automatic partition.
- Eliminating the cameras instead, or only half the points (the demotion
  of mixed positions then eliminates nothing), matches ceres_tpu per
  iteration (cost 1e-10, PCG counts, flags) on both loops; with the
  cameras eliminated the matvec takes the composed products, not kernel
  B4's (2, 9, 3) instantiation.
- A group 0 that is not an independent set raises the same ValueError.
"""

import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch.linalg import schur as tschur
from ceres_tpu_torch.program import Program as TProgram

torch.set_num_threads(1)

LM = dict(
    linear_solver_type="ITERATIVE_SCHUR",
    preconditioner_type="SCHUR_JACOBI",
    max_num_iterations=5,
    eta=0.1,
    max_linear_solver_iterations=25,
    function_tolerance=0.0,
    gradient_tolerance=0.0,
    parameter_tolerance=0.0,
)


def _options(pkg, **kw):
    kw = {**LM, **kw}
    kw["linear_solver_type"] = getattr(pkg.LinearSolverType, kw["linear_solver_type"])
    kw["preconditioner_type"] = getattr(pkg.PreconditionerType, kw["preconditioner_type"])
    if pkg is ct:
        kw["device"] = "cpu"
    return pkg.SolverOptions(**kw)


# each: a list of (method, args) applied to a fresh ordering of each package
SURFACES = {
    "groups": [("add_element_to_group", (5, 1)), ("add_element_to_group", (6, 1)),
               ("add_element_to_group", (7, 0))],
    "move": [("add_element_to_group", (5, 1)), ("add_element_to_group", (7, 0)),
             ("add_element_to_group", (5, 0))],
    "remove": [("add_element_to_group", (5, 2)), ("add_element_to_group", (6, 3)),
               ("remove", (5,)), ("remove", (5,))],
    "reverse": [("add_element_to_group", (7, 0)), ("add_element_to_group", (6, 1)),
                ("add_element_to_group", (3, 4)), ("reverse", ())],
    "negative_and_clear": [("add_element_to_group", (1, -1)), ("add_element_to_group", (2, 3)),
                           ("clear", ()), ("add_element_to_group", (4, 2))],
    "empty": [],
}


def _observe(o):
    queries = {
        "num_elements": o.num_elements,
        "num_groups": o.num_groups,
        "group_to_elements": o.group_to_elements(),
        "eliminated_blocks": o.eliminated_blocks(),
        "ids": [o.group_id(e) for e in range(10)],
        "members": [o.is_member(e) for e in range(10)],
        "sizes": [o.group_size(g) for g in range(5)],
        "elements_in": [o.elements_in_group(g) for g in range(5)],
    }
    try:
        queries["min_non_zero_group"] = o.min_non_zero_group()
    except ValueError as exc:
        queries["min_non_zero_group"] = str(exc)
    return queries


@pytest.mark.parametrize("ops", list(SURFACES))
def test_ordering_surface_matches_jax(ops):
    orderings = (ceres_tpu.ParameterBlockOrdering(), ct.ParameterBlockOrdering())
    for name, args in SURFACES[ops]:
        results = [getattr(o, name)(*args) for o in orderings]
        assert results[0] == results[1]
        assert _observe(orderings[0]) == _observe(orderings[1])
    assert list(ceres_tpu.ordering.eliminated_handles(orderings[0])) == list(
        ct.ordering.eliminated_handles(orderings[1]))


def _ordering(pkg, first, rest):
    o = pkg.ParameterBlockOrdering()
    for h in first:
        o.add_element_to_group(int(h), 0)
    for h in rest:
        o.add_element_to_group(int(h), 1)
    return o


def _bal():
    return synthetic_bal(8, 60, 300, seed=3, perturb_points=0.05)


@pytest.mark.parametrize("form", ["flat", "ordering"])
def test_points_first_ordering_equals_the_automatic_partition(monkeypatch, form):
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    runs = []
    for pinned in (False, True):
        problem, cams, pts = ct.build_ba_problem(_bal(), loss=ct.HuberLoss(1.0))
        kw = {}
        if pinned:
            kw["linear_solver_ordering"] = (
                [int(h) for h in pts] if form == "flat" else _ordering(ct, pts, cams))
        runs.append(ct.solve(_options(ct, **kw), problem))
    auto, pinned = runs
    assert [it.cost for it in pinned.iterations] == [it.cost for it in auto.iterations]
    assert [it.linear_solver_iterations for it in pinned.iterations] == [
        it.linear_solver_iterations for it in auto.iterations]


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("which", ["cameras", "half_points"])
def test_other_orderings_match_jax_per_iteration(monkeypatch, which, fused):
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", 16)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    sums = []
    for pkg, build in ((ceres_tpu, j_build), (ct, ct.build_ba_problem)):
        problem, cams, pts = build(_bal(), loss=pkg.HuberLoss(1.0))
        first = cams if which == "cameras" else pts[::2]
        rest = np.setdiff1d(np.concatenate([cams, pts]), first)
        options = _options(pkg, fused_execution=fused,
                           linear_solver_ordering=_ordering(pkg, first, rest))
        sums.append(pkg.solve(options, problem))
        if pkg is ct:
            program = problem.compile("cpu")
            e_blocks = program.compute_schur_partition()[0]
            # cameras: the 9-wide class is eliminated and B4 cannot apply;
            # half the points: the mixed points position is demoted whole
            assert e_blocks.sum() == (len(cams) if which == "cameras" else 0)
            assert tschur._sy_meta(program) is None
    js, ts = sums
    assert js.used_fused_execution == ts.used_fused_execution == fused
    assert len(ts.iterations) == len(js.iterations) == 6
    for a, b in zip(ts.iterations, js.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-10)
        assert a.linear_solver_iterations == b.linear_solver_iterations
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)


@pytest.mark.parametrize("form", ["flat", "ordering"])
def test_dependent_group_zero_raises_like_jax(form):
    errors = []
    for pkg, build in ((ceres_tpu, j_build), (ct, ct.build_ba_problem)):
        problem, cams, pts = build(synthetic_bal(4, 20, 80, seed=5))
        first = list(pts) + [cams[0]]  # camera 0 shares residual blocks with points
        ordering = [int(h) for h in first] if form == "flat" else _ordering(pkg, first, cams[1:])
        with pytest.raises(ValueError) as err:
            pkg.solve(_options(pkg, linear_solver_ordering=ordering, max_num_iterations=1),
                      problem)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "not an independent set" in errors[1]


def test_a_later_solve_without_an_ordering_goes_back_to_the_automatic_partition():
    problem, cams, pts = ct.build_ba_problem(synthetic_bal(4, 20, 80, seed=5))
    ct.solve(_options(ct, linear_solver_ordering=[int(h) for h in cams], max_num_iterations=1),
             problem)
    program = problem.compile("cpu")
    assert program.compute_schur_partition()[0][cams].all()
    ct.solve(_options(ct, max_num_iterations=1), problem)
    e_blocks = program.compute_schur_partition()[0]
    assert e_blocks[pts].all() and not e_blocks[cams].any()
