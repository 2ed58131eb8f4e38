"""What decides `correct`, on the CPU at a small size: a sound run passes;
the control (the float64 reference's evaluation replaced by its bfloat16
version in the port's place) and each fault a solve can have, planted
under the harness, come out not correct. With a card (`-m cuda`), the
control at each cell's own size on three seeds."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import cells
import check
import generator
import run
from reference import snavely_huber as ref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SEED = 2**31 + 21


def limits_of(workload):
    return check.load_limits(workload)


@pytest.fixture(params=["venice1778.uniform"])
def checkout(request, tmp_path):
    traffic = request.param.split(".")[1]
    root, bench = cells.tiny_checkout(tmp_path, traffic=(traffic,),
                                      limits=limits_of(request.param))
    return root, bench, f"tiny.{traffic}"


def _rows(problem, program, cams, pts):
    xo = program.x_offsets
    return xo[cams][:, None] + np.arange(9), xo[pts][:, None] + np.arange(3)


def control_solve(ct):
    """The port's solve, with the costs it reports worked out by the
    reference in bfloat16 (the nearest precision below float32) at the
    states it starts from and returns."""
    def solve(options, problem):
        program = problem.compile(options.device)
        handles = np.arange(problem.num_parameter_blocks())
        cams, pts = handles[:program.num_cameras_for_test], handles[program.num_cameras_for_test:]
        cr, pr = _rows(problem, program, cams, pts)
        gen = program.generated_for_test
        args = (gen.camera_index, gen.point_index, gen.observations)
        start = ref.cost(program.state0[cr], program.state0[pr], *args, dtype=torch.bfloat16)
        summary = ct.solve(options, problem)
        summary.initial_cost = start
        summary.final_cost = ref.cost(program.state0[cr], program.state0[pr], *args,
                                      dtype=torch.bfloat16)
        return summary
    return solve


def unchanged_solve(ct):
    """A step that returns its state unchanged: the solve runs, its state
    is put back where it started and the final cost is the initial one."""
    def solve(options, problem):
        program = problem.compile(options.device)
        start = program.state0.copy()
        summary = ct.solve(options, problem)
        program.write_state_back(start)
        summary.final_cost = summary.initial_cost
        return summary
    return solve


def half_batch_solve(ct):
    """Half of the observations left out, the cost taken as twice the rest:
    every other observation solved, the state copied back."""
    def solve(options, problem):
        program = problem.compile(options.device)
        gen = program.generated_for_test
        nc = program.num_cameras_for_test
        handles = np.arange(problem.num_parameter_blocks())
        cr, pr = _rows(problem, program, handles[:nc], handles[nc:])
        half = ct.BalProblem(program.state0[cr].copy(), program.state0[pr].copy(),
                             gen.camera_index[::2], gen.point_index[::2], gen.observations[::2])
        hp, hc, hpt = ct.build_ba_problem(half, loss=ct.HuberLoss(1.0))
        summary = ct.solve(options, hp)
        hprog = hp.compile(options.device)
        hcr, hpr = _rows(hp, hprog, hc, hpt)
        state = program.state0.copy()
        state[cr], state[pr] = hprog.state0[hcr], hprog.state0[hpr]
        program.write_state_back(state)
        summary.initial_cost *= 2
        summary.final_cost *= 2
        return summary
    return solve


def altered_solve(ct):
    """An answer altered where it is produced: one camera's focal length
    off by 5% in the state the solve returns."""
    def solve(options, problem):
        program = problem.compile(options.device)
        summary = ct.solve(options, problem)
        state = program.state0.copy()
        state[int(program.x_offsets[0]) + 6] *= 1.05
        program.write_state_back(state)
        return summary
    return solve


def planted(ct, make, root, bench, workload):
    """make(ct) as the cell's solve; the generated inputs and the camera
    count ride on the Program for the faults that need them."""
    cell = run.Cell(bench, workload, root)
    cfg = cell.config
    gen = generator.generate(cfg, cell.traffic, SEED)
    inner = make(ct)

    def solve(options, problem):
        program = problem.compile(options.device)
        program.generated_for_test = gen
        program.num_cameras_for_test = int(cfg["num_cameras"])
        return inner(options, problem)
    return solve


def test_a_sound_run_is_correct(checkout):
    root, bench, w = checkout
    result = run.run_cell(bench, w, SEED, 0.2, 0, device="cpu", root=root)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("make,fails", [
    (control_solve, "initial_cost_gap"),
    (unchanged_solve, "final_gradient_ratio"),
    (half_batch_solve, "initial_cost_gap"),
    (altered_solve, "final_cost_gap"),
])
def test_the_control_and_each_fault_are_not_correct(checkout, make, fails):
    import ceres_tpu_torch as ct

    root, bench, w = checkout
    result = run.run_cell(bench, w, SEED, 0.2, 0, device="cpu", root=root,
                          solve=planted(ct, make, root, bench, w))
    assert not result["correct"]
    c = result["checks"][fails]
    assert c["value"] > c["limit"], result["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["venice1778.uniform"])
def test_the_control_fails_at_the_cells_size(card, workload):
    """The bfloat16 reference in the port's place reads its cost farther
    from float64 than the cell's limits, on three seeds: at the start (the
    initial cost) and at the true parameters, the state a solve approaches
    (the final cost)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = run.Cell(json.load(f), workload)
    limits = limits_of(workload)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        g = generator.generate(cell.config, cell.traffic, seed)
        obs = (g.camera_index, g.point_index, g.observations)
        for name, state in (("initial_cost_gap", (g.cameras, g.points)),
                            ("final_cost_gap", (g.cameras_true, g.points_true))):
            c64 = ref.cost(*state, *obs, device=card)
            gap = abs(ref.cost(*state, *obs, device=card, dtype=torch.bfloat16) - c64) / c64
            print(f"control {workload} seed {seed}: {name} {gap!r} limit {limits[name]!r}")
            assert not gap <= limits[name]  # a control that gives no number has failed
