"""The mixed-precision configuration's plain reference against the port, on
the CPU (no JAX).

The benchmark's configuration venice-1778-mixed runs the port's
mixed-precision solves: the PCG matvec S·y reads a bfloat16 copy of the
scaled Jacobian's leaves and twins and sums in float32. Its reference,
portbench/reference/snavely_huber_mixed.py (plain torch; loaded here from
its file), states that product with every sum in float64. At a seeded
small BAL problem:

- the port's mixed S·y (kernel B4's plain version on the bfloat16 copy)
  agrees with the reference's `schur_matvec`, and the reference with its
  leaves left unrounded, or with its sums in bfloat16, does not;
- a 5-iteration mixed solve's initial and final cost agree with the
  reference's cost at the start and at the returned state, under the
  cell's limits (portbench/limits/venice1778.mixed.json);
- BlockJacobian.astype(torch.bfloat16) on the CPU is Tensor.to, bitwise,
  on every leaf and twin.
"""

import json
import os

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.linalg.schur_kernels import sy_meta
from ceres_tpu_torch.program import Program
from mixed_reference import F32, PORTBENCH, mixed_options, port_sy, reference, rows

torch.set_num_threads(1)

# The port against the reference, relative to the largest |S·y|. Measured
# at this problem: 9.4e-5 (9.4e-5 in blocks of 997 observations too), and
# 8.4e-5 to 1.9e-4 at problem seeds 4-6. That is not the float32 sums (the
# float32 port against the unrounded reference: 5.0e-6) but the port's
# float32 Jacobian, whose values near a tie between two bfloat16 values
# round the other way, one bfloat16 step (2^-8) apart. The controls lie
# 2.7e-3 (unrounded leaves) and 2.7e-3 (sums in bfloat16) from the port
# here, and 2.0e-3 or more at seeds 4-6. The tolerance lies 5.3x over the
# reading and 5.4x under both controls.
SY_TOL = 5e-4


@pytest.fixture(autouse=True)
def plans(monkeypatch):
    """The BA plans (points on buckets, cameras on the onehot plan: kernel
    B4's structure) at this small size."""
    monkeypatch.setattr(Program, "SEG_REDUCE_THRESHOLD", 16)


@pytest.fixture(scope="module")
def bal():
    return ct.synthetic_bal(24, 600, 6000, seed=3)


@pytest.fixture(scope="module")
def sy_case(bal):
    rng = np.random.default_rng(11)
    nc, npt = bal.cameras.shape[0], bal.points.shape[0]
    d_f = np.sqrt(rng.uniform(1e-3, 1e-1, (nc, 9)))
    d_e = np.sqrt(rng.uniform(1e-3, 1e-1, (npt, 3)))
    y = rng.normal(size=(nc, 9))
    y32 = y.astype(np.float32).astype(np.float64)  # what the float32 port holds
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Program, "SEG_REDUCE_THRESHOLD", 16)
        port = port_sy(bal, d_f, d_e, y32)
    args = (bal.cameras, bal.points, bal.camera_index, bal.point_index, bal.observations,
            d_f, d_e, y32)
    return port, args


def _gap(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("block", [1 << 21, 997], ids=["one-block", "blocks"])
def test_port_mixed_sy_matches_reference(sy_case, block):
    port, args = sy_case
    want = reference().schur_matvec(*args, block=block)
    assert _gap(port, want) <= SY_TOL


@pytest.mark.parametrize("control", ["unrounded-leaves", "bf16-sums"])
def test_lower_precision_than_stated_fails_the_tolerance(sy_case, control):
    """The tolerance is tight enough to see the rounding the configuration
    states: the reference without it, or with sums in bfloat16 where the
    configuration states float32 and better, lies outside it."""
    port, args = sy_case
    kw = {"leaf_dtype": None} if control == "unrounded-leaves" else {"sum_dtype": torch.bfloat16}
    control_sy = reference().schur_matvec(*args, **kw)
    assert _gap(port, control_sy) > SY_TOL


def test_mixed_solve_costs_match_reference(bal):
    """A 5-iteration mixed solve from the start: its initial cost against
    the reference's cost at the start, its final cost against the
    reference's cost at the state it returned, under the cell's limits."""
    ref = reference()
    with open(os.path.join(PORTBENCH, "limits", "venice1778.mixed.json")) as f:
        limits = json.load(f)
    problem, cams, pts = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    summary = ct.solve(mixed_options(
        max_num_iterations=5, function_tolerance=0.0, gradient_tolerance=0.0,
        parameter_tolerance=0.0), problem)
    assert summary.termination_type.name != "FAILURE" and len(summary.iterations) == 6
    program = problem.compile("cpu")
    cams_t = program.state0[rows(cams, 9, program.x_offsets)]
    pts_t = program.state0[rows(pts, 3, program.x_offsets)]
    obs = (bal.camera_index, bal.point_index, bal.observations)
    c0 = ref.cost(bal.cameras, bal.points, *obs)
    c_t = ref.cost(cams_t, pts_t, *obs)
    assert c_t < 0.5 * c0  # the solve moved the state
    assert abs(summary.initial_cost - c0) / c0 <= limits["initial_cost_gap"]
    assert abs(summary.final_cost - c_t) / c_t <= limits["final_cost_gap"]


def test_astype_bf16_on_the_cpu_is_tensor_to(bal):
    problem, _c, _p = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    program = problem.compile("cpu")
    _c, _r, jac, _g = Evaluator(program, F32).evaluate_groups(program.state_vector(F32))
    jac_m = jac.scale_columns(1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
    jac_m = jac_m.materialize_scale()
    meta = sy_meta(program)
    jac_m.twin(0, meta["e_pos"], meta["f_pos"])
    assert len(jac_m.twins) == 2
    j16 = jac_m.astype(torch.bfloat16)
    pairs = [(a, b) for ga, gb in zip(jac_m.jac_groups, j16.jac_groups) for a, b in zip(ga, gb)]
    pairs += [(jac_m.twins[k], j16.twins[k]) for k in jac_m.twins]
    assert list(j16.twins) == list(jac_m.twins) and len(pairs) == 4
    for a, b in pairs:
        want = a.to(torch.bfloat16)
        assert b.dtype == torch.bfloat16 and b.shape == a.shape
        assert torch.equal(b.view(torch.int16), want.view(torch.int16))
