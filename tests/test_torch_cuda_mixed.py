"""The mixed-precision solves on the card (marked `cuda`; they skip without
one). Imports no JAX.

- `leaf_to_bf16` (jacobian.bf16_copies, csrc/leaf_to_bf16.cu), the one
  launch that makes the bfloat16 copy of a Jacobian's leaves and twins, is
  bitwise Tensor.to(torch.bfloat16) at Venice's leaf and twin shapes and
  at ragged sizes, special values included;
- three mixed solves at chip_smoke.py's size capture 6, 0, 0 graphs, end
  bitwise equal, hold the reserved memory after solves 2 and 3, and launch
  the copy once a prepare; a float32 solve launches it never;
- B4 bf16's S·y at BAL-1778 against the configuration's plain reference.
"""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.jacobian import bf16_copies
from ceres_tpu_torch.utils import execution_summary as es
from mixed_reference import mixed_options, port_sy, reference

# BAL-1778's observations (chip_smoke.py's problem), and the width of its
# twins at problem seed 0: each camera's run padded to a multiple of 32 slots
N = 5_001_946
N_PAD = 5_030_016


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: leaf_to_bf16 and the CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _special(dtype, device):
    """Values where a conversion can go wrong: ties between two bfloat16
    values (odd and even below), one float32 step either side of a tie,
    subnormals, the largest finite values, the infinities and NaN."""
    tie = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)], dtype=torch.float64)
    near = torch.cat([tie * (1 + 2 ** -23), tie * (1 - 2 ** -23)])
    big = torch.tensor([3.3895e38, 3.4e38, -3.3895e38, 1e-40, -1e-42, 0.0, -0.0])
    inf = torch.tensor([float("inf"), float("-inf"), float("nan")])
    return torch.cat([tie, near, big.double(), inf.double()]).to(dtype).to(device)


def _same(out, want):
    """Bitwise equal, a NaN to any NaN."""
    a, b = out.view(torch.int16), want.view(torch.int16)
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(out), nan) and torch.equal(a[~nan], b[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_leaf_to_bf16_is_tensor_to(card, dtype):
    g = torch.Generator(device=card).manual_seed(7)
    shapes = [(18, N), (6, N), (18, N_PAD), (6, N_PAD)] if dtype == torch.float32 else [(6, N)]
    shapes += [(1, 1), (3, 7), (5, 8191), (2, 8193), (0, 4), (9, 1779)]
    tensors = [torch.randn(s, generator=g, device=card, dtype=dtype) * 10 for s in shapes]
    tensors.append(_special(dtype, card))
    # a view that starts 4 bytes into its storage: not 16-byte aligned
    tensors.append(torch.randn(1001, generator=g, device=card, dtype=dtype)[1:])
    before = es.counts()["leaf_to_bf16"]
    out = bf16_copies(tensors)
    torch.cuda.synchronize()
    assert es.counts()["leaf_to_bf16"] == before + 1
    for t, o in zip(tensors, out, strict=True):
        assert o.dtype == torch.bfloat16 and o.shape == t.shape and o.is_contiguous()
        assert _same(o, t.to(torch.bfloat16))


@pytest.mark.cuda
def test_leaf_to_bf16_takes_more_tensors_than_a_launch_holds(card):
    tensors = [torch.full((i + 1, 33), i + 0.1, device=card) for i in range(70)]
    before = es.counts()["leaf_to_bf16"]
    out = bf16_copies(tensors)
    assert es.counts()["leaf_to_bf16"] == before + 3  # 32 + 32 + 6
    assert all(_same(o, t.to(torch.bfloat16)) for t, o in zip(tensors, out))


@pytest.mark.cuda
def test_leaf_to_bf16_launches_nothing_for_empty_tensors(card):
    tensors = [torch.zeros((0, 5), device=card), torch.zeros(0, device=card)]
    before = es.counts()["leaf_to_bf16"]
    out = bf16_copies(tensors)
    assert es.counts()["leaf_to_bf16"] == before
    assert [o.shape for o in out] == [t.shape for t in tensors]
    assert all(o.dtype == torch.bfloat16 for o in out)


@pytest.mark.cuda
def test_leaf_to_bf16_refuses_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="contiguous"):
        bf16_copies([torch.zeros((4, 6), device=card).T])
    with pytest.raises(TypeError, match="dtype"):
        bf16_copies([torch.zeros(4, device=card), torch.zeros(4, device=card, dtype=torch.float64)])


def _captures(summary):
    ex = summary.execution_summary
    return sum(ex.calls(n) for n in ex.names() if n.startswith("CUDAGraph::Capture "))


@pytest.mark.cuda
def test_three_mixed_card_solves_capture_once_and_copy_once_a_prepare(card):
    """Three mixed solves of one Problem at chip_smoke.py's size (5
    iterations, float32, SCHUR_JACOBI, the fused loop) from one start: 6, 0,
    0 captures, the reserved memory after the third equal to that after the
    second, bitwise equal states; in each reused solve leaf_to_bf16 ran
    once per replay of the prepare graph, B4 ran its bfloat16 instantiation
    only."""
    bal = ct.synthetic_bal(1778, 993923, N, seed=0)
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    program = problem.compile("cuda")
    x0 = program.state0.copy()
    options = mixed_options(
        device="cuda", eta=0.1, max_linear_solver_iterations=25, max_num_iterations=5,
        function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
        logging_type=ct.LoggingType.SILENT)
    summaries, states, reserved, counts, prepares = [], [], [], [], []
    for _ in range(3):
        program.write_state_back(x0)
        before = es.counts()
        summaries.append(ct.solve(options, problem))
        torch.cuda.synchronize()
        states.append(program.state0.copy())
        reserved.append(torch.cuda.memory_reserved())
        counts.append(es.counts() - before)
        prepares.append(counts[-1]["CUDAGraph::Replay prepare"])
    assert [_captures(s) for s in summaries] == [6, 0, 0]
    assert reserved[2] == reserved[1]
    assert all(np.array_equal(s, states[0]) for s in states[1:])
    assert [it.cost for it in summaries[2].iterations] == [it.cost for it in summaries[0].iterations]
    for c, p in zip(counts[1:], prepares[1:]):
        assert c["leaf_to_bf16"] == p > 0
        assert c["schur_sy_bf16"] > 0 and c["schur_sy"] == 0
    assert summaries[0].final_cost < summaries[0].initial_cost


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
def test_the_float32_path_launches_no_copy(card, mixed):
    bal = ct.synthetic_bal(32, 4000, 40_000, seed=2)
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    es.reset_counts()
    ct.solve(mixed_options(device="cuda", use_mixed_precision_solves=mixed, max_num_iterations=3,
                           logging_type=ct.LoggingType.SILENT), problem)
    launched = es.counts()["leaf_to_bf16"]
    assert launched > 0 if mixed else launched == 0


@pytest.mark.cuda
def test_b4_bf16_sy_at_bal_1778_matches_reference(card):
    """B4 bf16 (the bfloat16 copy, the point and slot passes) against the
    configuration's reference in float64, computed on the card in blocks of
    2^20 observations. Tolerance 1e-3 of the largest |S·y|, the card tests'
    bound for B4 bf16 (PERF.md section 6); measured 4.1e-4 on an H100. The
    gap is the float32 Jacobian's values that round to the other bfloat16
    neighbour (the CPU test of the same product,
    tests/test_torch_mixed_reference.py, reads 0.8-1.9e-4 at 6,000
    observations), not the float32 sums."""
    bal = ct.synthetic_bal(1778, 993923, N, seed=0)
    rng = np.random.default_rng(17)
    nc, npt = bal.cameras.shape[0], bal.points.shape[0]
    d_f = np.sqrt(rng.uniform(1e-3, 1e-1, (nc, 9)))
    d_e = np.sqrt(rng.uniform(1e-3, 1e-1, (npt, 3)))
    y = rng.normal(size=(nc, 9)).astype(np.float32).astype(np.float64)
    launched = es.counts()["schur_sy_bf16"]
    port = port_sy(bal, d_f, d_e, y, device="cuda")
    assert es.counts()["schur_sy_bf16"] == launched + 1
    torch.cuda.empty_cache()
    want = reference().schur_matvec(
        bal.cameras, bal.points, bal.camera_index, bal.point_index, bal.observations, d_f, d_e,
        y, device="cuda", block=1 << 20)
    gap = float(np.abs(port - want).max() / np.abs(want).max())
    print(f"B4 bf16 S·y at BAL-1778 against the reference: {gap:.3e} of the largest")
    assert gap <= 1e-3
