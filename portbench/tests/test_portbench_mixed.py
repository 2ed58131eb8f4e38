"""The mixed-precision cell venice1778.mixed on the CPU: its configuration
against its float32 twin's, its byte model against the kernel table's
bound, the copy's count against the tensors the port copies, its readers
without a trace, and the files BENCHMARK.json names for it."""

import json
import os

import numpy as np
import pytest
import torch

import cells
import roofline
import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELL = "venice1778.mixed"
METRICS = ("b4_bf16_roofline_pct", "bf16_copy_roofline_pct")
MIXED = os.path.join(HERE, "metrics", "kernels_mixed.json")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_configuration_differs_from_its_float32_twin_in_the_option_alone():
    mixed, f32 = _config("venice-1778-mixed"), _config("venice-1778")
    changed = {k for k in mixed.keys() | f32.keys() if mixed.get(k) != f32.get(k)}
    assert changed == {"source", "solver", "solver_source", "assumed", "reference"}
    assert mixed["solver"] == dict(f32["solver"], use_mixed_precision_solves=True)
    assert mixed["assumed"][:len(f32["assumed"])] == f32["assumed"]
    assert mixed["reference"] == "snavely_huber_mixed"
    assert "venice" in mixed["source"] and "use_mixed_precision_solves" in mixed["source"]
    entry = next(c for c in _bench()["configs"] if c["name"] == "venice-1778-mixed")
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/venice-1778-mixed.json"


def test_benchmark_names_every_file_the_cell_needs():
    bench = _bench()
    cell = run.Cell(bench, CELL)
    assert cell.entry == {"name": CELL, "config": "venice-1778-mixed", "traffic": "uniform",
                          "chips": 1, "why": cell.entry["why"]}
    assert os.path.isfile(os.path.join(HERE, "limits", f"{CELL}.json"))
    assert os.path.isfile(os.path.join(HERE, "reference", f"{cell.config['reference']}.py"))
    assert os.path.isfile(MIXED)
    names = [m["name"] for m in cell.per_layer]
    assert names == list(METRICS)  # no accepted metric names the cell yet
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "solve_s"
        assert callable(cell.reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} == {"solve_s", "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("call", [0, 1], ids=["shared", "global"])
def test_b4_bf16_model_gives_the_kernel_tables_bound(call):
    """PERF.md section 6: B4 bf16's bound is 0.0883 ms at n = 5,000,000
    (2-byte leaves, 4-byte vectors, tables and outputs), for both point
    passes."""
    model = roofline.load(MIXED)
    sizes = {"obs": 5_000_000, "cameras": 1778, "points": 993923}
    c = model["functions"]["B4_bf16"]["calls"][call]
    assert round(roofline.bound_ms(c, sizes, model), 4) == 0.0883


def test_copy_model_counts_what_astype_copies(monkeypatch):
    """At a small BA Problem the Schur prepare's bfloat16 copy takes the F
    and E leaves and their two twins: the model's bytes per observation are
    6 bytes for each of their values off the twins' padding slots."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.linalg import schur
    from ceres_tpu_torch.program import Program

    monkeypatch.setattr(Program, "SEG_REDUCE_THRESHOLD", 16)
    bal = ct.synthetic_bal(12, 300, 2000, seed=5)
    program = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0].compile("cpu")
    f32 = torch.float32
    _c, _r, jac, _g = Evaluator(program, f32).evaluate_groups(program.state_vector(f32))
    jac_s = jac.scale_columns(1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
    options = ct.SolverOptions(use_mixed_precision_solves=True, dtype=f32, device="cpu")
    cache = schur.schur_prepare(program, options, jac_s)
    leaves = [j for g in cache["jac_mv_groups"] for j in g]
    twins = list(cache["jac_mv_twins"].values())
    assert len(leaves) == 2 and len(twins) == 2
    assert all(t.dtype == torch.bfloat16 for t in leaves + twins)
    n = bal.observations.shape[0]
    layout = jac.garrs[0]["csr"][schur.schur_kernels.sy_meta(program)["f_pos"]]
    pad = layout.pad.numel()
    assert all(t.shape[1] == n + pad for t in twins) and pad > 0
    for t in twins:  # the padding slots hold zeros, copied but not counted
        assert not t[:, layout.pad.long()].float().any()
    values = sum(t.numel() for t in leaves) + sum(t.shape[0] * n for t in twins)
    model = roofline.load(MIXED)
    (call,) = model["functions"]["bf16_copy"]["calls"]
    assert call["words"] == {"obs": 6 * values // n} and values == 48 * n


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels


@pytest.mark.parametrize("metric", METRICS)
def test_readers_without_a_trace_or_their_kernels_return_none(metric):
    reader = run.Cell(_bench(), CELL).reader(metric)
    sizes = {"obs": 1000, "cameras": 10, "points": 100}
    assert reader(run.Context(sizes, None, [], None, roofline.load())) is None
    # a program without the launch (the float32 path, or a parent that
    # copies with PyTorch's kernels): its trace holds none of the names
    other = [("void sy_point_kernel<float, 2, 9, 3>(...)", 7, 0.0, 100.0),
             ("void at::native::elementwise_kernel<128, 4>(...)", 7, 100.0, 50.0)]
    assert reader(run.Context(sizes, None, [], _Trace(other), roofline.load())) is None


def test_readers_read_their_kernels():
    """The copy's share: its bytes at 3.35 TB/s over its launch's time; B4
    bf16's over its point pass, its slot pass and the combine that follows."""
    cell = run.Cell(_bench(), CELL)
    model = roofline.load(MIXED)
    sizes = {"obs": 5_000_000, "cameras": 1778, "points": 993923}
    kernels = [
        ("void leaf_to_bf16::(anonymous namespace)::leaf_to_bf16_kernel<float>(...)", 7, 0, 500.0),
        ("void schur_sy::(anonymous namespace)::sy_point_shared_kernel<2, 9, 3>(...)", 7, 600,
         120.0),
        ("void schur_sy::(anonymous namespace)::sy_fold_bf16_kernel<2, 9, 3, 4>(...)", 7, 720, 90.0),
        ("void camera_chunks::(anonymous namespace)::chunk_parts_sum_kernel<float>(...)", 7, 810,
         10.0),
    ]
    ctx = run.Context(sizes, None, [], _Trace(kernels), roofline.load())
    copy_ms = roofline.bound_ms(model["functions"]["bf16_copy"]["calls"][0], sizes, model)
    assert cell.reader("bf16_copy_roofline_pct")(ctx) == pytest.approx(100 * copy_ms / 0.5)
    assert cell.reader("b4_bf16_roofline_pct")(ctx) == pytest.approx(100 * 0.0883 / 0.22, rel=1e-3)


def test_the_mixed_configuration_runs_as_a_cell(tmp_path):
    """The configuration's options and reference through the harness at a
    tiny size on the CPU: correct, and the device-trace readers silent."""
    mixed = _config("venice-1778-mixed")
    root, bench = cells.tiny_checkout(
        tmp_path, config={k: mixed[k] for k in ("solver", "reference")},
        limits=json.load(open(os.path.join(HERE, "limits", f"{CELL}.json"))))
    result = run.run_cell(bench, "tiny.uniform", 2**31 + 24, 0.2, 1, device="cpu", root=root)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert not set(METRICS) & set(result["metrics"])
    assert np.isfinite(result["checks"]["final_gradient_ratio"]["value"])
