"""The harness on the CPU: cells, configurations, traffic and metrics
found by name; the result line's keys; no card, no result; the kernel
byte model against the kernel table's bounds."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

import cells
import roofline
import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_names_every_file_it_needs():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = run.Cell(bench, w["name"])
        assert cell.config["num_observations"] > 0
        assert os.path.isfile(os.path.join(HERE, "limits", f"{w['name']}.json"))
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))


BANDED = '''"""Banded visibility (a test's model): synthetic_bal's problem with each
observation moved to one of the 3 cameras nearest its point's place in
the ring, as in a video sequence."""

import generator


def draw(config, traffic, seed):
    g = generator.load("visibility", "uniform").draw(config, traffic, seed)
    nc, npt = g.cameras.shape[0], g.points.shape[0]
    rng = generator.rng_for(seed + 1)
    cam = (g.point_index * nc // npt + rng.integers(-1, 2, g.point_index.size)) % nc
    pix, _ = generator.project(g.cameras_true[cam], g.points_true[g.point_index])
    g.camera_index = cam
    g.observations = pix + rng.normal(0, traffic["observation_noise"], pix.shape)
    return g
'''


def test_new_files_make_a_new_cell_and_metric(tmp_path):
    """A configuration, a traffic mix with a visibility model of its own,
    limits and a metric reader added as new files (and entries in
    BENCHMARK.json) run as a cell, with no existing file edited."""
    root, bench = cells.tiny_checkout(tmp_path, traffic=("banded",))
    with open(os.path.join(HERE, "traffic", "uniform.json")) as f:
        t = json.load(f)
    t.update(visibility="banded", problem_seed=3)
    with open(os.path.join(root, "portbench", "traffic", "banded.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(root, "portbench", "visibility", "banded.py"), "w") as f:
        f.write(BANDED)
    with open(os.path.join(root, "portbench", "metrics", "solves_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.solves)\n")
    bench["per_layer"].append({"name": "solves_seen", "unit": "solves", "better": "higher",
                               "source": "program_counter", "layer": "solve entry",
                               "moves": "solve_s", "workloads": ["tiny.banded"]})
    before = {p: open(os.path.join(HERE, p), "rb").read()
              for p in ("run.py", "generator.py", "check.py", "roofline.py", "devtrace.py",
                        os.path.join("visibility", "uniform.py"),
                        os.path.join("problems", "snavely_bal.py"))}
    result = run.run_cell(bench, "tiny.banded", 12, 0.2, 1, device="cpu", root=root)
    assert result["correct"], result["checks"]
    assert result["metrics"]["solves_seen"]["value"] == result["attempted"] >= 1
    assert {"lm_iter_ms", "pcg_steps_per_iter", "reads_per_iter"} <= set(result["metrics"])
    # no trace on the CPU: the device-trace readers find nothing and stay silent
    assert "device_idle_pct" not in result["metrics"]
    for p, b in before.items():
        assert open(os.path.join(HERE, p), "rb").read() == b


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(tmp_path, trace):
    root, bench = cells.tiny_checkout(tmp_path, traffic=("uniform",))
    result = run.run_cell(bench, "tiny.uniform", 2**31 + 99, 0.2, trace, device="cpu", root=root)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert set(result) <= set(KEYS) | {"breakdown", "checks"}
    names = {m["name"] for m in (bench["end_to_end"] if trace == 0 else bench["per_layer"])}
    assert set(result["metrics"]) <= names
    if trace == 0:
        assert {"solve_s", "setup_s"} <= set(result["metrics"])
    assert result["correct"] and result["failed"] == 0
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


def test_a_run_without_a_card_fails():
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", "venice1778.uniform",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_a_checkout_without_the_port_fails(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ gives no result."""
    root, _ = cells.tiny_checkout(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, os.path.join(root, "portbench", "run.py"), "--workload",
         "venice1778.uniform", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=root, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_byte_model_gives_the_kernel_tables_bounds():
    """At n = 5,000,000, 1,778 cameras and 993,923 points the model gives
    the bounds of PERF.md's kernel table: B1 0.1827 ms (with the Jacobian;
    0.0394 residual-only), B4 0.1600 ms, B5 0.1661 ms at 3.35 TB/s."""
    model = roofline.load()
    sizes = {"obs": 5_000_000, "cameras": 1778, "points": 993923}
    fns = model["functions"]
    b1, b1_res = (roofline.bound_ms(c, sizes, model) for c in fns["B1"]["calls"])
    assert round(b1, 4) == 0.1827 and round(b1_res, 4) == 0.0394
    assert round(roofline.bound_ms(fns["B4"]["calls"][0], sizes, model), 4) == 0.1600
    assert round(roofline.bound_ms(fns["B5"]["calls"][0], sizes, model), 4) == 0.1661


def test_roofline_share_attributes_tails_by_stream_order():
    model = roofline.load()
    sizes = {"obs": 5_000_000, "cameras": 1778, "points": 993923}
    k = [("void sy_point_kernel<float, 2, 9, 3>(float const*)", 7, 0, 200.0),
         ("void sy_fold_kernel<float, 2, 9, 3>(float const*)", 7, 200, 150.0),
         ("void camera_chunks::chunk_sum_kernel<float>(float const*)", 7, 350, 50.0),
         ("void contract_reduce_kernel<float>(float const*)", 7, 400, 300.0),
         ("void camera_chunks::chunk_sum_kernel<float>(float const*)", 7, 700, 50.0)]
    b4 = roofline.bound_ms(model["functions"]["B4"]["calls"][0], sizes, model)
    assert roofline.share(k, "B4", sizes, model) == pytest.approx(100 * b4 / 0.4)
    assert roofline.share(k, "B5", sizes, model) is None


def test_metric_readers_stay_silent_without_a_trace():
    ctx = run.Context({"obs": 1, "cameras": 1, "points": 1}, None, [], None,
                      roofline.load())
    for name in ("b1_roofline_pct", "b4_roofline_pct", "b5_roofline_pct", "device_idle_pct",
                 "lm_iter_ms", "reads_per_iter", "pcg_steps_per_iter", "solve_overhead_ms"):
        spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "metrics",
                                                                         f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.read(ctx) is None
