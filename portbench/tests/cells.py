"""A tiny checkout for the tests: BENCHMARK.json and portbench/ copied into
a temporary directory, with a small configuration and its cells added as
a later change would add them (new files and new entries only)."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

TINY = {"num_cameras": 24, "num_points": 1200, "num_observations": 6039}


def tiny_checkout(tmp, traffic=("uniform",), limits=None, config=None):
    """(root, bench) of a copy with config "tiny" and cells tiny.<traffic>."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(HERE, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(HERE, "configs", "venice-1778.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, **(config or {}))
    with open(os.path.join(root, "portbench", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for t in traffic:
        name = f"tiny.{t}"
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": t, "chips": 1,
                                   "why": "test"})
        for m in bench["per_layer"]:
            m["workloads"].append(name)
        with open(os.path.join(root, "portbench", "limits", f"{name}.json"), "w") as f:
            json.dump(limits or {"initial_cost_gap": 1e-4, "final_cost_gap": 1e-4,
                                 "final_gradient_ratio": 0.05}, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root, bench
