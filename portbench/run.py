#!/usr/bin/env python3
"""The benchmark of ceres_tpu_torch: one cell of BENCHMARK.json on one card.

    python3 portbench/run.py --workload venice1778.uniform --seed 7 --seconds 20 --trace 0

Everything a cell is made of is found by name: the cell's entry in
BENCHMARK.json names a configuration (its "file", under portbench/configs/,
with the problem's counts, the solver options, its problem builder
portbench/problems/<builder>.py and its reference portbench/reference/
<reference>.py) and a traffic mix (portbench/traffic/<traffic>.json, read
by generator.py, which draws it with the visibility model it names,
portbench/visibility/<visibility>.py); its limits are
portbench/limits/<workload>.json; each per-layer metric is read by
portbench/metrics/<metric>.py (`read(ctx)`, None where it finds nothing).

Set-up draws the traffic's problem in the order --seed gives
(generator.py), builds the port's Problem with the configuration's
builder, runs one warm solve of 2 iterations (the preprocess, the
kernels' build on a checkout's first run, every shape of the cell) and one
whole unit. The window then runs whole units back to back until --seconds
have passed: reset the parameters to the start (Program.write_state_back),
solve 20 LM iterations. solve_s is the window's time over its solves,
peak_mem_gb the device memory peak over the window. With --trace 1 the window is followed by whole solves
under torch.profiler, and the line holds the per-layer metrics. Then the
port's state is freed and check.py judges every solve's answers against
the configuration's float64 reference.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device[, breakdown], and last the numbers compared with
their limits ("checks"), which also end standard error. No card, fewer
cards than the cell asks for, or a module of JAX or of the JAX package
loaded once the window has closed: a message on standard error, no
result, exit status 2 or 3.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one host thread for the process's numerical libraries: the host side of
# a solve is launch work, and fewer threads make runs steadier
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import enum  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ceres_tpu")
WARM_ITERATIONS = 2


def log(msg):
    print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (ceres_tpu_torch is not ceres_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic,
    limits and metrics, all found by name under `root`."""

    def __init__(self, bench: dict, workload: str, root=ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.entry = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.traffic = load_json(os.path.join(root, "portbench", "traffic",
                                              f"{self.entry['traffic']}.json"))
        self.root = root
        self.portbench = os.path.join(root, "portbench")

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, metric: str):
        import generator

        return generator.load("metrics", metric, self.portbench).read


class Solve:
    """One unit of the window: the port's Summary, the solve's wall time
    and the state it wrote back (the Program's state vector)."""

    def __init__(self, summary, wall_s, state):
        self.summary = summary
        self.wall_s = wall_s
        self.state = state

    @property
    def steady(self):
        """Iterations 2 and later (iteration 1 pays the graph captures)."""
        return [it for it in self.summary.iterations if it.iteration >= 2]

    @property
    def steps(self):
        return [it for it in self.summary.iterations if it.iteration >= 1]

    def ok(self) -> bool:
        """The solve ended without FAILURE and with finite costs (with the
        tolerances at 0 it ends after its iterations, or earlier only where
        a step changes the float32 cost by exactly nothing)."""
        s = self.summary
        return (s.termination_type.name != "FAILURE" and len(self.steps) >= 1
                and math.isfinite(s.initial_cost) and math.isfinite(s.final_cost))


class Context:
    """What the per-layer readers see."""

    def __init__(self, sizes, warm, solves, trace, kernels):
        self.sizes = sizes  # {"obs", "cameras", "points"}
        self.warm = warm  # the set-up's first solve's Summary
        self.solves = solves  # the window's Solves
        self.trace = trace  # devtrace.Trace of the traced solves, or None
        self.kernels = kernels  # metrics/kernels.json


def solver_options(ct, torch, config, device, iterations):
    """SolverOptions from the configuration's "solver" entry (enum members
    by name), its precision, the device and the iteration count."""
    defaults = ct.SolverOptions()
    kw = {}
    for key, value in config["solver"].items():
        current = getattr(defaults, key)
        kw[key] = type(current)[value] if isinstance(current, enum.Enum) else value
    kw.update(max_num_iterations=iterations, dtype=getattr(torch, config["precision"]),
              device=device)
    return ct.SolverOptions(**kw)


def run_cell(bench, workload, seed, seconds, trace, device="cuda", solve=None, root=ROOT):
    """One run of a cell; returns the result object. `solve` replaces the
    port's solve (the fault tests plant their faults there)."""
    if root not in sys.path:
        sys.path.insert(0, root)
    import numpy as np
    import torch

    import ceres_tpu_torch as ct
    import check
    import devtrace
    import generator
    import roofline

    cell = Cell(bench, workload, root)
    config = cell.config
    solve = solve or ct.solve
    cuda = torch.device(device).type == "cuda"

    # ---- set-up ----
    gen = generator.generate(config, cell.traffic, seed, cell.portbench)
    builder = generator.load("problems", config["builder"], cell.portbench)
    problem, blocks = builder.build(ct, gen, config)
    log(f"problem built: {gen.observations.shape[0]} observations")
    # the warm solve pays the preprocess (the Program's lowering)
    warm = solve(solver_options(ct, torch, config, device, WARM_ITERATIONS), problem)
    program = problem.compile(device)
    rows = [program.x_offsets[h][:, None] + np.arange(v.shape[1]) for h, v in blocks]
    start = [s for _, s in blocks]
    x0 = np.full(program.state0.shape, np.nan)
    for r, s in zip(rows, start):
        x0[r] = s
    if np.isnan(x0).any():
        raise RuntimeError("the Program's state has entries of no parameter block")
    iterations = int(config["iterations"])
    options = solver_options(ct, torch, config, device, iterations)
    # what set-up built lives for the whole run: the collector leaves it
    # alone, so that a release's collection walks only the solves' objects
    gc.collect()
    gc.freeze()

    # each solve leaves its CUDA graphs' private pools reserved in the
    # allocator (+3.6-7.4 GB a solve at Venice's size), and a capture cannot
    # free them: the 17th solve of a process fails with CUDA out of memory.
    # So once the reserved memory passes half the card, the unit collects
    # the solves' graphs and gives their memory back, inside the window; a
    # program that holds its memory never pays it.
    release_at = torch.cuda.get_device_properties(device).total_memory // 2 if cuda else None
    releases = []  # seconds of each release

    def unit():
        with torch.profiler.record_function(devtrace.RESET):
            if cuda and torch.cuda.memory_reserved(device) > release_at:
                t = time.perf_counter()
                with torch.profiler.record_function(devtrace.RELEASE):
                    gc.collect()
                    torch.cuda.empty_cache()
                releases.append(time.perf_counter() - t)
            program.write_state_back(x0)
        t = time.perf_counter()
        with torch.profiler.record_function(devtrace.SOLVE):
            summary = solve(options, problem)
        return Solve(summary, time.perf_counter() - t, program.state0)

    unit()  # one whole unit more: the window's first solve finds the allocator warm
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    log(f"set-up done; warm solve's preprocess {warm.preprocessor_time_in_seconds:.3f} s")

    # ---- the window ----
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    releases.clear()
    solves = []
    t0 = time.perf_counter()
    while True:
        solves.append(unit())
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    released = (len(releases), sum(releases))
    walls = sorted(s.wall_s for s in solves)
    log(f"window: {len(solves)} solves in {elapsed:.3f} s; solve walls min "
        f"{walls[0]:.3f} median {walls[len(walls) // 2]:.3f} max {walls[-1]:.3f} s; PCG steps "
        f"of the last {[it.linear_solver_iterations for it in solves[-1].steps]}; "
        f"{released[0]} releases, {released[1]:.3f} s")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    traced = []
    trace_data = None
    if trace and cuda:
        n_traced = 1 if elapsed / len(solves) > 4.0 else 2
        traced, trace_data = devtrace.profile(lambda: [unit() for _ in range(n_traced)], torch)

    sizes = {"obs": int(gen.observations.shape[0]), "cameras": int(gen.cameras.shape[0]),
             "points": int(gen.points.shape[0])}
    metrics = {}
    if trace:
        ctx = Context(sizes, warm, solves, trace_data, roofline.load())
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        own = {"solve_s": elapsed / len(solves), "setup_s": setup_s,
               "peak_mem_gb": None if peak is None else peak / 1e9}
        for m in cell.end_to_end:
            if own.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(own[m["name"]]), "unit": m["unit"]}

    # ---- correctness, once the port's state is freed ----
    everything = solves + traced
    answers = [(s.summary.initial_cost, s.summary.final_cost, [s.state[r] for r in rows])
               for s in everything]
    failed = sum(not s.ok() for s in everything)
    del problem, program, solves, traced, everything, warm
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("port freed; reference running")
    values = check.readings(check.reference_module(config), gen, start, answers, device)
    ok, checks = check.judge(values, check.load_limits(workload, os.path.join(root, "portbench")))

    result = {
        "correct": bool(ok and failed == 0 and answers),
        "attempted": len(answers),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(cell.entry["chips"]),
            "memory_peak_bytes": peak,
        },
    }
    if trace_data is not None:
        result["device"]["busy_s"] = trace_data.busy_us / 1e6
        result["device"]["window_s"] = trace_data.window_us / 1e6
        # the traced solves' idle gaps, and the window's releases (host
        # time in which the device idles) as an entry of their own
        result["breakdown"] = {
            "device_ops": trace_data.device_ops(),
            "idle_gaps": trace_data.idle_gaps(9) + [
                [f"window {devtrace.RELEASE}: {released[0]} of {len(walls)} solves", released[1]]],
        }
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = next((int(w["chips"]) for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        print(f"loaded once the window had closed: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
