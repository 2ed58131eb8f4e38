#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's BAL-1778 solve on one CUDA card.

    python3 profile_torch_solve.py              # profile the fused and the host loop
    python3 profile_torch_solve.py --compare 3  # iteration ms, fused and host loop
                                                # interleaved 3 times each, no profiler

Runs the same solve as chip_smoke.py's main run (synthetic_bal(1778, 993923,
5,000,000, seed=0), Huber(1.0), float32, LM + ITERATIVE_SCHUR + SCHUR_JACOBI,
eta 0.1, PCG <= 25, 5 iterations) on a new Problem, once on the fused device
loop (fused_execution_chunk_iters=1) and once on the host loop
(fused_execution=False), each under one torch.profiler window, after a
discarded window over a small solve of each loop. For each it
prints the device time per kernel (the full tables go to
chiprun_out/profile_solve.txt), each LM iteration's wall ms, and the device's
busy and idle share over iterations 2-5 from the trace's timeline: the
window runs from the start of iteration 2's host span (FusedLoop::Chunk or
TrustRegion::Iteration) to the end of iteration 5's, and busy is the union
of the kernel, copy and memset intervals inside it.

With --compare N it runs the fused and the host loop N times each, in turns
(fused, host, fused, host, ...), each on a new Problem, and prints every
run's iteration ms and the per-iteration medians.

With --mixed the two variants are the fused loop in float32 and the fused
loop with use_mixed_precision_solves=True (bfloat16 matvec leaves), for the
profile (its tables in chiprun_out/profile_solve_mixed.txt) and for
--compare alike:

    python3 profile_torch_solve.py --mixed --compare 3

With --quaternion they are the fused loop on angle-axis cameras, on
quaternion cameras on Quaternion x Euclidean(6)
(build_ba_problem(use_quaternions=True, use_manifolds=True)) and on
quaternion cameras without a manifold (tangent 10, B4 built for its
shape); tables in chiprun_out/profile_solve_quaternion.txt. --tree DIR
runs --compare on the package of another checkout, so that two trees'
iteration ms can be taken in turns, one process each, in one call:

    python3 profile_torch_solve.py --quaternion --compare 1 --tree .chipcheck/base

With --dogleg they are the fused loop with trust_region_strategy_type=DOGLEG,
TRADITIONAL and SUBSPACE (its Gauss-Newton point CGNR + JACOBI, B1-B3;
tables in chiprun_out/profile_solve_dogleg.txt), and with --sparse-schur
the one run is chip_smoke.py's SPARSE_SCHUR solve at Dubrovnik-356's shape
on the host loop (3 iterations, the idle share over iterations 2-3, which
the host factorization fills; chiprun_out/profile_solve_sparse_schur.txt):

    python3 profile_torch_solve.py --dogleg
    python3 profile_torch_solve.py --sparse-schur

With --denoising the runs are chip_smoke.py's two Fields-of-Experts
denoising solves (FOE_RUNS: LM + CGNR + JACOBI in float32 on the fused
loop; every group through B1 generic), each profiled alone, the idle share
over iterations 2 to min(5, the last); tables in
profile_solve_denoising.txt beside the others:

    python3 profile_torch_solve.py --denoising

With --line-search the one run is chip_smoke.py's line-search run at
BAL-1778: minimizer_type=LINE_SEARCH, L-BFGS + WOLFE, 10 iterations (the
gradient from the evaluate graph, B1 and B3), with its line-search trials
per iteration and the idle share over iterations 2-10
(chiprun_out/profile_solve_line_search.txt):

    python3 profile_torch_solve.py --line-search

With --kernels it times B1 generic (chip_smoke.py's Fields-of-Experts
groups: the 3x3 clique, the data term and the 5x5 clique of FOE_RUNS, and
the 3x3 clique as an AnalyticCostFunction; with the Jacobian and
residual-only), B2 (BAL-1778's shape, n = 5,000,000, t = 9, 1,779
columns, float32, float64 and bfloat16 leaves), and B3 and B4 (S·y whole,
its point pass and its slot pass with the camera combine) at BAL-1778's
shape on float32 and on bfloat16 leaves and twins (chip_smoke.py's
Program: its point buckets, camera layout and slot rows; seeded random
leaves and inverse table; angle-axis cameras, tf 9, then quaternion
cameras without a manifold, tf 10), as each runs by default, each as the device ms
per call of one CUDA graph that holds 20 calls back to back, replayed 10
times between two CUDA events (the median of 5); with B1 generic's cost
and a hash of each B3/B4 output's bytes, so that two versions' results
can be compared: at B1 generic's ~10 us a replay of a single call is
mostly the graph's own launch. `--kernels generic b2 sy` names the sets
to time (default all three). It calls only entry points that the parent
commit has too, so --tree DIR times the package of another checkout (say
a parent commit unpacked with `git archive`) by the same method; run two
checkouts in turns, in one call:

    python3 profile_torch_solve.py --kernels --tree .chipcheck/base
    python3 profile_torch_solve.py --kernels sy --tree .chipcheck/base

With --covariance it profiles chip_smoke.py's covariance PCG at
Dubrovnik-356's shape (gauge_fixed_ba: float64, 72 columns, the batched
PCG over BlockJacobian.jtj_multiply_batched with the block-Jacobi
preconditioner) for 5 steps after 3 discarded ones, and prints the device
time per kernel and per step (chiprun_out/profile_covariance.txt):

    python3 profile_torch_solve.py --covariance
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("FusedLoop::Chunk", "TrustRegion::Iteration", "LineSearch::Iteration")


def _device_us(evt) -> float:
    # the attribute's name changed across torch versions
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def timeline_shares(trace_path, first=2, last=5):
    """Per-iteration (host ms, device busy ms) for every iteration span, and
    the (window ms, busy ms) over iterations first..last, from a chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("ph") == "X" and e.get("name") in SPANS and e.get("cat") == "user_annotation"
    )
    busy = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    )

    def busy_in(lo, hi):
        total, cur = 0.0, lo
        for a, b in busy:
            a, b = max(a, cur), min(b, hi)
            if b > a:
                total += b - a
                cur = b
        return total

    per_iter = [((b - a) / 1e3, busy_in(a, b) / 1e3) for a, b in spans]
    lo, hi = spans[first - 1][0], spans[last - 1][1]
    return per_iter, ((hi - lo) / 1e3, busy_in(lo, hi) / 1e3)


def profile_one(ct, torch, make_problem, options, label, out_dir, last=5):
    problem = make_problem()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=acts) as prof:
        summary = ct.solve(options, problem)
        torch.cuda.synchronize()
    wall = time.time() - t0

    # device-side events only (kernels, copies): an aten op's row repeats
    # the time of the kernels it launched, and an iteration span's device
    # row the time of everything in it
    cuda = torch.autograd.DeviceType.CUDA
    rows = [
        (e.key, _device_us(e), e.count) for e in prof.key_averages()
        if e.device_type == cuda and e.key not in SPANS
    ]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    trace = os.path.join(out_dir, f"trace_{label}.json")
    prof.export_chrome_trace(trace)
    last = min(last, len(summary.iterations) - 1)
    per_iter, (window, busy) = timeline_shares(trace, last=last)
    lines = [
        f"{label}: solve wall {wall:.3f} s under the profiler; preprocess "
        f"{summary.preprocessor_time_in_seconds:.3f} s; used_fused_execution "
        f"{summary.used_fused_execution}",
        "iteration ms: " + ", ".join(
            f"{1000.0 * it.iteration_time_in_seconds:.1f}" for it in summary.iterations
        ),
        "pcg: " + ", ".join(str(it.linear_solver_iterations) for it in summary.iterations),
        "line-search trials: " + ", ".join(
            str(it.line_search_iterations) for it in summary.iterations),
        "device reads: " + ", ".join(str(it.num_device_reads) for it in summary.iterations),
        "graph replays: " + ", ".join(str(it.num_graph_replays) for it in summary.iterations),
        "iteration spans (host ms / device busy ms): " + ", ".join(
            f"{h:.3f}/{d:.3f}" for h, d in per_iter
        ),
        f"iterations 2-{last}: window {window:.3f} ms, "
        f"device busy {busy:.3f} ms "
        f"({100.0 * busy / window:.1f}%), idle {window - busy:.3f} ms "
        f"({100.0 * (window - busy) / window:.1f}%)",
        f"device time {total / 1000.0:.3f} ms in total",
        f"{'device ms':>10} {'share':>7} {'calls':>6}  name",
    ]
    lines += [
        f"{us / 1000.0:10.3f} {100.0 * us / total:6.2f}% {n:6d}  {key[:100]}"
        for key, us, n in rows
    ]
    os.remove(trace)
    return lines


def warm_up_profiler(ct, torch, loops):
    """One profiler window over a small solve of each variant, discarded:
    the first window of a process pays the profiler's start-up inside its
    host spans, which inflates its idle share (PERF.md section 5)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for _, opts, _make, make_small in loops:
            ct.solve(opts, make_small())
        torch.cuda.synchronize()


def variants(mixed, quaternion, dogleg=False):
    """(label, solve options, build_ba_problem options) of the runs:
    fused and host loop; with `mixed` the fused loop in float32 and with
    mixed-precision solves; with `quaternion` the fused loop on angle-axis
    cameras and on quaternion cameras with and without the manifold; with
    `dogleg` the fused loop with DOGLEG, TRADITIONAL and SUBSPACE."""
    fused = {"fused_execution_chunk_iters": 1}
    if dogleg:
        import ceres_tpu_torch as ct

        return tuple(
            (f"dogleg_{kind.split('_')[0].lower()}",
             {**fused, "trust_region_strategy_type": ct.TrustRegionStrategyType.DOGLEG,
              "dogleg_type": getattr(ct.DoglegType, kind)}, {})
            for kind in ("TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG")
        )
    if mixed:
        return (("fused", fused, {}),
                ("mixed", {**fused, "use_mixed_precision_solves": True}, {}))
    if quaternion:
        return (("fused", fused, {}),
                ("quaternion", fused, {"use_quaternions": True, "use_manifolds": True}),
                ("quaternion_nomanifold", fused, {"use_quaternions": True}))
    return (("fused", fused, {}), ("host", {"fused_execution": False}, {}))


def compare(ct, torch, bal, lm_options, runs, variants):
    """Iteration ms of the variants, `runs` times each, in turns, each on
    a new Problem, no profiler."""
    ms = {label: [] for label, _, _ in variants}
    for k in range(runs * len(variants)):
        label, extra, problem_kw = variants[k % len(variants)]
        problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), **problem_kw)
        torch.cuda.empty_cache()
        summary = ct.solve(lm_options("cuda", torch.float32, **extra), problem)
        torch.cuda.synchronize()
        its = [1000.0 * it.iteration_time_in_seconds for it in summary.iterations]
        ms[label].append(its)
        print(f"compare run {k + 1} ({label}): iteration ms "
              + ", ".join(f"{t:.1f}" for t in its)
              + f"; pcg {[it.linear_solver_iterations for it in summary.iterations]}"
              + f"; reads {[it.num_device_reads for it in summary.iterations]}"
              + f"; costs {[it.cost for it in summary.iterations]!r}"
              + f"; final cost {summary.final_cost!r}", flush=True)
    for label, runs_ms in ms.items():
        med = [statistics.median(col) for col in zip(*runs_ms)]
        print(f"compare {label}: median iteration ms over {len(runs_ms)} runs: "
              + ", ".join(f"{t:.1f}" for t in med)
              + f"; iterations 2-5 median sum {sum(med[2:6]):.1f} ms", flush=True)


def batched_ms(torch, fn, calls=20, replays=10, repeats=5) -> float:
    """Device ms per call of fn: one CUDA graph holding `calls` calls back
    to back, replayed `replays` times between two CUDA events; the median
    of `repeats` such readings."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (calls * replays))
    del graph
    return statistics.median(times)


KERNEL_SETS = ("generic", "b2", "sy")


def kernel_times(torch, label, sets=KERNEL_SETS):
    """--kernels: B1 generic on chip_smoke's FoE groups, B2 at BAL-1778's
    shape and B3/B4 on BAL-1778's Program, as each runs by default, by
    batched_ms; `sets` names which."""
    if "generic" in sets:
        generic_times(torch, label)
    if "b2" in sets:
        b2_times(torch, label)
    if "sy" in sets:
        sy_times(torch, label)


def generic_times(torch, label):
    """B1 generic on chip_smoke's FoE groups and the sphere2500-shaped pose
    graph, with the Jacobian and residual-only."""
    from ceres_tpu_torch import eval_kernel, functor_codegen
    from ceres_tpu_torch import cuda_lib
    from ceres_tpu_torch.evaluator import Evaluator, state_tables
    from chip_smoke import FOE_RUNS, build_foe

    dev = torch.device("cuda")
    f32 = torch.float32
    cases = []
    for h, w, size, k, _iters in FOE_RUNS:
        program = build_foe(h, w, size, k).compile(dev)
        cases.append((f"FoE {size}x{size} clique ({h}x{w})", program, 1, f32))
        if size == 3:
            cases.append((f"FoE data term ({h}x{w})", program, 0, f32))
            cases.append((f"FoE {size}x{size} analytic clique ({h}x{w})",
                          build_foe(h, w, size, k, analytic=True).compile(dev), 1, f32))
    # the 5x5 clique at smaller images (fewer blocks than the card holds),
    # and the sphere2500-shaped 3D pose graph's edges in float64, as its run
    for side in (132, 68):
        cases.append((f"FoE 5x5 clique ({side}x{side})", build_foe(side, side, 5, 1).compile(dev),
                      1, f32))
    from chip_smoke import SPHERE_RINGS, write_sphere_g2o
    from ceres_tpu_torch.examples import pose_graph

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sphere.g2o")
        write_sphere_g2o(path, *SPHERE_RINGS)
        graph = pose_graph.load_g2o_3d(path)
    cases.append(("sphere2500-shaped 3D pose graph", pose_graph.build_pose_graph_3d_problem(
        graph)[0].compile(dev), 0, torch.float64))
    # every case's generated source first, one nvcc each, all at once
    cuda_lib.build_generated([functor_codegen.group_program(
        program.groups[gi], Evaluator(program, dtype).arrays["groups"][gi], dtype, True).source
        for _name, program, gi, dtype in cases])
    for name, program, gi, dtype in cases:
        ev = Evaluator(program, dtype)
        meta, garr = program.groups[gi], ev.arrays["groups"][gi]
        st = state_tables(program, program.state_vector(dtype))
        prog = functor_codegen.group_program(meta, garr, dtype, True)
        jac = batched_ms(torch, lambda: eval_kernel.generic_evaluate(prog, meta, garr, st, True))
        res = batched_ms(torch, lambda: eval_kernel.generic_evaluate(prog, meta, garr, st, False))
        cost = float(eval_kernel.generic_evaluate(prog, meta, garr, st, True)[0])
        print(f"kernels [{label}]: eval_generic {name}: n {meta.n}, N {prog.num_tangent}: "
              f"{jac:.5f} ms with the Jacobian, {res:.5f} ms residual-only; cost "
              f"{cost!r}", flush=True)
        del ev, st, program
        torch.cuda.empty_cache()


def b2_times(torch, label):
    """B2 at BAL-1778's shape on float32, float64 and bfloat16 leaves."""
    import numpy as np

    from ceres_tpu_torch import cuda_lib
    from ceres_tpu_torch.gather_reduce import gather_contract

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n, ncols, t, r = 5_000_000, 1779, 9, 2
    rows = torch.tensor(rng.integers(0, ncols, n).astype(np.int32), device=dev)
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        vdt = cuda_lib.vector_dtype(dt)
        jac = torch.tensor(rng.standard_normal((r * t, n), dtype=np.float32), device=dev).to(dt)
        table = torch.tensor(rng.standard_normal((t, ncols)), device=dev, dtype=vdt)
        table[:, -1] = 0
        ms = batched_ms(torch, lambda: gather_contract(jac, rows, table, r))
        print(f"kernels [{label}]: gather_contract {str(dt).split('.')[-1]}: {ms:.5f} ms",
              flush=True)
        del jac, table
        torch.cuda.empty_cache()


def _digest(x) -> str:
    """A short hash of a tensor's bytes: equal outputs, bitwise."""
    import hashlib

    return hashlib.sha256(x.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def sy_times(torch, label):
    """B3 and B4 at BAL-1778's shape (chip_smoke.py's Program: its buckets,
    camera layout and slot rows; seeded random leaves, twins and inverse
    table, float32 y and u) on float32 and on bfloat16 leaves and twins:
    B3, S·y whole, its point pass and its slot pass, each with a hash of its
    output; first on angle-axis cameras (tangent 9), then on quaternion
    cameras without a manifold (tangent 10, build_ba_problem(
    use_quaternions=True)) on the same data."""
    import ceres_tpu_torch as ct
    from chip_smoke import NUM_OBSERVATIONS, NUM_POINTS

    t0 = time.time()
    bal = ct.synthetic_bal(1778, NUM_POINTS, NUM_OBSERVATIONS, seed=0)
    print(f"kernels [{label}]: BAL-1778 data in {time.time() - t0:.1f} s", flush=True)
    for quaternion in (False, True):
        sy_times_on(torch, label, ct.build_ba_problem(
            bal, loss=ct.HuberLoss(1.0), use_quaternions=quaternion)[0])
        torch.cuda.empty_cache()


def sy_times_on(torch, label, problem):
    """sy_times on one BAL-1778 Problem."""
    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.gather_reduce import contract_reduce
    from ceres_tpu_torch.jacobian import make_twin
    from ceres_tpu_torch.linalg.schur_kernels import (
        sy_apply, sy_fold_pass, sy_meta, sy_point_pass, sy_tables,
    )

    dev = torch.device("cuda")
    f32 = torch.float32
    t0 = time.time()
    program = problem.compile(dev)
    meta = sy_meta(program)
    garr = Evaluator(program, f32).arrays["groups"][0]
    f_pos, e_pos, r, te, tf = meta["f_pos"], meta["e_pos"], meta["r"], meta["te"], meta["tf"]
    rows_f, layout = garr["t_rows"][f_pos], garr["csr"][f_pos]
    n, ncols = rows_f.shape[0], layout.offsets.shape[0] - 1
    cnt_e = program.tangent_class_counts[meta["e_cls"]]
    prow = program.slot_rows(0, e_pos, f_pos, dev)
    segs = sy_tables(meta, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    F = torch.randn((r * tf, n), generator=gen, device=dev)
    E = torch.randn((r * te, n), generator=gen, device=dev)
    minv = 0.1 + torch.rand((te * te, cnt_e), generator=gen, device=dev)
    y = torch.randn((tf, ncols), generator=gen, device=dev)
    y[:, -1] = 0
    u = torch.randn((r, n), generator=gen, device=dev)
    shape = f"(r, tf, te) = ({r}, {tf}, {te})"
    print(f"kernels [{label}]: BAL-1778 Program {shape} and operands in {time.time() - t0:.1f} s: "
          f"n {n}, n_pad {layout.perm.shape[0]}, {layout.num_chunks} chunks, {cnt_e} points",
          flush=True)
    for dt in (f32, torch.bfloat16):
        Fd, Ed = F.to(dt), E.to(dt)
        f_twin, e_twin = make_twin(Fd, layout), make_twin(Ed, layout)
        t2 = sy_point_pass(meta, Fd, Ed, rows_f, y, minv, segs)
        calls = {
            "contract_reduce": lambda: contract_reduce(f_twin, layout, u, r),
            "schur_sy": lambda: sy_apply(meta, Fd, Ed, rows_f, f_twin, e_twin, prow, layout, y,
                                         minv, segs),
            "schur_sy point pass": lambda: sy_point_pass(meta, Fd, Ed, rows_f, y, minv, segs),
            "schur_sy slot pass": lambda: sy_fold_pass(meta, f_twin, e_twin, prow, layout, y, t2),
        }
        for name, fn in calls.items():
            ms = batched_ms(torch, fn)
            print(f"kernels [{label}]: {name} {str(dt).split('.')[-1]} at tf {tf}: {ms:.5f} ms; "
                  f"output {_digest(fn())}", flush=True)
        del Fd, Ed, f_twin, e_twin, t2, calls
        torch.cuda.empty_cache()


def profile_covariance(ct, torch, out_dir, smi, steps=5):
    """The covariance's batched PCG at Dubrovnik-356's shape under the
    profiler: device time per kernel over `steps` steps (after 3 discarded
    ones), and per step."""
    from torch.profiler import ProfilerActivity, profile

    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.linalg.cg import conjugate_gradients
    from ceres_tpu_torch.linalg.preconditioners import BlockDiagSolver
    from chip_smoke import COV_COLUMNS, DUBROVNIK_356, gauge_fixed_ba

    problem, pairs, _ = gauge_fixed_ba(ct.synthetic_bal(*DUBROVNIK_356, seed=0))
    program = problem.compile("cuda")
    _, _, jac, _ = Evaluator(program, torch.float64).evaluate_groups(
        program.state_vector(torch.float64))
    prec = BlockDiagSolver(program, jac.block_diag_jtj())
    cols = torch.tensor(
        [int(program.t_offsets[b]) + j for b in dict(pairs) for j in range(9)], device="cuda")
    rhs = torch.zeros((COV_COLUMNS, program.num_effective_parameters), dtype=torch.float64,
                      device="cuda")
    rhs[torch.arange(COV_COLUMNS, device="cuda"), cols] = 1.0

    def run(n):
        conjugate_gradients(jac.jtj_multiply_batched, rhs, preconditioner=prec.apply_batched,
                            max_iterations=n, tolerance=0.0, batched=True)
        torch.cuda.synchronize()

    run(3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
    events = prof.key_averages()
    # the kernels' own entries (the aten ops that launched them carry the
    # same time again)
    device = sum(_device_us(e) for e in events if str(e.device_type).endswith("CUDA")) / 1e3
    table = events.table(sort_by="self_cuda_time_total", row_limit=25, max_name_column_width=70)
    head = (f"{smi} | covariance PCG at Dubrovnik-356's shape, float64, {COV_COLUMNS} columns: "
            f"{device:.1f} ms of device time over {steps} steps and the initial matvec, "
            f"{device / (steps + 1):.1f} ms per step")
    print(head + "\n" + table[:5000], flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_covariance.txt"), "w") as f:
        f.write(head + "\n" + table + "\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Profile the port's BAL-1778 solve.")
    parser.add_argument("--compare", type=int, default=0,
                        help="run the fused and host loops this many times each, in turns")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--mixed", action="store_true",
                       help="the fused loop in float32 and with mixed-precision solves instead")
    group.add_argument("--quaternion", action="store_true",
                       help="the fused loop on angle-axis and on quaternion cameras instead")
    group.add_argument("--dogleg", action="store_true",
                       help="the fused loop with DOGLEG, TRADITIONAL and SUBSPACE, instead")
    group.add_argument("--sparse-schur", action="store_true",
                       help="profile chip_smoke's SPARSE_SCHUR run at Dubrovnik-356's shape instead")
    group.add_argument("--denoising", action="store_true",
                       help="profile chip_smoke's two Fields-of-Experts denoising runs instead")
    group.add_argument("--line-search", action="store_true",
                       help="profile chip_smoke's L-BFGS line-search run at BAL-1778 instead")
    group.add_argument("--kernels", nargs="*", choices=KERNEL_SETS, default=None,
                       help="time B1 generic, B2 and B3/B4 (or the sets named) by batched "
                            "graph replays instead")
    group.add_argument("--covariance", action="store_true",
                       help="profile chip_smoke's covariance PCG at Dubrovnik-356's shape instead")
    parser.add_argument("--tree", default=None,
                        help="with --kernels or --compare: the checkout whose package to time")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_solve: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.tree) if args.tree else os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    if args.kernels is not None:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | {root}", flush=True)
        kernel_times(torch, args.tree or "this checkout", args.kernels or KERNEL_SETS)
        return 0
    import ceres_tpu_torch as ct
    from ceres_tpu_torch import cuda_lib
    from chip_smoke import (
        DUBROVNIK_356, FOE_RUNS, NUM_OBSERVATIONS, NUM_POINTS, build_foe, line_search_run,
        lm_options,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    cuda_lib.library()
    if args.covariance:
        profile_covariance(ct, torch, os.path.join(root, "chiprun_out"), smi)
        return 0
    if args.compare and (args.denoising or args.sparse_schur or args.line_search):
        parser.error("--compare times the BAL-1778 variants; --denoising, --sparse-schur and "
                     "--line-search only profile")
    shape = DUBROVNIK_356 if args.sparse_schur else (1778, NUM_POINTS, NUM_OBSERVATIONS)
    bal = None if args.denoising else ct.synthetic_bal(*shape, seed=0)
    if args.compare:
        compare(ct, torch, bal, lm_options, args.compare,
                variants(args.mixed, args.quaternion, args.dogleg))
        return 0

    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = [f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}"]
    if args.denoising:
        loops = [
            (f"foe{size}x{size}_k{k}_{h}x{w}",
             lm_options("cuda", torch.float32, "JACOBI", fused_execution_chunk_iters=1,
                        max_num_iterations=iters, linear_solver_type=ct.LinearSolverType.CGNR),
             lambda h=h, w=w, size=size, k=k: build_foe(h, w, size, k),
             lambda size=size: build_foe(40, 36, size, 2))
            for h, w, size, k, iters in FOE_RUNS
        ]
    else:
        small = ct.synthetic_bal(32, 4000, 40_000, seed=0)
        runs = variants(args.mixed, args.quaternion, args.dogleg)
        if args.sparse_schur:
            runs = (("sparse_schur", {"linear_solver_type": ct.LinearSolverType.SPARSE_SCHUR,
                                      "max_num_iterations": 3}, {}),)
        if args.line_search:
            runs = (("line_search_lbfgs", line_search_run(), {}),)
        loops = [
            (label, lm_options("cuda", torch.float32, **extra),
             lambda kw=problem_kw: ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), **kw)[0],
             lambda kw=problem_kw: ct.build_ba_problem(small, loss=ct.HuberLoss(1.0), **kw)[0])
            for label, extra, problem_kw in runs
        ]
    warm_up_profiler(ct, torch, loops)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        for label, options, make_problem, _small in loops:
            torch.cuda.empty_cache()
            lines = profile_one(ct, torch, make_problem, options, label, tmp,
                                last=10 if args.line_search else 5)
            report += lines + [""]
            print("\n".join(lines[:30]), flush=True)
    name = ("profile_solve_mixed.txt" if args.mixed else
            "profile_solve_quaternion.txt" if args.quaternion else
            "profile_solve_dogleg.txt" if args.dogleg else
            "profile_solve_sparse_schur.txt" if args.sparse_schur else
            "profile_solve_denoising.txt" if args.denoising else
            "profile_solve_line_search.txt" if args.line_search else "profile_solve.txt")
    with open(os.path.join(out_dir, name), "w") as f:
        f.write("\n".join(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
