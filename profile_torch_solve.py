#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's BAL-1778 solve on one CUDA card.

    python3 profile_torch_solve.py        # prints the table; the full one goes
                                          # to chiprun_out/profile_solve.txt

Runs the same solve as chip_smoke.py's main run (synthetic_bal(1778, 993923,
5,000,000, seed=0), Huber(1.0), float32, LM + ITERATIVE_SCHUR + SCHUR_JACOBI,
eta 0.1, PCG <= 25, 5 iterations) on a new Problem under one torch.profiler
window, and prints the device time per kernel, each LM iteration's wall ms,
and the preprocess seconds.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


def _device_us(evt) -> float:
    # the attribute's name changed across torch versions
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_solve: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import ceres_tpu_torch as ct
    from ceres_tpu_torch import cuda_lib
    from chip_smoke import NUM_OBSERVATIONS, NUM_POINTS, lm_options

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    cuda_lib.library()
    bal = ct.synthetic_bal(1778, NUM_POINTS, NUM_OBSERVATIONS, seed=0)
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    options = lm_options("cuda", torch.float32)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=acts) as prof:
        summary = ct.solve(options, problem)
        torch.cuda.synchronize()
    wall = time.time() - t0

    # device-side events only (kernels, copies): an aten op's row repeats
    # the time of the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = [
        (e.key, _device_us(e), e.count) for e in prof.key_averages()
        if e.device_type == cuda
    ]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    lines = [
        f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}",
        f"solve wall {wall:.3f} s under the profiler; preprocess "
        f"{summary.preprocessor_time_in_seconds:.3f} s",
        "iteration ms: " + ", ".join(
            f"{1000.0 * it.iteration_time_in_seconds:.1f}" for it in summary.iterations
        ),
        f"device time {total / 1000.0:.3f} ms in total",
        f"{'device ms':>10} {'share':>7} {'calls':>6}  name",
    ]
    lines += [
        f"{us / 1000.0:10.3f} {100.0 * us / total:6.2f}% {n:6d}  {key[:100]}"
        for key, us, n in rows
    ]
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_solve.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[:40]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
