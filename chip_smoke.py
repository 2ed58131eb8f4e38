#!/usr/bin/env python3
"""Drive the PyTorch port's bundle-adjustment, denoising, pose-graph and covariance runs on
one CUDA card.

    python3 chip_smoke.py            # one NVIDIA H100 (sm_90a), nvcc on the path
    python3 chip_smoke.py --phase 2  # phases 1 and 2 only, no result line

Phases, one line each (a failed phase raises, so the script exits non-zero
and prints no result):
  1. the device, its name and power limit, and the build of the CUDA
     kernels (ceres_tpu_torch/csrc, compiled here with nvcc), then every
     source the generator of B1 generic makes for the groups this script
     runs (functor_codegen.py) and B4's source at the quaternion cameras'
     shape without a manifold, (r, tf, te) = (2, 10, 3) (one nvcc each,
     all at once), with ptxas' registers and spills of B4's kernels there;
  2. each kernel B1-B5 against its plain PyTorch version on the card, at
     BAL-1778 shapes in float32, and B2, B3 and B4 on bfloat16 leaves and
     twins (the mixed-precision solves): max relative error vs a stated tolerance,
     the median time of each over 10 runs (CUDA events), its bound (the
     least time for its bytes and operations at the data sheet's rates)
     and, for B2 and B3, the time of one PyTorch sparse product for the same
     function; B1's residual-only launch beside the one with the Jacobian;
     B4 (S·y) whole and each of its two launches, also with D_f² y folded
     in; B3, B4 and B5 bitwise equal across two runs; leaf_to_bf16 (the
     mixed solves' bfloat16 copy of the F and E leaves and twins, one
     launch) bitwise against Tensor.to, its plain version and the library
     call it replaced, both timed in a CUDA graph of 20 calls (the device
     time a call, as the prepare graph runs it) and eagerly, in turns;
     the time to build the
     camera-ordered twins of one new Jacobian (B3's, B4's and B5's inputs);
     then schur_prepare's time per new Jacobian for JACOBI and SCHUR_JACOBI,
     with and without mixed-precision solves (which add the bfloat16 casts);
     then the quaternion cameras: B1's quaternion instantiations (on the
     camera's product manifold, tangent 9, and without one, tangent 10),
     with the Jacobian and residual-only, and B3, B4 and B5 on the 10-wide
     Jacobian, each against its plain version (B4 on the kernels built for
     its shape, in float32 and on bfloat16 leaves, bitwise across two runs,
     whole and each launch beside its bound, and beside the times of the
     generic instantiation it replaced); then B1 generic (graph-replay ms, eager ms beside) on the
     Fields-of-Experts 3x3 clique group at 512 x 512, the data term, the
     5x5 clique group at 213 x 177 and the Snavely group at BAL-1778 (also
     against the hand-written eval_snavely), with and without the
     Jacobian, each against its plain version, bitwise across two runs,
     with ptxas' registers and spills at both block sizes; then B1
     generic's custom-Jacobian branch on the 3x3 clique group as an
     AnalyticCostFunction (closed form) against its plain version and
     beside the autodiff clique, and the wrong-rule probe (3x the closed
     form gives 3x the autodiff leaf); B2's two kernels on bfloat16 leaves
     (the table in shared memory; the first version's) at BAL-1778,
     bitwise equal to each other, each time with its share of the bound,
     the shared memory per block and ptxas' report; then B2 and B3 over a
     batch of k = 72 columns (the covariance's PCG) at Dubrovnik-356's
     shape in float64 and BAL-1778's in float32, on lane-major operands
     (the column axis innermost): max rel err against the plain version,
     bitwise equality with 72 single-vector launches and from run to run,
     ms beside the 72 single launches' and the first versions', the
     bound, one torch.sparse product
     against a dense [., 72] operand, and ptxas' registers and spills;
     then B1 with a seeded lane mask that zeroes ~1/8 of the lanes (a
     sharded group's pad lanes): the angle-axis and quaternion Snavely
     instantiations at BAL-1778 and B1 generic on the FoE 3x3 clique at
     512 x 512, each against its plain version under the same mask, the
     masked lanes exactly 0, the others bitwise the unmasked launch, the
     masked and unmasked launches timed in turns;
  3. a small float64 solve (48,000 observations, so the layout plans
     engage) for 5 LM iterations on the card and on the CPU, for JACOBI,
     SCHUR_JACOBI, and SCHUR_JACOBI with the power-series warm start (which
     only schur_solve runs) on the host loop, and SCHUR_JACOBI on the fused
     device loop: per-iteration cost within 1e-9 relative and equal PCG
     counts, and each case's kernels launched; then SCHUR_JACOBI with
     use_mixed_precision_solves on the fused loop (bfloat16 leaves, float64
     elsewhere), whose float32 matvec sums run in another order on the card:
     cost within 1e-6; then, within 1e-9 with B1 generic launched, a small
     Fields-of-Experts CGNR solve on the fused loop, Powell's function on
     DENSE_QR and the curve fit on DENSE_NORMAL_CHOLESKY; then, within 1e-9
     with what each should launch launched, DOGLEG TRADITIONAL and SUBSPACE
     on a small BAL on both loops (B1-B3, not B4 or B5), DOGLEG on
     Rosenbrock's function (DENSE_QR), SPARSE_SCHUR and
     SPARSE_NORMAL_CHOLESKY on the small BAL, and a small 3D pose graph
     (a .g2o file written here) on SPARSE_NORMAL_CHOLESKY and on CGNR +
     SUBSET; then, within 1e-9 with equal counts, the line-search
     minimizer (L-BFGS + WOLFE + CUBIC; NCG Polak-Ribiere + ARMIJO: B1 and
     B3 only), LM with use_inner_iterations on the host loop and with
     check_gradients on the small BAL, solve_gradient_problem on
     Rosenbrock's function (LBFGS, BFGS) and the problem dump of iteration
     1 (every array within 1e-9 of the CPU's); then, within 1e-9, a FoE
     CGNR solve with analytic cliques (eval_generic_analytic), the
     sampled-function solve (no B1), a solve with an EvaluationCallback
     (host loop, the same callback sequence on both) and a SubsetManifold
     group (a scaled analytic functor); last the small BAL with Snavely as
     a NumericDiffCostFunction (CENTRAL; B1 not launched, B2-B5 launched),
     its starting Jacobian held to the CPU's at the rounding bound of a
     central difference and its per-iteration cost gap at 5e-7; then
     covariance in float64 on the card against the CPU within 1e-9:
     SPARSE_QR and ITERATIVE_PCG (the batched B2/B3 launched, the same PCG
     steps per column) on the 48,000-observation BAL, gauge-fixed, 8
     camera blocks and one cross block; DENSE_SVD on ceres_tpu's own test
     problem; then tiny_solve and tiny_solve_batched on six MGH problems
     (the same iterations and convergence per lane, x within 1e-10);
  4. the main run: synthetic_bal(1778, 993923, 5,000,000) with Huber(1.0)
     in float32 through ceres_tpu_torch.solve (LM + ITERATIVE_SCHUR +
     SCHUR_JACOBI, eta 0.1, PCG <= 25, 5 iterations, on the fused device
     loop at fused_execution_chunk_iters=1: the JAX package's benchmarked
     configuration, bench.py:207-243): every value finite, cost decreasing,
     each kernel B1-B5 launched by the run (a replayed CUDA graph counts
     the launches it captured once per replay), and its device->host
     reads and graph replays per iteration printed. Then the
     same solve on the host loop (fused_execution=False) on a new Problem:
     the same PCG counts and accept/reject sequence, final cost within 1e-4
     relative (float32 decisions round in the dtype on the card and in
     Python doubles on the host), both runs' iteration ms side by side.
     Then the fused solve with JACOBI on another new Problem (B1-B4, 3
     iterations), its PCG counts and iteration ms beside the main run's.
     Then the mixed-precision main run: the same solve with
     use_mixed_precision_solves=True on a new Problem, its PCG on B4's
     bfloat16 instantiation (and never the float32 one), one
     leaf_to_bf16 launch per run of the prepare graph, per iteration
     beside the float32 run, and its final cost's gap to it. Last the
     composed-path problem: BAL-1778 with a camera prior as a second
     residual group, where B4 does not apply and the mixed PCG runs the
     composed products through B2's and B3's bfloat16 instantiations (3
     iterations, fused loop). Last the quaternion main run: the same data
     with cameras [q | t | f k1 k2] on Quaternion x Euclidean(6)
     (build_ba_problem(use_quaternions=True, use_manifolds=True): B1's
     quaternion instantiation and B2-B5), SCHUR_JACOBI on the fused loop at
     chunk 1, 5 iterations, per iteration beside the angle-axis main run,
     its initial cost within 1e-5 relative of that run's; then 3 iterations
     without the manifold (tangent 10; B4's kernels built for that shape),
     per iteration beside the manifold run. Then the visibility preconditioners,
     3 iterations each on the fused loop, per iteration beside the main run:
     CLUSTER_JACOBI on canonical views and CLUSTER_TRIDIAGONAL on single
     linkage (B1 and B4 launched, B5 not), each with its clusters, storage,
     host plan seconds and the device ms of its assembly, factorization and
     apply; CLUSTER_TRIDIAGONAL on canonical views must be refused by its
     host plan (storage too large). Last the main configuration with a
     ParameterBlockOrdering that eliminates the points, 3 iterations,
     bitwise equal to the main run's first three. Last the two
     Fields-of-Experts denoising runs (FOE_RUNS: 3x3, K = 8, on 512 x 512 for
     5 iterations; 5x5, K = 24, on 213 x 177 for 3), LM + CGNR + JACOBI in
     float32 on the fused loop at chunk 1: cost, PCG steps, reads and ms per
     iteration, every group through B1 generic at every evaluation, at most
     2 + PCG steps reads per iteration. Before the denoising runs, DOGLEG at
     BAL-1778 (the main run's options, TRADITIONAL and SUBSPACE, 3
     iterations each, fused at chunk 1): the step kind, PCG steps, reads and
     ms per iteration beside the main run's, B1-B3 launched and B4, B5 not,
     at most 2 + PCG steps reads. Then the line-search minimizer at
     BAL-1778 (L-BFGS + WOLFE, 10 iterations, f32: cost, trials, reads,
     replays and ms per iteration; at most 2 + trials reads, 3 + trials on a
     restart; B1 and B3 launched, B4 and B5 not) and LM + SCHUR_JACOBI with
     use_inner_iterations (3 iterations, host loop, beside the main run;
     each refinement's cost before and after, never higher, and its ms by
     CUDA events). After them the host solvers: SPARSE_SCHUR
     at Dubrovnik-356's shape (DUBROVNIK_356, 3 iterations, host loop; the
     explicit branch at every step, the host plan's seconds, the read of S
     and its bytes, the host factorization's seconds, the assembly's ms and
     S bitwise across two assemblies), then the pose graphs in float64: a
     3D graph of sphere2500's shape (SPHERE_RINGS, written as a .g2o file
     and read back) on SPARSE_NORMAL_CHOLESKY and on CGNR + SUBSET (its
     odometry edges), and a 2D graph of M3500's pose count on
     SPARSE_NORMAL_CHOLESKY, each with B1 generic at every evaluation and
     its final cost beside the cost at the true poses. Before the denoising
     runs, the sharded solves of the main configuration (3 iterations):
     an unsharded run with its observations permuted sets each
     iteration's tolerance (the larger of 1e-5 and 10x its gap to the main
     run); (a) one NCCL rank on the card, on the fused loop with its
     all-reduces captured; (b) two gloo ranks that share the card,
     spawned, each reading its own observation rows (LazyRows), on the
     host loop, with pad lanes > 0. Each is held to the main run's first 3
     iterations (PCG counts, accepts, the initial cost within 1e-6, each
     cost within its tolerance) and prints per iteration its cost, PCG
     steps, ms and reads, and its all-reduces and their bytes, its peak
     memory per rank and the loop that ran; B4 and B5 do not run on a
     shard. Before them, BAL-1778 with Snavely as a NumericDiffCostFunction (CENTRAL) in
     float64 (SCHUR_JACOBI, fused, 3 iterations: its initial cost within
     1e-10 of eval_snavely's, B1 not launched, B2-B5 launched, the
     evaluate graph's ms per call, the peak device memory); after them the
     3x3 denoising run with the cliques as AnalyticCostFunctions beside the
     autodiff run (cost per iteration within 1e-5, equal PCG steps). Last
     the slice's own path: covariance at Dubrovnik-356's shape in float64
     (a new Problem, two cameras constant, 3 LM iterations, then the points
     seen by fewer than two cameras constant; ITERATIVE_PCG over 72
     columns at the default tolerance: steps per column, ms per step,
     reads, peak memory, the batched B2/B3 launched in the PCG (and per
     matvec) and the single-vector ones not; the blocks against S⁻¹ from a dense float64
     Cholesky of S assembled at D = 0), and tiny_solve_batched on 2^20
     Freudenstein-Roth starts (ms, reads, iterations, the share of lanes
     at each minimum; 1,024 sampled lanes against the CPU). Then the
     loaded-file run: synthetic_bal at Dubrovnik-356's shape written as a
     BAL text file (%.17g) and read back by the native parser
     (io/native.py, built here with g++) and by the numpy one, the arrays
     bitwise equal, each parser's seconds; the solve of the loaded problem
     (LM + ITERATIVE_SCHUR + SCHUR_JACOBI, Huber(1.0), float32, fused at
     chunk 1, 3 iterations: B1-B5 launched) bitwise the same solve of the
     in-memory problem, cost and PCG steps per iteration. Last the C API
     (capi.py and its embedding shim, built here with g++: its seconds):
     (a) in this process, a CProblem on the card with ctypes callbacks (the
     67-point exponential fit of tests/test_c_api.py, one more block under
     a stock Huber loss and one under a C loss callback) against the same
     CProblem on the CPU (CERES_TPU_TORCH_C_API_DEVICE=cpu), float64: the
     same iterations, cost within 1e-9 per iteration, ms per iteration,
     host round trips per evaluation and device reads; (b) the unchanged
     examples/curve_fitting.c linked against the shim and run as a
     program with the device variable unset (on the card): exit 0, its
     final m and c as %g prints them those of a CProblem on the CPU on the
     C file's data.
Then a JSON line describing the kernels, the card's name and power limit,
and the last line {"ok": true, "device": {...}}.

A bound counts what the function must move and compute at the problem's
n observations: each leaf once, its row tables, u or y, the inverse
table and the output. The twins' padding, the chunk tables and the
layout's permutation are the kernels' choices and are not counted.

With `--phase 2` the script stops after phase 2 and prints no result: run
it in two checkouts (say a parent unpacked with `git archive` into a
gitignored directory, and the change) one after another in one call on the
card, parent, change, change, parent, to compare two versions of a kernel.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# BAL-1778 at full size (problem-1778-993923-pnp.txt of the BAL dataset's
# Final set): no cut
NUM_POINTS = 993_923
NUM_OBSERVATIONS = 5_000_000
# NVIDIA's H100 SXM data sheet: device memory rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# and float64 outside the tensor cores
F64_FLOPS_PER_S = 34e12
# B1's float operations per observation, counted from csrc/eval_snavely.cu
# (the large-angle path, an FMA as 2, a sqrt, sincos or quotient as 1): the
# residual chain ~90, R ~45, dR/d(angle-axis) ~180, the projection block and
# the two 2 x 3 by 3 x 3 products ~100, the Huber/Triggs scaling of the 26
# outputs ~150
B1_OPS_PER_OBS = 540
# the residual-only instantiation: the residual chain, Huber, Triggs scale
B1_RES_OPS_PER_OBS = 110
# B1's quaternion instantiations, counted the same way: the rotation ~35
# (no sincos), dp'/dq and dp'/dp ~105, the plus-Jacobian chain (3 x 4 by
# 4 x 3) ~70 with the manifold, the projection block and its products
# ~130, the Huber/Triggs scaling of 26 (28 without the manifold) outputs
# ~150 (~160); residual-only ~90
B1_QUAT_OPS_PER_OBS = {True: 500, False: 460}
B1_QUAT_RES_OPS_PER_OBS = 90
# (name, source, TPU kernel it replaces, tolerance on max|k - p| / max|p|)
KERNELS = [
    ("eval_snavely", "ceres_tpu_torch/csrc/eval_snavely.cu",
     "ceres_tpu/pallas_eval.py:435", 2e-4),
    ("gather_contract", "ceres_tpu_torch/csrc/gather_reduce.cu",
     "ceres_tpu/pallas_onehot.py:111", 1e-5),
    ("contract_reduce", "ceres_tpu_torch/csrc/gather_reduce.cu",
     "ceres_tpu/pallas_onehot.py:142", 1e-4),
    ("schur_sy", "ceres_tpu_torch/csrc/schur_sy.cuh",
     "ceres_tpu/linalg/pallas_schur.py:262", 1e-4),
    ("schur_p0", "ceres_tpu_torch/csrc/schur_p0.cu",
     "ceres_tpu/linalg/pallas_schur.py:442", 1e-4),
    # the bfloat16-leaf instantiations (mixed-precision solves)
    ("gather_contract_bf16", "ceres_tpu_torch/csrc/gather_reduce.cu",
     "ceres_tpu/pallas_onehot.py:111", 1e-5),
    ("contract_reduce_bf16", "ceres_tpu_torch/csrc/gather_reduce.cu",
     "ceres_tpu/pallas_onehot.py:142", 1e-4),
    ("schur_sy_bf16", "ceres_tpu_torch/csrc/schur_sy.cuh",
     "ceres_tpu/linalg/pallas_schur.py:262", 1e-3),
    # the bfloat16 copy of the leaves and twins that the mixed PCG reads:
    # no Pallas kernel (ceres_tpu's astype, XLA's copy); bitwise Tensor.to
    ("leaf_to_bf16", "ceres_tpu_torch/csrc/leaf_to_bf16.cu",
     "none: ceres_tpu/jacobian.py:436 (astype)", 0.0),
]
# with the bfloat16 copy of the leaves and twins that their PCG reads
BF16_KERNELS = {"gather_contract_bf16", "contract_reduce_bf16", "schur_sy_bf16", "leaf_to_bf16"}
# B1's quaternion instantiations: on the camera's product manifold (tangent
# 9; the quaternion main run) and without a manifold (tangent 10)
QUAT_KERNELS = [
    ("eval_snavely_quat", "ceres_tpu_torch/csrc/eval_snavely.cu",
     "ceres_tpu/pallas_eval.py:435", 2e-4),
    ("eval_snavely_quat_nomanifold", "ceres_tpu_torch/csrc/eval_snavely.cu",
     "ceres_tpu/pallas_eval.py:435", 2e-4),
]
QUAT_NAMES = {name for name, *_ in QUAT_KERNELS}
# B1's generic instantiation (functor_codegen.py fills csrc/eval_generic.cuh);
# its residual-only launch counts under eval_generic_residual
GENERIC_KERNELS = [
    ("eval_generic", "ceres_tpu_torch/csrc/eval_generic.cuh", "ceres_tpu/pallas_eval.py:435", 2e-4),
    # the custom-Jacobian branch: a functor with an analytic rule
    ("eval_generic_analytic", "ceres_tpu_torch/csrc/eval_generic.cuh",
     "ceres_tpu/pallas_eval.py:435", 2e-4),
]
GENERIC_NAMES = {"eval_generic", "eval_generic_analytic", "eval_generic_residual"}
# B1's masked launches (a sharded solve's pad lanes) count apart; the
# sharded run (b) of phase 4 is their main path
MASKED_NAMES = {name + "_masked" for name in ("eval_snavely", "eval_snavely_quat",
                                               "eval_snavely_quat_nomanifold") + tuple(GENERIC_NAMES)}
# B2 and B3 over a batch of columns: the contract jax.vmap makes of the
# pallas_calls for the covariance's batched PCG (ceres_tpu/covariance.py:212);
# phase 4's covariance run is their main path, in float64. Tolerance on
# max|k - p| / max|p| in float64: B2 is the same 9-term dot product as its
# plain version, B3 sums ~3,500 observations per camera in another order
# than index_add_ (float32 at BAL-1778: B2's and B3's own tolerances)
BATCHED_KERNELS = [
    ("gather_contract_batched", "ceres_tpu_torch/csrc/gather_reduce.cu",
     "ceres_tpu/pallas_onehot.py:213", 1e-12),
    ("contract_reduce_batched", "ceres_tpu_torch/csrc/gather_reduce.cu",
     "ceres_tpu/pallas_onehot.py:248", 1e-12),
]
# the first versions' kernel ms (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md §6), printed beside this run's
FIRST_BATCHED_MS = {("gather_contract_batched", "Dubrovnik-356"): "1.4345-1.6282",
                   ("gather_contract_batched", "BAL-1778"): "6.4578-6.8710",
                   ("contract_reduce_batched", "Dubrovnik-356"): "2.9553-3.0647",
                   ("contract_reduce_batched", "BAL-1778"): "7.4313-7.5054"}
# the bfloat16 B3 and B4 before their redesign (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §6), printed beside this run's: B3, B4 whole, its point
# pass, its slot pass with the camera combine; this script's phase 2 on
# the first kernels, and profile_torch_solve.py --kernels sy (device ms a
# call in one CUDA graph) on them in turns with the redesigned ones
EARLIER_BF16_MS = {
    "contract_reduce_bf16": "phase 2 0.3196, graph 0.2247-0.2260",
    "schur_sy_bf16": "phase 2 0.3200, graph 0.2479-0.2520",
    "point pass": "phase 2 0.1552, graph 0.1211-0.1243",
    "slot pass": "phase 2 0.1915, graph 0.1212-0.1233",
}
# the redesigned bfloat16 B3 and B4 kernels: phase 1 prints their
# registers and spills
BF16_REDESIGNED = ("sy_point_shared_kernel", "sy_fold_bf16_kernel", "contract_reduce_bf16_kernel")
# B4 at the quaternion cameras' shape without a manifold (r, tf, te): its
# kernels are built from a source of their own (schur_kernels.sy_source);
# the kernels line's schur_sy_t10 takes its launches from phase 4's
# no-manifold quaternion run
QUAT_SY_SHAPE = (2, 10, 3)
QUAT_SY_KERNELS = [
    ("schur_sy_t10", "ceres_tpu_torch/csrc/schur_sy.cuh",
     "ceres_tpu/linalg/pallas_schur.py:262", 1e-4),
]
# B4 at that shape on the generic instantiation it replaced (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md §6-7), printed beside this run's: phase 2's
# CUDA-event ms (PR 7), and profile_torch_solve.py --kernels sy on the
# parent tree of the redesign (device ms a call in one CUDA graph, PR 19)
EARLIER_T10_MS = {"schur_sy": "phase 2 0.7345-0.7561 (PR 7), graph 0.6995-0.7008 (PR 19)",
                  "schur_sy_bf16": "graph 0.7069-0.7076 (PR 19)"}
BATCHED_TOL = {"gather_contract_batched": {"float64": 1e-12, "float32": 1e-5},
               "contract_reduce_batched": {"float64": 1e-12, "float32": 1e-4}}
# with their bfloat16 instantiations, which no path of this script runs
BATCHED_NAMES = {name + sfx for name, *_ in BATCHED_KERNELS for sfx in ("", "_bf16")}
# B1 with its lane mask (JAX's mask_T, pallas_eval.py:435-437), whose main
# path is phase 4's sharded run (b): the angle-axis Snavely group's pad
# lanes on two ranks
MASKED_KERNELS = [
    ("eval_snavely_masked", "ceres_tpu_torch/csrc/eval_snavely.cu",
     "ceres_tpu/pallas_eval.py:435", 2e-4),
]
# the share of lanes phase 2's masks zero
MASK_ZERO_SHARE = 0.125
# phase 4's sharded runs: LM iterations, and the gloo ranks of run (b)
SHARDED_ITERATIONS = 3
SHARDED_RANKS = 2
SHARDED_TIMEOUT = 120  # seconds a rank of run (b) may take (18-24 s spawn to done on one H100)
# the covariance runs: 8 camera blocks and one cross block, 72 columns, as
# ceres_tpu's own test (tests/test_covariance_scale.py:27-29)
COV_COLUMNS = 72
COV_MAX_ITERATIONS = 20_000  # tests/test_covariance_scale.py:40
# multistart TinySolver: Freudenstein-Roth (MGH 2) from 2^20 starts drawn
# over [-20, 20]^2; its global minimum (cost 0 at (5, 4)) and its local
# one (cost 24.4921 at (11.41, -0.8968))
FR_STARTS = 1 << 20
FR_BOX = 20.0
FR_SAMPLED = 1024
# the slice's denoising runs, Fields-of-Experts priors of the published
# shapes (synthetic taps from the seed): (image h, w, clique size, K filters,
# LM iterations). 512 x 512 is the size of the standard denoising test
# images; 213 x 177 that of the reference's own ceres_noisy.pgm run
FOE_RUNS = ((512, 512, 3, 8, 5), (213, 177, 5, 24, 3))
FOE_SIGMA = 20.0
# B1's float32 tolerance covers the dual-number chain (rotation, projection,
# distortion, Huber, Triggs correction) rounded differently from
# torch.func's; B2 is a 9-term dot product; B3/B4/B5 sum ~2,800 observations
# per camera in another order than index_add_. On bfloat16 leaves B2 and B3
# round only the table or u they are given (the same values in kernel and
# plain version), so their float32 tolerances hold; B4 rounds t1, t2 and
# diff, which kernel and plain version sum in other orders, so a few land on
# the other side of a bfloat16 rounding boundary (one term off by 2^-8): 1e-3.
# Phase 3's SCHUR_JACOBI problems have no point seen by one camera only.
# Such a point's EᵀE is singular, and SCHUR_JACOBI's cached correction
# (whose inverse carries only a 100·eps ridge) amplifies rounding there:
# the JAX package itself, fed the same problem with its observations in
# another order, moves its blocks by ~7e-5 and its step by ~2e-6
# (tests/test_torch_schur_jacobi.py::test_lone_points_reference_against_itself),
# far above phase 3's 1e-9. JACOBI keeps the problem with such points.
PARITY_CASES = (
    # (name, preconditioner, extra options, synthetic_bal sizes, cost tolerance)
    ("JACOBI", "JACOBI", {"fused_execution": False}, (96, 10_000, 48_000), 1e-9),
    ("SCHUR_JACOBI", "SCHUR_JACOBI", {"fused_execution": False}, (96, 4000, 48_000), 1e-9),
    ("SCHUR_JACOBI+spse_init", "SCHUR_JACOBI",
     {"use_spse_initialization": True, "fused_execution": False}, (96, 4000, 48_000), 1e-9),
    ("SCHUR_JACOBI fused", "SCHUR_JACOBI", {"fused_execution_chunk_iters": 1},
     (96, 4000, 48_000), 1e-9),
    # bfloat16 matvec leaves whose float32 sums run in another order on the
    # card than on the CPU
    ("SCHUR_JACOBI mixed fused", "SCHUR_JACOBI",
     {"fused_execution_chunk_iters": 1, "use_mixed_precision_solves": True},
     (96, 4000, 48_000), 1e-6),
)
# a composed-path problem: the camera prior's weight
PRIOR_WEIGHT = 0.1
# the host solvers' runs: SPARSE_SCHUR at the shape of BAL's Dubrovnik-356
# (problem-356-226730-pre.txt: cameras, points, observations), its S dense
# under synthetic_bal's uniform visibility (3,204² entries, 126,736 camera
# pairs), which SuperLU factors in seconds where BAL-1778's 16,002² would
# take minutes; the pose graphs at the published shapes of sphere2500.g2o
# (2,500 poses on 50 rings of 50: 2,499 odometry and 2,450 ring-to-ring
# loop-closure edges) and of M3500 (3,500 poses; synthetic_pose_graph_2d
# draws 4,375 edges against M3500's 5,453)
DUBROVNIK_356 = (356, 226_730, 1_255_268)
SPHERE_RINGS = (50, 50)
M3500_POSES = 3500


def kernel_launches() -> dict:
    """The kernel launches counted since the counter table's last reset:
    its launch counters (cuda_lib.LAUNCHES), by name."""
    from ceres_tpu_torch import cuda_lib
    from ceres_tpu_torch.utils.execution_summary import counts

    table = counts()
    return {name: table[name] for name in cuda_lib.LAUNCHES}


def reset_counts():
    """Zero the port's counter table (utils.execution_summary)."""
    from ceres_tpu_torch.utils import execution_summary

    execution_summary.reset_counts()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """`name<f32,args...>` of a template kernel from its mangled name: the
    length-prefixed identifier ending in _kernel, then its template
    arguments (the value type, B1's camera model with its own boolean, then
    integers and booleans)."""
    types = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16"}
    pattern = r"_kernelI(f|d|13__nv_bfloat16)(?:NS_\d+(\w+?Camera)(?:IL[ib](\d+)EE)?E)?((?:L[ib]\d+E)*)"
    for m in re.finditer(pattern, mangled):
        end = m.start() + len("_kernel")
        for size in range(len("_kernel"), end):
            if mangled[:end - size].endswith(str(size)):
                cam = ""
                if m.group(2):
                    cam = f",{m.group(2)}" + (f"<{m.group(3)}>" if m.group(3) else "")
                args = "".join(f",{a}" for a in re.findall(r"L[ib](\d+)E", m.group(4)))
                return f"{mangled[end - size:end]}<{types[m.group(1)]}{cam}{args}>"
    # a template over integers and booleans only (the bfloat16-only kernels)
    for m in re.finditer(r"_kernelI((?:L[ib]\d+E)+)E", mangled):
        end = m.start() + len("_kernel")
        for size in range(len("_kernel"), end):
            if mangled[:end - size].endswith(str(size)):
                args = ",".join(re.findall(r"L[ib](\d+)E", m.group(1)))
                return f"{mangled[end - size:end]}<{args}>"
    return mangled


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas -v output: its name
    (with f32/f64 for the template's type), registers, spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    diff = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max()) or 1.0
    return diff, diff / scale


def median_ms(fn, reps=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps=10) -> float:
    """Median ms of replaying fn()'s launches from one CUDA graph (CUDA
    events around each replay): the device time of the work, without the
    wrapper's host side, as the solve's graphs run it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    t = median_ms(graph.replay, reps)
    del graph
    return t


def bound(nbytes, ops, flops_per_s=F32_FLOPS_PER_S) -> tuple[float, str]:
    """(least ms on the card, what bounds it): the bytes the function must
    move over the memory rate, or its operations over their rate (float32's
    by default), whichever is larger."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / flops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_b2(jac, rows, table, r):
    """F·y as one PyTorch call: an int32-indexed CSR of F [r*n, t*ncols]
    (built here, outside the timed call) times the table [t, ncols] (or
    times the k tables [k, t, ncols] as one dense [t*ncols, k] operand,
    giving [r*n, k]); the port never calls it."""
    import torch

    rt, n = jac.shape
    t, ncols = rt // r, table.shape[-1]
    dev = jac.device
    crow = torch.arange(0, r * n * t + 1, t, dtype=torch.int32, device=dev)
    col = rows.long()[None, :, None] * t + torch.arange(t, device=dev)[None, None, :]
    col = col.expand(r, n, t).reshape(-1).int()
    val = jac.reshape(r, t, n).permute(0, 2, 1).reshape(-1)
    a = torch.sparse_csr_tensor(crow, col, val, (r * n, t * ncols))
    if table.dim() == 3:
        x = table.permute(2, 1, 0).reshape(t * ncols, -1).contiguous()
        return lambda: a @ x
    x = table.T.contiguous().reshape(-1)
    return lambda: (a @ x).reshape(r, n)


def library_b3(jac, rows, u, ncols, r):
    """Fᵀu as one PyTorch call (cuSPARSE SpMV): an int32-indexed CSR of Fᵀ
    [t*ncols, r*n] (row j*ncols + c) (built here, outside the timed call) times u [r, n] (or
    times the k u's [k, r, n] as one dense [r*n, k] operand, giving
    [t*ncols, k]); the port never calls it."""
    import torch

    rt, n = jac.shape
    t = rt // r
    dev = jac.device
    row = torch.arange(t, device=dev)[None, :, None] * ncols + rows.long()[None, None, :]
    col = torch.arange(r, device=dev)[:, None, None] * n + torch.arange(n, device=dev)[None, None, :]
    idx = torch.stack([row.expand(r, t, n).reshape(-1), col.expand(r, t, n).reshape(-1)])
    coo = torch.sparse_coo_tensor(idx, jac.reshape(-1), (t * ncols, r * n)).coalesce()
    del idx
    csr = coo.to_sparse_csr()
    del coo
    a = torch.sparse_csr_tensor(
        csr.crow_indices().int(), csr.col_indices().int(), csr.values(), csr.shape
    )
    if u.dim() == 3:
        x = u.permute(1, 2, 0).reshape(r * n, -1).contiguous()
        return lambda: a @ x
    x = u.reshape(-1)
    return lambda: (a @ x).reshape(t, ncols)


def time_library(name, make, want, results):
    """results[name]["library_ms"]: the median time of one PyTorch call for
    the same function, checked against the kernel's result; None (and the
    reason printed) where that call is not available on this install."""
    import torch

    try:
        fn = make()
        err = rel_err(fn(), want)[1]
        results[name]["library_ms"] = median_ms(fn)
        print(f"phase 2: {name}: library call rel err {err:.3e} vs the kernel", flush=True)
        del fn
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        results[name]["library_ms"] = None
        print(f"phase 2: {name}: library call not timed: {exc}", flush=True)
    torch.cuda.empty_cache()


def record_kernel(results, name, err, fn, plain, nbytes, ops):
    """results[name]: the error against the plain version, the median ms of
    the kernel and of the plain version, the bound for nbytes and ops."""
    t_k, t_p = median_ms(fn), median_ms(plain)
    b_ms, b_by = bound(nbytes, ops)
    results[name] = {"err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}


def report_kernels(results, entries):
    """One phase-2 line per kernel of `entries` (name, source, replaced
    kernel, tolerance) from its record; raise if one disagrees with its
    plain version."""
    for name, _src, _rep, tol in entries:
        res = results[name]
        abs_err, rel = res["err"]
        ok = rel <= tol
        lib = "none" if res["library_ms"] is None else f"{res['library_ms']:.4f} ms"
        print(
            f"phase 2: {name}: max rel err {rel:.3e} (tol {tol:.0e}, max abs {abs_err:.3e}) "
            f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}; {100 * res['bound_ms'] / res['ms']:.1f}% "
            f"of it), library {lib}{'' if ok else '  FAILED'}",
            flush=True,
        )
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")


def b2_branches(label, jac, rows, y, nbytes, ops, tol):
    """Phase 2, B2's two kernels on one bfloat16 input (the shared-memory
    one, which gather_branch picks at this table's size, and the first
    version's): each against the plain version, bitwise equal to each
    other, with its time, its share of the bound, the shared-memory
    kernel's dynamic shared memory per block and ptxas' report of both;
    raise if they differ or disagree."""
    import torch

    from ceres_tpu_torch import cuda_lib
    from ceres_tpu_torch.gather_reduce import gather_branch, gather_contract, gather_contract_plain

    t, ncols = y.shape
    want = gather_contract_plain(jac, rows, y, 2)
    outs = {b: gather_contract(jac, rows, y, 2, branch=b) for b in ("shared", "global")}
    same = torch.equal(outs["shared"], outs["global"])
    err = max(rel_err(o, want)[1] for o in outs.values())
    del want, outs
    times = {b: median_ms(lambda: gather_contract(jac, rows, y, 2, branch=b))
             for b in ("shared", "global")}
    b_ms, b_by = bound(nbytes, ops)
    log = cuda_lib.BUILD_DIR / "build.log"
    regs = []
    for ln in ptxas_report(log.read_text()) if log.exists() else []:
        name, rest = ln.split(": ", 1)
        if name.startswith("gather_contract_kernel<bf16>"):
            regs.append(f"global {rest}")
        elif "gather_contract_shared_kernel" in name:
            regs.append(f"shared {rest}")
    ok = same and err <= tol
    print(f"phase 2: {label} kernels at t {t}, ncols {ncols}: shared memory "
          f"{times['shared']:.4f} ms ({100 * b_ms / times['shared']:.1f}% of the bound), global "
          f"{times['global']:.4f} ms ({100 * b_ms / times['global']:.1f}%), bound {b_ms:.4f} ms "
          f"({b_by}); gather_branch picks {gather_branch(t, ncols, jac.dtype)}; "
          f"{t * ncols * y.element_size() + 16} B of dynamic shared memory per block; bitwise "
          f"equal {same}; max rel err {err:.3e} (tol {tol:.0e}); ptxas {' | '.join(regs)}"
          f"{'' if ok else '  FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: B2's kernels differ or disagree with the plain version")
    return times


def phase_kernels(program, dev, results):
    """Phase 2: every kernel against its plain version at the main path's
    shapes (the problem's own Jacobian, tables and layout), with its bound
    and, for B2 and B3, one PyTorch call for the same function; then the
    twin builds."""
    import torch

    from ceres_tpu_torch import HuberLoss
    from ceres_tpu_torch.eval_kernel import snavely_evaluate, snavely_evaluate_plain
    from ceres_tpu_torch.evaluator import Evaluator, state_tables
    from ceres_tpu_torch.gather_reduce import (
        contract_reduce, contract_reduce_plain, gather_contract, gather_contract_plain,
    )
    from ceres_tpu_torch.jacobian import BlockJacobian, make_twin, scale_twin
    from ceres_tpu_torch.linalg.schur import (
        ete_gram_tables, ete_solver_from_gram, ridge_ete_solver, schur_views,
    )
    from ceres_tpu_torch.linalg.schur_kernels import (
        p0_apply, p0_apply_plain, sy_apply, sy_apply_plain, sy_fold_pass, sy_meta,
        sy_point_pass, sy_tables,
    )

    f32 = torch.float32
    w = 4  # bytes per float32 and per int32
    gen = torch.Generator(device=dev).manual_seed(0)
    ev = Evaluator(program, f32)
    state = program.state_vector(f32)
    meta = program.groups[0]
    garr = ev.arrays["groups"][0]
    st2d = state_tables(program, state)
    p0, p1 = meta.positions
    args = (st2d[p0.a_cls], garr["a_rows"][0], st2d[p1.a_cls], garr["a_rows"][1],
            garr["data"][0], HuberLoss(1.0), True)
    n = meta.n

    def record(name, err, fn, plain, nbytes, ops):
        record_kernel(results, name, err, fn, plain, nbytes, ops)

    # B1
    cost_k, res_k, (j0, j1) = snavely_evaluate(*args)
    cost_p, res_p, (j0_p, j1_p) = snavely_evaluate_plain(*args)
    errs = [rel_err(a, b) for a, b in ((res_k, res_p), (j0, j0_p), (j1, j1_p))]
    errs.append(rel_err(cost_k.reshape(1), cost_p.reshape(1)))
    b1 = (max(e[0] for e in errs), max(e[1] for e in errs))
    del j0_p, j1_p
    ncam, npts = st2d[p0.a_cls].shape[0], st2d[p1.a_cls].shape[0]
    record("eval_snavely", b1, lambda: snavely_evaluate(*args),
           lambda: snavely_evaluate_plain(*args),
           w * (2 * n + 2 * n + 9 * ncam + 3 * npts + 2 * n + 24 * n), B1_OPS_PER_OBS * n)
    # the residual-only launch (the accept step's evaluation): the same
    # gathers and observations in, [2, n] out
    res_args = args[:-1] + (False,)
    cost_r, res_r, _ = snavely_evaluate(*res_args)
    rel = max(rel_err(res_r, res_p)[1], rel_err(cost_r.reshape(1), cost_p.reshape(1))[1])
    r_ms = median_ms(lambda: snavely_evaluate(*res_args))
    rb_ms, rb_by = bound(w * (2 * n + 2 * n + 9 * ncam + 3 * npts + 2 * n), B1_RES_OPS_PER_OBS * n)
    print(f"phase 2: eval_snavely residual-only: max rel err {rel:.3e} (tol 2e-04) kernel "
          f"{r_ms:.4f} ms, bound {rb_ms:.4f} ms ({rb_by}; {100 * rb_ms / r_ms:.1f}% of it); "
          f"with the Jacobian {results['eval_snavely']['ms']:.4f} ms"
          f"{'' if rel <= 2e-4 else '  FAILED'}", flush=True)
    if not rel <= 2e-4:
        raise AssertionError("eval_snavely residual-only: kernel disagrees with its plain version")
    del res_p, res_r

    # the twins of one new Jacobian: F's, made with the leaf; the
    # scale-materialized F's, scaled slot by slot from it; and the
    # materialized E's in camera order (for B4 and B5)
    layout = garr["csr"][0]
    n_pad = layout.perm.shape[0]
    ncols_f = layout.offsets.shape[0] - 1
    f_twin = make_twin(j0, layout)
    scale = 0.5 + torch.rand((ncols_f, 9), generator=gen, device=dev, dtype=f32)
    t_f = median_ms(lambda: make_twin(j0, layout))
    t_s = median_ms(lambda: scale_twin(f_twin, layout, scale, 2))
    t_e = median_ms(lambda: make_twin(j1, layout))
    print(
        f"phase 2: twin builds per new Jacobian: F {t_f:.4f} ms, scaled F from F's twin "
        f"{t_s:.4f} ms, E in camera order {t_e:.4f} ms, total {t_f + t_s + t_e:.4f} ms; "
        f"n_pad {n_pad} ({n_pad - n} padding slots); twin memory "
        f"{w * (18 + 18 + 6) * n_pad / 1e9:.3f} GB",
        flush=True,
    )
    del scale

    # B2 / B3 on the camera leaf
    rows_f = garr["t_rows"][0]
    y = torch.randn((9, ncols_f), generator=gen, device=dev, dtype=f32)
    y[:, -1] = 0
    u = torch.randn((2, n), generator=gen, device=dev, dtype=f32)
    out_b2 = gather_contract(j0, rows_f, y, 2)
    b2 = rel_err(out_b2, gather_contract_plain(j0, rows_f, y, 2))
    record("gather_contract", b2, lambda: gather_contract(j0, rows_f, y, 2),
           lambda: gather_contract_plain(j0, rows_f, y, 2),
           w * (18 * n + n + 9 * ncols_f + 2 * n), 2 * 18 * n)
    time_library("gather_contract", lambda: library_b2(j0, rows_f, y, 2), out_b2, results)
    del out_b2
    out1 = contract_reduce(f_twin, layout, u, 2)
    out2 = contract_reduce(f_twin, layout, u, 2)
    if not torch.equal(out1, out2):
        raise AssertionError("contract_reduce is not bitwise reproducible")
    b3 = rel_err(out1, contract_reduce_plain(f_twin, layout, u, 2))
    # Fᵀu: F, u and the camera row of each observation in, the table out
    record("contract_reduce", b3, lambda: contract_reduce(f_twin, layout, u, 2),
           lambda: contract_reduce_plain(f_twin, layout, u, 2),
           w * (18 * n + 2 * n + n + 9 * ncols_f), 2 * 18 * n)
    time_library("contract_reduce", lambda: library_b3(j0, rows_f, u, ncols_f, 2), out1, results)

    # B4 with the real (E'E + I)^-1 table of this Jacobian, whole and each
    # of its two launches
    sy = sy_meta(program)
    if sy is None:
        raise AssertionError("the BA problem is not on the fused S·y path")
    jac = BlockJacobian.build(program, ev.arrays, [(j0, j1)])
    jac_e, _ = schur_views(program, jac)
    e_mask = torch.as_tensor(program.schur_tangent_masks()[0], dtype=f32, device=dev)
    ete = ete_solver_from_gram(program, ete_gram_tables(program, jac_e), e_mask)
    minv = ete.inv_tables[sy["e_cls"]]
    e_pos, f_pos = sy["e_pos"], sy["f_pos"]
    F, E = j0, j1
    e_twin = jac.twin(0, e_pos, f_pos)
    prow = program.slot_rows(0, e_pos, f_pos, dev)
    segs = sy_tables(sy, dev)
    cnt_e = minv.shape[1]
    dsq = 0.5 + torch.rand((9, ncols_f), generator=gen, device=dev, dtype=f32)
    sy_args = (sy, F, E, rows_f, f_twin, e_twin, prow, layout, y, minv, segs)
    out1, out2 = sy_apply(*sy_args), sy_apply(*sy_args)
    if not torch.equal(out1, out2):
        raise AssertionError("schur_sy is not bitwise reproducible")
    b4 = rel_err(out1, sy_apply_plain(sy, F, E, rows_f, f_twin, layout, y, minv))
    b4_dsq = rel_err(sy_apply(*sy_args, dsq),
                     sy_apply_plain(sy, F, E, rows_f, f_twin, layout, y, minv, dsq))
    b4 = (max(b4[0], b4_dsq[0]), max(b4[1], b4_dsq[1]))
    del out1, out2
    # Fᵀ(I − E M⁻¹ Eᵀ) F y as a function: F and E once, the camera rows, the
    # point buckets (the point rows), y, the inverse table in, the table out
    b4_in = 18 * n + 6 * n + n + segs[0].numel() + segs[1].numel() + 9 * ncols_f + 9 * cnt_e
    record("schur_sy", b4, lambda: sy_apply(*sy_args),
           lambda: sy_apply_plain(sy, F, E, rows_f, f_twin, layout, y, minv),
           w * (b4_in + 9 * ncols_f), n * (4 * 18 + 4 * 6) + cnt_e * 2 * 9)
    t2 = sy_point_pass(sy, F, E, rows_f, y, minv, segs)
    a_ms = median_ms(lambda: sy_point_pass(sy, F, E, rows_f, y, minv, segs))
    b_ms = median_ms(lambda: sy_fold_pass(sy, f_twin, e_twin, prow, layout, y, t2))
    # pass (a): F, E, the camera rows, the buckets, y and the inverse table
    # in, t2 out; pass (b): the twins (not their padding), the point rows, y
    # and t2 in, the table out
    a_bound = bound(w * (b4_in + 3 * cnt_e), n * (2 * 18 + 2 * 6) + cnt_e * 2 * 9)
    b_bound = bound(w * (24 * n + n + 9 * ncols_f + 3 * cnt_e + 9 * ncols_f), n * (4 * 18 + 2 * 6))
    print(f"phase 2: schur_sy launches: point pass {a_ms:.4f} ms (bound {a_bound[0]:.4f} ms, "
          f"{a_bound[1]}), slot pass with its chunk sum {b_ms:.4f} ms (bound {b_bound[0]:.4f} ms, "
          f"{b_bound[1]}); with D_f² y folded in, max rel err {b4_dsq[1]:.3e}", flush=True)
    del ete, t2, dsq
    phase_kernels_bf16(results, sy, j0, j1, rows_f, layout, y, u, e_twin, prow, segs, minv)
    del minv

    # B5 with the ridge (E'E)^-1 table of this Jacobian, as schur_prepare
    # builds it
    e_gram = ete_gram_tables(program, jac_e)
    minv0 = ridge_ete_solver(program, e_gram, jac.squared_column_norms()).inv_records(sy["e_cls"])
    p0_args = (sy, jac.twin(0, f_pos), e_twin, prow, layout, minv0)
    p0_1, p0_2 = p0_apply(*p0_args), p0_apply(*p0_args)
    if not torch.equal(p0_1, p0_2):
        raise AssertionError("schur_p0 is not bitwise reproducible")
    b5 = rel_err(p0_1, p0_apply_plain(*p0_args))
    # F and E once, the camera and the point row of each observation, the
    # inverse table in, the blocks out
    r, te, tf, cnt_f = sy["r"], sy["te"], sy["tf"], sy["cnt_f"]
    record("schur_p0", b5, lambda: p0_apply(*p0_args), lambda: p0_apply_plain(*p0_args),
           w * (r * tf * n + r * te * n + 2 * n + te * te * cnt_e + tf * tf * cnt_f),
           n * (2 * r * te * te + 2 * r * r * te + 2 * r * r * tf + r * tf * (tf + 1)))
    report_kernels(results, KERNELS)
    print("phase 2: contract_reduce, schur_sy and schur_p0 bitwise equal across two runs, "
          "and so are contract_reduce_bf16 and schur_sy_bf16", flush=True)
    phase_prepare(program, jac)


def phase_kernels_bf16(results, sy, F, E, rows_f, layout, y, u, e_twin, prow, segs, minv):
    """Phase 2: B2, B3 and B4 on bfloat16 copies of the leaves and twins
    phase_kernels used (float32 y, u, (EᵀE + I)⁻¹ table and outputs), each
    against its plain version on the same inputs; the bounds count the
    leaves and twins at 2 bytes."""
    import torch

    from ceres_tpu_torch.gather_reduce import (
        contract_reduce, contract_reduce_plain, gather_contract, gather_contract_plain, table_fits,
    )
    from ceres_tpu_torch.jacobian import make_twin
    from ceres_tpu_torch.linalg.schur_kernels import (
        sy_apply, sy_apply_plain, sy_fold_pass, sy_point_pass,
    )

    bf16, w, h = torch.bfloat16, 4, 2  # bytes per float32 / int32, per bfloat16
    n = F.shape[1]
    ncols_f = y.shape[1]
    cnt_e = minv.shape[1]
    F16, E16 = F.to(bf16), E.to(bf16)
    f_twin16, e_twin16 = make_twin(F16, layout), e_twin.to(bf16)

    def record(name, err, fn, plain, nbytes, ops):
        record_kernel(results, name, err, fn, plain, nbytes, ops)

    out = gather_contract(F16, rows_f, y, 2)
    record("gather_contract_bf16", rel_err(out, gather_contract_plain(F16, rows_f, y, 2)),
           lambda: gather_contract(F16, rows_f, y, 2), lambda: gather_contract_plain(F16, rows_f, y, 2),
           h * 18 * n + w * (n + 9 * ncols_f + 2 * n), 2 * 18 * n)
    # cuSPARSE's bfloat16 SpMV takes a bfloat16 vector and writes bfloat16:
    # the same products on the same rounded table, the output rounded
    time_library("gather_contract_bf16",
                 lambda: library_b2(F16, rows_f, y.to(bf16), 2), out, results)
    b2_branches("gather_contract_bf16", F16, rows_f, y, h * 18 * n + w * (n + 9 * ncols_f + 2 * n),
                2 * 18 * n, 1e-5)
    out1, out2 = contract_reduce(f_twin16, layout, u, 2), contract_reduce(f_twin16, layout, u, 2)
    if not torch.equal(out1, out2):
        raise AssertionError("contract_reduce_bf16 is not bitwise reproducible")
    record("contract_reduce_bf16", rel_err(out1, contract_reduce_plain(f_twin16, layout, u, 2)),
           lambda: contract_reduce(f_twin16, layout, u, 2),
           lambda: contract_reduce_plain(f_twin16, layout, u, 2),
           h * 18 * n + w * (2 * n + n + 9 * ncols_f), 2 * 18 * n)
    time_library("contract_reduce_bf16",
                 lambda: library_b3(F16, rows_f, u.to(bf16), ncols_f, 2), out1, results)
    res = results["contract_reduce_bf16"]
    g_ms = graph_ms(lambda: contract_reduce(f_twin16, layout, u, 2))
    print(f"phase 2: contract_reduce_bf16 (8 consecutive slots a thread, 16-byte twin loads, a "
          f"warp a 256-slot piece): {res['ms']:.4f} ms, graph replay {g_ms:.4f} ms, "
          f"{100 * res['bound_ms'] / res['ms']:.1f}% of its bound; before the redesign "
          f"{EARLIER_BF16_MS['contract_reduce_bf16']} ms", flush=True)
    del out, out1, out2

    args = (sy, F16, E16, rows_f, f_twin16, e_twin16, prow, layout, y, minv, segs)
    out1, out2 = sy_apply(*args), sy_apply(*args)
    if not torch.equal(out1, out2):
        raise AssertionError("schur_sy_bf16 is not bitwise reproducible")
    err = rel_err(out1, sy_apply_plain(sy, F16, E16, rows_f, f_twin16, layout, y, minv))
    b4_in = h * 24 * n + w * (n + segs[0].numel() + segs[1].numel() + 9 * ncols_f + 9 * cnt_e)
    record("schur_sy_bf16", err, lambda: sy_apply(*args),
           lambda: sy_apply_plain(sy, F16, E16, rows_f, f_twin16, layout, y, minv),
           b4_in + w * 9 * ncols_f, n * (4 * 18 + 4 * 6) + cnt_e * 2 * 9)
    t2 = sy_point_pass(sy, F16, E16, rows_f, y, minv, segs)
    a_ms = median_ms(lambda: sy_point_pass(sy, F16, E16, rows_f, y, minv, segs))
    b_ms = median_ms(lambda: sy_fold_pass(sy, f_twin16, e_twin16, prow, layout, y, t2))
    a_graph = graph_ms(lambda: sy_point_pass(sy, F16, E16, rows_f, y, minv, segs))
    b_graph = graph_ms(lambda: sy_fold_pass(sy, f_twin16, e_twin16, prow, layout, y, t2))
    a_bound = bound(b4_in + w * 3 * cnt_e, n * (2 * 18 + 2 * 6) + cnt_e * 2 * 9)
    b_bound = bound(h * 24 * n + w * (n + 9 * ncols_f + 3 * cnt_e + 9 * ncols_f),
                    n * (4 * 18 + 2 * 6))
    whole = results["schur_sy_bf16"]
    print(f"phase 2: schur_sy_bf16 launches: point pass {a_ms:.4f} ms, graph replay "
          f"{a_graph:.4f} ms (bound {a_bound[0]:.4f} ms, {a_bound[1]}; {100 * a_bound[0] / a_ms:.1f}% "
          f"of it, {100 * a_bound[0] / a_graph:.1f}% replayed; before the redesign "
          f"{EARLIER_BF16_MS['point pass']} ms), slot pass with its chunk sum {b_ms:.4f} ms, graph "
          f"replay {b_graph:.4f} ms (bound {b_bound[0]:.4f} ms, {b_bound[1]}; "
          f"{100 * b_bound[0] / b_ms:.1f}% of it, {100 * b_bound[0] / b_graph:.1f}% replayed; "
          f"before {EARLIER_BF16_MS['slot pass']} ms); S·y {whole['ms']:.4f} ms (before "
          f"{EARLIER_BF16_MS['schur_sy_bf16']} ms); the two passes' bounds together "
          f"{a_bound[0] + b_bound[0]:.4f} ms, of which S·y's own bound (each leaf read once) is "
          f"{100 * whole['bound_ms'] / (a_bound[0] + b_bound[0]):.1f}%; y table in shared memory: "
          f"{table_fits(9, ncols_f)}; bfloat16 leaves and twins {h * (24 + 24) * n / 1e9:.3f} GB "
          f"against {w * (24 + 24) * n / 1e9:.3f} GB in float32 (not their padding)", flush=True)
    del t2, out1, out2, F16, E16, f_twin16, e_twin16
    torch.cuda.empty_cache()
    copy_bf16(results, [F, E, make_twin(F, layout), e_twin], 24 * 2 * n)


def copy_bf16(results, tensors, values):
    """Phase 2: leaf_to_bf16 (jacobian.bf16_copies) on the main path's
    float32 leaves and twins against Tensor.to(torch.bfloat16), its plain
    version and the library call it replaced: bitwise equal (tolerance 0),
    each timed as the prepare graph runs it (device ms a call of 20 calls
    in one CUDA graph) and eagerly with its host side, five rounds in
    turns; the bound moves
    `values` (the leaves and twins, not the twins' padding) at 4 bytes
    read and 2 written each."""
    import torch

    from ceres_tpu_torch.jacobian import bf16_copies

    bf16 = torch.bfloat16
    got, want = bf16_copies(tensors), [t.to(bf16) for t in tensors]
    same = all(a.shape == b.shape and torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(got, want, strict=True))
    err = max(rel_err(a, b) for a, b in zip(got, want))
    del got, want
    if not same:
        raise AssertionError(f"leaf_to_bf16 is not bitwise Tensor.to (max abs {err[0]:.3e})")

    def kernel():
        return bf16_copies(tensors)

    def plain():
        return [t.to(bf16) for t in tensors]

    def graph_ms_a_call(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        t = median_ms(g.replay) / calls
        del g
        return t

    graph = {"kernel": [], "plain": []}
    eager = {"kernel": [], "plain": []}
    for _ in range(5):
        for name, fn in (("kernel", kernel), ("plain", plain)):
            graph[name].append(graph_ms_a_call(fn))
            eager[name].append(median_ms(fn))
    b_ms, b_by = bound(6 * values, 0)
    t_k, t_p = statistics.median(graph["kernel"]), statistics.median(graph["plain"])
    results["leaf_to_bf16"] = {"err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": t_p}
    print(f"phase 2: leaf_to_bf16 on {len(tensors)} tensors ({sum(t.numel() for t in tensors)} "
          f"values): bitwise Tensor.to; in a graph {t_k:.4f} ms a call against Tensor.to's "
          f"{t_p:.4f} ms (rounds {[round(t, 5) for t in graph['kernel']]} / "
          f"{[round(t, 5) for t in graph['plain']]}), eager "
          f"{statistics.median(eager['kernel']):.4f} ms against "
          f"{statistics.median(eager['plain']):.4f} ms; bound {b_ms:.4f} ms "
          f"({100 * b_ms / t_k:.1f}% of it, Tensor.to {100 * b_ms / t_p:.1f}%)", flush=True)
    torch.cuda.empty_cache()


def lane_mask(n, dev, dtype, seed):
    """A seeded lane mask [n] in `dtype` that zeroes ~MASK_ZERO_SHARE of the
    lanes (a sharded group's pad lanes stand-in)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(n, generator=gen, device=dev) >= MASK_ZERO_SHARE).to(dtype)


def masked_b1(label, launch, plain, mask, nbytes, ops, tol=2e-4):
    """Phase 2, one B1 instantiation with a lane mask: launch(mask) against
    plain(mask) within tol, the masked lanes exactly 0, the others bitwise
    launch(None)'s; the masked and the unmasked launch timed in turns
    (unmasked, masked, masked, unmasked, each the median of 10 runs).
    Returns its record (kernel ms: the masked launch's)."""
    import torch

    got, want, free = launch(mask), plain(mask), launch(None)
    torch.cuda.synchronize()
    dead = mask == 0
    pairs = [(got[1], want[1], free[1])] + list(zip(got[2], want[2], free[2]))
    errs = [rel_err(a, b) for a, b, _ in pairs] + [rel_err(got[0].reshape(1), want[0].reshape(1))]
    err = (max(e[0] for e in errs), max(e[1] for e in errs))
    zero = all(bool((a[:, dead] == 0).all()) for a, _, _ in pairs)
    same = all(torch.equal(a[:, ~dead], f[:, ~dead]) for a, _, f in pairs)
    del got, want, free, pairs
    t_u1 = median_ms(lambda: launch(None))
    t_m1 = median_ms(lambda: launch(mask))
    t_m2 = median_ms(lambda: launch(mask))
    t_u2 = median_ms(lambda: launch(None))
    t_p = median_ms(lambda: plain(mask), reps=3)
    b_ms, b_by = bound(nbytes, ops)
    t_m = 0.5 * (t_m1 + t_m2)
    ok = err[1] <= tol and zero and same
    print(f"phase 2: {label} masked ({int(dead.sum())} of {mask.numel()} lanes): max rel err "
          f"{err[1]:.3e} (tol {tol:.0e}, max abs {err[0]:.3e}); masked lanes 0 {zero}; "
          f"unmasked lanes bitwise the unmasked launch {same}; kernel {t_m1:.4f}/{t_m2:.4f} ms "
          f"masked vs {t_u1:.4f}/{t_u2:.4f} ms unmasked (in turns), plain {t_p:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {100 * b_ms / t_m:.1f}% of it){'' if ok else '  FAILED'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{label} masked: kernel disagrees with its plain version")
    return {"err": err, "ms": t_m, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def phase_kernels_masked(program, dev, results):
    """Phase 2, B1 with a lane mask at the phase-2 widths: the angle-axis
    Snavely group at BAL-1778 (the kernels line's eval_snavely_masked) and
    B1 generic on the Fields-of-Experts 3x3 clique group at 512 x 512. The
    bound counts the mask, the live lanes' inputs and operations and every
    output (a masked lane writes its zeros)."""
    import torch

    from ceres_tpu_torch import HuberLoss, eval_kernel, functor_codegen
    from ceres_tpu_torch.evaluator import Evaluator, group_eval_plain, state_tables

    f32, w = torch.float32, 4
    ev = Evaluator(program, f32)
    st2d = state_tables(program, program.state_vector(f32))
    p0, p1 = program.groups[0].positions
    garr = ev.arrays["groups"][0]
    args = (st2d[p0.a_cls], garr["a_rows"][0], st2d[p1.a_cls], garr["a_rows"][1],
            garr["data"][0], HuberLoss(1.0), True)
    n = program.groups[0].n
    mask = lane_mask(n, dev, f32, 15)
    live = int(mask.sum())
    ncam, npts = st2d[p0.a_cls].shape[0], st2d[p1.a_cls].shape[0]
    results["eval_snavely_masked"] = masked_b1(
        "eval_snavely", lambda m: eval_kernel.snavely_evaluate(*args, m),
        lambda m: eval_kernel.snavely_evaluate_plain(*args, m), mask,
        w * (n + 4 * live + 9 * ncam + 3 * npts + (2 + 18 + 6) * n), B1_OPS_PER_OBS * live,
    )
    del ev, st2d, args, garr
    h, wd, size, k, _iters = FOE_RUNS[0]
    foe = build_foe(h, wd, size, k).compile(dev)
    ev = Evaluator(foe, f32)
    st = state_tables(foe, foe.state_vector(f32))
    meta, garr = foe.groups[1], ev.arrays["groups"][1]
    prog = functor_codegen.group_program(meta, garr, f32, True)
    mask = lane_mask(meta.n, dev, f32, 16)
    live = int(mask.sum())
    tables = [st[pm.a_cls] for pm in meta.positions]

    def with_mask(m):
        return garr if m is None else dict(garr, mask=m)

    masked_b1(
        f"eval_generic FoE {size}x{size} clique ({h}x{wd})",
        lambda m: eval_kernel.generic_evaluate(prog, meta, with_mask(m), st, True),
        lambda m: group_eval_plain(meta, with_mask(m), st, True, True), mask,
        generic_bytes(prog, tables, meta.n, True) + w * meta.n, generic_ops(prog, True) * live,
    )
    del ev, st, foe, tables
    torch.cuda.empty_cache()


def phase_kernels_quat(bal, dev, results):
    """Phase 2, the quaternion cameras at BAL-1778 shapes: B1's quaternion
    instantiations (on the camera's product manifold, tangent 9, and
    without one, tangent 10) with the Jacobian and residual-only against
    their plain versions, on the tables of the no-manifold quaternion
    Program; then B3, B4 and B5 once on the 10-wide Jacobian the
    no-manifold launch writes, against theirs (B4 on the kernels built for
    (r, tf, te) = QUAT_SY_SHAPE, in float32 and on bfloat16 leaves:
    sy_tangent10)."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.eval_kernel import snavely_quat_evaluate, snavely_quat_evaluate_plain
    from ceres_tpu_torch.evaluator import Evaluator, state_tables
    from ceres_tpu_torch.gather_reduce import contract_reduce, contract_reduce_plain
    from ceres_tpu_torch.jacobian import BlockJacobian, make_twin
    from ceres_tpu_torch.linalg.schur import (
        ete_gram_tables, ete_solver_from_gram, ridge_ete_solver, schur_views,
    )
    from ceres_tpu_torch.linalg.schur_kernels import p0_apply, p0_apply_plain, sy_meta, sy_tables

    f32, w = torch.float32, 4
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), use_quaternions=True)
    program = problem.compile(dev)
    ev = Evaluator(program, f32)
    st2d = state_tables(program, program.state_vector(f32))
    meta, garr = program.groups[0], ev.arrays["groups"][0]
    p0, p1 = meta.positions
    n = meta.n
    ncam, npts = st2d[p0.a_cls].shape[0], st2d[p1.a_cls].shape[0]
    print(f"phase 2: quaternion problem + Program (no manifold) in {time.time() - t0:.1f} s",
          flush=True)
    for manifold in (True, False):
        name = "eval_snavely_quat" if manifold else "eval_snavely_quat_nomanifold"
        tan = 9 if manifold else 10
        args = (st2d[p0.a_cls], garr["a_rows"][0], st2d[p1.a_cls], garr["a_rows"][1],
                garr["data"][0], ct.HuberLoss(1.0), True, manifold)
        cost_k, res_k, (j0, j1) = snavely_quat_evaluate(*args)
        cost_p, res_p, (j0_p, j1_p) = snavely_quat_evaluate_plain(*args)
        if tuple(j0.shape) != (2 * tan, n):
            raise AssertionError(f"{name}: jac0 of shape {tuple(j0.shape)}")
        errs = [rel_err(a, b) for a, b in ((res_k, res_p), (j0, j0_p), (j1, j1_p))]
        errs.append(rel_err(cost_k.reshape(1), cost_p.reshape(1)))
        del j0_p, j1_p
        in_bytes = w * (2 * n + 2 * n + 10 * ncam + 3 * npts)
        record_kernel(results, name, (max(e[0] for e in errs), max(e[1] for e in errs)),
                      lambda: snavely_quat_evaluate(*args),
                      lambda: snavely_quat_evaluate_plain(*args),
                      in_bytes + w * (2 + 2 * tan + 6) * n, B1_QUAT_OPS_PER_OBS[manifold] * n)
        if manifold:  # B1 quaternion with a lane mask
            mask = lane_mask(n, dev, f32, 17)
            live = int(mask.sum())
            masked_b1(name, lambda m: snavely_quat_evaluate(*args, m),
                      lambda m: snavely_quat_evaluate_plain(*args, m), mask,
                      w * (n + 4 * live + 10 * ncam + 3 * npts + (2 + 2 * tan + 6) * n),
                      B1_QUAT_OPS_PER_OBS[manifold] * live)
        res_args = args[:-2] + (False, manifold)
        cost_r, res_r, _ = snavely_quat_evaluate(*res_args)
        rel = max(rel_err(res_r, res_p)[1], rel_err(cost_r.reshape(1), cost_p.reshape(1))[1])
        r_ms = median_ms(lambda: snavely_quat_evaluate(*res_args))
        rb_ms, rb_by = bound(in_bytes + w * 2 * n, B1_QUAT_RES_OPS_PER_OBS * n)
        res = results[name]
        print(f"phase 2: {name} residual-only: max rel err {rel:.3e} (tol 2e-04) kernel "
              f"{r_ms:.4f} ms, bound {rb_ms:.4f} ms ({rb_by}; {100 * rb_ms / r_ms:.1f}% of it); "
              f"with the Jacobian {res['ms']:.4f} ms{'' if rel <= 2e-4 else '  FAILED'}",
              flush=True)
        if not rel <= 2e-4:
            raise AssertionError(f"{name} residual-only: kernel disagrees with its plain version")
        del res_p, res_r
        if manifold:
            del j0, j1
    report_kernels(results, QUAT_KERNELS)

    # B3, B4 and B5 on the 10-wide camera leaf j0 [20, n] and E's j1
    sy = sy_meta(program)
    if sy is None or sy["tf"] != 10:
        raise AssertionError("the no-manifold quaternion problem is not on the fused S·y path")
    tf, te, r, cnt_f = sy["tf"], sy["te"], sy["r"], sy["cnt_f"]
    layout = garr["csr"][sy["f_pos"]]
    rows_f = garr["t_rows"][sy["f_pos"]]
    ncols_f = layout.offsets.shape[0] - 1
    f_twin = make_twin(j0, layout)
    u = torch.randn((2, n), generator=gen, device=dev, dtype=f32)
    y = torch.randn((tf, ncols_f), generator=gen, device=dev, dtype=f32)
    y[:, -1] = 0

    def check(name, err, fn, plain, nbytes, ops, tol=1e-4):
        t_k, t_p = median_ms(fn), median_ms(plain)
        b_ms, b_by = bound(nbytes, ops)
        print(f"phase 2: {name} at tangent 10: max rel err {err[1]:.3e} (tol {tol:.0e}) "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{100 * b_ms / t_k:.1f}% of it){'' if err[1] <= tol else '  FAILED'}", flush=True)
        if not err[1] <= tol:
            raise AssertionError(f"{name} at tangent 10: kernel disagrees with its plain version")

    out = contract_reduce(f_twin, layout, u, 2)
    check("contract_reduce", rel_err(out, contract_reduce_plain(f_twin, layout, u, 2)),
          lambda: contract_reduce(f_twin, layout, u, 2),
          lambda: contract_reduce_plain(f_twin, layout, u, 2),
          w * (2 * tf * n + 2 * n + n + tf * ncols_f), 2 * 2 * tf * n)
    del out
    jac = BlockJacobian.build(program, ev.arrays, [(j0, j1)])
    jac_e, _ = schur_views(program, jac)
    e_mask = torch.as_tensor(program.schur_tangent_masks()[0], dtype=f32, device=dev)
    minv = ete_solver_from_gram(program, ete_gram_tables(program, jac_e), e_mask).inv_tables[
        sy["e_cls"]]
    e_twin = jac.twin(0, sy["e_pos"], sy["f_pos"])
    prow = program.slot_rows(0, sy["e_pos"], sy["f_pos"], dev)
    segs = sy_tables(sy, dev)
    cnt_e = minv.shape[1]
    sy_tangent10(results, sy, j0, j1, rows_f, f_twin, e_twin, prow, layout, y, minv, segs)
    del minv
    minv0 = ridge_ete_solver(program, ete_gram_tables(program, jac_e),
                             jac.squared_column_norms()).inv_records(sy["e_cls"])
    p0_args = (sy, jac.twin(0, sy["f_pos"]), e_twin, prow, layout, minv0)
    check("schur_p0", rel_err(p0_apply(*p0_args), p0_apply_plain(*p0_args)),
          lambda: p0_apply(*p0_args), lambda: p0_apply_plain(*p0_args),
          w * (r * tf * n + r * te * n + 2 * n + te * te * cnt_e + tf * tf * cnt_f),
          n * (2 * r * te * te + 2 * r * r * te + 2 * r * r * tf + r * tf * (tf + 1)))
    del problem, program, ev, jac, jac_e, f_twin, e_twin, j0, j1, p0_args, minv0
    torch.cuda.empty_cache()


def sy_tangent10(results, sy, F, E, rows_f, f_twin, e_twin, prow, layout, y, minv, segs):
    """Phase 2, B4 at the no-manifold quaternion shape on the kernels built
    for it: in float32 (results["schur_sy_t10"], the kernels line's entry)
    and on bfloat16 copies of the leaves and twins, each against its plain
    version, bitwise across two runs, S·y and each launch by CUDA events and
    by a graph replay beside its bound, and S·y beside EARLIER_T10_MS."""
    import torch

    from ceres_tpu_torch.jacobian import make_twin
    from ceres_tpu_torch.linalg.schur_kernels import (
        sy_apply, sy_apply_plain, sy_fold_pass, sy_point_pass,
    )

    if (sy["r"], sy["tf"], sy["te"]) != QUAT_SY_SHAPE or sy["source"] is None:
        raise AssertionError(f"B4 at tangent 10: shape {(sy['r'], sy['tf'], sy['te'])}, "
                             f"source {sy['source'] is not None}")
    r, tf, te = QUAT_SY_SHAPE
    n, ncols_f, cnt_e = F.shape[1], y.shape[1], minv.shape[1]
    w, h = 4, 2  # bytes per float32 / int32, per bfloat16
    tables = w * (n + segs[0].numel() + segs[1].numel() + tf * ncols_f + te * te * cnt_e)
    ops = n * (4 * r * tf + 4 * r * te) + cnt_e * 2 * te * te
    for dt, name, tol in ((torch.float32, "schur_sy", 1e-4), (torch.bfloat16, "schur_sy_bf16", 1e-3)):
        lw = w if dt == torch.float32 else h
        Fd, Ed = F.to(dt), E.to(dt)
        ft, et = (f_twin, e_twin) if dt == torch.float32 else (make_twin(Fd, layout), e_twin.to(dt))
        args = (sy, Fd, Ed, rows_f, ft, et, prow, layout, y, minv, segs)
        out1, out2 = sy_apply(*args), sy_apply(*args)
        same = torch.equal(out1, out2)
        err = rel_err(out1, sy_apply_plain(sy, Fd, Ed, rows_f, ft, layout, y, minv))
        del out1, out2
        t_k = median_ms(lambda: sy_apply(*args))
        t_p = median_ms(lambda: sy_apply_plain(sy, Fd, Ed, rows_f, ft, layout, y, minv))
        g_k = graph_ms(lambda: sy_apply(*args))
        b_ms, b_by = bound(lw * r * (tf + te) * n + tables + w * tf * ncols_f, ops)
        t2 = sy_point_pass(sy, Fd, Ed, rows_f, y, minv, segs)
        a_ms = graph_ms(lambda: sy_point_pass(sy, Fd, Ed, rows_f, y, minv, segs))
        f_ms = graph_ms(lambda: sy_fold_pass(sy, ft, et, prow, layout, y, t2))
        # pass (a): the leaves, camera rows, buckets, y, the inverse table in,
        # t2 out; pass (b): the twins (not their padding), the point rows, y
        # and t2 in, the table out
        a_b = bound(lw * r * (tf + te) * n + tables + w * te * cnt_e,
                    n * (2 * r * tf + 2 * r * te) + cnt_e * 2 * te * te)
        f_b = bound(lw * r * (tf + te) * n + w * (n + 2 * tf * ncols_f + te * cnt_e),
                    n * (4 * r * tf + 2 * r * te))
        ok = same and err[1] <= tol
        earlier = EARLIER_T10_MS.get(name)
        print(f"phase 2: {name} at tangent 10 (the kernels built for (r, tf, te) = "
              f"{QUAT_SY_SHAPE}): max rel err {err[1]:.3e} (tol {tol:.0e}, max abs {err[0]:.3e}); "
              f"bitwise across two runs {same}; S·y {t_k:.4f} ms, graph replay {g_k:.4f} ms, "
              f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {100 * b_ms / t_k:.1f}% of it, "
              f"{100 * b_ms / g_k:.1f}% replayed); point pass {a_ms:.4f} ms (bound "
              f"{a_b[0]:.4f} ms, {100 * a_b[0] / a_ms:.1f}%), slot pass with its chunk sum "
              f"{f_ms:.4f} ms (bound {f_b[0]:.4f} ms, {100 * f_b[0] / f_ms:.1f}%), graph replays"
              f"{'' if earlier is None else f'; EARLIER generic instantiation {earlier} ms'}"
              f"{'' if ok else '  FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} at tangent 10: kernel disagrees with its plain version "
                                 f"or is not bitwise reproducible")
        if dt == torch.float32:
            results["schur_sy_t10"] = {"err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                                       "bound_by": b_by, "library_ms": None}
        del Fd, Ed, ft, et, t2, args
    torch.cuda.empty_cache()


def phase_prepare(program, jac):
    """Phase 2, last line: schur_prepare's device time per new Jacobian
    (the Jacobi-scaled Jacobian, as the solve hands it over) for each
    preconditioner, without and with mixed-precision solves."""
    import torch

    from ceres_tpu_torch.linalg.schur import schur_prepare

    jac_s = jac.scale_columns(1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
    times = {}
    for name in ("JACOBI", "SCHUR_JACOBI"):
        for mixed in (False, True):
            options = lm_options("cuda", torch.float32, preconditioner_type=name,
                                 use_mixed_precision_solves=mixed)
            times[name + (" mixed" if mixed else "")] = median_ms(
                lambda: schur_prepare(program, options, jac_s), reps=5)
    print(
        "phase 2: schur_prepare per new Jacobian: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
        flush=True,
    )


def lm_options(device, dtype, preconditioner_type="SCHUR_JACOBI", **overrides):
    import ceres_tpu_torch as ct

    kw = dict(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=getattr(ct.PreconditionerType, preconditioner_type),
        eta=0.1,
        max_linear_solver_iterations=25,
        max_num_iterations=5,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
        logging_type=ct.LoggingType.SILENT,
        dtype=dtype,
        device=device,
    )
    kw.update(overrides)
    return ct.SolverOptions(**kw)


def phase_f64_parity():
    """Phase 3: the same float64 solve on the card and on the CPU, for each
    preconditioner case."""
    import torch

    import ceres_tpu_torch as ct

    for name, precond, extra, sizes, tol in PARITY_CASES:
        bal = ct.synthetic_bal(*sizes, seed=1)
        sums = {}
        for dev in ("cuda", "cpu"):
            problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
            reset_counts()
            sums[dev] = ct.solve(lm_options(dev, torch.float64, precond, **extra), problem)
            if dev == "cuda":
                launches = kernel_launches()
        worst = 0.0
        for a, b in zip(sums["cuda"].iterations, sums["cpu"].iterations, strict=True):
            worst = max(worst, abs(a.cost - b.cost) / abs(b.cost))
            if (a.linear_solver_iterations, a.step_is_successful) != (
                b.linear_solver_iterations, b.step_is_successful
            ):
                raise AssertionError(f"{name}, iteration {a.iteration}: CUDA and CPU solves diverge")
        print(
            f"phase 3: {name}: float64 synthetic_bal{sizes} solve, CUDA vs CPU: "
            f"{len(sums['cpu'].iterations)} iterations, max per-iteration cost rel diff "
            f"{worst:.3e} (tol {tol:.0e}), pcg {[it.linear_solver_iterations for it in sums['cuda'].iterations]}, "
            f"final cost {sums['cuda'].final_cost:.12e}, launches {json.dumps(launches)}",
            flush=True,
        )
        if not worst <= tol:
            raise AssertionError(f"{name}: float64 CUDA solve disagrees with the CPU solve")
        fused = extra.get("fused_execution", True)
        if not sums["cuda"].used_fused_execution == sums["cpu"].used_fused_execution == fused:
            raise AssertionError(f"{name}: the solve did not take the {'fused' if fused else 'host'} loop")
        # the BA structure's mixed PCG runs B4's bfloat16 instantiation only
        mixed = extra.get("use_mixed_precision_solves", False)
        unused = {"schur_sy"} if mixed else set(BF16_KERNELS)
        unused |= {"gather_contract_bf16", "contract_reduce_bf16"} | QUAT_NAMES | GENERIC_NAMES
        unused |= MASKED_NAMES
        unused |= BATCHED_NAMES
        if precond == "JACOBI":
            unused.add("schur_p0")
        missing = [k for k, v in launches.items() if v <= 0 and k not in unused]
        if missing:
            raise AssertionError(f"{name}: the CUDA solve did not launch {missing}")
        if mixed and launches["schur_sy"] != 0:
            raise AssertionError(f"{name}: the mixed PCG launched B4's float32 instantiation")


def build_prior_problem(bal):
    """The composed-path problem: BAL-1778 with a second residual group, a
    prior pulling every camera toward its start (9 residuals per camera).
    With two groups B4 does not apply (schur_kernels.sy_meta), so the PCG
    runs the composed products, B2 and B3 on the cameras' onehot plan."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.examples.snavely import snavely_reprojection_error

    def camera_prior(params, data):
        return PRIOR_WEIGHT * (params[0] - data[0])

    problem = ct.Problem()
    cams = problem.add_parameter_blocks(bal.cameras)
    pts = problem.add_parameter_blocks(bal.points)
    problem.add_residual_blocks(
        ct.CostFunction(camera_prior, 9, name="camera_prior"), None, cams[:, None], (bal.cameras,)
    )
    problem.add_residual_blocks(
        ct.CostFunction(snavely_reprojection_error, 2, name="snavely", kernel="snavely"),
        ct.HuberLoss(1.0), np.stack([cams[bal.camera_index], pts[bal.point_index]], axis=1),
        (bal.observations,),
    )
    return problem


def run_main_path(bal, precond, build=None, label=None, **overrides):
    """One full-size float32 solve on a new Problem (build_ba_problem's, or
    `build(bal)`, named `label` in its line), so that its preprocess and
    first iteration pay every one-time cost a user's solve pays; the launch
    counts are set to 0 just before it and read just after."""
    import torch

    import ceres_tpu_torch as ct

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    if build is None:
        problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    else:
        problem = build(bal)
    t_problem = time.time() - t0
    options = lm_options("cuda", torch.float32, precond, **overrides)
    reset_counts()
    t0 = time.time()
    summary = ct.solve(options, problem)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernel_launches()
    finite = all(math.isfinite(it.cost) for it in summary.iterations) and bool(
        np.isfinite(problem.compile().state0).all()
    )
    loop = "fused" if summary.used_fused_execution else "host loop"
    if overrides.get("use_mixed_precision_solves"):
        loop += ", mixed"
    if label is not None:
        loop += ", " + label
    ex = summary.execution_summary
    captures = [n for n in ex.names() if n.startswith("CUDAGraph::Capture ")]
    print(
        f"phase 4: {precond} ({loop}): Problem built in {t_problem:.1f} s; solve {wall:.1f} s "
        f"(preprocess {summary.preprocessor_time_in_seconds:.1f} s: Program, Schur ordering, "
        f"uploads), initial cost {summary.initial_cost!r}, final cost {summary.final_cost!r}, "
        f"{summary.termination_type.value}, launches {json.dumps(launches)}; device reads "
        f"{summary.num_device_reads}, graph replays {summary.num_graph_replays}, graph "
        f"captures {sum(ex.calls(n) for n in captures)} in "
        f"{1000.0 * sum(ex.seconds(n) for n in captures):.1f} ms",
        flush=True,
    )
    if not finite:
        raise AssertionError(f"{precond}: non-finite cost or state")
    if not summary.final_cost < summary.initial_cost:
        raise AssertionError(f"{precond}: the solve did not decrease the cost")
    return summary, launches


def sharded_solve(bal, mesh):
    """One sharded float32 solve of `bal` (Huber(1.0), LM + ITERATIVE_SCHUR +
    SCHUR_JACOBI, SHARDED_ITERATIONS iterations, chunk 1) on this rank's
    shard of `mesh`, on a new Problem; the launch and all-reduce counts set
    to 0 just before it and read just after. Returns what the rank prints
    and the parent checks."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.utils.execution_summary import counts

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    t_problem = time.time() - t0
    options = lm_options("cuda", torch.float32, "SCHUR_JACOBI", mesh=mesh,
                         fused_execution_chunk_iters=1, max_num_iterations=SHARDED_ITERATIONS)
    reset_counts()
    t0 = time.time()
    summary = ct.solve(options, problem)
    torch.cuda.synchronize()
    wall = time.time() - t0
    table = counts()
    program = problem.compile(mesh.device)
    rank, ndev = mesh.rank, mesh.size
    pads = lanes = 0
    for lay in program.build_shard_layout(ndev).values():
        L = lay["lanes_per_shard"]
        pads += int((lay["perm"][rank * L : (rank + 1) * L] < 0).sum())
        lanes += L
    return {
        "iterations": [(it.iteration, it.cost, it.linear_solver_iterations,
                        it.step_is_successful, 1000.0 * it.iteration_time_in_seconds,
                        it.num_device_reads) for it in summary.iterations],
        "initial_cost": summary.initial_cost, "final_cost": summary.final_cost,
        "fused": summary.used_fused_execution, "launches": kernel_launches(),
        "collectives": {"all_reduce": table["Mesh::AllReduce"],
                        "all_reduce_bytes": table["Mesh::AllReduce::Bytes"]},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "pad_lanes": pads, "lanes": lanes,
        "problem_s": t_problem, "preprocess_s": summary.preprocessor_time_in_seconds,
        "solve_s": wall, "finite": bool(np.isfinite(program.state0).all()),
    }


def _sharded_rank(rank, world, port, data_dir, queue):
    """A rank of phase 4's run (b), spawned: gloo on cuda:0 (the ranks share
    the card), the BAL arrays the parent saved, the observations read
    through a LazyRows (the rank reads only its own rows)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.io.lazy import ArraySource, LazyRows
    from ceres_tpu_torch.parallel import distributed

    try:
        distributed.initialize("gloo", f"tcp://localhost:{port}", world, rank, "cuda:0",
                               timeout_seconds=SHARDED_TIMEOUT)

        def load(name):
            return np.load(os.path.join(data_dir, name + ".npy"), mmap_mode="r")

        bal = ct.BalProblem(np.array(load("cameras")), np.array(load("points")),
                            np.array(load("camera_index")), np.array(load("point_index")),
                            LazyRows(ArraySource(load("observations"))))
        queue.put((rank, sharded_solve(bal, distributed.global_mesh())))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _collect_ranks(procs, queue):
    """{rank: its result} from the spawned ranks; raises when one exits
    without a result or SHARDED_TIMEOUT passes."""
    import queue as queue_mod

    outs, t0 = {}, time.time()
    while len(outs) < len(procs):
        try:
            rank, out = queue.get(timeout=5)
            outs[rank] = out
            continue
        except queue_mod.Empty:
            pass
        dead = [r for r, p in enumerate(procs) if r not in outs and p.exitcode not in (None, 0)]
        if dead or time.time() - t0 > SHARDED_TIMEOUT:
            raise AssertionError(f"run (b): ranks {dead or 'all'} ended without a result "
                                 f"(exit codes {[p.exitcode for p in procs]})")
    return outs


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _check_sharded(label, out, main, tols):
    """Run `out` held to the unsharded main run's first SHARDED_ITERATIONS
    iterations: the same PCG counts and accept sequence, the initial cost
    within 1e-6, each iteration's cost within tols[i]; prints its lines."""
    coll = out["collectives"]
    k = len(out["iterations"]) - 1
    print(f"phase 4: {label}: {'fused' if out['fused'] else 'host loop'}; Problem built in "
          f"{out['problem_s']:.1f} s, preprocess {out['preprocess_s']:.1f} s, solve "
          f"{out['solve_s']:.1f} s; pad lanes {out['pad_lanes']} of {out['lanes']}; all-reduces "
          f"{coll['all_reduce']} ({coll['all_reduce'] / max(k, 1):.1f} per iteration), "
          f"{coll['all_reduce_bytes'] / 1e6:.1f} MB ({coll['all_reduce_bytes'] / 1e6 / max(k, 1):.1f} "
          f"MB per iteration); peak {out['peak_gb']:.2f} GB; launches "
          f"{json.dumps({n: v for n, v in out['launches'].items() if v})}", flush=True)
    ok = out["finite"] and k == SHARDED_ITERATIONS
    for (i, cost, pcg, acc, ms, reads), ref, tol in zip(out["iterations"], main.iterations, tols):
        gap = abs(cost - ref.cost) / abs(ref.cost)
        same = i == 0 or (pcg, acc) == (ref.linear_solver_iterations, ref.step_is_successful)
        good = same and gap <= (1e-6 if i == 0 else tol)
        ok = ok and good
        print(f"phase 4: {label}: iter {i}: cost {cost!r} pcg {pcg} "
              f"{'accepted' if acc else 'rejected'} ms {ms:.1f} reads {reads} | unsharded cost "
              f"{ref.cost!r} pcg {ref.linear_solver_iterations}: rel gap {gap:.3e} (tol "
              f"{1e-6 if i == 0 else tol:.3e}){'' if good else '  FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the sharded solve parts from the unsharded one")


def phase_sharded_runs(bal, main):
    """Phase 4, the sharded solves at BAL-1778 (float32, SCHUR_JACOBI,
    SHARDED_ITERATIONS iterations), each held to the unsharded main run
    (_check_sharded). The tolerance of iteration i is the larger of 1e-5
    and 10x the gap to the main run of an unsharded run whose observations
    are permuted (another summation order, measured here). (a) one NCCL
    rank on the card: the fused loop, its all-reduces captured in the
    graphs; (b) SHARDED_RANKS gloo ranks that share the card, spawned, on
    the host loop; their pad lanes must be > 0 (B1's mask at work).
    Returns run (b)'s launches, summed over its ranks."""
    import multiprocessing
    import tempfile

    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.parallel import distributed

    perm = np.random.default_rng(3).permutation(bal.num_observations)
    permuted, _ = run_main_path(
        ct.BalProblem(bal.cameras, bal.points, bal.camera_index[perm], bal.point_index[perm],
                      bal.observations[perm]),
        "SCHUR_JACOBI", label="observations permuted", fused_execution_chunk_iters=1,
        max_num_iterations=SHARDED_ITERATIONS,
    )
    gaps = [abs(a.cost - b.cost) / abs(b.cost) for a, b in zip(permuted.iterations, main.iterations)]
    tols = [max(1e-5, 10.0 * g) for g in gaps]
    print(f"phase 4: unsharded run with permuted observations vs the main run: per-iteration "
          f"cost gaps {', '.join(f'{g:.3e}' for g in gaps)}; tolerances "
          f"{', '.join(f'{t:.3e}' for t in tols)}", flush=True)
    del permuted

    distributed.initialize("nccl", f"tcp://localhost:{_free_port()}", 1, 0, "cuda:0")
    try:
        run_a = sharded_solve(bal, distributed.global_mesh())
    finally:
        torch.distributed.destroy_process_group()
    if not run_a["fused"]:
        raise AssertionError("run (a): the NCCL mesh did not take the fused loop")
    _check_sharded("sharded (a) 1 NCCL rank", run_a, main, tols)

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as data_dir:
        for name in ("cameras", "points", "camera_index", "point_index", "observations"):
            np.save(os.path.join(data_dir, name + ".npy"), getattr(bal, name))
        ctx = multiprocessing.get_context("spawn")
        queue = ctx.Queue()
        port = _free_port()
        procs = [ctx.Process(target=_sharded_rank, args=(r, SHARDED_RANKS, port, data_dir, queue))
                 for r in range(SHARDED_RANKS)]
        for p in procs:
            p.start()
        try:
            outs = _collect_ranks(procs, queue)
        finally:
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.terminate()
    failed = {r: o["error"] for r, o in outs.items() if "error" in o}
    if failed:
        raise AssertionError(f"run (b): ranks failed: {failed}")
    print(f"phase 4: sharded (b) {SHARDED_RANKS} gloo ranks on one card: spawned and done in "
          f"{time.time() - t0:.1f} s; pad lanes per rank "
          f"{[outs[r]['pad_lanes'] for r in range(SHARDED_RANKS)]}", flush=True)
    for r in range(SHARDED_RANKS):
        _check_sharded(f"sharded (b) rank {r} of {SHARDED_RANKS} gloo", outs[r], main, tols)
    costs = [[it[1:4] for it in outs[r]["iterations"]] for r in range(SHARDED_RANKS)]
    if any(c != costs[0] for c in costs):
        raise AssertionError("run (b): the ranks left lockstep")
    if sum(outs[r]["pad_lanes"] for r in range(SHARDED_RANKS)) <= 0:
        raise AssertionError("run (b): no pad lanes: the mask did no work")
    if any(outs[r]["fused"] for r in range(SHARDED_RANKS)):
        raise AssertionError("run (b): a gloo mesh took the fused loop")
    launches = collections.Counter()
    for r in range(SHARDED_RANKS):
        launches.update(outs[r]["launches"])
    if not launches["eval_snavely_masked"] or launches["eval_snavely"]:
        raise AssertionError("run (b): B1 did not run masked on every evaluation")
    if launches["schur_sy"] or launches["schur_p0"]:
        raise AssertionError("run (b): B4 or B5 ran on a shard")
    return dict(launches)


def build_quaternion_problem(bal, use_manifolds=True):
    import ceres_tpu_torch as ct

    return ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), use_quaternions=True,
                               use_manifolds=use_manifolds)[0]


def phase_quaternion_runs(bal, main):
    """Phase 4, the quaternion main run: the same data with cameras [q | t |
    f k1 k2] on Quaternion x Euclidean(6) (B1's quaternion instantiation and
    B2-B5), SCHUR_JACOBI on the fused loop at chunk 1, 5 iterations, per
    iteration beside the angle-axis main run `main`; then 3 iterations
    without the manifold (tangent 10: B4 built for its shape). Each
    starts within 1e-5 relative of the angle-axis run's cost (the same
    data in another parameterisation) and lowers it. Returns the quaternion
    kernels' launches, each from its run."""
    out, sums = {}, {}
    runs = (("quaternion", True, {}), ("quaternion, no manifold", False,
                                      {"max_num_iterations": 3}))
    for label, manifold, extra in runs:
        summary, counts = run_main_path(
            bal, "SCHUR_JACOBI", build=lambda b: build_quaternion_problem(b, manifold),
            label=label, fused_execution_chunk_iters=1, **extra)
        sums[manifold] = summary
        b1 = "eval_snavely_quat" if manifold else "eval_snavely_quat_nomanifold"
        out[b1] = counts[b1]
        if not manifold:  # B4 at tangent 10: the kernels built for QUAT_SY_SHAPE
            out["schur_sy_t10"] = counts["schur_sy"]
        if not summary.used_fused_execution:
            raise AssertionError(f"the {label} run did not take the fused loop")
        missing = [k for k in (b1, "gather_contract", "contract_reduce", "schur_sy", "schur_p0")
                   if counts[k] <= 0]
        if missing or counts["eval_snavely"]:
            raise AssertionError(f"the {label} run: kernels not launched {missing}, angle-axis "
                                 f"B1 launched {counts['eval_snavely']} times")
        for a, b in zip(main.iterations, summary.iterations):
            print(f"phase 4: iter {a.iteration}: angle-axis {_iteration_line(a)} | {label} "
                  f"{_iteration_line(b)}", flush=True)
        rel = abs(summary.initial_cost - main.initial_cost) / abs(main.initial_cost)
        print(f"phase 4: {label} vs angle-axis initial cost rel diff {rel:.3e} (tol 1e-5)",
              flush=True)
        if not rel <= 1e-5:
            raise AssertionError(f"the {label} run starts at another cost than the angle-axis run")
    gaps = []
    for a, b in zip(sums[True].iterations, sums[False].iterations):
        print(f"phase 4: iter {a.iteration}: quaternion {_iteration_line(a)} | no manifold "
              f"{_iteration_line(b)}", flush=True)
        if a.iteration > 0:
            gaps.append(1000.0 * (b.iteration_time_in_seconds - a.iteration_time_in_seconds))
    print(f"phase 4: no manifold minus manifold iteration ms (iterations 1-{len(gaps)}): "
          f"{', '.join(f'{g:.1f}' for g in gaps)}", flush=True)
    return out


CLUSTER_RUNS = (("CLUSTER_JACOBI", "CANONICAL_VIEWS"), ("CLUSTER_TRIDIAGONAL", "SINGLE_LINKAGE"))


def _cluster_sizes(plan) -> str:
    sizes = sorted((len(m) for m in plan.members), reverse=True)
    if len(sizes) <= 8:
        return f"sizes {sizes}"
    counts = collections.Counter(sizes)
    return "sizes " + ", ".join(f"{n} x {size}" for size, n in sorted(counts.items()))


def visibility_timings(program, kind, clustering):
    """Phase 4: the visibility preconditioner of a finished CLUSTER run, at
    its final state (Jacobi-scaled Jacobian, D² at radius 1e4): the plan
    the run cached on its Program, and the device ms of the assembly (pair
    corrections, FᵀF, the dense blocks), the factorization and one apply
    (CUDA events, medians of 3, 3 and 5)."""
    import torch

    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.linalg import schur
    from ceres_tpu_torch.linalg.visibility import VisibilityPreconditioner

    _, _, jac, grad = Evaluator(program, torch.float32).evaluate_groups(
        program.state_vector(torch.float32))
    colnorm = jac.squared_column_norms()
    scale = 1.0 / (1.0 + torch.sqrt(colnorm))
    dsq = torch.clamp(colnorm * scale * scale, 1e-6, 1e32) / 1e4
    e_mask, f_mask = schur._masks(program, dsq)
    jac_e, jac_f = schur.schur_views(program, jac.scale_columns(scale).materialize_scale())
    ete = schur.make_ete_solver(program, jac_e, dsq * e_mask)
    dsq_f = dsq * f_mask
    prec = VisibilityPreconditioner(program, jac_e, jac_f, ete, dsq_f, kind, clustering)
    plan = prec.plan
    t_asm = median_ms(lambda: prec._assemble(jac_e, jac_f, ete, dsq_f), reps=3, warmup=1)
    dense, corr = prec._assemble(jac_e, jac_f, ete, dsq_f)
    t_fac = median_ms(lambda: prec._factor(dense, corr), reps=3, warmup=1)
    r = grad * scale * f_mask
    t_apply = median_ms(lambda: prec(r), reps=5, warmup=1)
    if not bool(torch.isfinite(prec(r)).all()):
        raise AssertionError(f"{kind.value}: the preconditioner is not finite")
    chains = ""
    if plan.chains is not None:
        chains = f", {len(plan.chains)} chains, K {plan.K}, L {plan.L}"
    print(
        f"phase 4: {kind.value} ({clustering.value}): {plan.n_clusters} clusters, "
        f"{_cluster_sizes(plan)}{chains}; storage {plan.storage_floats:.3e} floats "
        f"({4e-9 * plan.storage_floats:.2f} GB in float32), {plan.num_pairs} pair blocks per "
        f"build; host plan {plan.seconds:.1f} s; assembly {t_asm:.2f} ms, factorization "
        f"{t_fac:.2f} ms, apply {t_apply:.3f} ms (CUDA events)",
        flush=True,
    )


def phase_cluster_runs(bal, main):
    """Phase 4, the visibility preconditioners: CLUSTER_JACOBI on canonical
    views and CLUSTER_TRIDIAGONAL on single linkage, 3 iterations each on
    the fused loop (the step unsplit, its PCG matvec B4), per iteration
    beside the SCHUR_JACOBI main run `main`, with B1 and B4 launched and B5
    not; each preconditioner's plan and build times; then the refusal of
    CLUSTER_TRIDIAGONAL on canonical views, raised by the host plan before
    any block is allocated."""
    import torch

    import ceres_tpu_torch as ct

    for kind, clustering in CLUSTER_RUNS:
        made = []

        def build(b):
            made.append(ct.build_ba_problem(b, loss=ct.HuberLoss(1.0))[0])
            return made[-1]

        clustering = getattr(ct.VisibilityClusteringType, clustering)
        summary, counts = run_main_path(
            bal, kind, build=build, label=clustering.value, fused_execution_chunk_iters=1,
            max_num_iterations=3, visibility_clustering_type=clustering)
        if not summary.used_fused_execution:
            raise AssertionError(f"the {kind} run did not take the fused loop")
        if counts["eval_snavely"] <= 0 or counts["schur_sy"] <= 0 or counts["schur_p0"]:
            raise AssertionError(f"the {kind} run: B1 or B4 not launched, or B5 launched")
        for a, b in zip(main.iterations, summary.iterations):
            print(f"phase 4: iter {a.iteration}: SCHUR_JACOBI {_iteration_line(a)} | {kind} "
                  f"{_iteration_line(b)}", flush=True)
        visibility_timings(made[0].compile(), getattr(ct.PreconditionerType, kind), clustering)
        del made
        gc.collect()
        torch.cuda.empty_cache()

    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    options = lm_options("cuda", torch.float32, "CLUSTER_TRIDIAGONAL", max_num_iterations=1,
                         visibility_clustering_type=ct.VisibilityClusteringType.CANONICAL_VIEWS)
    torch.cuda.reset_peak_memory_stats()
    try:
        ct.solve(options, problem)
    except ValueError as exc:
        frame = traceback.extract_tb(exc.__traceback__)[-1]
        message = str(exc)
    else:
        raise AssertionError("CLUSTER_TRIDIAGONAL on canonical views was not refused")
    where = f"{os.path.basename(frame.filename)}:{frame.name}"
    print(f"phase 4: CLUSTER_TRIDIAGONAL (CANONICAL_VIEWS) refused in {where}: {message}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    if "CLUSTER_TRIDIAGONAL storage too large" not in message or where != "visibility.py:__init__":
        raise AssertionError("CLUSTER_TRIDIAGONAL was not refused by its host plan")


def phase_ordering_run(bal, main):
    """Phase 4, linear_solver_ordering: the main configuration with a
    ParameterBlockOrdering (points in group 0, cameras in group 1), the
    automatic partition's choice, 3 iterations; the initial cost, PCG counts
    and costs are bitwise those of the main run."""
    import ceres_tpu_torch as ct

    n_cams, n_pts = len(bal.cameras), len(bal.points)
    ordering = ct.ParameterBlockOrdering()
    for h in range(n_cams, n_cams + n_pts):
        ordering.add_element_to_group(h, 0)
    for h in range(n_cams):
        ordering.add_element_to_group(h, 1)

    def build(b):
        problem, cams, pts = ct.build_ba_problem(b, loss=ct.HuberLoss(1.0))
        if not (np.array_equal(cams, np.arange(n_cams))
                and np.array_equal(pts, n_cams + np.arange(n_pts))):
            raise AssertionError("the ordering's handles are not the problem's")
        return problem

    summary, _ = run_main_path(bal, "SCHUR_JACOBI", build=build, label="linear_solver_ordering",
                               fused_execution_chunk_iters=1, max_num_iterations=3,
                               linear_solver_ordering=ordering)
    for a, b in zip(main.iterations, summary.iterations):
        print(f"phase 4: iter {a.iteration}: automatic {_iteration_line(a)} | ordering "
              f"{_iteration_line(b)}", flush=True)
        if (a.cost, a.linear_solver_iterations) != (b.cost, b.linear_solver_iterations):
            raise AssertionError(f"iteration {a.iteration}: the ordering run is not the main run")
    if summary.initial_cost != main.initial_cost or len(summary.iterations) != 4:
        raise AssertionError("the ordering run does not start where the main run does")


def build_foe(h, w, size, k, seed=0, **kw):
    """The denoising problem of one FOE_RUNS entry: a synthetic
    piecewise-smooth image plus noise of FOE_SIGMA and a synthetic prior of
    the published shape, both from the seed; build_foe_denoising_problem
    (`analytic=True`: the cliques as AnalyticCostFunctions with their
    closed-form Jacobian)."""
    from ceres_tpu_torch.examples import denoising

    img = denoising.synthetic_noisy_image(h, w, sigma=FOE_SIGMA, seed=seed)
    foe = denoising.synthetic_foe_model(size, k, seed=seed)
    return denoising.build_foe_denoising_problem(img, foe, sigma=FOE_SIGMA, **kw)[0]


def build_foe_wrong_rule(h, w, size, k, seed=0):
    """build_foe's analytic problem with each clique's rule 3x its closed
    form: a deliberately wrong rule, for the probes that show whose
    Jacobian an evaluation computes (denoising.foe_clique_functions
    wrapped while build_foe runs)."""
    from ceres_tpu_torch.examples import denoising

    closed = denoising.foe_clique_functions

    def wrong(filt):
        fn, jac = closed(filt)
        return fn, lambda params, data: tuple(3.0 * j for j in jac(params, data))

    denoising.foe_clique_functions = wrong
    try:
        return build_foe(h, w, size, k, seed, analytic=True)
    finally:
        denoising.foe_clique_functions = closed


def generic_ops(prog, with_jacobian) -> int:
    """B1 generic's float operations per residual block, counted from the
    generated IR (an FMA as 2): on Jet<S, N> values a sum, difference,
    select or product by a scalar N + 1, a product of two Jets 3N + 1, a
    quotient 3N + 2, a function N + 10; on scalars 1, a function 10; then
    the loss and the correction of the r x N outputs (6 per entry)."""
    n = prog.num_tangent if with_jacobian else 0
    funcs = {"sqrt", "rsqrt", "exp", "expm1", "log", "log1p", "sin", "cos", "tan", "asin",
             "acos", "atan", "sinh", "cosh", "tanh", "atan2", "pow", "powc", "ipow", "recip",
             "abs", "max", "min"}
    fns = [prog.functor] + [pj[0] for pj in prog.plus_jacobians if pj is not None]
    if prog.rho is not None:
        fns.append(prog.rho[0])
    ops = 0
    for fn in fns:
        for var, op, args in fn.code:
            jet = fn.kinds[var] == "T" and n > 0
            both = jet and all(a[0] not in ("i",) and fn.kind(a) == "T" for a in args)
            if op == "val":
                continue
            if op == "rule":
                # an analytic rule's output: per parameter input a
                # multiply-add per tangent column
                if jet:
                    ops += 2 * n * len(args[2::2])
                continue
            if op in funcs:
                ops += (n + 10) if jet else 10
            elif op == "mul":
                ops += (3 * n + 1 if both else n + 1) if jet else 1
            elif op == "div":
                ops += (3 * n + 2 if both else n + 2) if jet else 1
            else:
                ops += (n + 1) if jet else 1
    return ops + 6 * prog.r * max(n, 1) + 20


def generic_bytes(prog, tables, n, with_jacobian) -> int:
    """What the function B1 generic computes must move for n blocks, each
    input read once and each output written once: each position's row
    index, each distinct state table once (the positions of a class share
    theirs), the data, the residuals, the leaves and the cost. The kernel's
    own traffic beyond that (a table row gathered again by every block
    that reads it, the cost partials) is not counted."""
    w = prog.dtype.itemsize
    table_words = sum(t.numel() for t in {id(t): t for t in tables}.values())
    per_block = 4 * len(prog.sizes) + w * (sum(prog.data_sizes) + prog.r)
    if with_jacobian:
        per_block += w * prog.r * prog.num_tangent
    return n * per_block + w * (table_words + 1)


def generic_ptxas(prog) -> str:
    """Registers and spills of a generated source's float32 instantiations
    (Jacobian, residual-only; each at 128 and 256 threads a block), from
    its nvcc log."""
    from ceres_tpu_torch import cuda_lib

    log = cuda_lib._generated_path(prog.source).with_suffix(".log")
    out, kind = {}, None
    for ln in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"Compiling entry function '_ZN3ctt19eval_generic_kernelI1GfLb(\d)ELi(\d+)E",
                      ln)
        if m:
            kind = ("jac" if m.group(1) == "1" else "res") + f"/{m.group(2)}"
            continue
        if kind and "spill" in ln:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            out[kind] = [None, spill.groups() if spill else ("?", "?")]
        elif kind and "registers" in ln:
            out.setdefault(kind, [None, ("?", "?")])[0] = re.search(r"Used (\d+) registers", ln).group(1)
            kind = None
    return ", ".join(f"{k} {v[0]} registers, spills {v[1][0]}/{v[1][1]} B" for k, v in out.items())


def build_subset_problem(n, seed=0, square=False):
    """A group on a SubsetManifold position: n blocks [a, b, c, d] with b
    held constant, four residuals on the three free coordinates (so the
    minimum is not zero), a scaled AnalyticCostFunction (a rule nested in
    a larger functor, cost_functions.scaled_cost_function) under a Cauchy
    loss, data from the seed. With `square` the first three residuals
    alone, whose minimum is zero: the solve ends at a cost of rounding
    level, where a relative gap of two solves says nothing."""
    import torch

    import ceres_tpu_torch as ct

    r = 3 if square else 4

    def fn(params, data):
        (x,) = params
        (d,) = data
        rows = [x[0] * x[1] - d[0], torch.sin(x[2]) + x[3] * x[0] - d[1], x[0] + x[2] - d[2]]
        return torch.stack(rows if square else rows + [x[3] - 0.5 * x[2] - d[3]])

    def jac(params, data):
        (x,) = params
        z, one = torch.zeros_like(x[0]), torch.ones_like(x[0])
        return (torch.stack([torch.stack([x[1], x[0], z, z]),
                             torch.stack([x[3], z, torch.cos(x[2]), x[0]]),
                             torch.stack([one, z, one, z]),
                             torch.stack([z, z, -0.5 * one, one])][:r]),)

    rng = np.random.default_rng(seed)
    p = ct.Problem()
    blocks = p.add_parameter_blocks(rng.uniform(0.5, 1.5, (n, 4)),
                                    manifold=ct.SubsetManifold(4, (1,)))
    p.add_residual_blocks(ct.scaled_cost_function(ct.AnalyticCostFunction(fn, jac, r), 0.5),
                          ct.CauchyLoss(1.0), blocks[:, None], (rng.normal(size=(n, r)),))
    return p


def phase_generic_build(bal_program, dev):
    """Phase 1, B1 generic: every generated source the script runs
    (Fields-of-Experts cliques of both sizes and the data term, the 3x3
    clique as an AnalyticCostFunction, a scaled analytic functor on a
    SubsetManifold position, Powell's, the curve fit's and Rosenbrock's
    functors, both pose graphs', the Snavely functor through the
    generator), built at once (one nvcc each, all started together)."""
    import torch

    from ceres_tpu_torch import cuda_lib, functor_codegen
    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.examples import test_functions
    from ceres_tpu_torch.linalg.schur_kernels import sy_source

    t0 = time.time()
    problems = [build_foe(16, 14, size, 2) for _h, _w, size, _k, _i in FOE_RUNS]
    # the custom-Jacobian branch: the analytic clique (its 3x probe shares
    # the source) and a scaled analytic functor on a SubsetManifold position
    problems += [build_foe(16, 14, 3, 2, analytic=True), build_subset_problem(40)]
    problems += [test_functions.build_powell_problem()[0],
                 test_functions.build_curve_fitting_problem()[0], build_rosenbrock()]
    # the pose graphs' functors (their sources depend on no size)
    from ceres_tpu_torch.examples import pose_graph
    from ceres_tpu_torch.utils.execution_summary import counts

    problems.append(pose_graph.build_pose_graph_2d_problem(
        pose_graph.synthetic_pose_graph_2d(n=8)[0])[0])
    with tempfile.TemporaryDirectory() as tmp:
        problems.append(small_sphere_problem(tmp, 2, 4)[0])
    progs = []
    for problem in problems:
        program = problem.compile("cpu")
        for dtype in (torch.float32, torch.float64):
            ev = Evaluator(program, dtype)
            progs += [functor_codegen.group_program(m, g, dtype, True)
                      for m, g in zip(program.groups, ev.arrays["groups"])]
    arrays = bal_program.arrays(torch.float32)
    progs.append(functor_codegen.group_program(bal_program.groups[0], arrays["groups"][0],
                                             torch.float32, True))
    if any(p is None for p in progs):
        raise AssertionError("a group of the slice's problems is not eligible for B1 generic")
    t_trace = time.time() - t0
    sources = {p.source for p in progs}
    sy_src = sy_source(*QUAT_SY_SHAPE)
    reset_counts()
    seconds = cuda_lib.build_generated(sources | {sy_src})
    table = counts()
    print(f"phase 1: B1 generic: {len(progs)} group programs traced in {t_trace:.1f} s, "
          f"{len(sources)} distinct sources and B4's at {QUAT_SY_SHAPE}: "
          f"{table['Kernel::GeneratedBuild']} built in {seconds:.1f} s (nvcc, in parallel), "
          f"{table['Kernel::GeneratedHit']} found built", flush=True)
    log = cuda_lib._generated_path(sy_src).with_suffix(".log")
    regs = ptxas_report(log.read_text()) if log.exists() else []
    print(f"phase 1: B4 at (r, tf, te) = {QUAT_SY_SHAPE} (registers, spills): "
          f"{' | '.join(regs) or 'found built'}", flush=True)
    return progs


def phase_kernels_generic(bal_program, dev, results):
    """Phase 2, B1 generic against its plain version on the card: the 3x3
    and 5x5 Fields-of-Experts clique groups and the data term at the
    denoising runs' sizes, and the Snavely group at BAL-1778 (also against
    the hand-written eval_snavely), each with the Jacobian and
    residual-only, two runs bitwise equal; the first is the kernels line's
    record. Its times are graph replays (graph_ms), as the solve's
    `evaluate` graph runs it: at these sizes the wrapper's host side (the
    checks, the allocations, the ctypes call) takes longer than the
    launches, and the eager time is printed beside them."""
    import torch

    from ceres_tpu_torch import eval_kernel, functor_codegen
    from ceres_tpu_torch.evaluator import Evaluator, group_eval_plain, state_tables

    f32 = torch.float32
    cases = []
    for h, w, size, k, _iters in FOE_RUNS:
        program = build_foe(h, w, size, k).compile(dev)
        cases.append((f"FoE {size}x{size} clique ({h}x{w})", program, 1))
        if size == 3:
            cases.append((f"FoE data term ({h}x{w})", program, 0))
    cases.append(("Snavely at BAL-1778", bal_program, 0))
    for label, program, gi in cases:
        ev = Evaluator(program, f32)
        meta, garr = program.groups[gi], ev.arrays["groups"][gi]
        st = state_tables(program, program.state_vector(f32))
        prog = functor_codegen.group_program(meta, garr, f32, True)
        tables = [st[pm.a_cls] for pm in meta.positions]
        args = (meta, garr, st)
        n = meta.n
        errs = {}
        for with_jac in (True, False):
            got = eval_kernel.generic_evaluate(prog, *args, with_jac)
            want = group_eval_plain(*args, with_jac, True)
            again = eval_kernel.generic_evaluate(prog, *args, with_jac)
            bitwise = all(torch.equal(a, b) for a, b in zip(
                [got[0], got[1], *got[2]], [again[0], again[1], *again[2]]))
            e = [rel_err(got[1], want[1]), rel_err(got[0].reshape(1), want[0].reshape(1))]
            e += [rel_err(a, b) for a, b in zip(got[2], want[2])]
            errs[with_jac] = ((max(x[0] for x in e), max(x[1] for x in e)), bitwise)
            del got, want, again
        err, bitwise = errs[True]
        rel_r = errs[False][0][1]
        t_e = median_ms(lambda: eval_kernel.generic_evaluate(prog, *args, True))
        t_k = graph_ms(lambda: eval_kernel.generic_evaluate(prog, *args, True))
        t_r = graph_ms(lambda: eval_kernel.generic_evaluate(prog, *args, False))
        t_p = median_ms(lambda: group_eval_plain(*args, True, True), reps=3)
        snavely = label.startswith("Snavely")
        # the Snavely function's operations as eval_snavely's bound counts
        # them (the generated Jet code does more than the function needs)
        ops, r_ops = ((B1_OPS_PER_OBS, B1_RES_OPS_PER_OBS) if snavely
                      else (generic_ops(prog, True), generic_ops(prog, False)))
        b_ms, b_by = bound(generic_bytes(prog, tables, n, True), ops * n)
        rb_ms, rb_by = bound(generic_bytes(prog, tables, n, False), r_ops * n)
        extra = ""
        if snavely:
            hand = eval_kernel.group_evaluate(meta, tables[0], garr["a_rows"][0], tables[1],
                                              garr["a_rows"][1], garr["data"][0], meta.loss, True)
            got = eval_kernel.generic_evaluate(prog, *args, True)
            hv = max(rel_err(a, b)[1] for a, b in zip([got[1], *got[2]], [hand[1], *hand[2]]))
            extra = f"; vs the hand-written eval_snavely {hv:.3e}"
            del hand, got
        ok = max(err[1], rel_r) <= 2e-4 and bitwise and errs[False][1]
        print(f"phase 2: eval_generic {label}: n {n}, N {prog.num_tangent}, max rel err "
              f"{err[1]:.3e} with the Jacobian, {rel_r:.3e} residual-only (tol 2e-04), bitwise "
              f"across two runs {bitwise and errs[False][1]}; kernel {t_k:.4f} ms from a graph "
              f"replay (residual-only {t_r:.4f}; eager, with the wrapper's host side, "
              f"{t_e:.4f}), plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{100 * b_ms / t_k:.1f}% of it; residual-only {rb_ms:.4f} ms, "
              f"{100 * rb_ms / t_r:.1f}%); ptxas f32 {generic_ptxas(prog)}{extra}"
              f"{'' if ok else '  FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"eval_generic {label}: kernel disagrees with its plain version "
                                 "or is not bitwise across runs")
        if "eval_generic" not in results:
            results["eval_generic"] = {"err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                                       "bound_by": b_by, "library_ms": None}
        del ev, st, tables, args
    del cases
    torch.cuda.empty_cache()


def phase_kernels_generic_analytic(dev, results):
    """Phase 2, B1 generic's custom-Jacobian branch: the Fields-of-Experts
    3x3, K = 8 clique group at 512 x 512 (FOE_RUNS[0]) as an
    AnalyticCostFunction with its closed-form Jacobian (the reference's
    FieldsOfExpertsCost) against its plain version (torch.func through the
    rule's jvp), with the Jacobian and residual-only, bitwise across two
    runs; graph-replay and eager ms, its bound (the autodiff clique's
    bytes, the rule's operations), ptxas' registers and spills; its outputs
    beside the autodiff clique instantiation's (the clique is linear, so
    they agree to rounding). Then the wrong-rule probe: the same group with
    3x the closed form gives 3x the autodiff leaf, and B1 generic's
    analytic counter moves."""
    import torch

    from ceres_tpu_torch import eval_kernel, functor_codegen
    from ceres_tpu_torch.evaluator import Evaluator, group_eval_plain, state_tables

    f32 = torch.float32
    h, w, size, k, _iters = FOE_RUNS[0]
    groups = {}
    for label, build in (("analytic", lambda: build_foe(h, w, size, k, analytic=True)),
                         ("autodiff", lambda: build_foe(h, w, size, k)),
                         ("3x rule", lambda: build_foe_wrong_rule(h, w, size, k))):
        program = build().compile(dev)
        ev = Evaluator(program, f32)
        meta, garr = program.groups[1], ev.arrays["groups"][1]
        st = state_tables(program, program.state_vector(f32))
        prog = functor_codegen.group_program(meta, garr, f32, True)
        if prog is None or prog.has_rule != (label != "autodiff"):
            raise AssertionError(f"eval_generic {label}: not generated with its rule")
        groups[label] = (prog, (meta, garr, st), [st[pm.a_cls] for pm in meta.positions])
    prog, args, tables = groups["analytic"]
    n = args[0].n
    errs = {}
    for with_jac in (True, False):
        got = eval_kernel.generic_evaluate(prog, *args, with_jac)
        want = group_eval_plain(*args, with_jac, True)
        again = eval_kernel.generic_evaluate(prog, *args, with_jac)
        bitwise = all(torch.equal(a, b) for a, b in zip(
            [got[0], got[1], *got[2]], [again[0], again[1], *again[2]]))
        e = [rel_err(got[1], want[1]), rel_err(got[0].reshape(1), want[0].reshape(1))]
        e += [rel_err(a, b) for a, b in zip(got[2], want[2])]
        errs[with_jac] = ((max(x[0] for x in e), max(x[1] for x in e)), bitwise)
        del got, want, again
    err, bitwise = errs[True]
    rel_r = errs[False][0][1]
    t_e = median_ms(lambda: eval_kernel.generic_evaluate(prog, *args, True))
    t_k = graph_ms(lambda: eval_kernel.generic_evaluate(prog, *args, True))
    t_r = graph_ms(lambda: eval_kernel.generic_evaluate(prog, *args, False))
    t_p = median_ms(lambda: group_eval_plain(*args, True, True), reps=3)
    auto_prog, auto_args, _ = groups["autodiff"]
    t_auto = graph_ms(lambda: eval_kernel.generic_evaluate(auto_prog, *auto_args, True))
    b_ms, b_by = bound(generic_bytes(prog, tables, n, True), generic_ops(prog, True) * n)
    got = eval_kernel.generic_evaluate(prog, *args, True)
    auto = eval_kernel.generic_evaluate(auto_prog, *auto_args, True)
    vs_auto = max(rel_err(a, b)[1] for a, b in zip([got[0].reshape(1), got[1], *got[2]],
                                                  [auto[0].reshape(1), auto[1], *auto[2]]))
    ok = max(err[1], rel_r) <= 2e-4 and bitwise and errs[False][1] and vs_auto <= 2e-4
    print(f"phase 2: eval_generic_analytic FoE {size}x{size} clique ({h}x{w}): n {n}, N "
          f"{prog.num_tangent}, max rel err {err[1]:.3e} with the Jacobian, {rel_r:.3e} "
          f"residual-only (tol 2e-04), bitwise across two runs {bitwise and errs[False][1]}; "
          f"kernel {t_k:.4f} ms from a graph replay (residual-only {t_r:.4f}; eager, with the "
          f"wrapper's host side, {t_e:.4f}; the autodiff clique's {t_auto:.4f}), plain "
          f"{t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {100 * b_ms / t_k:.1f}% of it); ptxas f32 "
          f"{generic_ptxas(prog)}; vs the autodiff clique instantiation {vs_auto:.3e}"
          f"{'' if ok else '  FAILED'}", flush=True)
    if not ok:
        raise AssertionError("eval_generic_analytic: kernel disagrees with its plain version, "
                             "with the autodiff clique, or is not bitwise across runs")
    results["eval_generic_analytic"] = {"err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                                        "bound_by": b_by, "library_ms": None}
    # the wrong-rule probe
    x3_prog, x3_args, _ = groups["3x rule"]
    reset_counts()
    probe = eval_kernel.generic_evaluate(x3_prog, *x3_args, True)
    moved = kernel_launches()["eval_generic_analytic"]
    plain = group_eval_plain(*x3_args, True, True)
    e3 = max(rel_err(a, 3.0 * b)[1] for a, b in zip(probe[2], auto[2]))
    e_res = rel_err(probe[1], auto[1])[1]
    e_plain = max(rel_err(a, b)[1] for a, b in zip(probe[2], plain[2]))
    ok = e3 <= 2e-4 and e_res <= 2e-4 and e_plain <= 2e-4 and moved == 1
    print(f"phase 2: eval_generic_analytic wrong-rule probe (3x the closed form): leaf vs 3x the "
          f"autodiff leaf max rel err {e3:.3e}, residuals vs the autodiff's {e_res:.3e}, vs its "
          f"plain version (the 3x rule through torch.func) {e_plain:.3e} (tol 2e-04), "
          f"eval_generic_analytic launches {moved}{'' if ok else '  FAILED'}", flush=True)
    if not ok:
        raise AssertionError("eval_generic_analytic: the kernel did not compute the user's rule")
    del groups, prog, args, tables, got, auto, probe, plain
    torch.cuda.empty_cache()


def numeric_ba_problem(bal, method="CENTRAL"):
    """build_ba_problem's Snavely group with the functor as a
    NumericDiffCostFunction (not tagged for eval_snavely, not generated:
    the torch.func path with the finite-difference rule), Huber(1.0)."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.examples.snavely import snavely_reprojection_error

    problem = ct.Problem()
    cams = problem.add_parameter_blocks(bal.cameras)
    pts = problem.add_parameter_blocks(bal.points)
    problem.add_residual_blocks(
        ct.NumericDiffCostFunction(snavely_reprojection_error, 2, method=method),
        ct.HuberLoss(1.0), np.stack([cams[bal.camera_index], pts[bal.point_index]], axis=1),
        (bal.observations,))
    return problem


def fd_rounding_excess(leaves_a, leaves_b, params, scale, rel=1e-6, min_step=1e-12):
    """|A - B| / (eps |f| / h) of two central-difference Jacobians (leaves
    [r * t, n] per position; the functor's values of magnitude `scale` [n])
    in units of the rounding bound of a central difference at step
    h = max(rel |p|, min_step) (params [n, t] per position). Returns the
    largest excess over the entries whose step is the floor (rel |p| <=
    min_step: synthetic_bal's camera translations of 0 or ~1e-16), where a
    unit is largest (~0.02-0.1 absolute) and last-bit differences of fn
    give a unit or two, and over the rest, where they give tens (Snavely's
    rotation carries values larger than |f|; tests/test_torch_diff_rules.py
    measures central differences against the exact Jacobian in these
    units). A different rule (a forward difference, another step) gives
    far more."""
    import torch

    eps = torch.finfo(torch.float64).eps
    worst = [0.0, 0.0]
    for a, b, p in zip(leaves_a, leaves_b, params):
        p = p.double().cpu()
        t, n = p.shape[1], a.shape[1]
        h = torch.clamp_min(rel * p.abs(), min_step).T  # [t, n]
        d = (a.double().cpu() - b.double().cpu()).reshape(-1, t, n)
        x = (d * h[None] / (eps * scale.double().cpu()[None, None, :])).abs()
        at_floor = (rel * p.abs() <= min_step).T[None].expand_as(x)
        for k, part in enumerate((x[at_floor], x[~at_floor])):
            if part.numel():
                worst[k] = max(worst[k], float(part.max()))
    return tuple(worst)


def phase_f64_rules():
    """Phase 3, the custom-Jacobian branch and the rest of the slice in
    float64 on the card against the CPU, per-iteration cost within 1e-9 with
    equal PCG counts and decisions, and what each should launch launched: a
    small Fields-of-Experts CGNR solve with analytic cliques on the fused
    loop (B1 generic, its analytic counter); the sampled-function solve
    (an interpolated functor: not generated, no B1); a solve with an
    EvaluationCallback (the curve fit, host loop; the card's and the CPU's
    (new_point, evaluate_jacobians) sequences equal); a group on a
    SubsetManifold position (a scaled analytic functor, B1 generic). Then
    the small BAL with Snavely as a NumericDiffCostFunction (CENTRAL) on
    SCHUR_JACOBI: B1 not launched, B2-B5 launched; its Jacobian at the
    start held to the CPU's at the rounding bound of a central difference
    and its per-iteration cost gap at 5e-7 (the synthetic cameras'
    translations of 0 take the 1e-12 floor of the step, whose columns move
    by ~1e-3 with the last bits of fn)."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.evaluator import Evaluator, state_tables
    from ceres_tpu_torch.examples import denoising, test_functions

    nothing = set(GENERIC_NAMES) | {"eval_snavely"}
    calls = {}

    def with_callback(dev):
        calls[dev] = []
        p = test_functions.build_curve_fitting_problem()[0]
        p.evaluation_callback = lambda new_point, jac: calls[dev].append((new_point, jac))
        return p

    samples = (np.arange(10.0) - 4.5) ** 2  # examples/sampled_function/sampled_function.cc
    cases = [
        ("FoE 3x3 analytic CGNR fused", lambda dev: build_foe(96, 80, 3, 3, analytic=True),
         dict(linear_solver_type=ct.LinearSolverType.CGNR, max_linear_solver_iterations=10,
              fused_execution_chunk_iters=1, preconditioner_type="JACOBI"),
         ({"eval_generic_analytic", "eval_generic"}, {"eval_snavely"})),
        ("sampled function DENSE_QR",
         lambda dev: denoising.build_sampled_function_problem(samples, 1.0)[0],
         dict(linear_solver_type=ct.LinearSolverType.DENSE_QR, max_num_iterations=10),
         (set(), nothing)),
        ("EvaluationCallback curve fitting DENSE_NORMAL_CHOLESKY", with_callback,
         dict(linear_solver_type=ct.LinearSolverType.DENSE_NORMAL_CHOLESKY, max_num_iterations=12),
         ({"eval_generic"}, {"eval_snavely"})),
        ("SubsetManifold scaled analytic DENSE_QR", lambda dev: build_subset_problem(300),
         dict(linear_solver_type=ct.LinearSolverType.DENSE_QR, max_num_iterations=8),
         ({"eval_generic_analytic"}, {"eval_snavely", "eval_generic"})),
    ]
    for name, build, extra, (launched, not_launched) in cases:
        extra = dict(extra)
        precond = extra.pop("preconditioner_type", "SCHUR_JACOBI")
        sums = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            sums[dev] = ct.solve(lm_options(dev, torch.float64, precond, **extra), build(dev))
            if dev == "cuda":
                launches = kernel_launches()
        worst = _same_iterations(name, sums)
        s = sums["cuda"]
        extra_line = ""
        if calls:
            if calls["cuda"] != calls["cpu"] or not calls["cuda"] or s.used_fused_execution:
                raise AssertionError(f"{name}: callback sequences differ or the solve was fused")
            extra_line = (f", callback calls {len(calls['cuda'])} ({sum(j for _, j in calls['cuda'])}"
                          f" with the Jacobian), equal on both")
            calls.clear()
        print(f"phase 3: {name}: float64, CUDA vs CPU: {len(s.iterations)} iterations "
              f"({'fused' if s.used_fused_execution else 'host loop'}), max per-iteration cost "
              f"rel diff {worst:.3e} (tol 1e-09), final cost {s.final_cost:.12e}, launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}{extra_line}", flush=True)
        if any(launches[k] <= 0 for k in launched) or any(launches[k] for k in not_launched):
            raise AssertionError(f"{name}: the CUDA solve did not launch {sorted(launched)} "
                                 f"alone of {sorted(launched | not_launched)}")
        if not s.final_cost < s.initial_cost:
            raise AssertionError(f"{name}: the solve did not decrease the cost")

    # the numeric-diff BA
    bal = ct.synthetic_bal(96, 4000, 48_000, seed=1)
    sums, jacs = {}, {}
    for dev in ("cuda", "cpu"):
        program = numeric_ba_problem(bal).compile(dev)
        ev = Evaluator(program, torch.float64)
        reset_counts()
        jacs[dev] = ev.evaluate_groups(program.state_vector(torch.float64))
        sums[dev] = ct.solve(lm_options(dev, torch.float64), numeric_ba_problem(bal))
        if dev == "cuda":
            launches = kernel_launches()
    (c_gpu, r_gpu, j_gpu, _), (c_cpu, r_cpu, j_cpu, _) = jacs["cuda"], jacs["cpu"]
    # the parameters and observations in the group's lane order (the CPU
    # Program's, which the card's shares)
    garr = ev.arrays["groups"][0]
    st = state_tables(program, program.state_vector(torch.float64))
    params = [st[pm.a_cls][rows] for pm, rows in zip(program.groups[0].positions, garr["a_rows"])]
    scale = garr["data"][0].abs().max(dim=1).values + r_cpu[0].abs().max(dim=0).values
    at_floor, above = fd_rounding_excess(j_gpu.jac_groups[0], j_cpu.jac_groups[0], params, scale)
    jac_gap = max(rel_err(a.cpu(), b)[1] for a, b in zip(j_gpu.jac_groups[0], j_cpu.jac_groups[0]))
    cost0 = abs(float(c_gpu) - float(c_cpu)) / abs(float(c_cpu))
    gaps = [abs(a.cost - b.cost) / abs(b.cost)
            for a, b in zip(sums["cuda"].iterations, sums["cpu"].iterations)]
    s = sums["cuda"]
    # the per-iteration gap comes from the columns at the step's floor,
    # where a last-bit difference of fn moves a central difference by
    # ~1e-3 of the largest entry: ceres_tpu's own jitted and eager solves
    # of such data part by ~3e-4 (tests/test_torch_diff_rules.py); the
    # gap is held at 5e-7, 3x its reading on the H100 (1.671e-07, the
    # same in every run)
    print(f"phase 3: numeric-diff Snavely (CENTRAL) SCHUR_JACOBI: float64, CUDA vs CPU: initial "
          f"cost rel diff {cost0:.3e} (tol 1e-12); Jacobian at the start max rel diff "
          f"{jac_gap:.3e}, in units of the central difference's rounding bound {at_floor:.2f} on "
          f"the columns at the step's 1e-12 floor (tol 8), {above:.2f} on those above it (tol "
          f"64); per-iteration cost rel diff {[f'{g:.3e}' for g in gaps]} (tol 5e-07), pcg "
          f"CUDA {[it.linear_solver_iterations for it in s.iterations]} CPU "
          f"{[it.linear_solver_iterations for it in sums['cpu'].iterations]}, final cost "
          f"{s.final_cost:.12e}, launches {json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    if not (cost0 <= 1e-12 and at_floor <= 8.0 and above <= 64.0 and max(gaps) <= 5e-7):
        raise AssertionError("numeric-diff BA: the card's finite differences or solve are not "
                             "the CPU's")
    if len(s.iterations) != len(sums["cpu"].iterations) or not (
            all(math.isfinite(it.cost) for it in s.iterations) and s.final_cost < s.initial_cost):
        raise AssertionError("numeric-diff BA: the card's solve failed")
    if any(launches[k] for k in nothing) or any(
            launches[k] <= 0 for k in ("gather_contract", "contract_reduce", "schur_sy",
                                       "schur_p0")):
        raise AssertionError("numeric-diff BA: B1 launched, or B2-B5 not launched")


def phase_f64_generic():
    """Phase 3, the slice's solvers in float64 on the card against the CPU:
    a small Fields-of-Experts CGNR + JACOBI solve on the fused loop (PCG <=
    10 steps: on this ill-conditioned prior a 25-step PCG amplifies the
    card's and the CPU's different summation orders), Powell's function on
    DENSE_QR and the curve fit on DENSE_NORMAL_CHOLESKY, each with B1
    generic launched."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.examples import test_functions

    cases = (
        ("FoE 3x3 CGNR fused", lambda: build_foe(96, 80, 3, 3),
         dict(linear_solver_type=ct.LinearSolverType.CGNR, max_linear_solver_iterations=10,
              fused_execution_chunk_iters=1)),
        ("Powell DENSE_QR", lambda: test_functions.build_powell_problem()[0],
         dict(linear_solver_type=ct.LinearSolverType.DENSE_QR, max_num_iterations=8)),
        ("curve fitting DENSE_NORMAL_CHOLESKY",
         lambda: test_functions.build_curve_fitting_problem()[0],
         dict(linear_solver_type=ct.LinearSolverType.DENSE_NORMAL_CHOLESKY, max_num_iterations=12)),
    )
    for name, build, extra in cases:
        sums = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            sums[dev] = ct.solve(lm_options(dev, torch.float64, "JACOBI", **extra), build())
            if dev == "cuda":
                launches = kernel_launches()
        worst = 0.0
        for a, b in zip(sums["cuda"].iterations, sums["cpu"].iterations, strict=True):
            worst = max(worst, abs(a.cost - b.cost) / max(abs(b.cost), 1e-300))
            if (a.linear_solver_iterations, a.step_is_successful) != (
                b.linear_solver_iterations, b.step_is_successful
            ):
                raise AssertionError(f"{name}, iteration {a.iteration}: CUDA and CPU solves diverge")
        print(f"phase 3: {name}: float64, CUDA vs CPU: {len(sums['cpu'].iterations)} iterations, "
              f"max per-iteration cost rel diff {worst:.3e} (tol 1e-09), pcg "
              f"{[it.linear_solver_iterations for it in sums['cuda'].iterations]}, final cost "
              f"{sums['cuda'].final_cost:.12e}, eval_generic launches "
              f"{launches['eval_generic']} (+{launches['eval_generic_residual']} residual-only)",
              flush=True)
        if not worst <= 1e-9:
            raise AssertionError(f"{name}: float64 CUDA solve disagrees with the CPU solve")
        if launches["eval_generic"] <= 0 or launches["eval_snavely"]:
            raise AssertionError(f"{name}: the CUDA solve did not run B1 generic alone")


def run_denoising(h, w, size, k, iters, analytic=False):
    """Phase 4, one denoising run of FOE_RUNS: LM + CGNR + JACOBI in float32
    on the fused loop at chunk 1 (eta 0.1, PCG <= 25), on a new Problem;
    every group through B1 generic at every evaluation (the launch counts,
    set to 0 just before the solve and read just after, against the
    groups times the evaluations). With `analytic` the cliques are
    AnalyticCostFunctions: the K clique groups count under
    eval_generic_analytic, the data term under eval_generic."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.utils.execution_summary import counts

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    problem = build_foe(h, w, size, k, analytic=analytic)
    t_problem = time.time() - t0
    options = lm_options("cuda", torch.float32, "JACOBI", fused_execution_chunk_iters=1,
                         max_num_iterations=iters,
                         linear_solver_type=ct.LinearSolverType.CGNR)
    reset_counts()
    t0 = time.time()
    summary = ct.solve(options, problem)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernel_launches()
    table = counts()
    builds = {"builds": table["Kernel::GeneratedBuild"], "hits": table["Kernel::GeneratedHit"]}
    groups = k + 1
    label = f"FoE {size}x{size} K={k} {h}x{w}" + (" analytic" if analytic else "")
    print(f"phase 4: {label} (CGNR + JACOBI, fused): {summary.num_residuals} residuals, "
          f"{summary.num_effective_parameters} parameters, {groups} groups; Problem built in "
          f"{t_problem:.1f} s; solve {wall:.1f} s (preprocess "
          f"{summary.preprocessor_time_in_seconds:.1f} s), initial cost {summary.initial_cost!r}, "
          f"final cost {summary.final_cost!r}, {summary.termination_type.value}, launches "
          f"{json.dumps({k_: v for k_, v in launches.items() if v})}; device reads "
          f"{summary.num_device_reads}, graph replays {summary.num_graph_replays}; generated "
          f"sources built {builds['builds']}, found built {builds['hits']}", flush=True)
    for it in summary.iterations:
        print(f"phase 4: {label}: iter {it.iteration}: cost {it.cost!r} pcg "
              f"{it.linear_solver_iterations} reads {it.num_device_reads} ms "
              f"{1000.0 * it.iteration_time_in_seconds:.1f} "
              f"{'accepted' if it.step_is_successful else 'rejected'}", flush=True)
    if not summary.used_fused_execution:
        raise AssertionError(f"{label}: the run did not take the fused loop")
    if not (all(math.isfinite(it.cost) for it in summary.iterations)
            and summary.final_cost < summary.initial_cost):
        raise AssertionError(f"{label}: non-finite or non-decreasing cost")
    jac_launches = launches["eval_generic"] + launches["eval_generic_analytic"]
    if (jac_launches != groups * summary.num_jacobian_evaluations
            or launches["eval_generic_analytic"] != (
                k * summary.num_jacobian_evaluations if analytic else 0)
            or launches["eval_generic_residual"] != groups * summary.num_residual_evaluations):
        raise AssertionError(f"{label}: a group did not take B1 generic at every evaluation")
    if any(it.num_device_reads > 2 + it.linear_solver_iterations for it in summary.iterations[1:]):
        raise AssertionError(f"{label}: more than 2 + PCG steps reads in an iteration")
    return summary, launches


def phase_analytic_denoising_run(auto):
    """Phase 4, FOE_RUNS[0] with the cliques as AnalyticCostFunctions
    (closed form), on a new Problem, beside the autodiff run `auto`
    (summary, launches): cost per iteration within 1e-5 relative, equal PCG
    steps; run_denoising's launch and read checks. Returns its launches."""
    summary, launches = run_denoising(*FOE_RUNS[0], analytic=True)
    a_sum = auto[0]
    worst = 0.0
    for a, b in zip(a_sum.iterations, summary.iterations, strict=True):
        worst = max(worst, abs(a.cost - b.cost) / abs(a.cost))
        print(f"phase 4: FoE analytic vs autodiff: iter {a.iteration}: autodiff cost {a.cost!r} "
              f"pcg {a.linear_solver_iterations} ms {1000.0 * a.iteration_time_in_seconds:.1f} | "
              f"analytic cost {b.cost!r} pcg {b.linear_solver_iterations} ms "
              f"{1000.0 * b.iteration_time_in_seconds:.1f}", flush=True)
        if a.linear_solver_iterations != b.linear_solver_iterations:
            raise AssertionError(f"FoE analytic, iteration {a.iteration}: PCG steps differ")
    print(f"phase 4: FoE analytic vs autodiff max per-iteration cost rel diff {worst:.3e} "
          f"(tol 1e-05)", flush=True)
    if not worst <= 1e-5:
        raise AssertionError("FoE analytic: the run departs from the autodiff run")
    return launches


def phase_numeric_ba_run(bal):
    """Phase 4, BAL-1778 with Snavely as a NumericDiffCostFunction (CENTRAL),
    Huber(1.0), in float64 (central differences at the default relative
    step of 1e-6 mean nothing in float32): LM + ITERATIVE_SCHUR +
    SCHUR_JACOBI, eta 0.1, PCG <= 25, fused at chunk 1, 3 iterations, on a
    new Problem. Its initial cost within 1e-10 of the same data's cost
    through B1's float64 Snavely kernel; every value finite; the cost
    falling; B1 not launched and B2-B5 launched; reads within 2 + PCG
    steps. Prints the evaluation's ms per call (CUDA events around the
    `evaluate` graph's replay; its first call runs the warm-up and the
    capture) and the peak device memory."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.solvers import trust_region

    gc.collect()
    torch.cuda.empty_cache()
    f64 = torch.float64
    ref = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0].compile("cuda")
    ev = Evaluator(ref, f64)
    reset_counts()
    ref_cost = float(ev.cost(ref.state_vector(f64)))
    if kernel_launches()["eval_snavely"] != 1:
        raise AssertionError("numeric BA: the reference cost did not run B1's Snavely kernel")
    del ref, ev
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    problem = numeric_ba_problem(bal)
    t_problem = time.time() - t0
    events, make = [], trust_region.make_evaluate

    def timed_make_evaluate(program, evaluator):
        evaluate = make(program, evaluator)

        def timed(state):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = evaluate(state)
            b.record()
            events.append((a, b))
            return out

        return timed

    options = lm_options("cuda", f64, "SCHUR_JACOBI", fused_execution_chunk_iters=1,
                         max_num_iterations=3)
    trust_region.make_evaluate = timed_make_evaluate
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        summary = ct.solve(options, problem)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = kernel_launches()
    finally:
        trust_region.make_evaluate = make
    peak = torch.cuda.max_memory_allocated() / 2**30
    eval_ms = [a.elapsed_time(b) for a, b in events]
    rel = abs(summary.initial_cost - ref_cost) / abs(ref_cost)
    print(f"phase 4: BAL-1778 numeric-diff Snavely (CENTRAL, float64, SCHUR_JACOBI, fused): "
          f"Problem built in {t_problem:.1f} s; solve {wall:.1f} s (preprocess "
          f"{summary.preprocessor_time_in_seconds:.1f} s), initial cost {summary.initial_cost!r} "
          f"vs {ref_cost!r} through eval_snavely (rel diff {rel:.3e}, tol 1e-10), final cost "
          f"{summary.final_cost!r}, {summary.termination_type.value}, launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; device reads "
          f"{summary.num_device_reads}, graph replays {summary.num_graph_replays}; evaluate ms "
          f"per call (CUDA events; the first with warm-up and capture) "
          f"{[round(t, 3) for t in eval_ms]}; peak device memory {peak:.2f} GiB", flush=True)
    for it in summary.iterations:
        print(f"phase 4: BAL-1778 numeric-diff: iter {it.iteration}: {_iteration_line(it)}",
              flush=True)
    if not rel <= 1e-10:
        raise AssertionError("numeric BA: the initial cost is not eval_snavely's")
    if not (all(math.isfinite(it.cost) for it in summary.iterations)
            and bool(np.isfinite(problem.compile().state0).all())
            and summary.final_cost < summary.initial_cost):
        raise AssertionError("numeric BA: non-finite or non-decreasing cost")
    if any(launches[k] for k in GENERIC_NAMES | {"eval_snavely"}) or any(
            launches[k] <= 0 for k in ("gather_contract", "contract_reduce", "schur_sy",
                                       "schur_p0")):
        raise AssertionError("numeric BA: B1 launched, or B2-B5 not launched")
    if any(it.num_device_reads > 2 + it.linear_solver_iterations for it in summary.iterations[1:]):
        raise AssertionError("numeric BA: more than 2 + PCG steps reads in an iteration")
    if not summary.used_fused_execution or not events:
        raise AssertionError("numeric BA: the run did not take the fused loop")


def _quat_xyzw(axis_angle):
    """[n, 3] angle-axis vectors -> [n, 4] unit quaternions [x, y, z, w]."""
    theta = np.linalg.norm(axis_angle, axis=1, keepdims=True)
    axis = axis_angle / np.maximum(theta, 1e-300)
    return np.concatenate([axis * np.sin(theta / 2), np.cos(theta / 2)], axis=1)


def _qmul(a, b):
    x1, y1, z1, w1 = a.T
    x2, y2, z2, w2 = b.T
    return np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], 1)


def _rotate(q, p):
    t = 2.0 * np.cross(q[:, :3], p)
    return p + q[:, 3:] * t + np.cross(q[:, :3], t)


def write_sphere_g2o(path, rings, per_ring, seed=0, noise=(0.05, 0.01)):
    """A pose graph of sphere2500's layout as a .g2o file (VERTEX_SE3:QUAT,
    EDGE_SE3:QUAT): `rings` rings of `per_ring` poses on a sphere of radius
    50, one odometry edge between consecutive poses and a loop closure from
    each pose to the one below it on the previous ring; the measurements
    from the true poses plus noise (translation, rotation sigma) with the
    matching information, the vertices the true poses plus noise (the first
    pose true), all from the seed. Returns the true (positions,
    quaternions)."""
    rng = np.random.default_rng(seed)
    k, j = np.divmod(np.arange(rings * per_ring), per_ring)
    lat = np.pi * (k + 1) / (rings + 1) - np.pi / 2
    lon = 2 * np.pi * j / per_ring
    pos = 50.0 * np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], 1)
    q = _quat_xyzw(np.stack([np.zeros_like(lon), -lat, lon + np.pi / 2], 1))
    n = len(pos)
    edges = [(i, i + 1) for i in range(n - 1)] + [(i, i - per_ring) for i in range(per_ring, n)]
    a, b = np.asarray(edges).T
    qa_inv = q[a] * [-1, -1, -1, 1]
    t_ab = _rotate(qa_inv, pos[b] - pos[a]) + rng.normal(0, noise[0], (len(a), 3))
    q_ab = _qmul(_qmul(qa_inv, q[b]), _quat_xyzw(rng.normal(0, noise[1], (len(a), 3))))
    info = np.diag([1 / noise[0] ** 2] * 3 + [1 / noise[1] ** 2] * 3)
    pos0 = pos + rng.normal(0, 0.5, pos.shape)
    q0 = _qmul(q, _quat_xyzw(rng.normal(0, 0.05, (n, 3))))
    pos0[0], q0[0] = pos[0], q[0]
    iu = np.triu_indices(6)
    with open(path, "w") as f:
        for i in range(n):
            f.write("VERTEX_SE3:QUAT %d " % i + " ".join(f"{v:.17g}" for v in (*pos0[i], *q0[i]))
                    + "\n")
        for e in range(len(a)):
            vals = (*t_ab[e], *q_ab[e], *info[iu])
            f.write(f"EDGE_SE3:QUAT {a[e]} {b[e]} " + " ".join(f"{v:.17g}" for v in vals) + "\n")
    return pos, q


def build_rosenbrock():
    """Rosenbrock's function from (-1.2, 1), one residual block of 2."""
    import torch

    import ceres_tpu_torch as ct

    def res(params, data):
        (xy,) = params
        return torch.cat([10.0 * (xy[1:2] - xy[0:1] ** 2), 1.0 - xy[0:1]])

    p = ct.Problem()
    b = p.add_parameter_block(np.array([-1.2, 1.0]))
    p.add_residual_block(ct.CostFunction(res, 2, name="rosenbrock"), None, [b])
    return p


def small_sphere_problem(tmp, rings=6, per_ring=10):
    """A small 3D pose graph written to and read back from a .g2o file:
    (problem, number of odometry edges)."""
    from ceres_tpu_torch.examples import pose_graph

    path = os.path.join(tmp, f"sphere_{rings}x{per_ring}.g2o")
    write_sphere_g2o(path, rings, per_ring, seed=1)
    return pose_graph.build_pose_graph_3d_problem(pose_graph.load_g2o_3d(path))[0], rings * per_ring - 1


@contextlib.contextmanager
def captured_dogleg_step_fns():
    """A with-block in which every dogleg step function a solve makes is
    also appended to the list it yields (to read its step-kind log after
    the solve)."""
    from ceres_tpu_torch.solvers import dogleg

    made, make = [], dogleg.make_dogleg_step_fn

    def spy(*args):
        made.append(make(*args))
        return made[-1]

    dogleg.make_dogleg_step_fn = spy
    try:
        yield made
    finally:
        dogleg.make_dogleg_step_fn = make


def _same_iterations(name, sums, tol=1e-9):
    """The largest per-iteration cost difference of the CUDA and CPU
    solves, relative; raises when their decisions or counts part."""
    worst = 0.0
    for a, b in zip(sums["cuda"].iterations, sums["cpu"].iterations, strict=True):
        worst = max(worst, abs(a.cost - b.cost) / max(abs(b.cost), 1e-300))
        if (a.linear_solver_iterations, a.step_is_successful, a.line_search_iterations) != (
            b.linear_solver_iterations, b.step_is_successful, b.line_search_iterations
        ):
            raise AssertionError(f"{name}, iteration {a.iteration}: CUDA and CPU solves diverge")
    counts = [(s.num_jacobian_evaluations, s.num_residual_evaluations, s.num_inner_iteration_steps)
              for s in (sums["cuda"], sums["cpu"])]
    if counts[0] != counts[1]:
        raise AssertionError(f"{name}: evaluation counts differ, CUDA {counts[0]}, CPU {counts[1]}")
    if not worst <= tol:
        raise AssertionError(f"{name}: float64 CUDA solve disagrees with the CPU solve ({worst:.3e})")
    return worst


def phase_f64_host_solvers(tmp):
    """Phase 3, the slice's solvers in float64 on the card against the CPU,
    per-iteration cost within 1e-9 with equal PCG counts and decisions, and
    what each should launch launched: DOGLEG TRADITIONAL and SUBSPACE on a
    small BAL (ITERATIVE_SCHUR options, radius 1 so the steps leave the
    Gauss-Newton point; the GN is CGNR + JACOBI: B1-B3, not B4 or B5) on
    the fused and on the host loop; DOGLEG SUBSPACE on DENSE_QR
    (Rosenbrock, B1 generic); SPARSE_SCHUR and SPARSE_NORMAL_CHOLESKY on the
    small BAL (host loop, B1-B3); a small 3D pose graph read from a .g2o
    file on SPARSE_NORMAL_CHOLESKY and on CGNR + SUBSET (its odometry
    edges), B1 generic."""
    import torch

    import ceres_tpu_torch as ct

    bal = ct.synthetic_bal(96, 4000, 48_000, seed=1)

    def ba():
        return ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]

    _, n_odo = small_sphere_problem(tmp)
    dogleg = dict(trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
                  initial_trust_region_radius=1.0)
    ba_kernels = ({"eval_snavely", "gather_contract", "contract_reduce"}, {"schur_sy", "schur_p0"})
    generic = ({"eval_generic"}, {"eval_snavely"})
    cases = [
        (f"DOGLEG {kind} {loop}", ba,
         dict(dogleg, dogleg_type=getattr(ct.DoglegType, kind), fused_execution=loop == "fused",
              fused_execution_chunk_iters=1), ba_kernels)
        for kind in ("TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG") for loop in ("fused", "host loop")
    ]
    cases += [
        ("DOGLEG SUBSPACE_DOGLEG Rosenbrock DENSE_QR", build_rosenbrock,
         dict(dogleg_type=ct.DoglegType.SUBSPACE_DOGLEG, max_num_iterations=12,
              trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
              linear_solver_type=ct.LinearSolverType.DENSE_QR), generic),
        ("SPARSE_SCHUR", ba, dict(linear_solver_type=ct.LinearSolverType.SPARSE_SCHUR),
         ba_kernels),
        ("SPARSE_NORMAL_CHOLESKY", ba,
         dict(linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY), ba_kernels),
        ("3D pose graph SPARSE_NORMAL_CHOLESKY", lambda: small_sphere_problem(tmp)[0],
         dict(linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY), generic),
        ("3D pose graph CGNR + SUBSET", lambda: small_sphere_problem(tmp)[0],
         dict(linear_solver_type=ct.LinearSolverType.CGNR, initial_trust_region_radius=1.0,
              preconditioner_type="SUBSET",
              residual_blocks_for_subset_preconditioner=list(range(n_odo))), generic),
    ]
    for name, build, extra, (launched, not_launched) in cases:
        sums = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            sums[dev] = ct.solve(lm_options(dev, torch.float64, **extra), build())
            if dev == "cuda":
                launches = kernel_launches()
        worst = _same_iterations(name, sums)
        print(f"phase 3: {name}: float64, CUDA vs CPU: {len(sums['cpu'].iterations)} iterations "
              f"({'fused' if sums['cuda'].used_fused_execution else 'host loop'}), max "
              f"per-iteration cost rel diff {worst:.3e} (tol 1e-09), pcg "
              f"{[it.linear_solver_iterations for it in sums['cuda'].iterations]}, final cost "
              f"{sums['cuda'].final_cost:.12e}, launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
        if any(launches[k] <= 0 for k in launched) or any(launches[k] for k in not_launched):
            raise AssertionError(f"{name}: the CUDA solve did not launch {sorted(launched)} "
                                 f"alone of {sorted(launched | not_launched)}")
        if sums["cuda"].final_cost >= sums["cuda"].initial_cost:
            raise AssertionError(f"{name}: the solve did not decrease the cost")


def phase_dogleg_runs(bal, main):
    """Phase 4, DOGLEG at BAL-1778: the main run's options with
    trust_region_strategy_type=DOGLEG, TRADITIONAL and SUBSPACE, 3
    iterations each on a new Problem on the fused loop at chunk 1; per
    iteration the step kind the finish took, PCG steps, reads and ms beside
    the main run's. Its Gauss-Newton point is CGNR + JACOBI (the JAX
    package's dogleg): B1, B2 and B3 launched, B4 and B5 not; at most 2 +
    PCG steps reads per iteration."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.solvers import dogleg

    for kind in ("TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"):
        with captured_dogleg_step_fns() as made:
            summary, counts = run_main_path(
                bal, "SCHUR_JACOBI", label=f"DOGLEG {kind}", fused_execution_chunk_iters=1,
                max_num_iterations=3, trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
                dogleg_type=getattr(ct.DoglegType, kind))
        n = len(summary.iterations) - 1
        kinds = [dogleg.STEP_KINDS[k] for k in made[0].step_kinds.tolist()[:n]]
        for a, b, step in zip(main.iterations[1:], summary.iterations[1:], kinds):
            print(f"phase 4: iter {a.iteration}: SCHUR_JACOBI {_iteration_line(a)} | DOGLEG "
                  f"{kind} step {step} {_iteration_line(b)}", flush=True)
        if not summary.used_fused_execution:
            raise AssertionError(f"the DOGLEG {kind} run did not take the fused loop")
        if any(counts[k] <= 0 for k in ("eval_snavely", "gather_contract", "contract_reduce")) or (
                counts["schur_sy"] or counts["schur_p0"]):
            raise AssertionError(f"the DOGLEG {kind} run: B1-B3 not launched, or B4 or B5 launched")
        if any(it.num_device_reads > 2 + it.linear_solver_iterations
               for it in summary.iterations[1:]):
            raise AssertionError(f"the DOGLEG {kind} run read more than 2 + PCG steps times")


def line_search_run():
    """The overrides of lm_options for the line-search run at BAL-1778:
    minimizer_type=LINE_SEARCH, L-BFGS + WOLFE, 10 iterations (the traffic
    of the reference's bundle_adjuster --minimizer=line_search)."""
    import ceres_tpu_torch as ct

    return dict(minimizer_type=ct.MinimizerType.LINE_SEARCH,
                line_search_direction_type=ct.LineSearchDirectionType.LBFGS,
                line_search_type=ct.LineSearchType.WOLFE, max_num_iterations=10)


def phase_f64_minimizers(tmp):
    """Phase 3, the line-search minimizer, inner iterations, the dump,
    check_gradients and solve_gradient_problem in float64 on the card
    against the CPU, within 1e-9 per iteration with equal counts, on the
    small BAL: the line-search minimizer (L-BFGS + WOLFE + CUBIC; NCG
    Polak-Ribiere + ARMIJO, whose trials are residual-only: B1 and B3, not
    B2, B4 or B5), LM + SCHUR_JACOBI with use_inner_iterations on the host
    loop, and check_gradients passing; solve_gradient_problem on
    Rosenbrock's function (LBFGS, BFGS: x and the final cost); the problem
    dump of iteration 1 (every array within 1e-9, cols and row_ptr equal)."""
    import torch

    import ceres_tpu_torch as ct

    bal = ct.synthetic_bal(96, 4000, 48_000, seed=1)
    ls = dict(minimizer_type=ct.MinimizerType.LINE_SEARCH, max_num_iterations=5)
    gradient_only = ({"eval_snavely", "contract_reduce"},
                     {"gather_contract", "schur_sy", "schur_p0"})
    cases = [
        ("LINE_SEARCH LBFGS WOLFE CUBIC",
         dict(ls, line_search_direction_type=ct.LineSearchDirectionType.LBFGS,
              line_search_type=ct.LineSearchType.WOLFE,
              line_search_interpolation_type=ct.LineSearchInterpolationType.CUBIC),
         gradient_only),
        ("LINE_SEARCH NCG POLAK_RIBIERE ARMIJO",
         dict(ls, line_search_direction_type=ct.LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT,
              nonlinear_conjugate_gradient_type=ct.NonlinearConjugateGradientType.POLAK_RIBIERE,
              line_search_type=ct.LineSearchType.ARMIJO,
              line_search_interpolation_type=ct.LineSearchInterpolationType.QUADRATIC),
         gradient_only),
        ("LM SCHUR_JACOBI use_inner_iterations", dict(use_inner_iterations=True),
         ({"eval_snavely", "gather_contract", "contract_reduce", "schur_sy", "schur_p0"}, set())),
        ("LM SCHUR_JACOBI check_gradients",
         dict(check_gradients=True, gradient_check_relative_precision=1e-3, max_num_iterations=2),
         ({"eval_snavely", "schur_sy", "schur_p0"}, set())),
    ]
    for name, extra, (launched, not_launched) in cases:
        sums = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            problem = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]
            sums[dev] = ct.solve(lm_options(dev, torch.float64, **extra), problem)
            if dev == "cuda":
                launches = kernel_launches()
        worst = _same_iterations(name, sums)
        s = sums["cuda"]
        print(f"phase 3: {name}: float64, CUDA vs CPU: {len(s.iterations)} iterations "
              f"({'fused' if s.used_fused_execution else 'host loop'}), max per-iteration cost "
              f"rel diff {worst:.3e} (tol 1e-09), trials "
              f"{[it.line_search_iterations for it in s.iterations[1:]]}, gradient / residual "
              f"evaluations {s.num_jacobian_evaluations} / {s.num_residual_evaluations}, inner "
              f"iteration steps {s.num_inner_iteration_steps}, final cost {s.final_cost:.12e}, "
              f"{s.termination_type.value}, launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
        if any(launches[k] <= 0 for k in launched) or any(launches[k] for k in not_launched):
            raise AssertionError(f"{name}: the CUDA solve did not launch {sorted(launched)} "
                                 f"alone of {sorted(launched | not_launched)}")
        if s.termination_type == ct.TerminationType.FAILURE or not s.final_cost < s.initial_cost:
            raise AssertionError(f"{name}: the solve failed or did not decrease the cost "
                                 f"({s.message})")
        if extra.get("use_inner_iterations") and (
                s.used_fused_execution or s.num_inner_iteration_steps <= 0):
            raise AssertionError(f"{name}: no inner iterations on the host loop")
        if extra.get("line_search_type") == ct.LineSearchType.ARMIJO and not (
                s.num_residual_evaluations > 0):
            raise AssertionError(f"{name}: no residual-only evaluation")

    def rosenbrock(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    for direction in ("LBFGS", "BFGS"):
        out = {}
        for dev in ("cuda", "cpu"):
            options = ct.SolverOptions(
                minimizer_type=ct.MinimizerType.LINE_SEARCH, device=dev,
                line_search_direction_type=getattr(ct.LineSearchDirectionType, direction),
                max_num_iterations=300, function_tolerance=1e-14, gradient_tolerance=1e-10,
                parameter_tolerance=1e-14)
            out[dev] = ct.solve_gradient_problem(
                options, ct.GradientProblem(rosenbrock, size=2), [-1.2, 1.0])
        (xg, sg), (xc, sc) = out["cuda"], out["cpu"]
        dx = float(np.abs(xg - xc).max())
        dcost = abs(sg.final_cost - sc.final_cost) / sc.initial_cost
        print(f"phase 3: solve_gradient_problem Rosenbrock {direction}: float64, CUDA vs CPU: "
              f"{len(sg.iterations) - 1} iterations each ({len(sc.iterations) - 1}), x "
              f"{xg.tolist()}, max |x diff| {dx:.3e}, final cost {sg.final_cost:.3e} (diff "
              f"{dcost:.3e} of the initial cost; tol 1e-09), reads {sg.num_device_reads}",
              flush=True)
        if not (dx <= 1e-9 and dcost <= 1e-9 and len(sg.iterations) == len(sc.iterations)
                and float(np.abs(xg - 1.0).max()) <= 1e-4):
            raise AssertionError(f"Rosenbrock {direction}: the CUDA solve disagrees with the CPU")

    dumps = {}
    for dev in ("cuda", "cpu"):
        d = os.path.join(tmp, f"dump_{dev}")
        os.makedirs(d, exist_ok=True)
        problem = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]
        ct.solve(lm_options(dev, torch.float64, max_num_iterations=2,
                            trust_region_minimizer_iterations_to_dump=(1,),
                            trust_region_problem_dump_directory=d), problem)
        dumps[dev] = np.load(os.path.join(d, "ceres_tpu_problem_001.npz"))
    worst = {}
    for key in dumps["cpu"].files:
        a, b = dumps["cuda"][key], dumps["cpu"][key]
        if key in ("jacobian_cols", "jacobian_row_ptr"):
            if not np.array_equal(a, b):
                raise AssertionError(f"the dump's {key} differ between CUDA and CPU")
            continue
        worst[key] = float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-300))
    print(f"phase 3: problem dump of iteration 1: float64, CUDA vs CPU: "
          f"{len(dumps['cpu']['jacobian_values'])} Jacobian values, max rel diff per array "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})} (tol 1e-09), cols and "
          f"row_ptr equal", flush=True)
    if max(worst.values()) > 1e-9:
        raise AssertionError("the dumps of the CUDA and the CPU solve disagree")


def phase_line_search_run(bal, main):
    """Phase 4, the line-search minimizer at BAL-1778 (line_search_run: L-BFGS
    + WOLFE, 10 iterations, float32, on a new Problem): per iteration cost,
    trials, reads and ms beside the main run's first iterations; at most 2 +
    trials reads per iteration (3 + trials on a restart); B1 with the
    Jacobian at every trial (WOLFE takes the gradient at each, so its B1
    launches are all the Jacobian instantiation; phase 3's ARMIJO run takes
    the residual-only one) and B3 for each gradient; B4 and B5 not."""
    summary, counts = run_main_path(bal, "SCHUR_JACOBI", label="LINE_SEARCH LBFGS WOLFE",
                                    **line_search_run())
    for it in summary.iterations:
        print(f"phase 4: LINE_SEARCH LBFGS: iter {it.iteration}: cost {it.cost!r} trials "
              f"{it.line_search_iterations} step size {it.step_size:.6g} reads "
              f"{it.num_device_reads} replays {it.num_graph_replays} ms "
              f"{1000.0 * it.iteration_time_in_seconds:.1f}", flush=True)
    restarts = [it.iteration for it in summary.iterations[1:]
                if it.num_device_reads == 3 + it.line_search_iterations]
    print(f"phase 4: LINE_SEARCH LBFGS: {summary.num_jacobian_evaluations} gradient evaluations, "
          f"{summary.num_residual_evaluations} residual-only, restarts at {restarts}, device reads "
          f"{summary.num_device_reads}, {summary.termination_type.value}; main run's first "
          f"iterations ms {[round(1000.0 * it.iteration_time_in_seconds, 1) for it in main.iterations]}",
          flush=True)
    if any(it.num_device_reads - it.line_search_iterations not in (2, 3)
           for it in summary.iterations[1:]):
        raise AssertionError("the line-search run read more than 2 + trials (+1 on a restart) times")
    if not (counts["eval_snavely"] == summary.num_jacobian_evaluations
            + summary.num_residual_evaluations > 0 and counts["contract_reduce"] > 0):
        raise AssertionError("the line-search run did not launch B1 at every evaluation, or B3")
    if counts["schur_sy"] or counts["schur_p0"]:
        raise AssertionError("the line-search run launched B4 or B5")
    return counts


@contextlib.contextmanager
def recorded_refinements():
    """A with-block in which every inner-iteration refinement appends
    (cost before, cost after, ms by CUDA events) to the list it yields."""
    import torch

    from ceres_tpu_torch.solvers.inner_iterations import InnerIterationRefiner

    made, refine = [], InnerIterationRefiner.refine

    def spy(self, state, cost):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = refine(self, state, cost)
        end.record()
        end.synchronize()
        made.append((cost, out[1], start.elapsed_time(end)))
        return out

    InnerIterationRefiner.refine = spy
    try:
        yield made
    finally:
        InnerIterationRefiner.refine = refine


def phase_inner_iteration_run(bal, main):
    """Phase 4, LM + ITERATIVE_SCHUR + SCHUR_JACOBI with use_inner_iterations
    at BAL-1778 (3 iterations, float32, the host loop, a new Problem; the
    traffic of bundle_adjuster --inner_iterations): per iteration beside the
    main run, each refinement's cost before and after (after <= before) and
    its ms (two sweeps, each one graph replay with the candidate's cost,
    and their two reads; CUDA events)."""
    with recorded_refinements() as refinements:
        summary, counts = run_main_path(bal, "SCHUR_JACOBI", label="inner iterations",
                                        max_num_iterations=3, use_inner_iterations=True)
    for a, b in zip(main.iterations, summary.iterations):
        print(f"phase 4: iter {a.iteration}: SCHUR_JACOBI {_iteration_line(a)} | inner iterations "
              f"{_iteration_line(b)}", flush=True)
    for k, (before, after, ms) in enumerate(refinements):
        print(f"phase 4: inner iterations: refinement {k + 1}: cost {before!r} -> {after!r} in "
              f"{ms:.3f} ms ({ms / 2.0:.3f} ms per sweep)", flush=True)
    print(f"phase 4: inner iterations: num_inner_iteration_steps "
          f"{summary.num_inner_iteration_steps}, used_fused_execution "
          f"{summary.used_fused_execution}", flush=True)
    if summary.used_fused_execution or summary.num_inner_iteration_steps != len(refinements) or (
            not refinements):
        raise AssertionError("the inner-iteration run did not refine on the host loop")
    if any(after > before for before, after, _ in refinements):
        raise AssertionError("an inner-iteration refinement raised the cost")
    if any(counts[k] <= 0 for k in ("eval_snavely", "gather_contract", "contract_reduce",
                                    "schur_sy", "schur_p0")):
        raise AssertionError("the inner-iteration run did not launch B1-B5")
    return counts


def phase_sparse_schur_run():
    """Phase 4, SPARSE_SCHUR at Dubrovnik-356's shape (DUBROVNIK_356,
    Huber(1.0), float32, LM, 3 iterations, on the host loop, as its step
    factors on the host): every step the explicit branch (no fallback); the
    host plan's seconds and its S (camera-pair slots, pair blocks); the
    read of S and its bytes, the host factorization's seconds per step
    (execution summary); then, at the final state, the device assembly's
    ms (CUDA events, median of 3) and S bitwise equal across two
    assemblies."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.linalg import schur
    from ceres_tpu_torch.linalg.explicit_schur import ExplicitSchurPlan

    bal = ct.synthetic_bal(*DUBROVNIK_356, seed=0)
    made = []

    def build(b):
        made.append(ct.build_ba_problem(b, loss=ct.HuberLoss(1.0))[0])
        return made[-1]

    summary, counts = run_main_path(
        bal, "SCHUR_JACOBI", build=build, label="SPARSE_SCHUR, Dubrovnik-356 shape",
        max_num_iterations=3, linear_solver_type=ct.LinearSolverType.SPARSE_SCHUR)
    ex, n = summary.execution_summary, summary.num_linear_solves
    for it in summary.iterations[1:]:
        print(f"phase 4: SPARSE_SCHUR: iter {it.iteration}: {_iteration_line(it)}", flush=True)
    if summary.used_fused_execution:
        raise AssertionError("the SPARSE_SCHUR run took the fused loop")
    if ex.calls("SparseSchur::Explicit") != n or ex.calls("SparseSchur::Fallback"):
        raise AssertionError("the SPARSE_SCHUR run did not take the explicit branch at every step")
    if any(counts[k] <= 0 for k in ("eval_snavely", "gather_contract", "contract_reduce")) or (
            counts["schur_sy"] or counts["schur_p0"]):
        raise AssertionError("the SPARSE_SCHUR run: B1-B3 not launched, or B4 or B5 launched")

    program = made[0].compile()
    _, _, jac, _ = Evaluator(program, torch.float32).evaluate_groups(
        program.state_vector(torch.float32))
    jac_s = jac.scale_columns(1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
    dsq = torch.clamp(jac_s.squared_column_norms(), 1e-6, 1e32) / 1e4
    e_mask, f_mask = schur._masks(program, dsq)
    jac_e, jac_f = (v.materialize_scale() for v in schur.schur_views(program, jac_s))
    ete = schur.make_ete_solver(program, jac_e, dsq * e_mask)
    plan = ExplicitSchurPlan.get(program, jac_e, jac_f)
    ftf = jac_f.block_diag_jtj(dsq=dsq * f_mask)[plan.cam_cls]
    s1, s2 = (plan.assemble(jac_e, jac_f, ete, ftf) for _ in range(2))
    t_asm = median_ms(lambda: plan.assemble(jac_e, jac_f, ete, ftf), reps=3, warmup=1)
    bitwise = bool(torch.equal(s1, s2))
    print(f"phase 4: SPARSE_SCHUR: host plan {plan.seconds:.2f} s, S of {plan.n_cams} x "
          f"{plan.n_cams} blocks of {plan.tf} x {plan.tf}: {plan.n_slots} camera-pair slots, "
          f"{plan.n_pairs} pair blocks; per step: read of S "
          f"{ex.nbytes('SparseSchur::Read') / n / 1e6:.1f} MB in "
          f"{ex.seconds('SparseSchur::Read') / n:.3f} s, host factorization and solve "
          f"{ex.seconds('SparseSchur::HostSolve') / n:.3f} s; device assembly {t_asm:.2f} ms "
          f"(CUDA events), bitwise across two assemblies {bitwise}", flush=True)
    if not bitwise or not bool(torch.isfinite(s1).all()):
        raise AssertionError("the explicit S is not finite or not bitwise equal across assemblies")
    del made, program, jac, jac_s, jac_e, jac_f, ete, s1, s2
    gc.collect()
    torch.cuda.empty_cache()


def run_pose_graph(label, problem, truth_cost, **overrides):
    """Phase 4, one pose-graph solve in float64 on a new Problem (LM and the
    reference examples' defaults but `overrides`): its cost per iteration,
    its host factorizations, the final cost beside the truth's, and B1
    generic at every evaluation (its one group)."""
    import torch

    import ceres_tpu_torch as ct

    options = ct.SolverOptions(logging_type=ct.LoggingType.SILENT, dtype=torch.float64,
                               **overrides)
    reset_counts()
    t0 = time.time()
    summary = ct.solve(options, problem)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernel_launches()
    ex = summary.execution_summary
    host = "; ".join(
        f"{name} {ex.calls(name)} calls {ex.seconds(name):.3f} s"
        + (f" {ex.nbytes(name) / 1e6:.1f} MB" if ex.nbytes(name) else "")
        for name in ex.names() if name.split("::")[0] in ("SparseCholesky", "SubsetPreconditioner")
    )
    print(f"phase 4: {label}: {summary.num_residuals} residuals, "
          f"{summary.num_effective_parameters} parameters; solve {wall:.1f} s (preprocess "
          f"{summary.preprocessor_time_in_seconds:.1f} s), {len(summary.iterations) - 1} "
          f"iterations, {summary.termination_type.value}; initial cost {summary.initial_cost!r}, "
          f"final cost {summary.final_cost!r}, truth's cost {truth_cost!r}; device reads "
          f"{summary.num_device_reads}; {host}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    for it in summary.iterations[1:]:
        print(f"phase 4: {label}: iter {it.iteration}: {_iteration_line(it)}", flush=True)
    if not (all(math.isfinite(it.cost) for it in summary.iterations)
            and summary.final_cost < summary.initial_cost):
        raise AssertionError(f"{label}: non-finite or non-decreasing cost")
    if (launches["eval_generic"] != summary.num_jacobian_evaluations
            or launches["eval_generic_residual"] != summary.num_residual_evaluations
            or launches["eval_snavely"]):
        raise AssertionError(f"{label}: the graph's group did not take B1 generic at every "
                             "evaluation")
    return summary


def phase_pose_graph_runs(tmp):
    """Phase 4, the pose graphs: the sphere2500-shaped 3D graph
    (SPHERE_RINGS, written as a .g2o file and read back with load_g2o_3d)
    on SPARSE_NORMAL_CHOLESKY, as the reference's pose_graph_3d.cc solves
    it (up to 20 iterations), then CGNR + SUBSET with its odometry edges as
    the subset (5 iterations); the M3500-sized 2D graph
    (synthetic_pose_graph_2d(M3500_POSES, seed=0)) on
    SPARSE_NORMAL_CHOLESKY (up to 20 iterations). Each in float64, its
    final cost printed beside the cost at the true poses."""
    import dataclasses

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.examples import pose_graph

    path = os.path.join(tmp, "sphere2500_shape.g2o")
    pos, q = write_sphere_g2o(path, *SPHERE_RINGS, seed=0)
    g3 = pose_graph.load_g2o_3d(path)
    truth3 = pose_graph.build_pose_graph_3d_problem(
        dataclasses.replace(g3, positions=pos, quaternions=q))[0].evaluate()[0]
    n_odo = SPHERE_RINGS[0] * SPHERE_RINGS[1] - 1
    run_pose_graph("3D pose graph (sphere2500 shape), SPARSE_NORMAL_CHOLESKY",
                   pose_graph.build_pose_graph_3d_problem(g3)[0], truth3, max_num_iterations=20,
                   linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY)
    run_pose_graph("3D pose graph (sphere2500 shape), CGNR + SUBSET",
                   pose_graph.build_pose_graph_3d_problem(g3)[0], truth3, max_num_iterations=5,
                   linear_solver_type=ct.LinearSolverType.CGNR,
                   preconditioner_type=ct.PreconditionerType.SUBSET,
                   residual_blocks_for_subset_preconditioner=list(range(n_odo)))
    g2, truth = pose_graph.synthetic_pose_graph_2d(n=M3500_POSES, seed=0)
    truth2 = pose_graph.build_pose_graph_2d_problem(
        dataclasses.replace(g2, poses=truth))[0].evaluate()[0]
    run_pose_graph(f"2D pose graph ({M3500_POSES} poses), SPARSE_NORMAL_CHOLESKY",
                   pose_graph.build_pose_graph_2d_problem(g2)[0], truth2, max_num_iterations=20,
                   linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY)


def phase_kernels_batched(bal_program, dev, results):
    """Phase 2: the batched B2 and B3 (the covariance's PCG), k = 72, at
    Dubrovnik-356's shape in float64 (phase 4's covariance run) and at
    BAL-1778's in float32, on lane-major operands (gather_reduce.lanes_major:
    the column axis innermost, as the PCG gives them): max rel err against
    the plain version, bitwise equality with 72 single-vector launches
    column by column and from run to run, the median ms of each over 10
    runs (CUDA events) beside the 72 single launches' and the first
    versions' (FIRST_BATCHED_MS), the bound (the leaf once, rows, the k
    tables or u's, the k outputs) and its share, one torch.sparse CSR
    product against a dense [t*ncols, k] or [r*n, k] operand, and ptxas'
    registers and spills. The Dubrovnik float64 numbers go into the
    kernels line."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch import cuda_lib
    from ceres_tpu_torch.evaluator import Evaluator
    from ceres_tpu_torch.gather_reduce import (
        contract_reduce, contract_reduce_batched, contract_reduce_batched_plain,
        gather_contract, gather_contract_batched, gather_contract_batched_plain,
    )

    log = cuda_lib.BUILD_DIR / "build.log"
    regs = [ln for ln in ptxas_report(log.read_text()) if "batched" in ln] if log.exists() else []
    for ln in regs:
        print(f"phase 2: batched ptxas {ln}", flush=True)
    k, r, t = COV_COLUMNS, 2, 9
    for label, dtype, program in (("Dubrovnik-356", torch.float64, None),
                                  ("BAL-1778", torch.float32, bal_program)):
        if program is None:
            problem, _, _ = ct.build_ba_problem(ct.synthetic_bal(*DUBROVNIK_356, seed=0))
            program = problem.compile(dev)
        ev = Evaluator(program, dtype)
        _, _, jac, _ = ev.evaluate_groups(program.state_vector(dtype))
        garr = ev.arrays["groups"][0]
        leaf, rows, layout, twin = jac.leaf(0, 0), garr["t_rows"][0], garr["csr"][0], jac.twin(0, 0)
        n, ncols = leaf.shape[1], layout.offsets.shape[0] - 1
        gen = torch.Generator(device=dev).manual_seed(1)
        # lane-major: [k, t, ncols] over [ncols, t, k], [k, r, n] over [n, r, k]
        table = torch.randn((ncols, t, k), generator=gen, device=dev, dtype=dtype).permute(2, 1, 0)
        table[:, :, -1] = 0
        u = torch.randn((n, r, k), generator=gen, device=dev, dtype=dtype).permute(2, 1, 0)
        e = leaf.element_size()
        ops = 2 * r * t * n * k
        flops = F64_FLOPS_PER_S if dtype == torch.float64 else F32_FLOPS_PER_S
        cases = (
            ("gather_contract_batched",
             lambda: gather_contract_batched(leaf, rows, table, r, twin, layout),
             lambda: torch.stack([gather_contract(leaf, rows, table[c].contiguous(), r)
                                  for c in range(k)]),
             lambda: gather_contract_batched_plain(leaf, rows, table, r),
             e * (r * t * n + k * t * ncols + k * r * n) + 4 * n,
             lambda: library_b2(leaf, rows, table, r),
             lambda out: out.permute(1, 2, 0).reshape(r * n, k)),
            ("contract_reduce_batched",
             lambda: contract_reduce_batched(twin, layout, u, r),
             lambda: torch.stack([contract_reduce(twin, layout, u[c].contiguous(), r)
                                  for c in range(k)]),
             lambda: contract_reduce_batched_plain(twin, layout, u, r),
             e * (r * t * n + k * r * n + k * t * ncols) + 4 * n,
             lambda: library_b3(leaf, rows, u, ncols, r),
             lambda out: out.permute(1, 2, 0).reshape(t * ncols, k)),
        )
        for name, fn, singles, plain, nbytes, lib, as_lib in cases:
            out = fn()
            same = bool(torch.equal(out, singles()))
            again = bool(torch.equal(out, fn()))
            err = rel_err(out, plain())
            tol = BATCHED_TOL[name][str(dtype)[6:]]
            rec = {"err": err, "ms": median_ms(fn), "plain_ms": median_ms(plain, reps=3, warmup=1),
                   "library_ms": None}
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, flops)
            single_ms = median_ms(singles, reps=3, warmup=1)
            tmp = {name: rec}
            time_library(name, lib, as_lib(out), tmp)
            del out
            ok = same and again and err[1] <= tol
            lib_s = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
            print(f"phase 2: {name} {label} {str(dtype)[6:]} k {k}: max rel err {err[1]:.3e} "
                  f"(tol {tol:.0e}, max abs {err[0]:.3e}); bitwise equal to {k} single-vector "
                  f"launches {same}, from run to run {again}; kernel {rec['ms']:.4f} ms (first "
                  f"version: {FIRST_BATCHED_MS[name, label]} ms), {k} single launches "
                  f"{single_ms:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
                  f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it), library {lib_s}"
                  f"{'' if ok else '  FAILED'}", flush=True)
            if not ok:
                raise AssertionError(f"{name}: batched kernel differs from the single launches "
                                     "or between runs, or disagrees with its plain version")
            if dtype == torch.float64:
                results[name] = rec
        del jac, ev, table, u, leaf, twin
        gc.collect()
        torch.cuda.empty_cache()


def gauge_fixed_ba(bal, prepare=None):
    """(problem, pairs, lone): bal's BA problem with two cameras held
    constant (the gauge), then (after prepare(problem), if given) every
    point that fewer than two distinct cameras observe held constant
    (synthetic_bal guarantees two observations per point, not two cameras,
    and such a point leaves JᵀJ singular); pairs: 8 camera blocks and one
    cross block (72 columns); lone: how many points were held constant."""
    import ceres_tpu_torch as ct

    problem, cams, pts = ct.build_ba_problem(bal)
    problem.set_parameter_block_constant(cams[0])
    problem.set_parameter_block_constant(cams[1])
    if prepare is not None:
        prepare(problem)
    seen = np.unique(np.stack([bal.point_index, bal.camera_index], 1), axis=0)
    lone = np.nonzero(np.bincount(seen[:, 0], minlength=bal.num_points) < 2)[0]
    for i in lone:
        problem.set_parameter_block_constant(pts[i])
    free = [int(c) for c in cams[2:]]
    return problem, [(c, c) for c in free[:8]] + [(free[0], free[1])], len(lone)


def block_gap(a, b, pairs) -> float:
    """max over the pairs of max|a - b| / max|b| of each block (a, b:
    Covariances, or functions of a pair)."""
    get = [x.get_covariance_block if hasattr(x, "get_covariance_block") else x for x in (a, b)]
    gap = 0.0
    for bi, bj in pairs:
        x, y = (np.asarray(g(bi, bj)) for g in get)
        gap = max(gap, float(np.abs(x - y).max() / np.abs(y).max()))
    return gap


def covariance(problem, pairs, algo, device, **kw):
    """(Covariance after compute, its return, seconds)."""
    import ceres_tpu_torch as ct

    cov = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=getattr(ct.CovarianceAlgorithmType, algo), device=device, **kw))
    t0 = time.time()
    ok = cov.compute(pairs, problem)
    return cov, ok, time.time() - t0


def _steps(cov) -> str:
    its = cov.pcg_stats["iterations"]
    return (f"PCG steps per column min {its.min()} median {int(np.median(its))} max {its.max()}, "
            f"reads {cov.pcg_stats['reads']}")


def phase_f64_covariance():
    """Phase 3: covariance on the card against the CPU in float64, within
    1e-9 of each block's scale: SPARSE_QR and ITERATIVE_PCG (the batched
    B2/B3 launched on the card) on the phase's 48,000-observation BAL,
    gauge-fixed, 8 camera blocks and one cross block; DENSE_SVD on
    ceres_tpu's own test problem (tests/test_covariance_scale.py:17-23),
    where J densifies (at 48,000 observations the dense J would be ~10 GB).
    Then tiny_solve and tiny_solve_batched on MGH problems: the same
    iterations and convergence per lane, x within 1e-10."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.examples.more_garbow_hillstrom import PROBLEMS

    cases = (
        ("SPARSE_QR", (96, 4000, 48_000), {}),
        ("ITERATIVE_PCG", (96, 4000, 48_000), {"iterative_max_iterations": COV_MAX_ITERATIONS}),
        ("DENSE_SVD", (10, 300, 3000), {}),
    )
    for algo, sizes, kw in cases:
        noise = {"observation_noise": 0.5} if sizes[0] == 10 else {}
        bal = ct.synthetic_bal(*sizes, seed=11 if noise else 1, **noise)
        covs = {}
        for dev in ("cuda", "cpu"):
            problem, pairs, lone = gauge_fixed_ba(bal)
            reset_counts()
            covs[dev] = covariance(problem, pairs, algo, dev, **kw)
            if dev == "cuda":
                launches = kernel_launches()
        (cc, ok_c, s_c), (cp, ok_p, s_p) = covs["cuda"], covs["cpu"]
        gap = block_gap(cc, cp, pairs) if ok_c and ok_p else float("nan")
        extra = ""
        if algo == "ITERATIVE_PCG":
            extra = (f"; card {_steps(cc)}, CPU {_steps(cp)}; batched launches "
                     f"{launches['gather_contract_batched']} / "
                     f"{launches['contract_reduce_batched']}")
        print(f"phase 3: covariance {algo} synthetic_bal{sizes} float64, {lone} lone points held "
              f"constant, CUDA vs CPU: compute {ok_c} / {ok_p}, max block rel diff {gap:.3e} "
              f"(tol 1e-9); {s_c:.1f} s / {s_p:.1f} s{extra}", flush=True)
        if not (ok_c and ok_p and gap <= 1e-9):
            raise AssertionError(f"covariance {algo}: the card disagrees with the CPU")
        if algo == "ITERATIVE_PCG" and not (
                launches["gather_contract_batched"] > 0 and launches["contract_reduce_batched"] > 0
                and np.array_equal(cc.pcg_stats["iterations"], cp.pcg_stats["iterations"])):
            raise AssertionError("ITERATIVE_PCG: batched B2/B3 not launched, or other PCG steps")
    # well-conditioned at their minima: Box 3D, Biggs EXP6, Wood and
    # Jennrich-Sampson move x by 1e-9 to 1e-2 under a 1e-15 relative
    # change of the start (on the CPU alone), beyond a card/CPU tolerance
    # of 1e-10
    rng = np.random.default_rng(5)
    for name in ("rosenbrock", "freudenstein_roth", "powell_singular", "helical_valley", "bard",
                 "kowalik_osborne"):
        spec = next(p for p in PROBLEMS if p.name == name)

        def fn(x, spec=spec):
            return spec.residual_fn((x,), ())

        x0 = spec.x0[None] * (1.0 + 0.5 * rng.uniform(-1, 1, (64, spec.x0.size))) + rng.normal(
            0, 0.1, (64, spec.x0.size))
        res = {dev: ct.tiny_solve_batched(fn, torch.tensor(x0, device=dev)) for dev in ("cuda", "cpu")}
        one = {dev: ct.tiny_solve(fn, torch.tensor(x0[0], device=dev)) for dev in ("cuda", "cpu")}
        same = all(torch.equal(getattr(res["cuda"], f).cpu(), getattr(res["cpu"], f))
                   for f in ("iterations", "converged")) and all(
            torch.equal(getattr(one["cuda"], f).cpu(), getattr(one["cpu"], f))
            for f in ("iterations", "converged"))
        xc, xp = res["cuda"].x.cpu().numpy(), res["cpu"].x.numpy()
        gap = float((np.abs(xc - xp) / np.maximum(np.abs(xp).max(axis=1, keepdims=True), 1.0)).max())
        gap = max(gap, float((one["cuda"].x.cpu() - one["cpu"].x).abs().max()
                             / max(float(one["cpu"].x.abs().max()), 1.0)))
        its = res["cpu"].iterations.numpy()
        print(f"phase 3: tiny_solve_batched {name}, 64 starts, CUDA vs CPU: the same iterations "
              f"and converged per lane {same} (iterations {its.min()}-{its.max()}, "
              f"{int(res['cpu'].converged.sum())} converged), x max rel diff {gap:.3e} "
              f"(tol 1e-10); tiny_solve of lane 0: {int(one['cuda'].iterations)} iterations",
              flush=True)
        if not (same and gap <= 1e-10):
            raise AssertionError(f"tiny solver {name}: the card disagrees with the CPU")


def reduced_camera_inverse(program, jac, pair_chunk=1 << 20):
    """S⁻¹ of the reduced camera system, assembled here in plain torch from
    the Jacobian's two leaves (camera position 0, point position 1), apart
    from the port's Schur code: with E_o, F_o the point and camera blocks
    of observation o, M_p = Σ_o E_oᵀE_o over the free point p's
    observations and W_o = E_oᵀF_o, S = Σ_o F_oᵀF_o − Σ_p Σ_(a,b of p)
    W_aᵀ M_p⁻¹ W_b over the free cameras (D = 0); dense in float64,
    factored by a dense Cholesky and inverted. An observation of a point
    held constant adds its F_oᵀF_o only. Returns (S⁻¹ [nc*9, nc*9], S's
    condition number from eigvalsh, the camera class)."""
    import torch

    meta = program.groups[0]
    cam, pt = meta.positions
    rows = program.group_idx[0]["t_rows"]
    nc, npt = (program.tangent_class_counts[pm.t_cls] for pm in (cam, pt))
    tf, te = cam.tangent_size, pt.tangent_size
    dev = jac._device()
    f = jac.leaf(0, 0).reshape(2, tf, -1).permute(2, 0, 1)  # [n, 2, tf]
    e = jac.leaf(0, 1).reshape(2, te, -1).permute(2, 0, 1)  # [n, 2, te]
    c_rows = torch.as_tensor(rows[0].astype(np.int64), device=dev)
    p_rows = rows[1].astype(np.int64)
    live_c = c_rows < nc
    s4 = torch.zeros((nc, nc, tf, tf), dtype=torch.float64, device=dev)
    cl = c_rows[live_c]
    s4.index_put_((cl, cl), (f.mT @ f)[live_c], accumulate=True)
    live_p = np.nonzero(p_rows < npt)[0]
    p_dev = torch.as_tensor(p_rows[live_p], device=dev)
    m = torch.zeros((npt, te, te), dtype=torch.float64, device=dev)
    m.index_add_(0, p_dev, (e.mT @ e)[live_p])
    w = e.mT @ f  # [n, te, tf]
    t = torch.zeros_like(w)
    t[live_p] = torch.linalg.inv(m)[p_dev] @ w[live_p]
    # the pairs (a, b) of observations of one free point, by multiplicity
    order = live_p[np.argsort(p_rows[live_p], kind="stable")]
    _, starts, counts = np.unique(p_rows[order], return_index=True, return_counts=True)
    for d in np.unique(counts):
        obs = order[starts[counts == d][:, None] + np.arange(d)[None, :]]
        a = np.broadcast_to(obs[:, :, None], (len(obs), d, d)).reshape(-1)
        b = np.broadcast_to(obs[:, None, :], (len(obs), d, d)).reshape(-1)
        for k0 in range(0, a.size, pair_chunk):
            ai = torch.as_tensor(a[k0:k0 + pair_chunk], device=dev)
            bi = torch.as_tensor(b[k0:k0 + pair_chunk], device=dev)
            ok = live_c[ai] & live_c[bi]
            ai, bi = ai[ok], bi[ok]
            s4.index_put_((c_rows[ai], c_rows[bi]), -(w[ai].mT @ t[bi]), accumulate=True)
    s = s4.permute(0, 2, 1, 3).reshape(nc * tf, nc * tf)
    s = 0.5 * (s + s.T)
    ev = torch.linalg.eigvalsh(s)
    inv = torch.cholesky_inverse(torch.linalg.cholesky(s))
    return inv, float(ev[-1] / ev[0]), cam.t_cls


def camera_block(program, inv, cam_cls, bi, bj):
    """Block (bi, bj) of S⁻¹, cameras by their class rows."""
    i, j = int(program.t_row[bi]), int(program.t_row[bj])
    s = program.tangent_class_sizes[cam_cls]
    return inv[i * s:(i + 1) * s, j * s:(j + 1) * s].cpu().numpy()


def phase_covariance_run():
    """Phase 4, the slice at a real size: covariance at Dubrovnik-356's
    shape (DUBROVNIK_356, float64) on a new Problem, two cameras held
    constant (the gauge), after a 3-iteration LM + ITERATIVE_SCHUR solve;
    then every point that fewer than two distinct cameras observe held
    constant, and ITERATIVE_PCG over 8 camera blocks and one cross block (72
    columns) at the default tolerance and iterative_max_iterations 20,000:
    PCG steps per column, ms per step, reads (at most steps + 3), seconds,
    peak device memory beside the estimate, the batched B2/B3 launched in
    the PCG and the single-vector B2/B3 not. The blocks are held against
    S⁻¹ (reduced_camera_inverse) at 10 x the PCG tolerance x S's condition
    number. Returns the PCG's launches."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.evaluator import Evaluator

    bal = ct.synthetic_bal(*DUBROVNIK_356, seed=0)
    t0 = time.time()
    solved = []
    problem, pairs, lone = gauge_fixed_ba(bal, lambda p: solved.append(
        ct.solve(lm_options("cuda", torch.float64, max_num_iterations=3), p)))
    solved, t_solve = solved[0], time.time() - t0
    program = problem.compile("cuda")
    n_eff, n = program.num_effective_parameters, bal.num_observations
    # per column: x, r, p, z, Ap, b and two temporaries of the tangent size,
    # J p [2, n], and the point side's [2, 3, n] products and [3, n] sums
    estimate = 8 * COV_COLUMNS * (8 * n_eff + 2 * n + 6 * n + 3 * n)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cov, ok, secs = covariance(problem, pairs, "ITERATIVE_PCG", "cuda",
                               iterative_max_iterations=COV_MAX_ITERATIONS)
    peak = torch.cuda.max_memory_allocated()
    st = cov.pcg_stats
    launches = st["launches"]
    steps = int(st["iterations"].max())
    print(f"phase 4: covariance ITERATIVE_PCG at Dubrovnik-356's shape float64 after "
          f"{len(solved.iterations) - 1} LM iterations ({t_solve:.1f} s, cost "
          f"{solved.initial_cost:.6e} -> {solved.final_cost:.6e}); {lone} points seen by "
          f"fewer than two cameras held constant; {COV_COLUMNS} columns, {n_eff} parameters: "
          f"compute {ok}; {_steps(cov)}; {1e3 * st['seconds'] / max(steps, 1):.3f} ms per step; "
          f"PCG {st['seconds']:.1f} s, compute {secs:.1f} s; peak device memory "
          f"{peak / 1e9:.2f} GB (estimate {estimate / 1e9:.2f} GB); PCG launches "
          f"{json.dumps(launches)}; per matvec (steps + 1) B2 batched "
          f"{launches.get('gather_contract_batched', 0) / (steps + 1):.3f}, B3 batched "
          f"{launches.get('contract_reduce_batched', 0) / (steps + 1):.3f}", flush=True)
    if not ok:
        raise AssertionError("covariance at Dubrovnik-356's shape did not converge")
    if st["reads"] > steps + 3:
        raise AssertionError(f"the covariance PCG read {st['reads']} times in {steps} steps")
    if not (launches.get("gather_contract_batched", 0) > 0
            and launches.get("contract_reduce_batched", 0) > 0):
        raise AssertionError("the covariance PCG did not launch the batched B2/B3")
    if launches.get("gather_contract", 0) or launches.get("contract_reduce", 0):
        raise AssertionError("the covariance PCG launched the single-vector B2/B3")
    t0 = time.time()
    _, _, jac, _ = Evaluator(program, torch.float64).evaluate_groups(
        program.state_vector(torch.float64))
    inv, cond, cam_cls = reduced_camera_inverse(program, jac)
    gap = block_gap(cov, lambda bi, bj: camera_block(program, inv, cam_cls, bi, bj), pairs)
    tol = 10 * cov.options.iterative_tolerance * cond
    print(f"phase 4: covariance blocks vs S⁻¹ (S assembled at D = 0, dense float64 Cholesky, "
          f"{time.time() - t0:.1f} s): max block rel diff {gap:.3e} (tol {tol:.1e} = 10 x "
          f"tolerance {cov.options.iterative_tolerance:.0e} x cond(S) {cond:.3e})", flush=True)
    if not gap <= tol:
        raise AssertionError("covariance blocks disagree with S⁻¹")
    del cov, jac, inv, program, problem
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_tiny_multistart():
    """Phase 4: tiny_solve_batched on FR_STARTS starts of Freudenstein-Roth
    in float64, drawn with numpy from a seed over [-FR_BOX, FR_BOX]^2 (a
    multistart: the problem has a global and a local minimum): ms, reads,
    the distribution of iterations and the share of lanes at each minimum;
    FR_SAMPLED sampled lanes held against the CPU (tiny_solve_batched, and
    tiny_solve on 16 of them): the same iterations, x within 1e-10."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.examples.more_garbow_hillstrom import PROBLEMS
    from ceres_tpu_torch.utils.execution_summary import counts

    spec = next(p for p in PROBLEMS if p.name == "freudenstein_roth")

    def freudenstein_roth(x):
        return spec.residual_fn((x,), ())

    rng = np.random.default_rng(14)
    x0 = rng.uniform(-FR_BOX, FR_BOX, (FR_STARTS, 2))
    x0_dev = torch.tensor(x0, device="cuda")
    ct.tiny_solve_batched(freudenstein_roth, x0_dev[:1024])  # warm-up
    torch.cuda.synchronize()
    reads0, t0 = counts()["Device::Read"], time.perf_counter()
    res = ct.tiny_solve_batched(freudenstein_roth, x0_dev)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    reads = counts()["Device::Read"] - reads0
    its = res.iterations.cpu().numpy()
    cost = res.cost.cpu().numpy()
    share = {"global (cost < 1e-8)": float(np.mean(cost < 1e-8)),
             "local (cost 24.4921)": float(np.mean(np.abs(cost - 24.4921) < 1e-3))}
    pick = np.sort(rng.choice(FR_STARTS, FR_SAMPLED, replace=False))
    cpu = ct.tiny_solve_batched(freudenstein_roth, torch.tensor(x0[pick]))
    same = bool(np.array_equal(its[pick], cpu.iterations.numpy())) and bool(
        np.array_equal(res.converged.cpu().numpy()[pick], cpu.converged.numpy()))
    xg, xc = res.x.cpu().numpy()[pick], cpu.x.numpy()
    gap = float((np.abs(xg - xc) / np.maximum(np.abs(xc).max(axis=1, keepdims=True), 1.0)).max())
    for e in pick[:16]:
        one = ct.tiny_solve(freudenstein_roth, torch.tensor(x0[e]))
        same &= int(one.iterations) == its[e]
        gap = max(gap, float(np.abs(one.x.numpy() - res.x[e].cpu().numpy()).max()
                             / max(float(np.abs(one.x.numpy()).max()), 1.0)))
    hist = np.bincount(its)
    print(f"phase 4: tiny_solve_batched Freudenstein-Roth, {FR_STARTS} starts in "
          f"[-{FR_BOX:g}, {FR_BOX:g}]^2 float64: {ms:.1f} ms, {reads} reads, iterations min "
          f"{its.min()} median {int(np.median(its))} max {its.max()} (lanes by iterations "
          f"{json.dumps({int(i): int(c) for i, c in enumerate(hist) if c})}), converged "
          f"{float(res.converged.double().mean()):.4f}, share of lanes {json.dumps(share)}; "
          f"{FR_SAMPLED} sampled lanes vs the CPU: the same iterations and converged {same}, "
          f"x max rel diff {gap:.3e} (tol 1e-10)", flush=True)
    if not (same and gap <= 1e-10):
        raise AssertionError("tiny_solve_batched on the card disagrees with the CPU")


def write_bal_text(bal, path):
    """`bal` as a BAL text file, every value in %.17g (a double's round
    trip: tests/test_native.py's format)."""
    with open(path, "w") as f:
        f.write(f"{bal.num_cameras} {bal.num_points} {bal.num_observations}\n")
        f.write("".join(f"{c} {p} {u:.17g} {v:.17g}\n" for c, p, (u, v) in zip(
            bal.camera_index.tolist(), bal.point_index.tolist(), bal.observations.tolist())))
        f.write("".join(f"{x:.17g}\n" for x in np.concatenate(
            [bal.cameras.reshape(-1), bal.points.reshape(-1)]).tolist()))


def phase_native_loader_run(tmp):
    """Phase 4, the loaded-file run: Dubrovnik-356's shape written as a BAL
    file, parsed by the native parser and by numpy (bitwise equal), and
    the main configuration solved on it for 3 iterations, bitwise the same
    solve of the in-memory problem (B1-B5 launched)."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.io import bal as tbal
    from ceres_tpu_torch.io import native

    if not native.available():
        raise AssertionError("no C++ compiler on PATH: the native BAL loader cannot build")
    t_phase = time.time()
    bal = ct.synthetic_bal(*DUBROVNIK_356, seed=0)
    path = os.path.join(tmp, "dubrovnik-356-shape.txt")
    t0 = time.time()
    write_bal_text(bal, path)
    t_write = time.time() - t0
    t0 = time.time()
    native.load_bal_native(path)  # builds the library
    t_build = time.time() - t0
    t0 = time.time()
    loaded = ct.load_bal(path)
    t_native = time.time() - t0
    t0 = time.time()
    plain = tbal.load_bal_numpy(path)
    t_numpy = time.time() - t0
    fields = ("cameras", "points", "camera_index", "point_index", "observations")
    same = all(getattr(loaded, f).dtype == getattr(plain, f).dtype
               and getattr(loaded, f).tobytes() == getattr(plain, f).tobytes() for f in fields)
    exact = all(np.array_equal(getattr(loaded, f), getattr(bal, f)) for f in fields)
    print(f"phase 4: BAL file at Dubrovnik-356's shape ({os.path.getsize(path) / 1e6:.1f} MB, "
          f"written in {t_write:.1f} s): native parser {t_native:.3f} s (library built or "
          f"found in {t_build:.1f} s), numpy parser {t_numpy:.3f} s ({t_numpy / t_native:.1f}x); "
          f"arrays bitwise equal {same}, equal to the in-memory problem {exact}", flush=True)
    if not (same and exact):
        raise AssertionError("the native and numpy BAL parsers disagree")
    memory, _ = run_main_path(bal, "SCHUR_JACOBI", label="in memory, Dubrovnik-356's shape",
                              fused_execution_chunk_iters=1, max_num_iterations=3)
    del bal, plain
    from_file, launches = run_main_path(loaded, "SCHUR_JACOBI",
                                        label="loaded from the file, Dubrovnik-356's shape",
                                        fused_execution_chunk_iters=1, max_num_iterations=3)
    for a, b in zip(memory.iterations, from_file.iterations, strict=True):
        print(f"phase 4: Dubrovnik-356's shape: iter {a.iteration}: in memory "
              f"{_iteration_line(a)} | loaded {_iteration_line(b)}", flush=True)
    if [(it.cost, it.linear_solver_iterations) for it in memory.iterations] != [
            (it.cost, it.linear_solver_iterations) for it in from_file.iterations]:
        raise AssertionError("the loaded problem's solve is not bitwise the in-memory one's")
    missing = [k for k in ("eval_snavely", "gather_contract", "contract_reduce", "schur_sy",
                           "schur_p0") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the loaded-file run: {missing}")
    print(f"phase 4: the loaded-file run took {time.time() - t_phase:.1f} s", flush=True)


def _c_api_problem(capi, rows, losses=()):
    """A capi.CProblem fitting (m, c) to rows (the C example's callback:
    user_data points at (x, y)), plus one block per (row, loss kind, C loss
    callback or None) of `losses`; returns (CProblem, m, c, what the caller
    keeps alive)."""
    import ctypes

    dptr = ctypes.POINTER(ctypes.c_double)

    @capi.COST_FUNC_T
    def exponential_residual(user_data, parameters, residuals, jacobians):
        x, y = ctypes.cast(user_data, dptr)[0:2]
        m, c = parameters[0][0], parameters[1][0]
        e = math.exp(m * x + c)
        residuals[0] = y - e
        if jacobians:
            if jacobians[0]:
                jacobians[0][0] = -x * e
            if jacobians[1]:
                jacobians[1][0] = -e
        return 1

    data = np.ascontiguousarray(np.concatenate(
        [rows, np.reshape([r for r, _, _ in losses], (-1, 2))]), dtype=np.float64)
    m, c = np.array([0.0]), np.array([0.0])
    cp = capi.CProblem()
    fn = ctypes.cast(exponential_residual, ctypes.c_void_p).value
    kinds = [(-1, None)] * len(rows) + [(k, cb) for _, k, cb in losses]
    for i, (kind, cb) in enumerate(kinds):
        cp.add_residual_block_c(fn, data[i].ctypes.data, kind, 1.0, 0.0, 1,
                                [m.ctypes.data, c.ctypes.data], [1, 1],
                                ctypes.cast(cb, ctypes.c_void_p).value if cb else 0, 0)
    return cp, m, c, (exponential_residual, data)


def _lcg_rows(n=67):
    """examples/curve_fitting.c's make_data in numpy."""
    out, s = np.empty((n, 2)), 12345
    for i in range(n):
        s = (s * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        x = 0.075 * i
        out[i] = x, math.exp(0.3 * x + 0.1) + ((s >> 11) / 9007199254740992.0 - 0.5) * 0.2
    return out


def phase_c_api_run(tmp):
    """Phase 4, the C API: (a) a CProblem with ctypes callbacks on the card
    against the same on the CPU; (b) the unchanged examples/curve_fitting.c
    linked against the shim, run on the card, against a CProblem on the
    CPU."""
    import ctypes

    from ceres_tpu_torch import capi
    from ceres_tpu_torch.utils.execution_summary import counts

    t_phase = t0 = time.time()
    shim = capi.build_shim()
    print(f"phase 4: C API shim {shim.name} built or found in {time.time() - t0:.1f} s "
          f"(g++, {os.path.basename(str(shim.parent))})", flush=True)

    @capi.LOSS_FUNC_T
    def log_loss(user_data, s, out):
        out[0], out[1], out[2] = math.log1p(s), 1.0 / (1.0 + s), -1.0 / (1.0 + s) ** 2

    rng = np.random.default_rng(5)
    x = 0.075 * np.arange(67)
    rows = np.stack([x, np.exp(0.3 * x + 0.1) + rng.normal(0, 0.05, 67)], axis=1)
    losses = [((5.1, 8.0), 0, None), ((5.2, 2.0), -1, log_loss)]  # Huber(1), the C loss
    runs = {}
    for device in ("cpu", None):
        if device is None:
            os.environ.pop(capi.DEVICE_ENV, None)
        else:
            os.environ[capi.DEVICE_ENV] = device
        cp, m, c, keep = _c_api_problem(capi, rows, losses)
        reset_counts()
        t0 = time.time()
        report = cp.solve()
        wall = time.time() - t0
        s = cp.summary
        evals = s.num_residual_evaluations + s.num_jacobian_evaluations
        table = counts()
        stats = {"round_trips": table["CAPI::RoundTrip"], "calls": table["CAPI::Call"]}
        runs[str(cp.device)] = (s, float(m[0]), float(c[0]))
        iters = len(s.iterations) - 1
        print(f"phase 4: C API CProblem on {cp.device} ({s.num_residual_blocks} blocks, "
              f"{len(cp.problem.compile(cp.device).groups)} groups, float64, "
              f"{'fused' if s.used_fused_execution else 'host'} loop): "
              f"{report.splitlines()[0]}; solve {wall:.2f} s, minimizer "
              f"{1e3 * s.minimizer_time_in_seconds / max(iters, 1):.1f} ms per iteration "
              f"({iters} iterations); {stats['round_trips']} host round trips in {evals} "
              f"evaluations ({stats['round_trips'] / max(evals, 1):.1f} each), "
              f"{stats['calls']} C calls, {s.num_device_reads} device reads "
              f"({s.num_device_reads / max(evals, 1):.1f} per evaluation); m {float(m[0])!r} "
              f"c {float(c[0])!r}", flush=True)
        del keep
    os.environ.pop(capi.DEVICE_ENV, None)
    if set(runs) != {"cpu", "cuda"}:
        raise AssertionError(f"the C API ran on {sorted(runs)}, not on the card and the CPU")
    (cs, cm, cc), (gs, gm, gc_) = runs["cpu"], runs["cuda"]
    gap = max(abs(a.cost - b.cost) / abs(a.cost) for a, b in zip(cs.iterations, gs.iterations))
    print(f"phase 4: C API card vs CPU: iterations {len(gs.iterations)} vs {len(cs.iterations)}, "
          f"per-iteration cost max rel diff {gap:.3e} (tol 1e-9), m {abs(gm - cm):.3e} "
          f"c {abs(gc_ - cc):.3e}", flush=True)
    if not (len(gs.iterations) == len(cs.iterations) and gap <= 1e-9
            and abs(gm - cm) <= 1e-9 * abs(cm) and abs(gc_ - cc) <= 1e-9 * abs(cc)):
        raise AssertionError("the C API's solve on the card disagrees with the CPU")

    root = os.path.dirname(os.path.abspath(__file__))
    exe = capi.link_c_program(os.path.join(root, "examples", "curve_fitting.c"),
                              os.path.join(tmp, "curve_fitting"), shim)
    env = {k: v for k, v in os.environ.items() if k != capi.DEVICE_ENV}
    t0 = time.time()
    proc = subprocess.run([exe], capture_output=True, text=True, timeout=600, env=env)
    wall = time.time() - t0
    found = re.search(r"^Final m: (\S+) c: (\S+)", proc.stdout, re.M)
    device = re.search(r"^device: (\S+)", proc.stdout, re.M)
    if proc.returncode != 0 or found is None or device is None:
        raise AssertionError(f"examples/curve_fitting.c failed (rc {proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    os.environ[capi.DEVICE_ENV] = "cpu"
    try:
        cp, m, c, keep = _c_api_problem(capi, _lcg_rows())
        cp.solve()
    finally:
        os.environ.pop(capi.DEVICE_ENV, None)
    want = ("%g" % m[0], "%g" % c[0])
    summary_line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("Solver Summary")), "")
    print(f"phase 4: C API examples/curve_fitting.c (unchanged, linked against the shim) on "
          f"{device.group(1)}: exit {proc.returncode} in {wall:.1f} s; {summary_line}; "
          f"Final m: {found.group(1)} c: {found.group(2)}; CProblem on the CPU: m {want[0]} "
          f"c {want[1]}", flush=True)
    if device.group(1) != "cuda" or found.groups() != want:
        raise AssertionError("examples/curve_fitting.c did not run on the card or disagrees "
                             "with the CPU")
    print(f"phase 4: the C API runs took {time.time() - t_phase:.1f} s", flush=True)


def _iteration_line(it) -> str:
    return (
        f"cost {it.cost!r} pcg {it.linear_solver_iterations} ms "
        f"{1000.0 * it.iteration_time_in_seconds:.1f} reads {it.num_device_reads} replays "
        f"{it.num_graph_replays} {'accepted' if it.step_is_successful else 'rejected'}"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Drive the port's BA solve on one CUDA card.")
    parser.add_argument(
        "--phase", type=int, choices=(2,),
        help="stop after phase 2 (the kernels, the twin builds, schur_prepare); no result line",
    )
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ceres_tpu_torch as ct
    from ceres_tpu_torch import cuda_lib
    from ceres_tpu_torch.utils.dtypes import resolve_device

    t_start = time.time()
    dev = resolve_device("cuda")
    smi = nvidia_smi_line()
    t0 = time.time()
    cuda_lib.library()
    build_s = time.time() - t0
    log = cuda_lib.BUILD_DIR / "build.log"
    regs = ptxas_report(log.read_text()) if log.exists() else []
    print(
        f"phase 1: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | kernels built in {build_s:.1f} s",
        flush=True,
    )
    for ln in regs:
        print(f"phase 1: ptxas {ln}", flush=True)
    redesigned = [ln for ln in regs if ln.split("<")[0] in BF16_REDESIGNED]
    print(f"phase 1: the bfloat16 B3 and B4 kernels (registers, spills): "
          f"{' | '.join(redesigned) or 'not in the ptxas report'}", flush=True)

    t0 = time.time()
    bal = ct.synthetic_bal(1778, NUM_POINTS, NUM_OBSERVATIONS, seed=0)
    t_data = time.time() - t0
    t0 = time.time()
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    program = problem.compile(dev)
    print(
        f"phase 2: BAL-1778 data ({NUM_POINTS} points, {NUM_OBSERVATIONS} observations) "
        f"made in {t_data:.1f} s, problem + Program in {time.time() - t0:.1f} s, "
        f"{len(program.groups[0].red_plans[program.groups[0].owner][1])} point buckets",
        flush=True,
    )
    phase_generic_build(program, dev)
    results = {}
    phase_kernels(program, dev, results)
    phase_kernels_masked(program, dev, results)
    phase_kernels_batched(program, dev, results)
    phase_kernels_generic(program, dev, results)
    phase_kernels_generic_analytic(dev, results)
    del problem, program
    torch.cuda.empty_cache()
    phase_kernels_quat(bal, dev, results)
    if args.phase == 2:
        print(f"phase 2 only: {time.time() - t_start:.1f} s; no result", flush=True)
        return 0

    phase_f64_parity()
    phase_f64_generic()
    phase_f64_rules()
    tmp = tempfile.TemporaryDirectory()
    phase_f64_host_solvers(tmp.name)
    phase_f64_minimizers(tmp.name)
    phase_f64_covariance()

    # phase 4: the main run (SCHUR_JACOBI on the fused loop, kernels B1-B5),
    # the host loop on the same problem, then JACOBI (B1-B4)
    main, launches = run_main_path(bal, "SCHUR_JACOBI", fused_execution_chunk_iters=1)
    if not main.used_fused_execution:
        raise AssertionError("the main run did not take the fused loop")
    missing = [k for k, v in launches.items()
               if v <= 0 and k not in BF16_KERNELS | QUAT_NAMES | GENERIC_NAMES | MASKED_NAMES | BATCHED_NAMES]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    host, _ = run_main_path(bal, "SCHUR_JACOBI", fused_execution=False)
    for a, b in zip(main.iterations, host.iterations, strict=True):
        print(f"phase 4: iter {a.iteration}: fused {_iteration_line(a)} | host loop "
              f"{_iteration_line(b)}", flush=True)
        if (a.linear_solver_iterations, a.step_is_successful) != (
            b.linear_solver_iterations, b.step_is_successful
        ):
            raise AssertionError(f"iteration {a.iteration}: the fused and host loops diverge")
    rel = abs(main.final_cost - host.final_cost) / abs(host.final_cost)
    print(f"phase 4: fused vs host loop final cost rel diff {rel:.3e} (tol 1e-4)", flush=True)
    if not rel <= 1e-4:
        raise AssertionError("the fused and host loops end at different costs")
    jacobi, jacobi_launches = run_main_path(bal, "JACOBI", fused_execution_chunk_iters=1,
                                            max_num_iterations=3)
    missing = [k for k, v in jacobi_launches.items()
               if v <= 0 and k != "schur_p0"
               and k not in BF16_KERNELS | QUAT_NAMES | GENERIC_NAMES | MASKED_NAMES | BATCHED_NAMES]
    if missing:
        raise AssertionError(f"kernels not launched by the JACOBI path: {missing}")
    for a, b in zip(main.iterations, jacobi.iterations):
        print(f"phase 4: iter {a.iteration}: SCHUR_JACOBI {_iteration_line(a)} | JACOBI "
              f"{_iteration_line(b)}", flush=True)

    # the mixed-precision main run: B4's bfloat16 instantiation is its PCG,
    # and each Schur prepare makes the bfloat16 copy with one leaf_to_bf16
    mixed, mixed_launches = run_main_path(
        bal, "SCHUR_JACOBI", fused_execution_chunk_iters=1, use_mixed_precision_solves=True
    )
    # a graph's first call runs its function once (the warm-up) and captures it
    prepares = (mixed.execution_summary.calls("CUDAGraph::Replay prepare")
                + mixed.execution_summary.calls("CUDAGraph::Capture prepare"))
    print(f"phase 4: mixed run: leaf_to_bf16 {mixed_launches['leaf_to_bf16']} launches, "
          f"prepare graph {prepares} runs", flush=True)
    if mixed_launches["leaf_to_bf16"] != prepares or prepares <= 0:
        raise AssertionError("the mixed run did not copy once per Schur prepare")
    if not mixed.used_fused_execution:
        raise AssertionError("the mixed run did not take the fused loop")
    for a, b in zip(main.iterations, mixed.iterations):
        print(f"phase 4: iter {a.iteration}: float32 {_iteration_line(a)} | mixed "
              f"{_iteration_line(b)}", flush=True)
    gap = abs(mixed.final_cost - main.final_cost) / abs(main.final_cost)
    print(f"phase 4: mixed vs float32 final cost rel gap {gap:.3e}", flush=True)
    if not (mixed_launches["schur_sy_bf16"] > 0 and mixed_launches["schur_sy"] == 0):
        raise AssertionError("the mixed PCG did not run B4's bfloat16 instantiation alone")
    missing = [k for k, v in mixed_launches.items()
               if v <= 0 and k not in {"schur_sy", "gather_contract_bf16", "contract_reduce_bf16"}
               | QUAT_NAMES | GENERIC_NAMES | MASKED_NAMES | BATCHED_NAMES]
    if missing:
        raise AssertionError(f"kernels not launched by the mixed path: {missing}")
    # the composed path: a second residual group; B2 and B3 in bfloat16
    composed, composed_launches = run_main_path(
        bal, "SCHUR_JACOBI", build=build_prior_problem, label="camera prior",
        fused_execution_chunk_iters=1,
        use_mixed_precision_solves=True, max_num_iterations=3,
    )
    for it in composed.iterations:
        print(f"phase 4: camera prior, mixed: iter {it.iteration}: {_iteration_line(it)}",
              flush=True)
    if not (composed_launches["gather_contract_bf16"] > 0
            and composed_launches["contract_reduce_bf16"] > 0):
        raise AssertionError("the composed path did not run B2's and B3's bfloat16 instantiations")
    if composed_launches["schur_sy"] or composed_launches["schur_sy_bf16"]:
        raise AssertionError("the composed path launched B4")
    for label, run in (("float32 main", main), ("mixed", mixed), ("camera prior, mixed", composed)):
        steps = tuple(it.linear_solver_iterations for it in run.iterations[1:])
        print(f"phase 4: {label} run: PCG steps {steps}, final cost {run.final_cost!r}", flush=True)
    quat_launches = phase_quaternion_runs(bal, main)
    phase_cluster_runs(bal, main)
    phase_ordering_run(bal, main)
    phase_dogleg_runs(bal, main)
    phase_line_search_run(bal, main)
    phase_inner_iteration_run(bal, main)
    phase_numeric_ba_run(bal)
    sharded_launches = phase_sharded_runs(bal, main)
    # Fields-of-Experts denoising, B1 generic on every group
    del bal
    denoising = [run_denoising(*run) for run in FOE_RUNS]
    analytic_launches = phase_analytic_denoising_run(denoising[0])
    # the host solvers: SPARSE_SCHUR, the pose graphs
    phase_sparse_schur_run()
    phase_pose_graph_runs(tmp.name)
    tmp.cleanup()
    # the slice's own path: covariance at Dubrovnik-356's shape, multistart
    # TinySolver
    cov_launches = phase_covariance_run()
    phase_tiny_multistart()
    # this slice's runs: the native BAL loader, the C API
    tmp = tempfile.TemporaryDirectory()
    phase_native_loader_run(tmp.name)
    phase_c_api_run(tmp.name)
    tmp.cleanup()
    launches.update({k: denoising[0][1][k] for k in ("eval_generic",)})
    launches.update({k: analytic_launches[k] for k in ("eval_generic_analytic",)})
    # each kernel's launches on the run that is its main path
    launches.update(quat_launches)
    launches.update({k: mixed_launches[k] for k in ("schur_sy_bf16", "leaf_to_bf16")})
    launches.update({k: composed_launches[k] for k in ("gather_contract_bf16", "contract_reduce_bf16")})
    launches.update({name: cov_launches.get(name, 0) for name, *_ in BATCHED_KERNELS})
    launches["eval_snavely_masked"] = sharded_launches["eval_snavely_masked"]

    kernels = []
    for name, src, replaces, _tol in (KERNELS + QUAT_KERNELS + GENERIC_KERNELS + BATCHED_KERNELS
                                      + MASKED_KERNELS + QUAT_SY_KERNELS):
        res = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": res["err"][0], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.time() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
