#!/usr/bin/env python3
"""Drive the PyTorch port's bundle-adjustment solve on one CUDA card.

    python3 chip_smoke.py            # one NVIDIA H100 (sm_90a), nvcc on the path
    python3 chip_smoke.py --phase 2  # phases 1 and 2 only, no result line

Phases, one line each (a failed phase raises, so the script exits non-zero
and prints no result):
  1. the device, its name and power limit, and the build of the CUDA
     kernels (ceres_tpu_torch/csrc, compiled here with nvcc);
  2. each kernel B1-B5 against its plain PyTorch version on the card, at
     BAL-1778 shapes in float32: max relative error vs a stated tolerance,
     the median time of each over 10 runs (CUDA events), its bound (the
     least time for its bytes and operations at the data sheet's rates)
     and, for B2 and B3, the time of one PyTorch sparse product for the same
     function; B1's residual-only launch beside the one with the Jacobian;
     B4 (S·y) whole and each of its two launches, also with D_f² y folded
     in; B3, B4 and B5 bitwise equal across two runs; the time to build the
     camera-ordered twins of one new Jacobian (B3's, B4's and B5's inputs);
     then schur_prepare's time per new Jacobian for JACOBI and SCHUR_JACOBI;
  3. a small float64 solve (48,000 observations, so the layout plans
     engage) for 5 LM iterations on the card and on the CPU, for JACOBI,
     SCHUR_JACOBI, and SCHUR_JACOBI with the power-series warm start (which
     only schur_solve runs): per-iteration cost within 1e-9 relative and
     equal PCG counts, and each case's kernels launched;
  4. the main run: synthetic_bal(1778, 993923, 5,000,000) with Huber(1.0)
     in float32 through ceres_tpu_torch.solve (LM + ITERATIVE_SCHUR +
     SCHUR_JACOBI, eta 0.1, PCG <= 25, 5 iterations, the JAX package's
     benchmarked configuration): every value finite, cost decreasing, and
     each kernel B1-B5 launched by the run. Then the same solve with JACOBI
     on another new Problem (B1-B4), its PCG counts and iteration ms beside
     the main run's.
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
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# BAL-1778 at full size (problem-1778-993923-pnp.txt of the BAL dataset's
# Final set): no cut
NUM_POINTS = 993_923
NUM_OBSERVATIONS = 5_000_000
# NVIDIA's H100 SXM data sheet: device memory rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# B1's float operations per observation, counted from csrc/eval_snavely.cu
# (the large-angle path, an FMA as 2, a sqrt, sincos or quotient as 1): the
# residual chain ~90, R ~45, dR/d(angle-axis) ~180, the projection block and
# the two 2 x 3 by 3 x 3 products ~100, the Huber/Triggs scaling of the 26
# outputs ~150
B1_OPS_PER_OBS = 540
# the residual-only instantiation: the residual chain, Huber, Triggs scale
B1_RES_OPS_PER_OBS = 110
# (name, source, TPU kernel it replaces, tolerance on max|k - p| / max|p|)
KERNELS = [
    ("eval_snavely", "ceres_tpu_torch/csrc/eval_snavely.cu",
     "ceres_tpu/pallas_eval.py:435", 2e-4),
    ("gather_contract", "ceres_tpu_torch/csrc/gather_reduce.cu",
     "ceres_tpu/pallas_onehot.py:111", 1e-5),
    ("contract_reduce", "ceres_tpu_torch/csrc/gather_reduce.cu",
     "ceres_tpu/pallas_onehot.py:142", 1e-4),
    ("schur_sy", "ceres_tpu_torch/csrc/schur_sy.cu",
     "ceres_tpu/linalg/pallas_schur.py:262", 1e-4),
    ("schur_p0", "ceres_tpu_torch/csrc/schur_p0.cu",
     "ceres_tpu/linalg/pallas_schur.py:442", 1e-4),
]
# B1's float32 tolerance covers the dual-number chain (rotation, projection,
# distortion, Huber, Triggs correction) rounded differently from
# torch.func's; B2 is a 9-term dot product; B3/B4/B5 sum ~2,800 observations
# per camera in another order than index_add_.
# Phase 3's SCHUR_JACOBI problems have no point seen by one camera only.
# Such a point's EᵀE is singular, and SCHUR_JACOBI's cached correction
# (whose inverse carries only a 100·eps ridge) amplifies rounding there:
# the JAX package itself, fed the same problem with its observations in
# another order, moves its blocks by ~7e-5 and its step by ~2e-6
# (tests/test_torch_schur_jacobi.py::test_lone_points_reference_against_itself),
# far above phase 3's 1e-9. JACOBI keeps the problem with such points.
PARITY_CASES = (
    # (name, preconditioner, extra options, synthetic_bal sizes)
    ("JACOBI", "JACOBI", {}, (96, 10_000, 48_000)),
    ("SCHUR_JACOBI", "SCHUR_JACOBI", {}, (96, 4000, 48_000)),
    ("SCHUR_JACOBI+spse_init", "SCHUR_JACOBI", {"use_spse_initialization": True},
     (96, 4000, 48_000)),
)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """`name<f32,args...>` of a template kernel from its mangled name: the
    length-prefixed identifier ending in _kernel, then its template
    arguments (the value type, then integers and booleans)."""
    for m in re.finditer(r"_kernelI([fd])((?:L[ib]\d+E)*)", mangled):
        end = m.start() + len("_kernel")
        for size in range(len("_kernel"), end):
            if mangled[:end - size].endswith(str(size)):
                args = "".join(f",{a}" for a in re.findall(r"L[ib](\d+)E", m.group(2)))
                return f"{mangled[end - size:end]}<{'f32' if m.group(1) == 'f' else 'f64'}{args}>"
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


def bound(nbytes, ops) -> tuple[float, str]:
    """(least ms on the card, what bounds it): the bytes the function must
    move over the memory rate, or its float32 operations over the float32
    rate, whichever is larger."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_b2(jac, rows, table, r):
    """F·y as one PyTorch call: an int32-indexed CSR of F [r*n, t*ncols]
    (built here, outside the timed call) times the table; the port never
    calls it."""
    import torch

    rt, n = jac.shape
    t, ncols = rt // r, table.shape[1]
    dev = jac.device
    crow = torch.arange(0, r * n * t + 1, t, dtype=torch.int32, device=dev)
    col = rows.long()[None, :, None] * t + torch.arange(t, device=dev)[None, None, :]
    col = col.expand(r, n, t).reshape(-1).int()
    val = jac.reshape(r, t, n).permute(0, 2, 1).reshape(-1)
    a = torch.sparse_csr_tensor(crow, col, val, (r * n, t * ncols))
    x = table.T.contiguous().reshape(-1)
    return lambda: (a @ x).reshape(r, n)


def library_b3(jac, rows, u, ncols, r):
    """Fᵀu as one PyTorch call (cuSPARSE SpMV): an int32-indexed CSR of Fᵀ
    [t*ncols, r*n] (row j*ncols + c) (built here, outside the timed call) times u; the port
    never calls it."""
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
    except (RuntimeError, NotImplementedError) as exc:
        results[name]["library_ms"] = None
        print(f"phase 2: {name}: library call not timed: {exc}", flush=True)
    torch.cuda.empty_cache()


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
        t_k, t_p = median_ms(fn), median_ms(plain)
        b_ms, b_by = bound(nbytes, ops)
        results[name] = {"err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None}

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
    del ete, minv, t2, dsq

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
    for name, _src, _rep, tol in KERNELS:
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
    print("phase 2: contract_reduce, schur_sy and schur_p0 bitwise equal across two runs",
          flush=True)
    phase_prepare(program, jac)


def phase_prepare(program, jac):
    """Phase 2, last line: schur_prepare's device time per new Jacobian
    (the Jacobi-scaled Jacobian, as the solve hands it over) for each
    preconditioner."""
    import torch

    from ceres_tpu_torch.linalg.schur import schur_prepare

    jac_s = jac.scale_columns(1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
    times = {}
    for name in ("JACOBI", "SCHUR_JACOBI"):
        options = lm_options("cuda", torch.float32, preconditioner_type=name)
        times[name] = median_ms(lambda: schur_prepare(program, options, jac_s), reps=5)
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
    from ceres_tpu_torch import cuda_lib

    for name, precond, extra, sizes in PARITY_CASES:
        bal = ct.synthetic_bal(*sizes, seed=1)
        sums = {}
        for dev in ("cuda", "cpu"):
            problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
            cuda_lib.reset_launch_counts()
            sums[dev] = ct.solve(lm_options(dev, torch.float64, precond, **extra), problem)
            if dev == "cuda":
                launches = cuda_lib.launch_counts()
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
            f"{worst:.3e} (tol 1e-9), pcg {[it.linear_solver_iterations for it in sums['cuda'].iterations]}, "
            f"final cost {sums['cuda'].final_cost:.12e}, launches {json.dumps(launches)}",
            flush=True,
        )
        if not worst <= 1e-9:
            raise AssertionError(f"{name}: float64 CUDA solve disagrees with the CPU solve")
        missing = [k for k, v in launches.items() if v <= 0 and (k, precond) != ("schur_p0", "JACOBI")]
        if missing:
            raise AssertionError(f"{name}: the CUDA solve did not launch {missing}")


def run_main_path(bal, precond):
    """One full-size float32 solve on a new Problem, so that its preprocess
    and first iteration pay every one-time cost a user's solve pays; the
    launch counts are set to 0 just before it and read just after."""
    import torch

    import ceres_tpu_torch as ct
    from ceres_tpu_torch import cuda_lib

    torch.cuda.empty_cache()
    t0 = time.time()
    problem, _, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    t_problem = time.time() - t0
    cuda_lib.reset_launch_counts()
    t0 = time.time()
    summary = ct.solve(lm_options("cuda", torch.float32, precond), problem)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.launch_counts()
    finite = all(math.isfinite(it.cost) for it in summary.iterations) and bool(
        np.isfinite(problem.compile().state0).all()
    )
    print(
        f"phase 4: {precond}: Problem built in {t_problem:.1f} s; solve {wall:.1f} s "
        f"(preprocess {summary.preprocessor_time_in_seconds:.1f} s: Program, Schur ordering, "
        f"uploads), initial cost {summary.initial_cost!r}, final cost {summary.final_cost!r}, "
        f"{summary.termination_type.value}, launches {json.dumps(launches)}",
        flush=True,
    )
    if not finite:
        raise AssertionError(f"{precond}: non-finite cost or state")
    if not summary.final_cost < summary.initial_cost:
        raise AssertionError(f"{precond}: the solve did not decrease the cost")
    return summary, launches


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
    results = {}
    phase_kernels(program, dev, results)
    del problem, program
    torch.cuda.empty_cache()
    if args.phase == 2:
        print(f"phase 2 only: {time.time() - t_start:.1f} s; no result", flush=True)
        return 0

    phase_f64_parity()

    # phase 4: the main run (SCHUR_JACOBI, kernels B1-B5), then JACOBI (B1-B4)
    main, launches = run_main_path(bal, "SCHUR_JACOBI")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    jacobi, jacobi_launches = run_main_path(bal, "JACOBI")
    missing = [k for k, v in jacobi_launches.items() if v <= 0 and k != "schur_p0"]
    if missing:
        raise AssertionError(f"kernels not launched by the JACOBI path: {missing}")
    for a, b in zip(main.iterations, jacobi.iterations):
        print(
            f"phase 4: iter {a.iteration}: SCHUR_JACOBI cost {a.cost!r} pcg "
            f"{a.linear_solver_iterations} ms {1000.0 * a.iteration_time_in_seconds:.1f} "
            f"{'accepted' if a.step_is_successful else 'rejected'} | JACOBI cost {b.cost!r} pcg "
            f"{b.linear_solver_iterations} ms {1000.0 * b.iteration_time_in_seconds:.1f} "
            f"{'accepted' if b.step_is_successful else 'rejected'}",
            flush=True,
        )

    kernels = []
    for name, src, replaces, _tol in KERNELS:
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
            "count": 1,  # every phase drives one card
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
