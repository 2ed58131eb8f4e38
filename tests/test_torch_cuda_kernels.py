"""Kernels B1-B5 on the card against their plain PyTorch versions.

These tests need an NVIDIA GPU (CUDA kernels have no CPU mode) and skip
without one. The file imports no JAX, so it also runs on a machine that has
only PyTorch: `python -m pytest --noconftest tests/test_torch_cuda_kernels.py`
(tests/conftest.py configures JAX). Tolerances are relative to the plain
version's largest magnitude: float32 2e-4 for B1 (the dual-number chain
rounds differently from torch.func), 1e-5 for B2 (a 9-term dot product),
1e-4 for B3/B4/B5 (sums over thousands of observations in another order);
float64 1e-11. B3, B4's slot pass and B5 read camera-ordered twins of the
leaves; their tests use ragged camera runs (1, 31, 32, 33 and thousands of
observations, one camera with none) and check that two runs are bitwise
equal. `synthetic_sy_case` also serves the CPU tests of B4's plain passes
(tests/test_torch_schur.py)."""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch import cuda_lib, eval_kernel
from ceres_tpu_torch.evaluator import Evaluator, state_tables
from ceres_tpu_torch.gather_reduce import (
    contract_reduce,
    contract_reduce_plain,
    gather_contract,
    gather_contract_plain,
)
from ceres_tpu_torch.linalg import schur as tschur
from ceres_tpu_torch.linalg.schur_kernels import (
    p0_apply,
    p0_apply_plain,
    sy_apply,
    sy_apply_plain,
    sy_fold_pass,
    sy_fold_plain,
    sy_meta,
    sy_point_pass,
    sy_point_plain,
    sy_tables,
)
from ceres_tpu_torch.jacobian import make_twin
from ceres_tpu_torch.program import camera_layout

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _ba(card, dtype, num_points=8000, seed=1):
    bal = ct.synthetic_bal(32, num_points, 40_000, seed=seed)
    program = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0].compile(card)
    return program, Evaluator(program, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_kernel_matches_plain(card, dtype):
    program, ev = _ba(card, dtype)
    st = state_tables(program, program.state_vector(dtype))
    g = ev.arrays["groups"][0]
    cam, pt = (pm.a_cls for pm in program.groups[0].positions)
    tol = 2e-4 if dtype == torch.float32 else 1e-11
    for with_jac in (True, False):
        args = (st[cam], g["a_rows"][0], st[pt], g["a_rows"][1], g["data"][0],
                ct.HuberLoss(1.0), with_jac)
        k = eval_kernel.snavely_evaluate(*args)
        p = eval_kernel.snavely_evaluate_plain(*args)
        for a, b in [(k[0].reshape(1), p[0].reshape(1)), (k[1], p[1])] + list(zip(k[2], p[2])):
            _close(a, b, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("loss", [ct.HuberLoss(1.0), ct.TrivialLoss(), None],
                         ids=["huber", "trivial", "none"])
def test_eval_kernel_branches(card, dtype, loss):
    """Both branches of the rotation (angle-axis 0 and |a|² < 1e-24: the
    small-angle linearization; the rest: Rodrigues), observations far off
    (Huber outliers) and near (inliers), with and without the Jacobian."""
    rng = np.random.default_rng(7)
    ncam, npts, n = 30, 200, 6000
    cams = rng.normal(size=(ncam, 9)) * [0.3, 0.3, 0.3, 1, 1, 1, 1, 0.1, 0.01]
    cams[:, 5] -= 6.0
    cams[:, 6] = 1.0 + 0.2 * rng.random(ncam)
    cams[:10, :3] = 0.0
    cams[10:20, :3] = rng.normal(size=(10, 3)) * 1e-13
    pts = rng.normal(size=(npts, 3))
    rows0 = rng.integers(0, ncam, n).astype(np.int32)
    rows1 = rng.integers(0, npts, n).astype(np.int32)
    obs = rng.normal(size=(n, 2)) * np.where(rng.random((n, 1)) < 0.3, 3.0, 0.05)
    tol = 2e-4 if dtype == torch.float32 else 1e-11
    for with_jac in (True, False):
        args = (torch.tensor(cams, dtype=dtype, device=card), torch.tensor(rows0, device=card),
                torch.tensor(pts, dtype=dtype, device=card), torch.tensor(rows1, device=card),
                torch.tensor(obs, dtype=dtype, device=card), loss, with_jac)
        k = eval_kernel.snavely_evaluate(*args)
        p = eval_kernel.snavely_evaluate_plain(*args)
        for a, b in [(k[0].reshape(1), p[0].reshape(1)), (k[1], p[1])] + list(zip(k[2], p[2])):
            _close(a, b, tol)
        if with_jac:  # both rotation branches reach the camera Jacobian
            _close(k[2][0][:, rows0 < 20], p[2][0][:, rows0 < 20], tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_reduce_kernels_match_plain(card, dtype):
    rng = np.random.default_rng(4)
    n, ncols = 50_000, 40
    jac = torch.tensor(rng.normal(size=(18, n)), dtype=dtype, device=card)
    rows_np = rng.integers(0, ncols, n).astype(np.int32)
    rows = torch.tensor(rows_np, device=card)
    table = torch.tensor(rng.normal(size=(9, ncols)), dtype=dtype, device=card)
    table[:, -1] = 0
    u = torch.tensor(rng.normal(size=(2, n)), dtype=dtype, device=card)
    layout = camera_layout(rows_np, ncols).to(card)
    f32 = dtype == torch.float32
    _close(gather_contract(jac, rows, table, 2), gather_contract_plain(jac, rows, table, 2),
           1e-5 if f32 else 1e-11)
    twin = make_twin(jac, layout)
    out = contract_reduce(twin, layout, u, 2)
    _close(out, contract_reduce_plain(twin, layout, u, 2), 1e-4 if f32 else 1e-11)
    assert torch.equal(out, contract_reduce(twin, layout, u, 2))  # deterministic
    twin9 = make_twin(jac[:9].contiguous(), layout)
    _close(contract_reduce(twin9, layout, None, 1),
           contract_reduce_plain(twin9, layout, None, 1), 1e-4 if f32 else 1e-11)


# observations per camera: runs around the 32-slot padding and the
# 2048-slot chunk, one camera with none (column 4), the dump column last
RAGGED = (1, 31, 32, 33, 0, 2047, 2048, 2049, 7000, 40)


def _ragged_layout(card, seed):
    rows = np.repeat(np.arange(len(RAGGED)), RAGGED).astype(np.int32)
    rows = np.random.default_rng(seed).permutation(rows)
    return rows, camera_layout(rows, len(RAGGED)).to(card)


def synthetic_sy_case(r, te, tf, dtype, device, seed=0):
    """Inputs of B4 (sy_apply) for any block sizes: the RAGGED camera runs
    (the last one the dump column) and points on a bucket layout of ragged
    degrees (1 to 40) and bucket lengths, three points without observations
    at the end. Returns (meta, F, E, rows_f, F_twin, E_twin, prow, layout,
    y, minv, dsq): leaves, twins, slot point rows, the [te², cnt_e] inverse
    table (symmetric blocks), a camera table y with the dump column 0 and
    an LM diagonal dsq, both [tf, ncols]."""
    rng = np.random.default_rng(seed)
    rows_np, layout = _ragged_layout(device, seed)
    n, ncols = rows_np.size, len(RAGGED)
    buckets, lane, point = [], 0, 0
    while lane < n:
        d = min(int(rng.choice([1, 2, 3, 5, 7, 40])), n - lane)
        n_seg = max(1, min(int(rng.integers(1, 60)), (n - lane) // d))
        buckets.append((lane, n_seg, d, point))
        lane, point = lane + n_seg * d, point + n_seg
    cnt_e = point + 3
    point_of_lane = np.concatenate([
        out_row + np.tile(np.arange(n_seg), d) for _ls, n_seg, d, out_row in buckets
    ]).astype(np.int32)
    meta = {
        "r": r, "te": te, "tf": tf, "cnt_f": ncols - 1, "buckets": tuple(buckets),
        "segs": np.asarray(buckets, dtype=np.int32).reshape(-1),
        "pt_start": np.concatenate([[0], np.cumsum([b[1] for b in buckets])]).astype(np.int32),
    }

    def tensor(a):
        return torch.tensor(a, dtype=dtype, device=device)

    F, E = tensor(rng.normal(size=(r * tf, n))), tensor(rng.normal(size=(r * te, n)))
    perm = layout.perm.cpu().numpy()
    prow = torch.tensor(np.where(perm >= 0, point_of_lane[np.maximum(perm, 0)], -1),
                        dtype=torch.int32, device=device)
    a = rng.normal(size=(cnt_e, te, te))
    minv = tensor((a @ a.transpose(0, 2, 1)).reshape(cnt_e, te * te).T.copy())
    y, dsq = tensor(rng.normal(size=(tf, ncols))), tensor(rng.uniform(0.5, 2.0, (tf, ncols)))
    y[:, -1] = 0
    return (meta, F, E, torch.tensor(rows_np, device=device), make_twin(F, layout),
            make_twin(E, layout), prow, layout, y, minv, dsq)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,r,with_u", [(9, 2, True), (6, 2, True), (16, 1, True), (81, 1, False)])
def test_contract_reduce_ragged_runs(card, dtype, t, r, with_u):
    rows, layout = _ragged_layout(card, t)
    rng = np.random.default_rng(t + r)
    n = rows.size
    twin = make_twin(torch.tensor(rng.normal(size=(r * t, n)), dtype=dtype, device=card), layout)
    u = torch.tensor(rng.normal(size=(r, n)), dtype=dtype, device=card) if with_u else None
    out = contract_reduce(twin, layout, u, r)
    assert torch.equal(out, contract_reduce(twin, layout, u, r))
    assert torch.all(out[:, 4] == 0)
    _close(out, contract_reduce_plain(twin, layout, u, r),
           1e-4 if dtype == torch.float32 else 1e-11)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tf,te", [(6, 3), (9, 3), (16, 3), (9, 8), (16, 8)])
def test_schur_p0_ragged_runs(card, dtype, tf, te):
    rows, layout = _ragged_layout(card, tf * 10 + te)
    rng = np.random.default_rng(tf + te)
    n, cnt_f, cnt_e, r = rows.size, len(RAGGED) - 1, 300, 2
    rows_e = torch.tensor(rng.integers(-1, cnt_e + 1, n), dtype=torch.int32, device=card)
    prow = torch.where(layout.perm >= 0, rows_e[layout.perm.clamp(min=0).long()], -1)
    prow = prow.to(torch.int32).contiguous()

    def leaf(k):
        return torch.tensor(rng.normal(size=(k, n)), dtype=dtype, device=card)

    F_twin, E_twin = make_twin(leaf(r * tf), layout), make_twin(leaf(r * te), layout)
    a = torch.tensor(rng.normal(size=(cnt_e, te, te)), dtype=dtype, device=card)
    minv = (a @ a.transpose(1, 2)).reshape(cnt_e, te * te)  # symmetric blocks, point-major
    meta = {"r": r, "te": te, "tf": tf, "cnt_f": cnt_f}
    out = p0_apply(meta, F_twin, E_twin, prow, layout, minv)
    assert tuple(out.shape) == (tf * tf, cnt_f)
    assert torch.equal(out, p0_apply(meta, F_twin, E_twin, prow, layout, minv))
    assert torch.all(out[:, 4] == 0)
    _close(out, p0_apply_plain(meta, F_twin, E_twin, prow, layout, minv),
           1e-4 if dtype == torch.float32 else 1e-11)


@pytest.mark.parametrize("dtype", DTYPES)
def test_schur_sy_kernel_matches_plain(card, dtype):
    program, ev = _ba(card, dtype)
    _c, _r, jac, _g = ev.evaluate_groups(program.state_vector(dtype))
    meta = sy_meta(program)
    assert meta is not None
    jac_e, _ = tschur.schur_views(program, jac)
    e_mask = torch.as_tensor(program.schur_tangent_masks()[0], dtype=dtype, device=card)
    ete = tschur.ete_solver_from_gram(program, tschur.ete_gram_tables(program, jac_e), e_mask)
    g = ev.arrays["groups"][0]
    F, E = jac.jac_groups[0][meta["f_pos"]], jac.jac_groups[0][meta["e_pos"]]
    rows_f, layout_f = g["t_rows"][meta["f_pos"]], g["csr"][meta["f_pos"]]
    F_twin = jac.twin(0, meta["f_pos"])
    E_twin = jac.twin(0, meta["e_pos"], meta["f_pos"])
    prow = program.slot_rows(0, meta["e_pos"], meta["f_pos"], card)
    y = torch.randn((9, layout_f.offsets.shape[0] - 1), dtype=dtype, device=card)
    y[:, -1] = 0
    minv = ete.inv_tables[meta["e_cls"]]
    args = (meta, F, E, rows_f, F_twin, E_twin, prow, layout_f, y, minv, sy_tables(meta, card))
    out = sy_apply(*args)
    assert torch.equal(out, sy_apply(*args))  # deterministic
    _close(out, sy_apply_plain(meta, F, E, rows_f, F_twin, layout_f, y, minv),
           1e-4 if dtype == torch.float32 else 1e-11)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,te,tf", [(2, 3, 9), (1, 1, 1), (2, 8, 16), (4, 3, 8), (3, 5, 6)])
def test_schur_sy_passes_ragged_runs(card, dtype, r, te, tf):
    """Each launch of B4 against its plain version, and the whole S·y with
    the LM diagonal folded in, on ragged camera runs and point degrees."""
    (meta, F, E, rows_f, F_twin, E_twin, prow, layout, y, minv,
     dsq) = synthetic_sy_case(r, te, tf, dtype, card, seed=r * 100 + te * 10 + tf)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    segs = sy_tables(meta, card)
    t2 = sy_point_pass(meta, F, E, rows_f, y, minv, segs)
    npts = int(meta["pt_start"][-1])  # the points with observations
    assert t2.shape[1] % 4 == 0 and torch.all(t2[:npts, te:] == 0)
    _close(t2[:npts, :te], sy_point_plain(meta, F, E, rows_f, y, minv)[:npts], tol)
    # y's and dsq's dump columns nonzero: the fold leaves that column 0
    y_dump = y.clone()
    y_dump[:, -1] = 1.5
    fold = sy_fold_pass(meta, F_twin, E_twin, prow, layout, y_dump, t2, dsq)
    assert torch.all(fold[:, -1] == 0)
    _close(fold, sy_fold_plain(meta, F_twin, E_twin, prow, layout, y_dump, t2, dsq), tol)
    args = (meta, F, E, rows_f, F_twin, E_twin, prow, layout, y, minv, segs, dsq)
    launched = cuda_lib.launch_counts()["schur_sy"]
    out = sy_apply(*args)
    assert cuda_lib.launch_counts()["schur_sy"] == launched + 1  # one count per S·y
    assert torch.equal(out, sy_apply(*args))
    _close(out, sy_apply_plain(meta, F, E, rows_f, F_twin, layout, y, minv, dsq), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("table", ["ridge", "damped"])
def test_schur_p0_kernel_matches_plain(card, dtype, table):
    # ridge: schur_prepare's (EᵀE + 100·eps·colnorm2)⁻¹, on a problem whose
    # points are all seen by two cameras or more; damped: (EᵀE + I)⁻¹ on one
    # with points seen by one camera only, where the ridge inverse would
    # amplify rounding (tests/test_torch_schur_jacobi.py, LONE_TOL)
    program, ev = _ba(card, dtype, *((4000, 2) if table == "ridge" else ()))
    _c, _r, jac, _g = ev.evaluate_groups(program.state_vector(dtype))
    meta = sy_meta(program)
    assert meta is not None
    jac_e, _ = tschur.schur_views(program, jac)
    e_gram = tschur.ete_gram_tables(program, jac_e)
    if table == "ridge":
        ete = tschur.ridge_ete_solver(program, e_gram, jac.squared_column_norms())
    else:
        e_mask = torch.as_tensor(program.schur_tangent_masks()[0], dtype=dtype, device=card)
        ete = tschur.ete_solver_from_gram(program, e_gram, e_mask)
    f_pos, e_pos = meta["f_pos"], meta["e_pos"]
    args = (meta, jac.twin(0, f_pos), jac.twin(0, e_pos, f_pos),
            program.slot_rows(0, e_pos, f_pos, card),
            ev.arrays["groups"][0]["csr"][f_pos],
            ete.inv_records(meta["e_cls"]))
    out = p0_apply(*args)
    assert tuple(out.shape) == (81, meta["cnt_f"])
    _close(out, p0_apply_plain(*args), 1e-4 if dtype == torch.float32 else 1e-11)
    assert torch.equal(out, p0_apply(*args))


@pytest.mark.parametrize(
    "precond,num_points",
    # SCHUR_JACOBI launches B5 too; its problem has no point seen by one
    # camera only (the ridge inverse of its cached blocks would amplify
    # rounding there, tests/test_torch_schur_jacobi.py LONE_TOL)
    [("JACOBI", 8000), ("SCHUR_JACOBI", 4000)],
)
def test_cuda_solve_matches_cpu_and_launches_every_kernel(card, precond, num_points):
    bal = ct.synthetic_bal(32, num_points, 40_000, seed=2)
    sums = {}
    for dev in ("cpu", "cuda"):
        problem = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]
        cuda_lib.reset_launch_counts()
        sums[dev] = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=getattr(ct.PreconditionerType, precond),
            max_num_iterations=3, max_linear_solver_iterations=25,
            function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
            device=dev, dtype=torch.float64), problem)
    unused = {"schur_p0"} if precond == "JACOBI" else set()
    assert all(v > 0 for k, v in cuda_lib.launch_counts().items() if k not in unused)
    for a, b in zip(sums["cuda"].iterations, sums["cpu"].iterations, strict=True):
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
        assert a.linear_solver_iterations == b.linear_solver_iterations
