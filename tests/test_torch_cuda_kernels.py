"""Kernels B1-B5 on the card against their plain PyTorch versions; B1 on
both camera models (angle-axis, quaternion with and without its manifold)
under each of its loss codes, and B1's generic instantiation (a generated
functor, functor_codegen.py) on the Fields-of-Experts, Powell,
curve-fitting and Snavely groups, under traced losses and a manifold.

These tests need an NVIDIA GPU (CUDA kernels have no CPU mode) and skip
without one. The file imports no JAX, so it also runs on a machine that has
only PyTorch: `python -m pytest --noconftest tests/test_torch_cuda_kernels.py`
(tests/conftest.py configures JAX). Tolerances are relative to the plain
version's largest magnitude: float32 2e-4 for B1 (the dual-number chain
rounds differently from torch.func), 1e-5 for B2 (a 9-term dot product),
1e-4 for B3/B4/B5 (sums over thousands of observations in another order);
float64 1e-11. B2, B3 and B4 also run on bfloat16 leaves (float32 vectors
and outputs): B2 and B3 round only their given table or u, so they keep
float32's tolerances; B4 rounds t1, t2 and diff, which the kernel and the
plain version sum in other orders, so one of them can land on the other
side of a bfloat16 rounding boundary (one term off by 2^-8 of itself):
1e-3. The batched B2 and B3 (k columns, the covariance's PCG) are held to
their plain versions at the single-vector tolerances and must be bitwise
equal, column by column, to k single-vector launches and from run to run,
on lane-major operands (the column axis innermost). B3, B4's slot pass
and B5 read camera-ordered twins of the
leaves; their tests use ragged camera runs (1, 31, 32, 33 and thousands of
observations, one camera with none) and check that two runs are bitwise
equal. `synthetic_sy_case` also serves the CPU tests of B4's plain passes
(tests/test_torch_schur.py)."""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch import cuda_lib, eval_kernel, functor_codegen
from ceres_tpu_torch.evaluator import Evaluator, group_eval_plain, state_tables
from ceres_tpu_torch.gather_reduce import (
    contract_reduce,
    contract_reduce_batched,
    contract_reduce_batched_plain,
    contract_reduce_plain,
    gather_contract,
    gather_contract_batched,
    gather_contract_batched_plain,
    gather_contract_plain,
    lanes_major,
    SHARED_TABLE_MAX_BYTES,
    table_fits,
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
from ceres_tpu_torch.utils import execution_summary as es

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.float64]
BF16 = torch.bfloat16
# B4's (r, te, tf): the BA shape (the library's kernels) and shapes built
# from their own sources (tangent 10: quaternion cameras without a
# manifold; 6-DoF cameras; stereo observations; homogeneous points)
SY_SHAPES = [(2, 3, 9), (1, 1, 1), (2, 8, 16), (4, 3, 8), (3, 5, 6), (2, 3, 10), (2, 3, 6),
             (3, 3, 9), (2, 4, 9)]


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


def _quat_args(card, dtype, loss, with_jac, seed=7, ncam=30, npts=200, n=6000):
    """Inputs of B1's quaternion instantiation: non-unit quaternions (the
    kernel normalizes nothing), the identity and a near-identity one, and
    observations far off (outliers of every robust loss) and near."""
    rng = np.random.default_rng(seed)
    cams = rng.normal(size=(ncam, 10)) * [1, 1, 1, 1, 1, 1, 1, 1, 0.1, 0.01]
    cams[:, :4] *= (0.8 + 0.4 * rng.random(ncam))[:, None] / np.linalg.norm(
        cams[:, :4], axis=1, keepdims=True)
    cams[0, :4] = [1.0, 0.0, 0.0, 0.0]
    cams[1, :4] = [1.0, 1e-13, 0.0, 0.0]
    cams[:, 6] -= 6.0
    cams[:, 7] = 1.0 + 0.2 * rng.random(ncam)
    pts = rng.normal(size=(npts, 3))
    rows0 = rng.integers(0, ncam, n).astype(np.int32)
    rows1 = rng.integers(0, npts, n).astype(np.int32)
    obs = rng.normal(size=(n, 2)) * np.where(rng.random((n, 1)) < 0.3, 3.0, 0.05)
    return (torch.tensor(cams, dtype=dtype, device=card), torch.tensor(rows0, device=card),
            torch.tensor(pts, dtype=dtype, device=card), torch.tensor(rows1, device=card),
            torch.tensor(obs, dtype=dtype, device=card), loss, with_jac)


def _check_b1(k, p, tol, jac_rows):
    for a, b in [(k[0].reshape(1), p[0].reshape(1)), (k[1], p[1])] + list(zip(k[2], p[2])):
        assert a.shape == b.shape
        _close(a, b, tol)
    if k[2]:
        assert k[2][0].shape[0] == jac_rows


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("manifold", [True, False], ids=["manifold", "no_manifold"])
def test_eval_kernel_quat_matches_plain(card, dtype, manifold):
    """B1's quaternion instantiation on the quaternion BA problem: with the
    Jacobian and residual-only, each counted once under its own name."""
    bal = ct.synthetic_bal(32, 8000, 40_000, seed=1)
    program = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), use_quaternions=True,
                                  use_manifolds=manifold)[0].compile(card)
    ev = Evaluator(program, dtype)
    st = state_tables(program, program.state_vector(dtype))
    g = ev.arrays["groups"][0]
    cam, pt = (pm.a_cls for pm in program.groups[0].positions)
    name = "eval_snavely_quat" if manifold else "eval_snavely_quat_nomanifold"
    tol = 2e-4 if dtype == torch.float32 else 1e-11
    for with_jac in (True, False):
        args = (st[cam], g["a_rows"][0], st[pt], g["a_rows"][1], g["data"][0],
                ct.HuberLoss(1.0), with_jac, manifold)
        before = es.counts()
        k = eval_kernel.snavely_quat_evaluate(*args)
        after = es.counts()
        assert {key: after[key] - before[key] for key in cuda_lib.LAUNCHES
                if after[key] != before[key]} == {
            name: 1}
        _check_b1(k, eval_kernel.snavely_quat_evaluate_plain(*args), tol, 18 if manifold else 20)


LOSS_CODES = {
    "none": None, "trivial": ct.TrivialLoss(), "huber": ct.HuberLoss(0.5),
    "soft_l_one": ct.SoftLOneLoss(0.7), "cauchy": ct.CauchyLoss(0.5),
    "arctan": ct.ArctanLoss(2.0), "tolerant": ct.TolerantLoss(1.0, 0.3),
    "tolerant_big": ct.TolerantLoss(0.01, 0.01), "tukey": ct.TukeyLoss(1.0),
    "scaled": ct.ScaledLoss(ct.CauchyLoss(0.5), 2.5), "scaled_none": ct.ScaledLoss(None, 0.25),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("loss", list(LOSS_CODES))
def test_eval_kernel_loss_codes(card, dtype, loss):
    """Each loss code on both camera models (angle-axis; quaternion with and
    without the manifold), both launches, against the plain versions."""
    tol = 2e-4 if dtype == torch.float32 else 1e-11
    for with_jac in (True, False):
        args = _quat_args(card, dtype, LOSS_CODES[loss], with_jac)
        for manifold in (True, False):
            _check_b1(eval_kernel.snavely_quat_evaluate(*args, manifold),
                      eval_kernel.snavely_quat_evaluate_plain(*args, manifold), tol,
                      18 if manifold else 20)
        aa = (args[0][:, 1:4] * 0.3).contiguous()
        cams9 = torch.cat([aa, args[0][:, 4:]], dim=1).contiguous()
        args9 = (cams9,) + args[1:]
        _check_b1(eval_kernel.snavely_evaluate(*args9), eval_kernel.snavely_evaluate_plain(*args9),
                  tol, 18)


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


def test_bf16_gather_reduce_kernels_match_plain(card):
    """B2 and B3 on bfloat16 leaves and twins, float32 table and u."""
    rng = np.random.default_rng(5)
    n, ncols = 50_000, 40
    jac = torch.tensor(rng.normal(size=(18, n)), dtype=BF16, device=card)
    rows_np = rng.integers(0, ncols, n).astype(np.int32)
    rows = torch.tensor(rows_np, device=card)
    table = torch.tensor(rng.normal(size=(9, ncols)), dtype=torch.float32, device=card)
    table[:, -1] = 0
    u = torch.tensor(rng.normal(size=(2, n)), dtype=torch.float32, device=card)
    layout = camera_layout(rows_np, ncols).to(card)
    counts = es.counts()
    out = gather_contract(jac, rows, table, 2)
    assert out.dtype == torch.float32
    _close(out, gather_contract_plain(jac, rows, table, 2), 1e-5)
    twin = make_twin(jac, layout)
    out = contract_reduce(twin, layout, u, 2)
    assert out.dtype == torch.float32
    _close(out, contract_reduce_plain(twin, layout, u, 2), 1e-4)
    after = es.counts()
    assert after["gather_contract_bf16"] == counts["gather_contract_bf16"] + 1
    assert after["contract_reduce_bf16"] == counts["contract_reduce_bf16"] + 1
    assert after["gather_contract"] == counts["gather_contract"]
    assert after["contract_reduce"] == counts["contract_reduce"]
    with pytest.raises(TypeError):  # float32 vectors only
        contract_reduce(twin, layout, u.double(), 2)


@pytest.mark.parametrize("t,r,with_u", [(9, 2, True), (6, 2, True), (16, 1, True), (81, 1, False),
                                        (10, 2, True), (4, 3, True)])
def test_bf16_contract_reduce_ragged_runs(card, t, r, with_u):
    """B3 on bfloat16 twins (8 consecutive slots a thread, 16-byte loads):
    its camera shapes (r = 2, t = 9 or 10) and the any-(r, t) kernel, one
    launch per call, bitwise from run to run."""
    rows, layout = _ragged_layout(card, t)
    rng = np.random.default_rng(t + r)
    n = rows.size
    twin = make_twin(torch.tensor(rng.normal(size=(r * t, n)), dtype=BF16, device=card), layout)
    u = torch.tensor(rng.normal(size=(r, n)), dtype=torch.float32, device=card) if with_u else None
    launched = es.counts()["contract_reduce_bf16"]
    out = contract_reduce(twin, layout, u, r)
    assert es.counts()["contract_reduce_bf16"] == launched + 1
    assert out.dtype == torch.float32
    assert torch.equal(out, contract_reduce(twin, layout, u, r))
    assert torch.all(out[:, 4] == 0)
    _close(out, contract_reduce_plain(twin, layout, u, r), 1e-4)


def _misaligned(x):
    """x's values in a contiguous tensor whose data starts 2 bytes past a
    16-byte boundary (an offset slice of a larger buffer)."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


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
@pytest.mark.parametrize("r,te,tf", SY_SHAPES)
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
    launched = es.counts()["schur_sy"]
    out = sy_apply(*args)
    assert es.counts()["schur_sy"] == launched + 1  # one count per S·y
    assert torch.equal(out, sy_apply(*args))
    _close(out, sy_apply_plain(meta, F, E, rows_f, F_twin, layout, y, minv, dsq), tol)


@pytest.mark.parametrize("r,te,tf", SY_SHAPES)
def test_bf16_schur_sy_passes_ragged_runs(card, r, te, tf):
    """B4 on bfloat16 leaves and twins (float32 y, inverse table, D_f² and
    output): each launch against its plain version, the whole S·y twice
    bitwise, counted as schur_sy_bf16."""
    (meta, F, E, rows_f, _Ft, _Et, prow, layout, y, minv,
     dsq) = synthetic_sy_case(r, te, tf, torch.float32, card, seed=r * 100 + te * 10 + tf)
    F, E = F.to(BF16), E.to(BF16)
    F_twin, E_twin = make_twin(F, layout), make_twin(E, layout)
    segs = sy_tables(meta, card)
    t2 = sy_point_pass(meta, F, E, rows_f, y, minv, segs)
    npts = int(meta["pt_start"][-1])
    assert t2.dtype == torch.float32
    _close(t2[:npts, :te], sy_point_plain(meta, F, E, rows_f, y, minv)[:npts], 1e-3)
    fold = sy_fold_pass(meta, F_twin, E_twin, prow, layout, y, t2, dsq)
    assert fold.dtype == torch.float32 and torch.all(fold[:, -1] == 0)
    _close(fold, sy_fold_plain(meta, F_twin, E_twin, prow, layout, y, t2, dsq), 1e-3)
    assert torch.equal(t2[:npts], sy_point_pass(meta, F, E, rows_f, y, minv, segs)[:npts])
    assert torch.equal(fold, sy_fold_pass(meta, F_twin, E_twin, prow, layout, y, t2, dsq))
    args = (meta, F, E, rows_f, F_twin, E_twin, prow, layout, y, minv, segs, dsq)
    counts = es.counts()
    out = sy_apply(*args)
    after = es.counts()
    assert after["schur_sy_bf16"] == counts["schur_sy_bf16"] + 1
    assert after["schur_sy"] == counts["schur_sy"]
    assert torch.equal(out, sy_apply(*args))
    _close(out, sy_apply_plain(meta, F, E, rows_f, F_twin, layout, y, minv, dsq), 1e-3)


@pytest.mark.parametrize("r,te,tf", SY_SHAPES)
def test_bf16_schur_sy_point_pass_large_table(card, r, te, tf):
    """B4's bfloat16 point pass on a y table that does not fit shared
    memory (the first version's kernel, as at BAL-13682) gives bitwise the
    t2 of the shared-memory kernel on the same columns."""
    (meta, F, E, rows_f, _Ft, _Et, _prow, _layout, y, minv,
     _dsq) = synthetic_sy_case(r, te, tf, torch.float32, card, seed=r * 100 + te * 10 + tf)
    F, E = F.to(BF16), E.to(BF16)
    ncols = y.shape[1]
    wide = SHARED_TABLE_MAX_BYTES // (4 * tf) + 1  # the fewest columns that do not fit
    assert table_fits(tf, ncols) and not table_fits(tf, wide)
    y_wide = torch.randn((tf, wide), dtype=torch.float32, device=card)
    y_wide[:, :ncols - 1] = y[:, :ncols - 1]
    # the dump column is the last one of either table
    rows_wide = torch.where(rows_f == ncols - 1, wide - 1, rows_f).to(torch.int32)
    segs = sy_tables(meta, card)
    t2 = sy_point_pass(meta, F, E, rows_f, y, minv, segs)
    t2_wide = sy_point_pass(meta, F, E, rows_wide, y_wide, minv, segs)
    npts = int(meta["pt_start"][-1])  # the points with observations: the rest is not written
    assert torch.equal(t2[:npts], t2_wide[:npts])
    _close(t2_wide[:npts, :te], sy_point_plain(meta, F, E, rows_wide, y_wide, minv)[:npts], 1e-3)


@pytest.mark.parametrize("kernel", ["contract_reduce", "schur_sy"])
def test_bf16_misaligned_twin_raises(card, kernel):
    """B3's and B4's bfloat16 kernels read 16 bytes of a twin row at once:
    a twin whose data is not 16-byte aligned raises and launches nothing."""
    (meta, F, E, rows_f, _Ft, _Et, prow, layout, y, minv,
     dsq) = synthetic_sy_case(2, 3, 9, torch.float32, card)
    F, E = F.to(BF16), E.to(BF16)
    F_twin, E_twin = make_twin(F, layout), make_twin(E, layout)
    u = torch.randn((2, F.shape[1]), dtype=torch.float32, device=card)
    segs = sy_tables(meta, card)
    name = kernel + "_bf16"
    for bad in range(1 if kernel == "contract_reduce" else 2):
        launched = es.counts()[name]
        with pytest.raises(RuntimeError):
            if kernel == "contract_reduce":
                contract_reduce(_misaligned(F_twin), layout, u, 2)
            else:
                twins = [F_twin, E_twin]
                twins[bad] = _misaligned(twins[bad])
                sy_apply(meta, F, E, rows_f, *twins, prow, layout, y, minv, segs, dsq)
        torch.cuda.synchronize()
        assert es.counts()[name] == launched
    # the aligned twins run
    if kernel == "contract_reduce":
        _close(contract_reduce(F_twin, layout, u, 2), contract_reduce_plain(F_twin, layout, u, 2),
               1e-4)
    else:
        _close(sy_apply(meta, F, E, rows_f, F_twin, E_twin, prow, layout, y, minv, segs, dsq),
               sy_apply_plain(meta, F, E, rows_f, F_twin, layout, y, minv, dsq), 1e-3)


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
    "precond,num_points,fused",
    # SCHUR_JACOBI launches B5 too; its problem has no point seen by one
    # camera only (the ridge inverse of its cached blocks would amplify
    # rounding there, tests/test_torch_schur_jacobi.py LONE_TOL); each on
    # the host loop and on the fused loop
    [("JACOBI", 8000, False), ("SCHUR_JACOBI", 4000, False),
     ("JACOBI", 8000, True), ("SCHUR_JACOBI", 4000, True)],
    ids=["JACOBI-8000", "SCHUR_JACOBI-4000", "JACOBI-8000-fused", "SCHUR_JACOBI-4000-fused"],
)
def test_cuda_solve_matches_cpu_and_launches_every_kernel(card, precond, num_points, fused):
    bal = ct.synthetic_bal(32, num_points, 40_000, seed=2)
    sums = {}
    for dev in ("cpu", "cuda"):
        problem = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0]
        es.reset_counts()
        sums[dev] = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=getattr(ct.PreconditionerType, precond),
            max_num_iterations=3, max_linear_solver_iterations=25,
            function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
            fused_execution=fused, device=dev, dtype=torch.float64), problem)
    # the bfloat16 instantiations run only under mixed-precision solves, B1's
    # quaternion ones only on quaternion cameras, the batched B2/B3 only in
    # the covariance's PCG; the bfloat16 copy of the leaves only under
    # mixed-precision solves
    unused = {k + "_bf16" for k in cuda_lib.BF16_KERNELS} | set(cuda_lib.QUAT_KERNELS)
    unused |= set(cuda_lib.COPY_KERNELS)
    unused |= set(cuda_lib.GENERIC_KERNELS) | set(cuda_lib.BATCHED_KERNELS)
    unused |= set(cuda_lib.MASKED_KERNELS)  # B1's masked launches: sharded solves only
    unused |= {"schur_p0"} if precond == "JACOBI" else set()
    assert all(es.counts()[k] > 0 for k in cuda_lib.LAUNCHES if k not in unused)
    assert all(es.counts()[k] == 0 for k in unused if k.endswith("_bf16"))
    for a, b in zip(sums["cuda"].iterations, sums["cpu"].iterations, strict=True):
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
        assert a.linear_solver_iterations == b.linear_solver_iterations


@pytest.mark.parametrize("manifold", [True, False], ids=["manifold", "no_manifold"])
def test_cuda_quaternion_solve_matches_cpu(card, manifold):
    """The quaternion BA solve (SCHUR_JACOBI, fused loop) on the card against
    the CPU in float64: B1's quaternion instantiation and B2-B5 launched, the
    angle-axis B1 not; at tangent 10 B4 runs the kernels built for its
    shape."""
    bal = ct.synthetic_bal(32, 4000, 40_000, seed=2)
    sums = {}
    for dev in ("cpu", "cuda"):
        problem = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), use_quaternions=True,
                                      use_manifolds=manifold)[0]
        es.reset_counts()
        sums[dev] = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            max_num_iterations=3, max_linear_solver_iterations=25,
            function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
            device=dev, dtype=torch.float64), problem)
    counts = es.counts()
    b1 = "eval_snavely_quat" if manifold else "eval_snavely_quat_nomanifold"
    assert counts["eval_snavely"] == 0 and counts[b1] > 0
    for k in ("gather_contract", "contract_reduce", "schur_sy", "schur_p0"):
        assert counts[k] > 0, k
    for a, b in zip(sums["cuda"].iterations, sums["cpu"].iterations, strict=True):
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
        assert a.linear_solver_iterations == b.linear_solver_iterations


def test_sy_source_is_built_before_the_first_capture(card, monkeypatch):
    """A fresh Program of another shape than the BA shape (quaternion
    cameras without a manifold, tangent 10) solved on the fused loop: the
    Evaluator builds its B4 source before the solve's first CUDA graph
    capture, no nvcc runs inside a capture, and its S·y runs that source's
    kernels."""
    import subprocess

    from ceres_tpu_torch.linalg.schur_kernels import sy_source

    events = []
    build, popen = cuda_lib.build_generated, subprocess.Popen

    def spy_build(sources):
        sources = list(sources)
        events.append(("build", sources, es.counts()["CUDAGraph::Capture"]))
        return build(sources)

    def spy_popen(*args, **kwargs):
        events.append(("process", torch.cuda.is_current_stream_capturing(), None))
        return popen(*args, **kwargs)

    monkeypatch.setattr(cuda_lib, "build_generated", spy_build)
    monkeypatch.setattr(subprocess, "Popen", spy_popen)
    bal = ct.synthetic_bal(32, 4000, 40_000, seed=4)
    problem = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), use_quaternions=True)[0]
    es.reset_counts()
    captures0 = es.counts()["CUDAGraph::Capture"]
    summary = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI, max_num_iterations=2,
        fused_execution_chunk_iters=1, dtype=torch.float32), problem)
    assert summary.used_fused_execution
    assert es.counts()["CUDAGraph::Capture"] > captures0
    src = sy_source(2, 10, 3)
    builds = [e for e in events if e[0] == "build" and src in e[1]]
    assert builds and builds[0][2] == captures0  # before the solve's first capture
    assert not any(e[1] for e in events if e[0] == "process")  # no nvcc inside a capture
    assert es.counts()["schur_sy"] > 0


# ---- B1 generic ----------------------------------------------------------


def _generic_problems():
    from ceres_tpu_torch.examples import denoising, test_functions

    rng = np.random.default_rng(5)
    img = rng.uniform(0.0, 255.0, (40, 36))

    def foe(size, k):
        d = np.arange(size)
        return denoising.FoEModel(size, np.tile(d, size), np.repeat(d, size),
                                  rng.uniform(0.5, 2.0, k), rng.normal(size=(k, size * size)))

    bal = ct.synthetic_bal(8, 200, 1000, seed=3)
    return {
        "foe3": denoising.build_foe_denoising_problem(img, foe(3, 2))[0],
        "foe5": denoising.build_foe_denoising_problem(img, foe(5, 1))[0],
        "powell": test_functions.build_powell_problem()[0],
        "curve": test_functions.build_curve_fitting_problem(m0=0.1, c0=0.2)[0],
        "snavely_composed": ct.build_ba_problem(
            bal, loss=ct.ComposedLoss(ct.CauchyLoss(2.0), ct.HuberLoss(1.0)))[0],
        "quat_wrapper": ct.build_ba_problem(
            bal, loss=ct.LossFunctionWrapper(ct.TolerantLoss(1.0, 2.0)), use_quaternions=True,
            use_manifolds=True)[0],
    }


@pytest.mark.parametrize("case", ["foe3", "foe5", "powell", "curve", "snavely_composed",
                                  "quat_wrapper"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_generic_matches_plain(card, dtype, case):
    """Every group of the problem through B1 generic against its plain
    version (torch.func on the same card tensors), with the Jacobian and
    residual-only; two runs bitwise equal; one launch counted each."""
    program = _generic_problems()[case].compile(card)
    ev = Evaluator(program, dtype)
    st = state_tables(program, program.state_vector(dtype))
    tol = 2e-4 if dtype == torch.float32 else 1e-11
    for meta, garr in zip(program.groups, ev.arrays["groups"]):
        prog = functor_codegen.group_program(meta, garr, dtype, True)
        assert prog is not None, meta.cost_function.name
        args = (meta, garr, st)
        for with_jac in (True, False):
            es.reset_counts()
            cost, res, leaves = eval_kernel.generic_evaluate(prog, *args, with_jac)
            name = "eval_generic" if with_jac else "eval_generic_residual"
            assert es.counts()[name] == 1
            cost_p, res_p, leaves_p = group_eval_plain(*args, with_jac, True)
            _close(res, res_p, tol)
            _close(cost.reshape(1), cost_p.reshape(1), tol)
            assert len(leaves) == len(leaves_p) == (len(meta.positions) if with_jac else 0)
            for a, b in zip(leaves, leaves_p):
                _close(a, b, tol)
            again = eval_kernel.generic_evaluate(prog, *args, with_jac)
            assert torch.equal(again[1], res) and torch.equal(again[0], cost)
            assert all(torch.equal(a, b) for a, b in zip(again[2], leaves))


def test_eval_generic_dispatch_on_the_card(card):
    """On the card every Fields-of-Experts group goes through B1 generic
    (one build for the filter groups, whose sources are equal), the Snavely
    group under a coded loss through its own kernel."""
    program = _generic_problems()["foe3"].compile(card)
    ev = Evaluator(program, torch.float64)
    progs = [functor_codegen.group_program(m, g, torch.float64, True)
             for m, g in zip(program.groups, ev.arrays["groups"])]
    assert progs[1].source == progs[2].source != progs[0].source
    es.reset_counts()
    ev.evaluate_groups(program.state_vector(torch.float64))
    ev.cost(program.state_vector(torch.float64))
    counts = es.counts()
    assert counts["eval_generic"] == counts["eval_generic_residual"] == len(program.groups)


def test_eval_generic_build_failure_raises(card):
    """A generated source nvcc refuses raises (no torch.func fallback)."""
    import copy

    program = _generic_problems()["powell"].compile(card)
    ev = Evaluator(program, torch.float64)
    meta, garr = program.groups[0], ev.arrays["groups"][0]
    prog = copy.copy(functor_codegen.group_program(meta, garr, torch.float64, True))
    prog.entry_point = None
    prog.source = prog.source.replace("struct G {", "struct G { this is not C++;")
    st = state_tables(program, program.state_vector(torch.float64))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        eval_kernel.generic_evaluate(prog, meta, garr, st, True)
    with pytest.raises(TypeError):
        eval_kernel.generic_evaluate(
            functor_codegen.group_program(meta, garr, torch.float64, True), meta, garr,
            [t.float() for t in st], True)


# ---- B1 generic's custom-Jacobian branch --------------------------------


def _manifold_problem(m, cost, x, rng):
    """One group of 300 blocks on manifold m at the points x, Cauchy(1)
    loss, one datum per block."""
    p = ct.Problem()
    blocks = p.add_parameter_blocks(x, manifold=m)
    p.add_residual_blocks(cost, ct.CauchyLoss(1.0), blocks[:, None], (rng.normal(size=(300, 1)),))
    return p


def _rule_problems():
    """Groups with a rule of their own or a manifold the generator serves:
    Fields-of-Experts cliques as AnalyticCostFunctions (closed form, and a
    deliberately wrong rule of 3x the closed form), a scaled analytic
    functor on a SubsetManifold position (a rule nested in a larger
    functor), and autodiff functors on SubsetManifold, SphereManifold,
    LineManifold and AutoDiffManifold positions (the generator traces
    their plus-Jacobians: Householder reflections and normalisations)."""
    from chip_smoke import build_foe, build_foe_wrong_rule
    from ceres_tpu_torch.cost_functions import scaled_cost_function

    rng = np.random.default_rng(11)

    def fn(params, data):
        (x,) = params
        return torch.stack([x[0] * x[1] - data[0][0], torch.sin(x[2]) + x[3] * x[0]])

    def jac(params, data):
        (x,) = params
        z = torch.zeros_like(x[0])
        return (torch.stack([torch.stack([x[1], x[0], z, z]),
                             torch.stack([x[3], z, torch.cos(x[2]), x[0]])]),)

    def ambient(params, data):
        (q,) = params
        return torch.sin(q) * data[0][0] + q[0] * q

    def unit_rows(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    lines = rng.normal(size=(300, 6))
    lines[:, 3:] = unit_rows(lines[:, 3:])
    return {
        "foe3_analytic": build_foe(40, 36, 3, 2, seed=4, analytic=True),
        "foe3_analytic_x3": build_foe_wrong_rule(40, 36, 3, 2, seed=4),
        "scaled_analytic_subset": _manifold_problem(
            ct.SubsetManifold(4, (1,)), scaled_cost_function(ct.AnalyticCostFunction(fn, jac, 2),
                                                              0.5),
            rng.uniform(0.5, 1.5, (300, 4)), rng),
        "autodiff_subset": _manifold_problem(ct.SubsetManifold(4, (1,)), ct.CostFunction(fn, 2),
                                             rng.uniform(0.5, 1.5, (300, 4)), rng),
        "sphere": _manifold_problem(ct.SphereManifold(4), ct.CostFunction(ambient, 4),
                                    unit_rows(rng.normal(size=(300, 4))), rng),
        "line": _manifold_problem(ct.LineManifold(3), ct.CostFunction(ambient, 6), lines, rng),
        "autodiff_manifold": _manifold_problem(
            ct.AutoDiffManifold(lambda x, d: x + d * torch.exp(0.1 * x),
                                lambda y, x: (y - x) * torch.exp(-0.1 * x), 4, 4),
            ct.CostFunction(ambient, 4), rng.normal(size=(300, 4)), rng),
    }


@pytest.mark.parametrize("case", ["foe3_analytic", "foe3_analytic_x3", "scaled_analytic_subset",
                                  "autodiff_subset", "sphere", "line", "autodiff_manifold"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_generic_rule_matches_plain(card, dtype, case):
    """Every group through B1 generic against its plain version, whose
    torch.func path runs the rule's jvp: with the Jacobian and
    residual-only, bitwise across two runs; a group with an analytic rule
    counts under eval_generic_analytic, the others under eval_generic. The
    3x rule's leaves are 3x the autodiff clique's."""
    program = _rule_problems()[case].compile(card)
    ev = Evaluator(program, dtype)
    st = state_tables(program, program.state_vector(dtype))
    tol = 2e-4 if dtype == torch.float32 else 1e-11
    for meta, garr in zip(program.groups, ev.arrays["groups"]):
        prog = functor_codegen.group_program(meta, garr, dtype, True)
        assert prog is not None, meta.cost_function.name
        assert prog.has_rule == (meta.cost_function.name != "foe_data" and "analytic" in case)
        args = (meta, garr, st)
        for with_jac in (True, False):
            es.reset_counts()
            cost, res, leaves = eval_kernel.generic_evaluate(prog, *args, with_jac)
            name = ("eval_generic_analytic" if prog.has_rule else "eval_generic") if with_jac \
                else "eval_generic_residual"
            assert es.counts()[name] == 1
            cost_p, res_p, leaves_p = group_eval_plain(*args, with_jac, True)
            _close(res, res_p, tol)
            _close(cost.reshape(1), cost_p.reshape(1), tol)
            for a, b in zip(leaves, leaves_p):
                _close(a, b, tol)
            again = eval_kernel.generic_evaluate(prog, *args, with_jac)
            assert torch.equal(again[1], res) and all(
                torch.equal(a, b) for a, b in zip(again[2], leaves))
    if case == "foe3_analytic_x3":
        from chip_smoke import build_foe

        auto = build_foe(40, 36, 3, 2, seed=4).compile(card)
        aev = Evaluator(auto, dtype)
        ast = state_tables(auto, auto.state_vector(dtype))
        for gi in (1, 2):
            m, g = auto.groups[gi], aev.arrays["groups"][gi]
            want = eval_kernel.generic_evaluate(
                functor_codegen.group_program(m, g, dtype, True), m, g, ast, True)[2]
            m3, g3 = program.groups[gi], ev.arrays["groups"][gi]
            got = eval_kernel.generic_evaluate(
                functor_codegen.group_program(m3, g3, dtype, True), m3, g3, st, True)[2]
            for a, b in zip(got, want):
                _close(a, 3.0 * b, tol)


def test_numeric_group_takes_torch_func_on_the_card(card):
    """A NumericDiffCostFunction group is not generated: on the card its
    evaluation launches no B1 generic (nor B1's Snavely kernel), and its
    finite-difference Jacobian equals the CPU's within the rounding bound
    of a central difference (float64), in chip_smoke's units: at most 8 on
    the columns at the step's 1e-12 floor (synthetic_bal's camera
    translations of 0, where a unit is ~1e-4 of the largest entry), 64 on
    the rest (Snavely's rotation carries values larger than the unit's
    |f|)."""
    from chip_smoke import fd_rounding_excess
    from ceres_tpu_torch.examples.snavely import snavely_reprojection_error

    bal = ct.synthetic_bal(8, 200, 1000, seed=3)
    out = {}
    for dev in ("cpu", "cuda"):
        p = ct.Problem()
        cams = p.add_parameter_blocks(bal.cameras)
        pts = p.add_parameter_blocks(bal.points)
        p.add_residual_blocks(ct.NumericDiffCostFunction(snavely_reprojection_error, 2), None,
                              np.stack([cams[bal.camera_index], pts[bal.point_index]], 1),
                              (bal.observations,))
        program = p.compile(dev)
        ev = Evaluator(program, torch.float64)
        assert functor_codegen.group_program(program.groups[0], ev.arrays["groups"][0],
                                             torch.float64, True) is None
        es.reset_counts()
        out[dev] = ev.evaluate_groups(program.state_vector(torch.float64))
        counts = es.counts()
        assert counts["eval_snavely"] == 0
        assert all(counts[k] == 0 for k in cuda_lib.GENERIC_KERNELS)
    (c_cpu, r_cpu, j_cpu, _), (c_gpu, r_gpu, j_gpu, _) = out["cpu"], out["cuda"]
    assert float(c_gpu) == pytest.approx(float(c_cpu), rel=1e-12)
    # the parameters and observations in the group's lane order
    program = p.compile("cpu")
    garr = program.arrays(torch.float64)["groups"][0]
    st = state_tables(program, program.state_vector(torch.float64))
    params = [st[pm.a_cls][rows] for pm, rows in zip(program.groups[0].positions, garr["a_rows"])]
    scale = garr["data"][0].abs().max(dim=1).values + r_cpu[0].abs().max(dim=0).values
    at_floor, above = fd_rounding_excess(j_gpu.jac_groups[0], j_cpu.jac_groups[0], params, scale)
    print(f"units of the rounding bound: {at_floor:.2f} at the floor, {above:.2f} above it")
    assert at_floor <= 8.0 and above <= 64.0


def test_subset_solve_gap_is_rounding_at_a_vanishing_cost(card):
    """chip_smoke's SubsetManifold solve with three residuals on the three
    free coordinates (build_subset_problem(square=True)), whose minimum is
    zero: float64 card against CPU, every iteration's cost gap within
    1e-9 of the initial cost, and within 1e-9 of the iteration's own cost
    wherever that is above 1e-6 of the initial cost. Below, the cost is
    rounding and a relative gap says nothing; there chip_smoke's held
    per-iteration relative check missed 1e-9, so its problem has four
    residuals."""
    from chip_smoke import build_subset_problem, lm_options

    sums = {dev: ct.solve(lm_options(dev, torch.float64,
                                     linear_solver_type=ct.LinearSolverType.DENSE_QR,
                                     max_num_iterations=8),
                          build_subset_problem(300, square=True))
            for dev in ("cuda", "cpu")}
    c0 = sums["cpu"].initial_cost
    for a, b in zip(sums["cuda"].iterations, sums["cpu"].iterations, strict=True):
        gap = abs(a.cost - b.cost)
        print(f"iteration {a.iteration}: cost CUDA {a.cost!r} CPU {b.cost!r}, gap "
              f"{gap / c0:.3e} of the initial cost, {gap / max(b.cost, 1e-300):.3e} of its own")
        assert gap <= 1e-9 * c0
        if b.cost > 1e-6 * c0:
            assert gap <= 1e-9 * b.cost


# ---- B1 generic's one launch ---------------------------------------------


def manifold_problem(n, seed=0, loss=None):
    """A group of 15 tangent columns with a manifold position between two
    Euclidean ones: a point (3), a quaternion camera on Quaternion x
    Euclidean(6) (tangent 9, columns 3-11) and a second point (3). n
    blocks from the seed, one datum each."""
    rng = np.random.default_rng(seed)

    def fn(params, data):
        a, cam, b = params
        return torch.stack([cam[0] * a[0] + torch.sin(cam[1]) * b[1] - data[0][0],
                            cam[4] * a[2] - b[0] * cam[8] + cam[3] * cam[2],
                            cam[5] * cam[9] + a[1] * b[2] + cam[7] * cam[6]])

    q = rng.normal(size=(7, 4))
    cams = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True),
                           rng.normal(size=(7, 6))], axis=1)
    p = ct.Problem()
    pa = p.add_parameter_blocks(rng.normal(size=(11, 3)))
    pc = p.add_parameter_blocks(cams, manifold=ct.ProductManifold(ct.QuaternionManifold(),
                                                                  ct.EuclideanManifold(6)))
    pb = p.add_parameter_blocks(rng.normal(size=(13, 3)))
    idx = np.stack([pa[rng.integers(0, 11, n)], pc[rng.integers(0, 7, n)],
                    pb[rng.integers(0, 13, n)]], 1)
    p.add_residual_blocks(ct.CostFunction(fn, 3), loss, idx, (rng.normal(size=(n, 1)),))
    return p


def _one_launch_problems(tmp):
    """Groups of many tangent columns, each with n not a multiple of the
    block (128): the FoE 5x5 clique (N = 25), the manifold group (N = 15,
    Huber loss), the FoE 5x5 clique as an AnalyticCostFunction (N = 25)
    and the 3D pose graph's edges (N = 12, two quaternion poses)."""
    from chip_smoke import build_foe, small_sphere_problem
    from ceres_tpu_torch.examples import denoising

    rng = np.random.default_rng(7)
    img = rng.uniform(0.0, 255.0, (41, 37))
    foe = denoising.synthetic_foe_model(5, 1, seed=3)
    return {
        "foe5": denoising.build_foe_denoising_problem(img, foe)[0],
        "manifold": manifold_problem(1001, loss=ct.HuberLoss(1.0)),
        "foe5_analytic": build_foe(41, 37, 5, 1, seed=4, analytic=True),
        "pose_graph_3d": small_sphere_problem(tmp, 7, 10)[0],
    }


@pytest.mark.parametrize("case", ["foe5", "manifold", "foe5_analytic", "pose_graph_3d"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_generic_one_launch_matches_plain(card, dtype, case, tmp_path):
    """Each group's evaluation is one counted launch, with and without the
    Jacobian, against the plain version; residuals, leaves and cost bitwise
    equal across two launches."""
    program = _one_launch_problems(str(tmp_path))[case].compile(card)
    ev = Evaluator(program, dtype)
    st = state_tables(program, program.state_vector(dtype))
    tol = 2e-4 if dtype == torch.float32 else 1e-11
    for meta, garr in zip(program.groups, ev.arrays["groups"]):
        prog = functor_codegen.group_program(meta, garr, dtype, True)
        assert prog is not None and meta.n % eval_kernel.generic_block(meta.n) != 0
        args = (meta, garr, st)
        cost_p, res_p, leaves_p = group_eval_plain(*args, True, True)
        for with_jac in (True, False):
            name = ("eval_generic_analytic" if prog.has_rule else "eval_generic") if with_jac \
                else "eval_generic_residual"
            es.reset_counts()
            one = eval_kernel.generic_evaluate(prog, *args, with_jac)
            assert es.counts()[name] == 1
            _close(one[0], cost_p, tol)
            _close(one[1], res_p, tol)
            for a, b in zip(one[2], leaves_p):
                _close(a, b, tol)
            two = eval_kernel.generic_evaluate(prog, *args, with_jac)
            assert torch.equal(two[0], one[0]) and torch.equal(two[1], one[1])
            assert all(torch.equal(a, b) for a, b in zip(two[2], one[2]))


def test_eval_generic_cost_is_bitwise_across_graph_replays(card):
    """The one-launch cost sum: the last block resets the ticket counter,
    so three replays of one captured graph (with and without the Jacobian)
    give bitwise the same cost, equal to an eager launch's, and the counter
    ends at 0."""
    from ceres_tpu_torch.examples import denoising

    rng = np.random.default_rng(8)
    img = rng.uniform(0.0, 255.0, (41, 37))
    program = denoising.build_foe_denoising_problem(
        img, denoising.synthetic_foe_model(5, 2, seed=1))[0].compile(card)
    dtype = torch.float32
    ev = Evaluator(program, dtype)
    st = state_tables(program, program.state_vector(dtype))
    for meta, garr in zip(program.groups, ev.arrays["groups"]):
        prog = functor_codegen.group_program(meta, garr, dtype, True)
        args = (meta, garr, st)
        for with_jac in (True, False):
            eager = eval_kernel.generic_evaluate(prog, *args, with_jac)[0].clone()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                cost = eval_kernel.generic_evaluate(prog, *args, with_jac)[0]
            seen = []
            for _ in range(3):
                graph.replay()
                torch.cuda.synchronize()
                seen.append(cost.clone())
            assert all(torch.equal(c, eager) for c in seen)
            assert not prog.device_tickets[st[0].device].any()


def test_eval_generic_is_one_kernel_per_evaluation(card):
    """torch.profiler sees one B1 generic kernel per group evaluation (the
    cost summed inside it) and no second launch."""
    from torch.profiler import ProfilerActivity, profile

    program = _generic_problems()["foe3"].compile(card)
    ev = Evaluator(program, torch.float32)
    state = program.state_vector(torch.float32)
    ev.evaluate_groups(state)
    ev.cost(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev.evaluate_groups(state)
        ev.cost(state)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    generic = [nm for nm in names if "eval_generic" in nm]
    assert len(generic) == 2 * len(program.groups), generic
    assert not any("sum_kernel" in nm for nm in generic)


# ---- B2's two kernels ----------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES + [BF16])
@pytest.mark.parametrize("n", [50_000, 50_001, 49_997, 50_004, 7])
def test_gather_contract_branches(card, dtype, n):
    """B2 on a table that fits shared memory, a table that is a misaligned
    view (the bulk copy's head and tail) and ragged n (odd, and not a
    multiple of 8: the shared-memory kernel's scalar path). On bfloat16
    leaves the shared-memory and global branches, each against the plain
    version and bitwise equal to each other; on float32 and float64 leaves
    the global one (the default), the shared one refused."""
    from ceres_tpu_torch.gather_reduce import table_fits

    rng = np.random.default_rng(n)
    ncols = 1779
    vdt = cuda_lib.vector_dtype(dtype)
    jac = torch.tensor(rng.normal(size=(18, n)), dtype=dtype, device=card)
    rows = torch.tensor(rng.integers(0, ncols, n).astype(np.int32), device=card)
    big = torch.tensor(rng.normal(size=9 * ncols + 1), dtype=vdt, device=card)
    assert table_fits(9, ncols)
    tol = 1e-11 if dtype == torch.float64 else 1e-5
    name = cuda_lib.counter("gather_contract", dtype)
    for table in (big[:-1].reshape(9, ncols), big[1:].reshape(9, ncols)):
        want = gather_contract_plain(jac, rows, table, 2)
        counts = es.counts()
        glob = gather_contract(jac, rows, table, 2, branch="global")
        _close(glob, want, tol)
        if dtype == BF16:
            shared = gather_contract(jac, rows, table, 2, branch="shared")
            assert es.counts()[name] == counts[name] + 2
            _close(shared, want, tol)
            assert torch.equal(shared, glob)
            assert torch.equal(shared, gather_contract(jac, rows, table, 2))
        else:
            assert es.counts()[name] == counts[name] + 1
            assert torch.equal(glob, gather_contract(jac, rows, table, 2))
            with pytest.raises(ValueError):
                gather_contract(jac, rows, table, 2, branch="shared")


def test_gather_contract_large_table_takes_the_global_branch(card):
    """A table past the shared-memory limit (BAL-13682's camera count)
    runs the global branch, against the plain version, on bfloat16 leaves
    too; asking for the shared branch there raises."""
    from ceres_tpu_torch.gather_reduce import gather_branch

    rng = np.random.default_rng(3)
    n, ncols = 60_000, 13_683
    jac = torch.tensor(rng.normal(size=(18, n)), dtype=torch.float32, device=card)
    rows = torch.tensor(rng.integers(0, ncols, n).astype(np.int32), device=card)
    table = torch.tensor(rng.normal(size=(9, ncols)), dtype=torch.float32, device=card)
    assert gather_branch(9, ncols, torch.bfloat16) == "global"
    j16 = jac.to(BF16)
    _close(gather_contract(j16, rows, table, 2), gather_contract_plain(j16, rows, table, 2), 1e-5)
    _close(gather_contract(jac, rows, table, 2), gather_contract_plain(jac, rows, table, 2), 1e-5)
    with pytest.raises(ValueError):
        gather_contract(j16, rows, table, 2, branch="shared")


def test_eval_generic_strides_past_the_grid_cap(card):
    """Groups of more lanes than the capped grid covers (GENERIC_MAX_BLOCKS
    blocks of 512): each block strides over the rest. The FoE 5x5 clique
    and the data term at 1040 x 1040 against their plain version, with the
    Jacobian and residual-only, bitwise across two launches."""
    from ceres_tpu_torch.examples import denoising

    rng = np.random.default_rng(9)
    img = rng.uniform(0.0, 255.0, (1040, 1040))
    program = denoising.build_foe_denoising_problem(
        img, denoising.synthetic_foe_model(5, 1, seed=2))[0].compile(card)
    dtype = torch.float32
    ev = Evaluator(program, dtype)
    st = state_tables(program, program.state_vector(dtype))
    for meta, garr in zip(program.groups, ev.arrays["groups"]):
        assert meta.n > eval_kernel.GENERIC_MAX_BLOCKS * eval_kernel.generic_block(meta.n)
        prog = functor_codegen.group_program(meta, garr, dtype, True)
        args = (meta, garr, st)
        _, res_p, leaves_p = group_eval_plain(*args, True, True)
        one = eval_kernel.generic_evaluate(prog, *args, True)
        _close(one[1], res_p, 2e-4)
        for a, b in zip(one[2], leaves_p):
            _close(a, b, 2e-4)
        got = eval_kernel.generic_evaluate(prog, *args, True)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
        assert all(torch.equal(a, b) for a, b in zip(got[2], one[2]))
        r1 = eval_kernel.generic_evaluate(prog, *args, False)
        r2 = eval_kernel.generic_evaluate(prog, *args, False)
        _close(r1[1], res_p, 2e-4)
        assert torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1])


# (r, t, n, ncols, k): the camera shapes the batched kernels instantiate
# (t = 9 and t = 10; k = 72, and k = 13, whose f32 rows are no multiple of
# 16 bytes and go value by value), and a shape that takes their any-(r, t)
# instantiations
BATCHED_SHAPES = [(2, 9, 120_000, 357, 72), (2, 10, 40_000, 40, 13), (3, 4, 30_000, 25, 9)]


def _batched_case(card, dtype, shape, seed=7):
    """Lane-major table [k, t, ncols] and u [k, r, n] (gather_reduce.lanes_major),
    the leaf, rows, its camera layout and twin."""
    r, t, n, ncols, k = shape
    rng = np.random.default_rng(seed)
    vdt = cuda_lib.vector_dtype(dtype)
    rows_np = rng.integers(0, ncols, n).astype(np.int32)  # includes the dump column
    rows = torch.tensor(rows_np, device=card)
    layout = camera_layout(rows_np, ncols).to(card)
    jac = torch.tensor(rng.normal(size=(r * t, n)), device=card).to(dtype)
    table = lanes_major(torch.tensor(rng.normal(size=(k, t, ncols)), device=card).to(vdt))
    table[:, :, -1] = 0
    u = lanes_major(torch.tensor(rng.normal(size=(k, r, n)), device=card).to(vdt))
    return jac, rows, rows_np, layout, make_twin(jac, layout), table, u


def _kernel_names(fn):
    """The names of the device kernels one call of fn launches (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]


@pytest.mark.parametrize("shape", BATCHED_SHAPES, ids=lambda s: f"r{s[0]}t{s[1]}k{s[4]}")
@pytest.mark.parametrize("dtype", DTYPES + [BF16])
def test_batched_gather_reduce_match_plain_and_single_launches(card, dtype, shape):
    """The batched B2 and B3 on lane-major operands: within the single-vector
    tolerances of their plain versions, bitwise equal column by column to k
    single-vector launches and from run to run, the outputs lane-major, and
    one B3 call two launches (the chunk pass and camera_chunks' sum: no
    transposition of u)."""
    r, t, n, ncols, k = shape
    jac, rows, rows_np, layout, twin, table, u = _batched_case(card, dtype, shape)
    vdt = cuda_lib.vector_dtype(dtype)
    counts = es.counts()
    g = gather_contract_batched(jac, rows, table, r, twin, layout)
    c = contract_reduce_batched(twin, layout, u, r)
    after = es.counts()
    for name in ("gather_contract_batched", "contract_reduce_batched"):
        key = cuda_lib.counter(name, dtype)
        assert after[key] == counts[key] + 1
    assert g.shape == (k, r, n) and c.shape == (k, t, ncols) and g.dtype == c.dtype == vdt
    assert g.stride() == (1, k, r * k) and c.stride() == (1, k, t * k)
    tol = 1e-11 if dtype == torch.float64 else None
    _close(g, gather_contract_batched_plain(jac, rows, table, r), tol or 1e-5)
    _close(c, contract_reduce_batched_plain(twin, layout, u, r), tol or 1e-4)
    assert torch.equal(g, torch.stack([gather_contract(jac, rows, table[e].contiguous(), r)
                                       for e in range(k)]))
    assert torch.equal(c, torch.stack([contract_reduce(twin, layout, u[e].contiguous(), r)
                                       for e in range(k)]))
    assert torch.equal(g, gather_contract_batched(jac, rows, table, r, twin, layout))
    assert torch.equal(c, contract_reduce_batched(twin, layout, u, r))
    assert torch.all(g[:, :, torch.tensor(rows_np == ncols - 1, device=card)] == 0)
    names = _kernel_names(lambda: contract_reduce_batched(twin, layout, u, r))
    assert len(names) == 2 and not any("lanes_major" in x for x in names), names
    assert any("contract_reduce_batched" in x for x in names), names


def test_batched_wrappers_refuse_bad_operands(card):
    """Wrong shapes, dtypes and layouts raise (never a silent copy): a table
    or u in the [k, ., .]-contiguous layout, a missing twin."""
    jac, rows, _, layout, twin, table, u = _batched_case(card, torch.float32, (2, 9, 3000, 11, 5))
    with pytest.raises(ValueError, match="table_t"):
        gather_contract_batched(jac, rows, lanes_major(torch.zeros((5, 8, 11), device=card)), 2,
                                twin, layout)
    with pytest.raises(TypeError, match="table_t"):
        gather_contract_batched(jac, rows, table.double(), 2, twin, layout)
    with pytest.raises(ValueError, match="table_t: tensor must be lane-major"):
        gather_contract_batched(jac, rows, table.contiguous(), 2, twin, layout)
    with pytest.raises(ValueError, match="twin"):
        gather_contract_batched(jac, rows, table, 2, None, layout)
    with pytest.raises(ValueError, match="u: tensor must be lane-major"):
        contract_reduce_batched(twin, layout, u.contiguous(), 2)
    with pytest.raises(ValueError, match="u: shape"):
        contract_reduce_batched(twin, layout, u[:, :, :-1], 2)
