"""The port's Program reproduces ceres_tpu's index tables exactly.

Both packages compile the same numpy `synthetic_bal`; every layout table,
signature-group row table, reduction plan and the Schur partition must be
equal array for array. The camera CSR (no JAX counterpart) must be a valid
stable sort of the lanes by class row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch import program as program_mod
from ceres_tpu_torch.interop import from_jax_program_arrays, state_from_numpy
from ceres_tpu_torch.program import Program as TProgram

torch.set_num_threads(1)


@pytest.fixture(params=["plans", "no_plans"])
def threshold(request, monkeypatch):
    t = 16 if request.param == "plans" else 10**9
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", t)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", t)
    return request.param


def _programs(constant_camera=False, seed=2):
    bal = synthetic_bal(6, 50, 240, seed=seed)
    jp, jcams, _ = j_build(bal, loss=ceres_tpu.HuberLoss(1.0))
    tp, tcams, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    if constant_camera:
        jp.set_parameter_block_constant(jcams[0])
        tp.set_parameter_block_constant(tcams[0])
    return jp.compile(), tp.compile("cpu")


LAYOUT_ATTRS = [
    "x_offsets", "t_offsets", "t_row", "a_row", "t_class", "a_class",
    "tangent_class_bases", "ambient_class_bases", "block_degree", "state0",
]


@pytest.mark.parametrize("constant_camera", [False, True], ids=["free", "constant_cam"])
def test_layout_tables_equal(threshold, constant_camera):
    jprog, tprog = _programs(constant_camera)
    for attr in LAYOUT_ATTRS:
        np.testing.assert_array_equal(getattr(tprog, attr), getattr(jprog, attr), err_msg=attr)
    for attr in ("tangent_class_sizes", "tangent_class_counts", "ambient_class_sizes",
                 "ambient_class_counts", "ambient_aligned", "num_parameters",
                 "num_effective_parameters", "num_residuals"):
        assert getattr(tprog, attr) == getattr(jprog, attr), attr
    for a, b in zip(tprog.plus_euclid, jprog.plus_euclid):
        assert (a is None) == (b is None)
        if a is not None:
            assert a["t_cls"] == b["t_cls"]
            np.testing.assert_array_equal(a["t_row_map"], b["t_row_map"])


@pytest.mark.parametrize("constant_camera", [False, True], ids=["free", "constant_cam"])
def test_group_tables_and_plans_equal(threshold, constant_camera):
    jprog, tprog = _programs(constant_camera)
    assert len(tprog.groups) == len(jprog.groups) == 1
    for tm, jm, ti, ji in zip(tprog.groups, jprog.groups, tprog.group_idx, jprog.group_idx):
        assert tm.red_plans == jm.red_plans
        assert tm.owner == jm.owner
        assert tm.owner_ambient_aligned == jm.owner_ambient_aligned
        assert (tm.n, tm.row_offset) == (jm.n, jm.row_offset)
        for tpm, jpm in zip(tm.positions, jm.positions):
            assert (tpm.size, tpm.tangent_size, tpm.a_cls, tpm.t_cls) == (
                jpm.size, jpm.tangent_size, jpm.a_cls, jpm.t_cls)
        for key in ("a_rows", "t_rows", "block_ids"):
            for a, b in zip(ti[key], ji[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)
        for a, b in zip(ti["data"], ji["data"]):
            np.testing.assert_array_equal(a, np.asarray(b))
    if threshold == "plans":
        assert tprog.groups[0].red_plans[tprog.groups[0].owner][0] == "bucket"


@pytest.mark.parametrize("constant_camera", [False, True], ids=["free", "constant_cam"])
def test_schur_partition_equal(threshold, constant_camera):
    jprog, tprog = _programs(constant_camera)
    te, tpos_e, tpos_f = tprog.compute_schur_partition()
    je, jpos_e, jpos_f = jprog.compute_schur_partition()
    np.testing.assert_array_equal(te, je)
    assert (tpos_e, tpos_f) == (jpos_e, jpos_f)
    for a, b in zip(tprog.schur_tangent_masks(), jprog.schur_tangent_masks()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("constant_camera", [False, True], ids=["free", "constant_cam"])
def test_camera_csr_is_stable_sort(constant_camera, monkeypatch):
    """The padded camera CSR: every camera's lanes in lane order, its run
    padded with -1 to a multiple of TWIN_ALIGN, and chunks that tile each
    run without straddling two cameras."""
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    monkeypatch.setattr(program_mod, "TWIN_CHUNK", 64)
    _, tprog = _programs(constant_camera, seed=5)
    meta, idx = tprog.groups[0], tprog.group_idx[0]
    onehot = [p for p, plan in meta.red_plans.items() if plan[0] == "onehot"]
    assert onehot == list(idx["csr"])
    for pos in onehot:
        lay = idx["csr"][pos]
        rows = idx["t_rows"][pos]
        ncols = tprog.tangent_class_counts[meta.positions[pos].t_cls] + 1
        offsets, n_pad = lay.offsets, len(lay.perm)
        assert offsets.shape == (ncols + 1,) and offsets[0] == 0 and offsets[-1] == n_pad
        assert np.all(offsets % program_mod.TWIN_ALIGN == 0)
        assert np.array_equal(np.sort(lay.perm[lay.perm >= 0]), np.arange(meta.n))
        assert np.array_equal(lay.pad, np.nonzero(lay.perm < 0)[0])
        assert lay.chunk_start[0] == 0 and lay.chunk_start[-1] == n_pad
        assert lay.live_chunks == lay.row_chunks[ncols - 1]
        for c in range(ncols):
            run = lay.perm[offsets[c] : offsets[c + 1]]
            lanes = run[run >= 0]
            assert np.all(run[: lanes.size] >= 0)  # padding at the end
            assert run.size - lanes.size < program_mod.TWIN_ALIGN
            assert np.all(rows[lanes] == c)
            assert np.all(np.diff(lanes) > 0)  # stable: lane order kept
            assert np.all(lay.slot_row[offsets[c] : offsets[c + 1]] == c)
            cuts = lay.chunk_start[lay.row_chunks[c] : lay.row_chunks[c + 1] + 1]
            if run.size:
                assert cuts[0] == offsets[c] and cuts[-1] == offsets[c + 1]
                assert np.all(np.diff(cuts) > 0) and np.all(np.diff(cuts) <= 64)
            else:
                assert lay.row_chunks[c] == lay.row_chunks[c + 1]
        if constant_camera:
            assert offsets[ncols] - offsets[ncols - 1] > 0  # the dump run


def test_arrays_and_interop(monkeypatch):
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", 16)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    jprog, tprog = _programs()
    t_arr = tprog.arrays(torch.float64)
    j_arr = jprog.arrays(jnp.float64)
    g = t_arr["groups"][0]
    assert all(a.dtype == torch.int32 for a in g["a_rows"] + g["t_rows"])
    assert g["data"][0].dtype == torch.float64 and g["data"][0].shape == (tprog.groups[0].n, 2)
    np_arrays = {
        "groups": [
            {k: tuple(np.asarray(x) for x in jg[k]) for k in ("a_rows", "t_rows", "data")}
            for jg in j_arr["groups"]
        ],
        "plus_euclid": [
            None if r is None else {"t_row_map": np.asarray(r["t_row_map"])}
            for r in j_arr["plus_euclid"]
        ],
    }
    conv = from_jax_program_arrays(np_arrays, "cpu", torch.float64)
    for key in ("a_rows", "t_rows", "data"):
        for a, b in zip(conv["groups"][0][key], g[key]):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    for a, b in zip(conv["plus_euclid"], t_arr["plus_euclid"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a["t_row_map"], b["t_row_map"])
    x = state_from_numpy(tprog, np.asarray(jprog.state_vector(jnp.float64)))
    assert torch.equal(x, tprog.state_vector(torch.float64))
    with pytest.raises(ValueError):
        state_from_numpy(tprog, np.zeros(3))


def test_problem_counts_match_jax():
    bal = synthetic_bal(5, 30, 120, seed=9)
    jp, jc, _ = j_build(bal)
    tp, tc, _ = ct.build_ba_problem(bal)
    jp.set_parameter_block_constant(jc[1])
    tp.set_parameter_block_constant(tc[1])
    for name in ("num_parameter_blocks", "num_parameters", "num_effective_parameters",
                 "num_residual_blocks", "num_residuals"):
        assert getattr(tp, name)() == getattr(jp, name)(), name
    assert tp.is_parameter_block_constant(tc[1])
    np.testing.assert_array_equal(tp.parameter_block_value(tc[2]), bal.cameras[2])


def test_compile_defaults_to_the_solve_device(monkeypatch):
    """Problem.compile() with no device lowers to the device `solve` picks
    (utils.dtypes.resolve_device): the card; with no card visible it
    raises rather than fall back to the CPU; a named device wins."""
    problem, _, _ = ct.build_ba_problem(synthetic_bal(3, 10, 30, seed=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        problem.compile()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert problem.compile().device == torch.device("cuda")
    assert problem.compile("cpu").device == torch.device("cpu")
