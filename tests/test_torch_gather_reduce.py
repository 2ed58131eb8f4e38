"""Kernels B2/B3 (ceres_tpu_torch/gather_reduce.py) and the Jacobian
products that route through them, against ceres_tpu.

- The plain versions against pallas_onehot.gather_contract /
  contract_reduce run in interpret mode (float32), at the JAX kernel tests'
  tolerance 5e-4; B3 on the twin (the leaf in padded camera order) against
  the lane-order segmented sum in float64 at 1e-12, on ragged camera runs
  (1, 31, 32, 33 and 3000 observations, one camera with none); reduce_T's
  onehot plan on lane-order input, and the scaled twin made from the raw
  one bitwise equal to the twin of the scaled leaf.
- BlockJacobian products (right/left multiply, their tvec forms, column
  norms, block-diagonal grams, scale folding) against the JAX XLA path in
  float64 at 1e-12, on a problem with a constant camera so the dump column
  is exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu import pallas_onehot as po
from ceres_tpu.evaluator import evaluate as j_evaluate
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.gather_reduce import (
    contract_reduce,
    contract_reduce_plain,
    gather_contract,
    gather_contract_plain,
)
from ceres_tpu_torch.jacobian import make_twin, reduce_T, scale_twin
from ceres_tpu_torch.program import Program as TProgram
from ceres_tpu_torch.program import camera_layout

torch.set_num_threads(1)
TOL_F32 = 5e-4


def _kernel_inputs(seed, n, r=2, t=9, ncols=7):
    rng = np.random.default_rng(seed)
    jac = rng.normal(size=(r * t, n)).astype(np.float32)
    rows = rng.integers(0, ncols, n).astype(np.int32)  # includes the dump column
    table = rng.normal(size=(t, ncols)).astype(np.float32)
    table[:, -1] = 0.0
    u = rng.normal(size=(r, n)).astype(np.float32)
    return jac, rows, table, u


@pytest.mark.parametrize("n", [300, 5000])
def test_gather_contract_matches_pallas(monkeypatch, n):
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    jac, rows, table, _ = _kernel_inputs(0, n)
    want = np.asarray(po.gather_contract(jnp.asarray(jac), jnp.asarray(rows), jnp.asarray(table), 2))
    got = gather_contract(torch.tensor(jac), torch.tensor(rows), torch.tensor(table), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("n", [300, 5000])
def test_contract_reduce_matches_pallas(monkeypatch, n):
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    jac, rows, table, u = _kernel_inputs(1, n)
    ncols = table.shape[1]
    want = np.asarray(po.contract_reduce(jnp.asarray(jac), jnp.asarray(rows), jnp.asarray(u), ncols, 2))
    layout = camera_layout(rows, ncols).to("cpu")
    got = contract_reduce(make_twin(torch.tensor(jac), layout), layout, torch.tensor(u), 2)
    assert got.shape == (9, ncols)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32 * np.abs(want).max())


def test_dump_rows_gather_zero():
    jac, rows, table, _ = _kernel_inputs(2, 200)
    table[:, -1] = 7.0  # a nonzero dump column must still gather zero
    dump = rows == table.shape[1] - 1
    assert dump.any()
    out = gather_contract(torch.tensor(jac), torch.tensor(rows), torch.tensor(table), 2)
    assert torch.all(out[:, torch.tensor(dump)] == 0)
    table[:, -1] = 0.0
    ref = gather_contract_plain(torch.tensor(jac), torch.tensor(rows), torch.tensor(table), 2)
    assert torch.equal(out, ref)


def test_contract_reduce_without_u_is_segment_sum():
    jac, rows, table, _ = _kernel_inputs(3, 400, r=1, t=81)
    ncols = table.shape[1]
    layout = camera_layout(rows, ncols).to("cpu")
    twin = make_twin(torch.tensor(jac), layout)
    got = contract_reduce(twin, layout, None, 1)
    want = np.zeros((81, ncols), np.float64)
    np.add.at(want.T, rows, jac.T.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, contract_reduce_plain(twin, layout, None, 1))


# observations per camera: ragged runs around the 32-slot padding, one
# camera with none (column 4); the last column is the dump column
RAGGED = (1, 31, 32, 33, 0, 3000, 5)


def _ragged_rows(seed, sizes=RAGGED):
    rows = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    return np.random.default_rng(seed).permutation(rows)


def _lane_reduce(jac, rows, u, ncols, r):
    """B3's function in lane order (index_add_ over the lanes)."""
    rt, n = jac.shape
    x = jac.reshape(r, rt // r, n)
    contrib = x.sum(dim=0) if u is None else (x * u[:, None, :]).sum(dim=0)
    out = torch.zeros((rt // r, ncols), dtype=jac.dtype)
    return out.index_add_(1, torch.as_tensor(rows).long(), contrib)


@pytest.mark.parametrize("with_u", [True, False], ids=["u", "segment_sum"])
def test_twin_contract_reduce_matches_lane_order_f64(with_u):
    rows = _ragged_rows(5)
    n, ncols, r = rows.size, len(RAGGED), 2 if with_u else 1
    rng = np.random.default_rng(6)
    jac = torch.tensor(rng.normal(size=(r * 9, n)))
    u = torch.tensor(rng.normal(size=(r, n))) if with_u else None
    layout = camera_layout(rows, ncols).to("cpu")
    assert len(layout.pad) > 0
    got = contract_reduce(make_twin(jac, layout), layout, u, r)
    want = _lane_reduce(jac, rows, u, ncols, r)
    assert torch.all(got[:, 4] == 0)  # the camera without observations
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


def test_twin_padding_contributes_zero():
    """make_twin zeroes the padding slots, and B3's padding slots add
    nothing even where u, gathered at the clamped lane 0, is not finite."""
    rows = _ragged_rows(7)
    n, ncols = rows.size, len(RAGGED)
    rng = np.random.default_rng(8)
    jac = torch.tensor(rng.normal(size=(18, n)))
    u = torch.tensor(rng.normal(size=(2, n)))
    u[:, 0] = float("inf")
    layout = camera_layout(rows, ncols).to("cpu")
    twin = make_twin(jac, layout)
    live = layout.perm >= 0
    assert torch.all(twin[:, ~live] == 0)
    assert torch.equal(twin[:, live], jac[:, layout.perm[live].long()])
    got = contract_reduce(twin, layout, u, 2)
    others = torch.arange(ncols) != int(rows[0])
    assert torch.isfinite(got[:, others]).all()
    want = _lane_reduce(jac, rows, u, ncols, 2)
    np.testing.assert_allclose(got[:, others].numpy(), want[:, others].numpy(), rtol=1e-12,
                               atol=1e-12 * float(want[:, others].abs().max()))


@pytest.mark.parametrize("k", [1, 9, 81])
def test_reduce_T_onehot_takes_lane_order(k):
    """reduce_T's onehot plan takes lane-order contributions, as the bucket
    plan does, and makes their twin itself."""
    rows = _ragged_rows(9)
    ncols = len(RAGGED)
    contrib = torch.tensor(np.random.default_rng(k).normal(size=(k, rows.size)))
    layout = camera_layout(rows, ncols).to("cpu")
    got = reduce_T(("onehot",), contrib, torch.tensor(rows), ncols, layout)
    want = _lane_reduce(contrib, rows, None, ncols, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


def test_scale_twin_is_twin_of_scaled_leaf():
    """The scaled twin made from the raw twin slot by slot is bitwise the
    twin of the scaled leaf, zero on padding."""
    rows = _ragged_rows(10)
    ncols, r, t = len(RAGGED), 2, 9
    rng = np.random.default_rng(11)
    jac = torch.tensor(rng.normal(size=(r * t, rows.size)))
    table = torch.tensor(rng.uniform(0.5, 2.0, size=(ncols, t)))
    layout = camera_layout(rows, ncols).to("cpu")
    scaled = (jac.reshape(r, t, -1) * table[torch.tensor(rows)].T[None]).reshape(r * t, -1)
    got = scale_twin(make_twin(jac, layout), layout, table, r)
    assert torch.equal(got, make_twin(scaled, layout))
    assert torch.all(got[:, layout.pad.long()] == 0)


@pytest.fixture(scope="module")
def jacobians():
    """(JAX program, JAX BlockJacobian, port program, port BlockJacobian),
    float64, camera 0 constant, layout plans on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JProgram, "SEG_REDUCE_THRESHOLD", 16)
        mp.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
        bal = synthetic_bal(6, 50, 260, seed=11)
        jp, jc, _ = j_build(bal, loss=ceres_tpu.HuberLoss(1.0))
        tp, tc, _ = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
        jp.set_parameter_block_constant(jc[0])
        tp.set_parameter_block_constant(tc[0])
        jprog, tprog = jp.compile(), tp.compile("cpu")
    _c, _r, jjac, _g = jax.jit(lambda a, s: j_evaluate(jprog, a, s))(
        jprog.arrays(jnp.float64), jprog.state_vector(jnp.float64)
    )
    _c, _r, tjac, _g = Evaluator(tprog, torch.float64).evaluate_groups(
        tprog.state_vector(torch.float64)
    )
    meta = tprog.groups[0]
    assert sorted(p[0] for p in meta.red_plans.values()) == ["bucket", "onehot"]
    return jprog, jjac, tprog, tjac


def _vec(prog, seed):
    return np.random.default_rng(seed).normal(size=prog.num_effective_parameters)


def _res(prog, seed):
    return np.random.default_rng(seed).normal(size=(2, prog.groups[0].n))


def _check(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def _product(kind, prog, jac, to):
    """The BlockJacobian product `kind` in either package; `to` converts
    numpy inputs to the package's arrays."""
    v, u, s = to(_vec(prog, 1)), to(_res(prog, 2)), to(np.abs(_vec(prog, 3)) + 0.5)
    if kind == "right":
        return jac.right_multiply(v)[0]
    if kind == "left":
        return jac.left_multiply([u])
    if kind == "right_scaled":
        return jac.scale_columns(s).right_multiply(v)[0]
    if kind == "left_scaled":
        return jac.scale_columns(s).left_multiply([u])
    if kind == "right_t":
        return jac.scale_columns(s).materialize_scale().right_multiply_t(jac.tvec(v))[0]
    if kind == "left_t":
        return jac.tvec_flat(jac.scale_columns(s).materialize_scale().left_multiply_t([u]))
    if kind == "colnorm":
        return jac.scale_columns(s).squared_column_norms()
    raise ValueError(kind)


@pytest.mark.parametrize(
    "kind", ["right", "left", "right_scaled", "left_scaled", "right_t", "left_t", "colnorm"]
)
def test_products_match_xla_f64(jacobians, kind):
    jprog, jjac, tprog, tjac = jacobians
    want = _product(kind, jprog, jjac, jnp.asarray)
    got = _product(kind, tprog, tjac, lambda a: torch.tensor(a))
    _check(got, want)


def test_block_diag_jtj_matches_xla_f64(jacobians):
    jprog, jjac, tprog, tjac = jacobians
    s = np.abs(_vec(tprog, 4)) + 0.5
    d = np.abs(_vec(tprog, 5))
    want = jjac.scale_columns(jnp.asarray(s)).block_diag_jtj(dsq=jnp.asarray(d))
    got = tjac.scale_columns(torch.tensor(s)).block_diag_jtj(dsq=torch.tensor(d))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _check(g, w)


def test_to_dense_matches_xla_f64(jacobians):
    jprog, jjac, tprog, tjac = jacobians
    _check(tjac.to_dense(), jjac.to_dense())
