"""Row-lazy data (io/lazy.py, io.bal.load_bal_lazy) against ceres_tpu's.

LazyRows views and gathers, the file-backed BAL payload, a Program built
from lazy observations (its tables and evaluation equal an eager one's),
and a rank's shard reading only its own rows of the payload."""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu.io import bal as jbal
from ceres_tpu.io import lazy as jlazy
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.io import lazy as tlazy
from ceres_tpu_torch.parallel import sharding
from ceres_tpu_torch.program import Program as TProgram

torch.set_num_threads(1)


def _write_bal(path, bal):
    with open(path, "w") as f:
        f.write(f"{bal.num_cameras} {bal.num_points} {bal.num_observations}\n")
        for c, p, (u, v) in zip(bal.camera_index, bal.point_index, bal.observations):
            f.write(f"{c} {p} {u:.17g} {v:.17g}\n")
        for x in np.concatenate([bal.cameras.reshape(-1), bal.points.reshape(-1)]):
            f.write(f"{x:.17g}\n")


@pytest.fixture
def bal_file(tmp_path):
    bal = ct.synthetic_bal(7, 60, 301, seed=5)
    path = tmp_path / "problem.txt"
    _write_bal(path, bal)
    return bal, path


@pytest.mark.parametrize("rows", [slice(3, 40, 2), [5, 0, 5, 11], slice(None)],
                         ids=["slice", "repeats", "all"])
def test_lazy_rows_match_jax(rows):
    a = np.random.default_rng(0).normal(size=(50, 2))
    t = tlazy.LazyRows(tlazy.ArraySource(a))[np.arange(49, -1, -1)][rows]
    j = jlazy.LazyRows(jlazy.ArraySource(a))[np.arange(49, -1, -1)][rows]
    assert t.shape == j.shape and t.dtype == j.dtype and len(t) == len(j)
    np.testing.assert_array_equal(t.materialize(), j.materialize())
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    np.testing.assert_array_equal(t.gather([1, 0, 1]), j.gather([1, 0, 1]))
    with pytest.raises(TypeError):
        t[np.zeros((2, 2), dtype=np.int64)]


def test_load_bal_lazy_matches_jax(bal_file):
    bal, path = bal_file
    t, j = ct.load_bal_lazy(path), jbal.load_bal_lazy(path)
    for f in ("cameras", "points", "camera_index", "point_index"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert isinstance(t.observations, tlazy.LazyRows)
    rows = np.random.default_rng(1).integers(0, bal.num_observations, 40)
    np.testing.assert_array_equal(t.observations.gather(rows), j.observations.gather(rows))
    np.testing.assert_array_equal(np.asarray(t.observations), ct.load_bal(path).observations)


def test_lazy_program_equals_eager(monkeypatch, bal_file):
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    _, path = bal_file
    lazy = ct.build_ba_problem(ct.load_bal_lazy(path), loss=ct.HuberLoss(1.0))[0].compile("cpu")
    eager = ct.build_ba_problem(ct.load_bal(path), loss=ct.HuberLoss(1.0))[0].compile("cpu")
    assert isinstance(lazy.group_idx[0]["data"][0], tlazy.LazyRows)
    for a, b in zip(lazy.group_idx[0]["t_rows"], eager.group_idx[0]["t_rows"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(lazy.group_idx[0]["data"][0]),
                                  eager.group_idx[0]["data"][0])
    state = eager.state_vector(torch.float64)
    c1, _, _, g1 = Evaluator(lazy, torch.float64).evaluate_groups(state)
    c2, _, _, g2 = Evaluator(eager, torch.float64).evaluate_groups(state)
    assert float(c1) == float(c2)
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())


def test_a_shard_reads_only_its_rows(monkeypatch, bal_file):
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", 16)
    _, path = bal_file
    problem_bal = ct.load_bal_lazy(path)
    src = problem_bal.observations.source
    read = []
    gather = src.gather
    monkeypatch.setattr(src, "gather", lambda rows: read.append(np.asarray(rows)) or gather(rows))
    program = ct.build_ba_problem(problem_bal)[0].compile("cpu")
    assert not read  # compiling reads no observation
    lay = program.build_shard_layout(3)[0]
    local = sharding.shard_group_idx(program, 3, 1)[0]
    assert len(read) == 1
    own = lay["perm"][lay["lanes_per_shard"] : 2 * lay["lanes_per_shard"]]
    assert read[0].size == int((own >= 0).sum()) < problem_bal.num_observations // 2
    np.testing.assert_array_equal(local["mask"], own >= 0)
