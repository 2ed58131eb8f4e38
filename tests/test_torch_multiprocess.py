"""A 4-rank sharded solve over a 2 x 2 hybrid mesh (parallel.distributed.
hybrid_mesh: 2 "hosts" of 2 ranks, every reduction within a host's ranks
first, then across hosts) from a BAL file each rank loads lazily
(io.bal.load_bal_lazy: a rank reads only its own observation rows),
against ceres_tpu's hybrid-mesh solve of the same file on a 2 x 2 mesh of
conftest's virtual CPU devices (after tests/test_multiprocess.py:117-150):
the initial cost at 1e-10, the final cost at 1e-5, every rank's summary
bitwise the same. The ranks are spawned gloo processes that import only
the port (tests/torch_mp_worker.py), each under a timeout."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import ceres_tpu
from ceres_tpu.io.bal import build_ba_problem, load_bal, synthetic_bal
from ceres_tpu.program import Program as JProgram

import torch_mp
from torch_mp_worker import solve_options, summary_record

THRESHOLD = 16
CASE = "ischur_schur_jacobi"


def _write_bal(path, bal):
    with open(path, "w") as f:
        f.write(f"{bal.num_cameras} {bal.num_points} {bal.num_observations}\n")
        for c, p, (u, v) in zip(bal.camera_index, bal.point_index, bal.observations):
            f.write(f"{c} {p} {u:.17g} {v:.17g}\n")
        for x in np.concatenate([bal.cameras.reshape(-1), bal.points.reshape(-1)]):
            f.write(f"{x:.17g}\n")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid")
    bal_path = tmp / "problem.txt"
    _write_bal(bal_path, synthetic_bal(10, 120, 501, seed=9))
    started = torch_mp.start_ranks(str(tmp), 4, {
        "mesh": "hybrid", "local_size": 2, "threshold": THRESHOLD, "cases": [CASE],
        "bal_path": str(bal_path),
    })
    saved = JProgram.SEG_REDUCE_THRESHOLD
    JProgram.SEG_REDUCE_THRESHOLD = THRESHOLD
    try:
        hmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
        problem = build_ba_problem(load_bal(bal_path), loss=ceres_tpu.HuberLoss(1.0))[0]
        want = summary_record(ceres_tpu.solve(solve_options(ceres_tpu, CASE, mesh=hmesh), problem))
    finally:
        JProgram.SEG_REDUCE_THRESHOLD = saved
    return want, torch_mp.collect(started)


def test_hybrid_mesh_solve_matches_jax(results):
    want, ranks = results
    got = ranks[0][CASE]
    print(f"hybrid: final cost {got['final_cost']!r} against {want['final_cost']!r}, "
          f"gap {abs(got['final_cost'] - want['final_cost']) / want['final_cost']:.3e}")
    np.testing.assert_allclose(got["initial_cost"], want["initial_cost"], rtol=1e-10)
    np.testing.assert_allclose(got["final_cost"], want["final_cost"], rtol=1e-5)
    assert not got["used_fused_execution"]


def test_hybrid_ranks_stay_in_lockstep(results):
    _, ranks = results
    assert all(r[CASE] == ranks[0][CASE] for r in ranks[1:])


def test_replicate_gives_every_rank_rank_zeros_value(results):
    _, ranks = results
    assert [r["replicate"] for r in ranks] == [[0.0, 1.5, 2.5]] * 4
