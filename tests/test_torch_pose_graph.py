"""Pose-graph SLAM of the port (examples/pose_graph.py) against ceres_tpu's.

- `load_g2o_2d` / `load_g2o_3d` on .g2o files the test writes: the arrays
  of both packages equal; the 3D file is a ring-on-a-sphere graph of
  sphere2500's layout at a small size (rings of poses, odometry along them
  and loop closures between neighbouring rings) from a numpy seed,
  written by chip_smoke.write_sphere_g2o, since the package has no 3D
  generator;
- both functors against the JAX ones at seeded inputs, values and
  Jacobians to 1e-12, and both through the generator of B1 generic
  (functor_codegen.group_program, its IR against torch.func to 1e-12; the
  3D group with the EigenQuaternion plus-Jacobian of its two quaternion
  positions fused in);
- LM solves of both graphs on SPARSE_NORMAL_CHOLESKY and of the 2D graph on
  CGNR (as tests/test_pose_graph.py) against ceres_tpu.solve: per-iteration
  cost to 1e-10 relative, equal PCG counts and decisions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.examples import pose_graph as jpg
from ceres_tpu_torch import functor_codegen
from ceres_tpu_torch.evaluator import Evaluator, group_eval_plain, state_tables
from ceres_tpu_torch.examples import pose_graph as tpg
from chip_smoke import _quat_xyzw, write_sphere_g2o

torch.set_num_threads(1)
F64 = torch.float64


def write_g2o_2d(path, g):
    with open(path, "w") as f:
        for i, p in enumerate(g.poses):
            f.write(f"VERTEX_SE2 {i} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
        for e, m, si in zip(g.edges_ij, g.measurements, g.sqrt_informations):
            info = si.T @ si
            f.write(
                f"EDGE_SE2 {e[0]} {e[1]} {m[0]:.17g} {m[1]:.17g} {m[2]:.17g} "
                + " ".join(f"{info[i, j]:.17g}" for i, j in zip(*np.triu_indices(3))) + "\n"
            )


@pytest.fixture(scope="module")
def g2o_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("g2o")
    g, _ = jpg.synthetic_pose_graph_2d(n=12, noise=0.05, seed=2)
    write_g2o_2d(d / "g2d.g2o", g)
    write_sphere_g2o(d / "g3d.g2o", rings=4, per_ring=6, seed=0)
    return d


def test_synthetic_2d_matches_jax():
    jg, jt = jpg.synthetic_pose_graph_2d(n=20, noise=0.05, seed=3)
    tg, tt = tpg.synthetic_pose_graph_2d(n=20, noise=0.05, seed=3)
    for f in ("poses", "edges_ij", "measurements", "sqrt_informations"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_load_g2o_matches_jax(g2o_files, dim):
    j = getattr(jpg, f"load_g2o_{dim}")(g2o_files / f"g{dim}.g2o")
    t = getattr(tpg, f"load_g2o_{dim}")(g2o_files / f"g{dim}.g2o")
    for f in j.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    if dim == "3d":
        assert len(t.positions) == 24 and len(t.edges_ij) == 23 + 18


def _functor_inputs(dim, rng):
    if dim == "2d":
        params = (rng.normal(size=3), rng.normal(size=3))
        data = (rng.normal(size=3), np.triu(rng.normal(size=(3, 3))) + 3 * np.eye(3))
    else:
        params = (rng.normal(size=3), _quat_xyzw(rng.normal(size=(1, 3)))[0],
                  rng.normal(size=3), _quat_xyzw(rng.normal(size=(1, 3)))[0])
        data = (rng.normal(size=3), _quat_xyzw(rng.normal(size=(1, 3)))[0],
                np.triu(rng.normal(size=(6, 6))) + 3 * np.eye(6))
    return params, data


@pytest.mark.parametrize("dim", ["2d", "3d"])
@pytest.mark.parametrize("seed", [0, 1])
def test_functor_matches_jax(dim, seed):
    """Values and Jacobians at seeded inputs (angles beyond pi included, so
    normalize_angle's floor wraps), the port's functor also on the
    flattened square-root information its builder stores."""
    params, data = _functor_inputs(dim, np.random.default_rng(seed))
    if dim == "2d":
        params[1][2] += 7.0
    jfn = getattr(jpg, f"pose_graph_{dim}_residual")
    tfn = getattr(tpg, f"pose_graph_{dim}_residual")
    jd = tuple(jnp.asarray(d) for d in data)
    want = np.asarray(jfn(tuple(jnp.asarray(p) for p in params), jd))
    want_j = jax.jacfwd(lambda *ps: jfn(ps, jd), argnums=tuple(range(len(params))))(
        *(jnp.asarray(p) for p in params))
    for flat in (False, True):
        td = tuple(torch.tensor(d) for d in data)
        if flat:
            td = td[:-1] + (td[-1].reshape(-1),)
        got = tfn(tuple(torch.tensor(p) for p in params), td)
        got_j = torch.func.jacfwd(lambda *ps: tfn(ps, td), argnums=tuple(range(len(params))))(
            *(torch.tensor(p) for p in params))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
        for a, b in zip(got_j, want_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


def _port_graph(dim, g2o_files):
    if dim == "2d":
        return tpg.build_pose_graph_2d_problem(tpg.load_g2o_2d(g2o_files / "g2d.g2o"))[0]
    return tpg.build_pose_graph_3d_problem(tpg.load_g2o_3d(g2o_files / "g3d.g2o"))[0]


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_functors_trace_through_the_generator(g2o_files, dim):
    """On a card the graphs' groups take B1 generic: the generator traces
    them (a group it cannot trace would take torch.func without a word),
    and its IR equals torch.func's values and Jacobians."""
    program = _port_graph(dim, g2o_files).compile("cpu")
    ev = Evaluator(program, F64)
    meta, garr = program.groups[0], ev.arrays["groups"][0]
    prog = functor_codegen.group_program(meta, garr, F64, False)
    assert prog is not None
    st = state_tables(program, program.state_vector(F64))
    _, res, jacs = group_eval_plain(meta, garr, st, True, False)
    tables = [st[pm.a_cls] for pm in meta.positions]
    for b in range(meta.n):
        params = [t[r[b]].numpy() for t, r in zip(tables, garr["a_rows"])]
        r_ir, j_ir, _ = functor_codegen.run_ir(prog, params, [d[b].numpy() for d in garr["data"]])
        np.testing.assert_allclose(r_ir, res[:, b].numpy(), rtol=1e-12, atol=1e-12)
        off = 0
        for p, t in enumerate(prog.tangents):
            want = jacs[p][:, b].numpy().reshape(prog.r, t)
            np.testing.assert_allclose(j_ir[:, off:off + t], want, rtol=1e-12, atol=1e-12)
            off += t
    if dim == "3d":
        assert [pj is not None for pj in prog.plus_jacobians] == [False, True, False, True]
        assert prog.num_tangent == 12


def _jax_graph(dim, g2o_files):
    if dim == "2d":
        return jpg.build_pose_graph_2d_problem(jpg.load_g2o_2d(g2o_files / "g2d.g2o"))[0]
    return jpg.build_pose_graph_3d_problem(jpg.load_g2o_3d(g2o_files / "g3d.g2o"))[0]


SOLVES = {
    # case: (graph, linear solver, preconditioner, LM iterations)
    "2d-sparse_normal_cholesky": ("2d", "SPARSE_NORMAL_CHOLESKY", "JACOBI", 5),
    "3d-sparse_normal_cholesky": ("3d", "SPARSE_NORMAL_CHOLESKY", "JACOBI", 5),
    "2d-cgnr": ("2d", "CGNR", "JACOBI", 5),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_matches_jax_per_iteration(g2o_files, case):
    dim, solver, precond, iters = SOLVES[case]
    sums = []
    for pkg, build, extra in ((ceres_tpu, _jax_graph, {}), (ct, _port_graph, {"device": "cpu"})):
        options = pkg.SolverOptions(
            linear_solver_type=getattr(pkg.LinearSolverType, solver),
            preconditioner_type=getattr(pkg.PreconditionerType, precond),
            max_num_iterations=iters, function_tolerance=0.0, gradient_tolerance=0.0,
            parameter_tolerance=0.0, **extra)
        sums.append(pkg.solve(options, build(dim, g2o_files)))
    js, ts = sums
    assert ts.used_fused_execution == js.used_fused_execution == (solver == "CGNR")
    assert len(ts.iterations) == len(js.iterations) == iters + 1
    for a, b in zip(ts.iterations, js.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-10)
        assert a.trust_region_radius == pytest.approx(b.trust_region_radius, rel=1e-10)
        assert (a.linear_solver_iterations, a.step_is_successful) == (
            b.linear_solver_iterations, b.step_is_successful)
    assert ts.final_cost < 1e-2 * ts.initial_cost


def test_pose_graph_2d_recovers_the_trajectory():
    """tests/test_pose_graph.py's recovery test on SPARSE_NORMAL_CHOLESKY."""
    g, truth = tpg.synthetic_pose_graph_2d(n=24, noise=0.01, seed=1)
    problem, ids = tpg.build_pose_graph_2d_problem(g)
    s = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY, max_num_iterations=50,
        device="cpu"), problem)
    assert s.termination_type == ct.TerminationType.CONVERGENCE, s.message
    est = np.stack([problem.parameter_block_value(i) for i in ids])
    assert np.linalg.norm(est[:, :2] - truth[:, :2], axis=1).mean() < 0.2
    assert np.abs(tpg.normalize_angle_np(est[:, 2] - truth[:, 2])).mean() < 0.05
