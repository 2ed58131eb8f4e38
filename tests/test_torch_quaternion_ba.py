"""The quaternion bundle adjustment of the port against ceres_tpu.

The path is `build_ba_problem(bal, loss, use_quaternions=True,
use_manifolds=...)` -> `solve`: cameras [q(4) | t(3) | f k1 k2] on
Quaternion x Euclidean(6) (tangent 9) or without a manifold (tangent 10),
evaluated by kernel B1's quaternion instantiation, whose plain version runs
here. Inputs come from numpy seeds and go to both packages. Held:
- rotation.py against ceres_tpu.rotation, float64, to 1e-14;
- the quaternion and product manifolds' plus, plus_jacobian, minus and
  minus_jacobian against ceres_tpu.manifolds, float64, to 1e-14;
- the quaternion functor and its Jacobians against JAX's, to 1e-14;
- load_bal, normalize and perturb against JAX's, exactly;
- the quaternion Program's tables against JAX's, exactly, and JAX's state
  and tables carried across by `interop`;
- B1's quaternion plain version against the JAX package's Pallas
  GroupKernel in interpret mode (CERES_TPU_PALLAS=interpret, float32, 5e-4,
  as tests/test_pallas_eval.py runs it) and against its XLA path in float64
  (1e-12);
- the LM solves per iteration on the host and the fused loop: cost to
  1e-10, equal PCG counts and step flags;
- the dispatch: an eligible quaternion group goes to the kernel's entry
  point, a ComposedLoss group to torch.func.
The CUDA kernel itself is compared with its plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu import manifolds as jman
from ceres_tpu import pallas_eval
from ceres_tpu import rotation as jrot
from ceres_tpu.evaluator import evaluate as j_evaluate
from ceres_tpu.examples.snavely import (
    snavely_reprojection_error_with_quaternions as j_quat_fn,
)
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import load_bal as j_load_bal
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch import eval_kernel, evaluator
from ceres_tpu_torch import manifolds as tman
from ceres_tpu_torch import rotation as trot
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.examples.snavely import snavely_reprojection_error_with_quaternions
from ceres_tpu_torch.interop import from_jax_program_arrays, state_from_numpy
from ceres_tpu_torch.program import Program as TProgram

torch.set_num_threads(1)
F64 = torch.float64


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def _rotations(rng, n):
    """Angle-axis vectors: zero, tiny (the small-angle branches), ordinary
    and near pi."""
    aa = rng.normal(size=(n, 3))
    aa[0] = 0.0
    aa[1] *= 1e-14
    aa[2:4] /= np.linalg.norm(aa[2:4], axis=1, keepdims=True) / (np.pi - 1e-3)
    return aa


def _quaternions(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = [1.0, 0.0, 0.0, 0.0]
    q[1] = [-0.2, 1e-13, 0.0, 0.0]
    q[1] /= np.linalg.norm(q[1])
    return q


def _matrices(rng, n):
    aa = rng.normal(size=(n, 3))
    aa[0] = [np.pi - 1e-4, 0.0, 0.0]  # trace -1: not the trace candidate
    aa[1] = [0.0, 0.0, 3.0]
    return np.stack([np.asarray(jrot.angle_axis_to_rotation_matrix(jnp.asarray(a))) for a in aa])


ROTATION_CASES = {
    # name: inputs made from rng, number of positional inputs
    "angle_axis_rotate_point": lambda rng: (_rotations(rng, 8), rng.normal(size=(8, 3))),
    "angle_axis_to_quaternion": lambda rng: (_rotations(rng, 8),),
    "quaternion_to_angle_axis": lambda rng: (_quaternions(rng, 8) * np.where(
        np.arange(8)[:, None] % 2, -1.0, 1.0),),
    "quaternion_to_rotation_matrix": lambda rng: (rng.normal(size=(8, 4)),),
    "rotation_matrix_to_quaternion": lambda rng: (_matrices(rng, 8),),
    "angle_axis_to_rotation_matrix": lambda rng: (_rotations(rng, 8),),
    "rotation_matrix_to_angle_axis": lambda rng: (_matrices(rng, 8),),
    "quaternion_product": lambda rng: (rng.normal(size=(8, 4)), rng.normal(size=(8, 4))),
    "quaternion_conjugate": lambda rng: (rng.normal(size=(8, 4)),),
    "unit_quaternion_rotate_point": lambda rng: (rng.normal(size=(8, 4)), rng.normal(size=(8, 3))),
    "quaternion_rotate_point": lambda rng: (rng.normal(size=(8, 4)), rng.normal(size=(8, 3))),
    "cross_product_matrix": lambda rng: (rng.normal(size=(8, 3)),),
    "euler_angles_to_rotation_matrix": lambda rng: (rng.uniform(-180, 180, size=(8, 3)),),
}


@pytest.mark.parametrize("name", list(ROTATION_CASES))
def test_rotation_matches_jax(name):
    args = ROTATION_CASES[name](np.random.default_rng(len(name)))
    want = jax.vmap(getattr(jrot, name))(*map(jnp.asarray, args))
    got = vmap(getattr(trot, name))(*map(_t, args))
    _close(got, want, 1e-14)


MANIFOLDS = {
    "quaternion": (jman.QuaternionManifold(), tman.QuaternionManifold(), 4),
    "eigen_quaternion": (jman.EigenQuaternionManifold(), tman.EigenQuaternionManifold(), 4),
    "quat_x_euclidean6": (
        jman.ProductManifold(jman.QuaternionManifold(), jman.EuclideanManifold(6)),
        tman.ProductManifold(tman.QuaternionManifold(), tman.EuclideanManifold(6)),
        10,
    ),
}


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_manifold_matches_jax(name):
    jm, tm, amb = MANIFOLDS[name]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, amb))
    x[:, :4] /= np.linalg.norm(x[:, :4], axis=1, keepdims=True)
    delta = rng.normal(size=(6, tm.tangent_size)) * 0.3
    delta[0] = 0.0  # exp at 0: the select's other branch
    y = np.asarray(jax.vmap(jm.plus)(jnp.asarray(x), jnp.asarray(0.1 * delta)))
    assert tm.ambient_size == jm.ambient_size and tm.tangent_size == jm.tangent_size
    for op, args in [("plus", (x, delta)), ("plus_jacobian", (x,)), ("minus", (y, x)),
                     ("minus_jacobian", (x,))]:
        want = jax.vmap(getattr(jm, op))(*map(jnp.asarray, args))
        got = vmap(getattr(tm, op))(*map(_t, args))
        _close(got, want, 1e-14)
    assert tm == MANIFOLDS[name][1] and hash(tm) == hash(MANIFOLDS[name][1])


def test_manifold_constants_follow_the_operand():
    """plus_jacobian builds its unit quaternions and zero blocks in the
    operand's dtype (and so on its device)."""
    m = tman.ProductManifold(tman.QuaternionManifold(), tman.EuclideanManifold(6))
    x = torch.ones(10, dtype=torch.float32)
    assert m.plus_jacobian(x).dtype == torch.float32
    assert m.minus_jacobian(x).shape == (9, 10)
    assert tman.QuaternionManifold() != tman.EigenQuaternionManifold()


def test_quaternion_functor_matches_jax():
    rng = np.random.default_rng(5)
    cam = rng.normal(size=(10,)) * 0.3
    cam[4:7] += [0.0, 0.0, -8.0]
    cam[7] = 500.0
    point, obs = rng.normal(size=3), rng.normal(size=2)
    want = j_quat_fn((jnp.asarray(cam), jnp.asarray(point)), (jnp.asarray(obs),))
    want_j = jax.jacfwd(lambda c, p: j_quat_fn((c, p), (jnp.asarray(obs),)), argnums=(0, 1))(
        jnp.asarray(cam), jnp.asarray(point))
    got = snavely_reprojection_error_with_quaternions((_t(cam), _t(point)), (_t(obs),))
    got_j = jacfwd(lambda c, p: snavely_reprojection_error_with_quaternions((c, p), (_t(obs),)),
                   argnums=(0, 1))(_t(cam), _t(point))
    _close(got, want, 1e-14)
    for a, b in zip(got_j, want_j):
        _close(a, b, 1e-14)


def _write_bal(path, bal):
    with open(path, "w") as f:
        f.write(f"{bal.num_cameras} {bal.num_points} {bal.num_observations}\n")
        for c, p, (x, y) in zip(bal.camera_index, bal.point_index, bal.observations):
            f.write(f"{int(c)} {int(p)} {float(x)!r} {float(y)!r}\n")
        for v in np.concatenate([bal.cameras.reshape(-1), bal.points.reshape(-1)]):
            f.write(f"{float(v)!r}\n")


def test_load_bal_normalize_perturb_match_jax(tmp_path):
    path = tmp_path / "problem-5-30-120.txt"
    _write_bal(path, synthetic_bal(5, 30, 120, seed=7))
    jb, tb = j_load_bal(path), ct.load_bal(path)
    fields = ("cameras", "points", "camera_index", "point_index", "observations")
    for name in fields:
        a, b = getattr(tb, name), getattr(jb, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    jb.normalize()
    tb.normalize()
    jb.perturb(0.01, 0.02, 0.03, seed=4)
    tb.perturb(0.01, 0.02, 0.03, seed=4)
    for name in fields:
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)


def _programs(use_manifolds, threshold, monkeypatch, seed=2, loss=("Huber", 1.0)):
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", threshold)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", threshold)
    bal = synthetic_bal(6, 50, 240, seed=seed)
    jl = getattr(ceres_tpu, loss[0] + "Loss")(*loss[1:])
    tl = getattr(ct, loss[0] + "Loss")(*loss[1:])
    jp = j_build(bal, loss=jl, use_quaternions=True, use_manifolds=use_manifolds)[0]
    tp = ct.build_ba_problem(bal, loss=tl, use_quaternions=True, use_manifolds=use_manifolds)[0]
    return jp.compile(), tp.compile("cpu")


@pytest.mark.parametrize("use_manifolds", [True, False], ids=["manifold", "no_manifold"])
@pytest.mark.parametrize("threshold", [16, 10**9], ids=["plans", "no_plans"])
def test_quaternion_program_tables_match_jax(monkeypatch, use_manifolds, threshold):
    jprog, tprog = _programs(use_manifolds, threshold, monkeypatch)
    for attr in ("x_offsets", "t_offsets", "t_row", "a_row", "t_class", "a_class",
                 "tangent_class_bases", "ambient_class_bases", "block_degree", "state0"):
        np.testing.assert_array_equal(getattr(tprog, attr), getattr(jprog, attr), err_msg=attr)
    for attr in ("tangent_class_sizes", "tangent_class_counts", "ambient_class_sizes",
                 "ambient_class_counts", "num_parameters", "num_effective_parameters"):
        assert getattr(tprog, attr) == getattr(jprog, attr), attr
    tm, jm = tprog.groups[0], jprog.groups[0]
    assert tm.positions[0].tangent_size == (9 if use_manifolds else 10)
    assert tm.red_plans == jm.red_plans and tm.owner == jm.owner
    for tpm, jpm in zip(tm.positions, jm.positions):
        assert (tpm.size, tpm.tangent_size, tpm.a_cls, tpm.t_cls) == (
            jpm.size, jpm.tangent_size, jpm.a_cls, jpm.t_cls)
        assert (tpm.manifold is None) == (jpm.manifold is None)
    for key in ("a_rows", "t_rows", "block_ids"):
        for a, b in zip(tprog.group_idx[0][key], jprog.group_idx[0][key]):
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert len(tprog.manifold_group_idx) == len(jprog.manifold_group_idx) == int(use_manifolds)
    for tg, jg in zip(tprog.manifold_group_idx, jprog.manifold_group_idx):
        assert (tg["a_cls"], tg["t_cls"]) == (jg["a_cls"], jg["t_cls"])
        for key in ("a_rows", "t_rows"):
            np.testing.assert_array_equal(tg[key], jg[key], err_msg=key)
    for a, b in zip(tprog.plus_euclid, jprog.plus_euclid):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a["t_row_map"], b["t_row_map"])
    te, tpe, tpf = tprog.compute_schur_partition()
    je, jpe, jpf = jprog.compute_schur_partition()
    np.testing.assert_array_equal(te, je)
    assert (tpe, tpf) == (jpe, jpf)
    # the JAX Program's state and tables carried across (interop)
    j_arr, t_arr = jprog.arrays(jnp.float64), tprog.arrays(F64)
    conv = from_jax_program_arrays({
        "groups": [{k: tuple(np.asarray(x) for x in j_arr["groups"][0][k])
                    for k in ("a_rows", "t_rows", "data")}],
        "manifold_groups": [{k: np.asarray(g[k]) for k in ("a_rows", "t_rows")}
                            for g in j_arr["manifold_groups"]],
    }, "cpu", F64)
    for key in ("a_rows", "t_rows", "data"):
        for a, b in zip(conv["groups"][0][key], t_arr["groups"][0][key]):
            assert a.dtype == b.dtype and torch.equal(a, b), key
    assert len(conv["manifold_groups"]) == len(t_arr["manifold_groups"])
    for a, b in zip(conv["manifold_groups"], t_arr["manifold_groups"]):
        for key in ("a_rows", "t_rows"):
            assert torch.equal(a[key], b[key]), key
    state = state_from_numpy(tprog, np.asarray(jprog.state_vector(jnp.float64)))
    assert torch.equal(state, tprog.state_vector(F64))


def _port_eval(tprog, dtype, with_jacobian):
    ev = Evaluator(tprog, dtype)
    state = tprog.state_vector(dtype)
    if with_jacobian:
        return ev.evaluate_groups(state)
    cost, res, _, _ = evaluator.evaluate(tprog, ev.arrays, state, with_jacobian=False)
    return cost, res, None, None


@pytest.mark.parametrize("use_manifolds", [True, False], ids=["manifold", "no_manifold"])
@pytest.mark.parametrize("with_jacobian", [True, False], ids=["jac", "residual_only"])
def test_plain_matches_pallas_group_kernel_f32(monkeypatch, use_manifolds, with_jacobian):
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    jprog, tprog = _programs(use_manifolds, 16, monkeypatch, seed=4)
    assert eval_kernel.eligible(tprog.groups[0], torch.float32, True)
    arrays = jprog.arrays(jnp.float32)
    assert pallas_eval.group_kernel(
        jprog.groups[0], arrays["groups"][0], jnp.float32, True, with_jacobian=with_jacobian
    ) is not None
    c1, r1, j1, g1 = jax.jit(
        lambda a, s: j_evaluate(jprog, a, s, with_jacobian=with_jacobian)
    )(arrays, jprog.state_vector(jnp.float32))
    c2, r2, j2, g2 = _port_eval(tprog, torch.float32, with_jacobian)
    tol = 5e-4
    assert abs(float(c1) - float(c2)) <= tol * (1.0 + abs(float(c1)))
    np.testing.assert_allclose(np.asarray(r2[0]), np.asarray(r1[0]), rtol=tol, atol=tol)
    if with_jacobian:
        assert j2.jac_groups[0][0].shape == (18 if use_manifolds else 20, tprog.groups[0].n)
        np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=tol,
                                   atol=tol * float(jnp.max(jnp.abs(g1))))
        for ta, tb in zip(j2.jac_groups[0], j1.jac_groups[0]):
            np.testing.assert_allclose(np.asarray(ta), np.asarray(tb), rtol=tol, atol=tol)


@pytest.mark.parametrize("use_manifolds", [True, False], ids=["manifold", "no_manifold"])
@pytest.mark.parametrize("loss", [("Huber", 1.0), ("Cauchy", 2.0), ("Trivial",)],
                         ids=["huber", "cauchy", "trivial"])
def test_plain_matches_xla_f64(monkeypatch, use_manifolds, loss):
    jprog, tprog = _programs(use_manifolds, 16, monkeypatch, seed=6, loss=loss)
    c1, r1, j1, g1 = jax.jit(lambda a, s: j_evaluate(jprog, a, s, with_jacobian=True))(
        jprog.arrays(jnp.float64), jprog.state_vector(jnp.float64))
    c2, r2, j2, g2 = _port_eval(tprog, F64, True)
    assert abs(float(c1) - float(c2)) <= 1e-12 * abs(float(c1))
    for got, want in [(r2[0], r1[0]), (g2, g1)] + list(zip(j2.jac_groups[0], j1.jac_groups[0])):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12,
                                   atol=1e-12 * float(jnp.max(jnp.abs(want))))


def test_wrapper_on_cpu_is_plain(monkeypatch):
    for use_manifolds in (True, False):
        _, tprog = _programs(use_manifolds, 16, monkeypatch)
        ev = Evaluator(tprog, F64)
        st = evaluator.state_tables(tprog, tprog.state_vector(F64))
        g = ev.arrays["groups"][0]
        cam, pt = (pm.a_cls for pm in tprog.groups[0].positions)
        args = (st[cam], g["a_rows"][0], st[pt], g["a_rows"][1], g["data"][0], ct.HuberLoss(1.0),
                True, use_manifolds)
        c1, r1, (a1, b1) = eval_kernel.snavely_quat_evaluate(*args)
        c2, r2, (a2, b2) = eval_kernel.snavely_quat_evaluate_plain(*args)
        assert torch.equal(r1, r2) and torch.equal(a1, a2) and torch.equal(b1, b2)
        assert a1.shape == (18 if use_manifolds else 20, tprog.groups[0].n)


def test_dispatch(monkeypatch):
    """An eligible quaternion group goes to the kernel's entry point; a
    ComposedLoss group (no loss code) and an EigenQuaternion camera (another
    manifold) take the torch.func path, as ceres_tpu's group_kernel returns
    None for what it cannot trace."""
    calls = []
    entry = eval_kernel.snavely_quat_evaluate

    def spy(*args, **kwargs):
        calls.append(args[-1])
        return entry(*args, **kwargs)

    monkeypatch.setattr(eval_kernel, "snavely_quat_evaluate", spy)
    bal = synthetic_bal(5, 30, 120, seed=8)
    for manifold in (True, False):
        prog = ct.build_ba_problem(bal, ct.HuberLoss(1.0), use_quaternions=True,
                                   use_manifolds=manifold)[0].compile("cpu")
        assert eval_kernel.eligible(prog.groups[0], F64, True)
        _port_eval(prog, F64, True)
        assert calls[-1] is manifold
    n_calls = len(calls)
    composed = ct.ComposedLoss(ct.CauchyLoss(2.0), ct.HuberLoss(1.0))
    prog = ct.build_ba_problem(bal, composed, use_quaternions=True,
                               use_manifolds=True)[0].compile("cpu")
    assert not eval_kernel.eligible(prog.groups[0], F64, True)
    assert eval_kernel.eligible(prog.groups[0], F64, False)  # loss not applied
    _port_eval(prog, F64, True)
    assert len(calls) == n_calls
    meta = prog.groups[0]
    meta.loss = ct.HuberLoss(1.0)
    assert eval_kernel.eligible(meta, F64, True)
    eigen = tman.ProductManifold(tman.EigenQuaternionManifold(), tman.EuclideanManifold(6))
    meta.positions = [dataclasses.replace(meta.positions[0], manifold=eigen)] + list(
        meta.positions[1:])
    assert not eval_kernel.eligible(meta, F64, True)


# (manifold, preconditioner, loss, plans threshold): every value of each
# factor meets every value of the others at least once
SOLVE_CASES = [
    (True, "SCHUR_JACOBI", "Huber", 16),
    (True, "JACOBI", "Cauchy", 16),
    (False, "SCHUR_JACOBI", "Cauchy", 16),
    (False, "JACOBI", "Huber", 10**9),
]


@pytest.mark.parametrize(
    "case,fused",
    [(c, f) for f in (False, True) for c in SOLVE_CASES],
    ids=[f"{'manifold' if c[0] else 'no_manifold'}-{c[1]}-{c[2]}{'-fused' if f else ''}"
         for f in (False, True) for c in SOLVE_CASES],
)
def test_lm_solve_matches_jax_per_iteration(monkeypatch, case, fused):
    use_manifolds, precond, loss, threshold = case
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", threshold)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", threshold)
    bal = synthetic_bal(8, 60, 300, seed=3, perturb_points=0.05)
    jp = j_build(bal, getattr(ceres_tpu, loss + "Loss")(1.0), use_quaternions=True,
                 use_manifolds=use_manifolds)[0]
    tp = ct.build_ba_problem(bal, getattr(ct, loss + "Loss")(1.0), use_quaternions=True,
                             use_manifolds=use_manifolds)[0]

    def options(pkg, **kw):
        return pkg.SolverOptions(
            linear_solver_type=pkg.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=getattr(pkg.PreconditionerType, precond),
            max_num_iterations=5, eta=0.1, max_linear_solver_iterations=25,
            function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
            fused_execution=fused, **kw)

    js = ceres_tpu.solve(options(ceres_tpu), jp)
    ts = ct.solve(options(ct, device="cpu"), tp)
    assert js.used_fused_execution == ts.used_fused_execution == fused
    assert len(ts.iterations) == len(js.iterations) == 6
    for a, b in zip(ts.iterations, js.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-10)
        assert a.linear_solver_iterations == b.linear_solver_iterations
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-10)
    assert ts.final_cost < ts.initial_cost
