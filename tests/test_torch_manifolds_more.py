"""The manifolds beyond the Euclidean, quaternion and product ones
(SubsetManifold, SphereManifold, LineManifold, AutoDiffManifold,
check_manifold_invariants) against ceres_tpu's, in float64 on the CPU: the parametrised cases of tests/test_manifolds.py on
the port (Plus of zero, the plus-Jacobian against central differences,
Minus after Plus, vmap, the sphere's radius, the subset's constants,
AutoDiffManifold against the explicit Jacobian, the invariants and their
bad-manifold case); plus, minus, plus_jacobian and minus_jacobian against
JAX within 1e-12; and a bundle adjustment with the cameras' distortion
held constant on a SubsetManifold (libmv_bundle_adjuster's use), solved by
both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu import manifolds as jm
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu_torch import manifolds as tm

torch.set_num_threads(1)
RNG = np.random.default_rng(5)

# (name, port manifold, JAX manifold)
CASES = {
    "subset": (tm.SubsetManifold(4, (1, 3)), jm.SubsetManifold(4, (1, 3))),
    "subset_first_last": (tm.SubsetManifold(5, (0, 4)), jm.SubsetManifold(5, (0, 4))),
    "sphere": (tm.SphereManifold(4), jm.SphereManifold(4)),
    "sphere3": (tm.SphereManifold(3), jm.SphereManifold(3)),
    "line": (tm.LineManifold(3), jm.LineManifold(3)),
    "product_sphere_subset": (
        tm.ProductManifold(tm.SphereManifold(3), tm.SubsetManifold(3, (2,))),
        jm.ProductManifold(jm.SphereManifold(3), jm.SubsetManifold(3, (2,)))),
}


def random_point(m, rng=RNG):
    if isinstance(m, tm.ProductManifold):
        return np.concatenate([random_point(f, rng) for f in m.manifolds])
    x = rng.standard_normal(m.ambient_size)
    if isinstance(m, tm.SphereManifold):
        x /= np.linalg.norm(x)
    if isinstance(m, tm.LineManifold):
        x[m.size:] /= np.linalg.norm(x[m.size:])
    return x


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float64))


@pytest.mark.parametrize("case", list(CASES))
def test_plus_zero_is_identity(case):
    m = CASES[case][0]
    x = random_point(m)
    np.testing.assert_allclose(m.plus(_t(x), torch.zeros(m.tangent_size, dtype=torch.float64)),
                               x, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_plus_jacobian_matches_fd(case):
    m = CASES[case][0]
    x = _t(random_point(m))
    jac = m.plus_jacobian(x).numpy()
    assert jac.shape == (m.ambient_size, m.tangent_size)
    eps = 1e-7
    for j in range(m.tangent_size):
        d = torch.zeros(m.tangent_size, dtype=torch.float64)
        d[j] = eps
        fd = (m.plus(x, d) - m.plus(x, -d)).numpy() / (2 * eps)
        np.testing.assert_allclose(jac[:, j], fd, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_minus_plus_roundtrip(case):
    m = CASES[case][0]
    x = _t(random_point(m))
    delta = _t(0.1 * RNG.standard_normal(m.tangent_size))
    np.testing.assert_allclose(m.minus(m.plus(x, delta), x), delta, atol=1e-9)


@pytest.mark.parametrize("case", list(CASES))
def test_plus_vmaps(case):
    m = CASES[case][0]
    xs = _t(np.stack([random_point(m) for _ in range(5)]))
    ds = _t(0.05 * RNG.standard_normal((5, m.tangent_size)))
    ys = vmap(m.plus)(xs, ds)
    pj = vmap(m.plus_jacobian)(xs)
    for i in range(5):
        np.testing.assert_allclose(ys[i], m.plus(xs[i], ds[i]), atol=1e-12)
        np.testing.assert_allclose(pj[i], m.plus_jacobian(xs[i]), atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_operations_match_jax(case):
    """plus, minus and both Jacobians against ceres_tpu's within 1e-12."""
    tm_, jm_ = CASES[case]
    rng = np.random.default_rng(11)
    for _ in range(3):
        x = random_point(tm_, rng)
        d = 0.3 * rng.standard_normal(tm_.tangent_size)
        y = np.asarray(jm_.plus(jnp.asarray(x), jnp.asarray(d)))
        np.testing.assert_allclose(tm_.plus(_t(x), _t(d)).numpy(), y, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tm_.minus(_t(y), _t(x)).numpy(),
                                   np.asarray(jm_.minus(jnp.asarray(y), jnp.asarray(x))),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tm_.plus_jacobian(_t(x)).numpy(),
                                   np.asarray(jm_.plus_jacobian(jnp.asarray(x))),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tm_.minus_jacobian(_t(x)).numpy(),
                                   np.asarray(jm_.minus_jacobian(jnp.asarray(x))),
                                   rtol=1e-12, atol=1e-12)
    assert (tm_.ambient_size, tm_.tangent_size) == (jm_.ambient_size, jm_.tangent_size)


def test_sphere_plus_keeps_radius():
    m = tm.SphereManifold(5)
    x = _t(2.5 * random_point(m))
    y = m.plus(x, _t(0.3 * RNG.standard_normal(4)))
    np.testing.assert_allclose(torch.linalg.norm(y), torch.linalg.norm(x), atol=1e-10)


def test_sphere_minus_of_the_antipode():
    """Minus at the antipode takes the [0.., pi] branch, as JAX's."""
    tm_, jm_ = tm.SphereManifold(3), jm.SphereManifold(3)
    x = np.array([0.0, 0.0, 1.0])
    np.testing.assert_allclose(tm_.minus(_t(-x), _t(x)).numpy(),
                               np.asarray(jm_.minus(jnp.asarray(-x), jnp.asarray(x))), atol=1e-12)


def test_subset_manifold_holds_constants():
    m = tm.SubsetManifold(4, (1, 3))
    y = m.plus(_t([1.0, 2.0, 3.0, 4.0]), _t([0.5, -0.5]))
    np.testing.assert_allclose(y, [1.5, 2.0, 2.5, 4.0], atol=1e-12)
    np.testing.assert_allclose(m.apply_plus_jacobian(torch.eye(4, dtype=torch.float64)[:2],
                                                     _t(np.zeros(4))),
                               [[1.0, 0.0], [0.0, 0.0]])
    with pytest.raises(ValueError, match="out of range"):
        tm.SubsetManifold(3, (3,))


def test_autodiff_manifold_matches_explicit():
    m = tm.AutoDiffManifold(lambda x, d: x + d ** 1, lambda y, x: y - x, 3, 3)
    x = _t([1.0, 2.0, 3.0])
    np.testing.assert_allclose(m.plus_jacobian(x), np.eye(3), atol=1e-12)
    np.testing.assert_allclose(m.minus_jacobian(x), np.eye(3), atol=1e-12)
    assert m == tm.AutoDiffManifold(m._plus_fn, m._minus_fn, 3, 3)
    assert hash(m) == hash(tm.AutoDiffManifold(m._plus_fn, m._minus_fn, 3, 3))


@pytest.mark.parametrize("case", list(CASES))
def test_check_manifold_invariants(case):
    m = CASES[case][0]
    rng = np.random.default_rng(7)
    tm.check_manifold_invariants(m, random_point(m, rng),
                                 0.2 * rng.standard_normal(m.tangent_size), tol=1e-8)


def test_check_manifold_invariants_catches_bad_manifold():
    m = tm.AutoDiffManifold(lambda x, d: x + 2.0 * d, lambda y, x: y - x, 3, 3)
    with pytest.raises(AssertionError, match="MinusPlusIsIdentity"):
        tm.check_manifold_invariants(m, [1.0, 2.0, 3.0], [0.1, 0.2, 0.3])


# ---- a BA with the cameras' distortion held constant -------------------- #

def _subset_ba(pkg, bal):
    p = pkg.Problem()
    cams = p.add_parameter_blocks(bal.cameras, manifold=pkg.SubsetManifold(9, (7, 8)))
    pts = p.add_parameter_blocks(bal.points)
    if pkg is ceres_tpu:
        from ceres_tpu.examples.snavely import snavely_reprojection_error as fn
    else:
        from ceres_tpu_torch.examples.snavely import snavely_reprojection_error as fn
    p.add_residual_blocks(pkg.CostFunction(fn, 2), pkg.HuberLoss(1.0),
                          np.stack([cams[bal.camera_index], pts[bal.point_index]], axis=1),
                          (bal.observations,))
    return p, cams


def test_subset_manifold_ba_matches_jax():
    """Per-iteration cost within 1e-10 and the distortion coefficients
    unchanged, on both packages (ITERATIVE_SCHUR + JACOBI, host loop and
    fused loop on the port)."""
    bal = synthetic_bal(5, 30, 120, seed=4)
    kw = dict(max_num_iterations=4, function_tolerance=0.0, gradient_tolerance=0.0,
              parameter_tolerance=0.0)
    jp, jcams = _subset_ba(ceres_tpu, bal)
    want = ceres_tpu.solve(ceres_tpu.SolverOptions(
        linear_solver_type=ceres_tpu.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ceres_tpu.PreconditionerType.JACOBI, **kw), jp)
    for fused in (True, False):
        tp, tcams = _subset_ba(ct, bal)
        got = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.JACOBI, fused_execution=fused,
            device="cpu", **kw), tp)
        assert got.used_fused_execution is fused
        for a, b in zip(got.iterations, want.iterations, strict=True):
            assert a.cost == pytest.approx(b.cost, rel=1e-10)
            assert a.linear_solver_iterations == b.linear_solver_iterations
        for h, jh, c in zip(tcams, jcams, bal.cameras):
            v = np.asarray(tp.parameter_block_value(h))
            np.testing.assert_array_equal(v[7:], c[7:])
            np.testing.assert_allclose(v, np.asarray(jp.parameter_block_value(jh)), rtol=1e-8,
                                       atol=1e-10)


GENERATED = {
    "sphere": lambda: tm.SphereManifold(4),
    "line": lambda: tm.LineManifold(3),
    "autodiff": lambda: tm.AutoDiffManifold(lambda x, d: x + d, lambda y, x: y - x, 4, 4),
    # a plus whose Jacobian depends on x: jacfwd's trace holds dead shape
    # checks on meta tensors, which the generator drops
    "autodiff_scaled": lambda: tm.AutoDiffManifold(
        lambda x, d: x + d * torch.exp(0.1 * x), lambda y, x: (y - x) * torch.exp(-0.1 * x), 4, 4),
    "subset": lambda: tm.SubsetManifold(4, (1,)),
}


@pytest.mark.parametrize("case", list(GENERATED))
def test_generated_manifold_group_matches_torch_func(case):
    """B1 generic's generator traces each of these manifolds' plus-Jacobian
    (ceres_tpu's group_kernel refuses Sphere and Line, so there the JAX
    package runs XLA; both paths give the exact Jacobian): its IR, run with
    the kernel's dual-number rules, against the torch.func path at 1e-12."""
    from ceres_tpu_torch import evaluator, functor_codegen
    from ceres_tpu_torch.evaluator import Evaluator, state_tables

    m = GENERATED[case]()
    rng = np.random.default_rng(2)
    p = ct.Problem()
    x = np.stack([random_point(m, rng) if not isinstance(m, tm.AutoDiffManifold)
                  else rng.normal(size=4) for _ in range(5)])
    b = p.add_parameter_blocks(x, manifold=m)

    def fn(params, data):
        (q,) = params
        return torch.sin(q) * data[0][0] + q[0] * q

    p.add_residual_blocks(ct.CostFunction(fn, m.ambient_size), None, b[:, None],
                          (rng.normal(size=(5, 1)),))
    program = p.compile("cpu")
    ev = Evaluator(program, torch.float64)
    meta, garr = program.groups[0], ev.arrays["groups"][0]
    prog = functor_codegen.group_program(meta, garr, torch.float64, True)
    assert prog is not None and prog.plus_jacobians[0] is not None
    st = state_tables(program, program.state_vector(torch.float64))
    _, res, jacs = evaluator.group_eval_plain(meta, garr, st, True, False)
    rows = garr["a_rows"][0]
    for k in range(5):
        r_ir, j_ir, _ = functor_codegen.run_ir(prog, [st[0][rows[k]].numpy()],
                                               [garr["data"][0][k].numpy()])
        np.testing.assert_allclose(r_ir, res[:, k].numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(j_ir, jacs[0][:, k].numpy().reshape(m.ambient_size, -1),
                                   rtol=1e-12, atol=1e-12)
