"""The port's interpolation.py, the sampled-function example and
checkpoint.py against ceres_tpu's, in float64 on the CPU.

- CubicInterpolator and BiCubicInterpolator: values and derivatives
  (torch.func against jax.grad) at points inside and past the grid's edges,
  within 1e-12; the exactness cases of tests/test_system.py:151 (a
  quadratic in 1-D, a bilinear surface in 2-D);
- the sampled-function solve (examples/sampled_function): per-iteration
  cost against ceres_tpu's within 1e-10; its functor is not generated
  (a data-dependent index), as JAX's group_kernel refuses it;
- Checkpoint save / load / resume, the callback's periodic saves, and a
  checkpoint written by ceres_tpu resuming a port solve: the port's
  per-iteration costs equal ceres_tpu's own resumed solve's within 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu import checkpoint as jck
from ceres_tpu import interpolation as jint
from ceres_tpu.examples import denoising as jdn
from ceres_tpu.examples.test_functions import build_curve_fitting_problem as j_curve
from ceres_tpu_torch import checkpoint as tck
from ceres_tpu_torch import functor_codegen, interop
from ceres_tpu_torch import interpolation as tint
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.examples import denoising as tdn
from ceres_tpu_torch.examples.test_functions import build_curve_fitting_problem as t_curve

torch.set_num_threads(1)
RNG = np.random.default_rng(8)
F64 = torch.float64


@pytest.mark.parametrize("shape", [(12,), (12, 3)])
def test_cubic_matches_jax(shape):
    vals = RNG.normal(size=shape)
    ji, ti = jint.CubicInterpolator(vals), tint.CubicInterpolator(vals)
    for q in (-1.3, 0.0, 2.25, 5.5, 10.9, 11.0, 13.7):
        np.testing.assert_allclose(ti(torch.tensor(q, dtype=F64)).numpy(),
                                   np.asarray(ji(jnp.asarray(q))), rtol=1e-12, atol=1e-12)
        jd = jax.grad(lambda x: jnp.sum(ji(x)))(jnp.asarray(q))
        td = grad(lambda x: ti(x).sum())(torch.tensor(q, dtype=F64))
        np.testing.assert_allclose(float(td), float(jd), rtol=1e-12, atol=1e-12)
        f, df = ti.evaluate_with_derivative(q)
        jf, jdf = ji.evaluate_with_derivative(jnp.asarray(q))
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(df), float(jdf), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 2)])
def test_bicubic_matches_jax(shape):
    vals = RNG.normal(size=shape)
    ji, ti = jint.BiCubicInterpolator(vals), tint.BiCubicInterpolator(vals)
    for r, c in ((0.0, 0.0), (2.5, 3.25), (6.0, 8.0), (-0.7, 4.4), (5.9, 9.6)):
        tr, tc = torch.tensor(r, dtype=F64), torch.tensor(c, dtype=F64)
        np.testing.assert_allclose(ti(tr, tc).numpy(), np.asarray(ji(jnp.asarray(r), jnp.asarray(c))),
                                   rtol=1e-12, atol=1e-12)
        jg = jax.grad(lambda a, b: jnp.sum(ji(a, b)), argnums=(0, 1))(jnp.asarray(r), jnp.asarray(c))
        tg = grad(lambda a, b: ti(a, b).sum(), argnums=(0, 1))(tr, tc)
        np.testing.assert_allclose([float(g) for g in tg], [float(g) for g in jg], rtol=1e-12,
                                   atol=1e-12)


def test_interpolation_reproduces_polynomials():
    """tests/test_system.py:151 on the port: Catmull-Rom is exact for a
    quadratic inside the grid, bicubic for a bilinear surface."""
    xs = np.arange(10.0)
    interp = tint.CubicInterpolator(0.5 * xs ** 2 - xs + 3.0)
    for q in (2.3, 4.75, 7.5):
        np.testing.assert_allclose(float(interp(torch.tensor(q, dtype=F64))),
                                   0.5 * q ** 2 - q + 3.0, rtol=1e-12)
    g = grad(lambda q: interp(q))(torch.tensor(3.7, dtype=F64))
    np.testing.assert_allclose(float(g), 3.7 - 1.0, rtol=1e-10)
    r, c = np.meshgrid(np.arange(8.0), np.arange(9.0), indexing="ij")
    bi = tint.BiCubicInterpolator(2.0 * r - 3.0 * c + 0.5 * r * c)
    for qr, qc in ((2.5, 3.5), (4.1, 6.9)):
        np.testing.assert_allclose(float(bi(torch.tensor(qr, dtype=F64), torch.tensor(qc, dtype=F64))),
                                   2.0 * qr - 3.0 * qc + 0.5 * qr * qc, rtol=1e-10)


@pytest.mark.parametrize("x0", [1.0, 7.3])
def test_sampled_function_solve_matches_jax(x0):
    samples = (np.arange(10.0) - 4.5) ** 2  # sampled_function.cc's samples
    kw = dict(max_num_iterations=10)
    jp, jb = jdn.build_sampled_function_problem(samples, x0)
    tp, tb = tdn.build_sampled_function_problem(samples, x0)
    want = ceres_tpu.solve(ceres_tpu.SolverOptions(**kw), jp)
    got = ct.solve(ct.SolverOptions(device="cpu", **kw), tp)
    assert len(got.iterations) == len(want.iterations)
    for a, b in zip(got.iterations, want.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-10, abs=1e-20)
    np.testing.assert_allclose(tp.parameter_block_value(tb), jp.parameter_block_value(jb),
                               rtol=1e-9, atol=1e-12)
    program = tp.compile("cpu")
    assert functor_codegen.group_program(
        program.groups[0], Evaluator(program, F64).arrays["groups"][0], F64, True) is None


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "state.npz")
    p, mc = t_curve()
    cb = tck.CheckpointCallback(p, path, every=1)
    ct.solve(ct.SolverOptions(max_num_iterations=12, callbacks=[cb],
                              update_state_every_iteration=True, device="cpu"), p)
    assert np.load(path)["state"].shape == (2,)
    p2, mc2 = t_curve()
    ckpt = tck.resume_problem_from(p2, path)
    np.testing.assert_allclose(p2.parameter_block_value(mc2), p.parameter_block_value(mc))
    assert ckpt.iteration >= 1
    again = tck.Checkpoint.load(path)
    assert (again.iteration, again.cost, again.trust_region_radius) == (
        ckpt.iteration, ckpt.cost, ckpt.trust_region_radius)
    with pytest.raises(ValueError, match="parameters"):
        tck.Checkpoint(np.zeros(3), 1.0, 1, 1.0).save(path)
        tck.resume_problem_from(t_curve()[0], path)


def test_jax_checkpoint_resumes_a_port_solve(tmp_path):
    """A checkpoint written by ceres_tpu's CheckpointCallback (same keys)
    resumes a port solve: the resumed state is the checkpoint's
    (interop.state_from_numpy) and the per-iteration costs are ceres_tpu's
    own resumed solve's within 1e-10."""
    path = str(tmp_path / "jax.npz")
    jp, _ = j_curve()
    ceres_tpu.solve(ceres_tpu.SolverOptions(
        max_num_iterations=8, callbacks=[jck.CheckpointCallback(jp, path, every=1)],
        update_state_every_iteration=True), jp)
    sums = []
    for pkg, mod, build, kw in ((ceres_tpu, jck, j_curve, {}), (ct, tck, t_curve, {"device": "cpu"})):
        p, _ = build()
        ckpt = mod.resume_problem_from(p, path)
        if pkg is ct:
            program = p.compile("cpu")
            np.testing.assert_array_equal(
                program.state_vector(F64).numpy(),
                interop.state_from_numpy(program, ckpt.state).numpy())
        sums.append(pkg.solve(pkg.SolverOptions(
            max_num_iterations=6, initial_trust_region_radius=ckpt.trust_region_radius, **kw), p))
    assert sums[0].initial_cost == pytest.approx(tck.Checkpoint.load(path).cost, rel=1e-12)
    assert len(sums[0].iterations) == len(sums[1].iterations)
    for a, b in zip(sums[1].iterations, sums[0].iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-10)
