"""Fields-of-Experts denoising in the port against ceres_tpu.

The reference's trained filters (data/{2x2,3x3,5x5}.foe) and its noisy
image are not in this repository, so the problems here use synthetic
priors of the published shapes (examples/denoising.synthetic_foe_model:
zero-mean taps, alphas in [0.5, 2]) on a synthetic piecewise-smooth image
with Gaussian noise, both from numpy seeds and carried into both packages
(`interop.foe_model`). Held:
- the LM + CGNR + JACOBI solve (PCG <= 10 steps) of a 24 x 20 image (3x3
  cliques, K = 3; and 5x5, K = 2) per iteration against ceres_tpu's in
  float64: cost to 1e-10, radius, PCG counts and decisions, on the fused
  loop and the host loop;
- the problem's structure (groups, residuals, clique tables) and its
  initial cost, residuals and gradient against ceres_tpu's;
- FieldsOfExpertsLoss: rho against ceres_tpu's, rho1 and rho2 against
  autograd's derivatives of rho0;
- the PGM writer and reader (P2 and P5) round trip, against ceres_tpu's
  reader; `load_foe_file` on a file the test writes, against ceres_tpu's,
  and its refusal of a malformed file."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.evaluator import evaluate as j_evaluate
from ceres_tpu.examples import denoising as jdn
from ceres_tpu_torch import interop
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.examples import denoising as tdn

torch.set_num_threads(1)
F64 = torch.float64


def _jfoe(foe):
    return jdn.FoEModel(**{f: getattr(foe, f) for f in
                           ("size", "x_deltas", "y_deltas", "alphas", "filters")})


def _problems(size, k, seed=0, h=24, w=20):
    foe = tdn.synthetic_foe_model(size, k, seed=seed)
    img = tdn.synthetic_noisy_image(h, w, sigma=20.0, seed=seed)
    jfoe = _jfoe(foe)
    jp, jpx = jdn.build_foe_denoising_problem(img, jfoe, sigma=20.0)
    tp, tpx = tdn.build_foe_denoising_problem(img, interop.foe_model(jfoe), sigma=20.0)
    return jp, tp, img


def _options(pkg, **kw):
    # PCG <= 10 steps: a Fields-of-Experts prior leaves the normal equations
    # ill-conditioned even under JACOBI, and PCG run to a 25-step cap
    # amplifies the two packages' different summation orders (index_add_
    # against segment_sum) to 5e-11..1.2e-7 of the cost by iteration 3 on
    # this image (three seeds); at 10 steps they agree to ~2e-15
    base = dict(
        linear_solver_type=pkg.LinearSolverType.CGNR,
        preconditioner_type=pkg.PreconditionerType.JACOBI,
        max_num_iterations=5, eta=0.1, max_linear_solver_iterations=10,
        function_tolerance=0.0, gradient_tolerance=0.0, parameter_tolerance=0.0,
    )
    return pkg.SolverOptions(**{**base, **kw})


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
@pytest.mark.parametrize("size,k", [(3, 3), (5, 2)], ids=["3x3", "5x5"])
def test_foe_cgnr_solve_matches_jax_per_iteration(size, k, fused):
    jp, tp, _ = _problems(size, k)
    js = ceres_tpu.solve(_options(ceres_tpu, fused_execution=fused), jp)
    ts = ct.solve(_options(ct, device="cpu", fused_execution=fused), tp)
    assert ts.used_fused_execution == js.used_fused_execution == fused
    assert len(ts.iterations) == len(js.iterations) == 6
    for a, b in zip(ts.iterations, js.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-10)
        rtol = 1e-10 + (1e-13 * b.cost / abs(b.cost_change) if b.cost_change else 0.0)
        assert a.trust_region_radius == pytest.approx(b.trust_region_radius, rel=rtol)
        assert a.linear_solver_iterations == b.linear_solver_iterations
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
    assert ts.final_cost < 0.8 * ts.initial_cost
    if fused:
        for it in ts.iterations[1:]:
            assert it.num_device_reads <= 2 + it.linear_solver_iterations


def test_foe_problem_matches_jax():
    jp, tp, img = _problems(3, 3)
    jprog, tprog = jp.compile(), tp.compile("cpu")
    h, w = img.shape
    assert len(tprog.groups) == len(jprog.groups) == 4
    assert tprog.num_residuals == jprog.num_residuals == h * w + 3 * (h - 2) * (w - 2)
    for jm, tm, jidx, tidx in zip(jprog.groups, tprog.groups, jprog.group_idx, tprog.group_idx):
        assert tm.n == jm.n and len(tm.positions) == len(jm.positions)
        for a, b in zip(tidx["a_rows"], jidx["a_rows"]):
            np.testing.assert_array_equal(a, np.asarray(b)[: jm.n])
    c1, r1, _, g1 = j_evaluate(jprog, jprog.arrays(jnp.float64), jprog.state_vector(jnp.float64))
    c2, r2, _, g2 = Evaluator(tprog, F64).evaluate_groups(tprog.state_vector(F64))
    assert float(c2) == pytest.approx(float(c1), rel=1e-13)
    for a, b in zip(r2, r1):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(g2.numpy(), np.asarray(g1), rtol=1e-12,
                               atol=1e-12 * float(jnp.abs(g1).max()))


def test_synthetic_prior_and_image():
    foe = tdn.synthetic_foe_model(5, 24, seed=1)
    assert foe.filters.shape == (24, 25) and foe.alphas.shape == (24,)
    np.testing.assert_allclose(foe.filters.mean(axis=1), 0.0, atol=1e-12)
    assert ((foe.alphas >= 0.5) & (foe.alphas <= 2.0)).all()
    assert sorted(zip(foe.y_deltas, foe.x_deltas)) == [(y, x) for y in range(5) for x in range(5)]
    img = tdn.synthetic_noisy_image(64, 48, sigma=20.0, seed=1)
    assert img.shape == (64, 48)
    clean = tdn.synthetic_noisy_image(64, 48, sigma=0.0, seed=1)
    assert clean.min() >= 0.0 and clean.max() <= 255.0
    assert np.std(img - clean) == pytest.approx(20.0, rel=0.05)
    np.testing.assert_array_equal(img, tdn.synthetic_noisy_image(64, 48, sigma=20.0, seed=1))


@pytest.mark.parametrize("alpha", [0.5, 1.7])
def test_fields_of_experts_loss_contract(alpha):
    s = torch.tensor([0.0, 0.3, 2.0, 150.0, 1e4], dtype=F64, requires_grad=True)
    rho0, rho1, rho2 = tdn.FieldsOfExpertsLoss(alpha).rho(s)
    jr = jdn.FieldsOfExpertsLoss(alpha).rho(jnp.asarray(s.detach().numpy()))
    for a, b in zip((rho0, rho1, rho2), jr):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-15)
    d1 = torch.autograd.grad(rho0.sum(), s, create_graph=True)[0]
    d2 = torch.autograd.grad(d1.sum(), s)[0]
    np.testing.assert_allclose(rho1.detach().numpy(), d1.detach().numpy(), rtol=1e-14)
    np.testing.assert_allclose(rho2.detach().numpy(), d2.numpy(), rtol=1e-14)
    assert float(rho0[0].detach()) == 0.0 and float(rho1[0].detach()) == pytest.approx(alpha / 2)


def test_pgm_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(-20.0, 280.0, (7, 5))
    p2 = tmp_path / "a.pgm"
    tdn.save_pgm(p2, img)
    want = np.clip(np.round(img), 0, 255)
    np.testing.assert_array_equal(tdn.load_pgm(p2), want)
    np.testing.assert_array_equal(tdn.load_pgm(p2), jdn.load_pgm(p2))
    # binary P5 with a comment in its header
    p5 = tmp_path / "b.pgm"
    raw = rng.integers(0, 256, (4, 6)).astype(np.uint8)
    p5.write_bytes(b"P5\n# made by the test\n6 4\n255\n" + raw.tobytes())
    np.testing.assert_array_equal(tdn.load_pgm(p5), raw.astype(np.float64))
    np.testing.assert_array_equal(tdn.load_pgm(p5), jdn.load_pgm(p5))
    bad = tmp_path / "c.pgm"
    bad.write_text("P3\n1 1\n255\n0\n")
    with pytest.raises(ValueError, match="not a PGM"):
        tdn.load_pgm(bad)


def test_load_foe_file(tmp_path):
    foe = tdn.synthetic_foe_model(3, 4, seed=2)
    lines = [f"{foe.size} {len(foe.alphas)}",
             " ".join(str(int(v)) for v in foe.x_deltas),
             " ".join(str(int(v)) for v in foe.y_deltas),
             " ".join(repr(float(v)) for v in foe.alphas)]
    lines += [" ".join(repr(float(v)) for v in row) for row in foe.filters]
    path = tmp_path / "3x3.foe"
    path.write_text("\n".join(lines) + "\n")
    got, want = tdn.load_foe_file(path), jdn.load_foe_file(path)
    for f in ("x_deltas", "y_deltas", "alphas", "filters"):
        np.testing.assert_array_equal(getattr(got, f), getattr(foe, f))
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.size == want.size == 3
    path.write_text("\n".join(lines[:-1]) + "\n")
    with pytest.raises(ValueError, match="expected"):
        tdn.load_foe_file(path)
