"""The port's robust losses against ceres_tpu.loss, and B1's loss codes.

Each loss's rho triple (rho0, rho1, rho2) is held to the JAX package's on
the same squared norms, made from a numpy seed (0, tiny, each loss's own
breakpoints, 1e-6 to 1e4 and the Tolerant loss's large-x branch), in
float64, to 1e-14 relative with an absolute floor of 1e-14: XLA contracts
some multiply-adds into FMAs, and the cancellation in rho0 near s = 0
(SoftLOne's sqrt(1 + s/b) - 1, Tolerant's b log1p(e^x) - c) lifts that
rounding above 1e-14 relative to the small rho0 there. Then each coded
loss through B1 (its plain version, here) on the angle-axis and the
quaternion group against the JAX package's evaluation, and the codes
themselves: a ScaledLoss folds into its inner loss's code, a ComposedLoss
or LossFunctionWrapper has none, so its group takes torch.func."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.evaluator import evaluate as j_evaluate
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu_torch import eval_kernel
from ceres_tpu_torch.evaluator import Evaluator

torch.set_num_threads(1)


def _pair(name, *args):
    return getattr(ceres_tpu.loss, name)(*args), getattr(ct, name)(*args)


def _both(spec):
    """(JAX loss, port loss) for a nested spec (name, args...), where an
    argument may itself be a spec or None."""
    if spec is None:
        return None, None
    name, *args = spec
    j_args, t_args = [], []
    for a in args:
        if isinstance(a, tuple) or a is None:
            ja, ta = _both(a)
            j_args.append(ja)
            t_args.append(ta)
        else:
            j_args.append(a)
            t_args.append(a)
    return getattr(ceres_tpu.loss, name)(*j_args), getattr(ct, name)(*t_args)


LOSSES = {
    "trivial": ("TrivialLoss",),
    "huber": ("HuberLoss", 1.5),
    "soft_l_one": ("SoftLOneLoss", 0.7),
    "cauchy": ("CauchyLoss", 1.3),
    "arctan": ("ArctanLoss", 2.0),
    "tolerant": ("TolerantLoss", 1.0, 0.5),
    "tukey": ("TukeyLoss", 3.0),
    "scaled": ("ScaledLoss", ("CauchyLoss", 0.5), 2.5),
    "scaled_none": ("ScaledLoss", None, 0.25),
    "composed": ("ComposedLoss", ("HuberLoss", 1.0), ("CauchyLoss", 2.0)),
    "wrapper": ("LossFunctionWrapper", ("SoftLOneLoss", 1.0)),
    "wrapper_none": ("LossFunctionWrapper", None),
}


def _squared_norms():
    rng = np.random.default_rng(0)
    return np.concatenate([
        [0.0, 1e-300, 1e-12, 0.25, 0.49, 1.0, 2.25, 9.0, 19.0, 36.0, 1e6],
        10 ** rng.uniform(-6, 4, 200),
    ])


@pytest.mark.parametrize("name", list(LOSSES))
def test_rho_matches_jax_f64(name):
    jl, tl = _both(LOSSES[name])
    s = _squared_norms()
    want = jl.rho(jnp.asarray(s))
    got = tl.rho(torch.tensor(s, dtype=torch.float64))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float64 and a.shape == s.shape, i
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14, atol=1e-14,
                                   err_msg=f"rho{i}")


def test_losses_are_value_objects():
    """Equal losses batch into one group: equality and hashing by value."""
    for spec in LOSSES.values():
        a, b = _both(spec)[1], _both(spec)[1]
        assert a == b and hash(a) == hash(b)
    w = ct.LossFunctionWrapper(ct.HuberLoss(1.0))
    w.reset(ct.CauchyLoss(1.0))
    assert w == ct.LossFunctionWrapper(ct.CauchyLoss(1.0))
    assert ct.TolerantLoss(1.0, 0.5) != ct.TolerantLoss(1.0, 0.6)


CODED = ["trivial", "huber", "soft_l_one", "cauchy", "arctan", "tolerant", "tukey", "scaled",
         "scaled_none"]


def test_loss_codes():
    kinds = {"trivial": 1, "huber": 2, "soft_l_one": 3, "cauchy": 4, "arctan": 5,
             "tolerant": 6, "tukey": 7, "scaled": 4, "scaled_none": 1}
    for name in CODED:
        kind, a, b, c, scale = eval_kernel.loss_code(_both(LOSSES[name])[1])
        assert kind == kinds[name], name
    assert eval_kernel.loss_code(None) == (0, 0.0, 0.0, 0.0, 1.0)
    assert eval_kernel.loss_code(ct.ScaledLoss(ct.CauchyLoss(0.5), 2.5)) == (4, 0.5, 0.0, 0.0, 2.5)
    assert eval_kernel.loss_code(ct.ScaledLoss(ct.ScaledLoss(None, 2.0), 3.0)) == (
        1, 0.0, 0.0, 0.0, 6.0)
    kind, a, b, c, scale = eval_kernel.loss_code(ct.TolerantLoss(1.0, 0.5))
    # the constant the kernel takes is the one TolerantLoss.rho subtracts
    s0 = ct.TolerantLoss(1.0, 0.5).rho(torch.zeros(1, dtype=torch.float64))[0]
    assert (a, b) == (1.0, 0.5) and abs(0.5 * np.log1p(np.exp(-2.0)) - c) < 1e-16
    assert abs(float(s0) - (0.5 * np.log1p(np.exp(-2.0)) - c)) < 1e-15
    for name in ("composed", "wrapper", "wrapper_none"):
        assert eval_kernel.loss_code(_both(LOSSES[name])[1]) is None, name
    assert eval_kernel.loss_code(ct.ScaledLoss(ct.ComposedLoss(ct.HuberLoss(1.0),
                                                                ct.HuberLoss(2.0)), 2.0)) is None


@pytest.mark.parametrize("camera", ["angle_axis", "quaternion"])
@pytest.mark.parametrize("name", CODED + ["composed", "wrapper"])
def test_group_under_loss_matches_jax_f64(camera, name):
    """A coded loss takes B1 (its plain version on the CPU), an uncoded one
    the torch.func path; both match the JAX package's evaluation."""
    jl, tl = _both(LOSSES[name])
    bal = synthetic_bal(5, 30, 150, seed=12, observation_noise=3.0)
    kw = {"use_quaternions": True, "use_manifolds": True} if camera == "quaternion" else {}
    jprog = j_build(bal, loss=jl, **kw)[0].compile()
    tprog = ct.build_ba_problem(bal, loss=tl, **kw)[0].compile("cpu")
    assert eval_kernel.eligible(tprog.groups[0], torch.float64, True) == (name in CODED)
    c1, r1, j1, g1 = jax.jit(lambda a, s: j_evaluate(jprog, a, s, with_jacobian=True))(
        jprog.arrays(jnp.float64), jprog.state_vector(jnp.float64))
    ev = Evaluator(tprog, torch.float64)
    c2, r2, j2, g2 = ev.evaluate_groups(tprog.state_vector(torch.float64))
    assert abs(float(c1) - float(c2)) <= 1e-12 * abs(float(c1))
    for got, want in [(r2[0], r1[0]), (g2, g1)] + list(zip(j2.jac_groups[0], j1.jac_groups[0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12 * float(jnp.max(jnp.abs(want))))
