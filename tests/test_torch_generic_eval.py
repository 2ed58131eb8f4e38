"""B1's generic instantiation: the functor -> CUDA generator
(functor_codegen.py) and its plain version against torch.func and
ceres_tpu.

Held here, on the CPU:
- the generator's IR, evaluated in float64 by `run_ir` with the dual-number
  rules of csrc/eval_generic.cuh, against the torch.func path
  (evaluator.evaluate_batch) at 1e-12: residuals, tangent-space Jacobians
  and the traced rho, on the Fields-of-Experts 3x3 and 5x5 cliques, the
  data term, Powell's four functors, the curve fit, the Snavely functor
  under a ComposedLoss, the quaternion camera on its manifold under a
  LossFunctionWrapper, and a functor made of the rules most likely to go
  wrong (sqrt at 0, atan2, integer powers, where selecting whole Jets,
  clamp, maximum, abs, a matrix product, cat, index_put);
- the port's plain version against ceres_tpu's Pallas GroupKernel in
  interpret mode (CERES_TPU_PALLAS=interpret, float32, 5e-4, as
  tests/test_pallas_eval.py runs it);
- the eligibility of a table of functors against ceres_tpu's group_kernel
  (None or not, float32 for both: JAX's kernel is float32 only);
- the dispatch: on the CPU no group is traced and every group takes the
  torch.func path, which `generic_evaluate` runs as its plain version on
  CPU tensors; the K filter groups of a prior share one source, and an
  ineligible functor has no program.
The CUDA kernel itself is held to its plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu import pallas_eval
from ceres_tpu.autodiff import CostFunction as JCostFunction
from ceres_tpu.evaluator import evaluate as j_evaluate
from ceres_tpu.examples import denoising as jdn
from ceres_tpu.examples import test_functions as jtf
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu_torch import eval_kernel, evaluator, functor_codegen, interop
from ceres_tpu_torch.evaluator import Evaluator, state_tables
from ceres_tpu_torch.examples import denoising as tdn
from ceres_tpu_torch.examples import test_functions as ttf

torch.set_num_threads(1)
F64 = torch.float64


def _foe(size, k, seed):
    return tdn.synthetic_foe_model(size, k, seed=seed)


def _jfoe(foe):
    return jdn.FoEModel(**{f: getattr(foe, f) for f in
                           ("size", "x_deltas", "y_deltas", "alphas", "filters")})


def _rules(params, data):
    """The dual-number rules most likely to go wrong, in one functor."""
    (x,) = params
    (w,) = data
    a = torch.atan2(x[0], x[1])
    b = x[2] ** 3 + x[0] ** 2 * x[1] ** -2 + x[1] ** 0.5
    sel = torch.where(x[:2] > 0.5, x[1:3] * x[0], torch.exp(x[2:4]))
    r = torch.sqrt(x[3] * x[3])  # sqrt at 0: x[3] = 0 in the data below
    m = x[:2].reshape(1, 2) @ torch.stack([x[2:4], w]).T
    c = torch.clamp(x[0], 0.1, 0.9) + torch.maximum(x[1], x[2]) + x[2].abs()
    z = torch.zeros_like(x[:3])
    z[1] = x[0] * w[0]
    return torch.cat([torch.stack([a, b, r, c]), sel, m.reshape(-1), z[1:]])


def _rules_problem():
    rng = np.random.default_rng(9)
    p = ct.Problem()
    x = rng.uniform(0.2, 1.0, size=(6, 4))
    x[:, 3] = 0.0
    blocks = p.add_parameter_blocks(x)
    p.add_residual_blocks(ct.CostFunction(_rules, 10, name="rules"), ct.CauchyLoss(2.0),
                          blocks[:, None], (rng.normal(size=(6, 2)),))
    return p


def _port_problems():
    bal = synthetic_bal(5, 30, 90, seed=4)
    img = tdn.synthetic_noisy_image(9, 8, seed=3)
    return {
        "foe3": tdn.build_foe_denoising_problem(img, _foe(3, 2, 1))[0],
        "foe5": tdn.build_foe_denoising_problem(img, _foe(5, 1, 2))[0],
        "powell": ttf.build_powell_problem()[0],
        "curve": ttf.build_curve_fitting_problem(m0=0.1, c0=0.2)[0],
        "snavely_composed": ct.build_ba_problem(
            bal, loss=ct.ComposedLoss(ct.CauchyLoss(2.0), ct.HuberLoss(1.0)))[0],
        "quaternion_manifold": ct.build_ba_problem(
            bal, loss=ct.LossFunctionWrapper(ct.TolerantLoss(1.0, 2.0)), use_quaternions=True,
            use_manifolds=True)[0],
        "rules": _rules_problem(),
    }


def _group_ir_against_torch_func(meta, garr, st, blocks=12):
    prog = functor_codegen.group_program(meta, garr, F64, True)
    assert prog is not None, meta.cost_function.name
    tables = [st[pm.a_cls] for pm in meta.positions]
    _, res, jacs = evaluator.group_eval_plain(meta, garr, st, True, False)
    for b in range(min(meta.n, blocks)):
        params = [t[r[b]].numpy() for t, r in zip(tables, garr["a_rows"])]
        data = [d[b].numpy() for d in garr["data"]]
        r_ir, j_ir, rho = functor_codegen.run_ir(prog, params, data)
        want_r = res[:, b].numpy()
        np.testing.assert_allclose(r_ir, want_r, rtol=1e-12,
                                   atol=1e-12 * max(1.0, np.abs(want_r).max()))
        off = 0
        for p, t in enumerate(prog.tangents):
            want = jacs[p][:, b].numpy().reshape(prog.r, t)
            scale = max(1.0, np.nanmax(np.abs(want), initial=0.0))
            np.testing.assert_allclose(j_ir[:, off:off + t], want, rtol=1e-12,
                                       atol=1e-12 * scale, equal_nan=True)
            off += t
        if meta.loss is not None:
            want = [float(v) for v in meta.loss.rho(torch.tensor(float((r_ir ** 2).sum()), dtype=F64))]
            np.testing.assert_allclose(rho, want, rtol=1e-12, atol=1e-300)
    r_only, _, _ = functor_codegen.run_ir(prog, params, data, with_jacobian=False)
    np.testing.assert_array_equal(r_only, r_ir)
    return prog


@pytest.mark.parametrize("case", ["foe3", "foe5", "powell", "curve", "snavely_composed",
                                  "quaternion_manifold", "rules"])
def test_generated_ir_matches_torch_func(case):
    program = _port_problems()[case].compile("cpu")
    ev = Evaluator(program, F64)
    st = state_tables(program, program.state_vector(F64))
    progs = [_group_ir_against_torch_func(m, g, st)
             for m, g in zip(program.groups, ev.arrays["groups"])]
    if case == "rules":
        # sqrt at 0 gives NaN columns in both; everything else is finite
        _, j, _ = functor_codegen.run_ir(
            progs[0], [st[0][0].numpy()], [ev.arrays["groups"][0]["data"][0][0].numpy()])
        assert np.isnan(j[2]).all() and np.isfinite(np.delete(j, 2, axis=0)).all()
    if case == "quaternion_manifold":
        assert progs[0].plus_jacobians[0] is not None and progs[0].num_tangent == 12


def _jax_problems():
    bal = synthetic_bal(5, 30, 90, seed=4)
    img = tdn.synthetic_noisy_image(9, 8, seed=3)
    data = jtf.make_curve_fitting_data(seed=5)
    return {
        "foe3": (jdn.build_foe_denoising_problem(img, _jfoe(_foe(3, 2, 1)))[0],
                 tdn.build_foe_denoising_problem(img, interop.foe_model(_jfoe(_foe(3, 2, 1))))[0]),
        "powell": (jtf.build_powell_problem()[0], ttf.build_powell_problem()[0]),
        "curve": (jtf.build_curve_fitting_problem(data, m0=0.1, c0=0.2)[0],
                  ttf.build_curve_fitting_problem(data, m0=0.1, c0=0.2)[0]),
        "snavely_composed": (
            j_build(bal, loss=ceres_tpu.ComposedLoss(ceres_tpu.CauchyLoss(2.0),
                                                     ceres_tpu.HuberLoss(1.0)))[0],
            ct.build_ba_problem(bal, loss=ct.ComposedLoss(ct.CauchyLoss(2.0),
                                                          ct.HuberLoss(1.0)))[0]),
    }


@pytest.mark.parametrize("with_jacobian", [True, False], ids=["jac", "residual_only"])
@pytest.mark.parametrize("case", ["foe3", "powell", "curve", "snavely_composed"])
def test_plain_matches_pallas_group_kernel_f32(monkeypatch, case, with_jacobian):
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    # the JAX Fields-of-Experts functors close over their taps as jnp
    # arrays, made float64 under the tests' x64 setting, which would promote
    # the float32 kernel's values: the JAX side is built and run without it
    with jax.enable_x64(case != "foe3"):
        jp, tp = _jax_problems()[case]
        jprog, tprog = jp.compile(), tp.compile("cpu")
        arrays = jprog.arrays(jnp.float32)
        tev = Evaluator(tprog, torch.float32)
        for jm, jg, tm, tg in zip(jprog.groups, arrays["groups"], tprog.groups,
                                  tev.arrays["groups"]):
            assert pallas_eval.group_kernel(jm, jg, jnp.float32, True,
                                            with_jacobian=with_jacobian) is not None
            assert functor_codegen.group_program(tm, tg, torch.float32, True) is not None
        c1, r1, j1, g1 = jax.jit(
            lambda a, s: j_evaluate(jprog, a, s, with_jacobian=with_jacobian))(
            arrays, jprog.state_vector(jnp.float32))
    state = tprog.state_vector(torch.float32)
    if with_jacobian:
        c2, r2, j2, g2 = tev.evaluate_groups(state)
    else:
        c2, r2, _, _ = evaluator.evaluate(tprog, tev.arrays, state, with_jacobian=False)
    tol = 5e-4
    assert abs(float(c1) - float(c2)) <= tol * (1.0 + abs(float(c1)))
    for a, b in zip(r2, r1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol * max(1.0, float(jnp.max(jnp.abs(b)))))
    if with_jacobian:
        np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=tol,
                                   atol=tol * float(jnp.max(jnp.abs(g1))))
        for ga, gb in zip(j2.jac_groups, j1.jac_groups):
            for ta, tb in zip(ga, gb):
                np.testing.assert_allclose(np.asarray(ta), np.asarray(tb), rtol=tol,
                                           atol=tol * max(1.0, float(jnp.max(jnp.abs(tb)))))


# (name, JAX functor, port functor, block size, data for 3 blocks)
def _eligibility_cases():
    return [
        ("polynomial", lambda p, d: jnp.stack([p[0][0] ** 2 - d[0][0], p[0][1] * d[0][1]]),
         lambda p, d: torch.stack([p[0][0] ** 2 - d[0][0], p[0][1] * d[0][1]]),
         2, np.ones((3, 2))),
        ("branch_free_where", lambda p, d: jnp.where(p[0] > 0, p[0], -p[0]),
         lambda p, d: torch.where(p[0] > 0, p[0], -p[0]), 2, None),
        ("matrix_product", lambda p, d: p[0].reshape(2, 2) @ p[0][:2],
         lambda p, d: p[0].reshape(2, 2) @ p[0][:2], 4, None),
        ("control_flow", lambda p, d: p[0] if p[0][0] > 0 else -p[0],
         lambda p, d: p[0] if p[0][0] > 0 else -p[0], 2, None),
        ("sort", lambda p, d: jnp.sort(p[0]), lambda p, d: torch.sort(p[0]).values, 2, None),
        ("data_index", lambda p, d: p[0][d[0].astype(jnp.int32)],
         lambda p, d: p[0][d[0].long()], 2, np.zeros((3, 2))),
        ("integer_data", lambda p, d: p[0] * d[0], lambda p, d: p[0] * d[0], 2,
         np.ones((3, 2), dtype=np.int64)),
        ("rank3_data", lambda p, d: p[0] * d[0].sum(), lambda p, d: p[0] * d[0].sum(), 2,
         np.ones((3, 2, 2))),
    ]


ELIGIBLE = {"polynomial", "branch_free_where", "matrix_product"}


@pytest.mark.parametrize("case", [c[0] for c in _eligibility_cases()])
def test_eligibility_matches_group_kernel(monkeypatch, case):
    """The generator's decision equals ceres_tpu's group_kernel's (float32
    on both sides; JAX's kernel refuses float64 outright)."""
    monkeypatch.setenv("CERES_TPU_PALLAS", "interpret")
    name, jfn, tfn, size, data = next(c for c in _eligibility_cases() if c[0] == case)
    x0 = np.linspace(0.3, 1.1, 3 * size).reshape(3, size)
    r = 2
    decisions = []
    for pkg, fn, cf in ((ceres_tpu, jfn, JCostFunction), (ct, tfn, ct.CostFunction)):
        p = pkg.Problem()
        blocks = p.add_parameter_blocks(x0)
        p.add_residual_blocks(cf(fn, r), None, blocks[:, None], () if data is None else (data,))
        if pkg is ceres_tpu:
            prog = p.compile()
            arrays = prog.arrays(jnp.float32)
            decisions.append(pallas_eval.group_kernel(
                prog.groups[0], arrays["groups"][0], jnp.float32, True) is not None)
        else:
            prog = p.compile("cpu")
            arrays = prog.arrays(torch.float32)
            decisions.append(functor_codegen.group_program(
                prog.groups[0], arrays["groups"][0], torch.float32, True) is not None)
    assert decisions[0] == decisions[1] == (case in ELIGIBLE)


def test_dispatch_and_shared_sources(monkeypatch):
    """On the CPU the evaluator traces no group (B1 generic's plain version
    is the torch.func path itself) and `generic_evaluate` on CPU tensors
    returns that path's values; the filter groups of a prior share one
    source, the data term has its own, a group whose only difference is a
    constant reuses it, and a functor with an op the generator has no rule
    for has no program."""
    traced = []
    entry = functor_codegen.group_program

    def spy(meta, *args):
        traced.append(meta.cost_function.name)
        return entry(meta, *args)

    monkeypatch.setattr(functor_codegen, "group_program", spy)
    img = tdn.synthetic_noisy_image(9, 8, seed=3)
    program = tdn.build_foe_denoising_problem(img, _foe(3, 3, 1))[0].compile("cpu")
    ev = Evaluator(program, F64)
    state = program.state_vector(F64)
    cost, res, jac, _ = ev.evaluate_groups(state)
    assert traced == []
    progs = [functor_codegen.group_program(m, g, F64, True)
             for m, g in zip(program.groups, ev.arrays["groups"])]
    assert progs[1].source == progs[2].source == progs[3].source != progs[0].source
    assert progs[1].consts != progs[2].consts
    st = state_tables(program, state)
    total = 0.0
    for gi, (m, g, prog) in enumerate(zip(program.groups, ev.arrays["groups"], progs)):
        c, r, leaves = eval_kernel.generic_evaluate(prog, m, g, st, True)
        total += float(c)
        assert torch.equal(r, res[gi])
        for a, b in zip(leaves, jac.jac_groups[gi]):
            assert torch.equal(a, b)
    assert total == pytest.approx(float(cost), rel=1e-14)
    p = ct.Problem()
    b = p.add_parameter_blocks(np.array([[0.5, 0.2], [0.1, 0.3]]))
    p.add_residual_blocks(ct.CostFunction(lambda q, d: torch.sort(q[0]).values, 2),
                          None, b[:, None])
    prog = p.compile("cpu")
    Evaluator(prog, F64).evaluate_groups(prog.state_vector(F64))
    assert functor_codegen.group_program(
        prog.groups[0], prog.arrays(F64)["groups"][0], F64, True) is None


def test_program_cache_follows_a_swapped_loss():
    """The program cached on a group's meta is traced anew when its loss is
    replaced, so a new loss's constants (a Fields-of-Experts alpha) reach
    the kernel even where the old object's id is reused."""
    img = tdn.synthetic_noisy_image(9, 8, seed=3)
    program = tdn.build_foe_denoising_problem(img, _foe(3, 1, 1))[0].compile("cpu")
    meta, garr = program.groups[1], program.arrays(F64)["groups"][1]
    first = functor_codegen.group_program(meta, garr, F64, True)
    assert functor_codegen.group_program(meta, garr, F64, True) is first
    alpha = meta.loss.alpha
    object.__setattr__(meta, "loss", tdn.FieldsOfExpertsLoss(alpha * 3.0))
    second = functor_codegen.group_program(meta, garr, F64, True)
    assert second is not first and second.source == first.source
    assert alpha * 3.0 in second.consts and alpha not in second.consts


def test_generated_source_shape():
    """One kernel per structural signature: the source names no constant
    value, types every literal through S or the constant buffer, and the
    emitted arithmetic for a Fields-of-Experts clique is its dot product."""
    img = tdn.synthetic_noisy_image(9, 8, seed=3)
    program = tdn.build_foe_denoising_problem(img, _foe(3, 1, 1))[0].compile("cpu")
    ev = Evaluator(program, torch.float32)
    prog = functor_codegen.group_program(program.groups[1], ev.arrays["groups"][1],
                                       torch.float32, True)
    body = prog.source.split("functor(")[1].split("}")[0]
    assert body.count(" * ") == 9 and body.count(" + ") == 8
    taps = program.groups[1].cost_function.fn.__defaults__[0]
    for v in taps.tolist():
        assert repr(v) not in prog.source and f"{v:.6g}" not in prog.source
    assert prog.consts[:9] == [float(np.float32(v)) for v in taps.tolist()]
    assert "CTT_EVAL_GENERIC_ENTRY(G)" in prog.source
    assert program.groups[1].loss.alpha in prog.consts
