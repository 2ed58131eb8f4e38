"""The port's C API (ceres_tpu_torch/capi.py and its embedding shim
ceres_tpu_torch/native/ceres_tpu_torch_c_api.cc) against ceres_tpu's, after
tests/test_c_api.py.

Cost and loss functions arrive as C function pointers (ctypes callbacks
standing in for a C caller, the same ones fed to both packages), parameter
memory is caller-owned doubles adopted in place, and the solved values are
written back. On the CPU (CERES_TPU_TORCH_C_API_DEVICE=cpu), in float64:

- the 67-point exponential fit of tests/test_c_api.py through both
  packages' CProblem: per-iteration cost 1e-10 relative, m and c 1e-10,
  the same fused/host loop choice;
- stock_loss_rho of the five kinds (1e-14), CCallbackLoss.rho, and solves
  under each stock loss and under a custom C loss against ceres_tpu's;
- a callback that returns 0 ends in FAILURE in both;
- blocks that share a callback and its data form one group, evaluated in
  one host round trip; the callback is asked for Jacobians only where the
  evaluation differentiates; torch.func's jacfwd, vmap and grad go through
  the callback's Jacobians;
- the generator refuses a C callback or C loss (the torch.func path) and
  an Evaluator over such a Program captures no CUDA graph;
- with the device variable unset and no card, solve raises and calls no
  callback;
- the shim builds, the unchanged examples/curve_fitting.c links against it
  and runs, and prints the m and c of ceres_tpu's in-process CProblem on
  the same data (the C file's LCG, rewritten in numpy).
A `cuda` case holds the card against the CPU (1e-9). ceres_tpu (JAX) is
imported by the `jcapi` fixture, so that the card case runs where JAX is
not installed (`python3 -m pytest --noconftest -m cuda
tests/test_torch_capi.py`)."""

import ctypes
import math
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceres_tpu_torch import capi as tcapi
from ceres_tpu_torch import cuda_lib, functor_codegen
from ceres_tpu_torch.autodiff import batched_value_and_jacobians, batched_values
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.utils.execution_summary import counts, reset_counts

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DPTR = ctypes.POINTER(ctypes.c_double)


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv(tcapi.DEVICE_ENV, "cpu")


@pytest.fixture
def jcapi():
    from ceres_tpu import capi

    return capi


def _make_data(n=67):
    """tests/test_c_api.py's samples of y = exp(0.3 x + 0.1)."""
    rng = np.random.default_rng(5)
    x = 0.075 * np.arange(n)
    y = np.exp(0.3 * x + 0.1) + rng.normal(0, 0.05, n)
    return np.stack([x, y], axis=1)


def _lcg_data(n=67):
    """examples/curve_fitting.c's make_data in Python (the LCG modulo 2^64,
    as the C unsigned long long wraps; glibc's exp, as the C program's)."""
    out, s = np.empty((n, 2)), 12345
    for i in range(n):
        x = 0.075 * i
        s = (s * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        out[i] = x, math.exp(0.3 * x + 0.1) + ((s >> 11) / 9007199254740992.0 - 0.5) * 0.2
    return out


@tcapi.COST_FUNC_T
def exponential_residual(user_data, parameters, residuals, jacobians):
    """examples/curve_fitting.c's callback: user_data points at (x, y)."""
    x, y = ctypes.cast(user_data, DPTR)[0:2]
    m, c = parameters[0][0], parameters[1][0]
    e = np.exp(m * x + c)
    residuals[0] = y - e
    if jacobians:
        if jacobians[0]:
            jacobians[0][0] = -x * e
        if jacobians[1]:
            jacobians[1][0] = -e
    return 1


CALLS = {"with_jacobians": 0, "values": 0}


@tcapi.COST_FUNC_T
def offset_residual(user_data, parameters, residuals, jacobians):
    """r = [p0 - a, p0 p1 - b] over one 2-vector p, (a, b) at user_data."""
    a, b = ctypes.cast(user_data, DPTR)[0:2]
    p0, p1 = parameters[0][0], parameters[0][1]
    residuals[0] = p0 - a
    residuals[1] = p0 * p1 - b
    CALLS["with_jacobians" if jacobians else "values"] += 1
    if jacobians and jacobians[0]:
        jacobians[0][0], jacobians[0][1] = 1.0, 0.0
        jacobians[0][2], jacobians[0][3] = p1, p0
    return 1


@tcapi.COST_FUNC_T
def failing_residual(user_data, parameters, residuals, jacobians):
    residuals[0] = parameters[0][0]
    return 0


@tcapi.LOSS_FUNC_T
def log_loss(user_data, s, out):
    """A custom C loss: rho(s) = log(1 + s), a Cauchy loss of scale 1."""
    out[0] = np.log1p(s)
    out[1] = 1.0 / (1.0 + s)
    out[2] = -1.0 / (1.0 + s) ** 2


def _host_stats():
    """The C API's host round trips and C function calls since the last
    reset of the counter table."""
    table = counts()
    return {"round_trips": table["CAPI::RoundTrip"], "calls": table["CAPI::Call"]}


def _addr(fn):
    return ctypes.cast(fn, ctypes.c_void_p).value


class _Summaries:
    """Records the Summary of each of ceres_tpu's CProblem solves."""

    def __init__(self, monkeypatch, jcapi):
        self.last = None
        solve = jcapi.solve

        def recording(options, problem):
            self.last = solve(options, problem)
            return self.last

        monkeypatch.setattr(jcapi, "solve", recording)


def _curve_fit(mod, data, loss=(-1, 0.0, 0.0, 0), start=(0.0, 0.0)):
    """A CProblem of `mod` fitting (m, c) to data, one block per row with
    exponential_residual on that row; returns (report, m, c, CProblem, the
    rows kept alive)."""
    rows = np.ascontiguousarray(data, dtype=np.float64)
    m, c = np.array([start[0]]), np.array([start[1]])
    cp = mod.CProblem()
    kind, a, b, custom = loss
    for i in range(rows.shape[0]):
        cp.add_residual_block_c(_addr(exponential_residual), rows[i].ctypes.data, kind, a, b, 1,
                                [m.ctypes.data, c.ctypes.data], [1, 1],
                                _addr(custom) if custom else 0, 0)
    report = cp.solve()
    return report, m, c, cp, rows


def _check_parity(js, ts, jm, jc, tm, tc, tol):
    jcost = [it.cost for it in js.iterations]
    tcost = [it.cost for it in ts.iterations]
    assert len(jcost) == len(tcost), (jcost, tcost)
    gap = max(abs(a - b) / abs(a) for a, b in zip(jcost, tcost))
    print(f"largest per-iteration cost gap {gap:.3e}")
    assert gap <= tol
    assert ts.termination_type.value == js.termination_type.value
    assert ts.used_fused_execution == js.used_fused_execution
    np.testing.assert_allclose([tm[0], tc[0]], [jm[0], jc[0]], rtol=tol, atol=tol)


def test_curve_fit_matches_jax(monkeypatch, jcapi):
    rec = _Summaries(monkeypatch, jcapi)
    data = _make_data()
    jrep, jm, jc, _, _ = _curve_fit(jcapi, data)
    trep, tm, tc, cp, _ = _curve_fit(tcapi, data)
    _check_parity(rec.last, cp.summary, jm, jc, tm, tc, 1e-10)
    assert "CONVERGENCE" in trep and trep.splitlines()[-1] == "device: cpu"
    assert trep.splitlines()[0] == jrep
    # written back into the caller's memory
    assert abs(tm[0] - 0.3) < 0.05 and abs(tc[0] - 0.1) < 0.1
    handles = list(cp._param_handles.values())
    assert tm[0] == cp.problem.parameter_block_value(handles[0])[0]
    assert cp.summary.used_fused_execution  # the fused loop, as ceres_tpu's


@pytest.mark.parametrize("kind", range(5), ids=["huber", "softl1", "cauchy", "arctan", "tolerant"])
def test_stock_loss_rho_matches_jax(jcapi, kind):
    for s in (0.25, 1.0, 9.0):
        got, want = tcapi.stock_loss_rho(kind, 1.3, 0.7, s), jcapi.stock_loss_rho(kind, 1.3, 0.7, s)
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-300)


def test_c_loss_rho_matches_jax(jcapi):
    s = np.array([0.0, 0.5, 2.0, 9.0])
    reset_counts()
    got = tcapi.CCallbackLoss(_addr(log_loss), 0).rho(torch.tensor(s))
    want = jcapi.CCallbackLoss(_addr(log_loss), 0).rho(s)
    assert _host_stats() == {"round_trips": 1, "calls": 4}
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == (4,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


LOSSES = {
    "huber": (0, 0.1, 0.0, None), "softl1": (1, 0.1, 0.0, None),
    "cauchy": (2, 0.1, 0.0, None), "arctan": (3, 0.1, 0.0, None),
    "tolerant": (4, 0.05, 0.1, None), "custom_c": (-1, 0.0, 0.0, log_loss),
}


@pytest.mark.parametrize("loss", list(LOSSES))
def test_solve_under_a_loss_matches_jax(monkeypatch, jcapi, loss):
    rec = _Summaries(monkeypatch, jcapi)
    data = _make_data(12)
    data[3, 1] += 2.0  # an outlier for the loss to reject
    _, jm, jc, _, _ = _curve_fit(jcapi, data, LOSSES[loss], start=(0.2, 0.0))
    _, tm, tc, cp, _ = _curve_fit(tcapi, data, LOSSES[loss], start=(0.2, 0.0))
    _check_parity(rec.last, cp.summary, jm, jc, tm, tc, 1e-10)


def test_failing_callback_ends_in_failure_in_both(monkeypatch, jcapi):
    rec = _Summaries(monkeypatch, jcapi)
    out = {}
    for mod in (jcapi, tcapi):
        x = np.array([1.0])
        cp = mod.CProblem()
        cp.add_residual_block_c(_addr(failing_residual), 0, -1, 0.0, 0.0, 1, [x.ctypes.data], [1])
        cp.solve()
        out[mod] = cp.summary if mod is tcapi else rec.last
    assert out[jcapi].termination_type.value == "FAILURE"
    assert out[tcapi].termination_type.value == "FAILURE"


def _shared_group(mod, n=6):
    """n blocks of offset_residual with one user data, each on its own
    2-vector."""
    ab = np.array([1.5, -2.0])
    ps = [np.array([0.5 + i, 1.0 - 0.3 * i]) for i in range(n)]
    cp = mod.CProblem()
    for p in ps:
        cp.add_residual_block_c(_addr(offset_residual), ab.ctypes.data, -1, 0.0, 0.0, 2,
                                [p.ctypes.data], [2])
    return cp, ab, ps


def test_blocks_sharing_a_callback_and_its_data_form_one_group(jcapi):
    jcp, _, _ = _shared_group(jcapi)
    cp, keep, ps = _shared_group(tcapi)
    assert len(jcp.problem.compile().groups) == 1
    program = cp.problem.compile("cpu")
    assert len(program.groups) == 1
    ev = Evaluator(program, torch.float64)
    state = program.state_vector(torch.float64)
    CALLS.update(with_jacobians=0, values=0)
    reset_counts()
    cost, res, jac, grad = ev.evaluate(state)
    assert _host_stats() == {"round_trips": 1, "calls": 6}
    assert CALLS == {"with_jacobians": 6, "values": 0}
    ev.cost(state)  # residual-only: no Jacobians asked for
    assert _host_stats() == {"round_trips": 2, "calls": 12}
    assert CALLS == {"with_jacobians": 6, "values": 6}
    x = np.stack(ps)
    r = np.stack([x[:, 0] - 1.5, x[:, 0] * x[:, 1] + 2.0], axis=1)
    np.testing.assert_allclose(float(cost), 0.5 * (r * r).sum(), rtol=1e-15)
    g = np.stack([r[:, 0] + r[:, 1] * x[:, 1], r[:, 1] * x[:, 0]], axis=1)
    np.testing.assert_allclose(np.sort(grad.numpy()), np.sort(g.reshape(-1)), rtol=1e-14)


def test_torch_func_goes_through_the_callbacks_jacobians():
    cp, keep, ps = _shared_group(tcapi, n=3)
    fn = cp.problem.compile("cpu").groups[0].cost_function.fn
    x = torch.tensor(np.stack(ps))
    reset_counts()
    res, (jac,) = batched_value_and_jacobians(fn, (x,), ())
    assert _host_stats()["round_trips"] == 1
    want_j = torch.zeros((3, 2, 2), dtype=torch.float64)
    want_j[:, 0, 0] = 1.0
    want_j[:, 1, 0], want_j[:, 1, 1] = x[:, 1], x[:, 0]
    torch.testing.assert_close(jac, want_j, rtol=0, atol=0)
    torch.testing.assert_close(res, batched_values(fn, (x,), ()), rtol=0, atol=0)
    # reverse mode (torch.func.grad and autograd) applies Jᵀ
    g = torch.func.vmap(torch.func.grad(lambda p: fn((p,)).sum()))(x)
    torch.testing.assert_close(g, want_j.sum(dim=1), rtol=0, atol=0)
    xr = x.clone().requires_grad_()
    torch.func.vmap(lambda p: fn((p,)))(xr).pow(2).sum().backward()
    torch.testing.assert_close(xr.grad, 2 * torch.einsum("nr,nrs->ns", res, want_j))


def test_the_generator_refuses_c_callbacks_and_graphs_are_off():
    cp, _, _ = _shared_group(tcapi)
    row, m, c = _make_data(1)[0], np.array([0.1]), np.array([0.2])
    cp.add_residual_block_c(_addr(exponential_residual), row.ctypes.data, -1, 0, 0, 1,
                            [m.ctypes.data, c.ctypes.data], [1, 1])
    cp.problem.add_residual_block(
        tcapi.make_callback_cost_function(_addr(offset_residual), 7, 2, [2]),
        tcapi.CCallbackLoss(_addr(log_loss), 0), [cp.problem.add_parameter_block([1.0, 2.0])])
    program = cp.problem.compile("cpu")
    arrays = program.arrays(torch.float64)
    assert len(program.groups) == 3
    for meta, garr in zip(program.groups, arrays["groups"]):
        assert functor_codegen.group_program(meta, garr, torch.float64, True) is None
    assert not Evaluator(program, torch.float64).capturable
    import ceres_tpu_torch as ct

    plain = ct.Problem()
    plain.add_residual_block(ct.CostFunction(lambda p, d: p[0] - 1.0, 1), None,
                             [plain.add_parameter_block([0.0])])
    assert Evaluator(plain.compile("cpu"), torch.float64).capturable


def test_without_a_card_or_a_device_solve_raises(monkeypatch):
    monkeypatch.delenv(tcapi.DEVICE_ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cp, _, ps = _shared_group(tcapi, n=2)
    before = [p.copy() for p in ps]
    CALLS.update(with_jacobians=0, values=0)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        cp.solve()
    assert CALLS == {"with_jacobians": 0, "values": 0} and cp.summary is None
    for p, b in zip(ps, before):
        np.testing.assert_array_equal(p, b)


@pytest.mark.skipif(cuda_lib.host_compiler() is None or shutil.which("cc") is None
                    and shutil.which("gcc") is None, reason="no C/C++ compiler")
def test_shim_runs_the_unchanged_c_example(tmp_path, jcapi):
    example = os.path.join(REPO, "examples", "curve_fitting.c")
    exe = tcapi.link_c_program(example, tmp_path / "curve_fitting")
    proc = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **{tcapi.DEVICE_ENV: "cpu"}))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "device: cpu" in proc.stdout
    got = re.search(r"^Final m: (\S+) c: (\S+)", proc.stdout, re.M).groups()
    _, jm, jc, _, _ = _curve_fit(jcapi, _lcg_data())
    assert got == ("%g" % jm[0], "%g" % jc[0])


@pytest.mark.cuda
def test_card_matches_the_cpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    data = _make_data()
    _, cm, cc, cpu, _ = _curve_fit(tcapi, data)
    monkeypatch.delenv(tcapi.DEVICE_ENV)
    _, gm, gc, card, _ = _curve_fit(tcapi, data)
    assert card.device.type == "cuda"
    assert not Evaluator(card.problem.compile(card.device), torch.float64).capturable
    _check_parity(cpu.summary, card.summary, cm, cc, gm, gc, 1e-9)
