"""The float64 reference against an independent computation, its control
in bfloat16, and what the reference and the harness's sources import."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import generator
from reference import snavely_huber as ref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"num_cameras": 12, "num_points": 300, "num_observations": 1500}


def small(name="uniform", seed=4):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return generator.generate(SMALL, json.load(f), seed)


def loop_cost(cams, pts, ci, pi, obs):
    """Observation by observation: the rotation as a matrix
    (I + sin t K + (1 - cos t) K^2), Huber as Ceres writes it."""
    total = 0.0
    for c, p, o in zip(cams[ci], pts[pi], obs):
        t = np.linalg.norm(c[:3])
        k = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]]) / t
        r = np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k
        q = r @ p + c[3:6]
        x, y = -q[0] / q[2], -q[1] / q[2]
        d = 1 + (x * x + y * y) * (c[7] + c[8] * (x * x + y * y))
        s = (c[6] * d * x - o[0]) ** 2 + (c[6] * d * y - o[1]) ** 2
        total += s if s <= 1 else 2 * np.sqrt(s) - 1
    return 0.5 * total


@pytest.mark.parametrize("seed", [4, 2**31 + 4])
def test_cost_matches_the_loop(seed):
    g = small(seed=seed)
    args = (g.camera_index, g.point_index, g.observations)
    for cams, pts in ((g.cameras, g.points), (g.cameras_true, g.points_true)):
        want = loop_cost(cams, pts, *args)
        assert ref.cost(cams, pts, *args) == pytest.approx(want, rel=1e-12)
        assert ref.cost(cams, pts, *args, block=97) == pytest.approx(want, rel=1e-12)


def test_gradient_norm_matches_central_differences():
    g = small("uniform", 9)
    args = (g.camera_index, g.point_index, g.observations)
    x = np.concatenate([g.cameras.ravel(), g.points.ravel()])
    nc = g.cameras.size

    def f(v):
        return ref.cost(v[:nc].reshape(-1, 9), v[nc:].reshape(-1, 3), *args)

    grad = np.empty_like(x)
    for i in range(x.size):
        h = 1e-6 * max(1.0, abs(x[i]))
        e = np.zeros_like(x)
        e[i] = h
        grad[i] = (f(x + e) - f(x - e)) / (2 * h)
    got = ref.gradient_norm(g.cameras, g.points, *args, block=101)
    assert got == pytest.approx(np.linalg.norm(grad), rel=1e-5)


def test_the_bfloat16_control_reads_far_from_float64():
    for seed in (4, 2**31 + 4):
        g = small(seed=seed)
        args = (g.cameras, g.points, g.camera_index, g.point_index, g.observations)
        c64 = ref.cost(*args)
        assert abs(ref.cost(*args, dtype=torch.bfloat16) - c64) / c64 > 1e-2
        assert abs(ref.cost(*args, dtype=torch.float32) - c64) / c64 < 1e-5


def test_nothing_of_jax_or_the_port_is_imported():
    """The reference and the generator load neither JAX, nor the JAX
    package, nor the port; the harness's modules load no JAX."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import generator, check, roofline, devtrace\n"
        "generator.load('visibility', 'uniform'); generator.load('problems', 'snavely_bal')\n"
        "import reference.snavely_huber\n"
        "bad = {m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'ceres_tpu',"
        " 'ceres_tpu_torch'}\n"
        "assert not bad, bad\n"
        "import run\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()\n"
    ) % (os.path.dirname(HERE), HERE)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "ceres_tpu_torch_lookalike", sys)
    assert "ceres_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
