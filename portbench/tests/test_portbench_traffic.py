"""The traffic generator on the CPU: counts, seeds, track and camera
coverage, cheirality, track lengths, even camera loads, visibility models
found by name, and the uniform mix's bitwise agreement with the port's
synthetic_bal."""

import json
import os

import numpy as np
import pytest

import generator

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MID = {"num_cameras": 300, "num_points": 30000, "num_observations": 150978}
SEEDS = [2**31 + 11, 12]


def traffic(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=SEEDS)
def uniform_mid(request):
    return generator.generate(MID, traffic("uniform"), request.param)


def test_venice_counts_are_the_published_ones():
    cfg = config("venice-1778")
    g = generator.generate(cfg, traffic("uniform"), 3)
    assert g.cameras.shape == (1778, 9) and g.points.shape == (993923, 3)
    assert g.observations.shape == (5001946, 2)
    assert g.camera_index.shape == g.point_index.shape == (5001946,)
    assert np.bincount(g.camera_index, minlength=1778).min() >= 1
    assert np.bincount(g.point_index, minlength=993923).min() >= 2


def test_one_seed_one_problem_two_seeds_two():
    t = traffic("uniform")
    a = generator.generate(MID, t, 77)
    b = generator.generate(MID, t, 77)
    c = generator.generate(MID, t, 78)
    for f in ("cameras", "points", "camera_index", "point_index", "observations"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
        assert not np.array_equal(getattr(a, f), getattr(c, f))


def test_coverage_and_cheirality(uniform_mid):
    g = uniform_mid
    assert g.observations.shape[0] == MID["num_observations"]
    assert np.bincount(g.point_index, minlength=MID["num_points"]).min() >= 2
    assert np.bincount(g.camera_index, minlength=MID["num_cameras"]).min() >= 1
    for cams, pts in ((g.cameras_true, g.points_true), (g.cameras, g.points)):
        _, z = generator.project(cams[g.camera_index], pts[g.point_index])
        assert z.max() < 0  # in front: BAL's camera looks down -z


def test_mean_track_length(uniform_mid):
    lengths = np.bincount(uniform_mid.point_index)
    assert lengths.mean() == pytest.approx(MID["num_observations"] / MID["num_points"], abs=1e-12)


def test_camera_loads_are_even(uniform_mid):
    """Uniform visibility: loads vary by < 0.1 of their mean, and nearly
    every camera pair shares a point."""
    even = np.bincount(uniform_mid.camera_index, minlength=MID["num_cameras"])
    assert even.std() / even.mean() < 0.1
    nc = MID["num_cameras"]
    v = np.zeros((MID["num_points"], nc), dtype=np.float32)
    v[uniform_mid.point_index, uniform_mid.camera_index] = 1
    assert float(((v.T @ v) > 0).mean()) > 0.9


def test_uniform_draws_what_synthetic_bal_draws():
    import ceres_tpu_torch as ct

    for cfg, seed in ((MID, 0), ({"num_cameras": 7, "num_points": 50, "num_observations": 90}, 2**31 + 3)):
        g = generator.draw(cfg, traffic("uniform"), seed)
        b = ct.synthetic_bal(cfg["num_cameras"], cfg["num_points"], cfg["num_observations"],
                             seed=seed)
        for f in ("cameras", "points", "camera_index", "point_index", "observations"):
            assert np.array_equal(getattr(g, f), getattr(b, f)), f


def test_seeds_order_one_problem():
    """Two seeds give the same problem in two orders: the same cameras,
    points and observations, renumbered and shuffled."""
    t = traffic("uniform")
    a = generator.generate(MID, t, 5)
    b = generator.generate(MID, t, 2**31 + 6)

    def canon(g):
        cams = g.cameras[g.camera_index]
        pts = g.points[g.point_index]
        rows = np.concatenate([cams, pts, g.observations], axis=1)
        return rows[np.lexsort(rows.T[::-1])]

    assert np.array_equal(canon(a), canon(b))
    assert not np.array_equal(a.camera_index, b.camera_index)
    assert np.array_equal(np.sort(a.cameras, axis=0), np.sort(b.cameras, axis=0))


def test_visibility_models_are_found_by_name(tmp_path):
    """A mix names its visibility model; a model is a file of its own, and
    one that is not there is refused."""
    (tmp_path / "visibility").mkdir()
    (tmp_path / "visibility" / "echo.py").write_text(
        "import generator\n"
        "def draw(config, traffic, seed):\n"
        "    return generator.load('visibility', 'uniform').draw(config, traffic, seed + 1)\n")
    t = dict(traffic("uniform"), visibility="echo")
    small = {"num_cameras": 7, "num_points": 50, "num_observations": 90}
    got = generator.draw(small, t, 4, root=str(tmp_path))
    want = generator.draw(small, traffic("uniform"), 5)
    assert np.array_equal(got.observations, want.observations)
    with pytest.raises(ValueError, match="no visibility module"):
        generator.draw(small, dict(t, visibility="absent"), 4, root=str(tmp_path))
