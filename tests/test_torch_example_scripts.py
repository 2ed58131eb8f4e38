"""The port's example programs (ceres_tpu_torch/examples/scripts), run
in-process on the CPU with `--device cpu`, after tests/test_example_scripts.py.

Every script of examples/ but the C API's curve_fitting.c (and the JAX
cache bootstrap _common.py) has a counterpart that takes the JAX script's
flags plus `--device`. The quick ones run as they are; the ones that read
files run on small inputs written here (a g2o graph, a PGM image and a
Fields-of-Experts file, a NIST .dat, a libmv dump, a BAL problem).
"""

import importlib
import pathlib
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_SCRIPTS = sorted(p.stem for p in (REPO / "examples").glob("*.py") if p.stem != "_common")

QUICK = [
    "helloworld", "helloworld_numeric_diff", "powell", "rosenbrock", "curve_fitting",
    "robust_curve_fitting", "circle_fit", "robot_pose_mle", "ellipse_approximation",
    "sampled_function", "bicubic_interpolation", "pose_graph_2d", "libmv_homography",
    "simple_bundle_adjuster",
]


def _run(name, *argv):
    mod = importlib.import_module(f"ceres_tpu_torch.examples.scripts.{name}")
    mod.main([*argv, "--device", "cpu"])


def _flags(path):
    return set(re.findall(r"add_argument\(\s*\"(--\w+)\"", path.read_text()))


@pytest.mark.parametrize("name", JAX_SCRIPTS)
def test_every_script_is_ported_with_its_flags(name):
    port = REPO / "ceres_tpu_torch" / "examples" / "scripts" / f"{name}.py"
    assert port.exists()
    src = port.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|ceres_tpu)\b", src, re.M)
    assert _flags(REPO / "examples" / f"{name}.py") <= _flags(port) | _flags(
        REPO / "ceres_tpu_torch" / "examples" / "scripts" / "_cli.py")


@pytest.mark.parametrize("name", QUICK)
def test_quick_script_runs(name, capsys):
    _run(name)
    out = capsys.readouterr().out
    assert "Solver Summary" in out or "Solver report" in out or "CONVERGENCE" in out, out


def test_curve_fitting_with_outliers(capsys):
    _run("curve_fitting", "--robust", "--outliers", "5", "--num_points", "40")
    assert "estimated m" in capsys.readouterr().out


def test_more_garbow_hillstrom_constrained(capsys):
    _run("more_garbow_hillstrom", "--constrained")
    out = capsys.readouterr().out
    assert re.search(r"\d+/\d+ reached the certified minimum", out)
    assert out.count("final cost") == 10  # the problems with bounds


def test_bundle_adjuster_synthetic(tmp_path, capsys):
    ply = tmp_path / "final.ply"
    _run("bundle_adjuster", "--synthetic", "6,60,300", "--num_iterations", "3", "--robustify",
         "--point_sigma", "0.01", "--final_ply", str(ply))
    out = capsys.readouterr().out
    assert "problem: 6 cameras, 60 points, 300 observations" in out and "Solver report" in out
    assert ply.read_text().startswith("ply\n") and len(ply.read_text().splitlines()) == 10 + 66


def _final_cost(out):
    return float(re.search(r"^Final cost\s+(\S+)", out, re.M).group(1))


def test_bundle_adjuster_on_a_two_rank_mesh(tmp_path, capsys):
    """--num_devices 2 under two gloo ranks started as torchrun would
    (tests/torch_mp.py): both ranks print the final cost of the 1-process
    run of the same problem, to 1e-10. Every point of the problem is seen
    by two cameras or more: a point seen by one makes the step depend on
    the summation order (SCHUR_JACOBI's ridge, ROADMAP Queue C), and on
    6,60,300, which has one, permuting the observations alone moves the
    1-process final cost by 5.9e-8."""
    import torch_mp

    argv = ["--synthetic", "6,60,600", "--num_iterations", "3", "--robustify",
            "--point_sigma", "0.01"]
    handle = torch_mp.start_ranks(str(tmp_path), 2, {
        "script": ["bundle_adjuster", *argv, "--num_devices", "2", "--device", "cpu"]})
    _run("bundle_adjuster", *argv)
    single = _final_cost(capsys.readouterr().out)
    for rank in torch_mp.collect(handle):
        assert "problem: 6 cameras, 60 points, 600 observations" in rank["stdout"]
        np.testing.assert_allclose(_final_cost(rank["stdout"]), single, rtol=1e-10)


def test_bundle_adjuster_refuses_a_mesh_that_is_not_the_world():
    with pytest.raises(ValueError, match="--num_devices 2 needs as many ranks"):
        _run("bundle_adjuster", "--synthetic", "6,60,300", "--num_devices", "2")


def test_pose_graph_3d_reads_g2o(tmp_path, capsys):
    path = tmp_path / "loop.g2o"
    lines = []
    for i in range(6):
        lines.append(f"VERTEX_SE3:QUAT {i} {i * 1.0 + 0.01 * i} {0.02 * i} 0 0 0 0 1")
    info = " ".join(["1 0 0 0 0 0", "1 0 0 0 0", "1 0 0 0", "1 0 0", "1 0", "1"])
    for i in range(5):
        lines.append(f"EDGE_SE3:QUAT {i} {i + 1} 1 0 0 0 0 0 1 {info}")
    lines.append(f"EDGE_SE3:QUAT 0 5 5 0 0 0 0 0 1 {info}")
    path.write_text("\n".join(lines) + "\n")
    _run("pose_graph_3d", "--input", str(path))
    assert "Solver Summary" in capsys.readouterr().out


def test_denoising_reads_pgm_and_foe(tmp_path, capsys):
    from ceres_tpu_torch.examples.denoising import save_pgm, synthetic_noisy_image

    img, foe = tmp_path / "noisy.pgm", tmp_path / "prior.foe"
    save_pgm(img, synthetic_noisy_image(12, 10, seed=0))
    # a 2x2 Fields-of-Experts prior in the reference's file format
    foe.write_text("2 2\n0 1 0 1\n0 0 1 1\n0.5 0.2\n1 -1 0 0\n1 0 -1 0\n")
    out_pgm = tmp_path / "out.pgm"
    _run("denoising", "--input", str(img), "--foe_file", str(foe), "--output", str(out_pgm),
         "--num_iterations", "2")
    assert "Solver Summary" in capsys.readouterr().out
    assert out_pgm.exists()


def test_nist_reads_a_dat_directory(tmp_path, capsys):
    from test_torch_examples_more import _synthetic_dat

    _synthetic_dat(tmp_path)
    _run("nist", "--nist_data_dir", str(tmp_path))
    out = capsys.readouterr().out
    assert out.count("SUCCESS") == 2 and "Easy    : 2/2" in out


def test_libmv_bundle_adjuster_reads_a_dump(tmp_path, capsys):
    from test_torch_examples_more import _euc_scene, _write_libmv_problem

    path = tmp_path / "scene.bin"
    _write_libmv_problem(path, _euc_scene())
    _run("libmv_bundle_adjuster", "--input", str(path), "--refine_intrinsics", "radial")
    out = capsys.readouterr().out
    assert "cameras: 4, points: 40, markers: 160" in out and "final intrinsics" in out


def test_simple_bundle_adjuster_reads_bal(tmp_path, capsys):
    import ceres_tpu_torch as ct

    bal = ct.synthetic_bal(4, 30, 120, seed=7)
    path = tmp_path / "problem.txt"
    rows = [f"{bal.num_cameras} {bal.num_points} {bal.num_observations}"]
    rows += [f"{c} {p} {o[0]} {o[1]}" for c, p, o in
             zip(bal.camera_index, bal.point_index, bal.observations)]
    rows += [str(v) for v in np.concatenate([bal.cameras.reshape(-1), bal.points.reshape(-1)])]
    path.write_text("\n".join(rows) + "\n")
    _run("simple_bundle_adjuster", "--input", str(path))
    assert "Solver report" in capsys.readouterr().out
