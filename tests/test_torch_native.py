"""The port's native BAL loader and preprocessor (ceres_tpu_torch/io/native.py,
built from ceres_tpu_torch/native/bal_loader.cc by cuda_lib.build_host)
against ceres_tpu's.

- the native parse is bitwise equal to the port's numpy parse (the plain
  version) and to ceres_tpu.io.bal.load_bal on files written as in
  tests/test_native.py (%.17g);
- sort_by_camera, count_degrees and coo_to_crs, native and plain, are
  exact against ceres_tpu's numpy fallbacks;
- a truncated file raises in both packages;
- two processes that build at once end with one library; a compiler that
  fails raises, and the numpy branch runs only without a compiler.
They skip only where no C++ compiler is on PATH."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu.io import bal as jbal
from ceres_tpu.io import native as jnative
from ceres_tpu_torch import cuda_lib
from ceres_tpu_torch.io import bal as tbal
from ceres_tpu_torch.io import native as tnative
from test_native import write_bal

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(cuda_lib.host_compiler() is None, reason="no C++ compiler")
FIELDS = ("cameras", "points", "camera_index", "point_index", "observations")


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape", [(4, 17, 60, 7), (6, 50, 203, 3)], ids=["4x17x60", "6x50x203"])
def test_native_parse_is_bitwise_jax_and_numpy(tmp_path, shape):
    *dims, seed = shape
    bal = jbal.synthetic_bal(*dims, seed=seed)
    path = str(tmp_path / "p.txt")
    write_bal(bal, path)
    parsed = tnative.load_bal_native(path)
    assert parsed is not None
    native = tbal.BalProblem(*parsed)
    plain, jax_side, loaded = tbal.load_bal_numpy(path), jbal.load_bal(path), ct.load_bal(path)
    for f in FIELDS:
        assert _bitwise(getattr(native, f), getattr(plain, f)), f
        assert _bitwise(getattr(native, f), getattr(jax_side, f)), f
        assert _bitwise(getattr(loaded, f), getattr(native, f)), f
        # %.17g round-trips every double
        assert _bitwise(getattr(native, f), getattr(bal, f).astype(getattr(native, f).dtype)), f


def _index_data():
    rng = np.random.default_rng(0)
    ci, pi = rng.integers(0, 10, 500), rng.integers(0, 50, 500)  # many ties
    return ci, pi


def _plain(monkeypatch, which):
    if which == "plain":
        monkeypatch.setattr(tnative, "_lib", lambda: None)
    # ceres_tpu's numpy fallbacks, whether or not its library is built
    monkeypatch.setattr(jnative, "_lib", lambda: None)


@pytest.mark.parametrize("which", ["native", "plain"])
def test_sort_by_camera_matches_jax(monkeypatch, which):
    _plain(monkeypatch, which)
    ci, pi = _index_data()
    got, want = tnative.sort_by_camera(ci, pi), jnative.sort_by_camera(ci, pi)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["native", "plain"])
def test_count_degrees_matches_jax(monkeypatch, which):
    _plain(monkeypatch, which)
    ci, pi = _index_data()
    got, want = tnative.count_degrees(ci, pi, 12, 53), jnative.count_degrees(ci, pi, 12, 53)
    for a, b in zip(got, want):
        assert _bitwise(a, b)


@pytest.mark.parametrize("which", ["native", "plain"])
def test_coo_to_crs_matches_jax(monkeypatch, which):
    _plain(monkeypatch, which)
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, 30, 400), rng.integers(0, 40, 400)
    (perm, ptr), (jperm, jptr) = tnative.coo_to_crs(rows, cols, 31), jnative.coo_to_crs(rows, cols, 31)
    np.testing.assert_array_equal(perm, jperm)
    assert _bitwise(ptr, jptr)
    assert ptr[-1] == rows.size


@pytest.mark.parametrize("keep", [50, 80, -3], ids=["observations", "cameras", "points"])
def test_truncated_file_raises_in_both(tmp_path, keep):
    bal = jbal.synthetic_bal(4, 17, 60, seed=7)
    full, cut = tmp_path / "full.txt", tmp_path / "cut.txt"
    write_bal(bal, str(full))
    cut.write_text("".join(full.read_text().splitlines(keepends=True)[:keep]))
    with pytest.raises(IOError, match="native BAL parse failed"):
        ct.load_bal(cut)
    with pytest.raises(ValueError):
        tbal.load_bal_numpy(cut)
    with pytest.raises(Exception):
        jbal.load_bal(str(cut))


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="BAL header"):
        ct.load_bal(tmp_path / "absent.txt")


_BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    from ceres_tpu_torch import cuda_lib
    from ceres_tpu_torch.io import native
    cuda_lib.BUILD_DIR = Path({build!r})
    print(native._lib()._name)
    print(native.count_degrees([0, 1, 1], [2, 0, 2], 2, 3)[1].tolist())
""")


def test_two_processes_that_build_at_once_end_with_one_library(tmp_path):
    build = tmp_path / "build"
    code = _BUILD.format(repo=REPO, build=str(build))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.splitlines()[0] for o in outs}
    assert len(paths) == 1 and all(o.splitlines()[1] == "[1, 0, 2]" for o in outs)
    built = sorted(p.relative_to(build).as_posix() for p in build.rglob("*") if p.is_file())
    assert built == [".lock", os.path.relpath(paths.pop(), build)]


def test_a_failing_compiler_raises_and_no_compiler_takes_numpy(tmp_path, monkeypatch):
    bal = jbal.synthetic_bal(4, 17, 60, seed=7)
    path = str(tmp_path / "p.txt")
    write_bal(bal, path)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    assert tnative.available()
    with pytest.raises(RuntimeError, match="false failed on bal_loader.cc"):
        ct.load_bal(path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not tnative.available()
    assert tnative.load_bal_native(path) is None
    loaded = ct.load_bal(path)
    for f in FIELDS:
        assert _bitwise(getattr(loaded, f), getattr(bal, f).astype(getattr(loaded, f).dtype))
    assert not list((tmp_path / "build").glob("host_*/*.so"))
