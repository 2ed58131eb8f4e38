"""Kernel B4's shapes on the CPU: one generated source per (r, tf, te)
within sy_meta's bounds (the library holds the BA shape), the bounds equal
to the CUDA template's, the dispatch between the library and a generated
source, and the Evaluator's build of its Program's source before any CUDA
graph capture. The kernels themselves run on the card only
(tests/test_torch_cuda_kernels.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch import cuda_lib, eval_kernel
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.linalg import schur_kernels as sk

CSRC = Path(sk.__file__).resolve().parent.parent / "csrc"
SY_PREFIXES = ("ctt_schur_sy_point", "ctt_schur_sy_fold")


def _shapes(r):
    return [(r, tf, te) for tf in range(1, sk.MAX_TF + 1) for te in range(1, sk.MAX_TE + 1)
            if r * tf <= sk.MAX_RTF]


@pytest.mark.parametrize("r", range(1, sk.MAX_R + 1))
def test_sy_source_is_one_per_shape(r):
    """Every shape sy_meta admits has one source, the same text each time,
    that instantiates the template's entry points at that shape."""
    shapes = _shapes(r)
    sources = [sk.sy_source(*s) for s in shapes]
    assert len(set(sources)) == len(shapes)
    sk.sy_source.cache_clear()
    assert [sk.sy_source(*s) for s in shapes] == sources
    for (rr, tf, te), src in zip(shapes, sources):
        assert '#include "schur_sy.cuh"' in src
        assert re.findall(r"CTT_SCHUR_SY_ENTRY\((\d+), (\d+), (\d+)\)", src) == [
            (str(rr), str(tf), str(te))]


@pytest.mark.parametrize("shape", [(0, 9, 3), (5, 6, 3), (2, 17, 3), (2, 9, 9), (3, 11, 3),
                                   (4, 9, 1), (2, 9, 0)])
def test_sy_source_refuses_shapes_outside_the_bounds(shape):
    assert not sk.sy_shape_ok(*shape)
    with pytest.raises(ValueError, match="outside"):
        sk.sy_source(*shape)


def test_bounds_equal_the_template_constants():
    """MAX_R, MAX_TF, MAX_TE and MAX_RTF are schur_sy.cuh's kMax*, and the
    library instantiates BA_SHAPE."""
    header = (CSRC / "schur_sy.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (kMax\w+) = (\d+);", header))
    assert {k: int(v) for k, v in consts.items()} == {
        "kMaxR": sk.MAX_R, "kMaxTf": sk.MAX_TF, "kMaxTe": sk.MAX_TE, "kMaxRTf": sk.MAX_RTF}
    library = (CSRC / "schur_sy.cu").read_text()
    entries = re.findall(r"^CTT_SCHUR_SY_ENTRY\((\d+), (\d+), (\d+)\)", library, re.M)
    assert [tuple(map(int, e)) for e in entries] == [sk.BA_SHAPE]
    # no shape is sized at run time any more: every kernel takes kR, kTf, kTe
    assert "kExact" not in header and "kMaxTe, false" not in header


@pytest.mark.parametrize("prefix", SY_PREFIXES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 3), (2, 10, 3), (2, 6, 3), (3, 9, 3), (2, 9, 4)])
def test_dispatch_library_or_generated(monkeypatch, prefix, dtype, shape):
    """The BA shape runs the library's entry point, every other shape the
    generated source of its own shape (nothing is built or loaded here)."""
    calls = []
    monkeypatch.setattr(cuda_lib, "kernel_fn", lambda p, d: calls.append(("library", p, d)))
    monkeypatch.setattr(cuda_lib, "generated_fn",
                        lambda src, d, p: calls.append(("generated", src, p, d)))
    r, tf, te = shape
    sk._sy_fn({"r": r, "tf": tf, "te": te}, prefix, dtype)
    if shape == sk.BA_SHAPE:
        assert calls == [("library", prefix, dtype)]
    else:
        assert calls == [("generated", sk.sy_source(*shape), prefix, dtype)]


def _ba(use_quaternions=False, use_manifolds=False, seed=1):
    bal = ct.synthetic_bal(8, 2000, 40_000, seed=seed)
    return ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0), use_quaternions=use_quaternions,
                               use_manifolds=use_manifolds)[0].compile("cpu")


@pytest.mark.parametrize("case,tf", [("angle_axis", 9), ("quaternion_manifold", 9),
                                     ("quaternion_no_manifold", 10)])
def test_ba_programs_record_their_source(case, tf):
    """The no-manifold quaternion Program (tangent 10: bundle_adjuster
    --use_quaternions) records its shape's source and the Evaluator builds
    it; the tangent-9 cameras take the library's kernels and build none."""
    program = _ba(use_quaternions=case != "angle_axis", use_manifolds=case == "quaternion_manifold")
    meta = sk.sy_meta(program)
    assert (meta["r"], meta["tf"], meta["te"]) == (2, tf, 3)
    want = None if tf == 9 else sk.sy_source(2, 10, 3)
    assert meta["source"] == want and sk.sy_route(meta) == want
    assert sk.sy_sources(program) == ([] if want is None else [want])
    assert Evaluator(program, torch.float32).sy_sources() == sk.sy_sources(program)


def test_sy_sources_without_b4():
    """A Program B4 does not serve (several groups; no layout plans) builds
    no B4 source."""
    from ceres_tpu_torch.examples import denoising

    img = np.random.default_rng(0).uniform(0, 255, (20, 18))
    foe = denoising.synthetic_foe_model(3, 2, seed=0)
    program = denoising.build_foe_denoising_problem(img, foe)[0].compile("cpu")
    assert sk.sy_meta(program) is None and sk.sy_sources(program) == []
    bal = ct.synthetic_bal(4, 60, 300, seed=3)  # below the layout plans' threshold
    small = ct.build_ba_problem(bal, use_quaternions=True)[0].compile("cpu")
    assert sk.sy_meta(small) is None and sk.sy_sources(small) == []


def test_evaluator_sources_go_in_one_batch(monkeypatch):
    """prepare_generic builds the Evaluator's B4 sources in the batch of B1
    generic's sources: one build_generated call."""
    program = _ba(use_quaternions=True)
    ev = Evaluator(program, torch.float32)
    batches = []
    monkeypatch.setattr(cuda_lib, "build_generated", lambda srcs: batches.append(list(srcs)))
    eval_kernel.prepare_generic(program, ev.arrays, torch.float32, ev.sy_sources())
    assert batches == [[sk.sy_source(2, 10, 3)]]


def test_build_refused_inside_a_capture(monkeypatch):
    """A kernel build inside a CUDA graph capture raises before any nvcc
    runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(cuda_lib, "_build_generated",
                        lambda srcs: pytest.fail("nvcc ran inside a capture"))
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        cuda_lib.build_generated([sk.sy_source(2, 10, 3)])


@pytest.mark.parametrize("prefix,dtype", [("ctt_schur_sy_point", torch.float16),
                                          ("ctt_schur_sy_fold", torch.int32),
                                          ("ctt_eval_generic", torch.bfloat16)])
def test_generated_entry_point_refuses_a_dtype(monkeypatch, prefix, dtype):
    """generated_fn takes the dtypes the library's kernel of that name
    takes, and refuses others before building anything."""
    monkeypatch.setattr(cuda_lib, "build_generated",
                        lambda srcs: pytest.fail("built for an unsupported dtype"))
    with pytest.raises(TypeError, match="unsupported dtype"):
        cuda_lib.generated_fn(sk.sy_source(2, 10, 3), dtype, prefix)
