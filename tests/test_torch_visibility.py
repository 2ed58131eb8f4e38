"""The visibility preconditioners of ceres_tpu_torch (linalg/visibility.py)
against ceres_tpu's, in float64 on the CPU.

- The clusterings (canonical views, single linkage) and the degree-2
  maximum spanning forest give the same integers on hand-made graphs and on
  the visibility graph of synthetic_bal(16, 400, 2000, seed=1).
- The assembly plan's clusters, size buckets, chains and vector indices
  equal the JAX package's, for both kinds and both clusterings.
- The built preconditioner's M⁻¹r equals the JAX package's at 1e-10
  relative, from the same scaled Jacobian, D² and (EᵀE + D_e²)⁻¹.
- Both refuse the same storage, with the same message.
- Two builds give bitwise-equal factors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu
import ceres_tpu_torch as ct
from ceres_tpu.evaluator import evaluate as j_evaluate
from ceres_tpu.io.bal import build_ba_problem as j_build
from ceres_tpu.io.bal import synthetic_bal
from ceres_tpu.linalg import schur as jschur
from ceres_tpu.linalg import visibility as jvis
from ceres_tpu.program import Program as JProgram
from ceres_tpu_torch.evaluator import Evaluator
from ceres_tpu_torch.linalg import schur as tschur
from ceres_tpu_torch.linalg import visibility as tvis
from ceres_tpu_torch.program import Program as TProgram

torch.set_num_threads(1)

KINDS = ["CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"]
CLUSTERINGS = ["CANONICAL_VIEWS", "SINGLE_LINKAGE"]
CASES = [(k, c) for k in KINDS for c in CLUSTERINGS]
IDS = [f"{k.lower()}-{c.lower()}" for k, c in CASES]


def _graph(name):
    """(n, ci, cj, w, vis_count) of a hand-made camera graph."""
    if name == "chains":
        ci, cj, w = [0, 1, 3], [1, 2, 4], [0.95, 0.92, 0.5]
        return 5, np.array(ci), np.array(cj), np.array(w), np.full(5, 10)
    if name == "cliques":
        edges = [(g[i], g[j], 0.9) for g in ([0, 1, 2], [3, 4, 5])
                 for i in range(3) for j in range(i + 1, 3)] + [(2, 3, 0.1)]
        ci, cj, w = (np.array(x) for x in zip(*edges))
        return 6, ci, cj, w, np.full(6, 10)
    if name == "star":
        return 5, np.zeros(4, np.int64), np.arange(1, 5), np.array([4.0, 3.0, 2.0, 1.0]), np.ones(5)
    # a random graph with tied weights and an unobserved camera
    rng = np.random.default_rng(7)
    pairs = sorted({tuple(sorted(rng.choice(12, 2, replace=False))) for _ in range(30)})
    ci, cj = (np.array(x) for x in zip(*pairs))
    w = rng.choice([0.3, 0.5, 0.91, 0.95], size=ci.size)
    vis = rng.integers(0, 20, size=12)
    vis[11] = 0
    return 12, ci, cj, w, vis


@pytest.mark.parametrize("graph", ["chains", "cliques", "star", "random"])
def test_clusterings_and_forest_match_jax_on_hand_made_graphs(graph):
    n, ci, cj, w, vis = _graph(graph)
    for kw in ({}, {"min_views": 0, "size_penalty_weight": 0.5},
               {"min_views": 1, "similarity_penalty_weight": 0.3}):
        tm, tn = tvis.canonical_views_clustering(n, ci, cj, w, vis, **kw)
        jm, jn = jvis.canonical_views_clustering(n, ci, cj, w, vis, **kw)
        assert tn == jn
        np.testing.assert_array_equal(tm, jm)
    for thr in (0.9, 0.4):
        tm, tn = tvis.single_linkage_clustering(n, ci, cj, w, min_similarity=thr)
        jm, jn = jvis.single_linkage_clustering(n, ci, cj, w, min_similarity=thr)
        assert tn == jn
        np.testing.assert_array_equal(tm, jm)
    assert tvis.degree2_max_spanning_forest(n, ci, cj, w) == jvis.degree2_max_spanning_forest(
        n, ci, cj, w)


def _setup(monkeypatch, bal=None, threshold=16):
    """Both programs of synthetic_bal(16, 400, 2000, seed=1) (Huber),
    evaluated in float64, Jacobi-scaled, with D² at radius 1e3: the
    (program, jac_e, jac_f, ete, dsq_f) of each package."""
    monkeypatch.setattr(JProgram, "SEG_REDUCE_THRESHOLD", threshold)
    monkeypatch.setattr(TProgram, "SEG_REDUCE_THRESHOLD", threshold)
    bal = synthetic_bal(16, 400, 2000, seed=1) if bal is None else bal
    jprog = j_build(bal, loss=ceres_tpu.HuberLoss(1.0))[0].compile()
    tprog = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))[0].compile("cpu")
    jjac = j_evaluate(jprog, jprog.arrays(jnp.float64), jprog.state_vector(jnp.float64))[2]
    tjac = Evaluator(tprog, torch.float64).evaluate_groups(tprog.state_vector(torch.float64))[2]
    colnorm = np.asarray(jjac.squared_column_norms())
    scale = 1.0 / (1.0 + np.sqrt(colnorm))
    dsq = np.clip(colnorm * scale**2, 1e-6, 1e32) / 1e3
    out = []
    for prog, jac, xp, views, ete in (
        (jprog, jjac, jnp.asarray, jschur.schur_views, jschur.make_ete_solver),
        (tprog, tjac, torch.tensor, tschur.schur_views, tschur.make_ete_solver),
    ):
        e_mask, f_mask = (xp(m) for m in prog.schur_tangent_masks())
        jac_e, jac_f = views(prog, jac.scale_columns(xp(scale)))
        out.append((prog, jac_e, jac_f, ete(prog, jac_e, xp(dsq) * e_mask), xp(dsq) * f_mask))
    return out


def _kinds(name, clustering):
    return ((getattr(ceres_tpu.PreconditionerType, name),
             getattr(ceres_tpu.VisibilityClusteringType, clustering)),
            (getattr(ct.PreconditionerType, name), getattr(ct.VisibilityClusteringType, clustering)))


def test_visibility_graph_and_clusterings_match_jax_on_synthetic_bal(monkeypatch):
    (jprog, jje, jjf, _, _), (tprog, tje, tjf, _, _) = _setup(monkeypatch)
    je_cls, jcam_cls, jstreams = jvis._camera_streams(jprog, jje, jjf)
    te_cls, tcam_cls, tstreams = tvis._camera_streams(tprog, tje, tjf)
    assert (je_cls, jcam_cls) == (te_cls, tcam_cls)
    n_cams = tprog.tangent_class_counts[tcam_cls]
    n_pts = tprog.tangent_class_counts[te_cls]
    jedges = jvis._visibility_edges(jstreams, n_cams, n_pts)
    tedges = tvis._visibility_edges(tstreams, n_cams, n_pts)
    for a, b in zip(tedges, jedges):
        np.testing.assert_array_equal(a, b)
    ci, cj, w, vis = tedges
    assert ci.size > 50
    tm, tn = tvis.canonical_views_clustering(n_cams, ci, cj, w, vis)
    jm, jn = jvis.canonical_views_clustering(n_cams, ci, cj, w, vis)
    assert (tn, sorted(np.bincount(tm).tolist())) == (jn, [4, 5, 7])
    np.testing.assert_array_equal(tm, jm)
    for lo in (0.9, 0.3):
        tl, tln = tvis.single_linkage_clustering(n_cams, ci, cj, w, lo)
        jl, jln = jvis.single_linkage_clustering(n_cams, ci, cj, w, lo)
        assert tln == jln
        np.testing.assert_array_equal(tl, jl)
    assert tvis.degree2_max_spanning_forest(n_cams, ci, cj, w) == (
        jvis.degree2_max_spanning_forest(n_cams, ci, cj, w))


@pytest.mark.parametrize("name,clustering", CASES, ids=IDS)
def test_assembly_plan_matches_jax(monkeypatch, name, clustering):
    (jprog, jje, jjf, _, _), (tprog, tje, tjf, _, _) = _setup(monkeypatch)
    (jk, jc), (tk, tc) = _kinds(name, clustering)
    jplan = jvis._AssemblyPlan(jprog, jje, jjf, jk, jc)
    tplan = tvis._AssemblyPlan(tprog, tje, tjf, tk, tc)
    assert tplan.n_clusters == jplan.n_clusters
    np.testing.assert_array_equal(tplan.membership, jplan.membership)
    assert [m.tolist() for m in tplan.members] == [m.tolist() for m in jplan.members]
    assert [(c, cl.tolist()) for c, cl in tplan.buckets] == [
        (c, cl.tolist()) for c, cl in jplan.buckets]
    for a, b in zip(tplan.vec_idx, jplan.vec_idx, strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tplan.pad_diag, jplan.pad_diag, strict=True):
        np.testing.assert_array_equal(a, b)
    assert tplan.chains == jplan.chains
    if jplan.chains is not None:
        assert tplan.L == jplan.L and tplan.K == jplan.K
        np.testing.assert_array_equal(tplan.chain_next, jplan.chain_next)
        np.testing.assert_array_equal(tplan.chain_mat, jplan.chain_mat)
    # the same pairs, routed to the same blocks
    routed = {}
    for ch in jplan.chunks:
        for dest, (_sa, _sb, key) in ch["routes"].items():
            routed.setdefault(dest, []).append(key)
    want = {d: np.sort(np.concatenate(k)) for d, k in routed.items()}
    got = {d: np.repeat(r["keys"], r["lengths"]) for st in tplan.streams
           for d, r in st["routes"].items()}
    assert sorted(got) == sorted(want)
    for d in want:
        np.testing.assert_array_equal(got[d], want[d])


@pytest.mark.parametrize("name,clustering", CASES, ids=IDS)
def test_preconditioner_apply_matches_jax(monkeypatch, name, clustering):
    (jprog, jje, jjf, jete, jdsq), (tprog, tje, tjf, tete, tdsq) = _setup(monkeypatch)
    (jk, jc), (tk, tc) = _kinds(name, clustering)
    jprec = jvis.VisibilityPreconditioner(jprog, jje, jjf, jete, jdsq, jk, jc)
    tprec = tvis.VisibilityPreconditioner(tprog, tje, tjf, tete, tdsq, tk, tc)
    rng = np.random.default_rng(3)
    for _ in range(2):
        r = rng.standard_normal(tprog.num_effective_parameters)
        want = np.asarray(jprec(jnp.asarray(r)))
        got = tprec(torch.tensor(r)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    # the camera entries change, the others pass through
    _e, f_mask = tprog.schur_tangent_masks()
    assert not np.allclose(got[f_mask > 0], r[f_mask > 0])
    np.testing.assert_array_equal(got[f_mask == 0], r[f_mask == 0])


@pytest.mark.parametrize("name", KINDS)
def test_storage_refusal_matches_jax(monkeypatch, name):
    (jprog, jje, jjf, _, _), (tprog, tje, tjf, _, _) = _setup(monkeypatch)
    (jk, jc), (tk, tc) = _kinds(name, "CANONICAL_VIEWS")
    monkeypatch.setattr(jvis, "MAX_STORAGE_FLOATS", 1000)
    monkeypatch.setattr(tvis, "MAX_STORAGE_FLOATS", 1000)
    with pytest.raises(ValueError) as jerr:
        jvis._AssemblyPlan(jprog, jje, jjf, jk, jc)
    with pytest.raises(ValueError, match=f"{name} storage too large") as terr:
        tvis._AssemblyPlan(tprog, tje, tjf, tk, tc)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", KINDS)
def test_two_builds_give_bitwise_equal_factors(monkeypatch, name):
    _, (tprog, tje, tjf, tete, tdsq) = _setup(monkeypatch)
    kind = getattr(ct.PreconditionerType, name)
    single = ct.VisibilityClusteringType.SINGLE_LINKAGE
    a = tvis.VisibilityPreconditioner(tprog, tje, tjf, tete, tdsq, kind, single)
    b = tvis.VisibilityPreconditioner(tprog, tje, tjf, tete, tdsq, kind, single)
    assert a.plan is b.plan  # built once per Program
    for x, y in zip(a.factors, b.factors, strict=True):
        assert torch.equal(x, y)
