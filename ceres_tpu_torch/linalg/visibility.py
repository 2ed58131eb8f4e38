"""Visibility-based preconditioners: CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL.

Port of `ceres_tpu.linalg.visibility` without its sharding branches
(reference: visibility_based_preconditioner.cc, visibility.cc,
canonical_views_clustering.cc, single_linkage_clustering.cc,
graph_algorithms.h Degree2MaximumSpanningForest).

The cameras are clustered by scene visibility; the Schur complement S is
restricted to the blocks within a cluster (CLUSTER_JACOBI) or within a
cluster and along the edges of a degree-2 maximum spanning forest of the
clusters (CLUSTER_TRIDIAGONAL), and that matrix is factored.

The structure is host numpy, computed once per Program and preconditioner
(`_AssemblyPlan`, cached on the Program): the observation streams, the
visibility graph, the clustering, the forest, and each camera pair's
destination. Everything with values runs on the Program's device in plain
torch, as the JAX package computes it outside any Pallas kernel:

  assembly           per observation w = EᵀF [te, tf] and M⁻¹w; per pair
                     of observations of one point routed to a block, the
                     block w_aᵀ M⁻¹ w_b, summed per destination block. The
                     pairs are sorted by destination on the host, so each
                     block is one segment reduced in a fixed order
                     (torch.segment_reduce) and added once: two builds give
                     bitwise-equal factors, with no atomics racing.
  CLUSTER_JACOBI     one padded dense matrix per cluster, batched per
                     power-of-two size bucket; batched Cholesky, and the
                     apply is two triangular solves.
  CLUSTER_TRIDIAGONAL the forest's trees are paths, so each is a
                     block-tridiagonal chain: a block-Cholesky sweep along
                     the chains (batched across chains) and a forward and a
                     backward sweep per apply, one step at a time. Where the
                     first factorization is not finite the one with the
                     off-diagonal blocks halved is taken (a torch.where
                     between both, as the JAX package's lax.cond;
                     visibility_based_preconditioner.cc:332-388 retries the
                     same way).

Nothing in the build or the apply reads a device value on the host, so
both run under torch.cuda.set_sync_debug_mode("error") once the plan's
tables are on the device. A failed Cholesky gives NaN factors, as
jnp.linalg.cholesky does, and the matrices are symmetrized first, as it
does.

Approximations (quality only, as in the JAX package): pair corrections are
accumulated within each (signature group, camera position) stream; cross-
group and cross-position couplings of the same point are dropped.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# reference: visibility_based_preconditioner.cc:63-65
CANONICAL_VIEWS_SIZE_PENALTY = 3.0
CANONICAL_VIEWS_SIMILARITY_PENALTY = 0.0
CANONICAL_VIEWS_MIN_VIEWS = 3
SINGLE_LINKAGE_MIN_SIMILARITY = 0.9

PAIR_CHUNK = 262_144  # pair blocks per segment reduce
MAX_STORAGE_FLOATS = 1_500_000_000  # refuse preconditioners that can't fit


# --------------------------------------------------------------------- #
# host: observation streams, visibility graph, clustering
# --------------------------------------------------------------------- #


def _camera_streams(program, jac_e, jac_f):
    """Identify the e-class and the camera class; collect per-(group,
    f-position) observation streams as host arrays.

    Returns (e_cls, cam_cls, streams) with streams =
    [(gi, e_vpos, f_vpos, point_rows, cam_rows)] where *_rows are class-row
    arrays of length meta.n. Raises ValueError when the problem is not
    BA-shaped (multiple e-classes, or camera positions of mixed classes).
    """
    e_cls = None
    cam_cls = None
    streams = []
    for gi, meta in enumerate(program.groups):
        if not jac_e.jac_groups[gi]:
            continue
        e_pos = jac_e.positions[gi][0]
        pm_e = meta.positions[e_pos]
        if e_cls is None:
            e_cls = pm_e.t_cls
        elif e_cls != pm_e.t_cls:
            raise ValueError("CLUSTER_* preconditioners need a single e-block class")
        pt_rows = program.group_idx[gi]["t_rows"][e_pos]
        for fv, f_pos in enumerate(jac_f.positions[gi]):
            pm_f = meta.positions[f_pos]
            if pm_f.t_cls < 0:
                continue
            if cam_cls is None:
                cam_cls = pm_f.t_cls
            elif pm_f.t_cls != cam_cls:
                raise ValueError("CLUSTER_* preconditioners need camera blocks of one size")
            cam_rows = program.group_idx[gi]["t_rows"][f_pos]
            streams.append((gi, 0, fv, pt_rows, cam_rows))
    if e_cls is None or cam_cls is None:
        raise ValueError("no e-block/camera structure for CLUSTER_* preconditioner")
    return e_cls, cam_cls, streams


def _visibility_edges(streams, n_cams, n_points):
    """Camera similarity graph from shared-point counts.

    reference: visibility.cc CreateSchurComplementGraph — edge weight
    w(c1,c2) = |V1 ∩ V2| / sqrt(|V1| |V2|) over per-camera visible-point
    sets. Returns (ci, cj, w) with ci < cj, plus per-camera visibility
    counts.
    """
    pt = np.concatenate([s[3] for s in streams])
    cam = np.concatenate([s[4] for s in streams])
    keep = cam < n_cams  # drop constant-camera dump rows
    pt, cam = pt[keep], cam[keep]
    # distinct (point, camera) incidences
    inc = np.unique(pt.astype(np.int64) * n_cams + cam.astype(np.int64))
    pti = inc // n_cams
    cami = (inc % n_cams).astype(np.int64)
    vis_count = np.bincount(cami, minlength=n_cams)

    order = np.argsort(pti, kind="stable")
    pti, cami = pti[order], cami[order]
    uniq, starts, counts = np.unique(pti, return_index=True, return_counts=True)
    pair_i, pair_j = [], []
    for d in np.unique(counts):
        if d < 2:
            continue
        sel = counts == d
        idx = starts[sel][:, None] + np.arange(d)[None, :]
        cams_d = np.sort(cami[idx], axis=1)  # [m, d] sorted within each point
        iu, ju = np.triu_indices(int(d), k=1)
        pair_i.append(cams_d[:, iu].reshape(-1))
        pair_j.append(cams_d[:, ju].reshape(-1))
    if pair_i:
        pi = np.concatenate(pair_i)
        pj = np.concatenate(pair_j)
        key = pi * n_cams + pj
        ukey, cnt = np.unique(key, return_counts=True)
        ci = ukey // n_cams
        cj = ukey % n_cams
        denom = np.sqrt(vis_count[ci].astype(np.float64) * vis_count[cj])
        w = cnt / np.maximum(denom, 1.0)
    else:
        ci = cj = np.zeros(0, dtype=np.int64)
        w = np.zeros(0)
    return ci, cj, w, vis_count


def canonical_views_clustering(
    n_cams,
    ci,
    cj,
    w,
    vis_count,
    min_views=CANONICAL_VIEWS_MIN_VIEWS,
    size_penalty_weight=CANONICAL_VIEWS_SIZE_PENALTY,
    similarity_penalty_weight=CANONICAL_VIEWS_SIMILARITY_PENALTY,
    view_score_weight=0.0,
):
    """Greedy canonical-views clustering (canonical_views_clustering.cc).

    Quality difference of adding candidate v:
      view_score_weight * 1.0
      + sum_neighbors max(0, w(v,n) - current_similarity(n))
      - size_penalty_weight
      - similarity_penalty_weight * sum_centers w(center, v)
    Self edges of weight 1.0 are included (visibility.cc:123-127).
    Cameras left unassigned become singleton clusters
    (FlattenMembershipMap, visibility_based_preconditioner.cc:536-560).
    Returns (membership [n_cams], n_clusters).
    """
    # symmetric neighbor lists incl. self edges
    src = np.concatenate([ci, cj, np.arange(n_cams)])
    dst = np.concatenate([cj, ci, np.arange(n_cams)])
    ww = np.concatenate([w, w, np.ones(n_cams)])
    only_observed = vis_count > 0

    sim = np.zeros(n_cams)  # similarity to current canonical view
    assign = np.full(n_cams, -1, dtype=np.int64)
    valid = only_observed.copy()
    centers = []
    while valid.any():
        gain_e = np.maximum(0.0, ww - sim[dst])
        gain = np.bincount(src, weights=gain_e, minlength=n_cams)
        score = view_score_weight + gain - size_penalty_weight
        if centers and similarity_penalty_weight:
            # penalty: similarity of candidate to existing centers
            pen = np.zeros(n_cams)
            cmask = np.isin(src, centers)
            np.add.at(pen, dst[cmask], ww[cmask])
            score = score - similarity_penalty_weight * pen
        score = np.where(valid, score, -np.inf)
        best = int(np.argmax(score))
        if score[best] <= 0 and len(centers) >= min_views:
            break
        centers.append(best)
        valid[best] = False
        upd = src == best
        better = ww[upd] > sim[dst[upd]]
        tgt = dst[upd][better]
        assign[tgt] = best
        sim[tgt] = ww[upd][better]

    membership = np.full(n_cams, -1, dtype=np.int64)
    for k, c in enumerate(centers):
        membership[assign == c] = k
    nclusters = len(centers)
    for cam in np.nonzero(membership < 0)[0]:
        membership[cam] = nclusters
        nclusters += 1
    return membership, nclusters


def single_linkage_clustering(n_cams, ci, cj, w, min_similarity=SINGLE_LINKAGE_MIN_SIMILARITY):
    """Union-find over edges with w >= min_similarity
    (single_linkage_clustering.cc:40-120)."""
    parent = list(range(n_cams))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    strong = np.asarray(w) >= min_similarity
    for a, b in zip(np.asarray(ci)[strong].tolist(), np.asarray(cj)[strong].tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(i) for i in range(n_cams)], dtype=np.int64)
    _, membership = np.unique(roots, return_inverse=True)
    return membership.astype(np.int64), int(membership.max()) + 1 if n_cams else 0


def degree2_max_spanning_forest(n_clusters, ei, ej, w):
    """Greedy degree-2 maximum-weight spanning forest -> set of paths.

    reference: graph_algorithms.h:261-330. Returns chains: list of cluster-id
    paths covering every cluster exactly once (singletons included).
    """
    order = np.argsort(-np.asarray(w), kind="stable")
    deg = [0] * n_clusters
    parent = list(range(n_clusters))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    adj = [[] for _ in range(n_clusters)]
    for a, b in zip(np.asarray(ei)[order].tolist(), np.asarray(ej)[order].tolist()):
        if deg[a] >= 2 or deg[b] >= 2:
            continue
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        parent[ra] = rb
        deg[a] += 1
        deg[b] += 1
        adj[a].append(b)
        adj[b].append(a)

    chains = []
    seen = np.zeros(n_clusters, dtype=bool)
    for c in range(n_clusters):
        if seen[c] or len(adj[c]) > 1:
            continue
        # endpoint (deg<=1): walk the path
        chain = [c]
        seen[c] = True
        cur, prev = c, -1
        while True:
            nxt = [x for x in adj[cur] if x != prev]
            if not nxt:
                break
            prev, cur = cur, nxt[0]
            chain.append(cur)
            seen[cur] = True
        chains.append(chain)
    assert seen.all(), "degree-2 forest must cover all clusters with paths"
    return chains


def _cluster_graph(membership, ci, cj, w):
    """The cluster graph: (ei, ej, ew) summing the camera-pair similarity
    over each pair of clusters, in the order each pair is first met along
    the camera edges, each sum taken in edge order."""
    ca, cb = membership[ci], membership[cj]
    cross = ca != cb
    lo, hi = np.minimum(ca, cb)[cross], np.maximum(ca, cb)[cross]
    if lo.size == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), np.zeros(0)
    n = int(membership.max()) + 1
    ukey, first, inv = np.unique(lo * n + hi, return_index=True, return_inverse=True)
    sums = np.bincount(inv, weights=np.asarray(w)[cross])
    met = np.argsort(first, kind="stable")
    return ukey[met] // n, ukey[met] % n, sums[met]


# --------------------------------------------------------------------- #
# host: assembly plan (structure only; cached on the Program)
# --------------------------------------------------------------------- #


class _AssemblyPlan:
    """Static routing tables for the on-device assembly of cluster blocks.
    `seconds` is the host time the plan took; `tables(device, dtype)` puts
    its index tables on a device once."""

    def __init__(self, program, jac_e, jac_f, kind, clustering_type):
        from ..types import PreconditionerType, VisibilityClusteringType

        t0 = time.perf_counter()
        self.kind = kind
        e_cls, cam_cls, streams = _camera_streams(program, jac_e, jac_f)
        self.e_cls, self.cam_cls = e_cls, cam_cls
        n_cams = program.tangent_class_counts[cam_cls]
        n_points = program.tangent_class_counts[e_cls]
        self.n_cams = n_cams
        self.tf = program.tangent_class_sizes[cam_cls]
        self.te = program.tangent_class_sizes[e_cls]

        ci, cj, w, vis_count = _visibility_edges(streams, n_cams, n_points)
        if clustering_type == VisibilityClusteringType.SINGLE_LINKAGE:
            membership, n_clusters = single_linkage_clustering(n_cams, ci, cj, w)
        else:
            membership, n_clusters = canonical_views_clustering(n_cams, ci, cj, w, vis_count)
        self.membership = membership
        self.n_clusters = n_clusters

        # members of each cluster, sorted by class row
        member_of = np.zeros(n_cams, dtype=np.int64)
        order = np.argsort(membership, kind="stable")
        counts = np.bincount(membership, minlength=n_clusters)
        members = np.split(order, np.cumsum(counts)[:-1])
        for m in members:
            member_of[m] = np.arange(len(m))
        self.members = members
        self.member_of = member_of
        sizes = counts.astype(np.int64)

        if kind == PreconditionerType.CLUSTER_TRIDIAGONAL:
            ei, ej, ew = _cluster_graph(membership, ci, cj, w)
            self.chains = degree2_max_spanning_forest(n_clusters, ei, ej, ew)
            # next-in-chain pointer; edge block of cluster c couples (c ->
            # next[c]) with rows = next's members, cols = c's members
            self.chain_next = np.full(n_clusters, -1, dtype=np.int64)
            for chain in self.chains:
                for a, b in zip(chain[:-1], chain[1:]):
                    self.chain_next[a] = b
            self.L = int(sizes.max()) if n_clusters else 1
            self.storage_floats = (n_clusters * 2 + 64) * (self.L * self.tf) ** 2
            if self.storage_floats > MAX_STORAGE_FLOATS:
                raise ValueError(
                    "CLUSTER_TRIDIAGONAL storage too large "
                    f"({self.storage_floats:.2e} floats); use SCHUR_JACOBI"
                )
            self.buckets = [(self.L, np.arange(n_clusters))]
        else:
            # size buckets (next pow2) so padding cost is bounded
            self.chains = None
            self.chain_next = None
            caps = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(sizes, 1))))
            self.buckets = [(int(cap), np.nonzero(caps == cap)[0]) for cap in np.unique(caps)]
            self.storage_floats = sum(len(cl) * (cap * self.tf) ** 2 for cap, cl in self.buckets)
            if self.storage_floats > MAX_STORAGE_FLOATS:
                raise ValueError(
                    "CLUSTER_JACOBI storage too large "
                    f"({self.storage_floats:.2e} floats); use SCHUR_JACOBI"
                )

        # bucket-local index of each cluster
        self.bucket_of = np.zeros(n_clusters, dtype=np.int64)
        self.idx_in_bucket = np.zeros(n_clusters, dtype=np.int64)
        for bi, (cap, cl) in enumerate(self.buckets):
            self.bucket_of[cl] = bi
            self.idx_in_bucket[cl] = np.arange(len(cl))

        self._plan_pairs(streams)
        self._plan_vectors(program)
        self._tables = {}
        self.seconds = time.perf_counter() - t0

    # ---------------- pair routing ---------------- #

    def _plan_pairs(self, streams):
        """Every ordered pair (a, b) of one point's observations in a stream,
        routed to its destination block: within a cluster to the cluster's
        bucket, along a chain edge (cluster(b) -> next = cluster(a)) to the
        edge blocks. Each route's pairs are sorted by destination key
        (stably: point, then a, then b) and cut into chunks of PAIR_CHUNK;
        a chunk's segments are its runs of one key."""
        membership, member_of = self.membership, self.member_of
        tridiag = self.chain_next is not None
        self.streams = []
        for gi, _ev, fv, pt_rows, cam_rows in streams:
            order = np.argsort(pt_rows, kind="stable")
            _, starts, counts = np.unique(pt_rows[order], return_index=True, return_counts=True)
            lanes_a, lanes_b = [], []
            for d in np.unique(counts).tolist():
                obs = order[starts[counts == d][:, None] + np.arange(d)[None, :]]  # [m, d]
                lanes_a.append(np.repeat(obs, d, axis=1).reshape(-1))
                lanes_b.append(np.tile(obs, (1, d)).reshape(-1))
            la, lb = np.concatenate(lanes_a), np.concatenate(lanes_b)
            cams_a, cams_b = cam_rows[la], cam_rows[lb]
            live_a, live_b = cams_a < self.n_cams, cams_b < self.n_cams
            ca = np.where(live_a, membership[np.minimum(cams_a, self.n_cams - 1)], -1)
            cb = np.where(live_b, membership[np.minimum(cams_b, self.n_cams - 1)], -1)
            ma = np.where(live_a, member_of[np.minimum(cams_a, self.n_cams - 1)], 0)
            mb = np.where(live_b, member_of[np.minimum(cams_b, self.n_cams - 1)], 0)
            valid = (ca >= 0) & (cb >= 0)
            same = valid & (ca == cb)
            routes = {}
            for bi, (cap, _cl) in enumerate(self.buckets):
                sel = np.nonzero(same & (self.bucket_of[np.maximum(ca, 0)] == bi))[0]
                key = self.idx_in_bucket[ca[sel]] * cap * cap + ma[sel] * cap + mb[sel]
                routes[("bucket", bi)] = (la[sel], lb[sel], key)
            if tridiag:
                L = self.L
                edge = valid & (ca != cb) & (self.chain_next[np.maximum(cb, 0)] == ca)
                sel = np.nonzero(edge)[0]
                routes[("edge", 0)] = (la[sel], lb[sel], cb[sel] * L * L + ma[sel] * L + mb[sel])
            planned = {}
            for dest, (a, b, key) in routes.items():
                if key.size == 0:
                    continue
                perm = np.argsort(key, kind="stable")
                a, b, key = a[perm], b[perm], key[perm]
                chunks, seg_keys, seg_lens = [], [], []
                for p0 in range(0, key.size, PAIR_CHUNK):
                    uk, cnt = np.unique(key[p0 : p0 + PAIR_CHUNK], return_counts=True)
                    s0 = sum(len(k) for k in seg_keys)
                    chunks.append((p0, min(p0 + PAIR_CHUNK, key.size), s0, s0 + len(uk)))
                    seg_keys.append(uk)
                    seg_lens.append(cnt)
                planned[dest] = dict(
                    a=a, b=b, chunks=chunks,
                    keys=np.concatenate(seg_keys), lengths=np.concatenate(seg_lens),
                )
            self.streams.append(dict(gi=gi, fv=fv, pts=pt_rows, routes=planned))

    @property
    def num_pairs(self) -> int:
        """Pair blocks one build forms."""
        return sum(r["a"].size for st in self.streams for r in st["routes"].values())

    # ---------------- vector gather/scatter ---------------- #

    def _plan_vectors(self, program):
        """Tangent indices of each padded cluster slot (pad -> num_eff)."""
        tf = self.tf
        base = int(program.tangent_class_bases[self.cam_cls])
        num_eff = self.num_eff = program.num_effective_parameters
        self.vec_idx = []  # per bucket [n_b, cap*tf]
        for cap, cl in self.buckets:
            idx = np.full((len(cl), cap * tf), num_eff, dtype=np.int32)
            for k, c in enumerate(cl):
                rows = self.members[c]
                pos = (base + rows[:, None] * tf + np.arange(tf)[None, :]).reshape(-1)
                idx[k, : pos.size] = pos
            self.vec_idx.append(idx)
        # padded-slot diagonal mask per bucket (1 where padding)
        self.pad_diag = [(idx == num_eff).astype(np.float64) for idx in self.vec_idx]
        if self.chains is not None:
            K = max(len(c) for c in self.chains)
            self.chain_mat = np.full((len(self.chains), K), -1, dtype=np.int64)
            for i, c in enumerate(self.chains):
                self.chain_mat[i, : len(c)] = c
            self.K = K

    # ---------------- device tables ---------------- #

    def tables(self, device, dtype):
        """The plan's index (and pad mask) tables on `device`, made once."""
        key = (torch.device(device), dtype)
        if key not in self._tables:
            self._tables[key] = self._make_tables(key[0], dtype)
        return self._tables[key]

    def _make_tables(self, dev, dtype):
        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64, device=dev)

        out = {"streams": []}
        for st in self.streams:
            out["streams"].append({
                "pts": ints(st["pts"]),
                "routes": {
                    dest: dict(a=ints(r["a"]), b=ints(r["b"]), keys=ints(r["keys"]),
                               lengths=ints(r["lengths"]), chunks=r["chunks"])
                    for dest, r in st["routes"].items()
                },
            })
        # member camera rows of each padded slot (pad -> the zero row n_cams)
        out["diag_rows"], out["pad_diag"], out["scatter"] = [], [], []
        for (cap, cl), vidx, pad in zip(self.buckets, self.vec_idx, self.pad_diag):
            rows = np.full((len(cl), cap), self.n_cams, dtype=np.int64)
            for k, c in enumerate(cl):
                rows[k, : len(self.members[c])] = self.members[c]
            out["diag_rows"].append(ints(rows.reshape(-1)))
            out["pad_diag"].append(torch.as_tensor(pad, dtype=dtype, device=dev))
            real = np.nonzero(pad.reshape(-1) == 0)[0]
            out["scatter"].append((ints(vidx.reshape(-1)), ints(real), ints(vidx.reshape(-1)[real])))
        if self.chains is not None:
            n_cl, K = self.n_clusters, self.K
            cm = self.chain_mat
            cidx = np.where(cm >= 0, cm, n_cl)
            # the edge of chain position k couples k -> k+1 and is stored
            # under the earlier cluster; the last position has none
            succ = np.full(cm.shape, n_cl, dtype=np.int64)
            succ[:, : K - 1] = cidx[:, 1:]
            eidx = np.where((cm >= 0) & (succ < n_cl), np.maximum(cm, 0), n_cl)
            s = self.L * self.tf
            vec_pad = np.concatenate([self.vec_idx[0], np.full((1, s), self.num_eff, np.int32)])
            gidx = vec_pad[cidx].transpose(1, 0, 2)  # [K, nch, s]
            flat = gidx.reshape(-1)
            real = np.nonzero(flat < self.num_eff)[0]
            out["chain"] = dict(
                cidx=ints(cidx.T), eidx=ints(eidx.T), gidx=ints(gidx),
                real=ints(real), real_idx=ints(flat[real]),
            )
        return out


# --------------------------------------------------------------------- #
# device: assembly + apply
# --------------------------------------------------------------------- #


def _cholesky(a):
    """Lower Cholesky factors of the symmetrized a, NaN where a factor
    fails (jnp.linalg.cholesky's contract; cholesky_ex does not
    synchronize)."""
    lower, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    return torch.where((info == 0)[..., None, None], lower, float("nan"))


def _cho_solve(lower, v):
    """(L Lᵀ)⁻¹ v for batched factors and vectors [..., s] (two triangular
    solves, as jax.scipy.linalg.cho_solve)."""
    y = torch.linalg.solve_triangular(lower, v[..., None], upper=False)
    return torch.linalg.solve_triangular(lower.mT, y, upper=True)[..., 0]


def _sum_products(a, b, k):
    """Σ_i a[:, :, i] b[:, i, :] over k terms, in index order:
    [m, p, k] x [m, k, q] -> [m, p, q] without a batched tiny GEMM."""
    out = a[:, :, 0, None] * b[:, None, 0, :]
    for i in range(1, k):
        out = out + a[:, :, i, None] * b[:, None, i, :]
    return out


def _whole_leaves(program, jac):
    """The Jacobian's leaves in the Program's lane order: its own without a
    mesh; on a rank's shard every rank's lanes, gathered over the mesh and
    put back in the Program's order, pad lanes dropped (the GSPMD gather of
    ceres_tpu/linalg/visibility.py:520-545: the pair plan pairs lanes of
    one point, which a layout without bucket plans may split between
    ranks). Every rank then assembles the same blocks."""
    mesh = jac.mesh
    if mesh is None:
        return jac.jac_groups
    layouts = program.build_shard_layout(mesh.size)
    out = []
    for gi, leaves in enumerate(jac.jac_groups):
        perm = layouts[gi]["perm"]
        real = np.nonzero(perm >= 0)[0]
        inv = np.empty(program.groups[gi].n, dtype=np.int64)
        inv[perm[real]] = real
        idx = torch.as_tensor(inv, device=jac._device())
        out.append(tuple(mesh.all_gather_lanes(leaf).index_select(1, idx) for leaf in leaves))
    return out


class VisibilityPreconditioner:
    """CLUSTER_JACOBI / CLUSTER_TRIDIAGONAL over a BA-shaped problem.

    Built per LM step from the scaled Jacobian's E and F views and the
    factorized (EᵀE + D_e²)⁻¹; applied inside the PCG loop on the reduced
    camera system to flat vectors. Camera-class entries get M⁻¹r; entries
    of other classes pass through unchanged.
    """

    def __init__(self, program, jac_e, jac_f, ete_solver, dsq_f, kind, clustering_type):
        self.plan = program.cached(
            ("visibility", kind, clustering_type),
            lambda p: _AssemblyPlan(p, jac_e, jac_f, kind, clustering_type),
        )
        self.program = program
        # the assembly reads the [r*t, n] leaves with the scale folded in
        jac_e = jac_e.materialize_scale()
        jac_f = jac_f.materialize_scale()
        self._dtype, self._device = dsq_f.dtype, dsq_f.device
        self.tables = self.plan.tables(self._device, self._dtype)
        self._build(jac_e, jac_f, ete_solver, dsq_f)

    # ---------------- assembly ---------------- #

    def _corrections(self, jac_e, jac_f, ete_solver):
        """Per-bucket (and edge) pair corrections Σ w_aᵀ M⁻¹ w_b, one row
        of tf*tf per destination block, over the Program's lanes (on a
        rank's shard every rank's, gathered: _whole_leaves)."""
        plan = self.plan
        e_leaves = _whole_leaves(self.program, jac_e)
        f_leaves = _whole_leaves(self.program, jac_f)
        tf, te = plan.tf, plan.te
        opts = dict(dtype=self._dtype, device=self._device)
        acc = {
            ("bucket", bi): torch.zeros((len(cl) * cap * cap, tf * tf), **opts)
            for bi, (cap, cl) in enumerate(plan.buckets)
        }
        if plan.chain_next is not None:
            acc[("edge", 0)] = torch.zeros((plan.n_clusters * plan.L * plan.L, tf * tf), **opts)
        inv_e = ete_solver.inv_tables[plan.e_cls]  # [te*te, cnt]
        for st, st_t in zip(plan.streams, self.tables["streams"]):
            r = self.program.groups[st["gi"]].num_residuals
            ej = e_leaves[st["gi"]][0].reshape(r, te, -1)
            fj = f_leaves[st["gi"]][st["fv"]].reshape(r, tf, -1)
            # w = EᵀF per observation [n, te, tf], then M⁻¹w
            w = _sum_products(ej.permute(2, 1, 0), fj.permute(2, 0, 1), r).contiguous()
            minv = inv_e.T.index_select(0, st_t["pts"]).reshape(-1, te, te)
            minvw = _sum_products(minv, w, te).contiguous()
            for dest, route in st_t["routes"].items():
                for p0, p1, s0, s1 in route["chunks"]:
                    ya = w.index_select(0, route["a"][p0:p1])
                    yb = minvw.index_select(0, route["b"][p0:p1])
                    blocks = _sum_products(ya.mT, yb, te).reshape(-1, tf * tf)
                    part = torch.segment_reduce(
                        blocks, "sum", lengths=route["lengths"][s0:s1], unsafe=True
                    )
                    # each key once per chunk: one add per block, no race
                    acc[dest].index_add_(0, route["keys"][s0:s1], part)
        return acc

    def _dense_buckets(self, corr, ftf_cam):
        """[n_b, cap*tf, cap*tf] per bucket: diag(FᵀF + D_f²) − corrections,
        the identity on padded slots, and a 1e-12 relative ridge."""
        plan = self.plan
        tf = plan.tf
        ftf_pad = torch.cat([ftf_cam, ftf_cam.new_zeros((1, tf, tf))])
        out = []
        for bi, (cap, cl) in enumerate(plan.buckets):
            nb = len(cl)
            dense = -corr[("bucket", bi)].reshape(nb, cap, cap, tf, tf)
            diag = ftf_pad.index_select(0, self.tables["diag_rows"][bi]).reshape(nb, cap, tf, tf)
            dense.diagonal(dim1=1, dim2=2).add_(diag.permute(0, 2, 3, 1))
            dense = dense.permute(0, 1, 3, 2, 4).reshape(nb, cap * tf, cap * tf)
            dense.diagonal(dim1=1, dim2=2).add_(self.tables["pad_diag"][bi])
            eps = 1e-12 * torch.clamp_min(dense.abs().amax(dim=(1, 2)), 1.0)
            dense.diagonal(dim1=1, dim2=2).add_(eps[:, None])
            out.append(dense)
        return out

    def _build(self, jac_e, jac_f, ete_solver, dsq_f):
        self.factors = self._factor(*self._assemble(jac_e, jac_f, ete_solver, dsq_f))

    def _assemble(self, jac_e, jac_f, ete_solver, dsq_f):
        """(the dense bucket matrices, the pair corrections)."""
        plan = self.plan
        corr = self._corrections(jac_e, jac_f, ete_solver)
        ftf = jac_f.block_diag_jtj(dsq=dsq_f)
        # [tf*tf, count] transposed table -> [count, tf, tf] block rows
        ftf_cam = ftf[plan.cam_cls].T.reshape(-1, plan.tf, plan.tf)
        return self._dense_buckets(corr, ftf_cam), corr

    def _factor(self, dense, corr):
        """CLUSTER_JACOBI: the Cholesky factor of each bucket's matrices;
        CLUSTER_TRIDIAGONAL: (L, E) along the chains."""
        plan = self.plan
        if plan.chain_next is None:
            return [_cholesky(d) for d in dense]
        # one bucket at the global pad L; block-Cholesky along the chains
        s = plan.L * plan.tf
        d_all = dense[0]  # [n_clusters, s, s]
        edges = corr[("edge", 0)].reshape(plan.n_clusters, plan.L, plan.L, plan.tf, plan.tf)
        # S = FᵀF − corr; edge blocks have no FᵀF part
        b_all = -edges.permute(0, 1, 3, 2, 4).reshape(plan.n_clusters, s, s)
        eye = torch.eye(s, dtype=d_all.dtype, device=d_all.device)
        ch = self.tables["chain"]
        d_seq = torch.cat([d_all, eye[None]])[ch["cidx"]]  # [K, nch, s, s]
        b_seq = torch.cat([b_all, torch.zeros_like(eye)[None]])[ch["eidx"]]
        l_seq, e_seq = self._factor_chain(d_seq, b_seq, eye)
        bad = ~torch.isfinite(l_seq).all()
        # the reference's retry with the off-diagonal blocks halved, taken
        # on the device where the first factorization is not finite
        l_half, e_half = self._factor_chain(d_seq, 0.5 * b_seq, eye)
        return torch.where(bad, l_half, l_seq), torch.where(bad, e_half, e_seq)

    @staticmethod
    def _factor_chain(d_seq, b_seq, eye):
        """L_k L_kᵀ = D_k − E_{k−1} E_{k−1}ᵀ, E_k = B_k L_k⁻ᵀ down the chains."""
        K = d_seq.shape[0]
        carry = d_seq[0]
        ls, es = [], []
        for k in range(K):
            l_k = _cholesky(carry)
            # E_k = B_k L_k^{-T}: solve L_k X = B_kᵀ, E = Xᵀ
            e_k = torch.linalg.solve_triangular(l_k, b_seq[k].mT, upper=False).mT
            d_next = d_seq[k + 1] if k + 1 < K else eye.expand_as(carry)
            carry = d_next - e_k @ e_k.mT
            ls.append(l_k)
            es.append(e_k)
        return torch.stack(ls), torch.stack(es)

    # ---------------- apply ---------------- #

    def __call__(self, r):
        plan = self.plan
        r_pad = torch.cat([r, r.new_zeros((1,))])
        out = r.clone()
        if plan.chain_next is None:
            for bi in range(len(plan.buckets)):
                idx, real, tgt = self.tables["scatter"][bi]
                rhs = r_pad.index_select(0, idx).reshape(self.factors[bi].shape[:2])
                sol = _cho_solve(self.factors[bi], rhs)
                out.index_copy_(0, tgt, sol.reshape(-1).index_select(0, real))
            return out

        # tridiagonal chains: forward, then backward block sweeps
        l_seq, e_seq = self.factors
        ch = self.tables["chain"]
        b_seq = r_pad[ch["gidx"]]  # [K, nch, s]
        K = b_seq.shape[0]
        # forward: y_k = L_k⁻¹ (b_k − E_{k−1} y_{k−1})
        carry = torch.zeros_like(b_seq[0])
        ys = []
        for k in range(K):
            y_k = torch.linalg.solve_triangular(
                l_seq[k], (b_seq[k] - carry)[..., None], upper=False
            )[..., 0]
            carry = (e_seq[k] @ y_k[..., None])[..., 0]
            ys.append(y_k)
        # backward: x_k = L_k⁻ᵀ (y_k − E_kᵀ x_{k+1})
        carry = torch.zeros_like(b_seq[0])
        xs = [None] * K
        for k in reversed(range(K)):
            rhs = ys[k] - (e_seq[k].mT @ carry[..., None])[..., 0]
            carry = torch.linalg.solve_triangular(
                l_seq[k].mT, rhs[..., None], upper=True
            )[..., 0]
            xs[k] = carry
        x = torch.stack(xs).reshape(-1)
        return out.index_copy_(0, ch["real_idx"], x.index_select(0, ch["real"]))
