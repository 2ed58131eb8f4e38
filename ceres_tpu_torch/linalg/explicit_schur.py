"""Explicit sparse Schur complement (SPARSE_SCHUR).

Port of `ceres_tpu.linalg.explicit_schur` (reference:
SparseSchurComplementSolver, schur_complement_solver.cc:265-408): S has one
block per camera pair that shares a point; it is assembled on the device,
crosses to the host in one read and is factored there by SuperLU (the role
SuiteSparse has in the reference); the reduced rhs and the
back-substitution of the eliminated blocks run on the device.

The block structure is host numpy, planned once per Program
(`ExplicitSchurPlan`, cached on it): per point chunk the observations, and
per pair of observations of one point its slot among the unique camera
pairs, and the BSR structure of S. The assembly is plain torch, as the JAX
package computes it outside any Pallas kernel: per observation w = EᵀF
and M⁻¹w, per pair the block w_aᵀ M⁻¹ w_b. The JAX package sums the pair
blocks per slot with segment_sum; here each piece of pairs is sorted by
slot on the host, so each slot's blocks are one segment reduced in a fixed
order (torch.segment_reduce) and added once (each slot once per piece):
two assemblies give bitwise-equal S, with no atomics racing. S is
assembled in the working dtype and factored in float64;
`use_mixed_precision_solves` changes nothing here, as in the JAX package.

Like the reference's eliminator this assumes the BA shape (one e-block
class and one camera class); `ExplicitSchurPlan.get` raises ValueError for
other shapes (visibility._camera_streams), where the step function takes
`schur_solve`'s dense S instead and records that it did.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..utils.execution_summary import record
from ..utils.graphs import read
from .visibility import PAIR_CHUNK, _camera_streams, _sum_products

# floats of gathered leaves and pair products per point chunk
POINT_CHUNK_FLOATS = 4_000_000


def _gather_rows(leaf, width, idx):
    """Per-observation blocks of a [width, n] leaf at the lanes idx [m, d]
    (a long tensor on the leaf's device): [m * d, width]."""
    return leaf.index_select(1, idx.reshape(-1)).T.reshape(-1, width)


class ExplicitSchurPlan:
    """Host block-sparsity plan of S and its device assembly."""

    def __init__(self, program, structure):
        """structure: visibility._camera_streams' (e class, camera class,
        observation streams)."""
        t0 = time.perf_counter()
        e_cls, cam_cls, streams = structure
        self.e_cls, self.cam_cls = e_cls, cam_cls
        self.n_cams = int(program.tangent_class_counts[cam_cls])
        self.tf = int(program.tangent_class_sizes[cam_cls])
        self.te = int(program.tangent_class_sizes[e_cls])
        self._plan(program, streams)
        self._tables = {}
        self.seconds = time.perf_counter() - t0

    @classmethod
    def get(cls, program, jac_e, jac_f):
        """The Program's plan, made at the first call; raises ValueError when
        the problem is not BA-shaped."""
        return program.cached(
            "explicit_schur", lambda p: cls(p, _camera_streams(p, jac_e, jac_f))
        )

    def _plan(self, program, streams):
        """ceres_tpu/linalg/explicit_schur.py:57-123, with each pair piece
        sorted by slot."""
        n_cams = self.n_cams
        chunks = []
        all_keys = [np.arange(n_cams, dtype=np.int64) * n_cams + np.arange(n_cams)]
        for gi, _ev, fv, pt_rows, cam_rows in streams:
            order = np.argsort(pt_rows, kind="stable")
            spt = pt_rows[order]
            uniq, starts, counts = np.unique(spt, return_index=True, return_counts=True)
            r = program.groups[gi].num_residuals
            for d in np.unique(counts):
                d = int(d)
                sel = counts == d
                obs_idx = order[starts[sel][:, None] + np.arange(d)[None, :]]
                pt_of = uniq[sel]
                mc = max(1, POINT_CHUNK_FLOATS // max(1, d * r * (self.te + self.tf) + d * d * 4))
                for s0 in range(0, obs_idx.shape[0], mc):
                    oi = obs_idx[s0 : s0 + mc]
                    cams = cam_rows[oi]  # [m, d]
                    valid = cams < n_cams
                    p, a, b = np.nonzero(valid[:, :, None] & valid[:, None, :])
                    keys = cams[p, a].astype(np.int64) * n_cams + cams[p, b]
                    all_keys.append(np.unique(keys))
                    chunks.append(dict(
                        gi=gi, fv=fv, r=r, obs=oi,
                        pts=np.repeat(pt_of[s0 : s0 + mc], d),
                        src_a=p * d + a, src_b=p * d + b, keys=keys,
                    ))
        slots = np.unique(np.concatenate(all_keys))
        self.n_slots = len(slots)
        for ch in chunks:
            slot = np.searchsorted(slots, ch.pop("keys"))
            pieces = []
            for p0 in range(0, slot.size, PAIR_CHUNK):
                ps = slot[p0 : p0 + PAIR_CHUNK]
                o = np.argsort(ps, kind="stable")
                keys, lengths = np.unique(ps[o], return_counts=True)
                pieces.append((ch["src_a"][p0 : p0 + PAIR_CHUNK][o],
                               ch["src_b"][p0 : p0 + PAIR_CHUNK][o], keys, lengths))
            ch["pieces"] = pieces
            del ch["src_a"], ch["src_b"]
        self.chunks = chunks
        self.n_pairs = sum(len(p[0]) for ch in chunks for p in ch["pieces"])
        self.diag_slots = np.searchsorted(
            slots, np.arange(n_cams, dtype=np.int64) * n_cams + np.arange(n_cams)
        ).astype(np.int64)
        # BSR structure: the slots are sorted by (row camera, column camera)
        self.bsr_cols = (slots % n_cams).astype(np.int32)
        self.bsr_indptr = np.searchsorted(slots // n_cams, np.arange(n_cams + 1)).astype(np.int32)

    def tables(self, device):
        """The plan's index tables on `device` (made once per device)."""
        device = torch.device(device)
        if device not in self._tables:
            def ints(a):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.long, device=device)

            self._tables[device] = {
                "chunks": [
                    {"obs": ints(ch["obs"]), "pts": ints(ch["pts"]),
                     "pieces": [tuple(ints(x) for x in piece) for piece in ch["pieces"]]}
                    for ch in self.chunks
                ],
                "diag": ints(self.diag_slots),
            }
        return self._tables[device]

    # ---------------- device assembly ---------------- #

    def assemble(self, jac_e, jac_f, ete_solver, ftf_cam):
        """S's blocks [n_slots, tf, tf]: diag(FᵀF + D_f²) − Σ w_aᵀ M⁻¹ w_b,
        from the scale-materialized E and F views, (EᵀE + D_e²)⁻¹ and the
        transposed [tf*tf, n_cams] table of FᵀF + D_f²."""
        tf, te = self.tf, self.te
        tabs = self.tables(ftf_cam.device)
        acc = torch.zeros((self.n_slots, tf * tf), dtype=ftf_cam.dtype, device=ftf_cam.device)
        inv_e = ete_solver.inv_tables[self.e_cls].T  # [cnt(+1), te*te]
        for ch, ct in zip(self.chunks, tabs["chunks"]):
            r = ch["r"]
            ej = _gather_rows(jac_e.jac_groups[ch["gi"]][0], r * te, ct["obs"]).reshape(-1, r, te)
            fj = _gather_rows(jac_f.jac_groups[ch["gi"]][ch["fv"]], r * tf, ct["obs"]).reshape(
                -1, r, tf
            )
            w = _sum_products(ej.mT, fj, r).contiguous()  # EᵀF per observation
            minv = inv_e.index_select(0, ct["pts"]).reshape(-1, te, te)
            minvw = _sum_products(minv, w, te).contiguous()
            for a, b, keys, lengths in ct["pieces"]:
                blocks = _sum_products(w.index_select(0, a).mT, minvw.index_select(0, b), te)
                part = torch.segment_reduce(
                    blocks.reshape(-1, tf * tf), "sum", lengths=lengths, unsafe=True
                )
                acc.index_add_(0, keys, part)  # each slot once per piece: no race
        s_blocks = (-acc).reshape(self.n_slots, tf, tf)
        return s_blocks.index_add_(0, tabs["diag"], ftf_cam.T.reshape(-1, tf, tf))

    # ---------------- host factor + solve ---------------- #

    def host_solve(self, s_blocks, rhs_cam):
        """Factor the block-sparse S with SuperLU and solve for the camera
        part: S's blocks and rhs_cam [n_cams * tf] cross in one read; the
        solution [n_cams * tf] comes back as float64 numpy."""
        t0 = time.perf_counter()
        flat = torch.cat([s_blocks.reshape(-1), rhs_cam])
        host = read(flat).double().numpy()
        t1 = time.perf_counter()
        record("SparseSchur::Read", t1 - t0, nbytes=flat.numel() * flat.element_size())
        tf = self.tf
        s = sp.bsr_matrix(
            (host[: s_blocks.numel()].reshape(self.n_slots, tf, tf), self.bsr_cols,
             self.bsr_indptr),
            shape=(self.n_cams * tf, self.n_cams * tf),
        ).tocsc()
        x = spla.splu(s).solve(host[s_blocks.numel():])
        record("SparseSchur::HostSolve", time.perf_counter() - t1)
        return x


def solve_sparse_schur(program, options, jac_s, res_groups, grad_s, dsq):
    """The SPARSE_SCHUR linear solve (ceres_tpu/linalg/explicit_schur.py
    :184-231): the reduced rhs and S assembled on the device, S factored on
    the host, the back-substitution on the device. Returns (step [num_eff],
    1); raises ValueError when the problem is not BA-shaped."""
    from .schur import _back_substitute, _masks, make_ete_solver, schur_views

    e_mask, f_mask = _masks(program, grad_s)
    jac_e, jac_f = schur_views(program, jac_s)
    plan = ExplicitSchurPlan.get(program, jac_e, jac_f)
    # the pair-block assembly reads raw [r*t, n] leaves: fold the scale in
    jac_e = jac_e.materialize_scale()
    jac_f = jac_f.materialize_scale()
    g_e = grad_s * e_mask
    ete = make_ete_solver(program, jac_e, dsq * e_mask)

    # rhs = -g_f + Fᵀ E M⁻¹ g_e (schur.schur_solve)
    rhs = -(grad_s * f_mask) + jac_f.left_multiply(jac_e.right_multiply(ete(g_e)))
    ftf = jac_f.block_diag_jtj(dsq=dsq * f_mask)[plan.cam_cls]
    s_blocks = plan.assemble(jac_e, jac_f, ete, ftf)

    base = int(program.tangent_class_bases[plan.cam_cls])
    ncoord = plan.n_cams * plan.tf
    x_cam = plan.host_solve(s_blocks, rhs[base : base + ncoord])
    dx_f = torch.zeros_like(grad_s)
    dx_f[base : base + ncoord] = torch.as_tensor(x_cam, dtype=grad_s.dtype, device=grad_s.device)
    step = _back_substitute(jac_e, jac_f, ete, g_e, e_mask, dx_f * f_mask)
    record("SparseSchur::Explicit")
    return step, torch.ones((), dtype=torch.int32, device=grad_s.device)
