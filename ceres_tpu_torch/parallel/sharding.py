"""Sharded evaluation: each rank holds its own lanes of every group.

Port of `ceres_tpu.parallel.sharding`. Every group's residual blocks are
laid out shard-major (Program.build_shard_layout): rank s holds lanes
[s*L, (s+1)*L) of the permuted group, in its own interleaved bucket order,
so that the owner position's slice+broadcast gathers and reshape+sum
reductions survive sharding ("bucket_sharded" plans, jacobian.py); the
camera positions keep their onehot plan with a padded camera CSR built over
the rank's lanes, so kernels B2 and B3 run per rank. Pad lanes fill each
rank's remainder: their rows point at row 0 (gathers) and at the dump
column (reductions), their data is 0, and the group's `mask` leaf (0 on a
pad lane, 1 elsewhere, in the state's dtype) makes the evaluation write 0
to their residuals and Jacobian columns and leave them out of the cost
(kernel B1's mask_T, eval_kernel.py).

The state and every tangent-space vector are whole on every rank; every
reduction over lanes (the cost, Jᵀu, the Gram blocks, the model cost
change) is a rank-local partial sum followed by Mesh.psum. The rank's
arrays carry the mesh (`garr["mesh"]`), so the Jacobian an evaluation
builds from them all-reduces its reductions itself; nothing has to be
wrapped, as the JAX package wraps its step functions in shard_map.

The JAX package clamps a shard's bucket window to the table's end
(ceres_tpu/jacobian.py:260-261, `jnp.minimum(..., nrows - per_e)`), which
shifts the window of a last shard whose bucket does not divide evenly and
gathers its real lanes from the wrong rows: its sharded cost is wrong
there. Here each window stops at its shard's live entities
(`bucket_sharded`'s fifth field) and pads with zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from ..evaluator import Evaluator
from ..io.lazy import materialize_rows
from ..program import camera_layout
from ..utils.dtypes import default_dtype
from ..utils.graphs import upload


def shard_plans(meta, lay, shard: int):
    """The rank-local plans of a group: its onehot plans as they are, the
    owner's bucket plan as ("bucket_sharded", ((local_start, per_e, d,
    out_row + shard*per_e, live), ...)), live the bucket's real entities on
    this shard (0..per_e); positions without a plan keep none."""
    plans = {}
    for pos, plan in (meta.red_plans or {}).items():
        if plan[0] == "onehot":
            plans[pos] = plan
        elif plan[0] == "bucket" and lay["shard_buckets"] is not None:
            plans[pos] = ("bucket_sharded", tuple(
                (ls, pe, d, out + shard * pe, max(0, min(pe, n_seg - shard * pe)))
                for (ls, pe, d, out), (_l, n_seg, _d, _o) in zip(lay["shard_buckets"], plan[1])
            ))
    return plans


def shard_group_idx(program, ndev: int, shard: int):
    """The numpy group tables of one shard (the lanes rank `shard` owns):
    per group a_rows, t_rows, data (only the shard's rows of a lazy leaf
    are read), the camera CSR of its onehot positions and the lane mask."""
    layouts = program.build_shard_layout(ndev)
    out = []
    for gi, (meta, idx) in enumerate(zip(program.groups, program.group_idx)):
        lay = layouts[gi]
        L = lay["lanes_per_shard"]
        src = lay["perm"][shard * L : (shard + 1) * L]
        valid = src >= 0
        rows = src[valid]

        def take(a, fill):
            shape = tuple(a.shape)
            o = np.full((L,) + shape[1:], fill, dtype=np.dtype(a.dtype))
            o[valid] = materialize_rows(a, rows)
            return o

        t_rows, csr = [], {}
        for pos, pm in enumerate(meta.positions):
            dump = program.tangent_class_counts[pm.t_cls] if pm.t_cls >= 0 else 0
            t_rows.append(take(idx["t_rows"][pos], dump))
            if (meta.red_plans or {}).get(pos, ("",))[0] == "onehot":
                csr[pos] = camera_layout(t_rows[-1], dump + 1)
        out.append({
            "a_rows": tuple(take(a, 0) for a in idx["a_rows"]),
            "t_rows": tuple(t_rows),
            "data": tuple(take(d, 0) for d in idx["data"]),
            "csr": csr,
            "mask": valid,
            "plans": shard_plans(meta, lay, shard),
        })
    return out


def build_shard_arrays(program, mesh, dtype=None):
    """The arrays of this rank's shard on the mesh's device (Program.arrays
    over shard_group_idx), each group's with its `mask` [L] in `dtype`, its
    rank-local `plans` and the `mesh` (ceres_tpu/parallel/sharding.py
    :101-200, one rank's part of it)."""
    dtype = dtype or default_dtype()
    local = shard_group_idx(program, mesh.size, mesh.rank)
    arrays = program.arrays(dtype, group_idx=local)
    for garr, idx in zip(arrays["groups"], local):
        garr["mask"] = upload(idx["mask"], dtype=dtype, device=program.device)
        garr["plans"] = idx["plans"]
        garr["mesh"] = mesh
    return arrays


class ShardedEvaluator(Evaluator):
    """An Evaluator over this rank's shard of the Program: the same entry
    points (cost, evaluate_groups, plus, ...), whose costs and gradients are
    all-reduced over the mesh and whose Jacobian all-reduces its
    reductions. The state is whole on every rank; residual groups and the
    Jacobian hold the rank's lanes (flat residuals too: `residuals` and
    `evaluate` return the rank's own)."""

    def __init__(self, program, mesh, dtype=None):
        self.mesh = mesh
        program.to(mesh.device)
        super().__init__(program, dtype)

    def _build_arrays(self):
        return build_shard_arrays(self.program, self.mesh, self.dtype)

    def sy_sources(self):
        """No source: B4 never runs on a shard (linalg/schur._sy_meta)."""
        return []

    @property
    def capturable(self) -> bool:
        """A gloo mesh's all-reduces cannot run inside a CUDA graph: its
        solves run eagerly on the host loop (fused_loop.eligible)."""
        return self.mesh.capturable and super().capturable
