"""Multi-process runtime: a mesh is a torch.distributed group, one rank per
shard.

Port of `ceres_tpu.parallel.distributed`. The JAX package runs one SPMD
program over a device mesh (shard_map, psum over a mesh axis); here every
rank is a process of its own that runs the same solve on its own lanes:

- every rank calls `initialize()` (torch.distributed.init_process_group),
  then builds the same Program from the global metadata (index arrays are
  global and cheap; the observation payload can stay on disk through
  io.bal.load_bal_lazy, each rank reading only its own rows);
- `global_mesh()` spans every rank, `hybrid_mesh()` lays the ranks out as
  hosts x local ranks with a process group per host row and one across
  hosts; parallel.sharding.build_shard_arrays gives each rank its lanes;
- every psum of the JAX package becomes `Mesh.psum`: an all_reduce(SUM)
  over the mesh's group, or over a hybrid mesh the inner (per-host) group
  first and then the one across hosts (the JAX package's
  `psum_hierarchical`, ceres_tpu/jacobian.py:161-171). Every value a
  rank branches on is all-reduced or computed from all-reduced tensors,
  so every rank holds the same bits and takes the same branch.

Backends: NCCL where every rank has a card of its own (its all-reduces can
be captured in CUDA graphs: the fused loop runs); gloo on the CPU and for
ranks that share one card (NCCL refuses two ranks on one device; gloo
all-reduces CUDA tensors through the host, and cannot be captured: such a
mesh runs the host loop). A backend that cannot start raises: a rank never
carries on alone.

Launch (one process per rank): `torchrun --nproc-per-node=N script.py`
with `initialize()` in the script, or spawn the ranks yourself and call
`initialize(backend, "tcp://localhost:<port>", world_size, rank, device)`.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.execution_summary import count

_device = None  # the device `initialize` gave this rank


class Mesh:
    """The ranks of a sharded solve, laid out over named axes.

    `groups` maps each axis name to the process group of the ranks that
    share this rank's coordinates on every other axis; `shape` is the size
    of each axis, ranks numbered row-major over them (a rank's shard is
    `rank`). `device` is where this rank's tensors live. Pass it as
    SolverOptions.mesh."""

    def __init__(self, axis_names, shape, groups, device, backend):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.groups = dict(groups)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = backend
        self.size = int(np.prod(self.shape))
        self.rank = dist.get_rank()
        if self.size != dist.get_world_size():
            raise ValueError(f"a mesh of shape {self.shape} over {dist.get_world_size()} ranks")
        if backend == "nccl":
            # NCCL sets up a communicator at a group's first collective,
            # which a CUDA graph capture would refuse: one all-reduce now
            warm = torch.zeros(1, device=self.device)
            for name in self.axis_names:
                dist.all_reduce(warm, group=self.groups[name])
            torch.cuda.synchronize(self.device)

    @property
    def capturable(self) -> bool:
        """Whether the mesh's all-reduces can be captured in a CUDA graph
        (NCCL can, gloo cannot)."""
        return self.backend == "nccl"

    def psum(self, x):
        """The sum of x over every rank of the mesh (a new tensor; x is
        left as it is): one all_reduce over a 1-D mesh; over a 2-D one the
        inner axis first, then the outer (ceres_tpu's psum_hierarchical). Each
        all-reduce is counted with its bytes (`Mesh::AllReduce` in
        utils.execution_summary's counter table, which a replayed graph
        adds to once per replay)."""
        out = x.contiguous().clone()
        for name in reversed(self.axis_names):
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.groups[name])
            count("Mesh::AllReduce", nbytes=out.numel() * out.element_size())
        return out

    def all_gather_lanes(self, x):
        """[k, L] from every rank -> [k, size*L], ranks in order (the
        shard-major lane order of parallel.sharding)."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=1)

    def psum_tables(self, tables):
        """psum of a list of tensors in one all-reduce (flattened, then
        split back), for the per-class tables of one reduction."""
        if not tables:
            return tables
        dt = tables[0].dtype
        flat = self.psum(torch.cat([t.reshape(-1).to(dt) for t in tables]))
        out, k = [], 0
        for t in tables:
            out.append(flat[k : k + t.numel()].reshape(t.shape).to(t.dtype))
            k += t.numel()
        return out


def _default_device(backend):
    """A rank's device when none is named: its card (cuda:LOCAL_RANK, modulo
    the cards under gloo, where ranks may share one). The CPU only when
    asked for by name: with no card visible this raises, as
    utils.dtypes.resolve_device does."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run a rank on the CPU"
        )
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if backend == "nccl":
        return torch.device("cuda", local)
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    timeout_seconds: float = 600.0,
):
    """Join the process group of a sharded solve; returns (rank, world size).

    backend: "nccl" (a card per rank) or "gloo" (the CPU, or ranks that
    share a card); default gloo when `device` is the CPU, else NCCL.
    init_method: "tcp://host:port" with world_size and rank, or None for
    torchrun's environment ("env://"). device: this rank's device (default:
    cuda:LOCAL_RANK under NCCL; under gloo the card LOCAL_RANK modulo the
    cards). The CPU only when named: with no device named and no card
    visible this raises, before joining any group. Raises too when the
    backend cannot start or the device is a card and none is visible."""
    global _device
    if backend is None:
        want_cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if want_cpu else "nccl"
    device = torch.device(device) if device is not None else _default_device(backend)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"rank device {device}: no CUDA device is visible")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = dict(backend=backend, init_method=init_method or "env://",
                  timeout=timedelta(seconds=timeout_seconds))
    if world_size is not None:
        kwargs.update(world_size=int(world_size), rank=int(rank))
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(**kwargs)
    _device = device
    return dist.get_rank(), dist.get_world_size()


def _backend():
    if not dist.is_initialized():
        raise RuntimeError("call parallel.distributed.initialize() first")
    return dist.get_backend()


def global_mesh(axis: str = "dp") -> Mesh:
    """A 1-D mesh over every rank (data parallel over residual blocks)."""
    backend = _backend()
    return Mesh((axis,), (dist.get_world_size(),), {axis: dist.group.WORLD},
                _device or _default_device(backend), backend)


def hybrid_mesh(dcn_axis: str = "dcn", ici_axis: str = "ici",
                local_size: Optional[int] = None) -> Mesh:
    """A 2-D mesh of hosts x local ranks (ceres_tpu/parallel/distributed.py
    :80-106): ranks h*local_size .. (h+1)*local_size - 1 form host h's row
    (one process group each, the inner axis), and the ranks with the same
    local index form a group across hosts (the outer axis). Lanes shard
    over both; every reduction runs inner first, then outer, so one
    already-reduced value per host crosses between hosts. local_size
    defaults to torchrun's LOCAL_WORLD_SIZE."""
    backend = _backend()
    world = dist.get_world_size()
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local_size:
        raise ValueError(f"hybrid_mesh: {world} ranks do not split into hosts of {local_size}")
    hosts = world // local_size
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in the same order (new_group's rule)
    for h in range(hosts):
        g = dist.new_group(list(range(h * local_size, (h + 1) * local_size)))
        if rank // local_size == h:
            groups[ici_axis] = g
    for i in range(local_size):
        g = dist.new_group(list(range(i, world, local_size)))
        if rank % local_size == i:
            groups[dcn_axis] = g
    return Mesh((dcn_axis, ici_axis), (hosts, local_size), groups,
                _device or _default_device(backend), backend)


def replicate(x, mesh: Mesh):
    """A host value as a tensor on the mesh's device, the same on every
    rank (rank 0's value, broadcast)."""
    t = torch.as_tensor(np.asarray(x), device=mesh.device).clone()
    dist.broadcast(t, src=0)
    return t
