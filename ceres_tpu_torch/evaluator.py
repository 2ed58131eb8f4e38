"""Batched residual / Jacobian / gradient / cost evaluation.

Port of `ceres_tpu.evaluator`. Per signature group, the Snavely functors
(angle-axis and quaternion cameras) run kernel B1's hand-derived
instantiations and every group the generator can trace B1's generic one
(eval_kernel.py, functor_codegen.py); each kernel's wrapper runs its plain
version on the CPU. The rest runs the torch.func path: gather the
parameter rows, vmap(jacfwd) the functor, chain the manifold
plus-Jacobian, apply the loss and the Triggs correction. Outputs are
observation-minor: residuals [r, n], Jacobian blocks [r*t, n].
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from . import eval_kernel, functor_codegen
from .autodiff import batched_value_and_jacobians, batched_values
from .corrector import correct_batched
from .jacobian import BlockJacobian, gather_T, group_plans
from .utils import graphs
from .utils.dtypes import default_dtype
from .utils.execution_summary import span


def state_tables(program, state):
    """Per-ambient-class [count, size] views of the flat state."""
    tables = []
    for cls in range(len(program.ambient_class_sizes)):
        base, cnt, s = program.ambient_class_slice(cls)
        tables.append(state[base : base + cnt * s].reshape(cnt, s))
    return tables


def tangent_tables(program, v, pad_zero_row: bool = False):
    """Per-tangent-class [count(+1), size] views of a tangent vector."""
    tables = []
    for cls in range(len(program.tangent_class_sizes)):
        base, cnt, s = program.tangent_class_slice(cls)
        t = v[base : base + cnt * s].reshape(cnt, s)
        if pad_zero_row:
            t = torch.cat([t, t.new_zeros((1, s))])
        tables.append(t)
    return tables


def plus(program, arrays, state, delta):
    """state [+] delta, all row operations, clamped to the bounds where
    there are any (reference: Program::Plus, PlusWithBoundsClamping)."""
    xs = state_tables(program, state)
    ds = tangent_tables(program, delta, pad_zero_row=True)
    out = []
    for cls, x2d in enumerate(xs):
        rec = program.plus_euclid[cls]
        if rec is not None:
            x2d = x2d + ds[rec["t_cls"]][arrays["plus_euclid"][cls]["t_row_map"]]
        out.append(x2d)
    for meta, g, gi in zip(
        program.manifold_group_meta, program.manifold_group_idx, arrays["manifold_groups"]
    ):
        x_rows = out[g["a_cls"]][gi["a_rows"]]
        d_rows = ds[g["t_cls"]][gi["t_rows"]]
        out[g["a_cls"]] = out[g["a_cls"]].index_copy(
            0, gi["a_rows"].long(), vmap(meta.manifold.plus)(x_rows, d_rows)
        )
    new = torch.cat([t.reshape(-1) for t in out])
    if program.has_bounds:
        new = torch.clamp(new, arrays["lower_bound"], arrays["upper_bound"])
    return new


def evaluate_batch(fn, params, data, manifolds, loss, with_jacobian, mask=None):
    """The torch.func evaluation of one batch of residual blocks.

    params: tuple of gathered [n, size_i]; data: tuple of [n, ...]; mask:
    None or [n], 0 on a pad lane of a sharded group, whose residuals and
    Jacobian columns are then 0 and whose rho0 leaves the cost (the XLA
    path's mask, ceres_tpu/evaluator.py:269-293).
    Returns (cost [], res_T [r, n], jacs_T tuple of [r*t_i, n])."""
    if with_jacobian:
        res, jacs = batched_value_and_jacobians(fn, params, data)
        jacs = list(jacs)
        for i, m in enumerate(manifolds):
            if m is not None:
                pj = vmap(m.plus_jacobian)(params[i])
                jacs[i] = torch.einsum("nrs,nst->nrt", jacs[i], pj)
    else:
        res = batched_values(fn, params, data)
        jacs = []
    live = None
    if mask is not None:
        live = mask > 0
        res = torch.where(live[:, None], res, 0.0)
        jacs = [torch.where(live[:, None, None], j, 0.0) for j in jacs]
    if loss is not None:
        rho0, rho1, rho2 = loss.rho((res * res).sum(dim=-1))
        if live is not None:
            rho0 = torch.where(live, rho0, 0.0)
        cost = 0.5 * rho0.sum()
        res, jacs = correct_batched(res, jacs, rho0, rho1, rho2)
    else:
        cost = 0.5 * (res * res).sum()
    n, r = res.shape
    res_T = res.T.contiguous()
    jacs_T = tuple(j.permute(1, 2, 0).reshape(r * j.shape[2], n) for j in jacs)
    return cost, res_T, jacs_T


def group_eval_plain(meta, garr, state_2d, with_jacobian, apply_loss):
    """torch.func evaluation of a whole group: the path of every group no
    kernel serves, and B1 generic's plain version. The owner position's
    gather is a bucket slice+broadcast when its rows are ambient-aligned;
    a sharded group's pad lanes are masked (garr["mask"])."""
    params = []
    plans = group_plans(meta, garr)
    for pos, (pm, rows) in enumerate(zip(meta.positions, garr["a_rows"])):
        plan = plans.get(pos)
        tbl = state_2d[pm.a_cls]
        if pos == meta.owner and meta.owner_ambient_aligned and plan is not None:
            params.append(gather_T(plan, tbl, rows).T)
        else:
            params.append(tbl[rows])
    return evaluate_batch(
        meta.cost_function.fn,
        tuple(params),
        tuple(garr["data"]),
        tuple(pm.manifold for pm in meta.positions),
        meta.loss if apply_loss else None,
        with_jacobian,
        garr.get("mask"),
    )


def _group_eval(meta, garr, state_2d, with_jacobian: bool, apply_loss: bool):
    """Evaluate one signature group -> (cost, res [r, n], jacs tuple of
    [r*t, n]). Kernel B1 for an eligible Snavely group, angle-axis or
    quaternion (its wrapper runs the plain version on CPU tensors); on a
    card B1 generic for a group the generator can trace; the torch.func
    path otherwise. On the CPU no group is traced: B1 generic's plain
    version is the torch.func path itself."""
    dtype = state_2d[0].dtype if state_2d else None
    if eval_kernel.eligible(meta, dtype, apply_loss):
        p0, p1 = meta.positions
        return eval_kernel.group_evaluate(
            meta,
            state_2d[p0.a_cls],
            garr["a_rows"][0],
            state_2d[p1.a_cls],
            garr["a_rows"][1],
            garr["data"][0],
            meta.loss if apply_loss else None,
            with_jacobian,
            garr.get("mask"),
        )
    on_card = bool(state_2d) and state_2d[0].device.type == "cuda"
    prog = functor_codegen.group_program(meta, garr, dtype, apply_loss) if on_card else None
    if prog is not None:
        return eval_kernel.generic_evaluate(prog, meta, garr, state_2d, with_jacobian)
    return group_eval_plain(meta, garr, state_2d, with_jacobian, apply_loss)


def evaluate(program, arrays, state, with_jacobian: bool = True, apply_loss: bool = True):
    """Full evaluation -> (cost, residual groups [r, n], BlockJacobian|None,
    gradient|None). Parity: Evaluator::Evaluate. On a rank's shard
    (parallel.sharding) the cost is all-reduced here and the gradient in
    the Jacobian's left_multiply."""
    total_cost = torch.zeros((), dtype=state.dtype, device=state.device)
    state_2d = state_tables(program, state)
    res_groups, jac_groups = [], []
    for meta, garr in zip(program.groups, arrays["groups"]):
        cost_g, res, jacs = _group_eval(meta, garr, state_2d, with_jacobian, apply_loss)
        total_cost = total_cost + cost_g
        res_groups.append(res)
        jac_groups.append(jacs)
    mesh = arrays["groups"][0].get("mesh") if arrays["groups"] else None
    if mesh is not None:
        total_cost = mesh.psum(total_cost)
    jac = grad = None
    if with_jacobian:
        jac = BlockJacobian.build(program, arrays, jac_groups)
        grad = jac.left_multiply(res_groups)
    return total_cost, res_groups, jac, grad


def diagnose_non_finite(program, state, max_blocks: int = 3) -> str:
    """Name the residual block(s) whose evaluation produced Inf/NaN: each
    group is evaluated again without the robust loss, and each offending
    block's parameters, raw residuals and Jacobian are printed, at most
    `max_blocks` per group (ceres_tpu/evaluator.py:444; reference:
    residual_block_utils.cc). Runs once, after a failure, on the host."""
    arrays = program.arrays(state.dtype)
    state_2d = state_tables(program, state)
    state_np = state.detach().cpu().numpy()
    lines = []
    for gi, (meta, garr, idx) in enumerate(zip(program.groups, arrays["groups"], program.group_idx)):
        _, res, jacs = _group_eval(meta, garr, state_2d, True, False)
        res = res.detach().cpu().numpy()[:, : meta.n]  # [r, n]
        jacs = [j.detach().cpu().numpy()[:, : meta.n] for j in jacs]
        bad = ~np.isfinite(res).all(axis=0)
        for j in jacs:
            bad |= ~np.isfinite(j).all(axis=0)
        if not bad.any():
            continue
        bad_rows = np.flatnonzero(bad)
        lines.append(
            f"group {gi} ('{meta.cost_function.name}'): "
            f"{bad_rows.size}/{meta.n} residual blocks non-finite"
        )
        for row in bad_rows[:max_blocks]:
            lines.append(f"  block {int(row)}:")
            lines.append(
                "    residuals: " + np.array2string(res[:, row], precision=6, max_line_width=100)
            )
            for pos, (pm, ids) in enumerate(zip(meta.positions, idx["block_ids"])):
                bid = int(ids[row])
                off = int(program.x_offsets[bid])
                lines.append(
                    f"    parameter block {pos} (id {bid}, size {pm.size}): "
                    + np.array2string(state_np[off : off + pm.size], precision=6,
                                      max_line_width=100)
                )
                # group layout is [r*t, n], r-major (jacobian.py)
                jcol = jacs[pos][:, row].reshape(meta.num_residuals, -1)
                lines.append(
                    "      jacobian: "
                    + np.array2string(jcol, precision=6, max_line_width=100).replace(
                        "\n", "\n                "
                    )
                )
        if bad_rows.size > max_blocks:
            lines.append(f"  ... and {bad_rows.size - max_blocks} more")
    if not lines:
        return (
            "No non-finite residual/Jacobian entries found on re-evaluation "
            "(failure may come from the robust loss or the linear solver)."
        )
    return "\n".join(lines)


def flatten_residuals(program, res_groups):
    """Per-group [r, n] residuals -> the global residual vector (groups in
    order, blocks within group, components within block)."""
    if not res_groups:
        return torch.zeros(0)
    return torch.cat([r.T.reshape(-1) for r in res_groups])


class Workspace:
    """What an Evaluator builds on the device and a Program may keep for
    its next solve under `key` (solvers/solver.py): the Program's tables as
    tensors (`arrays`), the solver's CUDA graphs by name and the tensors
    that only they read in place (`buffers`). It refers to no Program, so
    it goes with its Program by reference counting."""

    def __init__(self):
        self.key = None
        self.arrays = None
        self.graphs = {}
        self.buffers = {}

    def release(self):
        """Drop the graphs (their memory pools), the buffers and the tables
        now, rather than when the last reference goes."""
        for graph in self.graphs.values():
            if graph is not None:
                graph.release()
        self.graphs.clear()
        self.buffers.clear()
        self.arrays = None


class Evaluator:
    """Evaluation entry points bound to one Program, its dtype and its
    device (the Program's). Each entry point first calls the Program's
    evaluation callback, with (True, whether it evaluates the Jacobian),
    as ceres_tpu/evaluator.py:412-437 does; a minimizer that replays an
    evaluation from a CUDA graph calls `notify` itself before each
    replay (trust_region.make_evaluate).

    Its tables, the solver's graphs (`fn_graph`, `step_graph`: one per
    name) and their buffers live in its Workspace; an Evaluator given a
    built one takes them from there and builds nothing."""

    def __init__(self, program, dtype=None, workspace=None):
        self.program = program
        self.dtype = dtype or default_dtype()
        self.device = program.device
        if workspace is not None:  # built by an earlier Evaluator
            self.workspace, self.arrays = workspace, workspace.arrays
            return
        self.workspace = Workspace()
        with span("Evaluator::Build"):
            self.arrays = self.workspace.arrays = self._build_arrays()
            if torch.device(self.device).type == "cuda":
                # the generated kernels of the Program's groups and of B4 at
                # its shape, built at once, before any CUDA graph capture
                eval_kernel.prepare_generic(program, self.arrays, self.dtype, self.sy_sources())

    def sy_sources(self):
        """The generated B4 sources this Evaluator's solves can launch
        (linalg/schur_kernels.py sy_sources)."""
        from .linalg.schur_kernels import sy_sources

        return sy_sources(self.program)

    def _build_arrays(self):
        return self.program.arrays(self.dtype)

    @property
    def capturable(self) -> bool:
        """Whether an evaluation can run inside a CUDA graph: not where a
        group's functor or loss calls a host function (`runs_on_host`: the
        C API's callbacks, capi.py), and a sharded one only where its mesh's
        all-reduces can."""
        return not any(
            getattr(m.cost_function.fn, "runs_on_host", False)
            or getattr(m.loss, "runs_on_host", False)
            for m in self.program.groups
        )

    def fn_graph(self, name):
        """The utils.graphs.FnGraph `name` for the solver's functions over
        this evaluator's tensors, the same one at every request: on a card
        whose work can be captured; None (run eagerly) elsewhere."""
        return self._graph(name, graphs.fn_graph)

    def step_graph(self, name):
        """The utils.graphs.StepGraph `name`, where fn_graph gives an
        FnGraph."""
        return self._graph(name, graphs.step_graph)

    def _graph(self, name, make):
        if not self.capturable:
            return None
        kept = self.workspace.graphs
        if name not in kept:
            kept[name] = make(name, self.device)
        return kept[name]

    def buffer(self, key, make):
        """The tensor make() gave at the first request of `key`, at every
        request: a graph's fixed operand that no other graph writes."""
        kept = self.workspace.buffers
        if key not in kept:
            kept[key] = make()
        return kept[key]

    def notify(self, evaluate_jacobians: bool):
        """Run the Program's evaluation callback, if it has one, on the
        host: (new_point=True, evaluate_jacobians)."""
        cb = self.program.evaluation_callback
        if cb is not None:
            cb(True, evaluate_jacobians)

    def cost(self, state):
        self.notify(False)
        return evaluate(self.program, self.arrays, state, with_jacobian=False)[0]

    def residuals(self, state):
        """(cost, flat corrected residuals)."""
        self.notify(False)
        cost, res_groups, _, _ = evaluate(
            self.program, self.arrays, state, with_jacobian=False
        )
        return cost, flatten_residuals(self.program, res_groups)

    def evaluate(self, state, apply_loss: bool = True):
        """(cost, flat residuals, BlockJacobian, gradient)."""
        self.notify(True)
        cost, res_groups, jac, grad = evaluate(
            self.program, self.arrays, state, True, apply_loss
        )
        return cost, flatten_residuals(self.program, res_groups), jac, grad

    def evaluate_groups(self, state, apply_loss: bool = True):
        """(cost, per-group residuals, BlockJacobian, gradient)."""
        self.notify(True)
        return evaluate(self.program, self.arrays, state, True, apply_loss)

    def plus(self, state, delta):
        return plus(self.program, self.arrays, state, delta)
