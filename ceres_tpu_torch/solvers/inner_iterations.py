"""Inner iterations: block-coordinate refinement of the eliminated blocks.

Port of `ceres_tpu.solvers.inner_iterations` (reference:
coordinate_descent_minimizer.cc; TrustRegionMinimizer::
DoInnerIterationsIfNeeded, trust_region_minimizer.cc:504-583). The
independent set is a Schur e-block partition (no two e-blocks share a
residual), so every e-block's subproblem is solved at once, as one damped
Gauss-Newton sweep:

    per observation:  r, J_e (the Jacobian for its e-block, width t_e)
    per e-block:      JᵀJ, Jᵀr by jacobian.reduce_T
    batched solve:    (JᵀJ + damping·diag)⁻¹ Jᵀr  (preconditioners._inverse_T)
    update:           Plus of the e-entries of the tangent vector

The JAX package differentiates the functor for the e-position alone, with
vmap and value_and_jacobians outside its kernel. Here the e-position's
Jacobian leaf and the residuals come from the group's own evaluation,
evaluator._group_eval: kernel B1 (the Snavely instantiations, or B1
generic) on a card, its plain version on the CPU. That is the same
quantity: the loss correction of a position depends only on r and that
position's block. The sweep and its candidate's cost are one CUDA graph
on a card ("inner_sweep"); the refiner reads one cost per sweep.
"""

from __future__ import annotations

import torch

from ..evaluator import _group_eval, plus, state_tables
from ..jacobian import group_plans, reduce_T
from ..linalg.preconditioners import _inverse_T, apply_block_T, diag_rows
from ..ordering import eliminated_handles
from ..utils import graphs
from ..utils.graphs import read


def make_inner_iteration_fn(program, options, evaluator):
    """sweep(state, damping) -> state': one batched damped Gauss-Newton
    sweep over the e-blocks, or None when the partition has none
    (ceres_tpu/solvers/inner_iterations.py:66-169)."""
    if options.inner_iteration_ordering is not None:
        # group 0 of inner_iteration_ordering picks the blocks to refine
        # (coordinate_descent_minimizer.cc:88-150); a partition of its own,
        # which leaves the Program's cached one alone
        _, e_positions, _ = program.compute_schur_partition(
            user_e_override=eliminated_handles(options.inner_iteration_ordering)
        )
    else:
        _, e_positions, _ = program.compute_schur_partition()
    groups = [
        (gi, eps[0], program.groups[gi].positions[eps[0]].t_cls)
        for gi, eps in enumerate(e_positions)
        if eps
    ]
    e_classes = sorted({cls for _, _, cls in groups})
    if not e_classes:
        return None
    arrays = evaluator.arrays
    mesh = arrays["groups"][0].get("mesh") if arrays["groups"] else None

    def sweep(state, damping):
        state_2d = state_tables(program, state)
        sizes, counts = program.tangent_class_sizes, program.tangent_class_counts
        jtj = {c: state.new_zeros((sizes[c] ** 2, counts[c] + 1)) for c in e_classes}
        jtr = {c: state.new_zeros((sizes[c], counts[c] + 1)) for c in e_classes}
        for gi, e_pos, cls in groups:
            meta, garr = program.groups[gi], arrays["groups"][gi]
            _, res, jacs = _group_eval(meta, garr, state_2d, True, True)
            r, t = meta.num_residuals, sizes[cls]
            j3 = jacs[e_pos].reshape(r, t, -1)
            plan = group_plans(meta, garr).get(e_pos)
            layout = (garr["t_rows"][e_pos], counts[cls] + 1, garr["csr"].get(e_pos))
            outer = (j3[:, :, None, :] * j3[:, None, :, :]).sum(dim=0).reshape(t * t, -1)
            jtj[cls] = jtj[cls] + reduce_T(plan, outer, *layout)
            jtr[cls] = jtr[cls] + reduce_T(plan, (j3 * res[:, None, :]).sum(dim=0), *layout)
        if mesh is not None:  # a rank's partial sums (ceres_tpu inner_iterations.py:156-158)
            tabs = mesh.psum_tables([jtj[c] for c in e_classes] + [jtr[c] for c in e_classes])
            jtj = dict(zip(e_classes, tabs[: len(e_classes)]))
            jtr = dict(zip(e_classes, tabs[len(e_classes):]))
        # the tangent delta class by class: the e-classes solve, the rest 0
        parts = []
        for c, (s, cnt) in enumerate(zip(sizes, counts)):
            if c not in jtj:
                parts.append(state.new_zeros(cnt * s))
                continue
            a, b = jtj[c][:, :-1], jtr[c][:, :-1]
            rows = diag_rows(s, a.device)
            a = a.index_add(0, rows, damping * torch.clamp_min(a[rows], 1e-12))
            inv = _inverse_T(a, s, eps_scale=0.0)
            parts.append(-apply_block_T(inv, b, s).T.reshape(-1))
        return plus(program, arrays, state, torch.cat(parts))

    return sweep


class InnerIterationRefiner:
    """`sweeps` batched sweeps with a monotone cost guard and the JAX
    package's damping schedule (ceres_tpu/solvers/inner_iterations.py:
    172-202)."""

    def __init__(self, program, options, evaluator, sweeps: int = 2):
        self.evaluator = evaluator
        self.sweeps = sweeps
        self._sweep = make_inner_iteration_fn(program, options, evaluator)
        self._graph = evaluator.fn_graph("inner_sweep")

    @property
    def available(self) -> bool:
        return self._sweep is not None

    def _run(self, _, state, damping):
        from ..evaluator import evaluate

        ev = self.evaluator
        candidate = self._sweep(state, damping)
        return candidate, evaluate(ev.program, ev.arrays, candidate, with_jacobian=False)[0]

    def refine(self, state, cost: float):
        """(state', cost') with cost' <= cost; one read per sweep."""
        if self._sweep is None:
            return state, cost
        damping = 1e-4
        for _ in range(self.sweeps):
            d = torch.full((), damping, dtype=state.dtype, device=state.device)
            self.evaluator.notify(False)
            candidate, new_cost = graphs.call(self._graph, self._run, (), state, d)
            new_cost = read(new_cost).item()
            if new_cost < cost:
                # a graph's output is rewritten by its next replay
                state = candidate if self._graph is None else candidate.clone()
                cost = new_cost
                damping = max(damping / 2.0, 1e-8)
            else:
                damping *= 10.0
        return state, cost
