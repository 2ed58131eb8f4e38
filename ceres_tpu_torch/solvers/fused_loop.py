"""Fused trust-region execution: whole LM iterations with their state on the
card.

Port of `ceres_tpu.solvers.fused_loop` (reference: the outer loop of
trust_region_minimizer.cc:66-124). The JAX package compiles chunks of
complete LM iterations into one `lax.while_loop`. Here every decision of an
iteration is made on the card in the same order as there: the step solve
(whose PCG reads one flag per iteration, linalg/cg.py), the projected line
search, Plus, the candidate cost, the parameter and function tolerances, the
non-monotonic step quality and its 7-value state, the radius and `df`
update, the accept, the gradient norms and the termination code. The state
(parameters, cost, residuals, Jacobian, gradient, radius, step-evaluator
state, prepare cache) stays on the card.

On a card the iteration runs from CUDA graphs (utils/graphs.py), each
captured at its first call and replayed after: the finish's head, PCG
iteration and tail (solvers/strategies.py, linalg/schur.py), `decide` (Plus,
the candidate cost and every decision up to the branch), and after an
accepted step the minimizer's `evaluate` (the Jacobian and the gradient
norms) and `prepare`. The Jacobian, its twins and the prepare cache live in
the outputs of the `evaluate` and `prepare` graphs, which the first
evaluation fills too, and the later graphs read them in place. Without the
split (under bounds) the step runs eagerly; the projected line search runs
eagerly between the step and `decide`.

The two branches that cost a Jacobian (re-evaluation and `prepare` after a
successful step) cannot run masked without paying them on every rejected
step, so the host reads one packed row per iteration to take them: the step
flags and the termination code before the re-evaluation. A successful
iteration that does not end its chunk reads its final termination code;
each chunk ends with one packed read in the JAX layout (iterations,
termination, successes, failures, Jacobians, cost, line-search evaluations,
then the [chunk, 10] stats rows), which the host replays into
Summary.iterations. So an iteration takes at most 2 + (its PCG iterations)
device->host reads (utils.graphs.read counts them; the projected line search
adds one per cost evaluation and one to start). Dogleg's PCG runs in its
prepare, which therefore runs at the start of the iteration that takes its
cache (after an accepted step, the next iteration's), not right after the
accepted step as the JAX loop runs it: the cache is the same, and its
reads count in the iteration whose PCG steps they are.

Eligibility (the host loop in trust_region.py stays the general path): no
callbacks, no update_state_every_iteration. Bounds run fused: Plus clamps
to the box, the active-set mask zeroes frozen columns, the projected
Armijo search and the projected gradient norms are on the card; the
prepare cache is not used under bounds (the mask changes the scale every
iteration).

Each iteration is an `LM::Iteration` span (utils.execution_summary), its
stages `LM::Step`, `LM::Decide` and `LM::Accept` spans that each close on a
read, so that their wall times are the stages' elapsed times; the first
evaluation and prepare are `Minimizer::Start`. IterationSummary's times
are the iterations' spans, Summary.linear_solver_time_in_seconds the
steps' and jacobian_evaluation_time_in_seconds the first evaluation's and
the accepts'.
"""

from __future__ import annotations

import math
import time

import torch

from ..evaluator import diagnose_non_finite
from ..types import IterationSummary, TerminationType
from ..utils import graphs
from ..utils.execution_summary import counts, span
from ..utils.graphs import read
from .trust_region import active_bound_mask, grad_norms, projected_line_search

# termination codes inside the fused loop
_CONTINUE = 0
_PARAM_TOL = 1
_FUNC_TOL = 2
_GRAD_TOL = 3
_MIN_RADIUS = 4
_INVALID_FAIL = 5
_EVAL_FAIL = 6

_TERM_MAP = {
    _PARAM_TOL: (TerminationType.CONVERGENCE, "Parameter tolerance reached."),
    _FUNC_TOL: (TerminationType.CONVERGENCE, "Function tolerance reached."),
    _GRAD_TOL: (TerminationType.CONVERGENCE, "Gradient tolerance reached."),
    _MIN_RADIUS: (TerminationType.CONVERGENCE, "Minimum trust region radius reached."),
    _INVALID_FAIL: (TerminationType.FAILURE, "Maximum number of consecutive invalid steps."),
    _EVAL_FAIL: (
        TerminationType.FAILURE,
        "Residual/Jacobian evaluation failed at accepted point.",
    ),
}

# stats row layout (floats)
_N_STATS = 10
(
    _S_COST,
    _S_CHANGE,
    _S_GMAX,
    _S_GNORM,
    _S_RADIUS,
    _S_STEPNORM,
    _S_RELDEC,
    _S_LINITERS,
    _S_FLAGS,  # 1 = valid, +2 = successful
    _S_TERM,
) = range(_N_STATS)

CHUNK_ITERS = 20


def chunk_iters(options) -> int:
    """Chunk length: options.fused_execution_chunk_iters, else the module
    default."""
    n = options.fused_execution_chunk_iters
    return n if n > 0 else CHUNK_ITERS


def eligible(options, step_fn, program=None) -> bool:
    """ceres_tpu/solvers/fused_loop.py:90-116: inner iterations, the
    problem dump and a Program with an evaluation callback (which runs on
    the host before every evaluation) take the host loop. So does a mesh
    whose all-reduces cannot be captured in a CUDA graph (gloo: the CPU, or
    ranks that share a card), beside the JAX package's sharded_cluster
    clause; an NCCL mesh runs fused, its all-reduces in the graphs."""
    return bool(
        options.fused_execution
        and (options.mesh is None or options.mesh.capturable)
        and getattr(program, "evaluation_callback", None) is None
        and getattr(step_fn, "jittable", True)
        and not options.use_inner_iterations
        and not options.callbacks
        and not options.trust_region_minimizer_iterations_to_dump
        and not options.update_state_every_iteration
    )


def make_chunk_fn(minimizer):
    """The chunk runner: chunk_fn(carry, limit) runs up to `limit` LM
    iterations on the carry (a dict of device state, updated in place) and
    returns (packed, per_it): the chunk's packed row, read to the host, and
    per iteration (device reads, graph replays, seconds, end in
    perf_counter_ns), the last iteration's with the packed read. The carry
    sums the iterations' LM::Step and LM::Accept seconds (step_s,
    accept_s). chunk_fn.use_split says whether it takes the prepare/finish
    split."""
    program, options, ev = minimizer.program, minimizer.options, minimizer.evaluator
    step_fn = minimizer._step_fn
    evaluate, prepare = minimizer.evaluate, minimizer.prepare
    ftol = options.function_tolerance
    ptol = options.parameter_tolerance
    gtol = options.gradient_tolerance
    min_rel = options.min_relative_decrease
    max_radius = options.max_trust_region_radius
    min_radius = options.min_trust_region_radius
    max_invalid = options.max_num_consecutive_invalid_steps
    nonmono = (
        options.max_consecutive_nonmonotonic_steps if options.use_nonmonotonic_steps else 0
    )
    arrays = ev.arrays
    has_bounds = program.has_bounds
    # the JAX fused loop's split, which it leaves under bounds (the
    # active-set mask changes the effective scale every iteration)
    use_split = minimizer.has_split and not has_bounds
    # a prepare that reads the device (dogleg's PCG) runs at the start of
    # the iteration that takes its cache, so its reads count there, beside
    # the PCG steps that iteration reports; the JAX loop prepares right
    # after the accepted step, which gives the same cache
    lazy = use_split and getattr(step_fn, "prepare_reads", False)
    use_ls = minimizer.use_line_search

    def decide(_, state, delta, cost, mcc, valid, lin_iters, radius, df, ninv, se):
        """Everything between the step and the branch: Plus, the candidate
        cost and every decision of the iteration. Returns a dict of
        tensors; its "flags" are (successful, termination code) for the
        host's read, its "row" the stats row without the gradient norms and
        the final termination code."""
        dtype = state.dtype

        # ---- invalid-step path (HandleInvalidStep) ----
        ninv1 = torch.where(valid, 0, ninv + 1)
        inv_fail = ~valid & (ninv1 >= max_invalid)
        r_shrunk = radius / df
        df_grown = 2.0 * df
        inv_minrad = ~valid & (r_shrunk < min_radius)

        # ---- candidate evaluation ----
        candidate = ev.plus(state, delta)
        new_cost = ev.cost(candidate)
        finite_new = torch.isfinite(new_cost)
        # with bounds the projected candidate can move less than |delta|:
        # the realized ambient step (host-loop parity)
        step_norm = torch.linalg.norm(state - candidate if has_bounds else delta)
        x_norm = torch.linalg.norm(state)
        cost_change = cost - new_cost
        t_param = valid & (step_norm <= ptol * (x_norm + ptol))
        t_func = valid & ~t_param & finite_new & (cost_change.abs() <= ftol * cost)
        proceed = valid & ~t_param & ~t_func

        # ---- non-monotonic step quality (TrustRegionStepEvaluator) ----
        se_cur, se_min, se_ref, se_cand, se_aref, se_acand, se_n = se
        rd_classic = (se_cur - new_cost) / torch.where(mcc != 0, mcc, 1.0)
        rd_hist = (se_ref - new_cost) / torch.where(se_aref + mcc != 0, se_aref + mcc, 1.0)
        rel_dec = torch.maximum(rd_classic, rd_hist)
        successful = proceed & finite_new & (rel_dec > min_rel)

        # step-evaluator state update (only when successful)
        cur2 = new_cost
        is_new_min = cur2 < se_min
        up = cur2 > se_cand
        min2 = torch.where(is_new_min, cur2, se_min)
        n2 = torch.where(is_new_min, 0, se_n + 1)
        cand2 = torch.where(is_new_min | up, cur2, se_cand)
        acand2 = torch.where(is_new_min | up, 0.0, se_acand + mcc)
        hit = n2 == nonmono
        ref2 = torch.where(hit, cand2, se_ref)
        aref2 = torch.where(hit, acand2, se_aref + mcc)
        se_new = [
            torch.where(successful, a, b)
            for a, b in zip((cur2, min2, ref2, cand2, aref2, acand2, n2), se)
        ]

        # ---- radius / damping update ----
        r_grow = radius / torch.clamp(1.0 - (2.0 * rel_dec - 1.0) ** 3, min=1.0 / 3.0)
        r_grow = torch.clamp(r_grow, max=max_radius)
        rejected = proceed & ~successful
        shrink = ~valid | rejected
        radius2 = torch.where(successful, r_grow, torch.where(shrink, r_shrunk, radius))
        df2 = torch.where(successful, 2.0, torch.where(shrink, df_grown, df))
        rej_minrad = rejected & (r_shrunk < min_radius)

        # ---- state update ----
        accept_state = successful | (t_func & (new_cost < cost))
        state2 = torch.where(accept_state, candidate, state)
        cost_acc = torch.where(accept_state, new_cost, cost)
        term = torch.zeros((), dtype=torch.int32, device=state.device)
        for cond, code in (
            (rej_minrad, _MIN_RADIUS), (t_func, _FUNC_TOL), (t_param, _PARAM_TOL),
            (inv_minrad, _MIN_RADIUS), (inv_fail, _INVALID_FAIL),
        ):
            term = torch.where(cond, code, term)
        zero = torch.zeros((), dtype=dtype, device=state.device)
        return {
            "candidate": candidate, "state": state2, "cost": cost_acc, "radius": radius2,
            "df": df2, "ninv": ninv1, "se": se_new, "term": term,
            "successful": successful.to(torch.int32), "shrink": shrink.to(torch.int32),
            "flags": torch.stack([successful.to(dtype), term.to(dtype)]),
            "row": torch.stack([
                cost_acc,
                torch.where(valid, cost_change, 0.0),
                zero,
                zero,
                radius2,
                torch.where(valid, step_norm, 0.0),
                torch.where(proceed, rel_dec, 0.0),
                lin_iters.to(dtype),
                valid.to(dtype) + 2.0 * successful.to(dtype),
                zero,
            ]),
        }

    # on a card decide runs from a CUDA graph (one per solve, captured at its
    # first call), as the step's finish and the evaluation do
    decide_graph = ev.fn_graph("decide")

    def step(c):
        """The step of one iteration: the prepare where the cache is due,
        the step function (on the split the finish's head, its PCG steps
        with their reads and the tail's launch) and the projected line
        search. Returns (delta, mcc, lin_iters, valid, line-search
        evaluations)."""
        state, grad = c["state"], c["grad"]
        iter_scale = (
            c["scale"] * active_bound_mask(program, arrays, state, grad)
            if has_bounds
            else c["scale"]
        )
        if use_split:
            # the J-dependent tables in c["pcache"] hold while steps are
            # rejected; finish does only the radius-dependent work
            if c["pcache"] is None:
                c["pcache"] = prepare(c["jac"], c["res"], grad, c["scale"])
                c["prepares"] += 1
            delta, mcc, lin_iters, valid = step_fn.finish(
                c["jac"], c["res"], grad, c["radius"], iter_scale, c["pcache"]
            )
        else:
            delta, mcc, lin_iters, valid = step_fn(
                c["jac"], c["res"], grad, c["radius"], iter_scale)
        nls = 0
        if use_ls:
            delta, nls = projected_line_search(ev, options, state, delta, c["cost"], grad, valid)
        return delta, mcc, lin_iters, valid, nls

    def accept(c, d):
        """After a successful step: the re-evaluation at the candidate and
        the prepare of the new Jacobian. Returns (res, jac, grad, term,
        gmax, gnorm)."""
        cost_j, res2, jac2, grad2, gmax, gnorm = evaluate(d["candidate"])
        if lazy:
            c["pcache"] = None
        elif use_split:
            c["pcache"] = prepare(jac2, res2, grad2, c["scale"])
            c["prepares"] += 1
        term = torch.where(gmax <= gtol, _GRAD_TOL, d["term"])
        term = torch.where(~torch.isfinite(cost_j), _EVAL_FAIL, term)
        return res2, jac2, grad2, term, gmax, gnorm

    def advance(c, d, res2, jac2, grad2, term, gmax, gnorm, nls):
        """The iteration's stats row and the carry's next state."""
        row = c["stats"][c["it"]]
        row.copy_(d["row"])
        row[_S_GMAX] = gmax
        row[_S_GNORM] = gnorm
        row[_S_TERM] = term
        c.update(
            state=d["state"], cost=d["cost"], res=res2, jac=jac2, grad=grad2,
            radius=d["radius"], df=d["df"], ninv=d["ninv"], se=d["se"], term=term,
            n=c["n"] + 1,
            nsucc=c["nsucc"] + d["successful"],
            nfail=c["nfail"] + d["shrink"],
            njac=c["njac"] + d["successful"],
            nls=c["nls"] + nls,
        )
        c["it"] += 1

    def packed_read(c):
        """The chunk's one read of everything the host needs: the counts,
        the cost and the stats rows, in the JAX layout."""
        dtype = c["state"].dtype
        return read(torch.cat([
            torch.stack([c[k].to(dtype) for k in ("n", "term", "nsucc", "nfail", "njac")]
                        + [c["cost"], c["nls"].to(dtype)]),
            c["stats"].reshape(-1),
        ])).double().tolist()

    def iteration(c, limit):
        """One LM iteration on the carry, each stage a span that closes on
        a read: LM::Step (its last PCG read), LM::Decide (the flags, which
        wait for the tail and decide) and, after a successful step,
        LM::Accept (the final termination code, or the packed read where
        the iteration ends the chunk). Returns the packed row where the
        chunk ends here, else None."""
        with span("LM::Step") as sp:
            delta, mcc, lin_iters, valid, nls = step(c)
        c["step_s"] += sp.seconds
        with span("LM::Decide"):
            d = graphs.call(
                decide_graph, decide, (),
                c["state"], delta, c["cost"], mcc, valid, lin_iters, c["radius"], c["df"],
                c["ninv"], c["se"],
            )
            # the one read that takes the branch
            succ, term = read(d["flags"]).tolist()
        last = c["it"] + 1 >= limit
        if succ:
            with span("LM::Accept") as sp:
                advance(c, d, *accept(c, d), nls)
                # the re-evaluation may end the solve (gradient tolerance,
                # non-finite cost): its final code, or the packed read
                # that brings it
                ends = last or int(read(c["term"])) != _CONTINUE
                packed = packed_read(c) if ends else None
            c["accept_s"] += sp.seconds
            return packed
        gmax, gnorm = grad_norms(program, ev, d["state"], c["grad"])
        advance(c, d, c["res"], c["jac"], c["grad"], d["term"], gmax, gnorm, nls)
        return packed_read(c) if last or int(term) != _CONTINUE else None

    def chunk_fn(c, limit):
        dev, dtype = c["state"].device, c["state"].dtype
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        c.update(
            it=0, prepares=0, step_s=0.0, accept_s=0.0,
            n=zero, nsucc=zero, nfail=zero, njac=zero, nls=zero, term=zero, stats=torch.zeros((chunk_iters(options), _N_STATS), dtype=dtype, device=dev),
        )
        per_it = []  # (reads, replays, seconds, end) of each iteration
        packed = None
        while packed is None:
            before = counts()
            with span("LM::Iteration") as it:
                packed = iteration(c, limit)
            counted = counts() - before
            per_it.append((counted["Device::Read"], counted["CUDAGraph::Replay"], it.seconds,
                           it.end_ns))
        return packed, per_it

    chunk_fn.use_split = use_split
    chunk_fn.lazy_prepare = lazy
    return chunk_fn


def _first_carry(minimizer, chunk_fn, state, cost0, res_groups, jac, grad):
    """The fused loop's carry at the start: the Jacobi scale of the first
    Jacobian, the radius and step-evaluator state, and the first prepare
    (where it is not lazy)."""
    options, program = minimizer.options, minimizer.program
    if options.jacobi_scaling:
        scale = 1.0 / (1.0 + torch.sqrt(jac.squared_column_norms()))
    else:
        scale = torch.ones(program.num_effective_parameters, dtype=state.dtype, device=state.device)
    dtype, dev = state.dtype, state.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    # cost0 is the evaluation graph's output, which the next evaluation
    # rewrites: the carry keeps its own copy
    cost0 = cost0.clone()
    return dict(
        state=state,
        cost=cost0,
        res=res_groups,
        jac=jac,
        grad=grad,
        scale=scale,
        radius=torch.full((), float(options.initial_trust_region_radius), dtype=dtype, device=dev),
        df=torch.full((), 2.0, dtype=dtype, device=dev),
        ninv=torch.zeros((), dtype=torch.int32, device=dev),
        se=[cost0, cost0, cost0, cost0, zero, zero, torch.zeros((), dtype=torch.int32, device=dev)],
        pcache=(
            minimizer.prepare(jac, res_groups, grad, scale)
            if chunk_fn.use_split and not chunk_fn.lazy_prepare else None
        ),
    )


def run_fused(minimizer, state, summary):
    """Drive the fused loop in chunks; fills summary like the host loop."""
    options = minimizer.options
    program = minimizer.program
    chunk_fn = minimizer._fused_chunk_fn
    summary.used_fused_execution = True
    start_ns = time.perf_counter_ns()
    before = counts()

    # the first evaluation and its read, the scale and the first prepare
    with span("Minimizer::Start") as first:
        with span("Evaluator::Jacobian") as jac_span:
            cost0, res_groups, jac, grad, gmax0, gnorm0 = minimizer.evaluate(state)
            cost, gmax0, gnorm0 = read(torch.stack([cost0, gmax0, gnorm0])).tolist()
        summary.num_jacobian_evaluations += 1
        summary.jacobian_evaluation_time_in_seconds += jac_span.seconds
        if not math.isfinite(cost):
            summary.termination_type = TerminationType.FAILURE
            summary.message = (
                "Initial cost evaluation failed (non-finite).\n"
                + diagnose_non_finite(program, state)
            )
            return state
        summary.initial_cost = cost + summary.fixed_cost
        carry = None
        if not gmax0 <= options.gradient_tolerance:
            carry = _first_carry(minimizer, chunk_fn, state, cost0, res_groups, jac, grad)

    it0 = IterationSummary(
        iteration=0,
        step_is_valid=True,
        step_is_successful=True,
        cost=cost + summary.fixed_cost,
        gradient_max_norm=gmax0,
        gradient_norm=gnorm0,
        trust_region_radius=float(options.initial_trust_region_radius),
        eta=options.eta,
        num_device_reads=(counts() - before)["Device::Read"],
        iteration_time_in_seconds=first.seconds,
        cumulative_time_in_seconds=first.seconds,
    )
    summary.iterations.append(it0)
    minimizer._log(it0)
    if carry is None:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = (
            f"Gradient tolerance reached. Gradient max norm {gmax0:e}"
            f" <= {options.gradient_tolerance:e}"
        )
        summary.final_cost = cost + summary.fixed_cost
        return state
    cost_host = cost

    iters_done = 0
    term_code = _CONTINUE
    while iters_done < options.max_num_iterations:
        if (time.perf_counter_ns() - start_ns) * 1e-9 > options.max_solver_time_in_seconds:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum solver time reached."
            summary.final_cost = cost_host + summary.fixed_cost
            return carry["state"]
        limit = min(chunk_iters(options), options.max_num_iterations - iters_done)
        with span("FusedLoop::Chunk"):
            packed, per_it = chunk_fn(carry, limit)
        n_it = int(packed[0])
        term_chunk = int(packed[1])
        nsucc, nfail, njac = int(packed[2]), int(packed[3]), int(packed[4])
        cost_host = packed[5]
        nls = int(packed[6])
        stats = [packed[7 + k * _N_STATS: 7 + (k + 1) * _N_STATS] for k in range(n_it)]

        summary.num_successful_steps += nsucc
        summary.num_unsuccessful_steps += nfail
        summary.num_jacobian_evaluations += njac
        summary.num_residual_evaluations += n_it + nls
        summary.num_line_search_steps += nls
        summary.num_linear_solves += n_it
        # the stages' times, from their spans
        summary.linear_solver_time_in_seconds += carry["step_s"]
        summary.jacobian_evaluation_time_in_seconds += carry["accept_s"]

        for k, (row, (reads, replays, seconds, end_ns)) in enumerate(zip(stats, per_it)):
            flags = int(row[_S_FLAGS])
            it_sum = IterationSummary(
                iteration=iters_done + k + 1,
                step_is_valid=bool(flags & 1),
                step_is_successful=bool(flags & 2),
                cost=row[_S_COST] + summary.fixed_cost,
                cost_change=row[_S_CHANGE],
                gradient_max_norm=row[_S_GMAX],
                gradient_norm=row[_S_GNORM],
                step_norm=row[_S_STEPNORM],
                relative_decrease=row[_S_RELDEC],
                trust_region_radius=row[_S_RADIUS],
                eta=options.eta,
                linear_solver_iterations=int(row[_S_LINITERS]),
                num_device_reads=reads,
                num_graph_replays=replays,
                iteration_time_in_seconds=seconds,
                cumulative_time_in_seconds=(end_ns - start_ns) * 1e-9,
            )
            summary.iterations.append(it_sum)
            minimizer._log(it_sum)

        iters_done += n_it
        term_code = term_chunk
        if term_code != _CONTINUE or n_it == 0:
            break

    if term_code != _CONTINUE:
        tt, msg = _TERM_MAP[term_code]
        summary.termination_type = tt
        summary.message = msg
        if term_code == _EVAL_FAIL:
            # name the culprit block(s), the role of the reference's
            # residual_block_utils.cc report
            summary.message += "\n" + diagnose_non_finite(program, carry["state"])
    else:
        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = "Maximum number of iterations reached."
    summary.final_cost = cost_host + summary.fixed_cost
    return carry["state"]
