"""What the span readers share: the window solves' ExecutionSummaries
(ceres_tpu_torch.utils.execution_summary), read through their spans and
counters. A program without spans (no `Solve` span in its summaries)
gives nothing."""

SOLVE = "Solve"
CAPTURE = "CUDAGraph::Capture "  # + the graph's name


def summaries(ctx):
    """The window solves' ExecutionSummaries, or None where they hold no
    spans."""
    out = [getattr(s.summary, "execution_summary", None) for s in ctx.solves]
    if not out or not all(hasattr(es, "spans") and es.spans(SOLVE) for es in out):
        return None
    return out


def per_solve(ctx, value):
    """The mean of value(execution summary) over the window's solves, or
    None (no spans, or a value of None)."""
    exs = summaries(ctx)
    if exs is None:
        return None
    vals = [value(es) for es in exs]
    if any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def captures(es):
    """(calls, seconds) of the CUDA graph captures of one solve."""
    names = [n for n in es.names() if n.startswith(CAPTURE)]
    return sum(es.calls(n) for n in names), sum(es.seconds(n) for n in names)


def steady_ms(ctx, name, first=2):
    """The mean ms of the spans `name` whose parent is an LM::Iteration
    span of iteration `first` or later, over the window's solves."""
    exs = summaries(ctx)
    if exs is None:
        return None
    ms = []
    for es in exs:
        recs = es.spans()
        iteration = {}
        for i, r in enumerate(recs):
            if r.name == "LM::Iteration":
                iteration[i] = len(iteration) + 1
        ms += [1e3 * r.seconds for r in recs
               if r.name == name and iteration.get(r.parent, 0) >= first]
    return sum(ms) / len(ms) if ms else None
