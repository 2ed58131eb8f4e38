"""LM loop (solvers/fused_loop.py): the mean
IterationSummary.iteration_time_in_seconds over iterations 2 to 20 of every
window solve, in ms."""


def read(ctx):
    its = [it.iteration_time_in_seconds for s in ctx.solves for it in s.steady]
    return 1e3 * sum(its) / len(its) if its else None
