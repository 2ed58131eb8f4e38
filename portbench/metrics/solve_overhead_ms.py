"""Solve entry (solvers/solver.py: Evaluator construction, uploads,
iteration 1's graph captures, the write-back): per window solve, its host
wall time minus its iterations 2 to 20, in ms, averaged."""


def read(ctx):
    if not ctx.solves:
        return None
    over = [s.wall_s - sum(it.iteration_time_in_seconds for it in s.steady) for s in ctx.solves]
    return 1e3 * sum(over) / len(over)
