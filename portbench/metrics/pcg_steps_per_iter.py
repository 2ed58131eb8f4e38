"""PCG (linalg/cg.py, B4): IterationSummary.linear_solver_iterations, the
mean over iterations 1 to 20 of every window solve."""


def read(ctx):
    its = [it.linear_solver_iterations for s in ctx.solves for it in s.steps]
    return sum(its) / len(its) if its else None
