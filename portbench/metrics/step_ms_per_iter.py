"""PCG (solvers/fused_loop.py): the `LM::Step` span (the prepare where it
is due, the finish's head, the PCG steps with their reads, the tail's
launch) of iterations 2 to 20, in ms, the mean over every window solve;
nothing where the program has no spans."""

import spans


def read(ctx):
    return spans.steady_ms(ctx, "LM::Step")
