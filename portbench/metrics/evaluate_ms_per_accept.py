"""Evaluate + Schur prepare (solvers/fused_loop.py): the `LM::Accept` span
of each successful iteration 2 to 20 (the evaluation at the candidate,
the prepare of its Jacobian and the read that ends the iteration), in ms,
the mean over every window solve; nothing where the program has no
spans."""

import spans


def read(ctx):
    return spans.steady_ms(ctx, "LM::Accept")
