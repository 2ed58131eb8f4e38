"""Solve entry (evaluator.py): the `Evaluator::Build` span of each window
solve (the Program's device tables uploaded again, the generated kernels
looked up), in ms, averaged; nothing where the program has no spans."""

import spans


def read(ctx):
    return spans.per_solve(ctx, lambda es: 1e3 * es.seconds("Evaluator::Build"))
