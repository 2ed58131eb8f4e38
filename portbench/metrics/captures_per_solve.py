"""Solve entry (utils/graphs.py): the CUDA graphs each window solve
captured (the `CUDAGraph::Capture <graph>` spans), averaged; nothing where
the program has no spans."""

import spans


def read(ctx):
    return spans.per_solve(ctx, lambda es: spans.captures(es)[0])
