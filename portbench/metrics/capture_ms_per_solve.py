"""Solve entry (utils/graphs.py): the ms of each window solve's CUDA graph
warm-ups and captures (the `CUDAGraph::Capture <graph>` spans), averaged;
nothing where the program has no spans."""

import spans


def read(ctx):
    return spans.per_solve(ctx, lambda es: 1e3 * spans.captures(es)[1])
