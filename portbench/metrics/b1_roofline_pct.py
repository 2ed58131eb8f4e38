"""Kernel B1's share of its roofline over the traced solves: the least
time of its calls at the problem's sizes (metrics/kernels.json) over the
device time of its kernels (roofline.share); nothing without a trace."""

import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.share(ctx.trace.kernels, "B1", ctx.sizes, ctx.kernels)
