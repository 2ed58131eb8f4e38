"""Kernel B4's bfloat16 instantiation (the mixed-precision PCG's S·y) as a
share of its roofline over the traced solves: the least time of its calls
at the problem's sizes (metrics/kernels_mixed.json: 2-byte leaves, 4-byte
vectors and outputs) over the device time of its kernels (roofline.share);
nothing without a trace or without a call."""

import os

import roofline

MODEL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels_mixed.json")


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.share(ctx.trace.kernels, "B4_bf16", ctx.sizes, roofline.load(MODEL))
