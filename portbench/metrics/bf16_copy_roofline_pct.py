"""The bfloat16 copy of the Jacobian's leaves and twins (the launch
leaf_to_bf16, once per Schur prepare of a mixed-precision solve) as a share
of its roofline over the traced solves: 4 bytes read and 2 written per
copied value at the problem's sizes (metrics/kernels_mixed.json) over the
launches' device time (roofline.share); nothing without a trace, or where
no such launch ran (a program that copies with PyTorch's own kernels)."""

import os

import roofline

MODEL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels_mixed.json")


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.share(ctx.trace.kernels, "bf16_copy", ctx.sizes, roofline.load(MODEL))
