"""Device: the share of the traced window (whole solves, resets included)
in which no kernel, copy or memset ran (devtrace.Trace)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share()
