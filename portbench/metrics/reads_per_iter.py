"""LM loop: device-to-host reads per LM iteration
(IterationSummary.num_device_reads, each drains the stream), the mean over
iterations 1 to 20 of every window solve."""


def read(ctx):
    its = [it.num_device_reads for s in ctx.solves for it in s.steps]
    return sum(its) / len(its) if its else None
