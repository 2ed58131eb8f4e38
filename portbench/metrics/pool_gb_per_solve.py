"""Device memory: what each window solve left reserved in the allocator
(`Device::Reserved`, memory_reserved() at the solve's end less at its
start: the CUDA graphs' private pools), in GB, averaged; nothing where
the program has no spans or the solves ran on no card."""

import spans


def read(ctx):
    return spans.per_solve(
        ctx, lambda es: es.nbytes("Device::Reserved") / 1e9
        if "Device::Reserved" in es.names() else None)
