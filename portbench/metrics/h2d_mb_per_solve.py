"""Solve entry (utils/graphs.upload): the bytes of the host arrays each
window solve made tensors on the card (`Device::Upload`: Program.arrays,
state_vector, the Program's cached tables), in MB, averaged; nothing
where the program has no spans."""

import spans


def read(ctx):
    return spans.per_solve(ctx, lambda es: es.nbytes("Device::Upload") / 1e6)
