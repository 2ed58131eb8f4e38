"""The example programs of the port, one module each (the reference's
examples/*.cc mains, as the JAX package's examples/*.py):

    python -m ceres_tpu_torch.examples.scripts.<name> [flags] [--device cpu]

Each takes the flags of the JAX package's script of the same name, plus
`--device` (by default the card, as every entry point of the port). The C
API example (examples/curve_fitting.c) waits for the port of the C API.
"""
