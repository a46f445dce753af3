"""Seconds from the start of run.py to the first timed request: imports,
the CUDA context, the data, the index's load, the pools and the warm-up
(in a new checkout also the kernels' build)."""


def read(ctx):
    return ctx.setup_s
