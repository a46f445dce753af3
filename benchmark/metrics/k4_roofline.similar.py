"""Share of its roofline of the kernel that ``benchmark/rooflines/k4.py``
counts, over the traced window, %."""

from benchlib.readers import roofline


def read(ctx):
    return roofline(ctx, "k4")
