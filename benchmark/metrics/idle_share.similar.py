"""The traced window's share in which the device ran no kernel, copy or
set (1 - the union of their intervals / the window), %."""

from benchlib.readers import idle_share


def read(ctx):
    return idle_share(ctx)
