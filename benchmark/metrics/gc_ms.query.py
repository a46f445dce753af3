"""ms a request the host runtime (CPython's garbage collector, every
generation) spent collecting during the traced window, from
``gc.callbacks``: a pause of the program's host path, whatever caused it."""

from benchlib.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "gc")
