"""The index layer's own ms a request: the span around the index's
find_batch less the span around its store's search (the ``Match`` lists
and the needles' arrays)."""

from benchlib.readers import self_ms


def read(ctx):
    return self_ms(ctx, "index", "store")
