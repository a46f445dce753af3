"""The database layer's own ms a request: the span around
``Database.similar_to`` (a call a needle) less the span around the
index's ``find_batch``: sorting and cutting the matches, reading each
match's media from the collection, the index's descriptor lookup."""

from benchlib.readers import self_ms


def read(ctx):
    return self_ms(ctx, "database", "index")
