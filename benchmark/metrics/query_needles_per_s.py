"""Needles answered in the window over the window's seconds, host clock
(the window: first request sent to last answer in hand)."""


def read(ctx):
    reqs = ctx.window.requests
    return sum(n for _, _, n in reqs) / ctx.window.seconds if reqs else None
