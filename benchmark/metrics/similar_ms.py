"""The window's ms over the -similar calls it completed, host clock."""


def read(ctx):
    reqs = ctx.window.requests
    return ctx.window.seconds * 1e3 / len(reqs) if reqs else None
