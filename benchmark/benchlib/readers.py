"""Shared arithmetic of the metric readers (``benchmark/metrics/``)."""

from __future__ import annotations

from .manifest import part


def roofline(ctx, name: str):
    """A kernel's share of its roofline over the traced window, in %: the
    least time of the traced calls' work (``benchmark/rooflines/<name>.py``
    ``least_s``) over the device time of the kernels it names.  None when
    the trace holds no such kernel or no call needed its work."""
    mod = part("rooflines", name)
    least = [s for s in (mod.least_s(rec) for rec in ctx.work)
             if s is not None]
    busy = ctx.trace.kernel_s(mod.KERNEL) if ctx.trace is not None else 0.0
    if not least or busy <= 0:
        return None
    return 100.0 * sum(least) / busy


def idle_share(ctx):
    """The traced window's share in which no kernel, copy or set ran on
    the device, in %."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def self_ms(ctx, outer: str, inner: str):
    """ms a request of the traced window spends in span ``outer`` outside
    span ``inner``."""
    calls = ctx.spans.get(outer, [])
    n = len(ctx.window.requests)
    if not calls or not n:
        return None
    return 1e3 * (sum(calls) - sum(ctx.spans.get(inner, []))) / n


def per_call_ms(ctx, span: str):
    """ms of span ``span`` a request, over the traced window's requests."""
    n = len(ctx.window.requests)
    if not n:
        return None
    return 1e3 * sum(ctx.spans.get(span, [])) / n
