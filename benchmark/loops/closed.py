"""A closed loop of ``clients`` 1: a request is drawn, sent, and its
answer taken in hand before the next is drawn, until ``seconds`` have
passed since the first was sent; the last one sent finishes.

A loop is found by the mix's ``loop`` name; it offers ``drive``.
"""

from __future__ import annotations

import time
import traceback


def drive(verb, stream: int, seconds: float, keep, window) -> None:
    """Requests of ``stream`` back to back for ``seconds``.
    @param keep the reservoir offered each (request, answer as the
           program gave it), or None
    @param window records each request's (sent, answered, needles), and
           the request itself when ``window.sent`` is a list"""
    if verb.mix.get("clients", 1) != 1:
        raise ValueError("a closed loop drives one client")
    gen = verb.requests
    deadline = None
    i = 0
    while True:
        req = gen.request(stream, i)
        sent = time.perf_counter()
        if deadline is None:
            deadline = sent + seconds
        elif sent >= deadline:
            break
        try:
            out = verb.issue(req)
        except Exception:  # noqa: BLE001 - counted as failed, run ends
            traceback.print_exc()
            window.failed += 1
            break
        window.requests.append((sent, time.perf_counter(), req.size))
        if keep is not None:
            keep.offer(lambda: (req, out))
        if window.sent is not None:
            window.sent.append(req)
        i += 1
