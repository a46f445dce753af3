"""Spans the benchmark records around the calls into the program's layers
in a traced run: each wrapped call's host-clock duration, kept in memory
by name, and a ``torch.profiler.record_function`` of the same name in the
trace; and the host runtime's garbage collections (``gc``: each
collection of any generation, from ``gc.callbacks``)."""

from __future__ import annotations

import functools
import gc
import time

import torch


class Spans:
    def __init__(self):
        self.durations: dict[str, list[float]] = {}
        self.on = False
        self._gc_start = 0.0

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter()
        elif self.on:
            self.durations.setdefault("gc", []).append(
                time.perf_counter() - self._gc_start)

    def __enter__(self):
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Replaces ``obj.attr`` (a method) on this instance by a wrapper
        that records a span named ``name`` while ``on``."""
        fn = getattr(obj, attr)
        spans = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not spans.on:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spans.durations.setdefault(name, []).append(
                        time.perf_counter() - t0)

        setattr(obj, attr, wrapper)
