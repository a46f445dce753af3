"""Reading a ``torch.profiler`` trace of the traced window.

The profiler's Chrome trace is written to a temporary file, read and
deleted.  Device time is the kernels', copies' and sets' (categories
``kernel``, ``gpu_memcpy``, ``gpu_memset``): their intervals merged, so
overlapping work counts once.  The window is the profiler step that ran
the traced requests.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")  # ops, then spans
STEP = "ProfilerStep#"
TOP = 10
SCAN_BACK = 256  # host events looked at, backwards, for each idle gap


def short(name: str, width: int = 96) -> str:
    """A kernel's or op's name without its return type, namespace of its
    own file and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def _merge(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """@attr busy_s union of device intervals inside the window
    @attr window_s the traced step's length
    @attr kernels {name: device seconds}, full names"""

    def __init__(self, prof, device_cats=DEVICE_CATS):
        """@param device_cats the event categories counted as device work
        (a CPU run, which has no device, passes ``("cpu_op",)`` to drive
        the same code)"""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        # the step's host-side annotation: its device-side twin
        # (gpu_user_annotation) spans only the device work it saw
        steps = [e for e in events if e.get("cat") == "user_annotation"
                 and e["name"].startswith(STEP)]
        dev = [e for e in events if e.get("cat") in device_cats]
        if not dev:
            raise RuntimeError("the trace holds no device event")
        if steps:
            w0 = steps[-1]["ts"]
            w1 = w0 + steps[-1]["dur"]
        else:
            w0 = min(e["ts"] for e in events)
            w1 = max(e["ts"] + e["dur"] for e in events)
        self.window_s = (w1 - w0) * 1e-6
        self.kernels: dict[str, float] = {}
        spans = []
        for e in dev:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b <= a:
                continue
            spans.append((a, b))
            self.kernels[e["name"]] = self.kernels.get(e["name"], 0.0) + \
                (b - a) * 1e-6
        busy = _merge(spans)
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        ops, spans = ([(e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in events if e.get("cat") == cat
                       and not e["name"].startswith(STEP)]
                      for cat in HOST_CATS)
        self.gaps = self._gaps(busy, sorted(ops), sorted(spans), w0, w1)

    @staticmethod
    def _around(host: list, starts: list, mid: float, back: int):
        """The latest-starting of the last ``back`` host events starting
        before ``mid`` that is still running at ``mid``, or None."""
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 1 - back), -1):
            if host[j][1] >= mid:
                return host[j][2]
        return None

    @classmethod
    def _gaps(cls, busy: list, ops: list, spans: list, w0: float,
              w1: float) -> dict:
        """Idle device time by the innermost host op running at each gap's
        middle; where no op runs, the innermost span (ops are many and
        short, so SCAN_BACK of them are looked at; spans are few and as
        long as a call, so all of them)."""
        op_starts = [h[0] for h in ops]
        span_starts = [h[0] for h in spans]
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        out: dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            name = cls._around(ops, op_starts, mid, SCAN_BACK) or \
                cls._around(spans, span_starts, mid, len(spans))
            name = short(name, 64) if name else "(no host op)"
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
        return out

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name holds ``pattern``."""
        return sum(s for name, s in self.kernels.items() if pattern in name)

    def breakdown(self) -> dict:
        ops: dict[str, float] = {}
        for name, s in self.kernels.items():
            ops[short(name)] = ops.get(short(name), 0.0) + s
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}
