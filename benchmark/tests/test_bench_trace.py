"""The trace reader on a synthetic Chrome trace: the window is the host
step's, device time is the union of kernel, copy and set intervals, idle
gaps go to the innermost host event around them."""

import json

import pytest

from benchlib.trace import Trace


class FakeProfiler:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    ev("user_annotation", "ProfilerStep#1", 0, 1000),
    ev("user_annotation", "index", 0, 900),
    ev("cpu_op", "aten::copy_", 600, 100),
    ev("kernel", "void (anonymous namespace)::topk_scan(long)", 100, 200),
    ev("kernel", "wgmma_count_kernel<E4M3, false>(int)", 250, 150),
    ev("gpu_memcpy", "Memcpy DtoH", 640, 20),
    ev("kernel", "void (anonymous namespace)::topk_scan(long)", 950, 100),
    # the device-side twin of the step, spanning only what it saw
    ev("gpu_user_annotation", "ProfilerStep#1", 100, 300),
]


def test_window_busy_kernels_and_gaps():
    t = Trace(FakeProfiler(EVENTS))
    assert t.window_s == pytest.approx(1000e-6)
    # union: [100, 400] + [640, 660] + [950, 1000] (clipped to the window)
    assert t.busy_s == pytest.approx((300 + 20 + 50) * 1e-6)
    assert t.kernel_s("topk_scan") == pytest.approx(250e-6)
    assert t.kernel_s("wgmma_count_kernel") == pytest.approx(150e-6)
    # gaps [0, 100] and [400, 640] in "index", [660, 950]: middle 805 in
    # "index" too; aten::copy_ ends at 700, before it
    assert t.gaps == pytest.approx({"index": (100 + 240 + 290) * 1e-6})
    names = [name for name, _ in t.breakdown()["device_ops"]]
    assert names[0] == "topk_scan" and "wgmma_count_kernel<E4M3, false>" \
        in names


def test_a_gap_deep_inside_a_long_span_goes_to_the_span():
    """A call's span that began more than SCAN_BACK ops before a gap
    still names it."""
    from benchlib.trace import SCAN_BACK
    ops = [ev("cpu_op", "aten::nonzero", 10 + 2 * i, 1)
           for i in range(SCAN_BACK + 10)]
    end = 2 * (10 + 2 * (SCAN_BACK + 10))  # the gap's middle: past every op
    events = [ev("user_annotation", "ProfilerStep#1", 0, end + 200),
              ev("user_annotation", "index", 5, end + 150), *ops,
              ev("kernel", "topk_scan", end, 100)]
    t = Trace(FakeProfiler(events))
    assert t.gaps == pytest.approx({"index": (end + 100) * 1e-6})


def test_a_trace_without_device_events_raises():
    with pytest.raises(RuntimeError):
        Trace(FakeProfiler(EVENTS[:3]))
