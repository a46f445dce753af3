"""One run of one cell: set-up, warm-up, the window, the check, the line.

Set-up (``setup_s``) runs from the start of ``run.py`` to the first timed
request: importing torch and the port, the CUDA context, the cell's data
from the seed, the index through its load path, the needle pools, and
WARM_REQUESTS warm-up requests (the first builds the kernels in a new
checkout and loads them), then a full collection of the host runtime's
garbage, so every run's window starts from the same state of the
collector and no set-up garbage is collected inside it.

The parts, each found by name: the index adapter
(``benchmark/indexes/<index>.py``, the configuration's ``index``: the
data and the index), the verb (``benchmark/verbs/<index>.<verb>.py``, the
mix's ``verb``: the requests, the entry they go through and the check)
and the loop (``benchmark/loops/<loop>.py``, the mix's ``loop``: when
each request is sent).

The window (``--trace 0``): the loop sends requests until ``--seconds``
have passed since the first was sent; the window runs from the first send
to the last answer.  A seeded reservoir keeps ``check.requests`` of the
window's requests with their answers as the program gave them; they are
put into the benchmark's own arrays after the window.

The traced window (``--trace 1``): the verb's trace preparation (work
counts the roofline readers need that do not change from call to call),
then a traced warm-up step of at least TRACE_WARM_S seconds, dropped (a
short trace without it has lost its device events), then a traced step of
min(``--seconds``, TRACE_SECONDS) seconds with the benchmark's spans on;
its requests are the reservoir's.  The step records each request it sent
and nothing else; each call's work record is made from them after the
step.  The per-layer readers read the trace, the spans and the work.

The check runs after the window, once the memory peak has been read and
the index freed: the reservoir's answers against the plain reference,
each number beside its limit (``benchmark/workloads/<cell>.json``).
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time

import numpy as np

from . import data
from .manifest import Manifest, part
from .spans import Spans
from .trace import Trace
from .traffic import TRACE, TRACE_WARM, WARM, WINDOW

FORBIDDEN = ("jax", "jaxlib", "flax", "cbird_tpu")
WARM_REQUESTS = 3
TRACE_WARM_S = 1.0
TRACE_SECONDS = 5.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from the
    seed (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([data.seed_of(seed), 2])
        self.items: list = []
        self.seen = 0

    def offer(self, make) -> None:
        """@param make returns the item; called only when it is kept"""
        if self.seen < self.size:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = make()
        self.seen += 1


class Window:
    """What a window measured: each request's (sent, answered, needles),
    and in a traced window each request sent (``sent``; ``work``: the
    work records of the calls they made, made from them after the
    window)."""

    def __init__(self, record: bool = False):
        self.requests: list[tuple[float, float, int]] = []
        self.failed = 0
        self.sent: list | None = [] if record else None
        self.work: list[dict] = []

    @property
    def seconds(self) -> float:
        return self.requests[-1][1] - self.requests[0][0]


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def traced(verb, loop, seconds: float, keep: Reservoir, device):
    """@return (Window of the traced step, Trace, Spans)"""
    import torch
    spans = Spans()
    verb.instrument(spans)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    window = Window(record=True)
    with spans, torch.profiler.profile(activities=acts,
                                       schedule=sched) as prof:
        loop.drive(verb, TRACE_WARM, TRACE_WARM_S, None, Window())
        _sync(device)
        prof.step()
        spans.on = True
        loop.drive(verb, TRACE, min(seconds, TRACE_SECONDS), keep, window)
        _sync(device)
        spans.on = False
    trace = Trace(prof) if device.type == "cuda" else Trace(prof, ("cpu_op",))
    return window, trace, spans


class Clock:
    """Seconds of each part of a run, and the window's latencies, printed
    to standard error (before the check lines) for the reader of a run."""

    def __init__(self, t0: float):
        self.last = t0
        self.parts: list[tuple[str, float]] = []

    def mark(self, what: str) -> None:
        now = time.perf_counter()
        self.parts.append((what, now - self.last))
        self.last = now

    def report(self, window: Window) -> None:
        print("seconds: " + ", ".join(f"{w} {s:.3f}" for w, s in self.parts),
              file=sys.stderr)
        lat = np.array([b - a for a, b, _ in window.requests]) * 1e3
        if len(lat):
            q = np.percentile(lat, [0, 50, 90, 95, 99, 100])
            print(f"requests {len(lat)}, latency ms min/p50/p90/p95/p99/max "
                  + "/".join(f"{x:.3f}" for x in q), file=sys.stderr)
            print("answered a second, by quarter of the window "
                  + "/".join(f"{x:.1f}" for x in quarter_rates(window)),
                  file=sys.stderr)


def quarter_rates(window: Window) -> list[float]:
    """Needles (``-similar``: calls) a second answered in each quarter of
    the window, by the time each answer came: how steady the rate was
    inside one run."""
    t0, span = window.requests[0][0], window.seconds
    done = [0] * 4
    for _, answered, n in window.requests:
        done[min(3, int(4 * (answered - t0) / span))] += n
    return [4 * x / span for x in done]


class Context:
    """What a metric reader reads (``benchmark/metrics/<name>.py``
    ``read(ctx)``): ``window`` (the requests), ``setup_s``; in a traced
    run ``trace``, ``spans`` (durations by name) and ``work`` (each traced
    call's work record)."""

    def __init__(self, window: Window, setup_s: float, trace=None,
                 spans=None):
        self.window = window
        self.setup_s = setup_s
        self.trace = trace
        self.spans = spans.durations if spans is not None else {}
        self.work = window.work


def run(manifest: Manifest, name: str, seed: int, seconds: float,
        traced_run: bool, device, t0: float, overrides: dict | None = None
        ) -> dict:
    """One run of cell ``name`` on ``device``.  @param overrides keys
    replacing the configuration's and the mix's (``config``, ``traffic``:
    the tests' small sizes)
    @return the result line's object"""
    cell = manifest.cell(name)
    cfg = manifest.config(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        mix.update(overrides.get("traffic", {}))
    check = cell["check"]
    clock = Clock(t0)
    verb_mod = part("verbs", f"{cfg['index']}.{mix['verb']}")
    loop = part("loops", mix.get("loop", "closed"))
    system = part("indexes", cfg["index"]).System(
        cfg, mix, seed, device, clock.mark,
        media_table=getattr(verb_mod, "MEDIA_TABLE", False))
    verb = verb_mod.Verb(system, mix, seed)
    clock.mark("requests")
    for i in range(WARM_REQUESTS):
        verb.issue(verb.requests.request(WARM, i))
    _sync(device)
    gc.collect()
    clock.mark("warm-up")
    keep = Reservoir(check["requests"], seed)
    if traced_run:
        verb.prepare_trace()
        _sync(device)
        window, trace, spans = traced(verb, loop, seconds, keep, device)
        setup_s = float("nan")
    else:
        setup_s = time.perf_counter() - t0
        window = Window()
        loop.drive(verb, WINDOW, seconds, keep, window)
        _sync(device)
        trace = spans = None
    clock.mark("window")
    kept = [(req, verb.compact(req, out)) for req, out in keep.items]
    keep.items = []
    if window.sent is not None:
        window.work = [rec for req in window.sent for rec in verb.work(req)]
    dev_info = device_info(device, cell.get("chips", 1))
    system.free()
    numbers = verb.check(kept, check.get("sample", {}), seed)
    clock.mark("check")
    limits = check["limits"]
    ctx = Context(window, setup_s, trace, spans)
    metrics = {}
    for m in manifest.metrics(name, per_layer=traced_run):
        value = part("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not traced_run:
            raise RuntimeError(f"no reading of {m['name']}")
    if traced_run:
        dev_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
    correct = (window.failed == 0 and len(window.requests) > 0
               and set(numbers) == set(limits)
               and all(numbers[k] <= limits[k] for k in limits))
    out = {"correct": correct, "attempted": len(window.requests)
           + window.failed, "failed": window.failed, "metrics": metrics,
           "device": dev_info}
    if traced_run:
        out["breakdown"] = trace.breakdown()
    clock.mark("metrics")
    clock.report(window)
    out["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]}
                     for k in limits}
    return out


def device_info(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    name = torch.cuda.get_device_name(device)
    return {"platform": "gpu", "kind": name, "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips)),
            "power_limit": power_limit()}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ('' without)."""
    import subprocess
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else ""


def _clean(x):
    """Floats as JSON takes them: inf and nan as strings."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clean(v) for v in x]
    return x


def main(args, root: str, t0: float) -> int:
    import torch
    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    chips = cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(manifest, args.workload, args.seed, args.seconds,
              bool(args.trace), torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded JAX modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(_clean(out)))
    return 0
