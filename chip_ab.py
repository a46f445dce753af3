"""K4's wrapper (``hamming_topk``) of this checkout against another
checkout's, in one process on one NVIDIA GPU, under three timing methods.

    git archive <commit> | tar -x -C build/other    # here, with git
    python3 chip_ab.py build/other [ROUNDS]

The other checkout's package is loaded beside this one's under another
name, and each builds its own kernel from its own sources.  On
chip_smoke.py's kernels-phase operands (the same seed: 1024 needles over
2^20 rows with a 400-row cluster, 1% tombstones) it times
``hamming_topk(needles, hay, valid, 64, 5)``, the kernels line's K4
call, as the mean CUDA-event ms of 20 calls after a warm-up.  Each of
ROUNDS rounds (default 10) times both wrappers with each method, the
two in turn (other first in even rounds, this one first in odd ones),
so that the host's speed, which varies over a run, weighs on both:

  on       the collector on throughout (chip_smoke.py's event_ms before
           this one)
  collect  one gc.collect() first, the collector on while the calls run
           (chip_smoke.py's event_ms)
  off      one gc.collect() first, the collector off while they run

Then it traces 20 calls of each with chip_profile.py's ``trace`` (device
busy and idle share, the top kernels, the package's host functions).
Prints the card's name and power limit, one JSON line a round, one a
trace, and last, for each method: the median ms of each wrapper and of
their ratio (other over this) a round, the rounds this one won, and the
other's spread (the distance between its quartiles).  Exits non-zero
when no CUDA device is visible or the two wrappers disagree.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np

SEED = 20261016  # chip_smoke.py's SEED
METHODS = ("on", "collect", "off")


def load_other(root: str):
    """``root``'s ``cbird_tpu_torch`` as package ``other_cbird_tpu_torch``
    (its modules import each other relatively)."""
    init = os.path.join(os.path.abspath(root), "cbird_tpu_torch",
                        "__init__.py")
    spec = importlib.util.spec_from_file_location(
        "other_cbird_tpu_torch", init,
        submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(spec.name + ".ops.hamming_topk")


def event_ms(torch, call, method: str) -> float:
    call()
    torch.cuda.synchronize()
    if method != "on":
        gc.collect()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if method == "off":
        gc.disable()
    try:
        a.record()
        for _ in range(20):
            call()
        b.record()
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return a.elapsed_time(b) / 20


def main() -> int:
    import torch
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print("chip_ab: needs another checkout's path and a CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_profile
    from cbird_tpu_torch.ops import hamming_topk as this_tk
    other_tk = load_other(sys.argv[1])
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    rng = np.random.default_rng(SEED)
    n = 1 << 20
    h64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    h64[1000:1400] = h64[7] ^ np.uint64(1 << 9)
    hay = torch.from_numpy(h64.view(np.int64)).cuda()
    valid = torch.from_numpy(rng.random(n) > 0.01).cuda()
    needles = hay[torch.from_numpy(rng.integers(0, n, 1024)).cuda()] ^ 5
    calls = {name: (lambda tk=tk: tk.hamming_topk(needles, hay, valid, 64,
                                                  5))
             for name, tk in (("other", other_tk), ("this", this_tk))}
    got = {name: call() for name, call in calls.items()}
    if not all(torch.equal(a, b) for a, b in zip(got["other"],
                                                got["this"])):
        print("chip_ab: the two wrappers disagree", file=sys.stderr)
        return 1
    ms = {name: {m: [] for m in METHODS} for name in calls}
    for r in range(rounds):
        order = ("other", "this") if r % 2 == 0 else ("this", "other")
        row = {}
        for m in METHODS:
            for name in order:
                ms[name][m].append(event_ms(torch, calls[name], m))
            row[m] = {name: ms[name][m][-1] for name in calls}
        print(json.dumps({"round": r, "ms": row}), flush=True)
    for name, call in calls.items():
        print(json.dumps({"trace": name,
                          **chip_profile.trace(torch, call, 20)}),
              flush=True)

    def iqr(v):
        q = statistics.quantiles(v, n=4)
        return q[2] - q[0]
    print(json.dumps({
        "median_ms": {name: {m: statistics.median(v) for m, v in d.items()}
                      for name, d in ms.items()},
        "median_other_over_this": {m: statistics.median(
            o / t for o, t in zip(ms["other"][m], ms["this"][m]))
            for m in METHODS},
        "rounds_this_faster": {m: sum(t < o for o, t in zip(
            ms["other"][m], ms["this"][m])) for m in METHODS},
        "other_iqr_ms": {m: iqr(ms["other"][m]) for m in METHODS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
