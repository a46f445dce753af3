"""This checkout against another checkout's, in one process on one NVIDIA
GPU: K4's wrapper (``hamming_topk``) under three timing methods, and, as
asked, ORB's feature extraction and K3-run's wrapper.

    git archive <commit> | tar -x -C build/other    # here, with git
    python3 chip_ab.py build/other [ROUNDS] [k4] [feat] [k3run]
                                                    (default: k4)

  feat   ``extract_features_batch`` of chip_smoke.py's feat images (1024,
         the same seed), both packages in turn (other, this, this, other:
         ROUNDS // 5 + 1 times): images/s each call, and the features of
         the two equal or not (descriptors and keypoint hashes).
  k3run  ``run_tiles`` at chip_smoke.py's two K3-run shapes (the 3 run
         tiles of its timed block, the ~465 of the 65,536-row cluster):
         the other's wrapper on the tile list as the host list it took,
         this one's on the list on the card; the outputs equal; CUDA-event
         ms of 20 calls (the wrapper back to back) a round, in turns.

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


def load_other(root: str, module: str = "ops.hamming_topk"):
    """``root``'s ``cbird_tpu_torch`` as package ``other_cbird_tpu_torch``
    (its modules import each other relatively), loaded once.
    @return its ``module``"""
    name = "other_cbird_tpu_torch"
    if name not in sys.modules:
        init = os.path.join(os.path.abspath(root), "cbird_tpu_torch",
                            "__init__.py")
        spec = importlib.util.spec_from_file_location(
            name, init, submodule_search_locations=[os.path.dirname(init)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.{module}")


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
    args = sys.argv[2:]
    rounds = int(args.pop(0)) if args and args[0].isdigit() else 10
    parts = args or ["k4"]
    if not set(parts) <= {"k4", "feat", "k3run"}:
        print(f"chip_ab: unknown parts {parts}", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    ok = True
    for part in parts:
        ok &= {"k4": ab_k4, "feat": ab_feat, "k3run": ab_k3run}[part](
            torch, sys.argv[1], rounds)
    return 0 if ok else 1


def ab_k4(torch, root: str, rounds: int) -> bool:
    import chip_profile
    from cbird_tpu_torch.ops import hamming_topk as this_tk
    other_tk = load_other(root)
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
        return False
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
    return True


def ab_feat(torch, root: str, rounds: int) -> bool:
    """ORB's extraction of chip_smoke's feat images by each package."""
    import time
    import chip_smoke
    from cbird_tpu_torch.ops import orb as this_orb
    other_orb = load_other(root, "ops.orb")
    s = chip_smoke.Smoke(torch)
    imgs = s.feat_images(chip_smoke.FEAT_IMAGES,
                         np.random.default_rng(chip_smoke.SEED + 20))
    dev = torch.device("cuda")
    feats, per_s = {}, {"other": [], "this": []}
    for orb in (other_orb, this_orb):  # warm-up: one chunk each
        orb.extract_features_batch(imgs[:64], device=dev)
    for _ in range(rounds // 5 + 1):
        for name in ("other", "this", "this", "other"):
            orb = other_orb if name == "other" else this_orb
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats[name] = orb.extract_features_batch(imgs, device=dev)
            torch.cuda.synchronize()
            per_s[name].append(len(imgs) / (time.perf_counter() - t0))
    diff = {"descriptor_sets": 0, "hash_sets": 0}
    for (da, ha), (db, hb) in zip(feats["other"], feats["this"]):
        diff["descriptor_sets"] += not np.array_equal(da, db)
        diff["hash_sets"] += not np.array_equal(ha, hb)
    print(json.dumps({"part": "feat", "images": len(imgs),
                      "images_per_s": per_s,
                      "median_images_per_s": {k: statistics.median(v)
                                              for k, v in per_s.items()},
                      "images_whose_features_differ": diff}), flush=True)
    return True


def ab_k3run(torch, root: str, rounds: int) -> bool:
    """K3-run's wrapper of each package at chip_smoke's two shapes."""
    import chip_smoke
    from cbird_tpu_torch.ops import band_count as this_bc
    from cbird_tpu_torch.ops import pigeonhole as ph
    other_bc = load_other(root, "ops.band_count")
    s = chip_smoke.Smoke(torch)
    n, sz, _ = chip_smoke.K3_CHECKS[0]
    rng = np.random.default_rng(chip_smoke.SEED + 5)
    shapes = {"3 tiles": s.k3_data(n, sz, rng)}
    h64, valid = s.k3_data(n, sz, rng)
    m0 = ph.mask64(ph.block_masks(chip_smoke.T)[0]) % 2**64
    s.k3_cluster(h64, np.arange(n // 4, n // 4 + chip_smoke.K3_CLUSTER), rng,
                 outside=m0)
    shapes["cluster"] = (h64, valid)
    ok = True
    for shape, (h, v) in shapes.items():
        ops, masks, key_s = s.k3_block(h, v, chip_smoke.T, 0, sz)
        tiles = ph.run_tile_pairs(key_s, s.changes(key_s), sz)
        host = [tuple(p) for p in tiles.tolist()]
        outs = {k: torch.zeros_like(ops[1]) for k in ("other", "this")}
        calls = {"other": lambda: other_bc.run_tiles(
                     outs["other"], *ops, host, masks, chip_smoke.T, sz),
                 "this": lambda: this_bc.run_tiles(
                     outs["this"], *ops, tiles, masks, chip_smoke.T, sz)}
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        if not torch.equal(outs["other"], outs["this"]):
            print(f"chip_ab: K3-run wrappers disagree at {shape}",
                  file=sys.stderr)
            ok = False
        ms = {k: [] for k in calls}
        for r in range(rounds):
            for name in (("other", "this") if r % 2 == 0
                         else ("this", "other")):
                ms[name].append(event_ms(torch, calls[name], "collect"))
        print(json.dumps({"part": "k3run", "shape": shape,
                          "tiles": len(host), "ms": ms,
                          "median_ms": {k: statistics.median(v)
                                        for k, v in ms.items()}}),
              flush=True)
    return ok

if __name__ == "__main__":
    sys.exit(main())
