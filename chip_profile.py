"""Where the time goes: the port's main path traced on one NVIDIA GPU.

    python3 chip_profile.py

Builds chip_smoke's stores and images and, for each configuration below,
prints one JSON line: wall ms per call (host clock to the card's idle),
device busy ms per call (the kernels', copies' and sets' time from
``torch.profiler``),
the idle share 1 - busy / wall, the five device kernels with the most
time, and the host functions with the most cumulative time in one call
under ``cProfile`` (a separate, untraced call).  The card's name and power
limit come first.

  search q{1,64,1024}   needle search at threshold 5, 10M-row store
  self 1M triangle      search_self(5, k=64) with CBIRD_PIGEONHOLE=off
  self 1M / 10M ph      search_self(5, k=64) through the pigeonhole phase
  hash 1024             DctHasher, canvas 640, batch 64, autocrop
  video (a) similar     chip_smoke's video collection (4096 videos x 512
                        frames): find_batch over every live video, the
                        all-pairs self-search
  video (b) similar-to  the same collection with its black frames: find
                        of the unstored 16384-frame needle video

Exits non-zero when no CUDA device is visible.
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import time

import numpy as np

import chip_smoke

T = chip_smoke.T


def trace(torch, fn, reps: int) -> dict:
    fn()  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    # kernels, copies and sets only: an operator's entry repeats the
    # device time of the kernels it launched
    dev = [(e.key, e.self_device_time_total / 1e3 / reps)
           for e in prof.key_averages()
           if e.device_type != torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    busy = sum(ms for _, ms in dev)
    top = sorted(dev, key=lambda kv: -kv[1])[:5]
    prof_host = cProfile.Profile()
    prof_host.enable()
    fn()
    torch.cuda.synchronize()
    prof_host.disable()
    st = pstats.Stats(prof_host)
    host = sorted(((f"{os.path.basename(k[0])}:{k[2]}", v[3] * 1e3)
                   for k, v in st.stats.items()
                   if "cbird_tpu_torch" in k[0]), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall, "busy_ms": busy,
            "idle_share": 1 - busy / wall,
            "top_kernels_ms": [[k[:60], round(ms, 4)] for k, ms in top],
            "top_host_cum_ms": [[k, round(ms, 2)] for k, ms in host]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cbird_tpu_torch.ops.dct_hash import DctHasher
    from cbird_tpu_torch.ops.hamming import PackedHashStore
    print(chip_smoke.smi(), flush=True)
    s = chip_smoke.Smoke(torch)
    rng = np.random.default_rng(chip_smoke.SEED + 6)

    def store(n):
        hashes, ids, src, _, dead = s.planted_store(n, 1000, rng)
        st = PackedHashStore(hashes, ids, device=s.dev)
        st.remove(dead)
        st._device_arrays()
        return st, hashes[src]

    def show(name, nums):
        print(json.dumps({"config": name, **nums}), flush=True)

    big, needles = store(10_000_000)
    for q in (1, 64, 1024):
        nd = np.concatenate([needles, rng.integers(
            1, 2**64, size=max(0, q - len(needles)), dtype=np.uint64)])[:q]
        show(f"search q{q} 10M", trace(
            torch, lambda: big.search(nd, T, k=64), 10 if q < 1024 else 3))
    show("self 10M ph", trace(
        torch, lambda: big.search_self(T, k=64, sparse=True), 2))
    del big
    small, _ = store(1_000_000)
    os.environ["CBIRD_PIGEONHOLE"] = "off"
    show("self 1M triangle", trace(
        torch, lambda: small.search_self(T, k=64, sparse=True), 2))
    del os.environ["CBIRD_PIGEONHOLE"]
    show("self 1M ph", trace(
        torch, lambda: small.search_self(T, k=64, sparse=True), 3))
    images = s.synth_images(1024)
    hasher = DctHasher(canvas_hw=(640, 640), batch=64, device=s.dev)
    show("hash 1024", trace(
        torch, lambda: hasher.hash_images(images, do_crop=True), 2))
    del hasher, images
    from cbird_tpu_torch.params import SearchParams
    sp = SearchParams()
    vrng = np.random.default_rng(chip_smoke.SEED + 8)
    data = s.video_data(vrng)
    idx, h = s.video_index(data, black=False)
    needles, _ = s.video_live(data, h)
    show("video (a) similar 4096x512", trace(
        torch, lambda: idx.find_batch(needles, sp), 2))
    del idx, needles
    torch.cuda.empty_cache()
    idx, h = s.video_index(data, black=True)
    needle, _, _ = s.video_needle(data, h, vrng)
    show("video (b) similar-to 16384 frames", trace(
        torch, lambda: idx.find(needle, sp), 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
