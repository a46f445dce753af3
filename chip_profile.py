"""Where the time goes: the port's main path traced on one NVIDIA GPU.

    python3 chip_profile.py [NAME ...]

Builds chip_smoke's stores and images and, for each configuration below
(those whose names start with one of the NAMEs, when any are given),
prints one JSON line: wall ms per call (host clock to the card's idle),
device busy ms per call (the kernels', copies' and sets' time from
``torch.profiler``, in a traced step after a traced warm-up step of at
least WARM_S; a trace with no device event raises),
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
  feat 1024             extract_features_batch (ORB, 400 features, 12
                        levels, descriptors and keypoint hashes) over
                        chip_smoke's 1024 textured images
  fdct similar 2^22     chip_smoke's fdct store (2^22 keypoint-hash rows):
                        find_all at t=5
  fdct similar-to 16    the same store: find_batch of 16 needle images
  orb similar-to 16     chip_smoke's orb store (2^20 descriptors):
                        find_batch of 16 needle images (K5)
  orb similar 2^18      the same store: find_batch of the images of its
                        first 2^18 rows
  cdesc 256             create_descriptors (canvas 256) over the first 256
                        of chip_smoke's colored images (a trace of all
                        1024 holds too many events to finish)
  color similar-to 64   chip_smoke's color store (2^20 descriptors):
                        find_batch of its 64 planted sources (K6)
  color similar 2^16    the first 2^16 rows of that store: find_all (the
                        count-bucketed self-search)
  tm match 64 groups    chip_smoke's tm collection cut to TM_PROFILE
                        sources and as many distractors: a fresh
                        TemplateMatcher's match_groups over the first 64
                        of fdct -similar's groups (-p.tm's verification)
  serve query dct / fdct / tm
                        a QueryServer's engine over that index: a warm
                        query of a source (tm: -p.alg fdct -p.tm 1, the
                        matcher made anew a call, so no verdict is cached)

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
WARM_S = 1.0  # the traced warm-up step's least length
# the configurations after the color ones (they share the 10M-row store's
# random draws, so it is made for any of them)
HASH_CONFIGS = ("search q1 10M", "search q64 10M", "search q1024 10M",
                "self 10M ph", "self 1M triangle", "self 1M ph", "hash 1024",
                "feat 1024", "fdct similar 2^22", "fdct similar-to 16",
                "orb similar-to 16", "orb similar 2^18",
                "video (a) similar 4096x512",
                "video (b) similar-to 16384 frames")


def trace(torch, fn, reps: int) -> dict:
    fn()  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # an untimed step of at least WARM_S, traced and discarded (the
    # schedule's warm-up), before the timed one: after a trace of many
    # events (feat 1024) the next traces lost the device records of their
    # first tens of milliseconds, so that a short one (orb similar-to 16)
    # held no device event and longer ones lost their first calls' kernels
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        t0 = time.perf_counter()
        while True:
            fn()
            torch.cuda.synchronize()
            if time.perf_counter() - t0 >= WARM_S:
                break
        prof.step()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    # kernels, copies and sets only: an operator's entry repeats the
    # device time of the kernels it launched, and the step's annotation on
    # the device spans them
    dev = [(e.key, e.self_device_time_total / 1e3 / reps)
           for e in prof.key_averages()
           if e.device_type != torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0
           and not e.key.startswith("ProfilerStep")]
    busy = sum(ms for _, ms in dev)
    if not dev:
        raise RuntimeError("the trace holds no device event")
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
            "idle_share": 1 - busy / wall, "device_entries": len(dev),
            "top_kernels_ms": [[k[:60], round(ms, 4)] for k, ms in top],
            "top_host_cum_ms": [[k, round(ms, 2)] for k, ms in host]}


def feature_configs(torch, s, want, show):
    """The fdct and orb configurations, on chip_smoke's data."""
    from cbird_tpu_torch.ops import orb
    from cbird_tpu_torch.params import SearchParams
    from cbird_tpu_torch.store.media import Media
    sp = SearchParams()
    if want("feat 1024"):
        imgs = s.feat_images(chip_smoke.FEAT_IMAGES,
                             np.random.default_rng(chip_smoke.SEED + 20))
        show("feat 1024", trace(
            torch, lambda: orb.extract_features_batch(imgs, device=s.dev), 2))
        del imgs
    kp = chip_smoke.KP
    if want("fdct similar 2^22", "fdct similar-to 16"):
        idx, hashes, _, groups = s.fdct_index(
            np.random.default_rng(chip_smoke.SEED + 21))
        if want("fdct similar 2^22"):
            show("fdct similar 2^22", trace(torch, lambda: idx.find_all(sp),
                                            2))
        needles = []
        for src, _ in groups[:chip_smoke.FEAT_NEEDLES]:
            m = Media(f"/needle/{src}.png")
            m.keyPointHashes = hashes[(src - 1) * kp:src * kp]
            needles.append(m)
        if want("fdct similar-to 16"):
            show("fdct similar-to 16", trace(
                torch, lambda: idx.find_batch(needles, sp), 3))
        del idx, hashes
        torch.cuda.empty_cache()
    if want("orb similar-to 16", "orb similar 2^18"):
        idx, desc, groups = s.orb_index(
            np.random.default_rng(chip_smoke.SEED + 22))
        needles = []
        for src, _ in groups[:chip_smoke.FEAT_NEEDLES]:
            m = Media(f"/needle/{src}.png")
            m.keyPointDescriptors = desc[(src - 1) * kp:src * kp].view(
                np.uint8).reshape(kp, 32)
            needles.append(m)
        if want("orb similar-to 16"):
            show("orb similar-to 16", trace(
                torch, lambda: idx.find_batch(needles, sp), 3))
        first = [Media(id=i) for i in
                 range(1, chip_smoke.ORB_SIMILAR_ROWS // kp + 1)]
        if want("orb similar 2^18"):
            show("orb similar 2^18", trace(
                torch, lambda: idx.find_batch(first, sp), 1))
        del idx, desc
        torch.cuda.empty_cache()


def color_configs(torch, s, want, show):
    """The color configurations, on chip_smoke's data."""
    from cbird_tpu_torch.ops import color
    from cbird_tpu_torch.params import SearchParams
    sp = SearchParams()
    if want("cdesc 256"):
        imgs = s.color_images(chip_smoke.CDESC_IMAGES,
                              np.random.default_rng(chip_smoke.SEED + 31))
        imgs = imgs[:256]
        show("cdesc 256", trace(
            torch, lambda: color.create_descriptors(imgs, device=s.dev), 1))
        del imgs
    if not want("color similar-to 64", "color similar 2^16"):
        return
    descs, ids, groups = s.color_store(
        np.random.default_rng(chip_smoke.SEED + 32))
    if want("color similar-to 64"):
        idx = s.color_index(descs, ids, s.dev)
        needles = s.color_needles(descs, groups)
        show("color similar-to 64", trace(
            torch, lambda: idx.find_batch(needles, sp), 3))
        del idx
    if want("color similar 2^16"):
        n = chip_smoke.COLOR_SIMILAR_ROWS
        idx = s.color_index(descs[:n], ids[:n], s.dev)
        show("color similar 2^16", trace(torch, lambda: idx.find_all(sp), 1))
        del idx
    torch.cuda.empty_cache()


TM_PROFILE = 64  # sources (and distractors) of the tm configurations


def tm_configs(torch, s, want, show):
    """The template matcher's and the query server's configurations, on a
    cut of chip_smoke's tm collection (its index built by the CLI)."""
    if not want("tm match 64 groups", "serve query dct", "serve query fdct",
                "serve query tm"):
        return
    import contextlib
    import io
    import shutil
    import tempfile
    from cbird_tpu_torch.cli.main import main as cli
    from cbird_tpu_torch.host.engine import Engine
    from cbird_tpu_torch.host.template_matcher import TemplateMatcher
    from cbird_tpu_torch.params import SearchParams
    d = tempfile.mkdtemp(prefix="cbird-tm-")
    try:
        s.tm_collection(d, np.random.default_rng(chip_smoke.SEED + 40),
                        TM_PROFILE, TM_PROFILE)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["-use", d, "-create", "-i.algos", "dct+fdct", "-i.fsize",
                 "0", "-update",
                 "-p.alg", "fdct", "-similar", "-json"])
        raw = json.loads(buf.getvalue())[:64]
        eng = Engine(d, device=s.dev)
        db = eng.db
        sp = SearchParams()

        def groups():
            return [(db.media_with_path(g["needle"]["path"]),
                     [db.media_with_path(m["path"]) for m in g["matches"]])
                    for g in raw]
        if want("tm match 64 groups"):
            show("tm match 64 groups", trace(torch, lambda: TemplateMatcher(
                eng.scanner.decode_image, s.dev).match_groups(groups(), sp),
                1))
        needle = db.media_with_path(os.path.join(d, "t000_src.png"))
        for kind in ("dct", "fdct", "tm"):
            name = f"serve query {kind}"
            if not want(name):
                continue
            p = SearchParams()
            p.set_param("alg", "dct" if kind == "dct" else "fdct")
            p.templateMatch = kind == "tm"

            def query():
                eng._tm = None
                return eng.query(needle, p)
            show(name, trace(torch, query, 3))
        db.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    import torch
    names = sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2

    def want(*configs):
        return not names or any(c.startswith(n) for c in configs
                                for n in names)
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

    color_configs(torch, s, want, show)
    tm_configs(torch, s, want, show)
    if not want(*HASH_CONFIGS):
        return 0

    big, needles = store(10_000_000)  # made always: the same rng draws
    for q in (1, 64, 1024):
        nd = np.concatenate([needles, rng.integers(
            1, 2**64, size=max(0, q - len(needles)), dtype=np.uint64)])[:q]
        if want(f"search q{q} 10M"):
            show(f"search q{q} 10M", trace(
                torch, lambda: big.search(nd, T, k=64), 10 if q < 1024 else 3))
    if want("self 10M ph"):
        show("self 10M ph", trace(
            torch, lambda: big.search_self(T, k=64, sparse=True), 2))
    del big
    small, _ = store(1_000_000)
    if want("self 1M triangle"):
        os.environ["CBIRD_PIGEONHOLE"] = "off"
        show("self 1M triangle", trace(
            torch, lambda: small.search_self(T, k=64, sparse=True), 2))
        del os.environ["CBIRD_PIGEONHOLE"]
    if want("self 1M ph"):
        show("self 1M ph", trace(
            torch, lambda: small.search_self(T, k=64, sparse=True), 3))
    if want("hash 1024"):
        images = s.synth_images(1024)
        hasher = DctHasher(canvas_hw=(640, 640), batch=64, device=s.dev)
        show("hash 1024", trace(
            torch, lambda: hasher.hash_images(images, do_crop=True), 2))
        del hasher, images
    feature_configs(torch, s, want, show)
    if not want("video (a) similar 4096x512",
                "video (b) similar-to 16384 frames"):
        return 0
    from cbird_tpu_torch.params import SearchParams
    sp = SearchParams()
    vrng = np.random.default_rng(chip_smoke.SEED + 8)
    data = s.video_data(vrng)
    if want("video (a) similar 4096x512"):
        idx, h = s.video_index(data, black=False)
        needles, _ = s.video_live(data, h)
        show("video (a) similar 4096x512", trace(
            torch, lambda: idx.find_batch(needles, sp), 2))
        del idx, needles
        torch.cuda.empty_cache()
    idx, h = s.video_index(data, black=True)
    needle, _, _ = s.video_needle(data, h, vrng)
    if want("video (b) similar-to 16384 frames"):
        show("video (b) similar-to 16384 frames", trace(
            torch, lambda: idx.find(needle, sp), 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
