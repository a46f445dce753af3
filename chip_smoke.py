"""Smoke run of the PyTorch / CUDA port (cbird_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line (pass/fail, numbers, wall ms, card):

  build    nvcc builds every kernel in cbird_tpu_torch/csrc/ (sm_90a)
  kernels  each kernel against its plain PyTorch twin on the card, exact
           equality, at the main path's shapes; both timed (CUDA events)
  hash     4096 synthetic images through DctHasher (canvas 640, batch 64,
           autocrop) on the card; 256 of them against the CPU, <= 1 bit
  query    10M-row store (1000 planted near-duplicate pairs, 1% tombstones):
           1-, 64- and 1024-needle search at threshold 5
  self     1M-row store built the same way: search_self(5, k=64)
  cli      60 base images x 4 variants as files: cbird-torch -create
           -update -similar -json, then -similar-to

The launch counters are zeroed just before the main path (query, self,
cli) and read just after; every kernel must have run there.  The line
before the last is a JSON object with each kernel's numbers, the last is
{"ok": true, "device": {...}}.  Any failure exits non-zero without it.
Exits non-zero at once when no CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 20261016
T = 5  # the default dct threshold (-p.dht)
# image sizes of the hash phase (long side <= 400, the default -i.rsize)
SIZES = [(400, 400), (300, 400), (400, 280), (256, 320), (128, 128),
         (200, 96), (64, 80), (360, 240)]


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.card = torch.cuda.get_device_name(0)
        self.failed: list[str] = []
        self.kernels: dict[str, dict] = {}

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            nums = fn()
            ok = True
        except Exception:  # every phase runs; any failure fails the run
            traceback.print_exc()
            nums, ok = {}, False
            self.failed.append(name)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"phase {name}: {'pass' if ok else 'FAIL'} "
              f"{json.dumps(nums)} wall_ms={ms:.1f} on {self.card}",
              flush=True)

    def event_ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    # ---- data -----------------------------------------------------------
    def planted_store(self, n: int, pairs: int, rng):
        """Random hashes, ``pairs`` planted near-duplicate pairs (1-4 bit
        flips), 1% tombstones (never a planted row).
        @return (hashes u64, ids u32, src rows, dst rows, dead ids)"""
        hashes = rng.integers(1, 2**64, size=n, dtype=np.uint64)
        rows = rng.choice(n, size=2 * pairs, replace=False)
        src, dst = rows[:pairs], rows[pairs:]
        for j in range(pairs):
            flips = rng.choice(64, size=int(rng.integers(1, 5)),
                               replace=False)
            mask = np.uint64(sum(1 << int(b) for b in flips))
            hashes[dst[j]] = hashes[src[j]] ^ mask
        ids = np.arange(1, n + 1, dtype=np.uint32)
        alive = np.ones(n, bool)
        alive[rows] = False
        dead = rng.choice(np.nonzero(alive)[0], size=n // 100, replace=False)
        return hashes, ids, src, dst, ids[dead]

    # ---- phases ---------------------------------------------------------
    def build(self):
        from cbird_tpu_torch import _build
        out = {}
        for name in ("count_below", "hamming_topk"):
            t0 = time.perf_counter()
            _build.load(name)
            out[f"{name}_build_s"] = round(time.perf_counter() - t0, 3)
        return out

    def kernels_phase(self):
        torch = self.torch
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import hamming_topk as tk
        rng = np.random.default_rng(SEED)
        n = 1 << 20
        h64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        h64[1000:1400] = h64[7] ^ np.uint64(1 << 9)  # ties and a cluster
        hay = torch.from_numpy(h64.view(np.int64)).to(self.dev)
        valid = torch.from_numpy(rng.random(n) > 0.01).to(self.dev)
        needles = hay[torch.from_numpy(rng.integers(0, n, 1024)).to(
            self.dev)] ^ 5
        out = {}

        def same(a, b):
            if not torch.equal(a, b):
                raise AssertionError("kernel disagrees with plain version")
            return float((a.long() - b.long()).abs().max())

        err = {"K1": 0.0, "K2": 0.0, "K4": 0.0}
        for m in (n, n - 37):  # ragged haystack edge
            for t in (1, 5, 10, 63):
                got = cb.count_below(needles, hay[:m], valid[:m], t)
                torch.cuda.synchronize()
                err["K1"] = max(err["K1"], same(
                    got, cb.count_below_plain(needles, hay[:m], valid[:m], t)))
        rows, cols = 16384, 65536  # the self-search tile at 1M rows
        # diagonal-straddling, wholly above and wholly below the diagonal
        for rb, c0 in ((0, 0), (16384, 0), (65536 - 16384, 0),
                       (32768, 65536), (147456, 0)):
            args = (hay[rb:rb + rows], hay[c0:c0 + cols],
                    valid[c0:c0 + cols], T)
            kw = dict(masked=True, row_base=rb, col_base=c0)
            got = cb.count_below(*args, **kw)
            torch.cuda.synchronize()
            err["K2"] = max(err["K2"], same(got, cb.count_below_plain(
                *args, **kw)))
        for k in (1, 16, 64, 1024):
            for bound in (65, T):
                d, i = tk.hamming_topk(needles, hay, valid, k, bound)
                torch.cuda.synchronize()
                dp, ip = tk.hamming_topk_plain(needles, hay, valid, k, bound)
                err["K4"] = max(err["K4"], same(d, dp), same(i, ip))

        # times at the main path's shapes: the count gate of a 1024-needle
        # query, a diagonal self-search tile, the top-k at the search bound
        diag = (hay[:rows], hay[:cols], valid[:cols], T)
        timings = {
            "K1": (lambda: cb.count_below(needles, hay, valid, T),
                   lambda: cb.count_below_plain(needles, hay, valid, T)),
            "K2": (lambda: cb.count_below(*diag, masked=True),
                   lambda: cb.count_below_plain(*diag, masked=True)),
            "K4": (lambda: tk.hamming_topk(needles, hay, valid, 64, T),
                   lambda: tk.hamming_topk_plain(needles, hay, valid, 64, T)),
        }
        for name, (kern, plain) in timings.items():
            ms = self.event_ms(kern, 20)
            plain_ms = self.event_ms(plain, 3)
            self.kernels[name].update(max_abs_err=err[name], ms=ms,
                                      plain_ms=plain_ms)
            out[f"{name}_ms"] = round(ms, 4)
            out[f"{name}_plain_ms"] = round(plain_ms, 4)
        out["shapes"] = ("K1 Q=1024 N=2^20 t=5; K2 16384x65536 diagonal; "
                         "K4 Q=1024 N=2^20 k=64 bound=5")
        return out

    def synth_images(self, count: int, sizes=SIZES, seed: int = SEED):
        """Structured grayscale images (sin/cos field + gaussian blobs, as
        the tests' synth_image, plus a fine texture), made in bulk on the
        card from a seed."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        out = []
        per = count // len(sizes)
        for h, w in sizes:
            yy = torch.arange(h, device=self.dev, dtype=torch.float32)
            xx = torch.arange(w, device=self.dev, dtype=torch.float32)
            yy, xx = yy[None, :, None], xx[None, None, :]
            u = lambda *s: torch.rand(*s, generator=g, device=self.dev)
            fx, fy = 8 + 32 * u(per, 1, 1), 8 + 32 * u(per, 1, 1)
            img = 128 + 45 * torch.sin(xx / fx) * torch.cos(yy / fy)
            for _ in range(6):
                cy, cx = h * u(per, 1, 1), w * u(per, 1, 1)
                r = min(h, w) * (0.1 + 0.23 * u(per, 1, 1))
                amp = 120 * u(per, 1, 1) - 60
                img = img + amp * torch.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            # a 4-pixel checkerboard: no row or column is flat, even at
            # half size, so autocrop finds only real letterbox bars; the
            # hash's 32x32 area resize averages it out
            img = img + 50 * ((xx // 4 + yy // 4) % 2) - 25
            arr = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
            out += list(arr)
        return out

    def hash_phase(self):
        from cbird_tpu_torch.ops.dct_hash import DctHasher
        images = self.synth_images(4096)
        gpu = DctHasher(canvas_hw=(640, 640), batch=64, device=self.dev)
        gpu.hash_images(images[:64], do_crop=True)  # warm-up
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        hashes = gpu.hash_images(images, do_crop=True)
        dt = time.perf_counter() - t0
        cpu = DctHasher(canvas_hw=(640, 640), batch=64, device="cpu")
        sub = np.arange(0, 4096, 16)
        ref = cpu.hash_images([images[i] for i in sub], do_crop=True)
        flips = np.bitwise_count(hashes[sub] ^ ref)
        if flips.max() > 1 or (hashes == 0).any() or len(hashes) != 4096:
            raise AssertionError(f"hash mismatch: max {flips.max()} bits")
        return {"images": 4096, "images_per_s": round(4096 / dt, 1),
                "cpu_compared": len(sub),
                "hashes_with_flip": int(np.count_nonzero(flips)),
                "max_flip_bits": int(flips.max())}

    def query_phase(self):
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import hamming_topk as tk
        from cbird_tpu_torch.ops.hamming import PackedHashStore
        rng = np.random.default_rng(SEED + 1)
        n = 10_000_000
        hashes, ids, src, dst, dead = self.planted_store(n, 1000, rng)
        store = PackedHashStore(hashes, ids, device=self.dev)
        store.remove(dead)
        t0 = time.perf_counter()
        store._device_arrays()
        out = {"upload_ms": round((time.perf_counter() - t0) * 1e3, 2)}
        for q in (1, 64, 1024):
            sel = np.arange(min(q, 1000))
            needles = hashes[src[sel]]
            if q > 1000:  # pad with random needles
                needles = np.concatenate([needles, rng.integers(
                    1, 2**64, size=q - 1000, dtype=np.uint64)])
            k1, k4 = cb.count_below.launches, tk.hamming_topk.launches
            res = store.search(needles, T, k=64)
            for j in sel:
                if ids[dst[j]] not in res[j][0]:
                    raise AssertionError(f"q={q}: planted partner missed")
            if tk.hamming_topk.launches == k4:
                raise AssertionError(f"q={q}: K4 did not run")
            if (cb.count_below.launches > k1) != (q > 64):
                raise AssertionError(f"q={q}: K1 gate ran = "
                                     f"{cb.count_below.launches > k1}")
            walls = []
            for _ in range(20 if q < 1024 else 5):
                t0 = time.perf_counter()
                store.search(needles, T, k=64)
                walls.append((time.perf_counter() - t0) * 1e3)
            out[f"q{q}_p50_ms"] = round(float(np.median(walls)), 3)
        return out

    def self_phase(self):
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import hamming_topk as tk
        from cbird_tpu_torch.ops.hamming import PackedHashStore
        rng = np.random.default_rng(SEED + 2)
        n = 1_000_000
        hashes, ids, src, dst, dead = self.planted_store(n, 1000, rng)
        store = PackedHashStore(hashes, ids, device=self.dev)
        store.remove(dead)
        store._device_arrays()
        before = (cb.count_below.launches, cb.count_below.masked_launches,
                  tk.hamming_topk.launches)
        t0 = time.perf_counter()
        res = store.search_self(T, k=64, sparse=True)
        wall = (time.perf_counter() - t0) * 1e3
        for a, b in zip(src, dst):
            if ids[b] not in res.get(a, ((),))[0] or \
                    ids[a] not in res.get(b, ((),))[0]:
                raise AssertionError(f"planted pair {a},{b} missed")
        if store.rescanned:
            raise AssertionError(f"verify rescanned {store.rescanned} rows")
        after = (cb.count_below.launches, cb.count_below.masked_launches,
                 tk.hamming_topk.launches)
        if not all(x > y for x, y in zip(after, before)):
            raise AssertionError(f"a kernel did not run: {before} {after}")
        return {"n": n, "wall_ms": round(wall, 1), "rows_with_hits": len(res),
                "K1_tiles": after[0] - before[0],
                "K2_tiles": after[1] - before[1]}

    def cli_phase(self):
        from PIL import Image
        from cbird_tpu_torch.cli.main import main
        from cbird_tpu_torch.ops import hamming_topk as tk
        bases = self.synth_images(
            60, [(400, 400), (300, 400), (400, 280), (360, 240)], SEED + 3)
        with tempfile.TemporaryDirectory() as d:
            owner = {}
            for b, img in enumerate(bases):
                im = Image.fromarray(img)
                w, h = im.size
                lb = np.zeros((h + 80, w), np.uint8)
                lb[40:40 + h] = img
                variants = {
                    "copy.png": im,
                    "half.png": im.resize((max(1, w // 2), max(1, h // 2)),
                                          Image.BOX),
                    "q50.jpg": im,
                    "letterbox.png": Image.fromarray(lb),
                }
                for name, v in variants.items():
                    path = os.path.join(d, f"b{b:02d}_{name}")
                    v.save(path, quality=50) if name.endswith(".jpg") \
                        else v.save(path)
                    owner[path] = b
            k4 = tk.hamming_topk.launches
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(["-use", d, "-create", "-update", "-similar",
                           "-json"])
            if rc:
                raise AssertionError(f"cli rc {rc}")
            groups = [[m["path"] for m in [g["needle"]] + g["matches"]]
                      for g in json.loads(buf.getvalue())]
            # each base's 4 variants connected through groups, never mixed
            parent = {p: p for p in owner}

            def find(p):
                while parent[p] != p:
                    p = parent[p]
                return p
            for g in groups:
                if len({owner[p] for p in g}) != 1:
                    raise AssertionError(f"group mixes bases: {g}")
                for p in g[1:]:
                    parent[find(p)] = find(g[0])
            joined = sum(len({find(p) for p in owner if owner[p] == b}) == 1
                         for b in range(len(bases)))
            if joined != len(bases):
                raise AssertionError(f"only {joined}/{len(bases)} bases "
                                     f"grouped all 4 variants")
            needle = os.path.join(d, "b07_q50.jpg")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(["-use", d, "-similar-to", needle, "-json"])
            hit = json.loads(buf.getvalue())
            if rc or not hit or {owner[m["path"]] for m in
                                 hit[0]["matches"]} != {7}:
                raise AssertionError("-similar-to missed its variants")
        if tk.hamming_topk.launches == k4:
            raise AssertionError("K4 did not run in the cli phase")
        if "jax" in sys.modules:
            raise AssertionError("jax was imported")
        return {"files": 4 * len(bases), "groups": len(groups),
                "similar_to_matches": len(hit[0]["matches"])}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cbird_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from cbird_tpu_torch.ops import count_below as cb
    from cbird_tpu_torch.ops import hamming_topk as tk

    print(smi(), flush=True)
    s = Smoke(torch)
    s.kernels = {
        "K1": {"name": "count_below", "route": "cuda",
               "source": "cbird_tpu_torch/csrc/count_below.cu",
               "replaces": "cbird_tpu/ops/mxu_count.py:166"},
        "K2": {"name": "count_below_masked", "route": "cuda",
               "source": "cbird_tpu_torch/csrc/count_below.cu",
               "replaces": "cbird_tpu/ops/mxu_count.py:206"},
        "K4": {"name": "hamming_topk", "route": "cuda",
               "source": "cbird_tpu_torch/csrc/hamming_topk.cu",
               "replaces": "cbird_tpu/ops/pallas_hamming.py:104"},
    }
    s.phase("build", s.build)
    s.phase("kernels", s.kernels_phase)
    s.phase("hash", s.hash_phase)
    # the main path: counters from zero, read once it is done
    cb.count_below.launches = 0
    cb.count_below.masked_launches = 0
    tk.hamming_topk.launches = 0
    s.phase("query", s.query_phase)
    s.phase("self", s.self_phase)
    s.phase("cli", s.cli_phase)
    launches = {"K1": cb.count_below.launches,
                "K2": cb.count_below.masked_launches,
                "K4": tk.hamming_topk.launches}
    for name, n in launches.items():
        s.kernels[name]["launches"] = n
        if n == 0:
            s.failed.append(f"{name} never launched on the main path")
    print(json.dumps({"kernels": list(s.kernels.values())}), flush=True)
    if s.failed:
        print(f"chip_smoke: FAILED {s.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
