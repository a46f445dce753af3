"""Smoke run of the PyTorch / CUDA port (cbird_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--triangle-all]

--triangle-all checks the ph phase's 10M-row store against the whole
classic triangle too (~28 s more on an H100), which also times it.

Phases, each printed on its own line (pass/fail, numbers, wall ms, card):

  build    nvcc builds every kernel in cbird_tpu_torch/csrc/ (sm_90a), one
           process per source, all at once
  kernels  each kernel against its plain PyTorch twin on the card, exact
           equality, at the main path's shapes; both timed (CUDA events)
  hash     4096 synthetic images through DctHasher (canvas 640, batch 64,
           autocrop) on the card; 256 of them against the CPU, <= 1 bit
  query    10M-row store (1000 planted near-duplicate pairs, 1% tombstones):
           1-, 64- and 1024-needle search at threshold 5
  self     1M-row store built the same way: search_self(5, k=64) through
           the classic triangle (CBIRD_PIGEONHOLE=off), then through the
           pigeonhole count phase; equal results, both walls
  ph       2M- and 10M-row stores built the same way, the 10M one plus a
           5000-row cluster that shares one block's key: search_self(5,
           k=64) through the pigeonhole count phase (K3); then, as checks,
           its counts against the classic triangle's on every row at 2M
           and against K2 on sampled rows at 10M (every row with
           --triangle-all)
  cli      60 base images x 4 variants as files: cbird-torch -create
           -update -similar -json, then -similar-to

The main path is query, self, ph and cli: the launch counters are zeroed
just before each of them and read just after; every kernel must have run
there.  Launches made only to check a result (the ph phase's count
checks) are left out of the counts.  The line before the last is a JSON
object with each kernel's numbers, the last is {"ok": true, "device":
{...}}.  Any failure exits non-zero without it.  Exits non-zero at once
when no CUDA device is visible.

Bounds (bound_ms): the larger of the bytes a call must move over 3.35
TB/s and the operations this run's data needs over the peak rate of
their type on 132 SMs at the card's maximum SM clock (nvidia-smi
clocks.max.sm): 16 POPC and 64 INT32 instructions per clock per SM.
"""

from __future__ import annotations

import concurrent.futures as cf
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
SMS = 132
HBM_BYTES_PER_S = 3.35e12
POPC_PER_CLK = 16  # 32-bit POPC per clock per SM (sm_90)
INT32_PER_CLK = 64
KERNELS = ("count_below", "hamming_topk", "band_count")
# sizes: K3's checks (sorted block rows, tile size s, thresholds; the
# first is timed; s=1024 and 4096 are the other sizes the main path
# picks), the self phase's store, the ph phase's stores (the first is
# checked on every row against the triangle, ~N^2 / 3.8e12 s; the second
# on PH_SAMPLE blocks of 64 rows)
K3_CHECKS = ((1 << 20, 2048, (T, 1)), (1 << 20, 1024, (T,)),
             (1 << 21, 4096, (T,)))
SELF_ROWS = 1_000_000
PH_ROWS = (2_000_000, 10_000_000)
PH_SAMPLE = 128


def smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def smi_mhz(field: str) -> float:
    return float(smi(field).split()[0])


class Smoke:
    def __init__(self, torch, triangle_all: bool = False):
        self.torch = torch
        self.triangle_all = triangle_all
        self.dev = torch.device("cuda")
        self.card = torch.cuda.get_device_name(0)
        self.failed: list[str] = []
        self.errors: dict[str, str] = {}  # phase -> summary of its failure
        self.kernels: dict[str, dict] = {}
        self.clock_hz = smi_mhz("clocks.max.sm") * 1e6
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import hamming_topk as tk
        # kernel -> (wrapper, attribute of its launch counter)
        self.counters = {"K1": (cb.count_below, "launches"),
                         "K2": (cb.count_below, "masked_launches"),
                         "K3": (bc.band_counts, "launches"),
                         "K3-run": (bc.run_tiles, "launches"),
                         "K4": (tk.hamming_topk, "launches")}

    def launches(self) -> dict[str, int]:
        return {k: getattr(f, a) for k, (f, a) in self.counters.items()}

    def set_launches(self, counts: dict[str, int]):
        for k, (f, a) in self.counters.items():
            setattr(f, a, counts[k])

    @contextlib.contextmanager
    def uncounted(self):
        """Launches inside only check a result: the counters are put back
        as they were before."""
        saved = self.launches()
        try:
            yield
        finally:
            self.set_launches(saved)

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            nums = fn()
            ok = True
        except Exception as e:  # every phase runs; any failure fails the run
            traceback.print_exc()
            nums, ok = {}, False
            self.failed.append(name)
            self.errors[name] = self.summary(e)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"phase {name}: {'pass' if ok else 'FAIL'} "
              f"{json.dumps(nums)} wall_ms={ms:.1f} on {self.card}",
              flush=True)

    @staticmethod
    def summary(e: Exception) -> str:
        """One line for the end of the output: the exception and the
        innermost line of this repository it passed through."""
        here = os.path.dirname(os.path.abspath(__file__))
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if os.path.abspath(f.filename).startswith(here)]
        at = (f" at {os.path.relpath(frames[-1].filename, here)}:"
              f"{frames[-1].lineno}" if frames else "")
        msg = str(e).splitlines()[0] if str(e) else ""
        return f"{type(e).__name__}: {msg}{at}"

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

    def bound(self, nbytes: float, popc: float = 0, int_ops: float = 0):
        """@return (bound_ms, bound_by): the least time the card could take
        to move ``nbytes`` and execute ``popc`` POPC and ``int_ops`` INT32
        instructions, and which of the two bounds it."""
        clk = self.clock_hz * SMS
        by_ops = max(popc / (POPC_PER_CLK * clk),
                     int_ops / (INT32_PER_CLK * clk))
        by_bytes = nbytes / HBM_BYTES_PER_S
        if by_ops >= by_bytes:
            return by_ops * 1e3, "operations"
        return by_bytes * 1e3, "bytes"

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
        t0 = time.perf_counter()

        def one(name):
            _build.build(name)
            return round(time.perf_counter() - t0, 3)
        with cf.ThreadPoolExecutor(len(KERNELS)) as ex:
            done = dict(zip(KERNELS, ex.map(one, KERNELS)))
        for name in KERNELS:
            _build.load(name)
        out = {f"{name}_build_s": s for name, s in done.items()}
        out.update(nvcc=_build.nvcc(), torch=self.torch.__version__,
                   torch_cuda=self.torch.version.cuda)
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
        q = needles.numel()
        k2_pairs = rows * cols - rows * (rows + 1) // 2  # column > row
        bounds = {  # bytes moved, POPC executed (two per 64-bit pair)
            "K1": self.bound(9 * n + 12 * q, popc=2 * q * n),
            "K2": self.bound(9 * cols + 12 * rows, popc=2 * k2_pairs),
            "K4": self.bound(9 * n + 8 * q + 8 * q * 64,
                             popc=2 * 2 * q * n),  # two passes
        }
        # yardstick of a tensor-core form (not the same function): the
        # +-1 int8 product of the same needles and haystack
        pm = (torch.randint(0, 2, (q, 64), device=self.dev) * 2 - 1).to(
            torch.int8)
        hm = (torch.randint(0, 2, (64, n), device=self.dev) * 2 - 1).to(
            torch.int8)
        int_mm_ms = self.event_ms(lambda: torch._int_mm(pm, hm), 5)
        del pm, hm
        for name, (kern, plain) in timings.items():
            ms = self.event_ms(kern, 20)
            plain_ms = self.event_ms(plain, 3)
            bound_ms, bound_by = bounds[name]
            self.kernels[name].update(
                max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            if name != "K4":
                self.kernels[name]["int_mm_yardstick_ms"] = int_mm_ms
            out[f"{name}_ms"] = round(ms, 4)
            out[f"{name}_plain_ms"] = round(plain_ms, 4)
            out[f"{name}_bound_ms"] = round(bound_ms, 4)
        out["int_mm_1024x64x2^20_ms"] = round(int_mm_ms, 4)
        out["shapes"] = ("K1 Q=1024 N=2^20 t=5; K2 16384x65536 diagonal; "
                         "K4 Q=1024 N=2^20 k=64 bound=5")
        out.update(self.k3_kernels())
        return out

    def k3_block(self, h64, valid, t: int, b: int, s: int):
        """Block ``b`` of threshold ``t`` sorted by the port's own count
        phase code: (K3 operands, masks (current first), sorted valid
        keys)."""
        torch = self.torch
        from cbird_tpu_torch.ops import pigeonhole as ph
        masks = [ph.mask64(m) for m in ph.block_masks(t)]
        hashes = torch.from_numpy(h64.view(np.int64)).to(self.dev)
        vd = torch.from_numpy(valid).to(self.dev)
        rows = torch.nonzero(vd).flatten()
        dead = torch.nonzero(~vd).flatten()
        key_s, srow = ph.sort_block(hashes, rows, dead, masks[b])
        return ph.pad_block(hashes, vd, srow, s), masks[b::-1], key_s

    def k3_work(self, key_s, s: int, tiles=None):
        """(pairs, candidates) of this block: the valid pairs the band (or
        the run tiles) covers, and those among them with equal block keys,
        the only ones whose distance the data needs tested."""
        torch = self.torch
        m = key_s.numel()
        if tiles is not None:
            pairs = cands = 0
            for ta, tb in tiles:
                a, b = key_s[ta * s:(ta + 1) * s], key_s[tb * s:(tb + 1) * s]
                pairs += a.numel() * b.numel()
                cands += int((a[:, None] == b[None, :]).sum())
            return pairs, cands
        p = torch.arange(m, device=self.dev)
        change = torch.ones(m, dtype=torch.bool, device=self.dev)
        change[1:] = key_s[1:] != key_s[:-1]
        starts = torch.nonzero(change).flatten()
        ends = torch.cat([starts[1:], starts.new_tensor([m])])
        run_end = ends[torch.cumsum(change, 0) - 1]  # exclusive
        win = torch.clamp((p // s + 2) * s, max=m)
        pairs = int((win - p - 1).clamp(min=0).sum())
        cands = int((torch.minimum(win, run_end) - p - 1).clamp(min=0).sum())
        return pairs, cands

    def k3_data(self, n: int, s: int, rng):
        """``n`` random hashes with 1% tombstones, a ragged 37-row invalid
        tail and two planted over-long runs: 3s rows that share block 0's
        key of t=5 (every 15th of them within 2 bits of one base, outside
        the block) and 1.25 s copies of one hash.
        @return (hashes u64, valid bool)"""
        from cbird_tpu_torch.ops import pigeonhole as ph
        h64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        m0 = np.uint64(ph.mask64(ph.block_masks(T)[0]) % 2**64)
        run = np.arange(n // 10, n // 10 + 3 * s)
        h64[run] = (h64[run] & ~m0) | (h64[7] & m0)
        free = [b for b in range(64) if not int(m0) >> b & 1]
        for r in run[::15]:
            flips = rng.choice(free, size=int(rng.integers(0, 3)),
                               replace=False)
            h64[r] = h64[7] ^ np.uint64(sum(1 << int(b) for b in flips))
        h64[n // 2:n // 2 + 5 * s // 4] = h64[9]
        valid = rng.random(n) > 0.01
        valid[-37:] = False
        return h64, valid

    def k3_kernels(self):
        """K3 (band and run tiles) against the plain versions on sorted
        blocks at every size of K3_CHECKS (``k3_data``), every block of each
        threshold; times the first size's t=5 block 0."""
        torch = self.torch
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import pigeonhole as ph
        rng = np.random.default_rng(SEED + 5)
        out, err = {}, {"K3": 0, "K3-run": 0}
        timed = None
        for n, s, ts in K3_CHECKS:
            h64, valid = self.k3_data(n, s, rng)
            for t in ts:
                for b in range(t):
                    ops, masks, key_s = self.k3_block(h64, valid, t, b, s)
                    got = bc.band_counts(*ops, masks, t, s)
                    want = bc.band_counts_plain(*ops, masks, t, s)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"K3 band s={s} t={t} block {b}")
                    change = torch.ones_like(key_s, dtype=torch.bool)
                    change[1:] = key_s[1:] != key_s[:-1]
                    tiles = ph.run_tile_pairs(key_s, change, s)
                    bc.run_tiles(got, *ops, tiles, masks, t, s)
                    bc.run_tiles_plain(want, *ops, tiles, masks, t, s)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"K3 run tiles s={s} t={t} "
                                             f"block {b}")
                    out[f"s{s}_t{t}_b{b}"] = {"credits": int(want.sum()),
                                              "run_tiles": len(tiles)}
                    if timed is None:
                        timed = n, s, ops, masks, key_s, tiles
            if not any(out[f"s{s}_t{t}_b0"]["run_tiles"] for t in ts):
                raise AssertionError(f"s={s}: no over-long run reached the "
                                     f"run tiles")
        n, s, ops, masks, key_s, tiles = timed
        csort = torch.zeros_like(ops[1])
        n_tot = ops[0].numel()
        pairs, cands = self.k3_work(key_s, s)
        rpairs, rcands = self.k3_work(key_s, s, tiles)
        # bounds: 17 bytes a row (hash, row, valid, credit); the data needs
        # a pair tested only where the block keys are equal (the run edges
        # of a sorted block cost ~4 INT32 a row to find): 2 POPC and ~4
        # INT32 (two xors, the add, the compare) per equal-key pair
        run_rows = 2 * s * len(tiles)
        timings = {
            "K3": (lambda: bc.band_counts(*ops, masks, T, s),
                   lambda: bc.band_counts_plain(*ops, masks, T, s),
                   self.bound(17 * n_tot, popc=2 * cands,
                              int_ops=4 * cands + 4 * n_tot)),
            "K3-run": (lambda: bc.run_tiles(csort, *ops, tiles, masks, T, s),
                       lambda: bc.run_tiles_plain(csort, *ops, tiles, masks,
                                                  T, s),
                       self.bound(17 * run_rows, popc=2 * rcands,
                                  int_ops=4 * rcands + 4 * run_rows)),
        }
        for name, (kern, plain, (bound_ms, bound_by)) in timings.items():
            ms = self.event_ms(kern, 20)
            plain_ms = self.event_ms(plain, 3)
            self.kernels[name].update(
                max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            out[f"{name}_ms"] = round(ms, 4)
            out[f"{name}_plain_ms"] = round(plain_ms, 4)
            out[f"{name}_bound_ms"] = round(bound_ms, 4)
        out["K3_pairs"], out["K3_candidates"] = pairs, cands
        out["K3-run_pairs"], out["K3-run_candidates"] = rpairs, rcands
        out["K3_pairs_per_s"] = pairs / (self.kernels["K3"]["ms"] * 1e-3)
        out["sm_clock_mhz_after"] = smi_mhz("clocks.sm")
        out["k3_shapes"] = (
            "checked: " + ", ".join(f"{c[0]}-row block s={c[1]} t={c[2]}"
                                    for c in K3_CHECKS)
            + f"; timed: {n}-row block, s={s}, t={T} block 0 (band, and "
              f"its {len(tiles)} run tiles)")
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
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import hamming_topk as tk
        from cbird_tpu_torch.ops.hamming import PackedHashStore
        rng = np.random.default_rng(SEED + 2)
        n = SELF_ROWS
        hashes, ids, src, dst, dead = self.planted_store(n, 1000, rng)
        store = PackedHashStore(hashes, ids, device=self.dev)
        store.remove(dead)
        store._device_arrays()
        # the classic triangle (K1, K2), as the reference's own switch
        # selects it, then the default pigeonhole count phase (K3)
        before = (cb.count_below.launches, cb.count_below.masked_launches,
                  tk.hamming_topk.launches)
        os.environ["CBIRD_PIGEONHOLE"] = "off"
        try:
            wall, res = self.timed(lambda: store.search_self(T, k=64,
                                                             sparse=True))
        finally:
            del os.environ["CBIRD_PIGEONHOLE"]
        if store.pigeonhole is not None:
            raise AssertionError("pigeonhole ran with CBIRD_PIGEONHOLE=off")
        self.check_planted(res, ids, src, dst)
        if store.rescanned:
            raise AssertionError(f"verify rescanned {store.rescanned} rows")
        after = (cb.count_below.launches, cb.count_below.masked_launches,
                 tk.hamming_topk.launches)
        if not all(x > y for x, y in zip(after, before)):
            raise AssertionError(f"a kernel did not run: {before} {after}")
        k3 = bc.band_counts.launches
        wall_ph, res_ph = self.timed(lambda: store.search_self(T, k=64,
                                                               sparse=True))
        if store.pigeonhole is None or bc.band_counts.launches == k3:
            raise AssertionError("the pigeonhole path was not taken")
        self.check_same(res, res_ph)
        return {"n": n, "triangle_wall_ms": round(wall, 1),
                "pigeonhole_wall_ms": round(wall_ph, 1),
                "rows_with_hits": len(res),
                "K1_tiles": after[0] - before[0],
                "K2_tiles": after[1] - before[1],
                "pigeonhole_s": store.pigeonhole["s"]}

    def timed(self, fn):
        """@return (wall ms to the card's idle, fn's result)"""
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    @staticmethod
    def check_planted(res, ids, src, dst):
        for a, b in zip(src, dst):
            if ids[b] not in res.get(a, ((),))[0] or \
                    ids[a] not in res.get(b, ((),))[0]:
                raise AssertionError(f"planted pair {a},{b} missed")

    @staticmethod
    def check_same(a: dict, b: dict):
        if sorted(a) != sorted(b) or not all(
                np.array_equal(a[r][0], b[r][0])
                and np.array_equal(a[r][1], b[r][1]) for r in a):
            raise AssertionError("pigeonhole and triangle lists differ")

    def ph_phase(self):
        """The pigeonhole count phase on the user scale ROADMAP names."""
        torch = self.torch
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import pigeonhole as ph
        from cbird_tpu_torch.ops.hamming import PackedHashStore
        rng = np.random.default_rng(SEED + 4)
        out = {}
        for n in PH_ROWS:
            hashes, ids, src, dst, dead = self.planted_store(n, 1000, rng)
            clus = np.empty(0, np.int64)
            if n == PH_ROWS[-1]:
                # 5000 rows that share block 0's key and are random in their
                # other bits: one equal-key run ~3x the band, so run tiles
                # launch, with no giant duplicate cluster for the top-k
                m0 = np.uint64(ph.mask64(ph.block_masks(T)[0]) % 2**64)
                pool = np.setdiff1d(np.arange(n), np.r_[src, dst])
                clus = rng.choice(pool, 5000, replace=False)
                hashes[clus] = (hashes[clus] & ~m0) | (hashes[clus[0]] & m0)
            store = PackedHashStore(hashes, ids, device=self.dev)
            store.remove(dead)
            hd, vd = store._device_arrays()
            n_valid = int(np.count_nonzero(store.ids))
            k3 = (bc.band_counts.launches, bc.run_tiles.launches)
            wall, res = self.timed(lambda: store.search_self(T, k=64,
                                                             sparse=True))
            self.check_planted(res, ids, src, dst)
            if store.rescanned:
                raise AssertionError(f"verify rescanned {store.rescanned}")
            if store.pigeonhole is None or bc.band_counts.launches == k3[0]:
                raise AssertionError(f"n={n}: pigeonhole path not taken")
            if n == PH_ROWS[-1] and bc.run_tiles.launches == k3[1]:
                raise AssertionError("the planted run launched no run tiles")
            row = {"search_self_wall_ms": round(wall, 1),
                   "s_per_block": store.pigeonhole["s"],
                   "run_tiles_per_block": store.pigeonhole["run_tiles"],
                   "rows_with_hits": len(res)}
            with self.uncounted():  # checks, not the main path
                count_ms, counts = self.timed(
                    lambda: ph.self_counts(hd, vd, T, n_valid))
                if counts[n:].any():
                    raise AssertionError(f"n={n}: a padding row counted")
                if n == PH_ROWS[0] or self.triangle_all:
                    tri_ms, tri = self.timed(
                        lambda: store._classic_self_counts(
                            hd, vd, T, hd.numel(), 32768, 1 << 17))
                    if not np.array_equal(counts[:n], tri):
                        raise AssertionError(f"n={n}: pigeonhole counts "
                                             f"differ from the triangle's")
                    row["triangle_count_ms"] = round(tri_ms, 1)
                else:
                    row["rows_checked_by_K2"] = self.check_sampled(
                        counts, hd, vd, n, np.r_[src, dst, clus], rng)
            row["pigeonhole_count_ms"] = round(count_ms, 1)
            row["later_hits"] = int(counts.sum())
            out[f"n{n}"] = row
            del store, hd, vd, counts, res
            torch.cuda.empty_cache()
        return out

    def check_sampled(self, counts, hd, vd, n: int, planted, rng) -> int:
        """``counts`` (later-row hits per store row) against K2 on
        PH_SAMPLE blocks of 64 rows, each masked to the columns after its
        row: half start at planted rows, half at random ones.
        @return the number of rows checked"""
        from cbird_tpu_torch.ops import count_below as cb
        starts = np.r_[rng.choice(planted, PH_SAMPLE // 2, replace=False),
                       rng.integers(0, n, PH_SAMPLE // 2)]
        starts = np.minimum(starts, n - 64)
        rows = 0
        for rb in map(int, starts):
            k2 = cb.count_below(hd[rb:rb + 64], hd[rb:], vd[rb:], T,
                                masked=True, row_base=rb, col_base=rb)
            want = (k2 * vd[rb:rb + 64]).cpu().numpy()
            if not np.array_equal(counts[rb:rb + 64], want):
                raise AssertionError(f"pigeonhole counts differ from K2 at "
                                     f"rows {rb}..{rb + 63}")
            rows += 64
        return rows

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
        bad = [m for m in sys.modules if m in ("jax", "cbird_tpu")
               or m.startswith(("jax.", "cbird_tpu."))]
        if bad:
            raise AssertionError(f"the JAX side was imported: {bad[:5]}")
        return {"files": 4 * len(bases), "groups": len(groups),
                "similar_to_matches": len(hit[0]["matches"])}


def main() -> int:
    args = sys.argv[1:]
    if any(a != "--triangle-all" for a in args):
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2
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

    print(smi(), flush=True)
    s = Smoke(torch, triangle_all=bool(args))
    s.kernels = {
        "K1": {"name": "count_below", "route": "cuda",
               "source": "cbird_tpu_torch/csrc/count_below.cu",
               "replaces": "cbird_tpu/ops/mxu_count.py:166"},
        "K2": {"name": "count_below_masked", "route": "cuda",
               "source": "cbird_tpu_torch/csrc/count_below.cu",
               "replaces": "cbird_tpu/ops/mxu_count.py:206"},
        "K3": {"name": "band_counts", "route": "cuda",
               "source": "cbird_tpu_torch/csrc/band_count.cu",
               "replaces": "cbird_tpu/ops/pallas_band.py:149"},
        "K3-run": {"name": "run_tiles", "route": "cuda",
                   "source": "cbird_tpu_torch/csrc/band_count.cu",
                   "replaces": "cbird_tpu/ops/pigeonhole.py:489"},
        "K4": {"name": "hamming_topk", "route": "cuda",
               "source": "cbird_tpu_torch/csrc/hamming_topk.cu",
               "replaces": "cbird_tpu/ops/pallas_hamming.py:104"},
    }
    for k in s.kernels.values():
        k["launches"] = 0
    s.phase("build", s.build)
    s.phase("kernels", s.kernels_phase)
    s.phase("hash", s.hash_phase)
    # the main path: each phase with the counters from zero, read just after
    for name, fn in (("query", s.query_phase), ("self", s.self_phase),
                     ("ph", s.ph_phase), ("cli", s.cli_phase)):
        s.set_launches(dict.fromkeys(s.counters, 0))
        s.phase(name, fn)
        got = s.launches()
        print(f"launches in {name}: {json.dumps(got)}", flush=True)
        for k, n in got.items():
            s.kernels[k]["launches"] += n
    for name, k in s.kernels.items():
        if k["launches"] == 0:
            s.failed.append(f"{name} never launched on the main path")
    print(json.dumps({"kernels": list(s.kernels.values())}), flush=True)
    if s.failed:
        print(f"chip_smoke: FAILED {s.failed}", file=sys.stderr)
        for name, err in s.errors.items():
            print(f"chip_smoke: {name}: {err}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
