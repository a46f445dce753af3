"""Smoke run of the PyTorch / CUDA port (cbird_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--triangle-all]

--triangle-all checks the ph phase's 10M-row store against the whole
classic triangle too (~28 s more on an H100), which also times it.

Phases, each printed on its own line (pass/fail, numbers, wall ms, card):

  build    nvcc builds every kernel in cbird_tpu_torch/csrc/ (sm_90a) and
           chip_bounds.py's clock probe, one process per source, all at
           once
  kernels  each kernel against its plain PyTorch twin on the card, exact
           equality, at the main path's shapes; both timed (CUDA events);
           the tensor-core count (K1-mma, int8 and bf16) also against the
           popcount K1, and the three timed at the K1 variants' shapes;
           the top-k (K4) also timed at the query phase's and video (a)'s
           shapes (the wrapper, and its scan kernel alone), with the
           needles that took its second pass at each checked (k, bound)
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
  video    4096 videos x 512 retained frames (2^21 frame rows) built with
           add_video: 64 planted copies, 1% of the videos removed, then a
           black frame in 2000 of them: (a) -similar over every video (the
           all-pairs self-search, K3 + K4), (b) -similar-to an unstored
           16384-frame needle video (K1-mma at Q=16384, K4, the dense
           fallback), (c) 1024 image needles, (d) 16 stored needles whose
           trim diverges (the flat count gate); each run's walls, launches
           and idle share, the counts against the popcount K1, and in
           (b)-(d) the needles that took the dense fallback: exactly the
           black frames (the needles past k_cap)
  vcli     24 synthetic .fseq videos x 4 variants (source, trimmed,
           brightness-shifted, half size): cbird-torch -create -update
           -p.alg video -similar -json, then -similar-to a copy and a frame
  cli      60 base images x 4 variants as files: cbird-torch -create
           -update -similar -json, then -similar-to

The main path is query, self, ph, video, vcli and cli: the launch
counters are zeroed just before each of them and read just after; every
kernel must have run there, but for the bf16 form of K1-mma, which only
the kernels phase launches.  Launches made only to check a result (the ph
and video phases' count checks) are left out of the counts.  The line before the last is a JSON
object with each kernel's numbers, the last is {"ok": true, "device":
{...}}.  Any failure exits non-zero without it.  Exits non-zero at once
when no CUDA device is visible.

Bounds (bound_ms): the larger of the bytes a call must move over 3.35
TB/s and the operations this run's data needs over the peak rate of
their type on 132 SMs at the SM clock: 16 POPC, 64 compares or logic
instructions (the ALU pipe) and 128 INT32 instructions in all (adds also
issue as IMAD on the FMA pipe) per clock per SM; and for the tensor-core
count, 1979 TOPS int8 and 989 TFLOPS bf16 (dense).  The SM clock is the
higher of nvidia-smi's clocks.max.sm and what chip_bounds.py's probe
reads in the kernels phase: clock64 cycles over globaltimer ns, the
timer CUDA events read (up to ~1995 MHz where nvidia-smi says 1980).
python3 chip_bounds.py checks these rates and the clock on the card.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import gc
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
# INT32 per clock per SM: compares and logic issue only on the ALU pipe;
# adds also as IMAD on the FMA pipe, so all INT32 together reach twice
# that (chip_bounds.py's compare-and-add probe)
ALU_PER_CLK, INT32_PER_CLK = 64, 128
TC_INT8_OPS_PER_S = 1979e12
TC_BF16_OPS_PER_S = 989e12
KERNELS = ("count_below", "count_below_mma", "hamming_topk", "band_count")
# K1-mma: checked thresholds; timed shapes (Q, N, t): the K1 variants'
# experiments (epilogue and i16 at t=5, the bf16 sweep at t=6), K1's row
MMA_T = (0, 1, 5, 8, 32, 33, 63)
MMA_SHAPES = ((16384, 1 << 21, 5), (16384, 1 << 21, 6), (1024, 1 << 20, 5))
# the video phase's collection and its plants
VIDEOS, FRAMES, FRAME_STEP = 4096, 512, 12
COPIES, COPY_LEN = 64, 200
BLACK_VIDEOS, BLACK_AT = 2000, (100, 200, 300, 400)
NEEDLE_TRIMMED, NEEDLE_SOURCES, NEEDLE_SEG, NEEDLE_BLACK = 16384, 24, 300, 16
# kernels only the kernels phase launches
OFF_PATH = ("K1-mma-bf16",)
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
# chip_bounds.py's probe library (the SM clock for the bounds)
PROBE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "probes")


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
        # the bounds' SM clock: clocks.max.sm, raised to the highest clock
        # sm_clock reads in the kernels phase
        self.clock_hz = smi_mhz("clocks.max.sm") * 1e6
        self.clock64_mhz: list[float] = []
        self.probe_so, self.probes = None, None
        self.bound_sites: list = []  # bounds set by finish_bounds
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import count_below_mma as cm
        from cbird_tpu_torch.ops import hamming_topk as tk
        # kernel -> (wrapper, attribute of its launch counter)
        self.counters = {"K1": (cb.count_below, "launches"),
                         "K2": (cb.count_below, "masked_launches"),
                         "K1-mma": (cm.count_below_mma, "launches"),
                         "K1-mma-bf16": (cm.count_below_mma, "bf16_launches"),
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
        """Mean CUDA-event ms of ``reps`` calls after a warm-up.  One
        ``gc.collect()`` before them settles the collector's debt of
        earlier phases, which would otherwise fall on whichever call is
        timed when it comes due; the collector stays on while they run,
        so a wrapper's own garbage is paid for."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        gc.collect()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def bound(self, target: dict, key: str, by: str | None = None, *,
              nbytes: float, popc: float = 0, alu: float = 0,
              int_ops: float = 0, tc_ops: float = 0,
              tc_rate: float = TC_INT8_OPS_PER_S):
        """Sets ``target[key]`` to the least time (ms) the card could take
        to move ``nbytes`` and execute ``popc`` POPC, ``int_ops`` INT32
        instructions of which ``alu`` are compares or logic (the ALU pipe
        only) and ``tc_ops`` tensor-core operations at ``tc_rate``, and
        ``target[by]`` to which of the two bounds it.  finish_bounds sets
        it, at the highest SM clock the kernels phase read."""
        self.bound_sites.append((target, key, by, dict(
            nbytes=nbytes, popc=popc, alu=alu, int_ops=int_ops,
            tc_ops=tc_ops, tc_rate=tc_rate)))

    def finish_bounds(self):
        clk = self.clock_hz * SMS
        for target, key, by, w in self.bound_sites:
            by_ops = max(w["popc"] / (POPC_PER_CLK * clk),
                         w["alu"] / (ALU_PER_CLK * clk),
                         w["int_ops"] / (INT32_PER_CLK * clk),
                         w["tc_ops"] / w["tc_rate"])
            by_bytes = w["nbytes"] / HBM_BYTES_PER_S
            target[key] = max(by_ops, by_bytes) * 1e3
            if by:
                target[by] = "operations" if by_ops >= by_bytes else "bytes"
        self.bound_sites.clear()

    def sm_clock(self) -> float:
        """The SM clock now, from chip_bounds.py's probe: clock64 cycles
        over globaltimer ns, the timer CUDA events read (it can exceed
        nvidia-smi's clocks.max.sm).  The bounds use the highest read.
        @return MHz"""
        if self.probes is None:
            import chip_bounds
            self.probes = chip_bounds.Probes(self.torch, self.probe_so)
        mhz = self.probes.sm_clock_mhz()
        self.clock64_mhz.append(mhz)
        self.clock_hz = max(self.clock_hz, mhz * 1e6)
        return mhz

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
        """The kernels and chip_bounds.py's clock probe, one nvcc each, all
        at once."""
        import chip_bounds
        from cbird_tpu_torch import _build
        t0 = time.perf_counter()

        def one(name):
            if name == "probes":
                self.probe_so = chip_bounds.build_probes(PROBE_DIR)
            else:
                _build.build(name)
            return round(time.perf_counter() - t0, 3)
        names = KERNELS + ("probes",)
        with cf.ThreadPoolExecutor(len(names)) as ex:
            done = dict(zip(names, ex.map(one, names)))
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
        same = self.same
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
        # K4's checks: the timed needles with needle 0 in the 400-row
        # cluster (401 hits at < 5: past its slots for k <= 64); every
        # needle passes its slots at bound 65, few at bound 5
        chk = needles.clone()
        chk[0] = hay[1000]
        second = {}
        for k in (1, 16, 64, 1024):
            for bound in (65, T):
                n2 = tk.hamming_topk.overflowed
                d, i = tk.hamming_topk(chk, hay, valid, k, bound)
                torch.cuda.synchronize()
                second[f"k{k}_bound{bound}"] = tk.hamming_topk.overflowed - n2
                dp, ip = tk.hamming_topk_plain(chk, hay, valid, k, bound)
                err["K4"] = max(err["K4"], same(d, dp), same(i, ip))
        out["K4_second_pass_needles"] = second
        out["K4_one_pass_needles"] = {c: chk.numel() - v
                                      for c, v in second.items()}
        if not (sum(second.values()) and sum(out["K4_one_pass_needles"]
                                             .values())):
            raise AssertionError("K4's checks did not run both its paths")

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
        def topk_work(q, n, k):
            # one distance a pair: reads, [Q, k] dists and rows written
            return dict(nbytes=9 * n + 8 * q + 8 * q * k, popc=2 * q * n)
        work = {  # bytes moved, POPC executed (two per 64-bit pair)
            "K1": dict(nbytes=9 * n + 12 * q, popc=2 * q * n),
            "K2": dict(nbytes=9 * cols + 12 * rows, popc=2 * k2_pairs),
            "K4": topk_work(q, n, 64),
        }
        self.sm_clock()  # the bounds' clock, read after the checks' warm-up
        # yardstick of a tensor-core form (not the same function): the
        # +-1 int8 product of the same needles and haystack
        pm = (torch.randint(0, 2, (q, 64), device=self.dev) * 2 - 1).to(
            torch.int8)
        hm = (torch.randint(0, 2, (64, n), device=self.dev) * 2 - 1).to(
            torch.int8)
        int_mm_ms = self.event_ms(lambda: torch._int_mm(pm, hm), 5)
        del pm, hm
        out.update(self.k4_shapes(hay, valid, needles, topk_work, err))
        for name, (kern, plain) in timings.items():
            ms = self.event_ms(kern, 20)
            plain_ms = self.event_ms(plain, 3)
            self.kernels[name].update(
                max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                library_ms=None)
            self.bound(self.kernels[name], "bound_ms", "bound_by",
                       **work[name])
            if name != "K4":
                self.kernels[name]["int_mm_yardstick_ms"] = int_mm_ms
            out[f"{name}_ms"] = round(ms, 4)
            out[f"{name}_plain_ms"] = round(plain_ms, 4)
            self.bound(out, f"{name}_bound_ms", **work[name])
        out["int_mm_1024x64x2^20_ms"] = round(int_mm_ms, 4)
        out["shapes"] = ("K1 Q=1024 N=2^20 t=5; K2 16384x65536 diagonal; "
                         "K4 Q=1024 N=2^20 k=64 bound=5")
        out.update(self.k3_kernels())
        out.update(self.mma_kernels())
        self.sm_clock()
        self.finish_bounds()
        out["sm_clock64_mhz"] = self.clock64_mhz
        out["bound_clock_mhz"] = self.clock_hz / 1e6
        return out

    def k4_shapes(self, hay, valid, needles, topk_work, err):
        """K4 where the main path runs it, each shape against its bound and
        the bound of a tensor-core form (the int8 product K1-mma's row
        counts, so that no such form can read above 100%): the wrapper
        (both passes, the cursor read, the sort) and one first-pass scan
        launch alone.  Shapes: the timed row's, Q=1 and Q=64 over a 10M-row
        store at k=64 (the query phase), Q=1024 at k=4096 over 2^21 rows
        (video (a)); bound 5.  At each shape the wrapper's distances and
        rows of the first 64 needles are held against the plain twin's
        (``err["K4"]``)."""
        torch = self.torch
        from cbird_tpu_torch.ops import hamming_topk as tk
        rng = np.random.default_rng(SEED + 9)
        big = torch.from_numpy(rng.integers(
            0, 2**64, size=10_000_000, dtype=np.uint64).view(np.int64)).to(
                self.dev)
        big_valid = torch.from_numpy(rng.random(big.numel()) > 0.01).to(
            self.dev)
        pick = torch.from_numpy(rng.integers(0, 1 << 21, 1024)).to(self.dev)
        shapes = {  # name -> (needles, haystack, valid, k)
            "Q=1024 N=2^20 k=64": (needles, hay, valid, 64),
            "Q=1 N=10M k=64": (big[pick[:1]] ^ 5, big, big_valid, 64),
            "Q=64 N=10M k=64": (big[pick[:64]] ^ 5, big, big_valid, 64),
            "Q=1024 N=2^21 k=4096": (big[pick] ^ 5, big[:1 << 21],
                                     big_valid[:1 << 21], 4096)}
        ms_at = {}
        for name, (nd, h, v, k) in shapes.items():
            d, i = tk.hamming_topk(nd, h, v, k, T)
            dp, ip = tk.hamming_topk_plain(nd[:64], h, v, k, T)
            torch.cuda.synchronize()
            err["K4"] = max(err["K4"], self.same(d[:64], dp, f"K4 {name}"),
                            self.same(i[:64], ip, f"K4 {name}"))
            n2 = tk.hamming_topk.overflowed
            row = ms_at[name] = {
                "ms": self.event_ms(lambda: tk.hamming_topk(nd, h, v, k, T),
                                    20),
                "scan_ms": self.event_ms(self.topk_scan(nd, h, v, k, T), 20),
                "second_pass_needles_per_call":
                    (tk.hamming_topk.overflowed - n2) / 21}
            q, n = nd.numel(), h.numel()
            self.bound(row, "bound_ms", **topk_work(q, n, k))
            self.bound(row, "tc_bound_ms", **self.mma_work(
                q, n, TC_INT8_OPS_PER_S))
        self.kernels["K4"]["ms_at"] = ms_at
        self.kernels["K4"]["kernel_ms"] = ms_at["Q=1024 N=2^20 k=64"][
            "scan_ms"]
        self.bound(self.kernels["K4"], "tc_bound_ms",
                   **self.mma_work(needles.numel(), hay.numel(),
                                   TC_INT8_OPS_PER_S))
        return {"K4_ms_at": ms_at}

    def topk_scan(self, nd, h, v, k: int, bound: int):
        """One first-pass call of K4's scan (it zeroes its counts and
        empties its slots, then scans; no sort, no second pass), as a
        callable for event_ms."""
        torch = self.torch
        from cbird_tpu_torch import _build
        from cbird_tpu_torch.ops import hamming_topk as tk
        lib = tk._load()
        q, n = nd.numel(), h.numel()
        c = tk.capacity(k, n)
        hist = torch.empty((q, tk.BINS), dtype=torch.int32, device=self.dev)
        cursor = torch.empty(q, dtype=torch.int32, device=self.dev)
        keys = torch.empty(q * c, dtype=torch.int64, device=self.dev)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            _build.check(lib, lib.cbird_topk_scan(
                nd.data_ptr(), None, q, h.data_ptr(), v.data_ptr(), n, bound,
                hist.data_ptr(), None, c, cursor.data_ptr(), keys.data_ptr(),
                stream), "topk_scan")
        return launch

    @staticmethod
    def mma_work(q, n, rate):
        """The tensor-core count's work: 128 tensor operations a pair, the
        epilogue's compare (ALU pipe) and add (either pipe), 8 + 1 bytes a
        row and 8 + 4 a needle."""
        return dict(nbytes=9 * n + 12 * q, alu=q * n, int_ops=2 * q * n,
                    tc_ops=128 * q * n, tc_rate=rate)

    @staticmethod
    def same(a, b, what: str = "kernel") -> float:
        """@return the largest absolute difference of ``a`` and ``b``;
        raises unless it is 0."""
        if a.shape != b.shape:
            raise AssertionError(f"{what}: shape {tuple(a.shape)} against "
                                 f"{tuple(b.shape)}")
        err = float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
        if err:
            raise AssertionError(f"{what} disagrees with its reference "
                                 f"(max abs err {err})")
        return err

    @staticmethod
    def flip_bits(h: np.ndarray, bits: np.ndarray, rng) -> np.ndarray:
        """``h`` with ``bits[i]`` distinct random bits of row i flipped."""
        keys = rng.random((len(h), 64)).argsort(axis=1)
        mask = np.zeros(len(h), np.uint64)
        for b in range(int(bits.max(initial=0))):
            on = bits > b
            mask[on] |= np.uint64(1) << keys[on, b].astype(np.uint64)
        return h ^ mask

    def mma_kernels(self):
        """K1-mma, both forms, bit for bit against the plain twin (on a
        needle subset) and the popcount K1 (every needle): t in MMA_T, a
        ragged Q and N, 1% tombstones, an all-invalid column range, needles
        planted at distance t - 1 and t; then both forms and the popcount
        K1 timed at MMA_SHAPES."""
        torch = self.torch
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import count_below_mma as cm
        rng = np.random.default_rng(SEED + 7)
        n, q = (1 << 21) - 37, 16381
        h64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        valid = rng.random(n) > 0.01
        valid[1 << 20:(1 << 20) + 8192] = False  # whole column steps
        rows = rng.integers(0, n, q)
        # distances spread over 0..64: ~64 / 2^k bits, k = 1..8
        needles = self.flip_bits(h64[rows], np.minimum(
            64, rng.geometric(0.25, q) ** 2 // 2), rng)
        live = np.nonzero(valid)[0]
        plant = np.array([b for t in MMA_T for b in (t - 1, t) if b >= 0])
        needles[:len(plant)] = self.flip_bits(h64[live[:len(plant)]], plant,
                                              rng)
        hay = torch.from_numpy(h64.view(np.int64)).to(self.dev)
        vd = torch.from_numpy(valid).to(self.dev)
        nd = torch.from_numpy(needles.view(np.int64)).to(self.dev)
        sub = torch.from_numpy(np.r_[np.arange(len(plant)), rng.choice(
            np.arange(len(plant), q), 512, replace=False)]).to(self.dev)
        err = {"K1-mma": 0.0, "K1-mma-bf16": 0.0}
        hits = {}
        for t in MMA_T:
            pop = cb.count_below(nd, hay, vd, t)
            plain = cm.count_below_mma_plain(nd[sub], hay, vd, t)
            for key, bf16 in (("K1-mma", False), ("K1-mma-bf16", True)):
                got = cm.count_below_mma(nd, hay, vd, t, bf16=bf16)
                torch.cuda.synchronize()
                err[key] = max(err[key],
                               self.same(got, pop, f"{key} t={t}"),
                               self.same(got[sub], plain, f"{key} t={t}"))
            hits[f"t{t}"] = int(pop.sum())
        out = {"mma_checked": f"Q={q} N={n} t={list(MMA_T)}",
               "mma_hits": hits}
        del hay, vd, nd
        # timing operands: 2^21 rows, 1% tombstones, needles near stored rows
        n_max = max(s[1] for s in MMA_SHAPES)
        h64 = rng.integers(0, 2**64, size=n_max, dtype=np.uint64)
        hay = torch.from_numpy(h64.view(np.int64)).to(self.dev)
        vd = torch.from_numpy(rng.random(n_max) > 0.01).to(self.dev)
        nd = torch.from_numpy(self.flip_bits(
            h64[rng.integers(0, n_max, 16384)],
            rng.integers(0, 8, 16384), rng).view(np.int64)).to(self.dev)
        times = {}
        for qq, nn, t in MMA_SHAPES:
            args = (nd[:qq], hay[:nn], vd[:nn], t)
            times[(qq, nn, t)] = {
                "int8": self.event_ms(lambda: cm.count_below_mma(*args), 20),
                "bf16": self.event_ms(lambda: cm.count_below_mma(
                    *args, bf16=True), 20),
                "popcount": self.event_ms(lambda: cb.count_below(*args), 20)}
            out[f"q{qq}_n{nn}_t{t}_ms"] = {k: round(v, 4) for k, v in
                                           times[(qq, nn, t)].items()}
        qq, nn, t = MMA_SHAPES[0]
        args = (nd[:qq], hay[:nn], vd[:nn], t)
        plain_ms = self.event_ms(lambda: cm.count_below_mma_plain(*args), 3)
        self.sm_clock()

        # bounds: mma_work; the popcount form's: 2 POPC a pair
        mma_work = self.mma_work
        for key, form, rate in (("K1-mma", "int8", TC_INT8_OPS_PER_S),
                                ("K1-mma-bf16", "bf16", TC_BF16_OPS_PER_S)):
            ms_at = {}
            for a, b, c in MMA_SHAPES:
                row = ms_at[f"Q={a} N={b} t={c}"] = {
                    "ms": times[(a, b, c)][form],
                    "popcount_K1_ms": times[(a, b, c)]["popcount"]}
                self.bound(row, "bound_ms", **mma_work(a, b, rate))
                self.bound(row, "popcount_K1_bound_ms", nbytes=9 * b + 12 * a,
                           popc=2 * a * b)
            self.kernels[key].update(
                max_abs_err=err[key], ms=times[MMA_SHAPES[0]][form],
                plain_ms=plain_ms, library_ms=None, ms_at=ms_at)
            self.bound(self.kernels[key], "bound_ms", "bound_by",
                       **mma_work(qq, nn, rate))
            self.bound(out, f"{key}_bound_ms", **mma_work(qq, nn, rate))
        out["K1-mma_plain_ms"] = round(plain_ms, 4)
        out["K1-mma_pairs_per_s"] = qq * nn / (times[MMA_SHAPES[0]]["int8"]
                                              * 1e-3)
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
        # INT32 (two xors, the add, the compare; all but the add on the
        # ALU pipe) per equal-key pair
        run_rows = 2 * s * len(tiles)
        self.sm_clock()
        timings = {
            "K3": (lambda: bc.band_counts(*ops, masks, T, s),
                   lambda: bc.band_counts_plain(*ops, masks, T, s),
                   dict(nbytes=17 * n_tot, popc=2 * cands,
                        alu=3 * cands + 4 * n_tot,
                        int_ops=4 * cands + 4 * n_tot)),
            "K3-run": (lambda: bc.run_tiles(csort, *ops, tiles, masks, T, s),
                       lambda: bc.run_tiles_plain(csort, *ops, tiles, masks,
                                                  T, s),
                       dict(nbytes=17 * run_rows, popc=2 * rcands,
                            alu=3 * rcands + 4 * run_rows,
                            int_ops=4 * rcands + 4 * run_rows)),
        }
        for name, (kern, plain, work) in timings.items():
            ms = self.event_ms(kern, 20)
            plain_ms = self.event_ms(plain, 3)
            self.kernels[name].update(
                max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                library_ms=None)
            self.bound(self.kernels[name], "bound_ms", "bound_by", **work)
            out[f"{name}_ms"] = round(ms, 4)
            out[f"{name}_plain_ms"] = round(plain_ms, 4)
            self.bound(out, f"{name}_bound_ms", **work)
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

    # ---- video ------------------------------------------------------------
    def video_data(self, rng):
        """The video phase's collection: VIDEOS x FRAMES random frame hashes
        (frame numbers 0, 12, 24, ...), COPIES planted copies (a COPY_LEN
        frame range of a source with 0-2 bits flipped a frame), 1% of the
        videos to remove, BLACK_VIDEOS videos that get one black-frame hash
        at BLACK_AT, and untouched videos for the needles."""
        h = rng.integers(1, 2**64, size=(VIDEOS, FRAMES), dtype=np.uint64)
        order = rng.permutation(VIDEOS)
        cut = np.cumsum([COPIES, COPIES, BLACK_VIDEOS, VIDEOS // 100])
        src, dst, black, removed, free = np.split(order, cut)
        copies = []
        for s, c in zip(src, dst):
            # inside both videos' trim windows (skipFrames 300 = 25 frames)
            q0, p0 = rng.integers(30, FRAMES - 30 - COPY_LEN, 2)
            h[c, p0:p0 + COPY_LEN] = self.flip_bits(
                h[s, q0:q0 + COPY_LEN], rng.integers(0, 3, COPY_LEN), rng)
            copies.append((int(s), int(c), int(p0), int(q0)))
        return {"hashes": h, "copies": copies, "black": black,
                "removed": removed, "free": free,
                "black_hash": rng.integers(1, 2**64, dtype=np.uint64),
                "frames": np.arange(FRAMES, dtype=np.int32) * FRAME_STEP}

    def video_index(self, data, black: bool):
        """A DctVideoIndex of ``data`` built with add_video (media id =
        video + 1), the removed videos removed; ``black``: with the black
        frames planted."""
        from cbird_tpu_torch.index.dct_video_index import DctVideoIndex
        h = data["hashes"]
        if black:
            h = h.copy()
            h[data["black"][:, None], np.array(BLACK_AT)] = data["black_hash"]
        idx = DctVideoIndex(self.dev)
        idx._loaded = True
        for v in range(VIDEOS):
            idx._store.add_video(v + 1, data["frames"], h[v])
        idx._store.remove(data["removed"] + 1)
        idx._store._device()
        return idx, h

    def run_counted(self, fn):
        """fn through the main path, timed twice (first call, warm) and
        once more under the profiler.
        @return (result, numbers: walls, launches of the first call, the
        warm call's device busy ms and idle share)"""
        before = self.launches()
        wall, res = self.timed(fn)
        got = self.launches()
        warm, _ = self.timed(fn)
        busy, pwall = self.device_busy(fn)
        nums = {"first_wall_ms": round(wall, 1), "warm_wall_ms": round(warm, 1),
                "launches": {k: got[k] - before[k] for k in
                             ("K1-mma", "K3", "K4", "K1")},
                "profiled_wall_ms": round(pwall, 1)}
        if busy is None:
            nums["idle_share"] = "not measured"
        else:
            nums["device_busy_ms"] = round(busy, 2)
            nums["idle_share"] = round(1 - busy / pwall, 4)
        return res, nums

    @staticmethod
    @contextlib.contextmanager
    def dense_needles(idx):
        """While inside, the needle hashes that each call of the dense
        fallback (``PackedVideoStore.search``) receives, one array a call."""
        store = idx._store
        calls = []

        def search(hashes, *args, **kw):
            calls.append(np.array(hashes, np.uint64))
            return type(store).search(store, hashes, *args, **kw)
        store.search = search
        try:
            yield calls
        finally:
            del store.search

    @staticmethod
    def check_dense(calls, needles, black_hash, what: str, runs: int = 3):
        """Each of run_counted's ``runs`` calls sent exactly the black
        frames among ``needles`` (the needles past k_cap) to the dense
        fallback, and nothing else.
        @return the number of dense needles a call"""
        want = int(np.count_nonzero(needles == black_hash))
        if len(calls) != (runs if want else 0) or any(
                len(c) != want or (c != black_hash).any() for c in calls):
            raise AssertionError(
                f"({what}) dense fallback took {[len(c) for c in calls]} "
                f"needles a call, {want} black frames expected")
        return want

    def device_busy(self, fn):
        """@return (device ms of fn's kernels, copies and sets, or None when
        the profiler saw none; the wall of that call)"""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall, _ = self.timed(fn)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU) / 1e3
        return (busy if busy > 0 else None), wall

    def check_counts(self, idx, needles: np.ndarray, sample: int, rng):
        """The count gate's counts on every needle against the popcount K1,
        and on ``sample`` needles against the plain twin (uncounted)."""
        torch = self.torch
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import count_below_mma as cm
        with self.uncounted():
            store = idx._store
            got = store.flat_hit_counts(needles, T)
            hd, _, _, vd = store._device()
            nd = store._needles(needles)
            pop = torch.cat([cb.count_below(nd[s:s + 16384], hd, vd, T)
                             for s in range(0, len(needles), 16384)])
            sub = rng.choice(len(needles), min(sample, len(needles)),
                             replace=False)
            plain = cm.count_below_mma_plain(
                nd[torch.from_numpy(sub).to(self.dev)], hd, vd, T)
            if not (np.array_equal(got, pop.cpu().numpy())
                    and np.array_equal(got[sub], plain.cpu().numpy())):
                raise AssertionError("video gate counts differ")
        return int(got.sum())

    @staticmethod
    def video_media(v: int, hashes, frames):
        """Video ``v`` (media id v + 1) with its frame index in memory."""
        from cbird_tpu_torch.params import TYPE_VIDEO
        from cbird_tpu_torch.store.media import Media, VideoIndexData
        m = Media(f"/videos/{v}.mp4", TYPE_VIDEO, 128, 96, f"md5-{v}")
        m.id = v + 1
        m.videoIndex = VideoIndexData(frames=frames, hashes=hashes)
        return m

    def video_live(self, data, h):
        """Every live video as a needle, its index equal to the stored one.
        @return (needles, {video: needle position})"""
        removed = set(data["removed"].tolist())
        live = [v for v in range(VIDEOS) if v not in removed]
        return ([self.video_media(v, h[v], data["frames"]) for v in live],
                {v: i for i, v in enumerate(live)})

    def video_needle(self, data, h, rng):
        """An unstored needle video of NEEDLE_TRIMMED trimmed frames:
        NEEDLE_SOURCES segments of untouched stored videos with 0-2 bit
        flips, NEEDLE_BLACK black frames, random frames between.
        @return (needle, its trimmed hashes, the expected (id, srcIn,
        dstIn, len) of each match)"""
        m_total = NEEDLE_TRIMMED + 50  # 25 frames trimmed at each end
        nh = rng.integers(1, 2**64, size=m_total, dtype=np.uint64)
        want = set()
        for k, s in enumerate(data["free"][:NEEDLE_SOURCES]):
            p0 = 30 + k * (NEEDLE_TRIMMED // NEEDLE_SOURCES)
            q0 = int(rng.integers(30, FRAMES - 30 - NEEDLE_SEG))
            nh[p0:p0 + NEEDLE_SEG] = self.flip_bits(
                h[s, q0:q0 + NEEDLE_SEG], rng.integers(0, 3, NEEDLE_SEG), rng)
            want.add((int(s) + 1, FRAME_STEP * p0, FRAME_STEP * q0,
                      FRAME_STEP * (NEEDLE_SEG - 1)))
            if k < NEEDLE_BLACK:
                nh[p0 + NEEDLE_SEG + 10] = data["black_hash"]
        needle = self.video_media(
            -1, nh, np.arange(m_total, dtype=np.int32) * FRAME_STEP)
        return needle, nh[25:-25], want

    def video_phase(self):
        torch = self.torch
        from cbird_tpu_torch.params import SearchParams, TYPE_IMAGE
        from cbird_tpu_torch.store.media import Media
        rng = np.random.default_rng(SEED + 8)
        data = self.video_data(rng)
        sp = SearchParams()  # defaults: dht 5, vtrim 300, vfm 30, vfn 60
        span = FRAME_STEP * (COPY_LEN - 1)
        out = {"videos": VIDEOS, "frame_rows": VIDEOS * FRAMES}

        def ranges(matches):
            return {(m.mediaId, m.range.srcIn, m.range.dstIn, m.range.len)
                    for m in matches}

        # (a) -similar: every live video, stored and unchanged: the
        # all-pairs self-search.  Before the black frames: a frame row with
        # more than k = 4096 hits would send it down the gate path
        idx, h = self.video_index(data, black=False)
        needles, row = self.video_live(data, h)
        res, out["a"] = self.run_counted(lambda: idx.find_batch(needles, sp))
        for s, c, p0, q0 in data["copies"]:
            if (s + 1, FRAME_STEP * p0, FRAME_STEP * q0, span) not in \
                    ranges(res[row[c]]) or \
                    (c + 1, FRAME_STEP * q0, FRAME_STEP * p0, span) not in \
                    ranges(res[row[s]]):
                raise AssertionError(f"(a) planted copy {s}->{c} missed")
        if out["a"]["launches"]["K3"] == 0 or out["a"]["launches"]["K4"] == 0:
            raise AssertionError("(a) did not take the all-pairs self-search")
        out["a"]["videos_with_matches"] = sum(1 for r in res if r)
        del idx, needles, res
        torch.cuda.empty_cache()

        idx, h = self.video_index(data, black=True)
        # (b) an unstored needle video: the flat count gate at Q=16384;
        # each black frame is past k_cap, so the dense fallback runs
        needle, nh, want = self.video_needle(data, h, rng)
        with self.dense_needles(idx) as dense:
            res, out["b"] = self.run_counted(lambda: idx.find(needle, sp))
        if ranges(res) != want:
            raise AssertionError(f"(b) matches {sorted(ranges(res))[:4]} "
                                 f"differ from the planted segments")
        out["b"]["needle_frames"] = NEEDLE_TRIMMED
        out["b"]["dense_needles"] = self.check_dense(
            dense, nh, data["black_hash"], "b")
        out["b"]["gate_hits"] = self.check_counts(idx, nh, 256, rng)

        # (c) 1024 image needles: 600 frames of untouched videos with 0-2
        # bits flipped, 24 black frames, 400 random hashes
        vs = rng.choice(data["free"][NEEDLE_SOURCES:], 600)
        fs = rng.integers(0, FRAMES, 600)
        ih = np.r_[self.flip_bits(h[vs, fs], rng.integers(0, 3, 600), rng),
                   np.full(24, data["black_hash"]),
                   rng.integers(1, 2**64, size=400, dtype=np.uint64)]
        imgs = [Media(f"/images/{i}.png", TYPE_IMAGE, 64, 64, f"i{i}",
                      int(x)) for i, x in enumerate(ih)]
        with self.dense_needles(idx) as dense:
            res, out["c"] = self.run_counted(lambda: idx.find_batch(imgs, sp))
        out["c"]["dense_needles"] = self.check_dense(
            dense, ih, data["black_hash"], "c")
        for i, (v, f) in enumerate(zip(vs, fs)):
            d = int(np.bitwise_count(ih[i] ^ h[v, f]))
            if (v + 1, d, FRAME_STEP * f) not in {
                    (m.mediaId, m.score, m.range.dstIn) for m in res[i]}:
                raise AssertionError(f"(c) image needle {i} missed its frame")
        if any(len(res[600 + i]) != BLACK_VIDEOS for i in range(24)) or \
                any(res[624:]):
            raise AssertionError("(c) black or random needles: wrong matches")
        out["c"]["gate_hits"] = self.check_counts(idx, ih, 256, rng)

        # (d) 16 stored needles (8 copy targets, 8 untouched) whose in-memory
        # index diverges from the stored one inside the trim window: the
        # all-pairs path declines and the flat count gate runs
        picks = []
        for s, c, p0, q0 in data["copies"][:8]:
            picks.append((c, p0 - 5, (s + 1, FRAME_STEP * p0, FRAME_STEP * q0,
                                      span)))
        for v in data["free"][-8:]:
            picks.append((int(v), FRAMES // 2, None))
        needles = []
        for v, at, _ in picks:
            hv = h[v].copy()
            hv[at] ^= np.uint64(0xFF)
            needles.append(self.video_media(v, hv, data["frames"]))
        with self.dense_needles(idx) as dense:
            res, out["d"] = self.run_counted(lambda: idx.find_batch(needles,
                                                                    sp))
        out["d"]["dense_needles"] = self.check_dense(
            dense, np.concatenate([m.videoIndex.hashes for m in needles]),
            data["black_hash"], "d")
        for (v, _, exp), got in zip(picks, res):
            if (exp is None and got) or (exp is not None and
                                         ranges(got) != {exp}):
                raise AssertionError(f"(d) needle video {v}: {ranges(got)}")
        for k in ("b", "c", "d"):
            if out[k]["launches"]["K1-mma"] == 0:
                raise AssertionError(f"({k}) K1-mma did not run")
        return out

    def synth_videos(self, count: int, frames: int, h: int = 96, w: int = 128,
                     seed: int = SEED):
        """Moving content made in bulk on the card from a seed: each source
        pans slowly over its own coarse random field (12 x 16 cells, bicubic,
        twice the frame) under a moving blob, so no two sources share a
        frame hash and consecutive frames change gradually.
        @return [count, frames, h, w] uint8 numpy"""
        torch = self.torch
        import torch.nn.functional as F
        g = torch.Generator(device=self.dev).manual_seed(seed)
        u = lambda *shape: torch.rand(*shape, generator=g, device=self.dev)
        field = torch.randn(count, 1, 12, 16, generator=g, device=self.dev)
        big = F.interpolate(field, size=(2 * h, 2 * w), mode="bicubic",
                            align_corners=False)[:, 0]
        t = torch.arange(frames, device=self.dev, dtype=torch.float32)
        off_y = (t[None] * (0.1 + 0.15 * u(count, 1))).long().clamp(max=h - 1)
        off_x = (t[None] * (0.1 + 0.15 * u(count, 1))).long().clamp(max=w - 1)
        iy = off_y[:, :, None, None] + torch.arange(h, device=self.dev)[:, None]
        ix = off_x[:, :, None, None] + torch.arange(w, device=self.dev)[None, :]
        img = 128 + 45 * big[torch.arange(count, device=self.dev)[:, None, None,
                                                                  None], iy, ix]
        yy = torch.arange(h, device=self.dev, dtype=torch.float32)[:, None]
        xx = torch.arange(w, device=self.dev, dtype=torch.float32)[None, :]
        a = 7 * u(count, 1, 1, 1) + 0.21 * t[None, :, None, None]
        cy = h / 2 + (h / 3) * torch.sin(a * (0.6 + 0.6 * u(count, 1, 1, 1)))
        cx = w / 2 + (w / 3) * torch.cos(a * (0.6 + 0.8 * u(count, 1, 1, 1)))
        img = img + 60 * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 338.0)
        return img.clamp(0, 255).to(torch.uint8).cpu().numpy()

    def video_cli_phase(self):
        torch = self.torch
        from PIL import Image
        from cbird_tpu_torch.cli.main import main
        from cbird_tpu_torch.host import video as hv
        from cbird_tpu_torch.ops import count_below_mma as cm
        from cbird_tpu_torch.ops.dct_hash import DctHasher
        sources = self.synth_videos(24, 400)
        args = ["-p.alg", "video", "-p.vtrim", "5", "-p.vfm", "10",
                "-p.vfn", "40"]
        out = {}
        # GPU-vs-CPU frame hash flips (they move window compression)
        gpu = DctHasher(canvas_hw=(hv.DECODE_MAX_SIDE,) * 2, batch=256,
                        device=self.dev)
        cpu = DctHasher(canvas_hw=(hv.DECODE_MAX_SIDE,) * 2, batch=256,
                        device="cpu")
        sample = list(sources[:2].reshape(-1, 96, 128))
        on_gpu = gpu.hash_images(sample, do_crop=True)
        flips = np.bitwise_count(on_gpu ^ cpu.hash_images(sample, do_crop=True))
        out["frames_compared"] = len(sample)
        out["frames_with_flip"] = int(np.count_nonzero(flips))
        out["max_flip_bits"] = int(flips.max())
        # the window compression's pure-Python loop on one 400-frame run
        t0 = time.perf_counter()
        kept = hv.compress_hash_run(on_gpu[:400], 8)[0]
        out["compress_400_frames_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 2)
        out["compress_kept"] = len(kept)
        with tempfile.TemporaryDirectory() as d:
            owner, total = {}, 0
            for s, v in enumerate(sources):
                variants = {
                    "src": v, "trim": v[60:340],
                    "bright": np.clip(v.astype(np.int16) + 25, 0, 255)
                    .astype(np.uint8),
                    "half": v.reshape(len(v), 48, 2, 64, 2).mean((2, 4))
                    .astype(np.uint8)}
                for name, fr in variants.items():
                    path = os.path.join(d, f"s{s:02d}_{name}.fseq")
                    with open(path, "wb") as f:  # an uncompressed .fseq
                        np.savez(f, frames=fr, fps=np.float64(25.0))
                    owner[path] = s
                    total += len(fr)
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(["-use", d, "-create", "-update", *args])
            ingest = time.perf_counter() - t0
            if rc:
                raise AssertionError(f"-update rc {rc}")
            out.update(videos=len(owner), frames=total,
                       ingest_s=round(ingest, 3),
                       frames_hashed_per_s=round(total / ingest, 1))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(["-use", d, *args, "-similar", "-json"])
            if rc:
                raise AssertionError(f"-similar rc {rc}")
            groups = [[m["path"] for m in [g["needle"]] + g["matches"]]
                      for g in json.loads(buf.getvalue())]
            parent = {p: p for p in owner}

            def find(p):
                while parent[p] != p:
                    p = parent[p]
                return p
            for g in groups:
                if len({owner[p] for p in g}) != 1:
                    raise AssertionError(f"a group mixes sources: {g}")
                for p in g[1:]:
                    parent[find(p)] = find(g[0])
            joined = sum(len({find(p) for p in owner if owner[p] == s}) == 1
                         for s in range(len(sources)))
            out.update(groups=len(groups), sources_joined=joined)
            if joined != len(sources):
                raise AssertionError(f"only {joined}/{len(sources)} sources "
                                     f"grouped their 4 variants")
            k1 = cm.count_below_mma.launches
            frame = os.path.join(d, "frame.png")
            # frame 0: window compression always keeps it
            Image.fromarray(sources[3][0]).save(frame)
            for needle, s in ((os.path.join(d, "s07_trim.fseq"), 7),
                              (frame, 3)):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = main(["-use", d, *args, "-similar-to", needle,
                               "-json"])
                hit = json.loads(buf.getvalue())
                if rc or not hit or {owner[m["path"]] for m in
                                     hit[0]["matches"]} != {s}:
                    raise AssertionError(f"-similar-to {needle} missed")
                out[f"similar_to_{os.path.basename(needle)}"] = \
                    len(hit[0]["matches"])
            if cm.count_below_mma.launches == k1:
                raise AssertionError("K1-mma did not run for -similar-to")
        torch.cuda.empty_cache()
        return out

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
        "K1-mma": {"name": "count_below_mma", "route": "cuda",
                   "source": "cbird_tpu_torch/csrc/count_below_mma.cu",
                   "replaces": "experiments/mxu_epilogue_ab.py:179",
                   "also_replaces": ["experiments/mxu_epilogue_ab.py:95",
                                     "experiments/mxu_epilogue_ab.py:154",
                                     "experiments/mxu_i16_ab.py:55"]},
        "K1-mma-bf16": {"name": "count_below_mma_bf16", "route": "cuda",
                        "source": "cbird_tpu_torch/csrc/count_below_mma.cu",
                        "replaces": "experiments/mxu_count_sweep2.py:55"},
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
    from cbird_tpu_torch.ops.hamming_topk import hamming_topk
    s.kernels["K4"]["second_pass_needles"] = 0
    s.phase("build", s.build)
    s.phase("kernels", s.kernels_phase)
    s.phase("hash", s.hash_phase)
    # the main path: each phase with the counters from zero, read just after
    for name, fn in (("query", s.query_phase), ("self", s.self_phase),
                     ("ph", s.ph_phase), ("video", s.video_phase),
                     ("vcli", s.video_cli_phase), ("cli", s.cli_phase)):
        s.set_launches(dict.fromkeys(s.counters, 0))
        second = hamming_topk.overflowed
        s.phase(name, fn)
        got = s.launches()
        second = hamming_topk.overflowed - second
        print(f"launches in {name}: {json.dumps(got)}; K4 needles through "
              f"the second pass: {second}", flush=True)
        for k, n in got.items():
            s.kernels[k]["launches"] += n
        s.kernels["K4"]["second_pass_needles"] += second
    for name, k in s.kernels.items():
        if k["launches"] == 0 and name not in OFF_PATH:
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
