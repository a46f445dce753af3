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
           the tensor-core count (K1-mma, wgmma and bf16) also against
           the popcount K1, and the three timed at the K1 variants'
           shapes, the triangle's tile and the 1024-needle gate's; its
           masked form (K2-mma) against the plain twin and the popcount
           K2 on diagonal tiles (the diagonal inside a step, on a step
           edge, past and below the tile, 64-bit bases, a ragged needle
           batch), timed beside the popcount K2; both also at the wgmma
           kernel's tile edges (EDGE_Q, EDGE_N, EDGE_D, every t of K2_T);
           K3-run (the run tiles) also at the cluster shape (the ~465 run
           tiles of a 65,536-row near-duplicate cluster, checked against
           its plain twin), both of its shapes timed as the wrapper back to
           back, the bare kernel's device time and the wrapper's host time;
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
           5000-row cluster that shares one block's key, then the 2M one
           plus a 65,536-row near-duplicate cluster (every member within 2
           bits of one centre: hit-dense run tiles in every block):
           search_self(5, k=64) through the pigeonhole count phase (K3,
           K3-run; launches printed; the cluster's store through that
           count phase alone: search_self would list its 2^32 pairs, which
           takes minutes); then, as checks, its counts against
           the classic triangle's on every row at 2M and 2M + the cluster
           and against K2 on sampled rows at 10M (every row with
           --triangle-all); K3 on the 10M store's block 0 timed and held
           against its bound
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
  feat     extract_features_batch (ORB at 400 features, 12 levels;
           descriptors and keypoint hashes) over 1024 seeded textured
           images with long sides of 300-1200 px: images/s, and the device
           time of the pyramid and the ROI hashes beside the host's
           prescale and pack; 64 of them also through the CPU path (in
           chunks of 16): every ORB output equal (keypoints, 100%;
           descriptor bits differing, 0) and the ROI hashes equal but for
           flat ROIs (float noise on any device, counted apart); 8 of them
           one at a time on the card: the same features, bit for bit, as
           in the chunk of 64
  fdct     a DctFeaturesIndex of 2^22 keypoint-hash rows (10486 images x
           400) with 64 planted crop groups: -similar (find_all, t=5,
           through the pigeonhole path, K3 and K4) finds them; -similar-to
           of 16 needle images (6400 hashes: the K1-mma gate, K4) gives the
           same lists; 256 sampled rows' candidates against numpy
  orb      a CvFeaturesIndex of 2^20 descriptors (2622 images x 400) with 64
           planted groups: -similar-to of 16 needle images and -similar
           over the images of the first 2^18 rows (K5, bounded at
           cvThresh) find them; 64 sampled needle images' K5 results and
           votes against the plain twin's
  fcli     12 textured sources x (source, crop, 0.75 scale) as files:
           cbird-torch -create -update, then -p.alg fdct and orb -similar
           -json and -similar-to; the groups equal the same CLI run with
           CBIRD_TORCH_DEVICE=cpu in a subprocess (its own -update)
  cdesc    create_descriptors (canvas 256) over 1024 seeded RGB images of
           64-256 px with colored patches: images/s and the histogram of
           numColors; 16 of them also on the CPU, the descriptors equal
           (each differing entry printed, card against CPU)
  color    a ColorDescIndex of 2^20 descriptors (numColors drawn from
           cdesc's histogram) with 64 planted groups of 4 near copies
           (Luv within 2 quantization steps) in its first 2^16 rows:
           find_batch of the 64 sources over all 2^20 rows (-similar-to,
           K6) and find_all over the first 2^16 rows (the count-bucketed
           -similar) find every group; the scan path
           (CBIRD_COLOR_BUCKETS=off) equals the bucketed one over 2^14
           rows
  ccli     12 colored sources x (source, half size, mirrored, jpeg q50)
           as files: cbird-torch -create -i.algos dct+color -update,
           -p.alg color -similar (each source's four variants joined) and
           -similar-to of a mirrored copy, -merge, -test-image-search and
           -test-image-loader, each exit 0
  tm       256 textured sources of 300-1200 px x (source, 70-90% crop,
           0.5-0.8 rescale, shift onto a larger ground) and 256 unrelated
           images as files: cbird-torch -create -i.algos dct+fdct
           -update, -p.alg fdct -similar (the candidates), then -p.alg
           fdct -p.tm 1 -similar (ORB of the matcher on the card, its
           mutual match on K5): the sources joined and the cross-source
           pairs kept, each case against the planted truth printed with
           its cause and its scores both ways against a CPU matcher of
           the port; the matcher's descriptors on CUDA; K5's mutual match
           against numpy on 64 sampled pairs; 16 groups' pairs scored on
           the card and the CPU, every score equal; pairs verified/s, the
           wall and ORB's share
  serve    QueryServer over tm's index on 127.0.0.1:0 in a background
           thread (warm-up timed: every kernel built and loaded, the dct
           store on the card): ping, status, 64 queries (dct and fdct, 8
           with -p.tm), -similar-to through the CLI with CBIRD_SERVER,
           stop; each answer equal to the same -similar-to in process;
           first and warm p50 / p99 ms a kind of query
  mesh     the stores on a mesh of MESH_SHARDS shards of this card (the
           (2, 4) mesh of the JAX tests; also on a mesh of every card when
           there are several), each result equal, bit for bit, to the same
           store's on one device, walls side by side: 1- and 1024-needle
           search over a 10M-row store, search_self(5, k=64) through the
           pigeonhole count at 2M rows (with a 5000-row equal-key run: run
           tiles) and the triangle at 1M, video (a) and (b) at 4096 x 512
           frames, orb -similar-to of 16 images over 2^20 descriptors,
           color -similar-to of 64 needles over 2^20 rows and -similar
           over 2^16 rows (bucketed on one device, the scan on a mesh);
           then torch.distributed at world size 1 (CUDA collectives on
           NCCL): the 1M store's self-search through the triangle and
           the pigeonhole on make_multihost_mesh's mesh, and the all-pairs
           step of 4096 needles, against one device

The kernels phase also holds K5 (the 256-bit k-nearest search on the
tensor cores) and K5-popc (its popcount form, the yardstick) against
their plain twin at Q in K5_Q x T in K5_T (ties, some across the tensor-core
form's chunk edges, an all-invalid range, k in {1, 10}, bound 25 and
none) and times both in turns at K5_TIMED: Q=6400 x T=2^20, k=10, bound
25 and unbounded, and the orb -similar launch, 8192 x 2^20 at bound 25,
beside two bounds: tc_bound_ms, the function's (its +-1 product over
K = 256 on the tensor cores, as K4's tc_bound_ms; K5's bound_ms), and
K5-popc's bound_ms, that of its own form (8 POPC a pair).  It holds K6
(the chamfer color score) against its plain twin, bit for bit, at K6_Q x
K6_C for both sides and the one-sided forms with a row window, and times
it at K6_TIMED beside its plain twin and, as a yardstick, torch.cdist of
the colors alone at a small shape; and the color top-k of 8 needles over a
2^20-row store against the plain twin's, one needle with 101 rows tied at
its best score across a chunk edge and the k boundary; and in warps
whose rows' counts straddle the needles'.  It times K6's one-sided forms
("ab", "ba") at color -similar's launch, 1024 needles x K6_WINDOW rows,
each beside its plain twin, whose scores of every needle it matches.  K6's bound counts
the FP32 instructions the data needs (3 subtracts, a multiply, 2 FMAs and
a min a color pair of each scored pair, over the side it takes; a sqrt, a
compare and an add a color of that side) at FP32_PER_CLK a clock per SM,
the card's peak; the rate chip_bounds.py's probe of that color-pair step
sustains is printed beside it (probed_k6_step_per_clk_sm).

The main path is query, self, ph, video, vcli, cli, feat, fdct, orb,
fcli, cdesc, color, ccli, tm, serve and mesh: the launch
counters are zeroed just before each of them and read just after; every
kernel must have run there, but for the bf16 form of K1-mma and the
popcount K1 and K2 (the yardstick of the tensor-core forms), which only
the kernels phase launches and the main path must launch 0 times.
Launches made only to check a result (the ph and video phases' count
checks, tm's sampled mutual matches and CPU comparison) are left out of
the counts.  The line before the last is a JSON
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
import operator
import os
import socket
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
KERNELS = ("count_below", "count_below_mma", "hamming_topk", "band_count",
           "hamming_lanes_topk", "color_scores")
FP32_PER_CLK = 128  # FP32 instructions issued per clock per SM (4 x 32)
# K1-mma: checked thresholds; timed shapes (Q, N, t): the K1 variants'
# experiments (epilogue and i16 at t=5, the bf16 sweep at t=6), the
# triangle's tile at 1M rows, the 1024-needle gate (K1's row)
MMA_T = (0, 1, 5, 8, 32, 33, 63, 64, 65)
MMA_SHAPES = ((16384, 1 << 21, 5), (16384, 1 << 21, 6), (16384, 1 << 16, 5),
              (1024, 1 << 20, 5))
# K2-mma: checked thresholds; checked (row_base, col_base) of a ragged
# 16381 x 65536 diagonal tile: the diagonal inside a 256-column step, on a
# step edge, past the tile, below it, at 64-bit ids
K2_T = (0, 5, 33, 63, 64, 65)
K2_BASES = ((16384 + 100, 0), (32768, 0), (0, 65536), (147456, 0),
            ((1 << 33) + 5000, 1 << 33))
# the wgmma kernel's tile edges (count_below_mma.cu: units of 192 rows,
# three consumers of one m64 tile each, n-tiles of 256 columns, steps of
# 1024, a ring of 2 steps and one of 4 packed steps): needle counts
# around an m64 tile and one and two units' rows, column counts (one past
# each ring's wrap) and diagonal offsets row_base - col_base (the m64,
# n-tile and step edges, and past the tile), checked at every t of K2_T
EDGE_Q = (1, 63, 65, 127, 129, 191, 193, 255, 257, 383, 385)
EDGE_N = (1, 255, 257, 1023, 1025, 2049, 4097)
EDGE_D = (0, 1, -1, 63, -63, 64, -64, 255, -255, 256, -256, 257, -257,
          1023, -1023, 1024, -1024, 1025, -1025, 5000, -5000)
# the video phase's collection and its plants
VIDEOS, FRAMES, FRAME_STEP = 4096, 512, 12
COPIES, COPY_LEN = 64, 200
BLACK_VIDEOS, BLACK_AT = 2000, (100, 200, 300, 400)
NEEDLE_TRIMMED, NEEDLE_SOURCES, NEEDLE_SEG, NEEDLE_BLACK = 16384, 24, 300, 16
# kernels only the kernels phase launches: the main path must not
OFF_PATH = ("K1-mma-bf16", "K1", "K2", "K5-popc")
# sizes: K3's checks (sorted block rows, tile size s, thresholds; the
# first is timed; s=1024 and 4096 are the other sizes the main path
# picks; the largest threshold, pigeonhole.MAX_THRESHOLD, runs K3-run at
# every mask count, its data with K3_FAR pairs a block first equal there,
# k3_far_pairs), the self phase's store, the ph phase's stores (the first is
# checked on every row against the triangle, ~N^2 / 3.8e12 s; the second
# on PH_SAMPLE blocks of 64 rows)
T_MAX = 8
K3_CHECKS = ((1 << 20, 2048, (T, 1)), (1 << 20, 1024, (T,)),
             (1 << 21, 4096, (T,)), (1 << 20, 2048, (T_MAX,)))
K3_FAR = 4096
# K3-run's cluster shape: a near-duplicate cluster of K3_CLUSTER rows (every
# member within 2 bits of one centre) in a block of K3_CHECKS[0]'s rows, at
# its s: in block 0 of t=5 one equal-key run, ~465 hit-dense run tiles;
# the ph phase's store of PH_ROWS[0] rows holds one as well (its count
# phase), and one of PH_CLUSTER_SELF rows through search_self (the
# K3_CLUSTER one lists 2^32 pairs: minutes of top-k)
K3_CLUSTER = 65536
PH_CLUSTER_SELF = 8192
SELF_ROWS = 1_000_000
PH_ROWS = (2_000_000, 10_000_000)
PH_SAMPLE = 128
# the feature phases at the published widths (400 features an image, 12
# levels, 256-bit descriptors, 64-bit keypoint hashes): feat's images (8
# of them also on the CPU); the fdct store (2^22 keypoint-hash rows) and
# the orb store (2^20 descriptors), each with FEAT_GROUPS planted crop
# groups and FEAT_NEEDLES needle images (FEAT_ALONE of feat's also one at a
# time on the card); orb -similar over the images of
# the first ORB_SIMILAR_ROWS rows; fcli's sources
FEAT_IMAGES, FEAT_CPU, FEAT_ALONE, KP = 1024, 64, 8, 400
FDCT_IMAGES, ORB_IMAGES = 10486, 2622
FEAT_GROUPS, FEAT_NEEDLES = 64, 16
ORB_SIMILAR_ROWS = 1 << 18
FCLI_SOURCES = 12
# K5: checked needle and row counts (around the tensor-core form's m64
# tiles, its units of 192 needles, its steps of 256 columns, and one
# column past a chunk edge: 8193 rows in 33 chunks of one step); the
# timed shapes (name, Q, bound), all at T=2^20, k=10: the first is the
# kernels line's
K5_Q = (1, 63, 65, 191, 192, 193, 513)
K5_T = (1, 255, 256, 257, 8193, 16385, 1 << 20)
K5_TIMED = (("6400_bound25", 6400, 25), ("6400_unbounded", 6400, 257),
            ("8192_bound25", 8192, 25))
# the color phases: cdesc's images (CDESC_CPU of them also on the CPU);
# the color store (2^20 descriptors, COLOR_GROUPS planted groups of 4 in
# its first COLOR_SIMILAR_ROWS rows), -similar over those rows, the scan
# path against the bucketed one over COLOR_SCAN_ROWS; K6's timed shape
# (Q, C: chunks of 4096), its one-sided window (the bucketed -similar's
# super chunk), its checked needle and row counts (around its tiles of 32
# needles and 128 rows) and the topk check's needles over the whole store;
# ccli's sources (x 4 variants)
CDESC_IMAGES, CDESC_CPU = 1024, 16
COLOR_ROWS, COLOR_SIMILAR_ROWS, COLOR_SCAN_ROWS = 1 << 20, 1 << 16, 1 << 14
COLOR_GROUPS = 64
K6_TIMED = (1024, 1 << 18)
K6_WINDOW = 1 << 16
K6_Q = (1, 31, 32, 33, 64)
K6_C = (1, 127, 128, 129, 4097)
K6_TOPK_NEEDLES = 8
CCLI_SOURCES = 12
# the template matcher's collection: TM_SOURCES textured sources of
# 300-1200 px, each with a 70-90% crop, a 0.5-0.8 rescale and a shift,
# and TM_DISTRACTORS unrelated images; TM_SAMPLED_PAIRS pairs' K5 mutual
# match against numpy, TM_CPU_GROUPS groups' scores against the CPU;
# serve's query requests (SERVE_TM of them with -p.tm)
TM_SOURCES, TM_DISTRACTORS = 256, 256
TM_SAMPLED_PAIRS, TM_CPU_GROUPS, TM_CASES = 64, 16, 6
SERVE_QUERIES, SERVE_TM = 64, 8
# the mesh phase's shards of this card: the (2, 4) mesh of the JAX tests
MESH_SHARDS = 8
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
        from cbird_tpu_torch.ops import color_scores as cs
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import count_below_mma as cm
        from cbird_tpu_torch.ops import hamming_lanes as hl
        from cbird_tpu_torch.ops import hamming_topk as tk
        # kernel -> (wrapper, attribute of its launch counter)
        self.counters = {"K1": (cb.count_below, "launches"),
                         "K2": (cb.count_below, "masked_launches"),
                         "K1-mma": (cm.count_below_mma, "launches"),
                         "K2-mma": (cm.count_below_mma, "masked_launches"),
                         "K1-mma-bf16": (cm.count_below_mma, "bf16_launches"),
                         "K3": (bc.band_counts, "launches"),
                         "K3-run": (bc.run_tiles, "launches"),
                         "K4": (tk.hamming_topk, "launches"),
                         "K5": (hl.hamming_lanes_topk, "launches"),
                         "K5-popc": (hl.hamming_lanes_topk_popc,
                                     "launches"),
                         "K6": (cs.color_scores, "launches")}

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
              tc_rate: float = TC_INT8_OPS_PER_S, fp32: float = 0):
        """Sets ``target[key]`` to the least time (ms) the card could take
        to move ``nbytes`` and execute ``popc`` POPC, ``int_ops`` INT32
        instructions of which ``alu`` are compares or logic (the ALU pipe
        only), ``tc_ops`` tensor-core operations at ``tc_rate`` and ``fp32``
        FP32 instructions at FP32_PER_CLK a clock per SM, and
        ``target[by]`` to which of the two bounds it.  finish_bounds sets
        it, at the highest SM clock the kernels phase read."""
        self.bound_sites.append((target, key, by, dict(
            nbytes=nbytes, popc=popc, alu=alu, int_ops=int_ops,
            tc_ops=tc_ops, tc_rate=tc_rate, fp32=fp32)))

    def finish_bounds(self):
        clk = self.clock_hz * SMS
        for target, key, by, w in self.bound_sites:
            by_ops = max(w["popc"] / (POPC_PER_CLK * clk),
                         w["alu"] / (ALU_PER_CLK * clk),
                         w["int_ops"] / (INT32_PER_CLK * clk),
                         w["tc_ops"] / w["tc_rate"],
                         w["fp32"] / (FP32_PER_CLK * clk))
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
        out.update(self.k5_kernels())
        out.update(self.k6_kernels())
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
    def mma_work(q, n, rate, pairs=None):
        """The tensor-core count's work on the ``pairs`` it counts (default
        q * n; a diagonal tile's are those above the diagonal): 128
        tensor operations and the epilogue's one INT32 instruction a
        pair (its sign-bit add, taken as the ALU pipe's); 8 + 1 bytes a
        row and 8 + 4 a needle."""
        pairs = q * n if pairs is None else pairs
        return dict(nbytes=9 * n + 12 * q, alu=pairs, int_ops=pairs,
                    tc_ops=128 * pairs, tc_rate=rate)

    @staticmethod
    def same(a, b, what: str = "kernel") -> float:
        """@return the largest absolute difference of ``a`` and ``b``
        (floats in float64); raises unless it is 0."""
        if a.shape != b.shape:
            raise AssertionError(f"{what}: shape {tuple(a.shape)} against "
                                 f"{tuple(b.shape)}")
        if a.is_floating_point():
            a, b = a.double(), b.double()
        else:
            a, b = a.long(), b.long()
        err = float((a - b).abs().max()) if a.numel() else 0.0
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
        planted at distance t - 1 and t; K2-mma (``k2_mma_checks``); then
        both forms and the popcount K1 timed at MMA_SHAPES, K2-mma and the
        popcount K2 on the diagonal tile of two of them."""
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
        plant = np.array([b for t in MMA_T for b in (t - 1, t)
                          if 0 <= b <= 64])
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
        err["K2-mma"], out["K2-mma_checked"] = self.k2_mma_checks(rng)
        edge_err, out["mma_edges_checked"] = self.mma_edge_checks(rng)
        err["K1-mma"] = max(err["K1-mma"], edge_err["K1-mma"])
        err["K2-mma"] = max(err["K2-mma"], edge_err["K2-mma"])
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
        # K2-mma: the diagonal tile (rows = the first columns) of the
        # triangle's shape and of the gate's, beside the popcount K2
        masked = {}
        for qq, nn, t in (MMA_SHAPES[2], MMA_SHAPES[3]):
            args = (hay[:qq], hay[:nn], vd[:nn], t)
            kw = dict(masked=True)
            masked[(qq, nn, t)] = {
                "ms": self.event_ms(lambda: cm.count_below_mma(*args, **kw),
                                    20),
                "popcount_K2_ms": self.event_ms(
                    lambda: cb.count_below(*args, **kw), 20)}
        tq, tn, t = MMA_SHAPES[2]
        args = (hay[:tq], hay[:tn], vd[:tn], t)
        k2_plain_ms = self.event_ms(lambda: cm.count_below_mma_plain(
            *args, masked=True), 3)
        self.sm_clock()

        # bounds: mma_work; the popcount form's: 2 POPC a pair
        mma_work = self.mma_work
        qq, nn, _ = MMA_SHAPES[0]
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
        ms_at = {}
        for (a, b, c), row in masked.items():
            pairs = a * b - a * (a + 1) // 2  # column > row
            row = ms_at[f"Q={a} N={b} t={c} diagonal"] = dict(row)
            self.bound(row, "bound_ms", **mma_work(a, b, TC_INT8_OPS_PER_S,
                                                   pairs))
            self.bound(row, "popcount_K2_bound_ms", nbytes=9 * b + 12 * a,
                       popc=2 * pairs)
        self.kernels["K2-mma"].update(
            max_abs_err=err["K2-mma"], ms=masked[MMA_SHAPES[2]]["ms"],
            plain_ms=k2_plain_ms, library_ms=None, ms_at=ms_at)
        self.bound(self.kernels["K2-mma"], "bound_ms", "bound_by",
                   **mma_work(tq, tn, TC_INT8_OPS_PER_S,
                              tq * tn - tq * (tq + 1) // 2))
        out["K2-mma_ms_at"] = ms_at
        out["K1-mma_plain_ms"] = round(plain_ms, 4)
        out["K2-mma_plain_ms"] = round(k2_plain_ms, 4)
        out["K1-mma_pairs_per_s"] = qq * nn / (times[MMA_SHAPES[0]]["int8"]
                                              * 1e-3)
        return out

    def mma_edge_checks(self, rng):
        """K1-mma at every Q of EDGE_Q x N of EDGE_N and K2-mma at every
        offset of EDGE_D (Q 65 and 257, N 1025 and 4097, 32- and 64-bit
        ids), t in K2_T, each bit for bit against the plain twin and the
        popcount K1 / K2.  The haystack: 8192 rows, a third of them copies
        of a row 1-300 before with 0-4 bits flipped (near pairs on both
        sides of any diagonal), 1% tombstones and an all-invalid slot of
        1024 columns; the unmasked columns start on a 16-byte boundary and
        off it.
        @return ({kernel: max abs err}, what was checked)"""
        torch = self.torch
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import count_below_mma as cm
        n = 8192
        h64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        dup = np.nonzero(rng.random(n) < 0.3)[0]
        dup = dup[dup >= 300]
        src = dup - rng.integers(1, 301, len(dup))
        h64[dup] = self.flip_bits(h64[src], rng.integers(0, 5, len(dup)), rng)
        valid = rng.random(n) > 0.01
        valid[2048:3072] = False
        hay = torch.from_numpy(h64.view(np.int64)).to(self.dev)
        vd = torch.from_numpy(valid).to(self.dev)
        nd = hay[5000:5000 + max(EDGE_Q)] ^ 0x11
        err = {"K1-mma": 0.0, "K2-mma": 0.0}
        hits, calls = {"K1-mma": 0, "K2-mma": 0}, 0
        for c0 in (1024, 1025):
            for q in EDGE_Q:
                for nn in EDGE_N:
                    args = (nd[:q], hay[c0:c0 + nn], vd[c0:c0 + nn])
                    for t in K2_T:
                        got = cm.count_below_mma(*args, t)
                        torch.cuda.synchronize()
                        what = f"K1-mma edge c0={c0} q={q} n={nn} t={t}"
                        err["K1-mma"] = max(
                            err["K1-mma"],
                            self.same(got, cm.count_below_mma_plain(*args, t),
                                      what),
                            self.same(got, cb.count_below(*args, t), what))
                        hits["K1-mma"] += int(got.sum())
                        calls += 1
        s = 3000
        for d in EDGE_D:
            for q in (65, 257):
                for nn in (1025, 4097):
                    # rows at ids s + d, columns at s, so that the
                    # diagonal's offset is d; the rows' hashes from the
                    # same ids (clamped into the store past the tile)
                    r = min(max(s + d, 0), n - q)
                    args = (hay[r:r + q], hay[s:s + nn], vd[s:s + nn])
                    for base in (0, 1 << 33):
                        kw = dict(masked=True, row_base=base + s + d,
                                  col_base=base + s)
                        for t in K2_T:
                            got = cm.count_below_mma(*args, t, **kw)
                            torch.cuda.synchronize()
                            what = (f"K2-mma edge d={d} q={q} n={nn} "
                                    f"base={base} t={t}")
                            err["K2-mma"] = max(
                                err["K2-mma"],
                                self.same(got, cm.count_below_mma_plain(
                                    *args, t, **kw), what),
                                self.same(got, cb.count_below(*args, t, **kw),
                                          what))
                            hits["K2-mma"] += int(got.sum())
                            calls += 1
        if not all(hits.values()):
            raise AssertionError(f"mma edge checks: no hit ({hits})")
        return err, {"Q": list(EDGE_Q), "N": list(EDGE_N),
                     "offsets": list(EDGE_D), "t": list(K2_T),
                     "launches": calls, "hits": hits}

    def k2_mma_checks(self, rng):
        """K2-mma against its plain twin and the popcount K2 on a ragged
        16381 x 65536 diagonal tile at each of K2_BASES and K2_T: 2^18 random
        rows, 1% tombstones, a quarter of the rows copies of a row 1-300
        rows before them with 0-4 bits flipped, so near pairs lie on both
        sides of the diagonal.
        @return (max abs err, what was checked)"""
        torch = self.torch
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import count_below_mma as cm
        n, rows, cols = 1 << 18, 16381, 1 << 16
        h64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        dup = np.nonzero(rng.random(n) < 0.25)[0]
        dup = dup[dup >= 300]
        src = dup - rng.integers(1, 301, len(dup))
        h64[dup] = self.flip_bits(h64[src], rng.integers(0, 5, len(dup)), rng)
        hay = torch.from_numpy(h64.view(np.int64)).to(self.dev)
        vd = torch.from_numpy(rng.random(n) > 0.01).to(self.dev)
        err, hits = 0.0, {}
        for rb, c0 in K2_BASES:
            # operands at the bases' offsets; at 64-bit ids, 5000 rows apart
            r, c = (rb, c0) if rb < n else (5000, 0)
            args = (hay[r:r + rows], hay[c:c + cols], vd[c:c + cols])
            kw = dict(masked=True, row_base=rb, col_base=c0)
            for t in K2_T:
                got = cm.count_below_mma(*args, t, **kw)
                torch.cuda.synchronize()
                what = f"K2-mma row_base={rb} col_base={c0} t={t}"
                err = max(err, self.same(got, cm.count_below_mma_plain(
                    *args, t, **kw), what), self.same(got, cb.count_below(
                        *args, t, **kw), what))
                hits[f"{rb}/{c0}/t{t}"] = int(got.sum())
        if not any(v for k, v in hits.items() if k.endswith("/t5")):
            raise AssertionError("K2-mma checks: no pair under t=5")
        return err, {"Q": rows, "N": cols, "t": list(K2_T),
                     "bases": [list(b) for b in K2_BASES], "hits": hits}

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
            for ta, tb in (tiles.tolist() if hasattr(tiles, "tolist")
                           else tiles):
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

    @staticmethod
    def k3_far_pairs(h64: np.ndarray, t: int, rng, pairs: int = K3_FAR):
        """For each block b >= 1 of threshold ``t``, ``pairs`` pairs of
        rows a distance b apart, one bit in each earlier block: a pair
        first equal in block b, so that it counts there.  One row of a pair
        lies in the first half of the store, the other in the second (both
        clear of k3_data's plants), so that the stable sort puts them far
        apart in their run, in a run tile where the run spans three."""
        from cbird_tpu_torch.ops import pigeonhole as ph
        bits = [[i for i in range(64) if ph.mask64(m) % 2**64 >> i & 1]
                for m in ph.block_masks(t)]
        n = len(h64)
        lo = rng.permutation(np.arange(n // 5, n // 2))
        hi = rng.permutation(np.arange(n // 2 + n // 8, n - 64))
        for b in range(1, t):
            a = lo[(b - 1) * pairs:b * pairs]
            c = hi[(b - 1) * pairs:b * pairs]
            flip = np.zeros(pairs, dtype=np.uint64)
            for e in range(b):
                flip |= np.uint64(1) << rng.choice(bits[e], size=pairs) \
                    .astype(np.uint64)
            h64[c] = h64[a] ^ flip

    @staticmethod
    def k3_cluster(h64: np.ndarray, rows: np.ndarray, rng, outside: int = 0):
        """A near-duplicate cluster: ``rows`` of ``h64`` become one centre
        with 0-2 of its bits flipped (outside the bits of ``outside``, a
        64-bit mask, so that they keep its key there)."""
        free = [b for b in range(64) if not outside >> b & 1]
        centre = h64[rows[0]]
        flips = rng.integers(0, 3, size=len(rows))
        for r, f in zip(rows, flips):
            bits = rng.choice(free, size=int(f), replace=False)
            h64[r] = centre ^ np.uint64(sum(1 << int(b) for b in bits))

    def run_launch(self, csort, ops, tiles, masks, s: int):
        """One bare ``cbird_run_tiles`` launch of K3-run (no wrapper), as a
        callable: its device time is the kernel's own."""
        import ctypes
        from cbird_tpu_torch import _build
        from cbird_tpu_torch.ops import band_count as bc
        lib = bc._load(bc._RUN_FN, bc._RUN_ARGS)
        marr = bc._mask_array(masks)
        args = (*(a.data_ptr() for a in ops), ops[0].numel(), s,
                ctypes.addressof(marr), len(masks), T, tiles.data_ptr(),
                len(tiles), csort.data_ptr(),
                self.torch.cuda.current_stream().cuda_stream)

        def launch():
            _build.check(lib, getattr(lib, bc._RUN_FN)(*args), "run_tiles")
        launch.keep = marr
        return launch

    def queued_ms(self, fn, reps: int):
        """(device ms, host ms) a call of ``fn``, ``reps`` calls queued
        behind a spin of the card: the device time is the calls' own, with
        no wait for the host, and the host time the wrapper's enqueue."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # ~20 ms at 2 GHz
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps, host

    def k3_kernels(self):
        """K3 (band and run tiles) against the plain versions on sorted
        blocks at every size of K3_CHECKS (``k3_data``), every block of each
        threshold; times the first size's t=5 block 0.  K3-run also at the
        cluster shape (K3_CLUSTER), checked against its plain twin; both
        of its shapes timed three ways: the wrapper back to back (ms), the
        bare kernel's device time, the wrapper's host time a call."""
        torch = self.torch
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import pigeonhole as ph
        rng = np.random.default_rng(SEED + 5)
        out, err = {}, {"K3": 0, "K3-run": 0}
        timed = None
        for n, s, ts in K3_CHECKS:
            if T_MAX in ts:  # its own draws: the later shapes stay as they were
                far = np.random.default_rng(SEED + T_MAX)
                h64, valid = self.k3_data(n, s, far)
                self.k3_far_pairs(h64, T_MAX, far)
            else:
                h64, valid = self.k3_data(n, s, rng)
            for t in ts:
                for b in range(t):
                    ops, masks, key_s = self.k3_block(h64, valid, t, b, s)
                    got = bc.band_counts(*ops, masks, t, s)
                    want = bc.band_counts_plain(*ops, masks, t, s)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"K3 band s={s} t={t} block {b}")
                    tiles = ph.run_tile_pairs(key_s, self.changes(key_s), s)
                    band = int(want.sum())
                    bc.run_tiles(got, *ops, tiles, masks, t, s)
                    bc.run_tiles_plain(want, *ops, tiles, masks, t, s)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"K3 run tiles s={s} t={t} "
                                             f"block {b}")
                    if t == T_MAX and int(want.sum()) == band:
                        raise AssertionError(f"K3 run tiles t={t} block {b}: "
                                             f"no credit to check")
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
        # the cluster shape: K3_CLUSTER rows of a K3_CHECKS[0]-size block in
        # one run of block 0, its run tiles against the plain twin
        h64, valid = self.k3_data(n, s, rng)
        m0 = ph.mask64(ph.block_masks(T)[0]) % 2**64
        self.k3_cluster(h64, np.arange(n // 4, n // 4 + K3_CLUSTER), rng,
                        outside=m0)
        c_ops, _, c_key = self.k3_block(h64, valid, T, 0, s)
        c_tiles = ph.run_tile_pairs(c_key, self.changes(c_key), s)
        got = bc.run_tiles(torch.zeros_like(c_ops[1]), *c_ops, c_tiles,
                           masks, T, s)
        want = bc.run_tiles_plain(torch.zeros_like(c_ops[1]), *c_ops,
                                  c_tiles, masks, T, s)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("K3 run tiles differ at the cluster shape")
        c_csort = torch.zeros_like(c_ops[1])
        shapes = {"": (ops, tiles, csort), "cluster_": (c_ops, c_tiles,
                                                         c_csort)}
        # bounds: 17 bytes a row (hash, row, valid, credit); the data needs
        # a pair tested only where the block keys are equal (the run edges
        # of a sorted block cost ~4 INT32 a row to find): 2 POPC and ~4
        # INT32 (two xors, the add, the compare; all but the add on the
        # ALU pipe) per equal-key pair; and a run tile's credit, one add
        # (INT32) a counted pair: a hit-dense tile's pairs all count
        run_work = {}
        for tag, (o, tl, _) in shapes.items():
            k_s = key_s if not tag else c_key
            rpairs, rcands = self.k3_work(k_s, s, tl)
            hits = int(bc.run_tiles_plain(torch.zeros_like(o[1]), *o, tl,
                                          masks, T, s).sum()) if not tag \
                else int(want.sum())
            run_rows = 2 * s * len(tl)
            run_work[tag] = dict(nbytes=17 * run_rows, popc=2 * rcands,
                                 alu=3 * rcands + 4 * run_rows,
                                 int_ops=4 * rcands + 4 * run_rows + hits)
            out[f"K3-run_{tag}pairs"] = rpairs
            out[f"K3-run_{tag}candidates"] = rcands
            out[f"K3-run_{tag}hits"] = hits
            out[f"K3-run_{tag}tiles"] = len(tl)
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
                       run_work[""]),
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
        # K3-run at both shapes: the wrapper back to back, the bare kernel's
        # device time, the wrapper's host time a call
        for tag, (o, tl, cs) in shapes.items():
            wrap = (lambda o=o, tl=tl, cs=cs:
                    bc.run_tiles(cs, *o, tl, masks, T, s))
            if tag:
                out["K3-run_cluster_ms"] = self.event_ms(wrap, 20)
                self.bound(out, "K3-run_cluster_bound_ms",
                           "K3-run_cluster_bound_by", **run_work[tag])
            out[f"K3-run_{tag}kernel_ms"] = self.queued_ms(
                self.run_launch(cs, o, tl, masks, s), 20)[0]
            out[f"K3-run_{tag}wrapper_host_ms"] = self.queued_ms(wrap, 20)[1]
        self.kernels["K3-run"].update(
            kernel_ms=out["K3-run_kernel_ms"],
            cluster_ms=out["K3-run_cluster_ms"],
            cluster_kernel_ms=out["K3-run_cluster_kernel_ms"])
        self.bound(self.kernels["K3-run"], "cluster_bound_ms",
                   **run_work["cluster_"])
        out["K3_pairs"], out["K3_candidates"] = pairs, cands
        out["K3_pairs_per_s"] = pairs / (self.kernels["K3"]["ms"] * 1e-3)
        out["sm_clock_mhz_after"] = smi_mhz("clocks.sm")
        out["k3_shapes"] = (
            "checked: " + ", ".join(f"{c[0]}-row block s={c[1]} t={c[2]}"
                                    for c in K3_CHECKS)
            + f"; timed: {n}-row block, s={s}, t={T} block 0 (band, and "
              f"its {len(tiles)} run tiles); K3-run's cluster shape: the "
              f"{len(c_tiles)} run tiles of a {K3_CLUSTER}-row cluster in "
              f"a {n}-row block, s={s}, t={T} block 0")
        return out

    def changes(self, key_s):
        """[m] bool: the first position of each equal-key run."""
        change = self.torch.ones_like(key_s, dtype=self.torch.bool)
        change[1:] = key_s[1:] != key_s[:-1]
        return change

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
        from cbird_tpu_torch.ops import count_below_mma as cm
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
            k1, k4 = cm.count_below_mma.launches, tk.hamming_topk.launches
            res = store.search(needles, T, k=64)
            for j in sel:
                if ids[dst[j]] not in res[j][0]:
                    raise AssertionError(f"q={q}: planted partner missed")
            if tk.hamming_topk.launches == k4:
                raise AssertionError(f"q={q}: K4 did not run")
            if (cm.count_below_mma.launches > k1) != (q > 64):
                raise AssertionError(f"q={q}: K1-mma gate ran = "
                                     f"{cm.count_below_mma.launches > k1}")
            walls = []
            for _ in range(20 if q < 1024 else 5):
                t0 = time.perf_counter()
                store.search(needles, T, k=64)
                walls.append((time.perf_counter() - t0) * 1e3)
            out[f"q{q}_p50_ms"] = round(float(np.median(walls)), 3)
        return out

    def self_phase(self):
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import color_scores as cs
        from cbird_tpu_torch.ops import count_below as cb
        from cbird_tpu_torch.ops import count_below_mma as cm
        from cbird_tpu_torch.ops import hamming_topk as tk
        from cbird_tpu_torch.ops.hamming import PackedHashStore
        rng = np.random.default_rng(SEED + 2)
        n = SELF_ROWS
        hashes, ids, src, dst, dead = self.planted_store(n, 1000, rng)
        store = PackedHashStore(hashes, ids, device=self.dev)
        store.remove(dead)
        store._device_arrays()
        # the classic triangle (K1-mma, K2-mma), as the reference's own
        # switch selects it, then the default pigeonhole count phase (K3)
        before = (cm.count_below_mma.launches,
                  cm.count_below_mma.masked_launches, tk.hamming_topk.launches,
                  cb.count_below.launches, cb.count_below.masked_launches)
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
        after = (cm.count_below_mma.launches,
                 cm.count_below_mma.masked_launches, tk.hamming_topk.launches,
                 cb.count_below.launches, cb.count_below.masked_launches)
        ran = [x - y for x, y in zip(after, before)]
        # 544 tiles of 16384 x 65536: 480 off the diagonal, 64 across it
        if ran[0] < 480 or ran[1] < 64 or ran[2] == 0 or any(ran[3:]):
            raise AssertionError(f"triangle launches K1-mma, K2-mma, K4, "
                                 f"K1, K2: {ran}")
        k3 = bc.band_counts.launches
        wall_ph, res_ph = self.timed(lambda: store.search_self(T, k=64,
                                                               sparse=True))
        if store.pigeonhole is None or bc.band_counts.launches == k3:
            raise AssertionError("the pigeonhole path was not taken")
        self.check_same(res, res_ph)
        return {"n": n, "triangle_wall_ms": round(wall, 1),
                "pigeonhole_wall_ms": round(wall_ph, 1),
                "rows_with_hits": len(res),
                "K1-mma_tiles": ran[0], "K2-mma_tiles": ran[1],
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
        """The pigeonhole count phase on the user scale ROADMAP names: the
        PH_ROWS stores, then PH_ROWS[0] rows plus a PH_CLUSTER_SELF-row
        near-duplicate cluster (every member within 2 bits of one centre:
        run tiles in every block) through search_self; PH_ROWS[0] rows plus
        a K3_CLUSTER-row one through the count phase alone (its result
        held against the triangle too); K3 timed on block 0 of the
        largest."""
        torch = self.torch
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import pigeonhole as ph
        from cbird_tpu_torch.ops.hamming import PackedHashStore
        rng = np.random.default_rng(SEED + 4)
        out = {}
        for n, cluster in ((*PH_ROWS[:1], 0), (*PH_ROWS[1:], 0),
                           (PH_ROWS[0], PH_CLUSTER_SELF),
                           (PH_ROWS[0], K3_CLUSTER)):
            if cluster:
                rng = np.random.default_rng(SEED + 14)
            hashes, ids, src, dst, dead = self.planted_store(n, 1000, rng)
            clus = np.empty(0, np.int64)
            if cluster:
                hashes = np.r_[hashes, np.zeros(cluster, np.uint64)]
                ids = np.arange(1, n + cluster + 1, dtype=np.uint32)
                clus = np.arange(n, n + cluster)
                hashes[n] = rng.integers(1, 2**64, dtype=np.uint64)
                self.k3_cluster(hashes, clus, rng)
                n += cluster
            elif n == PH_ROWS[-1]:
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
            hot = None
            if cluster == K3_CLUSTER:
                # search_self would list the cluster's 2^32 pairs (its
                # saturation escalation takes minutes): the count phase
                # it runs first, on the store's arrays
                stats: dict = {}
                wall, hot = self.timed(lambda: ph.self_counts_sparse(
                    hd, vd, T, n_valid, stats=stats))
                row = {"count_phase_wall_ms": round(wall, 1),
                       "rows_with_later_hits": len(hot[0])}
            else:
                wall, res = self.timed(lambda: store.search_self(
                    T, k=64, sparse=True))
                self.check_planted(res, ids, src, dst)
                if store.rescanned:
                    raise AssertionError(f"verify rescanned "
                                         f"{store.rescanned}")
                # every cluster member's 64 best: all within 4 bits of it
                for r in clus if cluster else ():
                    if len(res[r][0]) != 64 or max(res[r][1]) >= T:
                        raise AssertionError(f"cluster row {r}: "
                                             f"{res[r]}")
                stats = store.pigeonhole or {}
                row = {"search_self_wall_ms": round(wall, 1),
                       "rows_with_hits": len(res)}
            if not stats or bc.band_counts.launches == k3[0]:
                raise AssertionError(f"n={n}: pigeonhole path not taken")
            if len(clus) and bc.run_tiles.launches == k3[1]:
                raise AssertionError("the planted run launched no run tiles")
            row.update({"s_per_block": stats["s"],
                        "run_tiles_per_block": stats["run_tiles"],
                        "K3_launches": bc.band_counts.launches - k3[0],
                        "K3-run_launches": bc.run_tiles.launches - k3[1]})
            with self.uncounted():  # checks, not the main path
                count_ms, counts = self.timed(
                    lambda: ph.self_counts(hd, vd, T, n_valid))
                if counts[n:].any():
                    raise AssertionError(f"n={n}: a padding row counted")
                if n != PH_ROWS[-1] or self.triangle_all:
                    tri_ms, tri = self.timed(
                        lambda: store._classic_self_counts(
                            hd, vd, T, hd.numel(), 32768, 1 << 17))
                    if not np.array_equal(counts[:n], tri):
                        raise AssertionError(f"n={n}: pigeonhole counts "
                                             f"differ from the triangle's")
                    if hot is not None:  # the timed call's own result
                        dense = np.zeros(len(counts), np.int64)
                        dense[hot[0]] = hot[1]
                        if not np.array_equal(dense[:n], tri) \
                                or dense[n:].any():
                            raise AssertionError(
                                f"n={n}: the sparse count phase differs "
                                f"from the triangle's")
                    row["triangle_count_ms"] = round(tri_ms, 1)
                else:
                    row["rows_checked_by_K2"] = self.check_sampled(
                        counts, hd, vd, n, np.r_[src, dst, clus], rng)
                if n == PH_ROWS[-1]:
                    row.update(self.k3_block0(hd, vd, store.pigeonhole["s"][0]))
            row["pigeonhole_count_ms"] = round(count_ms, 1)
            row["later_hits"] = int(counts.sum())
            out[f"n{n}" if not cluster else
                f"n{n - cluster}_plus_cluster{cluster}"] = row
            del store, hd, vd, counts
            torch.cuda.empty_cache()
        return out

    def k3_block0(self, hd, vd, s: int) -> dict:
        """K3 on block 0 of a store's count phase (its tile size ``s``),
        timed and held against its bound (the kernels phase's bound)."""
        torch = self.torch
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import pigeonhole as ph
        masks = [ph.mask64(m) for m in ph.block_masks(T)]
        key_s, srow = ph.sort_block(hd, torch.nonzero(vd).flatten(),
                                    torch.nonzero(~vd).flatten(), masks[0])
        ops = ph.pad_block(hd, vd, srow, s)
        n_tot = ops[0].numel()
        pairs, cands = self.k3_work(key_s, s)
        ms = self.event_ms(lambda: bc.band_counts(*ops, masks[:1], T, s), 10)
        out = {"K3_block0_ms": round(ms, 4), "K3_block0_s": s,
               "K3_block0_pairs": pairs, "K3_block0_candidates": cands,
               "K3_block0_card": smi()}
        self.bound(out, "K3_block0_bound_ms", "K3_block0_bound_by",
                   nbytes=17 * n_tot, popc=2 * cands,
                   alu=3 * cands + 4 * n_tot, int_ops=4 * cands + 4 * n_tot)
        self.finish_bounds()
        out["K3_block0_bound_share"] = round(out["K3_block0_bound_ms"] / ms, 4)
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


    # ---- the feature algorithms (fdct, orb) -------------------------------
    def k5_kernels(self):
        """K5 (tensor cores) and K5-popc (popcount) against their plain
        twin at K5_Q x K5_T (an all-invalid range, planted ties: 401 rows
        at one distance, and ten across a chunk edge of the 513-needle
        launch, k in {1, 10}, bound 25 and none), then both timed in turns
        (K5, K5-popc, K5-popc, K5) at K5_TIMED, beside the function's bound
        and the +-1 int8 product (the product alone: no library call
        computes a Hamming k-nearest)."""
        torch = self.torch
        from cbird_tpu_torch.ops import hamming_lanes as hl
        forms = {"K5": hl.hamming_lanes_topk,
                 "K5-popc": hl.hamming_lanes_topk_popc}
        rng = np.random.default_rng(SEED + 10)
        tmax = max(K5_T)
        hay = torch.from_numpy(rng.integers(
            -2**63, 2**63, size=(tmax, 4), dtype=np.int64)).to(self.dev)
        hay[1000:1400] = hay[7]  # ties: 401 rows at one distance
        hay[3000:3005, 0] = hay[7, 0] ^ 1
        valid = torch.from_numpy(rng.random(tmax) > 0.01).to(self.dev)
        valid[5000:9000] = False  # an all-invalid range
        pick = torch.from_numpy(rng.integers(0, tmax, max(K5_Q))).to(self.dev)
        needles = hay[pick].clone()
        needles[:, 1] ^= 5
        needles[0] = hay[7]
        # needle 1's ten nearest: across the first chunk edge of the
        # 513-needle launch, the source row below it
        edge = hl.tc_plan(513, tmax, torch.cuda.get_device_properties(
            self.dev).multi_processor_count)[1]
        needles[1] = hay[edge - 20]
        hay[edge - 5:edge + 5] = hay[edge - 20]
        valid[edge - 20:edge + 5] = True
        err = {name: 0.0 for name in forms}
        checks = 0
        for t in K5_T:
            for q in K5_Q:
                nd = needles[:q].contiguous()
                for k in (1, 10):
                    for bound in (25, hl.BINS):
                        want = hl.hamming_lanes_topk_plain(
                            nd, hay[:t], valid[:t], k, bound)
                        for name, form in forms.items():
                            got = form(nd, hay[:t], valid[:t], k, bound)
                            torch.cuda.synchronize()
                            what = f"{name} q={q} t={t} k={k} bound={bound}"
                            err[name] = max(
                                err[name], self.same(got[0], want[0], what),
                                self.same(got[1], want[1], what))
                        checks += 1
        k = 10
        self.sm_clock()
        rows = {}
        plain_ms = None
        for name, q, bound in K5_TIMED:
            nd = hay[torch.from_numpy(rng.integers(0, tmax, q)).to(self.dev)]
            nd[:, 2] ^= 0x10101
            nd = nd.contiguous()
            want = hl.hamming_lanes_topk_plain(nd, hay, valid, k, bound)
            row = rows[name] = {}
            for form in ("K5", "K5-popc"):
                got = forms[form](nd, hay, valid, k, bound)
                err[form] = max(
                    err[form], self.same(got[0], want[0], f"{form} {name}"),
                    self.same(got[1], want[1], f"{form} {name}"))
            del want
            for form in ("K5", "K5-popc", "K5-popc", "K5"):  # in turns
                row.setdefault(form, []).append(self.event_ms(
                    lambda: forms[form](nd, hay, valid, k, bound), 10))
            for form in ("K5", "K5-popc"):
                row[f"{form}_ms"] = sum(row.pop(form)) / 2
            if plain_ms is None:  # the kernels line's shape
                plain_ms = self.event_ms(
                    lambda: hl.hamming_lanes_topk_plain(nd, hay, valid, k,
                                                        bound), 1)
            self.bound(row, "tc_bound_ms", **self.k5_work(q, tmax, k, True))
            self.bound(row, "popc_bound_ms", **self.k5_work(q, tmax, k))
        # yardstick of a tensor-core form: the +-1 int8 product of the
        # needles and 2^16 rows, times 16 (the whole product's [Q, T] int32
        # output would not fit the card)
        q = K5_TIMED[0][1]
        pm = (torch.randint(0, 2, (q, 256), device=self.dev) * 2 - 1).to(
            torch.int8)
        hm = (torch.randint(0, 2, (256, 1 << 16), device=self.dev) * 2
              - 1).to(torch.int8)
        int_mm = 16 * self.event_ms(lambda: torch._int_mm(pm, hm), 5)
        del pm, hm
        row = rows[K5_TIMED[0][0]]
        for form in forms:
            self.kernels[form].update(
                max_abs_err=err[form], ms=row[f"{form}_ms"], plain_ms=plain_ms,
                library_ms=None, int_mm_yardstick_ms=int_mm, ms_at=rows)
            self.bound(self.kernels[form], "tc_bound_ms",
                       **self.k5_work(q, tmax, k, True))
        self.bound(self.kernels["K5"], "bound_ms", "bound_by",
                   **self.k5_work(q, tmax, k, True))
        self.bound(self.kernels["K5-popc"], "bound_ms", "bound_by",
                   **self.k5_work(q, tmax, k))
        return {"K5_checks": checks, "K5_max_abs_err": err,
                "K5_ms_at": rows, "K5_plain_ms": plain_ms,
                "K5_shapes": "T=2^20 k=10; the kernels line: Q=6400, bound "
                             "25",
                "int_mm_6400x256x2^20_ms": round(int_mm, 4)}

    @staticmethod
    def k5_work(q, t, k, tc=False):
        """Four __popcll (8 POPC) a pair, the bound of the popcount form;
        ``tc``: the function's bound, its +-1 product over K = 256 (512
        tensor operations a pair at the int8 rate) and a compare a pair, as
        mma_work counts K1-mma's.  32 bytes and a validity byte a row, 32
        bytes a needle, k distances and rows written."""
        nbytes = 33 * t + 32 * q + 8 * q * k
        if tc:
            return dict(nbytes=nbytes, alu=q * t, int_ops=q * t,
                        tc_ops=512 * q * t, tc_rate=TC_INT8_OPS_PER_S)
        return dict(nbytes=nbytes, popc=8 * q * t)

    def feat_images(self, count: int, rng):
        """Seeded textured images, long sides 300-1200 px."""
        out = []
        for _ in range(count):
            long_side = int(rng.integers(300, 1201))
            short = int(long_side * rng.uniform(0.6, 1.0))
            h, w = (long_side, short) if rng.random() < 0.5 else \
                (short, long_side)
            out.append(textured(rng, h, w))
        return out

    def feat_phase(self):
        """The ingest half: extract_features_batch on the card (images/s),
        its steps timed apart, and 8 images against the CPU path."""
        torch = self.torch
        from cbird_tpu_torch.ops import orb
        rng = np.random.default_rng(SEED + 20)
        imgs = self.feat_images(FEAT_IMAGES, rng)
        chunk = 64  # extract_features_batch's chunk on a card
        orb.extract_features_batch(imgs[:chunk], device=self.dev)  # warm-up
        wall, feats = self.timed(
            lambda: orb.extract_features_batch(imgs, device=self.dev))
        out = {"images": len(imgs), "images_per_s": round(
            len(imgs) / wall * 1e3, 1),
               "keypoints_per_image": round(float(np.mean(
                   [len(d) for d, _ in feats])), 1),
               "hashes_per_image": round(float(np.mean(
                   [len(h) for _, h in feats])), 1)}
        # the steps, apart: the host's prescale and pack (and the copy to
        # the card), the pyramid and the ROI hashes (CUDA events)
        host_ms = pyr_ms = roi_ms = 0.0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        for s0 in range(0, len(imgs), chunk):
            t0 = time.perf_counter()
            canvas, sizes = orb.pack_chunk(
                [orb._prescale(g) for g in imgs[s0:s0 + chunk]], self.dev)
            host_ms += (time.perf_counter() - t0) * 1e3
            ev[0].record()
            res = orb.orb_pyramid(canvas, sizes, KP)
            ev[1].record()
            boxes, ok = orb.roi_boxes(res["xs"], res["ys"], res["size"],
                                      res["valid"], sizes[:, 0], sizes[:, 1])
            orb.roi_hashes(canvas, boxes, ok)
            ev[2].record()
            torch.cuda.synchronize()
            pyr_ms += ev[0].elapsed_time(ev[1])
            roi_ms += ev[1].elapsed_time(ev[2])
        out.update(host_prescale_pack_ms=round(host_ms, 1),
                   pyramid_device_ms=round(pyr_ms, 1),
                   roi_hash_device_ms=round(roi_ms, 1))
        out.update(self.feat_cpu_check(imgs[:FEAT_CPU]))
        return out

    def feat_cpu_check(self, imgs):
        """The same images on the card (one chunk) and through the CPU path
        (chunks of 16, its default): every output of ORB (keypoints,
        responses, angles, descriptors) equal, and the ROI hashes equal
        but for flat ROIs (their 64 coefficients below 1e-6 of the DC term
        in float64: float noise of the DCT's rounding, where a last-ulp
        difference of the resize in float64 moves every bit; counted
        apart).  Then FEAT_ALONE of them one at a time on the card: the
        same features, bit for bit, as in the chunk (the flat ROIs' hashes
        again counted apart).  Any other difference fails the phase."""
        from cbird_tpu_torch.ops import orb
        pre = [orb._prescale(g) for g in imgs]

        def run(dev, chunk):
            parts = []
            for s0 in range(0, len(pre), chunk):
                canvas, sizes = orb.pack_chunk(pre[s0:s0 + chunk], dev)
                parts.append({k: v.cpu().numpy() for k, v in
                              orb.features_chunk(canvas, sizes, KP).items()})
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        g, c = run(self.dev, len(pre)), run("cpu", 16)
        live = g["valid"] | c["valid"]
        same = (g["xs"] == c["xs"]) & (g["ys"] == c["ys"]) & \
            (g["valid"] == c["valid"])
        kp = same & g["valid"]
        dbits = np.bitwise_count(g["desc"] ^ c["desc"]).sum(axis=2)[kp]
        both = g["hash_ok"] & c["hash_ok"]
        flat = self.flat_rois(pre, g, both)
        hdiff = (g["hash"] != c["hash"]) | (g["hash_ok"] != c["hash_ok"])
        out = {"cpu_images": len(imgs),
               "keypoint_agreement": float((same & live).sum()
                                           / max(live.sum(), 1)),
               "keypoints_compared": int(live.sum()),
               "descriptors_compared": int(kp.sum()),
               "descriptors_with_flip": int(np.count_nonzero(dbits)),
               "descriptor_bits_differing": int(dbits.sum()),
               "orb_outputs_differing": {k: int((g[k] != c[k]).sum()) for k in
                                         orb.KEYS},
               "roi_hashes_compared": int((both & ~flat).sum()),
               "roi_hashes_differing": int((hdiff & ~flat).sum()),
               "flat_rois": int((both & flat).sum()),
               "flat_roi_hashes_differing": int((hdiff & flat).sum())}
        if (any(out["orb_outputs_differing"].values())
                or out["roi_hashes_differing"]):
            raise AssertionError(f"card against CPU: {out}")
        alone_diff, alone_flat = {}, 0
        for n in range(FEAT_ALONE):
            canvas, sizes = orb.pack_chunk(pre[n:n + 1], self.dev)
            one = {k: v.cpu().numpy()[0] for k, v in
                   orb.features_chunk(canvas, sizes, KP).items()}
            for k, v in one.items():
                d = v != g[k][n]
                if k == "hash":
                    alone_flat += int((d & flat[n]).sum())
                    d &= ~flat[n]
                if d.any():
                    alone_diff[f"image {n} {k}"] = int(d.sum())
        out.update(alone_images=FEAT_ALONE, alone_differing=alone_diff,
                   alone_flat_roi_hashes_differing=alone_flat)
        if alone_diff:
            raise AssertionError(f"one image at a time against the chunk of "
                                 f"{len(pre)}: {alone_diff}")
        return out

    def flat_rois(self, pre, res, mask):
        """[B, K] bool: the ROIs under ``mask`` whose 64 hash coefficients
        are all below 1e-6 of the DC term (float64, on the CPU)."""
        torch = self.torch
        from cbird_tpu_torch.ops import dct_hash as dh
        from cbird_tpu_torch.ops import orb
        out = np.zeros(mask.shape, bool)
        for n, img in enumerate(pre):
            h, w = img.shape
            t = lambda k: torch.from_numpy(res[k][n:n + 1])
            boxes, _ = orb.roi_boxes(t("xs"), t("ys"), t("size"), t("valid"),
                                     torch.tensor([h]), torch.tensor([w]))
            sel = np.nonzero(mask[n])[0]
            if not len(sel):
                continue
            bx = boxes[0][torch.from_numpy(sel)]
            top, bottom, left, right = bx.unbind(1)
            rb = dh._blur_radius((bottom - top) * (right - left))
            mh = dh._axis_map(top, bottom - top, rb, 32, h).double()
            mw = dh._axis_map(left, right - left, rb, 32, w).double()
            f = mh @ torch.from_numpy(np.array(img)).double() \
                @ mw.transpose(1, 2)
            d = torch.as_tensor(dh._D32).double()
            f = d @ f @ d.T
            v = f[:, :9, :9].reshape(-1, 81)[:, torch.as_tensor(dh._ZZ64)]
            out[n, sel] = (v.abs().max(dim=1).values
                           < 1e-6 * f[:, 0, 0].abs()).numpy()
        return out

    @staticmethod
    def feature_groups(images: int, rng):
        """FEAT_GROUPS planted crop groups: (source id, [copy ids])."""
        pick = rng.choice(np.arange(1, images + 1), size=3 * FEAT_GROUPS,
                          replace=False).reshape(FEAT_GROUPS, 3)
        return [(int(a), [int(b), int(c)]) for a, b, c in pick]

    def fdct_index(self, rng):
        """A DctFeaturesIndex of FDCT_IMAGES x KP random keypoint hashes
        (2^22 rows): in each planted group, each copy's first 150 hashes
        are 150 of its source's with 0-2 bits flipped.
        @return (index, hashes, ids, groups)"""
        from cbird_tpu_torch.index.dct_features_index import DctFeaturesIndex
        from cbird_tpu_torch.ops.hamming import PackedHashStore
        hashes = rng.integers(1, 2**64, size=FDCT_IMAGES * KP,
                              dtype=np.uint64)
        ids = np.repeat(np.arange(1, FDCT_IMAGES + 1, dtype=np.uint32), KP)
        groups = self.feature_groups(FDCT_IMAGES, rng)
        for src, copies in groups:
            for c in copies:
                take = (src - 1) * KP + rng.choice(KP, 150, replace=False)
                rows = (c - 1) * KP + np.arange(150)
                hashes[rows] = self.flip_bits(hashes[take], rng.integers(
                    0, 3, 150), rng)
        idx = DctFeaturesIndex(self.dev)
        idx._store = PackedHashStore(hashes, ids, device=self.dev)
        idx._loaded = True
        return idx, hashes, ids, groups

    @staticmethod
    def check_feature_groups(votes: dict, groups, what: str):
        """Every planted copy in its source's list and the source in each
        copy's (``votes``: id -> set of matched ids)."""
        for src, copies in groups:
            for c in copies:
                if c not in votes.get(src, ()) or src not in votes.get(c, ()):
                    raise AssertionError(f"{what}: planted {src}-{c} missed")

    def fdct_phase(self):
        torch = self.torch
        from cbird_tpu_torch.ops import band_count as bc
        from cbird_tpu_torch.ops import hamming_topk as tk
        from cbird_tpu_torch.params import SearchParams
        from cbird_tpu_torch.store.media import Media
        rng = np.random.default_rng(SEED + 21)
        idx, hashes, ids, groups = self.fdct_index(rng)
        store = idx._store
        store._device_arrays()
        sp = SearchParams()
        k3, k4 = bc.band_counts.launches, tk.hamming_topk.launches
        wall, (out_ids, lists) = self.timed(lambda: idx.find_all(sp))
        if store.pigeonhole is None or bc.band_counts.launches == k3 \
                or tk.hamming_topk.launches == k4:
            raise AssertionError("find_all did not take the pigeonhole "
                                 "path, K3 and K4")
        votes = {int(i): set(l[0].tolist()) for i, l in zip(out_ids, lists)}
        self.check_feature_groups(votes, groups, "fdct -similar")
        out = {"rows": len(hashes), "images": FDCT_IMAGES,
               "similar_wall_ms": round(wall, 1),
               "images_with_matches": len(votes),
               "pigeonhole_s": store.pigeonhole["s"]}
        # -similar-to: 16 unstored needle images, the sources' hashes
        needles = []
        for src, _ in groups[:FEAT_NEEDLES]:
            m = Media(f"/needle/{src}.png")
            m.keyPointHashes = hashes[(src - 1) * KP:src * KP]
            needles.append(m)
        wall, res = self.timed(lambda: idx.find_batch(needles, sp))
        for (src, copies), ms in zip(groups, res):
            got = {m.mediaId for m in ms}
            if got != votes[src]:
                raise AssertionError(f"fdct -similar-to of {src}: {got} "
                                     f"against -similar's {votes[src]}")
        out["similar_to_wall_ms"] = round(wall, 1)
        out["similar_to_hashes"] = FEAT_NEEDLES * KP
        # candidate lists of 256 sampled rows against numpy
        with self.uncounted():
            planted = np.concatenate([np.arange((c - 1) * KP, (c - 1) * KP
                                                + 150)
                                      for _, cs in groups for c in cs])
            rows = np.r_[rng.choice(planted, 128, replace=False),
                         rng.choice(len(hashes), 128, replace=False)]
            res = store.search(hashes[rows], T, k=30)
            hits = 0
            for r, (got_ids, got_d) in zip(rows, res):
                d = np.bitwise_count(hashes ^ hashes[r]).astype(np.int32)
                near = np.nonzero(d < T)[0]
                o = np.lexsort((near, d[near]))[:30]
                if not (np.array_equal(got_ids, ids[near[o]])
                        and np.array_equal(got_d, d[near[o]])):
                    raise AssertionError(f"fdct row {r}: candidates differ "
                                         f"from numpy")
                hits += len(o)
        out.update(rows_checked=len(rows), checked_candidates=hits)
        del idx, store
        torch.cuda.empty_cache()
        return out

    def orb_index(self, rng):
        """A CvFeaturesIndex of ORB_IMAGES x KP random descriptors (2^20
        rows): in each planted group, each copy's first 200 descriptors are
        200 of its source's with 0-20 of 256 bits flipped.
        @return (index, descriptors [T, 8] uint32, groups)"""
        from cbird_tpu_torch.index.cv_features_index import CvFeaturesIndex
        desc = rng.integers(0, 2**32, size=(ORB_IMAGES * KP, 8),
                            dtype=np.uint32)
        ids = np.repeat(np.arange(1, ORB_IMAGES + 1, dtype=np.uint32), KP)
        groups = self.feature_groups(ORB_IMAGES, rng)
        for src, copies in groups:
            for c in copies:
                take = (src - 1) * KP + rng.choice(KP, 200, replace=False)
                rows = (c - 1) * KP + np.arange(200)
                bits = rng.integers(0, 21, 200)
                keys = rng.random((200, 256)).argsort(axis=1)
                flip = np.zeros((200, 256), bool)
                for b in range(20):
                    on = bits > b
                    flip[np.nonzero(on)[0], keys[on, b]] = True
                desc[rows] = desc[take] ^ np.packbits(
                    flip, axis=1, bitorder="little").view(np.uint32)
        idx = CvFeaturesIndex(self.dev)
        idx._store.add(desc, ids)
        idx._loaded = True
        return idx, desc, groups

    def orb_phase(self):
        torch = self.torch
        from cbird_tpu_torch.index.cv_features_index import (
            CvFeaturesIndex, KNN)
        from cbird_tpu_torch.ops import hamming_lanes as hl
        from cbird_tpu_torch.params import SearchParams
        from cbird_tpu_torch.store.media import Media
        rng = np.random.default_rng(SEED + 22)
        idx, desc, groups = self.orb_index(rng)
        idx._store.device_arrays()
        sp = SearchParams()
        out = {"rows": len(desc), "images": ORB_IMAGES}
        # -similar-to: 16 unstored needle images, the sources' descriptors
        needles = []
        for src, _ in groups[:FEAT_NEEDLES]:
            m = Media(f"/needle/{src}.png")
            m.keyPointDescriptors = desc[(src - 1) * KP:src * KP].view(
                np.uint8).reshape(KP, 32)
            needles.append(m)
        k5 = hl.hamming_lanes_topk.launches
        wall, res = self.timed(lambda: idx.find_batch(needles, sp))
        if hl.hamming_lanes_topk.launches == k5:
            raise AssertionError("K5 did not run for -similar-to")
        for (src, copies), ms in zip(groups, res):
            got = {m.mediaId for m in ms}
            if not {src, *copies} <= got:
                raise AssertionError(f"orb -similar-to of {src}: {got}")
        out.update(similar_to_wall_ms=round(wall, 1),
                   similar_to_descriptors=FEAT_NEEDLES * KP)
        # -similar over the images of the first ORB_SIMILAR_ROWS rows: every
        # stored descriptor of theirs a needle
        first = range(1, ORB_SIMILAR_ROWS // KP + 1)
        wall, res = self.timed(lambda: idx.find_batch(
            [Media(id=i) for i in first], sp))
        votes = {i: {m.mediaId for m in ms} for i, ms in zip(first, res)}
        inside = [(s, c) for s, c in groups if s in votes]
        for src, copies in inside:
            if not set(copies) <= votes[src]:
                raise AssertionError(f"orb -similar: planted {src} missed")
        out.update(similar_needles=len(first) * KP,
                   similar_wall_ms=round(wall, 1),
                   similar_groups_checked=len(inside))
        # votes against the plain path's on 64 sampled needle images
        with self.uncounted():
            hd, vd = idx._store.device_arrays()
            sample = rng.choice(np.arange(1, ORB_IMAGES + 1), 64,
                                replace=False)
            for i in sample:
                nd = torch.from_numpy(desc[(i - 1) * KP:i * KP].view(
                    np.int64).copy()).to(self.dev)
                got = hl.hamming_lanes_topk(nd, hd, vd, KNN, sp.cvThresh)
                want = hl.hamming_lanes_topk_plain(nd, hd, vd, KNN,
                                                   sp.cvThresh)
                self.same(got[0], want[0], "K5 votes")
                self.same(got[1], want[1], "K5 votes")
                ids = np.r_[idx._store.ids, np.uint32(0)]
                vote = [CvFeaturesIndex._vote(
                    r[0].cpu().numpy(), ids[r[1].cpu().numpy()], sp)
                    for r in (got, want)]
                if [(m.mediaId, m.score) for m in vote[0]] != \
                        [(m.mediaId, m.score) for m in vote[1]]:
                    raise AssertionError(f"orb votes of {i} differ")
        out["vote_needles_checked"] = len(sample)
        del idx
        torch.cuda.empty_cache()
        return out

    def fcli_phase(self):
        """The CLI with -p.alg fdct and orb over FCLI_SOURCES textured
        sources, each with a crop and a 0.75 scale: -create -update
        -similar -similar-to on the card; the groups against the same CLI
        run with CBIRD_TORCH_DEVICE=cpu in a subprocess."""
        import shutil
        from PIL import Image
        from cbird_tpu_torch.cli.main import main
        from cbird_tpu_torch.ops import hamming_lanes as hl
        rng = np.random.default_rng(SEED + 23)
        here = os.path.dirname(os.path.abspath(__file__))
        out = {}
        with tempfile.TemporaryDirectory() as top:
            d = os.path.join(top, "card")
            os.makedirs(d)
            owner = {}
            for s in range(FCLI_SOURCES):
                im = Image.fromarray(textured(rng, 320, 400))
                for name, v in (("src", im),
                                ("crop", im.crop((50, 30, 350, 290))),
                                ("s75", im.resize((300, 240), Image.BOX))):
                    path = os.path.join(d, f"s{s:02d}_{name}.png")
                    v.save(path)
                    owner[os.path.basename(path)] = s
            cpu_src = os.path.join(top, "cpu")
            shutil.copytree(d, cpu_src)
            args = ["-i.algos", "dct+fdct+orb"]
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(["-use", d, *args, "-create", "-update"])
            if rc:
                raise AssertionError(f"-update rc {rc}")
            out["update_s"] = round(time.perf_counter() - t0, 3)
            k5 = hl.hamming_lanes_topk.launches
            card = {}
            for alg in ("fdct", "orb"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = main(["-use", d, "-p.alg", alg, "-similar",
                               "-json"])
                if rc:
                    raise AssertionError(f"{alg} -similar rc {rc}")
                card[alg] = groups_of(buf.getvalue())
                joined = joined_sources(card[alg], owner)
                out[f"{alg}_groups"] = len(card[alg])
                out[f"{alg}_sources_joined"] = joined
                if joined != FCLI_SOURCES:
                    raise AssertionError(f"{alg}: only {joined} sources "
                                         f"joined their 3 variants")
                src = FCLI_SOURCES // 3
                needle = os.path.join(d, f"s{src:02d}_src.png")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = main(["-use", d, "-p.alg", alg, "-similar-to",
                               needle, "-json"])
                hit = json.loads(buf.getvalue())
                got = {owner[os.path.basename(m["path"])]
                       for m in hit[0]["matches"]} if hit else set()
                if rc or src not in got:
                    raise AssertionError(f"{alg} -similar-to missed: {got}")
                out[f"{alg}_similar_to_matches"] = len(hit[0]["matches"])
            if hl.hamming_lanes_topk.launches == k5:
                raise AssertionError("K5 did not run in the fcli phase")
            code = (
                "import contextlib, io, json, sys\n"
                "from cbird_tpu_torch.cli.main import main\n"
                "d = sys.argv[1]\n"
                "res = {}\n"
                "with contextlib.redirect_stdout(io.StringIO()):\n"
                "    assert main(['-use', d, '-i.algos', 'dct+fdct+orb',"
                " '-create', '-update']) == 0\n"
                "for alg in ('fdct', 'orb'):\n"
                "    buf = io.StringIO()\n"
                "    with contextlib.redirect_stdout(buf):\n"
                "        assert main(['-use', d, '-p.alg', alg, '-similar',"
                " '-json']) == 0\n"
                "    res[alg] = json.loads(buf.getvalue())\n"
                "print(json.dumps(res))\n")
            env = dict(os.environ, CBIRD_TORCH_DEVICE="cpu",
                       PYTHONPATH=here)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", code, cpu_src], env=env, cwd=here,
                capture_output=True, text=True, timeout=900)
            if proc.returncode:
                raise AssertionError(f"cpu run: {proc.stderr[-2000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            for alg in ("fdct", "orb"):
                cpu = groups_of(json.dumps(res[alg]))
                if cpu != card[alg]:
                    raise AssertionError(
                        f"{alg}: the card's groups differ from the CPU "
                        f"run's: {sorted(card[alg] ^ cpu)[:4]}")
            out["cpu_run_s"] = round(time.perf_counter() - t0, 1)
        return out

    # ---- the color algorithm ---------------------------------------------
    @staticmethod
    def color_images(count: int, rng):
        """Seeded RGB images of 64-256 px a side (``color_image``)."""
        return [color_image(rng, int(rng.integers(64, 257)),
                            int(rng.integers(64, 257)))
                for _ in range(count)]

    def color_store(self, rng, hist=None):
        """The color phase's store: COLOR_ROWS descriptors with the planted
        groups.  @return (descs, ids, groups)"""
        descs = self.color_rows(COLOR_ROWS, rng, hist)
        groups = self.color_groups(descs, rng)
        return descs, np.arange(1, COLOR_ROWS + 1, dtype=np.uint32), groups

    def color_rows(self, n: int, rng, hist=None):
        """``n`` quantized color descriptors [n, 33, 4] uint16: random
        colors, weights descending, numColors drawn from ``hist`` ({count:
        images}, default mostly 31)."""
        hist = hist or {31: 90, 30: 4, 29: 3, 28: 2, 27: 1}
        counts = np.array(list(hist))
        p = np.array([hist[c] for c in counts], np.float64)
        descs = np.zeros((n, 33, 4), np.uint16)
        descs[:, :32, :3] = rng.integers(0, 65536, (n, 32, 3),
                                         dtype=np.uint16)
        descs[:, :32, 3] = np.linspace(65535, 2000, 32).astype(np.uint16)
        descs[:, 32, 0] = rng.choice(counts, n, p=p / p.sum())
        return descs

    def color_device(self, descs):
        """Descriptors -> (colors [n, 32, 3] f32, counts [n] i32) on the card,
        as PackedColorStore dequantizes them."""
        from cbird_tpu_torch.ops.color import dequantize_luv
        torch = self.torch
        return (torch.from_numpy(dequantize_luv(descs[:, :32, :3])).to(
            self.dev), torch.from_numpy(descs[:, 32, 0].astype(np.int32)).to(
            self.dev))

    @staticmethod
    def k6_work(nn, hn, hv, side: str = "both"):
        """The FP32 instructions K6's scored pairs need (3 subtracts, a
        multiply, 2 FMAs and a min a color pair, over the counts; a sqrt,
        a compare and an add a color of the side that drives the sum), from
        the histograms of the needle and live row counts; bytes: each needle
        (384 + 4), each row (384 + 4 + 1) and each [Q, C] score once."""
        import chip_bounds
        a = np.bincount(nn.cpu().numpy(), minlength=33).astype(np.float64)
        hv = hv.cpu().numpy()
        b = np.bincount(hn.cpu().numpy()[hv], minlength=33).astype(
            np.float64)
        ops = 0.0
        for x in range(1, 33):
            for y in range(1, 33):
                if side == "both" and abs(x - y) > 2:
                    continue
                outer = max(x, y) if side == "both" else \
                    (x if side == "ab" else y)
                ops += a[x] * b[y] * (chip_bounds.K6_STEP_INSNS * x * y
                                      + 3 * outer)
        q, c = len(nn), len(hn)
        return dict(nbytes=388 * q + 389 * c + 4 * q * c, fp32=ops)

    def k6_rate(self) -> float:
        """FP32 instructions a clock per SM that chip_bounds.py's probe of
        K6's color-pair step sustains (its clock from clock64): a
        diagnostic printed beside K6's bound, which takes the card's peak,
        FP32_PER_CLK."""
        import chip_bounds
        torch = self.torch
        if self.probes is None:
            self.sm_clock()
        iters = 1 << 16
        pr = self.probes
        pr.run(chip_bounds.K6_STEP_OP, iters)
        torch.cuda.synchronize()
        mhz = pr.clock64_mhz()["median"]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        pr.run(chip_bounds.K6_STEP_OP, iters)
        b.record()
        torch.cuda.synchronize()
        steps = pr.blocks * chip_bounds.THREADS * chip_bounds.CHAINS * iters
        rate = chip_bounds.K6_STEP_INSNS * steps / (
            a.elapsed_time(b) * 1e-3 * SMS * mhz * 1e6)
        return rate

    def k6_operands(self, rng):
        """K6's operands on the card: a COLOR_ROWS-row store (counts from
        color_rows' histogram, 1% invalid; counts 0-32 in each warp of its
        first 64 rows) and K6_TIMED[0] needles, near copies of its rows
        (counts 0-32 in the first 8).  @return (nc, nn, hc, hn, hv)"""
        torch = self.torch
        hc, hn = self.color_device(self.color_rows(COLOR_ROWS, rng))
        hv = torch.from_numpy(rng.random(COLOR_ROWS) > 0.01).to(self.dev)
        hn[:64] = torch.tensor([0, 1, 2, 30, 31, 32, 28, 29] * 8,
                               dtype=torch.int32)
        pick = torch.from_numpy(rng.integers(0, COLOR_ROWS,
                                             K6_TIMED[0])).to(self.dev)
        nc, nn = hc[pick].clone(), hn[pick].clone()
        nc[:, :, 1] += 0.5  # near copies, not equal
        nn[:8] = torch.tensor([0, 1, 30, 31, 32, 31, 29, 33 - 1],
                              dtype=torch.int32)
        return nc, nn, hc, hn, hv

    def k6_kernels(self):
        """K6 against its plain twin, bit for bit: at K6_Q x K6_C for the
        two-sided form and both one-sided forms with a row window; at
        K6_TIMED (timed, with the plain twin once and torch.cdist of the
        colors alone at a small shape as yardsticks); and the color top-k
        of K6_TOPK_NEEDLES needles over a 2^20-row store."""
        torch = self.torch
        from cbird_tpu_torch.ops import color as pc
        from cbird_tpu_torch.ops import color_scores as cs
        rng = np.random.default_rng(SEED + 30)
        nc, nn, hc, hn, hv = self.k6_operands(rng)
        q, c = K6_TIMED
        err, checks = 0.0, 0
        for qn in K6_Q:
            for cn in K6_C:
                for side, kw in (("both", {}),
                                 ("ab", dict(lo=3, hi=cn - 2, base=1)),
                                 ("ba", dict(lo=0, hi=cn, base=0))):
                    args = (nc[:qn], nn[:qn], hc[:cn], hn[:cn], hv[:cn])
                    got = cs.color_scores(*args, side=side, **kw)
                    torch.cuda.synchronize()
                    want = cs.color_scores_plain(*args, side=side, **kw)
                    err = max(err, self.same(got, want,
                                             f"K6 {side} q={qn} c={cn}"))
                    checks += 1
        # warps whose rows straddle the needles' counts (rows of 28-32
        # colors, needles of 29-31): the two-sided form's mixed warps
        mix_n = torch.from_numpy(rng.integers(29, 32, 64).astype(
            np.int32)).to(self.dev)
        mix_h = torch.from_numpy(rng.integers(28, 33, 4097).astype(
            np.int32)).to(self.dev)
        for qn, cn in ((33, 129), (64, 4097)):
            for side in ("both", "ab", "ba"):
                args = (nc[:qn], mix_n[:qn], hc[:cn], mix_h[:cn], hv[:cn])
                got = cs.color_scores(*args, side=side)
                torch.cuda.synchronize()
                want = cs.color_scores_plain(*args, side=side)
                err = max(err, self.same(got, want, f"K6 {side} mixed warps "
                                                    f"q={qn} c={cn}"))
                checks += 1
        # the one-sided launch of color -similar: needles against a window
        # of K6_WINDOW rows, each side timed beside its plain twin (one
        # call, the scores of every needle checked)
        one = {}
        for side in ("ab", "ba"):
            args = (nc, nn, hc[:K6_WINDOW], hn[:K6_WINDOW], hv[:K6_WINDOW])
            buf = torch.empty((q, K6_WINDOW), dtype=torch.float32,
                              device=self.dev)
            one[side] = self.event_ms(lambda: cs.color_scores(
                *args, side=side, out=buf), 3)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            want = cs.color_scores_plain(*args, side=side)
            b.record()
            torch.cuda.synchronize()
            one[f"{side}_plain"] = a.elapsed_time(b)
            err = max(err, self.same(buf, want,
                                     f"K6 {side} at {q} x {K6_WINDOW}"))
            checks += 1
            del want
            one[f"{side}_work"] = self.k6_work(nn, hn[:K6_WINDOW],
                                               hv[:K6_WINDOW], side)
            del buf
        args = (nc, nn, hc[:c], hn[:c], hv[:c])
        buf = torch.empty((q, c), dtype=torch.float32, device=self.dev)
        ms = self.event_ms(lambda: cs.color_scores(*args, out=buf), 3)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = cs.color_scores_plain(*args)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        err = max(err, self.same(buf, want, "K6 at the timed shape"))
        del want, buf
        # the top-k over the whole store: K6, chunks' stable sorts, merge;
        # needle 8 has 101 rows at its best score, across a chunk edge
        # (4096) and the k boundary: the lower rows win
        src = COLOR_ROWS - 1000
        hc[4090:4190], hn[4090:4190] = hc[src], hn[src]
        hv[4090:4190] = True
        hv[src] = True
        nc[8], nn[8] = hc[src], hn[src]
        nd = slice(8, 8 + K6_TOPK_NEEDLES)
        got = pc.color_topk(nc[nd], nn[nd], hc, hn, hv, k=64)
        want = (cs.color_scores_plain(nc[nd], nn[nd], hc, hn, hv)
                .sort(dim=1, stable=True))
        err = max(err, self.same(got[0], want.values[:, :64], "K6 top-k"),
                  self.same(got[1], want.indices[:, :64], "K6 top-k rows"))
        if int((got[0][0] == got[0][0, 0]).sum()) != 64:
            raise AssertionError("K6 top-k: the planted ties did not fill k")
        del want
        # yardstick: the distances alone, torch.cdist of 64 needles' colors
        # against 1024 rows' ([2048, 3] x [32768, 3])
        ya, yb = nc[:64].reshape(-1, 3), hc[:1024].reshape(-1, 3)
        cdist_ms = self.event_ms(lambda: torch.cdist(ya, yb), 5)
        k6_small = self.event_ms(lambda: cs.color_scores(
            nc[:64], nn[:64], hc[:1024], hn[:1024], hv[:1024]), 5)
        probed = self.k6_rate()
        w = K6_WINDOW
        self.kernels["K6"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
            cdist_yardstick_ms=cdist_ms, ms_at_cdist_shape=k6_small,
            probed_k6_step_per_clk_sm=probed,
            shape=f"Q={q} C={c} (two-sided)", ab_window_ms=one["ab"],
            ba_window_ms=one["ba"], ab_window_plain_ms=one["ab_plain"],
            ba_window_plain_ms=one["ba_plain"],
            window_shape=f"Q={q} C={w} (one-sided)")
        work = self.k6_work(nn, hn[:c], hv[:c])
        self.bound(self.kernels["K6"], "bound_ms", "bound_by", **work)
        for side in ("ab", "ba"):
            self.bound(self.kernels["K6"], f"{side}_window_bound_ms",
                       **one[f"{side}_work"])
        out = {"K6_checks": checks, "K6_max_abs_err": err,
               "K6_ms": round(ms, 4), "K6_plain_ms": round(plain_ms, 4),
               "K6_ab_window_ms": round(one["ab"], 4),
               "K6_ba_window_ms": round(one["ba"], 4),
               "K6_ab_window_plain_ms": round(one["ab_plain"], 4),
               "K6_ba_window_plain_ms": round(one["ba_plain"], 4),
               "K6_cdist_64x1024_ms": round(cdist_ms, 4),
               "K6_64x1024_ms": round(k6_small, 4),
               "K6_probed_step_per_clk_sm": round(probed, 2),
               "K6_shape": f"Q={q} C={c}; one-sided Q={q} C={w}"}
        self.bound(out, "K6_bound_ms", **work)
        return out

    def color_groups(self, descs, rng):
        """Plants COLOR_GROUPS groups of 4 in the first COLOR_SIMILAR_ROWS
        rows: three near copies of a source (each Luv coordinate within 2
        quantization steps, the same numColors).  @return [G, 4] rows"""
        rows = rng.choice(COLOR_SIMILAR_ROWS, 4 * COLOR_GROUPS,
                          replace=False).reshape(COLOR_GROUPS, 4)
        for g in rows:
            for r in g[1:]:
                descs[r] = descs[g[0]]
                jit = rng.integers(-2, 3, (32, 3))
                descs[r, :32, :3] = np.clip(
                    descs[g[0], :32, :3].astype(np.int64) + jit, 0, 65535)
        return rows

    @staticmethod
    def color_needles(descs, groups):
        """Unstored needle media carrying the groups' sources' descriptors
        (-similar-to FILE)."""
        from cbird_tpu_torch.store.media import Media
        needles = []
        for g in groups:
            m = Media(f"/needle/{g[0]}.png")
            m.colorDescriptor = descs[g[0]]
            needles.append(m)
        return needles

    @staticmethod
    def color_index(descs, ids, device):
        from cbird_tpu_torch.index.color_desc_index import ColorDescIndex
        idx = ColorDescIndex(device)
        idx._store.add(descs, ids)
        idx._loaded = True
        idx._store.device_arrays()
        return idx

    def cdesc_phase(self):
        """create_descriptors on the card over CDESC_IMAGES images;
        CDESC_CPU of them against the port's CPU run."""
        from cbird_tpu_torch.ops import color as pc
        imgs = self.color_images(CDESC_IMAGES,
                                 np.random.default_rng(SEED + 31))
        pc.create_descriptors(imgs[:16], device=self.dev)  # warm-up
        dt, descs = self.timed(lambda: pc.create_descriptors(
            imgs, device=self.dev))
        hist: dict = {}
        for d in descs:
            if d is not None:
                c = int(d[32, 0])
                hist[c] = hist.get(c, 0) + 1
        if not hist:
            raise AssertionError("no descriptor made")
        self.color_hist = hist
        t0 = time.perf_counter()
        cpu = pc.create_descriptors(imgs[:CDESC_CPU], device="cpu")
        cpu_s = time.perf_counter() - t0
        equal, diffs = 0, []
        for i, (a, b) in enumerate(zip(descs, cpu)):
            if (a is None) != (b is None):
                diffs.append({"image": i, "none": [a is None, b is None]})
            elif a is None or np.array_equal(a, b):
                equal += 1
            else:
                # each differing entry: (row, column, card, cpu)
                diffs.append({"image": i, "entries": [
                    [int(r), int(c), int(a[r, c]), int(b[r, c])]
                    for r, c in np.argwhere(a != b)][:8]})
        return {"images": len(imgs), "wall_ms": round(dt, 1),
                "images_per_s": round(len(imgs) / (dt / 1e3), 1),
                "descriptors": sum(d is not None for d in descs),
                "num_colors_hist": {str(k): hist[k] for k in sorted(hist)},
                "cpu_compared": CDESC_CPU, "cpu_equal": equal,
                "cpu_differences": diffs, "cpu_s": round(cpu_s, 2)}

    def color_phase(self):
        """-similar-to over a 2^20-row color store, -similar over its first
        2^16 rows, the scan path against the bucketed one over 2^14."""
        torch = self.torch
        from cbird_tpu_torch.ops import color_scores as cs
        from cbird_tpu_torch.params import SearchParams
        descs, ids, groups = self.color_store(
            np.random.default_rng(SEED + 32),
            getattr(self, "color_hist", None))
        idx = self.color_index(descs, ids, self.dev)
        sp = SearchParams()
        out = {"rows": COLOR_ROWS, "groups": COLOR_GROUPS}
        needles = self.color_needles(descs, groups)
        k6 = cs.color_scores.launches
        wall, res = self.timed(lambda: idx.find_batch(needles, sp))
        warm, _ = self.timed(lambda: idx.find_batch(needles, sp))
        if cs.color_scores.launches == k6:
            raise AssertionError("K6 did not run for -similar-to")
        for g, ms in zip(groups, res):
            got = {m.mediaId for m in ms}
            if not set(ids[g]) <= got:
                raise AssertionError(f"color -similar-to of {g[0]}: {got}")
        with self.uncounted():  # K6 alone at this launch's shape
            nc, nn = self.color_device(np.stack([descs[g[0]]
                                                 for g in groups]))
            hc, hn, hv = idx._store.device_arrays()
            k6_ms = self.event_ms(lambda: cs.color_scores(nc, nn, hc, hn, hv),
                                  5)
        out.update(similar_to_wall_ms=round(wall, 1),
                   similar_to_warm_ms=round(warm, 1),
                   similar_to_k6_ms=round(k6_ms, 3))
        del idx
        torch.cuda.empty_cache()
        # -similar: find_all (count-bucketed) over the first 2^16 rows
        n = COLOR_SIMILAR_ROWS
        idx = self.color_index(descs[:n], ids[:n], self.dev)
        wall, (_, raw) = self.timed(lambda: idx.find_all(sp))
        for g in groups:
            if not set(ids[g]) <= set(raw.get(int(g[0]), ((),))[0]):
                raise AssertionError(f"color -similar missed group {g}")
        out.update(similar_rows=n, similar_wall_ms=round(wall, 1),
                   similar_rows_with_hits=len(raw))
        # the scan path against the bucketed one over 2^14 rows
        n = COLOR_SCAN_ROWS
        store = self.color_index(descs[:n], ids[:n], self.dev)._store
        k = sp.maxMatches + 8
        res = {}
        for mode in ("on", "off"):
            os.environ["CBIRD_COLOR_BUCKETS"] = mode
            try:
                res[mode] = self.timed(lambda: store.search_self(
                    k=k, sparse=True))
            finally:
                del os.environ["CBIRD_COLOR_BUCKETS"]
        (w_on, on), (w_off, off) = res["on"], res["off"]
        if sorted(on) != sorted(off) or not all(
                np.array_equal(on[r][0], off[r][0])
                and np.array_equal(on[r][1], off[r][1]) for r in on):
            raise AssertionError("bucketed and scan self-search differ")
        out.update(scan_rows=n, bucketed_wall_ms=round(w_on, 1),
                   scan_wall_ms=round(w_off, 1), scan_rows_with_hits=len(on))
        del store
        torch.cuda.empty_cache()
        return out

    def color_cli_phase(self):
        """The CLI with -p.alg color over CCLI_SOURCES colored sources, each
        with a half-size, a mirrored and a jpeg q50 copy: -update, -similar,
        -similar-to of a mirrored copy, -merge, -test-image-search (four
        files) and -test-image-loader exit 0 and find the copies."""
        from PIL import Image
        from cbird_tpu_torch.cli.main import main
        from cbird_tpu_torch.ops import color_scores as cs
        rng = np.random.default_rng(SEED + 33)
        out = {}
        k6 = cs.color_scores.launches

        def run(*args):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(["-use", d, *args])
            if rc:
                raise AssertionError(f"{args} rc {rc}")
            return buf.getvalue()
        with tempfile.TemporaryDirectory() as d:
            owner = {}
            for s in range(CCLI_SOURCES):
                im = Image.fromarray(color_image(rng, 240, 320))
                for name, v in (("src.png", im),
                                ("half.png", im.resize((160, 120),
                                                       Image.BOX)),
                                ("mirror.png", im.transpose(
                                    Image.FLIP_LEFT_RIGHT)),
                                ("q50.jpg", im)):
                    path = os.path.join(d, f"c{s:02d}_{name}")
                    v.save(path, quality=50) if name.endswith(".jpg") \
                        else v.save(path)
                    owner[os.path.basename(path)] = s
            t0 = time.perf_counter()
            run("-create", "-i.algos", "dct+color", "-update")
            out["update_s"] = round(time.perf_counter() - t0, 3)
            groups = groups_of(run("-p.alg", "color", "-similar", "-json"))
            joined = joined_sources(groups, owner)
            out.update(groups=len(groups), sources_joined=joined)
            if joined != CCLI_SOURCES:
                raise AssertionError(f"only {joined} sources joined their "
                                     f"4 variants")
            mirror = os.path.join(d, "c03_mirror.png")
            hit = json.loads(run("-p.alg", "color", "-similar-to", mirror,
                                 "-json"))
            got = {owner[os.path.basename(m["path"])]
                   for m in hit[0]["matches"][:3]} if hit else set()
            if got != {3}:
                raise AssertionError(f"-similar-to a mirror: {got}")
            merged = run("-merge", os.path.join(d, "c00_src.png"),
                         os.path.join(d, "c01_mirror.png"), "-dump")
            if "c01_mirror.png" not in merged or "c00_src.png" not in merged:
                raise AssertionError("-merge lost an item")
            files = [os.path.join(d, f"c{s:02d}_src.png") for s in range(4)]
            table = run("-select-files", *files, "-test-image-search")
            if "|  dct |   4 |   0 |" not in table:
                raise AssertionError(f"-test-image-search: {table}")
            loader = run("-test-image-loader", files[0])
            if "320x240" not in loader:
                raise AssertionError(f"-test-image-loader: {loader}")
        if cs.color_scores.launches == k6:
            raise AssertionError("K6 did not run in the ccli phase")
        out["similar_to_mirror_matches"] = len(hit[0]["matches"])
        return out

    # ---- the template matcher and the query server -----------------------
    def tm_collection(self, d: str, rng, sources: int,
                      distractors: int) -> dict:
        """``sources`` seeded textured sources of 300-1200 px, each with a
        70-90% crop, a 0.5-0.8 rescale and a shift (the source on a larger
        flat ground), and ``distractors`` unrelated images, written as
        files.  @return file name -> source (distractor n: -1 - n)"""
        from PIL import Image
        owner = {}

        def save(name, arr, src):
            Image.fromarray(arr).save(os.path.join(d, name))
            owner[name] = src
        for s, img in enumerate(self.feat_images(sources, rng)):
            h, w = img.shape
            save(f"t{s:03d}_src.png", img, s)
            f = rng.uniform(0.7, 0.9)
            ch, cw = int(h * f), int(w * f)
            y = int(rng.integers(0, h - ch + 1))
            x = int(rng.integers(0, w - cw + 1))
            save(f"t{s:03d}_crop.png", img[y:y + ch, x:x + cw], s)
            f = rng.uniform(0.5, 0.8)
            save(f"t{s:03d}_scale.png", np.asarray(Image.fromarray(img).resize(
                (max(1, round(w * f)), max(1, round(h * f))), Image.BOX)), s)
            dy = int(rng.integers(h // 20, h // 6))
            dx = int(rng.integers(w // 20, w // 6))
            shifted = np.full((h + dy, w + dx), 60, np.uint8)
            shifted[dy:, dx:] = img
            save(f"t{s:03d}_shift.png", shifted, s)
        for n, img in enumerate(self.feat_images(distractors, rng)):
            save(f"x{n:03d}.png", img, -1 - n)
        return owner

    def tm_phase(self):
        """-p.tm on the card: the TM collection through cbird-torch -create
        -i.algos dct+fdct -update, -p.alg fdct -similar (the candidates),
        then -p.alg fdct -p.tm 1 -similar.  Checks: the matcher's ORB on
        the card and K5 launched; every case the matcher gets wrong
        against the planted truth (a cross-source pair kept, a candidate
        of a source whose variants stay apart; a variant fdct did not
        offer is printed as such) printed with its cause and a CPU
        matcher's scores both ways (the first TM_CASES); at most a tenth of
        the sources apart and of fdct's cross-source pairs kept; K5's
        mutual match equal to numpy on TM_SAMPLED_PAIRS pairs; the pairs of
        TM_CPU_GROUPS groups scored on the card and on the CPU.  Every score
        must equal the CPU's (ORB gives the same features on both); a
        differing one is printed with whether the two ORBs differ, and
        fails the phase."""
        torch = self.torch
        from cbird_tpu_torch.cli import main as cli
        from cbird_tpu_torch.host import template_matcher as tmm
        from cbird_tpu_torch.host.scanner import Scanner
        from cbird_tpu_torch.ops import hamming_lanes as hl
        from cbird_tpu_torch.params import SearchParams
        from cbird_tpu_torch.store.database import Database
        if hasattr(cli, "NOT_PORTED"):
            raise AssertionError("the CLI still refuses verbs")
        rng = np.random.default_rng(SEED + 40)
        d = self.tm_dir = tempfile.mkdtemp(prefix="cbird-tm-")
        owner = self.tm_collection(d, rng, TM_SOURCES, TM_DISTRACTORS)
        out = {"files": len(owner)}

        def run(*args):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["-use", d, *args])
            if rc:
                raise AssertionError(f"{args} rc {rc}")
            return buf.getvalue()
        out["update_s"] = self.timed_s(
            lambda: run("-create", "-i.algos", "dct+fdct", "-i.fsize", "0",
                        "-update"))[0]
        raw_s, raw = self.timed_s(
            lambda: json.loads(run("-p.alg", "fdct", "-similar", "-json")))
        # spies: the matcher's ORB passes (device, synced ms) and pairs
        stats = {"orb_ms": 0.0, "orb_images": 0, "devices": set(),
                 "pairs": 0}
        orb_batch = tmm.TemplateMatcher._features_batch
        verify = tmm.TemplateMatcher._verify_pair

        def spy_orb(tm, grays, nf):
            t0 = time.perf_counter()
            res = orb_batch(tm, grays, nf)
            torch.cuda.synchronize()
            stats["orb_ms"] += (time.perf_counter() - t0) * 1e3
            stats["orb_images"] += len(grays)
            stats["devices"] |= {f[2].device.type for f in res}
            return res

        def spy_verify(*a):
            stats["pairs"] += 1
            return verify(*a)
        k5 = hl.hamming_lanes_topk.launches
        tmm.TemplateMatcher._features_batch = spy_orb
        tmm.TemplateMatcher._verify_pair = staticmethod(spy_verify)
        try:
            tm_s, res = self.timed_s(lambda: json.loads(run(
                "-p.alg", "fdct", "-p.tm", "1", "-similar", "-json")))
        finally:
            tmm.TemplateMatcher._features_batch = orb_batch
            tmm.TemplateMatcher._verify_pair = staticmethod(verify)
        out.update(raw_similar_s=raw_s, tm_similar_s=tm_s,
                   raw_groups=len(raw), tm_groups=len(res),
                   pairs_verified=stats["pairs"],
                   pairs_verified_per_s=round(stats["pairs"] / tm_s, 1),
                   orb_images=stats["orb_images"],
                   orb_ms=round(stats["orb_ms"], 1),
                   orb_share=round(stats["orb_ms"] / 1e3 / tm_s, 4),
                   k5_launches=hl.hamming_lanes_topk.launches - k5)
        if stats["devices"] != {self.dev.type}:
            raise AssertionError(f"the matcher's ORB ran on "
                                 f"{stats['devices']}")
        if hl.hamming_lanes_topk.launches == k5:
            raise AssertionError("K5 did not run in -p.tm")
        name = lambda m: os.path.basename(m["path"])
        raw_of = {name(g["needle"]): [name(m) for m in g["matches"]]
                  for g in raw}
        groups = {(name(g["needle"]), frozenset(map(name, g["matches"])))
                  for g in res}
        sources = {k: v for k, v in owner.items() if v >= 0}
        parent = {n: n for n in sources}

        def find(n):
            while parent[n] != n:
                n = parent[n]
            return n
        for n, ms in groups:
            for m in ms:
                if owner[n] == owner[m] >= 0:
                    parent[find(m)] = find(n)
        apart = sorted({owner[n] for n in sources}
                       - {s for s in set(sources.values()) if len(
                           {find(n) for n in sources if sources[n] == s}) == 1})
        cross = sorted((n, m) for n, ms in groups for m in ms
                       if owner[m] != owner[n])
        raw_cross = sum(owner[m] != owner[n] for n, ms in raw_of.items()
                        for m in ms)
        out.update(sources_joined=TM_SOURCES - len(apart),
                   raw_cross_pairs=raw_cross, tm_cross_pairs=len(cross))
        params = SearchParams()
        db = Database(d)
        fresh = lambda n: db.media_with_path(os.path.join(d, n))
        devs = (self.dev.type, "cpu")
        matchers = {t: tmm.TemplateMatcher(device=torch.device(t))
                    for t in devs}

        def scores(dev, n, ms):
            """A fresh match of template n against the group ms (no cached
            verdict): each candidate's score."""
            tm = matchers[dev]
            tm._cache.clear()
            group = [fresh(m) for m in ms]
            cands = list(group)
            tm.match(fresh(n), group, params)
            return [m.score for m in cands]

        def orb_of(dev, n, ms):
            """The ORB that scores(dev, n, ms) runs: the template n (a batch
            of one), then the candidates after -p.tscale (one batch)."""
            tm = matchers[dev]
            tg = tm._decode_gray(os.path.join(d, n))
            cgs = [tm._tscale(tg, tm._decode_gray(os.path.join(d, m)),
                              params) for m in ms]
            return [(x, y, f.cpu().numpy()) for x, y, f in (
                tm._features_batch([tg], params.needleFeatures)
                + tm._features_batch(cgs, params.haystackFeatures))]

        def compare(n, ms):
            """The card's and the CPU's scores of group ms under template n.
            Where a score differs, the ORB of n or of that candidate must
            differ too (float noise at a rounding edge, ROADMAP queue 3):
            equal features with unequal scores are a fault of the match or
            the verify.  @return per candidate (card, cpu, note, fault)"""
            card, cpu = (scores(t, n, ms) for t in devs)
            if card == cpu:
                return [(a, a, "", False) for a in card]
            a, b = (orb_of(t, n, ms) for t in devs)
            same = [all(np.array_equal(u, v) for u, v in zip(p, q))
                    for p, q in zip(a, b)]
            out = []
            for i, m in enumerate(ms):
                if card[i] == cpu[i]:
                    out.append((card[i], cpu[i], "", False))
                elif same[0] and same[i + 1]:
                    out.append((card[i], cpu[i], "the same ORB on both",
                                True))
                else:
                    kp = [f"{who}: {len(a[j][0])} / {len(b[j][0])} keypoints"
                          for who, j in ((n, 0), (m, i + 1)) if not same[j]]
                    out.append((card[i], cpu[i],
                                f"ORB differs ({'; '.join(kp)})", False))
            return out
        faults, noisy = 0, 0
        # the cases the matcher got wrong against the planted truth, each
        # printed with its cause and both devices' scores both ways
        cases = [(n, m, "a cross-source pair kept") for n, m in cross]
        for src in apart:
            names = sorted(k for k, v in sources.items() if v == src)
            for n in names:
                for m in names:
                    if m != n and m not in raw_of.get(n, []):
                        print(f"tm: {m} is not among fdct's candidates of "
                              f"{n}", flush=True)
                    elif m != n:
                        cases.append((n, m, "a same-source candidate"))
        with self.uncounted():
            for n, m, what in cases[:TM_CASES]:
                for t, c in ((n, m), (m, n)):
                    [(card, cpu, note, fault)] = compare(t, [c])
                    why = ("no transform from >= 3 mutual matches"
                           if card == tmm.INT_MAX else
                           f"masked-hash distance {card} "
                           f"{'<' if card < params.tmThresh else '>='} "
                           f"tmThresh {params.tmThresh}")
                    print(f"tm: {what}: {t} -> {c}: {why}; on the CPU "
                          f"{cpu} {note}", flush=True)
                    faults += fault
                    noisy += card != cpu
        out.update(cases=len(cases), cases_checked=min(len(cases), TM_CASES))
        if len(apart) > TM_SOURCES // 10 or len(cross) > raw_cross // 10:
            raise AssertionError(f"{len(apart)} sources not joined, "
                                 f"{len(cross)} of {raw_cross} cross-source "
                                 f"pairs kept")
        # checks: K5's mutual match against numpy; 16 groups on the CPU
        card = matchers[self.dev.type]
        pairs = [(n, m) for n, ms in sorted(raw_of.items()) for m in ms]
        pick = rng.choice(len(pairs), min(TM_SAMPLED_PAIRS, len(pairs)),
                          replace=False)
        dec = Scanner(device=self.dev).decode_image
        with self.uncounted():
            diff = 0
            for i in pick:
                n, m = pairs[i]
                grays = [dec(os.path.join(d, x)).gray for x in (n, m)]
                (_, _, a), (_, _, b) = card._features_batch(
                    grays, params.haystackFeatures)
                got = tmm.mutual_matches(a, [b], params.cvThresh)[0]
                want = tmm._mutual_radius_match(
                    a.cpu().numpy().view(np.uint8).reshape(-1, 32),
                    b.cpu().numpy().view(np.uint8).reshape(-1, 32),
                    params.cvThresh)
                diff += got != want
            if diff:
                raise AssertionError(f"K5's mutual match differs from "
                                     f"numpy on {diff} pairs")
            out["sampled_pairs_equal"] = len(pick)
            needles = [n for n in sorted(raw_of) if raw_of[n]]
            chosen = [needles[i] for i in sorted(rng.choice(
                len(needles), TM_CPU_GROUPS, replace=False))]
            equal = 0
            for n in chosen:
                for m, (card_s, cpu_s, note, fault) in zip(
                        raw_of[n], compare(n, raw_of[n])):
                    equal += card_s == cpu_s
                    faults += fault
                    noisy += card_s != cpu_s
                    if note:
                        print(f"tm: group of {n}: {m}: card {card_s}, CPU "
                              f"{cpu_s}: {note}", flush=True)
        db.close()
        out.update(cpu_pairs=sum(len(raw_of[n]) for n in chosen),
                   cpu_pairs_equal=equal, scores_differing_by_orb=noisy,
                   card=smi())
        if faults:
            raise AssertionError(f"{faults} scores differ from the CPU's "
                                 f"on the same ORB features")
        if noisy:
            raise AssertionError(f"{noisy} scores differ from the CPU's "
                                 f"(ORB's features are the same on every "
                                 f"device and in any batch)")
        return out

    def timed_s(self, fn):
        """(wall seconds, result) of one call, the card synced after."""
        t0 = time.perf_counter()
        res = fn()
        self.torch.cuda.synchronize()
        return round(time.perf_counter() - t0, 3), res

    def serve_phase(self):
        """-serve over the tm phase's index: QueryServer on 127.0.0.1:0 in
        a background thread (warm-up timed), ping and status, SERVE_QUERIES
        queries (dct and fdct, SERVE_TM with -p.tm), -similar-to through
        the CLI with CBIRD_SERVER, then stop; every answer equal to the
        same -similar-to in process; warm-query p50 / p99."""
        from cbird_tpu_torch.cli import main as cli
        from cbird_tpu_torch.cli.serve import QueryClient, QueryServer
        from cbird_tpu_torch.host.engine import Engine
        d = self.tm_dir
        try:
            rng = np.random.default_rng(SEED + 41)
            files = sorted(f for f in os.listdir(d) if f.endswith(".png"))
            eng = Engine(d, device=self.dev)
            srv = QueryServer(eng)
            warm_s = srv.warmup()
            thread = srv.start_background()
            addr = f"{srv.address[0]}:{srv.address[1]}"
            c = QueryClient(addr)
            out = {"warmup_s": round(warm_s, 3)}
            if not c.call({"cmd": "ping"}).get("pong"):
                raise AssertionError("no pong")
            status = c.call({"cmd": "status"})
            if status.get("items") != len(files):
                raise AssertionError(f"status: {status}")
            reqs = []
            for q in range(SERVE_QUERIES):
                alg = "dct" if q % 2 == 0 else "fdct"
                tm = q % (SERVE_QUERIES // SERVE_TM) == 1
                reqs.append((os.path.join(d, files[int(rng.integers(
                    len(files)))]), alg, tm))
            answers, ms = [], {"dct": [], "fdct": [], "tm": []}
            for path, alg, tm in reqs:
                params = {"alg": alg, **({"tm": 1} if tm else {})}
                t0 = time.perf_counter()
                answers.append(c.query(path, **params))
                ms["tm" if tm else alg].append(
                    (time.perf_counter() - t0) * 1e3)
            # the same -similar-to verbs in process, one CLI run
            args = ["-use", d]
            for path, alg, tm in reqs:
                args += ["-p.alg", alg, "-p.tm", "1" if tm else "0",
                         "-similar-to", path, "-json"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(args)
            if rc:
                raise AssertionError(f"in-process -similar-to rc {rc}")
            local, text, at = [], buf.getvalue(), 0
            dec = json.JSONDecoder()
            while text[at:].strip():
                at += len(text[at:]) - len(text[at:].lstrip())
                obj, at = dec.raw_decode(text, at)
                local.append(obj)
            same = lambda g, l: [[(m["path"], m["score"]) for m in x[1:]]
                                 for x in g] == [[(m["path"], m["score"])
                                                  for m in x["matches"]]
                                                 for x in l] and \
                [x[0]["path"] for x in g] == [x["needle"]["path"]
                                              for x in l]
            bad = [r for r, g, l in zip(reqs, answers, local)
                   if not same(g, l)]
            if len(local) != len(reqs) or bad:
                raise AssertionError(f"{len(bad)} answers differ from the "
                                     f"in-process -similar-to: {bad[:3]}")
            hits = sum(bool(g) for g in answers)
            k = next(i for i, r in enumerate(reqs)
                     if r[1] == "fdct" and not r[2])
            os.environ["CBIRD_SERVER"] = addr
            try:
                before = srv._queries
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["-use", d, "-p.alg", "fdct",
                                   "-similar-to", reqs[k][0], "-json"])
            finally:
                del os.environ["CBIRD_SERVER"]
            routed = json.loads(buf.getvalue())
            routed = [[x["needle"]] + x["matches"] for x in routed]
            if rc or srv._queries != before + 1 or not same(routed,
                                                             local[k]):
                raise AssertionError("-similar-to through CBIRD_SERVER "
                                     "differs")
            if not c.call({"cmd": "stop"}).get("stopping"):
                raise AssertionError("stop refused")
            c.close()
            thread.join(timeout=60)
            if thread.is_alive():
                raise AssertionError("the server did not stop")
            srv.server.server_close()
            eng.db.close()
            for kind, xs in ms.items():
                warm = np.array(xs[1:])  # the first loads the kind's index
                out[f"{kind}_first_ms"] = round(xs[0], 3)
                out[f"{kind}_p50_ms"] = round(float(np.percentile(warm, 50)),
                                             3)
                out[f"{kind}_p99_ms"] = round(float(np.percentile(warm, 99)),
                                             3)
            out.update(queries=len(reqs), with_matches=hits, card=smi())
            return out
        finally:
            import shutil
            shutil.rmtree(d, ignore_errors=True)

    # ---- mesh -------------------------------------------------------------
    def mesh_compare(self, out: dict, meshes: dict, what: str, fn, same):
        """``fn`` on one device, then on each mesh (each after a warm-up
        call that places the store), each result ``same`` as one device's.
        Walls (ms, to the card's idle) into ``out[what]``."""
        from cbird_tpu_torch.ops.hamming import use_mesh
        with use_mesh(None):
            fn()
            wall, want = self.timed(fn)
        row = {"single_ms": round(wall, 1)}
        for name, mesh in meshes.items():
            with use_mesh(mesh):
                fn()
                wall, got = self.timed(fn)
            if not same(want, got):
                raise AssertionError(f"mesh {name}: {what} differs from one "
                                     f"device's")
            row[f"{name}_ms"] = round(wall, 1)
        out[what] = row
        return want

    @staticmethod
    def same_lists(a, b) -> bool:
        """Dense lists or sparse dicts of (ids, values), entry for entry."""
        if isinstance(a, dict):
            if sorted(a) != sorted(b):
                return False
            a, b = [a[r] for r in sorted(a)], [b[r] for r in sorted(b)]
        return len(a) == len(b) and all(
            np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
            for x, y in zip(a, b))

    def mesh_phase(self):
        """The mesh (parallel/sharded.py) at full size: each result on a
        mesh of MESH_SHARDS shards of this card, the (2, 4) mesh of the JAX
        tests (and on a mesh of every card when there are several), against
        the same store's one-device result, bit for bit, walls side by
        side; then the process path at world size 1 on NCCL."""
        torch = self.torch
        from cbird_tpu_torch.ops import pigeonhole as ph
        from cbird_tpu_torch.ops.color import PackedColorStore
        from cbird_tpu_torch.ops.hamming import PackedHashStore, use_mesh
        from cbird_tpu_torch.ops.hamming_topk import hamming_topk
        from cbird_tpu_torch.parallel import sharded as shd
        from cbird_tpu_torch.params import SearchParams
        from cbird_tpu_torch.store.media import Media
        card = torch.device("cuda", torch.cuda.current_device())
        meshes = {"shards8": shd.make_mesh([card] * MESH_SHARDS)}
        if torch.cuda.device_count() > 1:
            meshes["cards"] = shd.make_mesh()
        out = {"meshes": {k: [list(map(str, r)) for r in m.devices]
                          for k, m in meshes.items()}}
        cmp = lambda what, fn, same=self.same_lists: self.mesh_compare(
            out, meshes, what, fn, same)
        sp = SearchParams()
        rng = np.random.default_rng(SEED + 51)

        # the dct store: 10M rows, 1- and 1024-needle search
        hashes, ids, src, _, dead = self.planted_store(10_000_000, 1000, rng)
        store = PackedHashStore(hashes, ids, device=self.dev)
        store.remove(dead)
        for q in (1, 1024):
            needles = np.r_[hashes[src[:min(q, 1000)]], rng.integers(
                1, 2**64, size=max(0, q - 1000), dtype=np.uint64)]
            cmp(f"search_q{q}_10M", lambda: store.search(needles, T, k=64))
        if not isinstance(store._dev[0], shd.Sharded):
            raise AssertionError("the store was not sharded on the mesh")
        del store
        # search_self: the pigeonhole count at 2M (with the ph phase's
        # run of 5000 rows that share block 0's key: run tiles), the
        # triangle at 1M
        for n, route in ((2_000_000, "pigeonhole"), (SELF_ROWS, "triangle")):
            hashes, ids, src, dst, dead = self.planted_store(n, 1000, rng)
            if route == "pigeonhole":
                m0 = np.uint64(ph.mask64(ph.block_masks(T)[0]) % 2**64)
                clus = rng.choice(np.setdiff1d(np.arange(n), np.r_[src, dst]),
                                  5000, replace=False)
                hashes[clus] = (hashes[clus] & ~m0) | (hashes[clus[0]] & m0)
            store = PackedHashStore(hashes, ids, device=self.dev)
            store.remove(dead)
            if route == "triangle":
                os.environ["CBIRD_PIGEONHOLE"] = "off"
            try:
                res = cmp(f"search_self_{route}_{n}",
                          lambda: store.search_self(T, k=64, sparse=True))
            finally:
                os.environ.pop("CBIRD_PIGEONHOLE", None)
            self.check_planted(res, ids, src, dst)
            if (store.pigeonhole is None) != (route == "triangle") \
                    or store.rescanned:
                raise AssertionError(f"{route}: pigeonhole "
                                     f"{store.pigeonhole}, rescanned "
                                     f"{store.rescanned}")
            if route == "pigeonhole":
                out["run_tiles_per_block"] = store.pigeonhole["run_tiles"]
            if route == "triangle":
                tri = (store, res)
            else:
                del store
        # video (a) -similar and (b) -similar-to a 16384-frame needle
        data = self.video_data(np.random.default_rng(SEED + 8))
        idx, h = self.video_index(data, black=False)
        needles, _ = self.video_live(data, h)
        cmp("video_a", lambda: idx.find_batch(needles, sp), operator.eq)
        del idx, needles
        idx, h = self.video_index(data, black=True)
        needle, _, _ = self.video_needle(data, h, rng)
        cmp("video_b", lambda: idx.find(needle, sp), operator.eq)
        del idx, data, h
        # orb -similar-to of 16 images over 2^20 descriptor rows
        idx, desc, groups = self.orb_index(np.random.default_rng(SEED + 22))
        needles = []
        for s, _ in groups[:FEAT_NEEDLES]:
            m = Media(f"/needle/{s}.png")
            m.keyPointDescriptors = desc[(s - 1) * KP:s * KP].view(
                np.uint8).reshape(KP, 32)
            needles.append(m)
        cmp("orb_similar_to_16", lambda: idx.find_batch(needles, sp),
            operator.eq)
        del idx, desc
        # color: -similar-to of 64 needles over 2^20 rows; -similar over
        # 2^16 rows, bucketed on one device and through the scan on a mesh
        descs, cids, cgroups = self.color_store(
            np.random.default_rng(SEED + 32),
            getattr(self, "color_hist", None))
        idx = self.color_index(descs, cids, self.dev)
        needles = self.color_needles(descs, cgroups)
        cmp("color_similar_to_64", lambda: idx.find_batch(needles, sp),
            operator.eq)
        del idx
        n = COLOR_SIMILAR_ROWS
        store = PackedColorStore(self.dev)
        store.add(descs[:n], cids[:n])
        k = sp.maxMatches + 8
        cmp("color_similar_65536", lambda: store.search_self(k=k,
                                                             sparse=True))
        with use_mesh(None):
            os.environ["CBIRD_COLOR_BUCKETS"] = "off"
            try:
                wall, _ = self.timed(lambda: store.search_self(k=k,
                                                               sparse=True))
            finally:
                del os.environ["CBIRD_COLOR_BUCKETS"]
        out["color_similar_65536"]["single_scan_ms"] = round(wall, 1)
        del store, descs
        torch.cuda.empty_cache()

        # the process path: torch.distributed at world size 1 (its CUDA
        # collectives on NCCL), the shards8 mesh from make_multihost_mesh:
        # the triangle's counts (all_reduce), the pigeonhole's block
        # states (all_reduce) and the all-pairs step's rows
        # (all_gather_into_tensor) against one device
        store, res = tri
        port = free_port()
        world = shd.init_distributed(f"127.0.0.1:{port}", 1, 0)
        try:
            backend = str(torch.distributed.get_backend())
            if world != 1 or "nccl" not in backend:
                raise AssertionError(f"world {world}, backend {backend}")
            mesh = shd.make_multihost_mesh(devices=[card] * MESH_SHARDS)
            with use_mesh(mesh):
                for mode in ("off", "on"):
                    os.environ["CBIRD_PIGEONHOLE"] = mode
                    try:
                        got = store.search_self(T, k=64, sparse=True)
                    finally:
                        del os.environ["CBIRD_PIGEONHOLE"]
                    if not self.same_lists(res, got):
                        raise AssertionError(f"process path, pigeonhole "
                                             f"{mode}: results differ")
                hd, vd = store._device_arrays()
                nd = store._needles(store.hashes[:4096])
                d, i = shd.sharded_all_pairs_step(mesh, nd, hd, vd, k=16)
            with use_mesh(None), self.uncounted():
                hd1, vd1 = store._device_arrays()
                d1, i1 = hamming_topk(nd, hd1, vd1, 16)
            self.same(d, d1, "all-pairs dists")
            self.same(i, i1, "all-pairs rows")
        finally:
            torch.distributed.destroy_process_group()
        out["process_path"] = {"world": world, "backend": backend,
                               "mesh": list(mesh.devices.shape)}
        out["card"] = smi()
        return out


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def color_image(rng, h: int, w: int) -> np.ndarray:
    """Eight color patches (as the tests' color images) on a color ramp,
    with mild noise, so that, as in photos, the k-means finds 32 distinct
    colors (numColors 31); seeded."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (rng.integers(40, 200, 3) + yy[..., None] * rng.uniform(
        -0.3, 0.3, 3) + xx[..., None] * rng.uniform(-0.3, 0.3, 3))
    for _ in range(8):
        y, x = rng.integers(0, h - h // 5), rng.integers(0, w - w // 5)
        ph, pw = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
        img[y:y + ph, x:x + pw] = rng.integers(30, 255, size=3)
    img += rng.normal(0.0, 4.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def textured(rng, h: int, w: int) -> np.ndarray:
    """Blocks of random grey on a flat ground (the tests' textured images),
    one block per ~3000 pixels, at least 40."""
    img = np.full((h, w), 60, np.uint8)
    for _ in range(max(40, h * w // 3000)):
        bh = int(rng.integers(8, max(9, min(50, h // 4))))
        bw = int(rng.integers(8, max(9, min(50, w // 4))))
        y, x = rng.integers(0, h - bh), rng.integers(0, w - bw)
        img[y:y + bh, x:x + bw] = rng.integers(0, 255)
    return img


def groups_of(js: str) -> set:
    """-json output -> {(needle, frozenset(matches))} by file name."""
    name = lambda m: os.path.basename(m["path"])
    return {(name(g["needle"]), frozenset(map(name, g["matches"])))
            for g in json.loads(js)}


def joined_sources(groups: set, owner: dict) -> int:
    """Sources whose variants the groups connect (union-find)."""
    parent = {p: p for p in owner}

    def find(p):
        while parent[p] != p:
            p = parent[p]
        return p
    for needle, matches in groups:
        for p in matches:
            parent[find(p)] = find(needle)
    return sum(len({find(p) for p in owner if owner[p] == s}) == 1
               for s in set(owner.values()))

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
                   "replaces": "cbird_tpu/ops/mxu_count.py:166",
                   "also_replaces": ["experiments/mxu_epilogue_ab.py:179",
                                     "experiments/mxu_epilogue_ab.py:95",
                                     "experiments/mxu_epilogue_ab.py:154",
                                     "experiments/mxu_i16_ab.py:55"]},
        "K2-mma": {"name": "count_below_mma_masked", "route": "cuda",
                   "source": "cbird_tpu_torch/csrc/count_below_mma.cu",
                   "replaces": "cbird_tpu/ops/mxu_count.py:206"},
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
        "K5": {"name": "hamming_lanes_topk", "route": "cuda",
               "source": "cbird_tpu_torch/csrc/hamming_lanes_topk.cu",
               "replaces": "cbird_tpu/ops/hamming.py:894"},
        "K5-popc": {"name": "hamming_lanes_topk_popc", "route": "cuda",
                    "source": "cbird_tpu_torch/csrc/hamming_lanes_topk.cu",
                    "replaces": "cbird_tpu/ops/hamming.py:894"},
        "K6": {"name": "color_scores", "route": "cuda",
               "source": "cbird_tpu_torch/csrc/color_scores.cu",
               "replaces": "cbird_tpu/ops/color.py:266",
               "also_replaces": ["cbird_tpu/ops/color.py:315",
                                 "cbird_tpu/ops/color.py:352",
                                 "cbird_tpu/ops/color.py:397",
                                 "cbird_tpu/ops/color.py:435"]},
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
                     ("vcli", s.video_cli_phase), ("cli", s.cli_phase),
                     ("feat", s.feat_phase), ("fdct", s.fdct_phase),
                     ("orb", s.orb_phase), ("fcli", s.fcli_phase),
                     ("cdesc", s.cdesc_phase), ("color", s.color_phase),
                     ("ccli", s.color_cli_phase), ("tm", s.tm_phase),
                     ("serve", s.serve_phase), ("mesh", s.mesh_phase)):
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
        if k["launches"] and name in OFF_PATH:
            s.failed.append(f"{name} launched {k['launches']} times on the "
                            f"main path")
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
