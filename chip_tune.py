"""Block shapes of the top-k scan (K4) and the band counts (K3), and the
forms of the tensor-core count (K1-mma), the 256-bit k-nearest search (K5)
and the chamfer color score (K6), and the forms of the color descriptor's
exact fma (``ops/exact32.py``), measured on one NVIDIA GPU.

    python3 chip_tune.py [k4] [k3] [k3run] [mma] [k5] [k6] [fma]
                                                            (default: all)

Writes every variant below of ``csrc/hamming_topk.cu``,
``csrc/band_count.cu``, ``csrc/count_below_mma.cu``,
``csrc/hamming_lanes_topk.cu`` and ``csrc/color_scores.cu`` to
``build/tune/``
(a copy of the source with its shape constants edited, or parts of its
code replaced by the text this script holds; the package always builds
the sources as they are), builds them with
nvcc, one each, all at once; checks that each variant's outputs equal
the first variant's (or the plain band's); then times each one with CUDA
events (20 launches, two rounds, the variants in turn), on
chip_smoke.py's operands.  A variant the compiler or the card refuses is
reported and left out (the run then exits non-zero):

  K4  one first-pass scan (bound 5, k=64): Q=1 and Q=64 over a 10M-row
      store, Q=1024 over 2^20 rows.  Variants: threads a block
      (THREADS), haystack columns a thread (CPT), needles a block (TQ).
  K3  the band of chip_smoke's timed block (2^20 rows, s=2048, t=5 block
      0, with its planted over-long runs), and of the same block without
      them (random rows, 1% tombstones): the long runs' warps against the
      bulk.  Variants: warps a block (WARPS), warps that share the
      columns of 32 rows (by s as ``split_for`` sets it, or fixed), each
      taking SPAN columns in turn, columns staged through shared memory
      or read through L1.
  k3run  K3-run (the run tiles) at chip_smoke's two shapes: the 3 run
      tiles of its timed block (2^20 rows, s=2048, t=5 block 0) and the
      ~465 hit-dense run tiles of a 65,536-row near-duplicate cluster in a
      block of the same size (built as chip_smoke's kernels phase builds
      it), each form's bare launch checked against the plain twin and
      timed on the card alone (queued behind a spin: no host time).
      Forms: the source (a block a unit) and a persistent grid of 528
      blocks (4 an SM) walking its units; rows a thread (RUN_RPT) 2 and
      1; chunks of 128 columns; column slices for 2 and 32 units a block;
      slices of at least 256 columns; registers capped for 4 blocks an
      SM; the column loop unrolled 8 and 2; and the form of
      commit K3RUN_OLD (a block a tile pair's 1024 rows x 64 columns, a
      global atomic a lane a column credit), its source from ``git
      show``, kept in ``build/tune/`` for a copy without git.
  mma K1-mma (wgmma), unmasked at Q=16384 x 65536 (the triangle's tile),
      Q=1024 x 2^20 (the 1024-needle gate) and Q=16384 x 2^21 (the video
      gate), masked on the diagonal tile of the first two; t=5.  The
      source: e4m3 operands, three consumer warpgroups, n-tiles of 256
      columns, steps of 1024 columns in a ring of 2 (packed: 4), the
      threshold in a bias lane.  Variants: two consumers (one or two m64
      tiles each), int8 operands with s32 sums, the threshold as a limit
      at the count (K = 64), ring and step sizes, n-tiles of 128 (one or
      two m64 tiles a consumer), a row's hits summed in f32 across tiles
      (exact only to 2^24 a lane): the forms that measured slower live
      only here, as edits of the source.  Then
      forms that leave out a part of the work (the unpack, the count, the
      products, all three, and the copies too), timed and not checked:
      what the time is made of.
  k5  K5 (the 256-bit k-nearest search on the tensor cores) at Q=6400 x
      T=2^20, k=10, bound 25 and unbounded (chip_smoke's timed operands).
      Checked forms: the source; the rare case entered at every step
      (its fixed cost: a group search of both rows in all four turns,
      nothing admitted at bound 25); a ring of 3 slots with a packed ring
      of 2; a packed ring of 2; the unpack loop unrolled 8; the unpack
      with a column's four words in one 8-lane group (4-way bank
      conflicts on its stores).  Timed-only forms at bound 25: no
      epilogue; no products (zero sums); no unpack and no epilogue; the
      ring alone (a sum kept alive where the epilogue goes).
  k6  K6 on chip_smoke's operands: two-sided at Q=1024 x C=2^18 (the
      timed shape), the same with every needle at 30 colors (nearly every
      warp's rows straddle the needle's count), and one-sided "ab" and
      "ba" at 1024 x 65536 (color -similar's launch).  The source is
      checked against the plain twin on the first 4096 rows of each, the
      forms against the source.  Forms: both sums in one pass for every
      two-sided warp (no vote); a row a thread on every side (the "ba"
      side too); a row on two threads of 16 colors on every side, with
      and without the vote; needle tiles of 16 and 64; 256 threads a
      block; the registers capped for 3 and 4 blocks an SM.  Timed only: the
      form of commit K6_OLD (unfused d2, a predicate a color pair, a
      runtime loop with a shared load a pair on the "ba" side), whose
      scores round otherwise (its source from ``git show``, kept in
      ``build/tune/`` for a copy without git).  Each form's registers and
      spills as ptxas reports them.
  fma ``fma32``'s forms on the card, no kernel built: the squared
      distance of three differences (two nested fmas, as the descriptor
      takes it) at the descriptor's shapes, the center shift's [16, 32],
      the k-means++ seeding's [16, 2^16, 1] and a Lloyd step's [16, 2^16,
      32], and at [16, 2^16, 4 / 8 / 16] between them, the dense form
      checked equal to the sparse one, each timed on the host's clock (20
      calls, then a sync; two rounds, the forms in turn) beside the float64
      sum rounded again (timed only);
      then create_descriptors of chip_smoke's first 256 cdesc images with
      fma32 taking the sparse form at every size, the dense form under
      FMA_CUTS' sizes, and the dense form at every size (descriptors
      checked equal), and, timed only, the float64 sum rounded once more
      to float32 (the double rounding the port took before exact32).

The first variant of each list is the shape the sources hold.  Prints
the card's name and power limit, then one JSON line per variant.  Exits
non-zero when no CUDA device is visible or a variant disagrees.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

K4_VARIANTS = [  # (threads, columns a thread, needles a block)
    (256, 4, 128), (256, 2, 128), (256, 8, 128), (128, 4, 128),
    (512, 4, 128), (256, 4, 64), (256, 4, 256), (128, 8, 256)]
K3_VARIANTS = [  # (warps a block, warps a 32-row group (0: by s), span,
    # columns through shared memory (1) or L1 (0))
    (8, 0, 128, 1), (8, 1, 128, 1), (8, 2, 128, 1), (8, 4, 128, 1),
    (8, 8, 128, 1), (8, 4, 64, 1), (8, 4, 256, 1), (16, 0, 128, 1),
    (8, 0, 128, 0), (8, 1, 128, 0)]


def k4_edits(v) -> tuple:
    return (("constexpr int THREADS = 256;", f"constexpr int THREADS = {v[0]};"),
            ("constexpr int CPT = 4;", f"constexpr int CPT = {v[1]};"),
            ("constexpr int TQ = 128;", f"constexpr int TQ = {v[2]};"))


# the band's columns read through L1 instead of the per-warp stage
L1_EDITS = (("    c_hash[w][lane] = c;\n    c_row[w][lane] = crow;\n", ""),
            ("c_hash[w][j]", "__ldg(sh + min(q0 + j, n_tot - 1))"),
            ("c_row[w][j]", "__ldg(srow + q0 + j)"))


def k3_edits(v) -> tuple:
    edits = (("constexpr int WARPS = 8;", f"constexpr int WARPS = {v[0]};"),
             ("constexpr int SPAN = 128;", f"constexpr int SPAN = {v[2]};"))
    if v[1]:
        edits += (("const int split = split_for(s);",
                   f"const int split = {v[1]};"),)
    return edits + (() if v[3] else L1_EDITS)


# K1-mma's forms, as edits of its source (the first is the source as it
# is).  An edit is (old, new), or ((begin, end), new) to replace the text
# from begin up to end.
MMA_SOURCE = ("e4m3, 3 consumers, n256, steps of 1024, ring 2, raw ring 4, "
              "bias lane")
CONS2 = ("constexpr int NCONS = 3;", "constexpr int NCONS = 2;")


def steps(sub: int, ring: int) -> tuple:
    """Steps of ``sub`` columns in a ring of ``ring`` slots."""
    return (("constexpr int SUB = 1024;", f"constexpr int SUB = {sub};"),
            ("constexpr int STAGES = 2;", f"constexpr int STAGES = {ring};"))


# n-tiles of 128 columns: the m64n128k32 product
N128 = (("constexpr int WN = 256;", "constexpr int WN = 128;"),
        ("#undef D8", r"""template <int SCALE_D>
__device__ __forceinline__ void mma_e4m3(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f16.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}
#undef D8"""))

# int8 +-1 operands, s32 sums (128 registers an n256 tile, so two
# consumers), a hit the sum's sign bit added by one shift-and-add
# (LEA.HI), in four partial sums a row
INT8 = (
    ("constexpr int NACC = WN / 4;", "constexpr int NACC = WN / 2;"),
    ("  return (x & 0x01010101u) * 0x80u + 0x38383838u;",
     "  return (x & 0x01010101u) * 0xFEu + 0x01010101u;"),
    ("  if (!counted) return 0x7Eu;\n"
     "  const int b = 64 - 2 * t;\n"
     "  const uint32_t sign = b < 0 ? 0x80u : 0u;\n"
     "  const int a = b < 0 ? -b : b;\n"
     "  return (e4m3(a & ~15) | sign) | ((e4m3(a & 15) | sign) << 8);",
     "  return counted ? static_cast<uint32_t>(64 - 2 * t) & 0xFFu : 0x7F7Fu;"),
    ("a[2][rr] = qd == 0 ? 0x3838u : 0u;", "a[2][rr] = qd == 0 ? 0x0101u : 0u;"),
    ("#undef D8", r"""template <int SCALE_D>
__device__ __forceinline__ void mma_s8(int (&d)[128], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}
#undef D8"""),
    ("        mma_e4m3<0>(acc, a[2], b_desc(tile + 4 * 128, 0));\n"
     "        mma_e4m3<1>(acc, a[0], b_desc(tile));\n"
     "        mma_e4m3<1>(acc, a[1], b_desc(tile + 256));",
     "        mma_s8<0>(acc, a[2], b_desc(tile + 4 * 128, 0));\n"
     "        mma_s8<1>(acc, a[0], b_desc(tile));\n"
     "        mma_s8<1>(acc, a[1], b_desc(tile + 256));"),
    # acc[4k + e] is row g + 8 (e >> 1), column 8k + 2qd + (e & 1)
    (("template <bool MASK, int N>\n"
      "__device__ __forceinline__ void count_rows(", "// mode 0: the tile"),
     r"""template <bool MASK, int N>
__device__ __forceinline__ void count_rows(const int (&acc)[N], int dm,
                                           int thr, int (&cnt)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int part[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1)
        if (!MASK || 8 * k + e1 - 8 * r + thr > dm)
          part[(2 * k + e1) & 3] += static_cast<int>(
              static_cast<uint32_t>(acc[4 * k + 2 * r + e1]) >> 31);
    cnt[r] += part[0] + part[1] + part[2] + part[3];
  }
}

"""))

# the threshold as each column's f16 limit 2t - 64 (-1024: never) in a
# slot of its own, applied at the count (lim - (-dot) saturated), K = 64
LIMITS = (
    ("constexpr int GROUP = 8 * 16 * 5;", "constexpr int GROUP = 8 * 16 * 4;"),
    ("constexpr int SMEM = 1024 + STAGES * B_BYTES +",
     "constexpr int SMEM = 1024 + STAGES * (B_BYTES + 2 * SUB) +"),
    ("  uint32_t raw;          // RAW_STAGES barriers",
     "  uint32_t raw;          // RAW_STAGES barriers\n"
     "  uint32_t lim;          // STAGES x 2 SUB: the limits, lim_at order"),
    ("  const uint32_t bars = r.raw_v + RAW_STAGES * RAW_V;",
     "  r.lim = r.raw_v + RAW_STAGES * RAW_V;\n"
     "  const uint32_t bars = r.lim + STAGES * 2 * SUB;"),
    ("__device__ __forceinline__ uint32_t lds8(uint32_t addr) {", r"""__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b16 [%0], %1;" ::"r"(addr),
               "h"(static_cast<unsigned short>(v)) : "memory");
}
__device__ __forceinline__ int4 lds128(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr)
               : "memory");
  return v;
}
// f16 bits of an integer |v| <= 1024, exact
__device__ __forceinline__ uint32_t f16_int(int v) {
  if (v == 0) return 0;
  const uint32_t sign = v < 0 ? 0x8000u : 0u;
  const int a = v < 0 ? -v : v;
  const int e = 31 - __clz(a);
  return sign | static_cast<uint32_t>((e + 15) << 10) |
         static_cast<uint32_t>(((a << 10) >> e) & 0x3FF);
}
// the byte offset of column j's limit in a slot: the words of columns
// 8k + 2qd and + 1 for four n8 blocks k share 16 bytes, so a consumer
// thread reads four in one load
__device__ __forceinline__ uint32_t lim_at(int j) {
  const int k = j >> 3, qd = (j >> 1) & 3;
  return static_cast<uint32_t>(((k >> 2) * 4 + qd) * 16 + (k & 3) * 4 +
                               (j & 1) * 2);
}
__device__ __forceinline__ uint32_t lds8(uint32_t addr) {"""),
    ("  const uint32_t fold = bias_word(t, true), never = bias_word(t, false);",
     "  const uint32_t fold = f16_int(2 * t - 64), never = f16_int(-1024);"),
    ("      sts128(col + 4 * 128, ok ? fold : never, 0, 0, 0);",
     "      sts16(r.lim + slot * 2 * SUB + lim_at(j), ok ? fold : never);"),
    ("__device__ __forceinline__ void count_rows(const int (&acc)[N], int dm,",
     "__device__ __forceinline__ void count_rows(const int (&acc)[N],\n"
     "                                           const uint32_t (&lw)[N / 2],"
     " int dm,"),
    ('"r"(0u), "r"(acc[2 * k + r])', '"r"(lw[k]), "r"(acc[2 * k + r])'),
    (("template <int N>\n"
      "__device__ __forceinline__ void count_tile(", "template <bool MASKED>"),
     r"""template <int N>
__device__ __forceinline__ void count_tile(int (&acc)[N], int mode, int dm,
                                           int thr, uint32_t lim,
                                           int (&cnt)[2]) {
  acc_fence(acc);
  if (!mode) return;
  uint32_t lw[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; k += 4) {
    const int4 v = lds128(lim + 16 * k);
    lw[k] = v.x; lw[k + 1] = v.y; lw[k + 2] = v.z; lw[k + 3] = v.w;
  }
  if (mode == 2)
    count_rows<true>(acc, lw, dm, thr, cnt);
  else
    count_rows<false>(acc, lw, dm, thr, cnt);
}

"""),
    ("        mma_e4m3<0>(acc, a[2], b_desc(tile + 4 * 128, 0));\n"
     "        mma_e4m3<1>(acc, a[0], b_desc(tile));",
     "        mma_e4m3<0>(acc, a[0], b_desc(tile));"),
    ("for (int e = 0; e < 12; ++e) asm volatile",  # no bias step's A
     "for (int e = 0; e < 8; ++e) asm volatile"),
    ("        count_tile(acc, mode, dm, thr, cnt);",
     "        count_tile(acc, mode, dm, thr,\n"
     "                   r.lim + slot * 2 * SUB + (nt * (WN / 32) * 4 + qd) * 16,"
     "\n                   cnt);"),
)

# two m64 tiles a consumer: every product of a step's n-tile on both
MT2 = (
    ("constexpr int BQ = NCONS * 64;", "constexpr int BQ = NCONS * 128;"),
    (("template <bool MASKED>\n__device__ __forceinline__ void consumer(",
      "template <bool MASKED>\n__global__"), r"""template <bool MASKED>
__device__ __forceinline__ void consumer(
    const Ring& r, Walk w, const unsigned long long* __restrict__ needles,
    int q, int* __restrict__ out) {
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
  const int tid = threadIdx.x & 127;
  const int wp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int thr = 2 * qd - 16 * wp - g;
  uint32_t a[2][3][4];
  int acc[2][NACC];
  bool more = w.unit<MASKED>();
  int i = 0;
  while (more) {
    const int r0 = w.y * BQ + c * 128;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r0 + 64 * m + 16 * wp + g + 8 * rr;
        const unsigned long long h = row < q ? ~needles[row] : 0ull;
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            a[m][s][2 * hf + rr] = pm1_word(h, 8 * s + 4 * hf + qd);
        a[m][2][rr] = qd == 0 ? 0x3838u : 0u;
        a[m][2][2 + rr] = 0u;
      }
#pragma unroll
    for (int e = 0; e < 24; ++e)
      asm volatile("" : "+r"(a[e / 12][(e >> 2) % 3][e & 3]));
    int cnt[2][2] = {{0, 0}, {0, 0}};
    do {
      const int slot = i % STAGES;
      bar_wait(r.full + 8 * slot, (i / STAGES) & 1);
      const uint32_t sb = r.b + slot * B_BYTES;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int mode[2], dm[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const long long d = w.row_base + r0 + 64 * m -
                              (w.col_base + w.c0 + nt * WN);
          mode[m] = r0 + 64 * m >= q ? 0 : !MASKED ? 1
                  : d >= WN - 1 ? 0 : d < -63 ? 1 : 2;
          dm[m] = mode[m] == 2 ? static_cast<int>(d) : 0;
        }
        acc_fence(acc[0]);
        acc_fence(acc[1]);
        wgmma_fence();
        const uint32_t tile = sb + nt * (WN / 8) * GROUP;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_e4m3<0>(acc[m], a[m][2], b_desc(tile + 4 * 128, 0));
          mma_e4m3<1>(acc[m], a[m][0], b_desc(tile));
          mma_e4m3<1>(acc[m], a[m][1], b_desc(tile + 256));
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < 2; ++m)
          count_tile(acc[m], mode[m], dm[m], thr, cnt[m]);
      }
      if (lane == 0) bar_arrive(r.empty + 8 * slot);
      ++i;
      w.c0 += SUB;
    } while (w.c0 < w.cend);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        int v = cnt[m][rr];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int row = r0 + 64 * m + 16 * wp + g + 8 * rr;
        if (qd == 0 && row < q && v) atomicAdd(out + row, v);
      }
    w.u += gridDim.x;
    more = w.unit<MASKED>();
  }
}

"""),
)

# a row's hits summed in f32 across tiles, converted once at the end:
# exact only while a lane's part of a row's count stays under 2^24
F32_SUMS = (
    (("    int v;\n", "  }\n}\n\n// mode 0"), r"""    float lo, hi;
    asm("{\n.reg .f16 l, h;\nmov.b32 {l, h}, %2;\ncvt.f32.f16 %0, l;\n"
        "cvt.f32.f16 %1, h;\n}" : "=f"(lo), "=f"(hi) : "r"(part[0]));
    cnt[r] = __float_as_int(__int_as_float(cnt[r]) + lo + hi);
"""),
    ("      int v = cnt[rr];",
     "      int v = static_cast<int>(__int_as_float(cnt[rr]));"),
)

MMA_VARIANTS = {
    MMA_SOURCE: (),
    "row sums in f32 (exact to 2^24 a lane)": F32_SUMS,
    "2 consumers": (CONS2,),
    "2 consumers, 2 m64": (CONS2, *MT2),
    "int8, s32 sums (LEA.HI count), 2 consumers": (*INT8, CONS2),
    "limits at the count (K = 64)": LIMITS,
    "raw ring 2": (("constexpr int RAW_STAGES = 4;",
                    "constexpr int RAW_STAGES = 2;"),),
    "steps of 768, ring 2": (("constexpr int SUB = 1024;",
                              "constexpr int SUB = 768;"),),
    "steps of 512, ring 2": steps(512, 2),
    "steps of 512, ring 3": steps(512, 3),
    "steps of 512, ring 4": steps(512, 4),
    "steps of 256, ring 2": steps(256, 2),
    "steps of 256, ring 3": steps(256, 3),
    "steps of 256, ring 4": steps(256, 4),
    "n128": N128,
    "n128, 2 m64": (*N128, *MT2),
}
# forms that leave out a part of the work, to see what the time is made
# of: their counts are wrong, so they are timed and not checked
NO_UNPACK = ("for (int half = 0; half < SUB / 128; ++half) {",
             "for (int half = 0; half < 0; ++half) {")
NO_COUNT = ("  acc_fence(acc);\n  if (mode == 2)",  # one sum kept alive
            "  acc_fence(acc);\n  if (mode < 5) {\n"
            "    cnt[0] += acc[0] & 1;\n    return;\n  }\n  if (mode == 2)")
NO_MMA = ("        mma_e4m3<0>(acc, a[2], b_desc(tile + 4 * 128, 0));\n"
          "        mma_e4m3<1>(acc, a[0], b_desc(tile));\n"
          "        mma_e4m3<1>(acc, a[1], b_desc(tile + 256));\n", "")
NO_COPY = ("  bar_expect(bar, static_cast<uint32_t>((h1 - h0) + (v1 - v0)));\n"
           "  bulk_load(r.raw_h + slot * RAW_H, reinterpret_cast<const void*>(h0),\n"
           "            static_cast<uint32_t>(h1 - h0), bar);\n"
           "  bulk_load(r.raw_v + slot * RAW_V, reinterpret_cast<const void*>(v0),\n"
           "            static_cast<uint32_t>(v1 - v0), bar);",
           "  bar_arrive(bar);")
MMA_DIAG = {
    "diag: no unpack": (NO_UNPACK,),
    "diag: no count": (NO_COUNT,),
    "diag: no mma": (NO_MMA,),
    "diag: ring only (no unpack, count, mma)": (NO_UNPACK, NO_COUNT, NO_MMA),
    "diag: ring only, no copies": (NO_UNPACK, NO_COUNT, NO_MMA, NO_COPY),
}
MMA_FORMS = {**MMA_VARIANTS, **MMA_DIAG}

# K5 (hamming_lanes_topk.cu)
K5_SOURCE = "source: one list a row, the quad's threads in turn"
K5_VARIANTS = {
    K5_SOURCE: (),
    "rare case at every step": (
        ("      if (__any_sync(0xffffffffu, p0 | p1)) {",
         "      if (__any_sync(0xffffffffu, 1)) {"),
        ("            if (p0) admit<KT, 0>", "            admit<KT, 0>"),
        ("            if (p1) admit<KT, 1>", "            admit<KT, 1>")),
    "ring 3, raw ring 2": (("constexpr int STAGES = 2;      // ring",
                            "constexpr int STAGES = 3;      // ring"),
                           ("constexpr int RAW_STAGES = 4;  // slots",
                            "constexpr int RAW_STAGES = 2;  // slots")),
    "raw ring 2": (("constexpr int RAW_STAGES = 4;  // slots",
                    "constexpr int RAW_STAGES = 2;  // slots"),),
    "unpack loop unrolled 8": (("#pragma unroll 2\n    for (int it = 0;",
                                "#pragma unroll\n    for (int it = 0;"),),
    "unpack: a column's 4 words in one 8-lane group (4-way conflicts)": (
        ("    const int wd = lane >> 3;", "    const int wd = lane & 3;"),
        ("it * 8 + (lane & 7);", "it * 8 + (lane >> 2);")),
}
# a sum kept alive by a store never taken: with no read of the sums left,
# ptxas drops the products
K5_NO_EPILOGUE = ((("      // the common case: no sum of the warp's rows",
                    "      if (lane == 0) bar_arrive(r.empty + 8 * slot);"),
                   "      if (acc[0] == 0x7FFFFFFF) sts32(lst[0], 0);\n"),)
K5_NO_MMA = ((("      mma_e4m3<0>(acc, a[0], b_desc(sb));",
               "      wgmma_commit();"),
              "#pragma unroll\n      for (int e = 0; e < NACC; ++e) acc[e] = 0;\n"),)
K5_NO_UNPACK = (("    for (int it = 0; it < SUB / 32; ++it) {",
                 "    for (int it = 0; it < 0; ++it) {"),)
K5_DIAG = {
    "diag: no epilogue": K5_NO_EPILOGUE,
    "diag: no products (zero sums)": K5_NO_MMA,
    "diag: no unpack, no epilogue": (*K5_NO_UNPACK, *K5_NO_EPILOGUE),
    "diag: ring only": (*K5_NO_UNPACK, *K5_NO_EPILOGUE, *K5_NO_MMA),
}
K5_FORMS = {**K5_VARIANTS, **K5_DIAG}

# K6 (color_scores.cu)
K6_SOURCE = ("source: needle tiles of 32, warp vote, a row a thread "
             "(two on the \"ba\" side)")
K6_SPLIT = "const int split = side == 2 ? 2 : 1;"
K6_NO_VOTE = ("    float s_ab = 0.f, s_ba = 0.f;",
              "    if (two && mode) mode = 3;\n"
              "    float s_ab = 0.f, s_ba = 0.f;")
K6_ONE = (K6_SPLIT, "const int split = 1;")
K6_TWO = (K6_SPLIT, "const int split = 2;")
K6_VARIANTS = {
    K6_SOURCE: (),
    "both sums, no vote": (K6_NO_VOTE,),
    "a row a thread on every side": (K6_ONE,),
    "two threads a row on every side": (K6_TWO,),
    "two threads a row on every side, both sums": (K6_TWO, K6_NO_VOTE),
    "needle tiles of 16": (("constexpr int QT = 32;",
                            "constexpr int QT = 16;"),),
    "needle tiles of 64": (("constexpr int QT = 32;",
                            "constexpr int QT = 64;"),),
    "256 threads": (("constexpr int THREADS = 128;",
                     "constexpr int THREADS = 256;"),),
    "3 blocks an SM": (("__launch_bounds__(THREADS)",
                        "__launch_bounds__(THREADS, 3)"),),
    "4 blocks an SM": (("__launch_bounds__(THREADS)",
                        "__launch_bounds__(THREADS, 4)"),),
}
# the form before this design, timed only (its d2 is unfused)
K6_OLD = "c2e23a7"
K6_OLD_FORM = f"commit {K6_OLD} (timed only)"
# K3-run's forms (the first is the source as it is) and the form of commit
# K3RUN_OLD.  The persistent grid: 528 blocks (4 an SM) walking the units.
K3RUN_OLD = "8b9deab"
K3RUN_PERSISTENT = (
    ("           const int* __restrict__ tiles, int rs, int cs,\n",
     "           const int* __restrict__ tiles, long long units, int rs,\n"
     "           int cs,\n"),
    ("                          const int*, int, int, int, int*);",
     "                          const int*, long long, int, int, int, int*);"),
    ("  const long long u = blockIdx.x;  // the block's unit\n",
     "  for (long long u = blockIdx.x; u < units; u += gridDim.x) {\n"),
    ("    return;  // block-uniform", "    continue;  // block-uniform"),
    ("    if (acc[k]) atomicAdd(out + r_lo + k * RUN_THREADS + tid, acc[k]);\n}\n",
     "    if (acc[k]) atomicAdd(out + r_lo + k * RUN_THREADS + tid, acc[k]);\n"
     "  }\n}\n"),
    ("  kern<<<(int)units, RUN_THREADS, 0, st>>>(",
     "  kern<<<528, RUN_THREADS, 0, st>>>("),
    ("static_cast<const int*>(tiles), rs, cs,",
     "static_cast<const int*>(tiles), units, rs, cs,"),
)
K3RUN_FORMS = {
    "source": (),
    "a persistent grid (528 blocks)": K3RUN_PERSISTENT,
    "2 rows a thread": (("constexpr int RUN_RPT = 4;",
                         "constexpr int RUN_RPT = 2;"),),
    "1 row a thread": (("constexpr int RUN_RPT = 4;",
                        "constexpr int RUN_RPT = 1;"),),
    "chunks of 128": (("constexpr int RUN_CHUNK = 256;",
                       "constexpr int RUN_CHUNK = 128;"),),
    "2 units a block": (("constexpr int UNITS_PER_BLOCK = 8;",
                         "constexpr int UNITS_PER_BLOCK = 2;"),),
    "32 units a block": (("constexpr int UNITS_PER_BLOCK = 8;",
                          "constexpr int UNITS_PER_BLOCK = 32;"),),
    "slices of >= 256": (("constexpr int RUN_MIN_COLS = 64;",
                          "constexpr int RUN_MIN_COLS = 256;"),),
    "4 blocks an SM": (("__launch_bounds__(RUN_THREADS)",
                        "__launch_bounds__(RUN_THREADS, 4)"),),
    "columns unrolled 8": (("#pragma unroll 4\n      for (int j = 0; j < 32",
                            "#pragma unroll 8\n      for (int j = 0; j < 32"),),
    "columns unrolled 2": (("#pragma unroll 4\n      for (int j = 0; j < 32",
                            "#pragma unroll 2\n      for (int j = 0; j < 32"),),
}
K3RUN_OLD_FORM = f"commit {K3RUN_OLD}"
PTXAS: dict = {}  # (source name, form) -> ptxas's registers and spills


def build_variant(name: str, edits: tuple, src: str | None = None,
                  ptxas: tuple | None = None) -> str:
    """``csrc/<name>.cu`` (or ``src``) with each edit made in turn (its
    text must occur): (old, new) replaces old; ((begin, end), new)
    replaces the text from begin up to end.  Compiled as the package
    compiles it, into ``build/tune/``; with ``ptxas`` set, ptxas's
    registers and spills go to ``PTXAS[ptxas]``.
    @return the library path"""
    from cbird_tpu_torch import _build
    if src is None:
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            src = f.read()
    for old, new in edits:
        if isinstance(old, tuple):
            i = src.find(old[0])
            j = src.find(old[1], i + len(old[0])) if i >= 0 else -1
            if j < 0:
                raise RuntimeError(f"chip_tune: {old!r} not in {name}.cu")
            old = src[i:j]
        elif old not in src:
            raise RuntimeError(f"chip_tune: {old!r} not in {name}.cu")
        src = src.replace(old, new)
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "tune")
    os.makedirs(out, exist_ok=True)
    stem = os.path.join(out, f"{name}-" + hashlib.sha256(
        src.encode()).hexdigest()[:16])
    with open(stem + ".cu", "w") as f:
        f.write(src)
    flags = [*_build.NVCC_FLAGS, "-Xptxas", "-v"] if ptxas else \
        _build.NVCC_FLAGS
    proc = subprocess.run([_build.nvcc(), *flags, "-o", stem + ".so",
                           stem + ".cu"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {stem}.cu:\n{proc.stderr}")
    if ptxas:
        PTXAS[ptxas] = [ln.split(":", 1)[-1].strip() for ln in
                        proc.stderr.splitlines()
                        if "registers" in ln or "spill" in ln]
    return stem + ".so"


def k6_old_source() -> str:
    """color_scores.cu at commit K6_OLD (``old_source``)."""
    return old_source("color_scores", K6_OLD)


def old_source(name: str, commit: str) -> str:
    """csrc/<name>.cu at ``commit``: from git, kept in build/tune/ so that a
    copy of the tree without git finds it."""
    from cbird_tpu_torch import _build
    keep = os.path.join(os.path.dirname(_build.BUILD_DIR), "tune",
                        f"{name}-{commit}.cu")
    try:
        src = subprocess.run(
            ["git", "show", f"{commit}:cbird_tpu_torch/csrc/{name}.cu"],
            cwd=os.path.dirname(os.path.abspath(__file__)), check=True,
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        with open(keep) as f:
            return f.read()
    os.makedirs(os.path.dirname(keep), exist_ok=True)
    with open(keep, "w") as f:
        f.write(src)
    return src


def scan_launch(torch, lib, nd, h, v, k: int, bound: int):
    """One first-pass ``cbird_topk_scan`` of ``lib`` (no sort, no second
    pass), as a callable; its ``hist`` and ``cursor`` ride on it."""
    from cbird_tpu_torch import _build
    from cbird_tpu_torch.ops import hamming_topk as tk
    q, n = nd.numel(), h.numel()
    c = tk.capacity(k, n)
    hist = torch.empty((q, tk.BINS), dtype=torch.int32, device="cuda")
    cursor = torch.empty(q, dtype=torch.int32, device="cuda")
    keys = torch.empty(q * c, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(lib, lib.cbird_topk_scan(
            nd.data_ptr(), None, q, h.data_ptr(), v.data_ptr(), n, bound,
            hist.data_ptr(), None, c, cursor.data_ptr(), keys.data_ptr(),
            stream), "topk_scan")
    launch.hist, launch.cursor = hist, cursor
    return launch


def main() -> int:
    import torch
    parts = sys.argv[1:] or ["k4", "k3", "k3run", "mma", "k5", "k6", "fma"]
    if not set(parts) <= {"k4", "k3", "k3run", "mma", "k5", "k6", "fma"}:
        print(f"chip_tune: unknown parts {parts}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_tune: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from cbird_tpu_torch.ops import band_count as bc
    from cbird_tpu_torch.ops import color_scores as cs
    from cbird_tpu_torch.ops import count_below_mma as cm
    from cbird_tpu_torch.ops import hamming_lanes as hl
    from cbird_tpu_torch.ops import hamming_topk as tk
    print(chip_smoke.smi(), flush=True)
    s = chip_smoke.Smoke(torch)
    jobs = ([("hamming_topk", v) for v in K4_VARIANTS] * ("k4" in parts)
            + [("band_count", v) for v in K3_VARIANTS] * ("k3" in parts)
            + [("run_tiles", v) for v in [*K3RUN_FORMS, K3RUN_OLD_FORM]]
            * ("k3run" in parts)
            + [("count_below_mma", v) for v in MMA_FORMS]
            * ("mma" in parts)
            + [("hamming_lanes_topk", v) for v in K5_FORMS] * ("k5" in parts)
            + [("color_scores", v) for v in [*K6_VARIANTS, K6_OLD_FORM]]
            * ("k6" in parts))
    edits = {"hamming_topk": k4_edits, "band_count": k3_edits,
             "count_below_mma": MMA_FORMS.get,
             "hamming_lanes_topk": K5_FORMS.get,
             "color_scores": lambda v: K6_VARIANTS.get(v, ())}

    def build(job):
        try:
            if job[0] == "run_tiles":
                return build_variant(
                    "band_count", K3RUN_FORMS.get(job[1], ()), ptxas=job,
                    src=old_source("band_count", K3RUN_OLD)
                    if job[1] == K3RUN_OLD_FORM else None)
            if job[0] == "color_scores":
                return build_variant(
                    job[0], edits[job[0]](job[1]), ptxas=job,
                    src=k6_old_source() if job[1] == K6_OLD_FORM else None)
            return build_variant(job[0], edits[job[0]](job[1]))
        except RuntimeError as e:  # a form the compiler refuses
            print(f"chip_tune: {job[0]} {job[1]}: {str(e)[-600:]}",
                  file=sys.stderr)
            return None
    with cf.ThreadPoolExecutor(max(1, len(jobs))) as ex:
        paths = list(ex.map(build, jobs))
    libs = {}
    for (name, v), path in zip(jobs, paths):
        if path is None:
            if name == "count_below_mma":
                MMA_FORMS.pop(v, None)
            if name == "hamming_lanes_topk":
                K5_FORMS.pop(v, None)
            if name == "color_scores":
                K6_VARIANTS.pop(v, None)
            continue
        lib = ctypes.CDLL(path)
        if name == "hamming_topk":
            lib.cbird_topk_scan.argtypes = tk._SCAN_ARGS
            lib.cbird_topk_scan.restype = ctypes.c_int
        elif name == "band_count":
            lib.cbird_band_counts.argtypes = bc._COMMON + [ctypes.c_void_p,
                                                           ctypes.c_void_p]
            lib.cbird_band_counts.restype = ctypes.c_int
        elif name == "run_tiles":
            lib.cbird_run_tiles.argtypes = bc._RUN_ARGS
            lib.cbird_run_tiles.restype = ctypes.c_int
        elif name == "count_below_mma":
            lib.cbird_count_below_mma.argtypes = cm._ARGTYPES
            lib.cbird_count_below_mma.restype = ctypes.c_int
        elif name == "hamming_lanes_topk":
            lib.cbird_lanes_topk.argtypes = hl._ARGS
            lib.cbird_lanes_topk.restype = ctypes.c_int
        else:
            lib.cbird_color_scores.argtypes = cs._ARGS
            lib.cbird_color_scores.restype = ctypes.c_int
        lib.cbird_error_string.argtypes = [ctypes.c_int]
        lib.cbird_error_string.restype = ctypes.c_char_p
        libs[(name, v)] = lib
    ok = None not in paths
    if "k4" in parts:
        ok &= tune_k4(torch, s, libs)
    if "k3" in parts:
        ok &= tune_k3(torch, s, libs)
    if "k3run" in parts:
        ok &= tune_k3run(torch, s, libs)
    if "mma" in parts:
        ok &= tune_mma(torch, s, libs)
    if "k5" in parts:
        ok &= tune_k5(torch, s, libs)
    if "k6" in parts:
        ok &= tune_k6(torch, s, libs)
    if "fma" in parts:
        ok &= tune_fma(torch, s)
    return 0 if ok else 1


# fma32 on the card: the size below which it takes the dense form
FMA_CUTS = {"sparse at every size": 0, "dense under 2^23": 1 << 23,
            "dense at every size": 1 << 62}


def fma_form(cut: int):
    """fma32 taking the dense form below ``cut`` entries, else the
    sparse one."""
    from cbird_tpu_torch.ops import exact32

    def fma(a, b, c):
        a, b, c, shape = exact32._operands(a, b, c)
        form = exact32._fma32_dense if shape.numel() < cut else \
            exact32._fma32_sparse
        return form(a, b, c, shape)
    return fma


def fma_twice(a, b, c):
    """The float64 sum rounded again to float32 (it rounds twice)."""
    from cbird_tpu_torch.ops import exact32
    a, b, c, _ = exact32._operands(a, b, c)
    dev = next(t.device for t in (a, b, c) if t.dim())
    return (a.to(dev).double() * b.to(dev).double() + c.to(dev)).float()


def tune_fma(torch, s) -> bool:
    """fma32's forms against each other (module docstring)."""
    import time
    import chip_smoke
    from cbird_tpu_torch.ops import color
    ok = True
    rng = np.random.default_rng(chip_smoke.SEED + 33)
    forms = {"sparse": fma_form(0), "dense": fma_form(1 << 62),
             "rounded twice (timed only)": fma_twice}
    for shape in ((16, 32), (16, 1 << 16, 1), (16, 1 << 16, 4),
                  (16, 1 << 16, 8), (16, 1 << 16, 16), (16, 1 << 16, 32)):
        d = [torch.from_numpy((rng.standard_normal(shape) * 40).astype(
            np.float32)).cuda() for _ in range(3)]

        def sq3(f, d=d):
            return f(d[2], d[2], f(d[1], d[1], d[0] * d[0]))
        outs = {m: sq3(forms[m]) for m in ("sparse", "dense")}
        if not torch.equal(outs["dense"], outs["sparse"]):
            print(f"chip_tune: fma32's forms differ at {shape}",
                  file=sys.stderr)
            ok = False
        ms: dict = {m: [] for m in forms}
        for _ in range(2):
            for m, f in forms.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    sq3(f)
                torch.cuda.synchronize()
                ms[m].append((time.perf_counter() - t0) / 20 * 1e3)
        print(json.dumps({"fma": "two nested fmas", "shape": list(shape),
                          "host_ms_a_call": ms}), flush=True)
    imgs = s.color_images(chip_smoke.CDESC_IMAGES,
                          np.random.default_rng(chip_smoke.SEED + 31))[:256]
    runs = {**{m: fma_form(cut) for m, cut in FMA_CUTS.items()},
            "float64 sum rounded again (timed only)": fma_twice}
    keep = color.fma32
    ms = {m: [] for m in runs}
    descs = {}
    try:
        color.fma32 = fma_form(0)
        color.create_descriptors(imgs[:16], device=s.dev)  # warm-up
        for _ in range(2):
            for m, f in runs.items():
                color.fma32 = f
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                descs[m] = color.create_descriptors(imgs, device=s.dev)
                ms[m].append((time.perf_counter() - t0) * 1e3)
    finally:
        color.fma32 = keep
    ref = descs["sparse at every size"]
    for m in FMA_CUTS:
        if not all((x is None and y is None) or np.array_equal(x, y)
                   for x, y in zip(descs[m], ref)):
            print(f"chip_tune: descriptors differ under {m}",
                  file=sys.stderr)
            ok = False
    for m in runs:
        print(json.dumps({"fma": f"create_descriptors of {len(imgs)} images",
                          "form": m, "checked": m in FMA_CUTS,
                          "wall_ms": ms[m]}), flush=True)
    return ok


def tune_k6(torch, s, libs) -> bool:
    """K6's forms against each other (module docstring)."""
    import chip_smoke
    from cbird_tpu_torch import _build
    from cbird_tpu_torch.ops import color_scores as cs
    nc, nn, hc, hn, hv = s.k6_operands(
        np.random.default_rng(chip_smoke.SEED + 30))
    q, c = chip_smoke.K6_TIMED
    w = chip_smoke.K6_WINDOW
    shapes = {  # name -> (needle counts, rows, side)
        f"Q={q} C=2^18 two-sided": (nn, c, "both"),
        f"Q={q} C=2^18 two-sided, needles at 30": (torch.full_like(nn, 30),
                                                   c, "both"),
        f"Q={q} C={w} ab": (nn, w, "ab"),
        f"Q={q} C={w} ba": (nn, w, "ba")}
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    forms = [*K6_VARIANTS, *([K6_OLD_FORM] * (("color_scores", K6_OLD_FORM)
                                              in libs))]
    times = {m: {} for m in forms}
    for shape, (cnt, cols, side) in shapes.items():
        outs = {m: torch.empty((q, cols), dtype=torch.float32,
                               device="cuda") for m in forms}

        def launch(m, cols=cols):
            lib = libs[("color_scores", m)]
            return lambda: _build.check(lib, lib.cbird_color_scores(
                nc.data_ptr(), cnt.data_ptr(), q, hc.data_ptr(),
                hn.data_ptr(), hv.data_ptr(), cols, cs.SIDES[side], 0, 0,
                cs._NO_LIMIT, outs[m].data_ptr(), cols, stream),
                "color_scores")
        for m in list(forms):
            try:
                launch(m)()
                torch.cuda.synchronize()
            except RuntimeError as e:  # a form the card refuses
                print(f"chip_tune: K6 {m}: {e}", file=sys.stderr)
                ok = False
                del times[m]
                forms.remove(m)
        want = cs.color_scores_plain(nc, cnt, hc[:4096], hn[:4096],
                                     hv[:4096], side)
        if not torch.equal(outs[K6_SOURCE][:, :4096], want):
            print(f"chip_tune: K6 differs from the plain twin at {shape}",
                  file=sys.stderr)
            ok = False
        for m in forms:
            if m in K6_VARIANTS and not torch.equal(outs[m],
                                                     outs[K6_SOURCE]):
                print(f"chip_tune: K6 {m} differs at {shape}",
                      file=sys.stderr)
                ok = False
        for _ in range(2):
            for m in forms:
                times[m].setdefault(shape, []).append(s.event_ms(launch(m),
                                                                 3))
        outs.clear()
    for m in times:
        print(json.dumps({"kernel": "K6", "form": m,
                          "checked": m in K6_VARIANTS,
                          "ptxas": PTXAS.get(("color_scores", m)),
                          "ms": times[m]}), flush=True)
    return ok


def tune_k5(torch, s, libs) -> bool:
    """K5's forms against each other (module docstring), on operands made
    as chip_smoke's k5_kernels makes its timed ones."""
    import chip_smoke
    from cbird_tpu_torch import _build
    from cbird_tpu_torch.ops import hamming_lanes as hl
    rng = np.random.default_rng(chip_smoke.SEED + 10)
    t, q, k = 1 << 20, 6400, 10
    hay = torch.from_numpy(rng.integers(
        -2**63, 2**63, size=(t, 4), dtype=np.int64)).cuda()
    valid = torch.from_numpy(rng.random(t) > 0.01).cuda()
    nd = hay[torch.from_numpy(rng.integers(0, t, q)).cuda()]
    nd[:, 2] ^= 0x10101
    nd = nd.contiguous()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    xc, chunk = hl.tc_plan(q, t, sms)
    scratch = torch.empty(xc * hl.list_size(k) * q, dtype=torch.int64,
                          device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    forms = list(K5_FORMS)  # less those the card refuses
    times = {m: {} for m in forms}
    for bound in (25, hl.BINS):
        want = hl.hamming_lanes_topk_plain(nd, hay, valid, k, bound)
        outs = {m: (torch.empty((q, k), dtype=torch.int32, device="cuda"),
                    torch.empty((q, k), dtype=torch.int32, device="cuda"))
                for m in forms}

        def launch(m):
            lib, (d, r) = libs[("hamming_lanes_topk", m)], outs[m]
            return lambda: _build.check(lib, lib.cbird_lanes_topk(
                nd.data_ptr(), q, hay.data_ptr(), valid.data_ptr(), t, k,
                bound, xc, chunk, scratch.data_ptr(), d.data_ptr(),
                r.data_ptr(), stream), "lanes_topk")
        timed = [m for m in forms if bound == 25 or m in K5_VARIANTS]
        for m in list(timed):
            try:
                launch(m)()
                torch.cuda.synchronize()
            except RuntimeError as e:  # a form the card refuses
                print(f"chip_tune: K5 {m}: {e}", file=sys.stderr)
                ok = False
                timed.remove(m)
                forms.remove(m)
                continue
            if m in K5_VARIANTS and not (
                    torch.equal(outs[m][0], want[0])
                    and torch.equal(outs[m][1], want[1])):
                print(f"chip_tune: K5 {m} differs at bound {bound}",
                      file=sys.stderr)
                ok = False
        for _ in range(2):
            for m in timed:
                times[m].setdefault(f"bound {bound}", []).append(
                    s.event_ms(launch(m), 10))
    for m in forms:
        print(json.dumps({"kernel": "K5", "form": m,
                          "checked": m in K5_VARIANTS,
                          "shape": f"Q={q} T=2^20 k={k}", "ms": times[m]}),
              flush=True)
    return ok


def tune_mma(torch, s, libs) -> bool:
    """K1-mma's forms against each other (module docstring)."""
    import chip_smoke
    from cbird_tpu_torch import _build
    rng = np.random.default_rng(chip_smoke.SEED + 7)
    n = 1 << 21
    h64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    hay = torch.from_numpy(h64.view(np.int64)).cuda()
    vd = torch.from_numpy(rng.random(n) > 0.01).cuda()
    nd = torch.from_numpy(s.flip_bits(
        h64[rng.integers(0, n, 16384)], rng.integers(0, 8, 16384),
        rng).view(np.int64)).cuda()
    shapes = {  # name -> (needles, haystack, valid, masked)
        "Q=16384 N=65536": (nd, hay[:1 << 16], vd[:1 << 16], False),
        "Q=16384 N=65536 diagonal": (hay[:16384], hay[:1 << 16],
                                     vd[:1 << 16], True),
        "Q=1024 N=2^20": (nd[:1024], hay[:1 << 20], vd[:1 << 20], False),
        "Q=1024 N=2^20 diagonal": (hay[:1024], hay[:1 << 20], vd[:1 << 20],
                                   True),
        "Q=16384 N=2^21": (nd, hay, vd, False)}
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    forms = list(MMA_FORMS)  # less those the card refuses
    times = {v: {} for v in forms}
    for shape, (q, h, v, masked) in shapes.items():
        outs = {m: torch.empty(q.numel(), dtype=torch.int32, device="cuda")
                for m in forms}

        def launch(m):
            lib = libs[("count_below_mma", m)]
            return lambda: _build.check(lib, lib.cbird_count_below_mma(
                q.data_ptr(), q.numel(), h.data_ptr(), v.data_ptr(),
                h.numel(), chip_smoke.T, 0, int(masked), 0, 0,
                outs[m].data_ptr(), stream), "count_below_mma")
        for m in list(forms):
            try:
                launch(m)()
                torch.cuda.synchronize()
            except RuntimeError as e:  # a form the card refuses
                print(f"chip_tune: K1-mma {m}: {e}", file=sys.stderr)
                ok = False
                del times[m]
                forms.remove(m)
                continue
            if m in MMA_VARIANTS and not torch.equal(outs[m],
                                                      outs[MMA_SOURCE]):
                print(f"chip_tune: K1-mma {m} differs at {shape}",
                      file=sys.stderr)
                ok = False
        for _ in range(2):
            for m in forms:
                times[m].setdefault(shape, []).append(s.event_ms(launch(m),
                                                                 20))
    for m in times:
        print(json.dumps({"kernel": "K1-mma", "form": m,
                          "checked": m in MMA_VARIANTS, "t": chip_smoke.T,
                          "ms": times[m]}), flush=True)
    return ok


def tune_k4(torch, s, libs) -> bool:
    """K4's block shapes against each other (module docstring)."""
    import chip_smoke
    ok = True
    rng = np.random.default_rng(chip_smoke.SEED + 9)
    big = torch.from_numpy(rng.integers(0, 2**64, size=10_000_000,
                                        dtype=np.uint64).view(np.int64)).cuda()
    big_valid = torch.from_numpy(rng.random(big.numel()) > 0.01).cuda()
    pick = torch.from_numpy(rng.integers(0, 1 << 20, 1024)).cuda()
    shapes = {"Q=1 N=10M": (big[pick[:1]] ^ 5, big, big_valid),
              "Q=64 N=10M": (big[pick[:64]] ^ 5, big, big_valid),
              "Q=1024 N=2^20": (big[pick] ^ 5, big[:1 << 20],
                                big_valid[:1 << 20])}
    times = {v: {} for v in K4_VARIANTS}
    for shape, (nd, h, vd) in shapes.items():
        launch = {v: scan_launch(torch, libs[("hamming_topk", v)], nd, h,
                                 vd, 64, chip_smoke.T)
                  for v in K4_VARIANTS}
        ref = launch[K4_VARIANTS[0]]
        for v, fn in launch.items():
            fn()
            torch.cuda.synchronize()
            if not (torch.equal(fn.hist, ref.hist)
                    and torch.equal(fn.cursor, ref.cursor)):
                print(f"chip_tune: K4 {v} differs at {shape}",
                      file=sys.stderr)
                ok = False
        for _ in range(2):
            for v, fn in launch.items():
                times[v].setdefault(shape, []).append(s.event_ms(fn, 20))
    for v in K4_VARIANTS:
        print(json.dumps({"kernel": "K4 topk_scan", "threads": v[0],
                          "columns_per_thread": v[1], "needles_per_block":
                          v[2], "ms": times[v]}), flush=True)
    return ok


def tune_k3(torch, s, libs) -> bool:
    """K3's block shapes against each other (module docstring)."""
    import chip_smoke
    from cbird_tpu_torch import _build
    from cbird_tpu_torch.ops import band_count as bc
    ok = True
    # the band of the smoke's timed block, and of a random one
    n, sz, _ = chip_smoke.K3_CHECKS[0]
    rng = np.random.default_rng(chip_smoke.SEED + 5)
    planted = s.k3_data(n, sz, rng)
    plain = (rng.integers(0, 2**64, size=n, dtype=np.uint64),
             rng.random(n) > 0.01)
    # each of the timed block's two plants alone: the 3s rows that share
    # block 0's key, and the 1.25 s copies of one hash
    long_run, copies = plain[0].copy(), plain[0].copy()
    long_run[n // 10:n // 10 + 3 * sz] = planted[0][n // 10:n // 10 + 3 * sz]
    copies[n // 2:n // 2 + 5 * sz // 4] = copies[9]
    stream = torch.cuda.current_stream().cuda_stream
    for block, (h64, valid) in (("timed block", planted),
                                ("random block", plain),
                                ("random + equal-key run", (long_run,
                                                            plain[1])),
                                ("random + copies", (copies, plain[1]))):
        ops, masks, _ = s.k3_block(h64, valid, chip_smoke.T, 0, sz)
        marr = bc._mask_array(masks)
        outs = {v: torch.empty_like(ops[1]) for v in K3_VARIANTS}

        def band(v):
            lib = libs[("band_count", v)]
            return lambda: _build.check(lib, lib.cbird_band_counts(
                *(a.data_ptr() for a in ops), ops[0].numel(), sz,
                ctypes.addressof(marr), len(masks), chip_smoke.T,
                outs[v].data_ptr(), stream), "band_counts")
        want = bc.band_counts_plain(*ops, masks, chip_smoke.T, sz)
        k3 = {v: [] for v in K3_VARIANTS}
        for v in K3_VARIANTS:
            band(v)()
            torch.cuda.synchronize()
            if not torch.equal(outs[v], want):
                print(f"chip_tune: K3 {v} differs from the plain band",
                      file=sys.stderr)
                ok = False
        for _ in range(2):
            for v in K3_VARIANTS:
                k3[v].append(s.event_ms(band(v), 20))
        for v in K3_VARIANTS:
            print(json.dumps({"kernel": "K3 band_counts", "block": block,
                              "warps_per_block": v[0],
                              "warps_per_32_rows": v[1],
                              "span": v[2], "shared_stage": v[3],
                              "ms": k3[v]}),
                  flush=True)
    return ok



def tune_k3run(torch, s, libs) -> bool:
    """K3-run's forms against each other (module docstring)."""
    import chip_smoke
    from cbird_tpu_torch import _build
    from cbird_tpu_torch.ops import band_count as bc
    from cbird_tpu_torch.ops import pigeonhole as ph
    ok = True
    n, sz, _ = chip_smoke.K3_CHECKS[0]
    rng = np.random.default_rng(chip_smoke.SEED + 5)
    shapes = {"3 tiles": s.k3_data(n, sz, rng)}
    h64, valid = s.k3_data(n, sz, rng)
    m0 = ph.mask64(ph.block_masks(chip_smoke.T)[0]) % 2**64
    s.k3_cluster(h64, np.arange(n // 4, n // 4 + chip_smoke.K3_CLUSTER), rng,
                 outside=m0)
    shapes["cluster"] = (h64, valid)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (h, v) in shapes.items():
        ops, masks, key_s = s.k3_block(h, v, chip_smoke.T, 0, sz)
        tiles = ph.run_tile_pairs(key_s, s.changes(key_s), sz)
        marr = bc._mask_array(masks)
        want = bc.run_tiles_plain(torch.zeros_like(ops[1]), *ops, tiles,
                                  masks, chip_smoke.T, sz)
        forms = [*K3RUN_FORMS, K3RUN_OLD_FORM]

        def launch(form, out):
            lib = libs[("run_tiles", form)]
            args = [*(a.data_ptr() for a in ops), ops[0].numel(), sz,
                    ctypes.addressof(marr), len(masks), chip_smoke.T,
                    tiles.data_ptr(), len(tiles), out.data_ptr()]
            return lambda: _build.check(lib, lib.cbird_run_tiles(
                *args, stream), "run_tiles")
        ms = {f: [] for f in forms if ("run_tiles", f) in libs}
        for form in ms:
            out = torch.zeros_like(ops[1])
            launch(form, out)()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"chip_tune: K3-run {form} differs from the plain "
                      f"twin at {shape}", file=sys.stderr)
                ok = False
        scratch = torch.zeros_like(ops[1])
        for _ in range(2):
            for form in ms:
                ms[form].append(s.queued_ms(launch(form, scratch), 10)[0])
        for form, v in ms.items():
            print(json.dumps({"kernel": "K3-run run_tiles", "shape": shape,
                              "tiles": len(tiles), "form": form,
                              "device_ms": v,
                              "ptxas": PTXAS.get(("run_tiles", form))}),
                  flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
