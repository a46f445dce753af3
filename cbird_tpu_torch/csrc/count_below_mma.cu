// Hamming count-below-threshold on the tensor cores (kernels K1-mma and,
// MASKED, K2-mma).
//
// On the main path it replaces cbird_tpu/ops/mxu_count.py mxu_count_below
// (_count_kernel: the image count gate of PackedHashStore.search, the video
// count gate, the off-diagonal tiles of the self-search triangle) and, with
// MASKED, mxu_count_triangle (_mask_kernel: the triangle's diagonal
// tiles).  It also computes the TPU's +-1 product experiments:
// experiments/mxu_epilogue_ab.py count (v0-v2), count_jouter (v3) and
// count_packed (v4), experiments/mxu_i16_ab.py count_i16 and, as the bf16
// instantiation, experiments/mxu_count_sweep2.py mxu_count_bf16.  The TPU's
// int16 dot tile has no counterpart: the 8-bit tensor cores accumulate
// only in s32 or f16, as Mosaic refused i16 accumulation there.  The
// popcount form of the same function (count_below.cu) stays as the
// yardstick.  Both operand types run one kernel template
// (wgmma_count_kernel<T, MASKED>) over a traits struct, E4M3 or BF16.
//
// Contract: out[i] = #{ j < n : valid[j] and popcount(needles[i] ^ hay[j]) < t
//                              and (!MASKED or col_base + j > row_base + i) }
// for 0 <= t <= 65; t = 65 counts every valid column, as popcount < t does
// for any t >= 65, so the caller passes min(t, 65).  Hashes are one 64-bit
// pattern per row.  row_base and col_base are 64-bit global ids.  Counts
// are exact: a tile's hits are summed in f16 (at most 64 a row and
// thread), the tiles' as integers.
//
// Form: a hash unpacked to a +-1 vector (bit 0 -> +1, bit 1 -> -1) gives
// dot(a, b) = 64 - 2 * ham(a, b), so ham < t <=> dot > 64 - 2t.  The needles
// are unpacked negated, so the product runs as c = bias - dot, with the
// threshold folded into the bias: 64 - 2t for a counted column, and a value
// no dot brings below 0 for an invalid column, one past the ragged edge or
// a masked pair.  A hit is then c < 0.  The valid mask never widens K (the
// TPU padded it to 96 with a penalty lane).
//
// What bounds it on an H100: per pair 128 tensor operations (K = 64) at
// 1,979 TOPS dense, the int8 and the e4m3 rate alike: 0.0694 ms per 2^30
// pairs, 64 pairs a clock per SM.  The haystack is read once per needle
// tile (8 B + 1 B a column), far under the memory bound.  Beside the
// products, each pair costs its hit test and count: on the SM's 128 lanes a
// clock of integer work (64 of them on the ALU pipe) that is half the
// tensor rate at one instruction a pair.  Ampere's warp-wide MMA
// instruction sustains half the int8 peak at best on this card
// (chip_bounds.py), so both forms are built on wgmma, and the e4m3 count
// on the FMA pipe.
//
// The main form (E4M3; wgmma_count_kernel): a block of four warpgroups, one
// producer and three consumers, one block an SM, persistent over units of
// BQ = 192 needle rows x a chunk of whole steps of SUB = 1024 columns.
// - Operands are e4m3 +-1 (0x38, 0xB8: exact), sums f16 (|c| <= 448 + 96,
//   exact), two a register: an m64n256 tile's sums take 64 registers, so
//   three consumers fit in the 128 registers a thread the compiler gives a
//   block of 512 threads (setmaxnreg moves registers at run time, not in
//   the compiler's allocation).  The same layout with int8 operands and s32
//   sums, its count one shift-and-add (LEA.HI, the ALU pipe) a pair, ran
//   1.26x slower (chip_tune.py).
// - Consumers hold their needle rows (one m64 tile each) as wgmma's A in
//   registers, negated and unpacked once a unit, and run
//   wgmma.mma_async m64n256k32 f16.e4m3.e4m3 with B read from shared
//   memory, four n-tiles a step; three consumers keep the tensor cores fed
//   while each counts its last tile.
// - The threshold is a third k32 step (K = 96, 1.5x the tensor work, so
//   0.104 ms per 2^30 pairs): A lanes 64 and 65 are 1, B's hold 64 - 2t as a
//   multiple of 16 and the rest (both exact in e4m3), or 448 for a column
//   that never counts, and the step starts the sums (scale-d 0): no
//   accumulator init.  The step reads its 16-byte chunk twice (LBO 0), so
//   a column takes 80 bytes of shared memory.  A K = 64 form with each
//   column's limit applied at the count ran slower (chip_tune.py).
// - The count: a hit is -c saturated to 1 (HADD2.SAT), summed in f16 a
//   tile (at most 64 a row and thread, exact) and as an integer across
//   tiles: one FMA-pipe instruction per two pairs and one per two sums.
// - The producer brings each step's packed columns (8 B a column and its
//   valid byte) into RAW_STAGES slots with bulk asynchronous copies
//   (cp.async.bulk, completion on the slot's raw barrier), RAW_STAGES
//   steps ahead, from and to 16-byte boundaries around them (the bytes
//   past them are never used); unpacks them into a ring of STAGES slots in
//   the K-major no-swizzle layout the B descriptor reads (core matrices of
//   8 columns x 16 bytes: a warp's 16-byte stores fill whole 128-byte
//   rows, no bank conflict), fences the generic-proxy stores for the async
//   proxy (fence.proxy.async) and arrives on the slot's full barrier.  The
//   consumers release a slot on its empty barrier.  The haystack stays
//   packed in device memory: a pre-unpacked copy would read 8x the bytes.
// - Registers: setmaxnreg gives the producer 40 and the consumers the rest.
// - The mask (K2) is decided per tile, not per pair: a unit starts at its
//   first step that holds a column past its first row (and is dropped when
//   it has none); per n-tile a consumer leaves uncounted a tile whose
//   pairs all lie at or below the diagonal, counts as K1 one whose pairs
//   all lie above it, and drops the masked halves of a straddling tile's
//   hits.
// What holds it above its bound (chip_tune.py's forms that leave a part
// out, PERF.md): the count, the K = 96 step and the ring's handshakes a
// step; larger steps amortise the last.  chip_tune.py also rebuilds, as
// edits of this source, the forms that measured slower: two consumers,
// two m64 tiles a consumer, n128 tiles, int8 operands, the K = 64 limits,
// other step and ring sizes.
//
// The bf16 form (BF16: K1-v mxu_count_bf16, no main-path launches) is the
// same kernel at half the tensor rate (989 TFLOPS: 0.139 ms per 2^30
// pairs, 32 pairs a clock per SM):
// - Operands bf16 +-1 (0x3F80, 0xBF80), sums f32 (the only accumulator
//   bf16 has): wgmma.mma_async m64n128k16 f32.bf16.bf16, A in registers,
//   four k16 steps for the 64 lanes.  An m64n128 tile's sums take 64
//   registers, as e4m3's m64n256 does, so three consumers fit; n256 (128
//   registers) leaves two.
// - The threshold is a fifth k16 step (1.25x the tensor work): A's lane 64
//   is 1, B's holds 65 - 2t, or 65 for a column that never counts (odd
//   integers, exact in bf16).  A dot is even, so c = 65 - 2t - dot is an
//   odd integer, never 0: a hit is c <= -1, its f32 sign bit.
// - A column takes 144 bytes of shared memory (eight 16-byte k chunks and
//   the bias chunk, read twice: LBO 0), so steps of SUB = 512 columns, in
//   a ring of 3 (a packed ring of 2): 231,584 bytes.
// - The count: the sign bit added by one shift-and-add (LEA.HI, the ALU
//   pipe) a pair, in four partial sums a row; the tiles' as integers.
// What holds it above its bound (chip_tune.py bf16, PERF.md): the bias
// step (1.25x the products: 5.6 ms at 16384 x 2^21 at the rate
// chip_bounds.py's bf16 probe sustains) and the producer's unpack (144
// bytes a column; leaving it out saves ~15%).  chip_tune.py rebuilds the
// forms that measured slower: two consumers (n128, n256), n64, rings of
// 2, steps of 256 and 384, each column's bias preloaded into the sums
// (K = 64), half the count on the FMA pipe, the count as f16x2.

#include "sm90.cuh"

namespace {

constexpr int UNIT_COST = 1;  // a unit's fixed cost in steps (grid)

// ------------------------------------------------------- the operand types
// Each form: consumer warpgroups (NCONS, one m64 tile of needles each),
// columns of one wgmma (an n-tile, WN), columns a step (a slot, SUB),
// ring slots of unpacked columns (STAGES) and of packed ones (RAW_STAGES:
// copies ahead); its k steps of 32 bytes over the 64 lanes (KSTEPS), its
// sums (Acc, NACC a thread), the +-1 word of a hash (word), the bias lanes
// (A's bias word and B's, bias_word), the product and the count.

// e4m3 +-1, f16 sums two a register
struct E4M3 {
  static constexpr int NCONS = 3, WN = 256, SUB = 1024, STAGES = 2;
  static constexpr int RAW_STAGES = 4;
  static constexpr int KSTEPS = 2;        // k32 steps
  static constexpr int NACC = WN / 4;     // f16 sums, two a register
  typedef int Acc;
  static constexpr uint32_t A_BIAS = 0x3838u;  // A's lanes 64 and 65: 1

  static __device__ __forceinline__ uint32_t word(unsigned long long h,
                                                  int w) {
    return pm1_word(h, w);
  }

  // e4m3 of v = 0..15, 16, 32, 48 or 64, exact
  static __device__ __forceinline__ uint32_t e4m3(int v) {
    if (v == 0) return 0;
    const int e = 31 - __clz(v);
    return static_cast<uint32_t>(((e + 7) << 3) | (((v << 3) >> e) & 7));
  }

  // a counted column's bias lanes 64 and 65 (A's are +1): 64 - 2t as the
  // multiple of 16 and the rest; a column that never counts: 448, over any
  // dot
  static __device__ __forceinline__ uint32_t bias_word(int t, bool counted) {
    if (!counted) return 0x7Eu;
    const int b = 64 - 2 * t;
    const uint32_t sign = b < 0 ? 0x80u : 0u;
    const int a = b < 0 ? -b : b;
    return (e4m3(a & ~15) | sign) | ((e4m3(a & 15) | sign) << 8);
  }

  template <int SCALE_D>
  static __device__ __forceinline__ void mma(Acc (&d)[NACC],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    mma_e4m3<SCALE_D>(d, a, desc);
  }

  // One n-tile's sums into the hit counts of rows g and g + 8 (MASK: less
  // the pairs whose column is at or below their row).  acc[2k + r] holds
  // row g + 8r, columns 8k + 2qd and + 1, as f16 c.  A hit is -c saturated
  // to 1 (HADD2.SAT: two pairs an instruction on the FMA pipe, 32 lanes a
  // clock); the hits are summed in f16 (at most 64 a row, exact) and added
  // to the row's count as an integer.
  template <bool MASK>
  static __device__ __forceinline__ void count_rows(const Acc (&acc)[NACC],
                                                    int dm, int thr,
                                                    int (&cnt)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t part[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < NACC / 2; ++k) {
        uint32_t h;
        asm("sub.sat.f16x2 %0, %1, %2;" : "=r"(h) : "r"(0u), "r"(acc[2 * k + r]));
        if (MASK) {
          const int off = 8 * k - 8 * r + thr;
          h &= (off <= dm ? 0u : 0xFFFFu) | (off + 1 <= dm ? 0u : 0xFFFF0000u);
        }
        asm("add.f16x2 %0, %0, %1;" : "+r"(part[k & 3]) : "r"(h));
      }
      asm("add.f16x2 %0, %0, %1;" : "+r"(part[0]) : "r"(part[1]));
      asm("add.f16x2 %0, %0, %1;" : "+r"(part[2]) : "r"(part[3]));
      asm("add.f16x2 %0, %0, %1;" : "+r"(part[0]) : "r"(part[2]));
      int v;
      asm("{\n.reg .f16 l, h;\nmov.b32 {l, h}, %1;\nadd.f16 l, l, h;\n"
          "cvt.rni.s32.f16 %0, l;\n}" : "=r"(v) : "r"(part[0]));
      cnt[r] += v;
    }
  }
};

// bf16 +-1, f32 sums
struct BF16 {
  static constexpr int NCONS = 3, WN = 128, SUB = 512, STAGES = 3;
  static constexpr int RAW_STAGES = 2;
  static constexpr int KSTEPS = 4;        // k16 steps
  static constexpr int NACC = WN / 2;     // f32 sums
  typedef float Acc;
  static constexpr uint32_t A_BIAS = 0x3F80u;  // A's lane 64: 1, 65: 0

  static __device__ __forceinline__ uint32_t word(unsigned long long h,
                                                  int w) {
    return pm1_bf16(h, w);
  }

  // a counted column's bias lane 64 (A's is +1): 65 - 2t; a column that
  // never counts: 65 (t = 0's), over any dot.  Odd integers, exact in bf16
  static __device__ __forceinline__ uint32_t bias_word(int t, bool counted) {
    return __float_as_uint(static_cast<float>(counted ? 65 - 2 * t : 65)) >>
           16;
  }

  template <int SCALE_D>
  static __device__ __forceinline__ void mma(Acc (&d)[NACC],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    mma_bf16<SCALE_D>(d, a, desc);
  }

  // acc[4k + 2r + e] holds row g + 8r, column 8k + 2qd + e, as f32 c (an
  // odd integer): a hit is its sign bit, added by one LEA.HI
  template <bool MASK>
  static __device__ __forceinline__ void count_rows(const Acc (&acc)[NACC],
                                                    int dm, int thr,
                                                    int (&cnt)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int part[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < NACC / 4; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t c = __float_as_uint(acc[4 * k + 2 * r + e]);
          if (MASK && 8 * k + e - 8 * r + thr <= dm) c = 0;
          part[(2 * k + e) & 3] += static_cast<int>(c >> 31);
        }
      cnt[r] += (part[0] + part[1]) + (part[2] + part[3]);
    }
  }
};

// the shapes a form gives the kernel
template <class T>
struct Shape {
  static constexpr int NT = T::SUB / T::WN;          // n-tiles a step
  static constexpr int CHUNKS = 2 * T::KSTEPS;       // 16-byte k chunks
  // bytes of 8 columns: their k chunks and a bias chunk (the bias step
  // reads it twice, LBO 0)
  static constexpr int GROUP = 8 * 16 * (CHUNKS + 1);
  static constexpr int BQ = T::NCONS * 64;           // needle rows a unit
  static constexpr int THREADS = 128 * (1 + T::NCONS);  // producer, consumers
  // registers a thread after setmaxnreg: 40 the producer, the rest the
  // consumers (a multiple of 8)
  static constexpr int CONS_REGS =
      (65536 - 128 * 40) / (128 * T::NCONS) / 8 * 8;
  static constexpr int B_BYTES = T::SUB / 8 * GROUP;  // +-1 columns of a slot
  static constexpr int RAW_H = T::SUB * 8 + 16;       // packed columns, aligned
  static constexpr int RAW_V = T::SUB + 32;           // their valid bytes
  static constexpr int SMEM = 1024 + T::STAGES * B_BYTES +
                              T::RAW_STAGES * (RAW_H + RAW_V) +
                              (2 * T::STAGES + T::RAW_STAGES) * 8;
  static_assert(T::NCONS == 2 || T::NCONS == 3,
                "four leave 96 registers a thread");
  static_assert(T::SUB % T::WN == 0, "whole n-tiles a step");
  static_assert(T::SUB % 128 == 0, "a producer warp's 32 columns at a time");
  static_assert(SMEM <= 232448, "shared memory");
};

// A block's walk over its units (u = blockIdx.x, + gridDim.x, ...): unit u
// is needle rows [y * BQ, +BQ) of the launch against columns [c0, cend),
// steps of SUB from c0.  Producer and consumers walk alike.
template <class T>
struct Walk {
  static constexpr int SUB = T::SUB, BQ = Shape<T>::BQ;
  int n, units, xc, chunk;
  long long row_base, col_base;
  int u, y, c0, cend;

  template <bool MASKED>
  __device__ __forceinline__ bool unit() {
    for (; u < units; u += gridDim.x) {
      y = u / xc;
      long long cs = static_cast<long long>(u % xc) * chunk;
      cend = static_cast<int>(min(static_cast<long long>(n), cs + chunk));
      if (MASKED) {
        // steps whose columns all lie at or below the unit's first row
        // count nothing: start past them
        const long long d = row_base + static_cast<long long>(y) * BQ -
                            (col_base + cs);
        if (d >= SUB - 1)
          cs += min(static_cast<long long>(chunk),
                    ((d - (SUB - 1)) / SUB + 1) * SUB);
      }
      if (cs < cend) {
        c0 = static_cast<int>(cs);
        return true;
      }
    }
    return false;
  }
  template <bool MASKED>
  __device__ __forceinline__ bool step() {
    c0 += SUB;
    if (c0 < cend) return true;
    u += gridDim.x;
    return unit<MASKED>();
  }
};

// the ring in shared memory, by address
struct Ring {
  uint32_t b;      // STAGES x B_BYTES
  uint32_t raw_h;  // RAW_STAGES x RAW_H
  uint32_t raw_v;  // RAW_STAGES x RAW_V
  uint32_t full, empty;  // STAGES barriers each, 8 bytes apart
  uint32_t raw;          // RAW_STAGES barriers
};

// the bulk copies of a step's packed columns and valid bytes into its
// slot, each from and to 16-byte boundaries around them
template <class T>
__device__ __forceinline__ void issue_step(
    const Ring& r, int slot, const Walk<T>& w,
    const unsigned long long* hay, const unsigned char* valid) {
  typedef Shape<T> S;
  const int cnt = min(T::SUB, w.cend - w.c0);
  const uintptr_t h0 = reinterpret_cast<uintptr_t>(hay + w.c0) & ~uintptr_t(15);
  const uintptr_t h1 = (reinterpret_cast<uintptr_t>(hay + w.c0 + cnt) + 15) &
                       ~uintptr_t(15);
  const uintptr_t v0 = reinterpret_cast<uintptr_t>(valid + w.c0) & ~uintptr_t(15);
  const uintptr_t v1 = (reinterpret_cast<uintptr_t>(valid + w.c0 + cnt) + 15) &
                       ~uintptr_t(15);
  const uint32_t bar = r.raw + 8 * slot;
  bar_expect(bar, static_cast<uint32_t>((h1 - h0) + (v1 - v0)));
  bulk_load(r.raw_h + slot * S::RAW_H, reinterpret_cast<const void*>(h0),
            static_cast<uint32_t>(h1 - h0), bar);
  bulk_load(r.raw_v + slot * S::RAW_V, reinterpret_cast<const void*>(v0),
            static_cast<uint32_t>(v1 - v0), bar);
}

template <class T, bool MASKED>
__device__ __forceinline__ void producer(
    const Ring& r, Walk<T> w, const unsigned long long* __restrict__ hay,
    const unsigned char* __restrict__ valid, int t) {
  typedef Shape<T> S;
  constexpr int SUB = T::SUB, STAGES = T::STAGES, RAW_STAGES = T::RAW_STAGES;
  const int tid = threadIdx.x;  // 0..127
  const uint32_t fold = T::bias_word(t, true), never = T::bias_word(t, false);
  bool more = w.template unit<MASKED>();
  Walk<T> fill = w;  // thread 0's copy cursor, RAW_STAGES steps ahead
  bool fmore = more;
  if (tid == 0)
    for (int k = 0; k < RAW_STAGES && fmore; ++k) {
      issue_step(r, k, fill, hay, valid);
      fmore = fill.template step<MASKED>();
    }
  for (int i = 0; more; ++i) {
    const int slot = i % STAGES, rslot = i % RAW_STAGES;
    // the packed columns are in; the consumers left the slot
    bar_wait(r.raw + 8 * rslot, (i / RAW_STAGES) & 1);
    bar_wait(r.empty + 8 * slot, ((i / STAGES) & 1) ^ 1);
    const int cnt = min(SUB, w.cend - w.c0);
    const int oh = static_cast<int>(reinterpret_cast<uintptr_t>(hay + w.c0) & 15);
    const int ov = static_cast<int>(reinterpret_cast<uintptr_t>(valid + w.c0) & 15);
    const uint32_t rh = r.raw_h + rslot * S::RAW_H + oh;
    const uint32_t rv = r.raw_v + rslot * S::RAW_V + ov;
    const uint32_t sb = r.b + slot * S::B_BYTES;
    // a warp takes 32 consecutive columns an iteration: its 16-byte stores
    // fill four core matrices' rows, 512 contiguous bytes
#pragma unroll
    for (int half = 0; half < SUB / 128; ++half) {
      const int j = (tid >> 5) * (SUB / 4) + half * 32 + (tid & 31);
      unsigned long long h = 0;
      bool ok = false;
      if (j < cnt) {
        h = lds64(rh + 8 * j);
        ok = lds8(rv + j) != 0;
      }
      const uint32_t col = sb + (j >> 3) * S::GROUP + (j & 7) * 16;
#pragma unroll
      for (int kc = 0; kc < S::CHUNKS; ++kc)
        sts128(col + kc * 128, T::word(h, 4 * kc), T::word(h, 4 * kc + 1),
               T::word(h, 4 * kc + 2), T::word(h, 4 * kc + 3));
      sts128(col + S::CHUNKS * 128, ok ? fold : never, 0, 0, 0);
    }
    // the stores are generic-proxy writes that wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1, 128);  // every producer thread is done with the slot
    if (tid == 0) {
      bar_arrive(r.full + 8 * slot);
      if (fmore) {  // into the packed slot just read
        issue_step(r, rslot, fill, hay, valid);
        fmore = fill.template step<MASKED>();
      }
    }
    more = w.template step<MASKED>();
  }
}

// mode 0: the tile lies at or below the diagonal (or past a ragged
// batch), nothing counts; 1: every pair counts; 2: its masked pairs,
// those at or below dm, are left out
template <class T>
__device__ __forceinline__ void count_tile(typename T::Acc (&acc)[T::NACC],
                                           int mode, int dm, int thr,
                                           int (&cnt)[2]) {
  acc_fence(acc);
  if (mode == 2)
    T::template count_rows<true>(acc, dm, thr, cnt);
  else if (mode)
    T::template count_rows<false>(acc, dm, thr, cnt);
}

template <class T, bool MASKED>
__device__ __forceinline__ void consumer(
    const Ring& r, Walk<T> w, const unsigned long long* __restrict__ needles,
    int q, int* __restrict__ out) {
  typedef Shape<T> S;
  constexpr int WN = T::WN, KS = T::KSTEPS;
  // consumer 0 .. NCONS - 1, read through a shuffle so that the compiler
  // knows it is the same in every lane: wgmma must not sit in a divergent
  // path
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
  const int tid = threadIdx.x & 127;
  const int wp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  // a masked pair: its column less its row within the tile is
  // 8k + (e & 1) - 8 (e >> 1) + thr, at or below the tile's offset
  const int thr = 2 * qd - 16 * wp - g;
  uint32_t a[KS + 1][4];
  typename T::Acc acc[T::NACC];
  bool more = w.template unit<MASKED>();
  int i = 0;  // the block's step count: the ring's slot and phase
  while (more) {
    const int r0 = w.y * S::BQ + c * 64;  // the consumer's first row
    // its needle rows as A fragments, negated, unpacked once a unit.  A k
    // step is 32 bytes in either type (PTX ISA, wgmma A in registers:
    // register 2h + r holds row 16 wp + g + 8r, bytes 16h + 4qd + 0..3 of
    // the step), so word 8s + 4h + qd of the row's +-1 vector; the bias
    // step's first word holds A's bias lanes
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 16 * wp + g + 8 * rr;
      const unsigned long long h = row < q ? ~needles[row] : 0ull;
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          a[s][2 * hf + rr] = T::word(h, 8 * s + 4 * hf + qd);
      a[KS][rr] = qd == 0 ? T::A_BIAS : 0u;
      a[KS][2 + rr] = 0u;
    }
    // held as they are: the compiler would otherwise recompute them from
    // the needle words before every product
#pragma unroll
    for (int e = 0; e < 4 * (KS + 1); ++e) asm volatile("" : "+r"(a[e >> 2][e & 3]));
    int cnt[2] = {0, 0};  // hits of rows g and g + 8
    const bool idle = r0 >= q;  // a ragged launch's empty consumer
    do {
      const int slot = i % T::STAGES;
      bar_wait(r.full + 8 * slot, (i / T::STAGES) & 1);
      const uint32_t sb = r.b + slot * S::B_BYTES;
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        // the tile's column less its row at its corner: pairs at or below
        // it are masked
        const long long d = w.row_base + r0 - (w.col_base + w.c0 + nt * WN);
        const int mode =
            idle ? 0 : !MASKED ? 1 : d >= WN - 1 ? 0 : d < -63 ? 1 : 2;
        const int dm = mode == 2 ? static_cast<int>(d) : 0;
        // the last count's reads land before the products start
        acc_fence(acc);
        wgmma_fence();
        // the product runs even where its sums are not counted, so that no
        // wgmma sits in a branch; the bias step starts the sums
        const uint32_t tile = sb + nt * (WN / 8) * S::GROUP;
        T::template mma<0>(acc, a[KS], b_desc(tile + KS * 256, 0, S::GROUP));
#pragma unroll
        for (int s = 0; s < KS; ++s)
          T::template mma<1>(acc, a[s], b_desc(tile + s * 256, 128, S::GROUP));
        wgmma_commit();
        wgmma_wait<0>();
        count_tile<T>(acc, mode, dm, thr, cnt);
      }
      if (lane == 0) bar_arrive(r.empty + 8 * slot);
      ++i;
      w.c0 += T::SUB;
    } while (w.c0 < w.cend);
    // the four lanes of a quad hold the same two rows
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      int v = cnt[rr];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int row = r0 + 16 * wp + g + 8 * rr;
      if (qd == 0 && row < q && v) atomicAdd(out + row, v);
    }
    w.u += gridDim.x;
    more = w.template unit<MASKED>();
  }
}

template <class T, bool MASKED>
__global__ void __launch_bounds__(Shape<T>::THREADS, 1)
wgmma_count_kernel(const unsigned long long* __restrict__ needles, int q,
                   const unsigned long long* __restrict__ hay,
                   const unsigned char* __restrict__ valid, int n, int t,
                   long long row_base, long long col_base, int units, int xc,
                   int chunk, int* __restrict__ out) {
  typedef Shape<T> S;
  constexpr int STAGES = T::STAGES, RAW_STAGES = T::RAW_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring r;
  r.b = saddr(base);
  r.raw_h = r.b + STAGES * S::B_BYTES;
  r.raw_v = r.raw_h + RAW_STAGES * S::RAW_H;
  const uint32_t bars = r.raw_v + RAW_STAGES * S::RAW_V;
  r.full = bars;
  r.empty = bars + 8 * STAGES;
  r.raw = bars + 16 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(r.full + 8 * s, 1);
      bar_init(r.empty + 8 * s, 4 * T::NCONS);  // a lane of each consumer warp
    }
    for (int s = 0; s < RAW_STAGES; ++s) bar_init(r.raw + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  Walk<T> w;
  w.n = n; w.units = units; w.xc = xc; w.chunk = chunk;
  w.row_base = row_base; w.col_base = col_base;
  w.u = blockIdx.x;
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    producer<T, MASKED>(r, w, hay, valid, t);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(S::CONS_REGS));
    consumer<T, MASKED>(r, w, needles, q, out);
  }
}

template <class T, bool MASKED>
cudaError_t launch_wgmma(const unsigned long long* nd, int q,
                         const unsigned long long* hs, const bool* vd, int n,
                         int t, long long row_base, long long col_base, int* o,
                         cudaStream_t s) {
  typedef Shape<T> S;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // units of BQ rows x a chunk of whole steps; one block an SM walks
  // every gridDim-th unit.  The chunk minimises the slowest SM's steps,
  // each unit costing UNIT_COST steps more (its A fragments, its counts'
  // atomics), over at most 16 units an SM
  const long long ytiles = (static_cast<long long>(q) + S::BQ - 1) / S::BQ;
  const long long steps = (static_cast<long long>(n) + T::SUB - 1) / T::SUB;
  long long best_ch = steps, best_cost = -1;
  for (long long xc = 1; xc <= steps; ++xc) {
    const long long ch = (steps + xc - 1) / xc;
    if ((steps + ch - 1) / ch != xc) continue;  // the same chunk as before
    const long long units = ytiles * xc;
    if (xc > 1 && units > 16LL * sms) break;
    const long long cost = (units + sms - 1) / sms * (ch + UNIT_COST);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_ch = ch;
    }
  }
  const int xc = static_cast<int>((steps + best_ch - 1) / best_ch);
  const long long units = ytiles * xc;
  if (units > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_count_kernel<T, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(units < sms ? units : sms);
  wgmma_count_kernel<T, MASKED><<<grid, S::THREADS, S::SMEM, s>>>(
      nd, q, hs, reinterpret_cast<const unsigned char*>(vd), n, t, row_base,
      col_base, static_cast<int>(units), xc,
      static_cast<int>(best_ch * T::SUB), o);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch(const unsigned long long* nd, int q,
                   const unsigned long long* hs, const bool* vd, int n, int t,
                   int masked, long long row_base, long long col_base, int* o,
                   cudaStream_t s) {
  return masked ? launch_wgmma<T, true>(nd, q, hs, vd, n, t, row_base,
                                        col_base, o, s)
                : launch_wgmma<T, false>(nd, q, hs, vd, n, t, row_base,
                                         col_base, o, s);
}

}  // namespace

extern "C" int cbird_count_below_mma(const void* needles, int q,
                                     const void* hay, const void* valid, int n,
                                     int t, int bf16, int masked,
                                     long long row_base, long long col_base,
                                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)q, s);
  if (err != cudaSuccess || q == 0 || n == 0) return (int)err;
  auto nd = static_cast<const unsigned long long*>(needles);
  auto hs = static_cast<const unsigned long long*>(hay);
  auto vd = static_cast<const bool*>(valid);
  auto o = static_cast<int*>(out);
  err = bf16 ? launch<BF16>(nd, q, hs, vd, n, t, masked, row_base, col_base,
                            o, s)
             : launch<E4M3>(nd, q, hs, vd, n, t, masked, row_base, col_base,
                            o, s);
  return (int)err;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
