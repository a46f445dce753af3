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
// yardstick.
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
// tensor rate at one instruction a pair.  mma.sync, Ampere's instruction,
// sustains half the int8 peak at best on this card (chip_bounds.py), so the
// main form is built on wgmma, and its count on the FMA pipe.
//
// The main form (wgmma_count_kernel): a block of four warpgroups, one
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

// The bf16 form (mma_count_kernel, K1-v mxu_count_bf16, no main-path
// launches) stays on the mma.sync form: each warp holds 4 m16 tiles
// of needles as A fragments; a block of 8 warps streams its columns in
// steps of 256, unpacked once into shared memory in the B fragment order;
// four m16n8k16 bf16 steps with f32 sums (exact, |dot| <= 64), init
// 64 - 2t + 0.5 so that c is never a signed zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ e4m3: wgmma
constexpr int STAGES = 2;         // ring slots of unpacked columns
constexpr int RAW_STAGES = 4;     // slots of packed columns: copies ahead
constexpr int SUB = 1024;         // haystack columns a step (a slot)
constexpr int NCONS = 3;          // consumer warpgroups
constexpr int UNIT_COST = 1;      // a unit's fixed cost in steps (grid)
constexpr int WN = 256;           // columns of one wgmma: an n-tile

constexpr int NT = SUB / WN;             // n-tiles a step
constexpr int NACC = WN / 4;             // f16 sums, two a register
// bytes of 8 columns: four 16-byte k chunks of +-1 and a fifth that holds
// the bias lanes (the bias k32 step reads it twice, LBO 0)
constexpr int GROUP = 8 * 16 * 5;
constexpr int BQ = NCONS * 64;           // needle rows a unit
constexpr int WG_THREADS = 128 * (1 + NCONS);  // a producer, the consumers
// registers a thread after setmaxnreg: 40 the producer, the rest the
// consumers (a multiple of 8)
constexpr int CONS_REGS = (65536 - 128 * 40) / (128 * NCONS) / 8 * 8;
static_assert(NCONS == 2 || NCONS == 3, "four leave 96 registers a thread");
static_assert(SUB % WN == 0, "whole n-tiles a step");

constexpr int B_BYTES = SUB / 8 * GROUP;       // +-1 columns of a slot
constexpr int RAW_H = SUB * 8 + 16;            // packed columns, aligned
constexpr int RAW_V = SUB + 32;                // their valid bytes
constexpr int SMEM = 1024 + STAGES * B_BYTES + RAW_STAGES * (RAW_H + RAW_V) +
                     (2 * STAGES + RAW_STAGES) * 8;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// waits for the phase of the given parity; a wait of 2^34 clocks (~8 s)
// means a broken ring, and traps rather than holding the card
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared-memory stores and loads by address: the ring's buffers are
// reached through computed addresses, and generic ones would cost a check
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t x, uint32_t y,
                                       uint32_t z, uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(x), "r"(y), "r"(z), "r"(w) : "memory");
}
__device__ __forceinline__ unsigned long long lds64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared.b64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t lds8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// word w (0..15) of a hash's +-1 vector: byte b is +1 (e4m3 0x38) for a
// clear bit, -1 (0xB8) for a set one, of bit 32 * (w >> 3) + 8 * b +
// (w & 7).  A and B use the same order of the 64 lanes, so the dot does
// not depend on it; this one takes three instructions a word and no table.
__device__ __forceinline__ uint32_t pm1_word(unsigned long long h, int w) {
  const uint32_t x = static_cast<uint32_t>(h >> (32 * (w >> 3))) >> (w & 7);
  return (x & 0x01010101u) * 0x80u + 0x38383838u;
}

// e4m3 of v = 0..15, 16, 32, 48 or 64, exact
__device__ __forceinline__ uint32_t e4m3(int v) {
  if (v == 0) return 0;
  const int e = 31 - __clz(v);
  return static_cast<uint32_t>(((e + 7) << 3) | (((v << 3) >> e) & 7));
}

// a counted column's bias lanes 64 and 65 (A's are +1): 64 - 2t as the
// multiple of 16 and the rest; a column that never counts: 448, over any
// dot
__device__ __forceinline__ uint32_t bias_word(int t, bool counted) {
  if (!counted) return 0x7Eu;
  const int b = 64 - 2 * t;
  const uint32_t sign = b < 0 ? 0x80u : 0u;
  const int a = b < 0 ? -b : b;
  return (e4m3(a & ~15) | sign) | ((e4m3(a & 15) | sign) << 8);
}

// B descriptor (K-major, no swizzle): core matrices of 8 columns x 16
// bytes; the next 16 bytes of k (LBO) lbo bytes on, the next 8 columns
// (SBO) GROUP bytes on
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t lbo = 128) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(GROUP >> 4) << 32);
}

// d (+)= A (64 x 32 e4m3, registers) x B (32 x 256 e4m3, shared memory),
// f16 sums two a register; d is zeroed first where SCALE_D is 0
#define D8(i)                                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
template <int SCALE_D>
__device__ __forceinline__ void mma_e4m3(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.f16.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}
#undef D8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}
// the sums are read only after the wait: keep the compiler from moving
// their reads above it
template <int N>
__device__ __forceinline__ void acc_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A block's walk over its units (u = blockIdx.x, + gridDim.x, ...): unit u
// is needle rows [y * BQ, +BQ) of the launch against columns [c0, cend),
// steps of SUB from c0.  Producer and consumers walk alike.
struct Walk {
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
__device__ __forceinline__ void issue_step(
    const Ring& r, int slot, const Walk& w,
    const unsigned long long* hay, const unsigned char* valid) {
  const int cnt = min(SUB, w.cend - w.c0);
  const uintptr_t h0 = reinterpret_cast<uintptr_t>(hay + w.c0) & ~uintptr_t(15);
  const uintptr_t h1 = (reinterpret_cast<uintptr_t>(hay + w.c0 + cnt) + 15) &
                       ~uintptr_t(15);
  const uintptr_t v0 = reinterpret_cast<uintptr_t>(valid + w.c0) & ~uintptr_t(15);
  const uintptr_t v1 = (reinterpret_cast<uintptr_t>(valid + w.c0 + cnt) + 15) &
                       ~uintptr_t(15);
  const uint32_t bar = r.raw + 8 * slot;
  bar_expect(bar, static_cast<uint32_t>((h1 - h0) + (v1 - v0)));
  bulk_load(r.raw_h + slot * RAW_H, reinterpret_cast<const void*>(h0),
            static_cast<uint32_t>(h1 - h0), bar);
  bulk_load(r.raw_v + slot * RAW_V, reinterpret_cast<const void*>(v0),
            static_cast<uint32_t>(v1 - v0), bar);
}

template <bool MASKED>
__device__ __forceinline__ void producer(
    const Ring& r, Walk w, const unsigned long long* __restrict__ hay,
    const unsigned char* __restrict__ valid, int t) {
  const int tid = threadIdx.x;  // 0..127
  const uint32_t fold = bias_word(t, true), never = bias_word(t, false);
  bool more = w.unit<MASKED>();
  Walk fill = w;  // thread 0's copy cursor, RAW_STAGES steps ahead
  bool fmore = more;
  if (tid == 0)
    for (int k = 0; k < RAW_STAGES && fmore; ++k) {
      issue_step(r, k, fill, hay, valid);
      fmore = fill.step<MASKED>();
    }
  for (int i = 0; more; ++i) {
    const int slot = i % STAGES, rslot = i % RAW_STAGES;
    // the packed columns are in; the consumers left the slot
    bar_wait(r.raw + 8 * rslot, (i / RAW_STAGES) & 1);
    bar_wait(r.empty + 8 * slot, ((i / STAGES) & 1) ^ 1);
    const int cnt = min(SUB, w.cend - w.c0);
    const int oh = static_cast<int>(reinterpret_cast<uintptr_t>(hay + w.c0) & 15);
    const int ov = static_cast<int>(reinterpret_cast<uintptr_t>(valid + w.c0) & 15);
    const uint32_t rh = r.raw_h + rslot * RAW_H + oh;
    const uint32_t rv = r.raw_v + rslot * RAW_V + ov;
    const uint32_t sb = r.b + slot * B_BYTES;
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
      const uint32_t col = sb + (j >> 3) * GROUP + (j & 7) * 16;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        sts128(col + kc * 128, pm1_word(h, 4 * kc), pm1_word(h, 4 * kc + 1),
               pm1_word(h, 4 * kc + 2), pm1_word(h, 4 * kc + 3));
      sts128(col + 4 * 128, ok ? fold : never, 0, 0, 0);
    }
    // the stores are generic-proxy writes that wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1, 128);  // every producer thread is done with the slot
    if (tid == 0) {
      bar_arrive(r.full + 8 * slot);
      if (fmore) {  // into the packed slot just read
        issue_step(r, rslot, fill, hay, valid);
        fmore = fill.step<MASKED>();
      }
    }
    more = w.step<MASKED>();
  }
}

// One n-tile's sums into the hit counts of rows g and g + 8 (MASK: less
// the pairs whose column is at or below their row).  acc[2k + r] holds
// row g + 8r, columns 8k + 2qd and + 1, as f16 c.  A hit is -c saturated
// to 1 (HADD2.SAT: two pairs an instruction on the FMA pipe, 32 lanes a
// clock); the hits are summed in f16 (at most 64 a row, exact) and added
// to the row's count as an integer.
template <bool MASK, int N>
__device__ __forceinline__ void count_rows(const int (&acc)[N], int dm,
                                           int thr, int (&cnt)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t part[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
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

// mode 0: the tile lies at or below the diagonal (or past a ragged
// batch), nothing counts; 1: every pair counts; 2: its masked pairs,
// those at or below dm, are left out
template <int N>
__device__ __forceinline__ void count_tile(int (&acc)[N], int mode, int dm,
                                           int thr, int (&cnt)[2]) {
  acc_fence(acc);
  if (mode == 2)
    count_rows<true>(acc, dm, thr, cnt);
  else if (mode)
    count_rows<false>(acc, dm, thr, cnt);
}

template <bool MASKED>
__device__ __forceinline__ void consumer(
    const Ring& r, Walk w, const unsigned long long* __restrict__ needles,
    int q, int* __restrict__ out) {
  // consumer 0 .. NCONS - 1, read through a shuffle so that the compiler
  // knows it is the same in every lane: wgmma must not sit in a divergent
  // path
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
  const int tid = threadIdx.x & 127;
  const int wp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  // a masked pair: its column less its row within the tile is
  // 8k + (e & 1) - 8 (e >> 1) + thr, at or below the tile's offset
  const int thr = 2 * qd - 16 * wp - g;
  uint32_t a[3][4];
  int acc[NACC];
  bool more = w.unit<MASKED>();
  int i = 0;  // the block's step count: the ring's slot and phase
  while (more) {
    const int r0 = w.y * BQ + c * 64;  // the consumer's first row
    // its needle rows as A fragments (PTX ISA, wgmma .m64nNk32 8-bit A:
    // register 2h + r holds row 16 wp + g + 8r, k = 16h + 4qd + 0..3),
    // negated, unpacked once a unit; the bias step's A lanes 64 and 65
    // are 1
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 16 * wp + g + 8 * rr;
      const unsigned long long h = row < q ? ~needles[row] : 0ull;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          a[s][2 * hf + rr] = pm1_word(h, 8 * s + 4 * hf + qd);
      a[2][rr] = qd == 0 ? 0x3838u : 0u;
      a[2][2 + rr] = 0u;
    }
    // held as they are: the compiler would otherwise recompute them from
    // the needle words before every product
#pragma unroll
    for (int e = 0; e < 12; ++e) asm volatile("" : "+r"(a[e >> 2][e & 3]));
    int cnt[2] = {0, 0};  // hits of rows g and g + 8
    const bool idle = r0 >= q;  // a ragged launch's empty consumer
    do {
      const int slot = i % STAGES;
      bar_wait(r.full + 8 * slot, (i / STAGES) & 1);
      const uint32_t sb = r.b + slot * B_BYTES;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
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
        const uint32_t tile = sb + nt * (WN / 8) * GROUP;
        mma_e4m3<0>(acc, a[2], b_desc(tile + 4 * 128, 0));
        mma_e4m3<1>(acc, a[0], b_desc(tile));
        mma_e4m3<1>(acc, a[1], b_desc(tile + 256));
        wgmma_commit();
        wgmma_wait<0>();
        count_tile(acc, mode, dm, thr, cnt);
      }
      if (lane == 0) bar_arrive(r.empty + 8 * slot);
      ++i;
      w.c0 += SUB;
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
    more = w.unit<MASKED>();
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_count_kernel(const unsigned long long* __restrict__ needles, int q,
                   const unsigned long long* __restrict__ hay,
                   const unsigned char* __restrict__ valid, int n, int t,
                   long long row_base, long long col_base, int units, int xc,
                   int chunk, int* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring r;
  r.b = saddr(base);
  r.raw_h = r.b + STAGES * B_BYTES;
  r.raw_v = r.raw_h + RAW_STAGES * RAW_H;
  const uint32_t bars = r.raw_v + RAW_STAGES * RAW_V;
  r.full = bars;
  r.empty = bars + 8 * STAGES;
  r.raw = bars + 16 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(r.full + 8 * s, 1);
      bar_init(r.empty + 8 * s, 4 * NCONS);  // a lane of each consumer warp
    }
    for (int s = 0; s < RAW_STAGES; ++s) bar_init(r.raw + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  Walk w;
  w.n = n; w.units = units; w.xc = xc; w.chunk = chunk;
  w.row_base = row_base; w.col_base = col_base;
  w.u = blockIdx.x;
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    producer<MASKED>(r, w, hay, valid, t);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONS_REGS));
    consumer<MASKED>(r, w, needles, q, out);
  }
}

template <bool MASKED>
cudaError_t launch_wgmma(const unsigned long long* nd, int q,
                         const unsigned long long* hs, const bool* vd, int n,
                         int t, long long row_base, long long col_base, int* o,
                         cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // units of BQ rows x a chunk of whole steps; one block an SM walks
  // every gridDim-th unit.  The chunk minimises the slowest SM's steps,
  // each unit costing UNIT_COST steps more (its A fragments, its counts'
  // atomics), over at most 16 units an SM
  const long long ytiles = (static_cast<long long>(q) + BQ - 1) / BQ;
  const long long steps = (static_cast<long long>(n) + SUB - 1) / SUB;
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
      wgmma_count_kernel<MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(units < sms ? units : sms);
  wgmma_count_kernel<MASKED><<<grid, WG_THREADS, SMEM, s>>>(
      nd, q, hs, reinterpret_cast<const unsigned char*>(vd), n, t, row_base,
      col_base, static_cast<int>(units), xc,
      static_cast<int>(best_ch * SUB), o);
  return cudaGetLastError();
}

// ----------------------------------------------------- bf16: mma.sync
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MT16 = 4;                // m16 tiles per warp
constexpr int WR = MT16 * 16;          // needle rows per warp
constexpr int BQ16 = WARPS * WR;       // needles per block
constexpr int SUB16 = 256;             // haystack columns per step
constexpr int NT8 = SUB16 / 8;         // n8 tiles per step

struct BF16 {  // bf16 operands, f32 sums
  static constexpr int KS = 16;
  static constexpr int STEPS = 64 / KS;
  static constexpr int EPR = 2;
  typedef float Acc;
  typedef float2 Acc2;
  __device__ static Acc fold(int t) { return 64.5f - 2.0f * t; }
  __device__ static Acc never() { return 1048576.0f; }
  __device__ static int sign(Acc c) { return (int)(__float_as_uint(c) >> 31); }
  // +1.0 is 0x3F80; the bit sets the sign of its half
  __device__ static uint32_t unpack(unsigned long long h, int pos) {
    const uint32_t x = (uint32_t)(h >> pos) & 3u;
    return 0x3F803F80u | ((x & 1u) << 15) | ((x & 2u) << 30);
  }
  __device__ static void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                             uint32_t b1, const Acc (&c)[4]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  }
};

// floor(x / 8) clamped to [lo, NT8]: an n8 tile index
__device__ __forceinline__ int tile_at(long long x, int lo) {
  const long long f = x >= 0 ? x / 8 : -((7 - x) / 8);
  return f < lo ? lo : (f > NT8 ? NT8 : (int)f);
}

// One n8 tile of the step in shared memory against the warp's m tiles.
// MASK: rel is the tile's first column less the warp's first row (global
// ids); a pair counts only where its column exceeds its row.
template <class T, bool MASK>
__device__ __forceinline__ void n8_tile(
    int nt, int rel, const uint32_t* sb, const typename T::Acc* sinit,
    const uint32_t (&a)[MT16][T::STEPS][4], int (&cnt)[MT16][2], int lane,
    int g, int qd) {
  typedef typename T::Acc Acc;
  constexpr int NB = 2 * T::STEPS;  // B registers per lane per n8 tile
  uint32_t b[NB];
  const uint4* src = reinterpret_cast<const uint4*>(sb + (nt * 32 + lane) * NB);
#pragma unroll
  for (int v = 0; v < NB / 4; ++v) {
    const uint4 w = src[v];
    b[4 * v] = w.x; b[4 * v + 1] = w.y; b[4 * v + 2] = w.z; b[4 * v + 3] = w.w;
  }
  const typename T::Acc2 init =
      reinterpret_cast<const typename T::Acc2*>(sinit)[nt * 4 + qd];
  const Acc i0 = init.x, i1 = init.y;
  Acc c[MT16][4];
#pragma unroll
  for (int m = 0; m < MT16; ++m) {
    c[m][0] = c[m][2] = i0;
    c[m][1] = c[m][3] = i1;
    if (MASK) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (rel + 2 * qd + (e & 1) <= m * 16 + g + 8 * (e >> 1)) c[m][e] = T::never();
    }
  }
  // k-steps outer: the m tiles' products are independent of each other
#pragma unroll
  for (int s = 0; s < T::STEPS; ++s)
#pragma unroll
    for (int m = 0; m < MT16; ++m)
      T::mma(c[m], a[m][s], b[2 * s], b[2 * s + 1], c[m]);
#pragma unroll
  for (int m = 0; m < MT16; ++m) {
    cnt[m][0] += T::sign(c[m][0]) + T::sign(c[m][1]);
    cnt[m][1] += T::sign(c[m][2]) + T::sign(c[m][3]);
  }
}

// Fragment order (PTX ISA, mma.m16n8k16 bf16): lane = 4g + q.  A register
// 2h + r of k-step s holds row g + 8r, k = s*KS + h*KS/2 + q*EPR and its
// next EPR - 1; B register 2s + h holds column g at the same k.  The sums
// land at rows g (c0, c1) and g + 8 (c2, c3), columns 2q and 2q + 1.
template <class T, bool MASKED>
__global__ void __launch_bounds__(THREADS)
mma_count_kernel(const unsigned long long* __restrict__ needles, int q,
                 const unsigned long long* __restrict__ hay,
                 const bool* __restrict__ valid, int n, int t,
                 long long row_base, long long col_base, int cols_per_block,
                 int* __restrict__ out) {
  typedef typename T::Acc Acc;
  constexpr int NB = 2 * T::STEPS;
  __shared__ __align__(16) uint32_t sb[NT8 * 32 * NB];
  __shared__ __align__(8) Acc sinit[SUB16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;

  int c_begin = blockIdx.x * cols_per_block;
  const int c_end = min(n, c_begin + cols_per_block);
  if (MASKED) {
    // steps whose columns all lie at or below the block's first row
    // count nothing: start past them, or leave (the whole block at once)
    const long long d = row_base + (long long)blockIdx.y * BQ16
                        - (col_base + c_begin);
    if (d >= SUB16 - 1) {
      const long long skip = ((d - (SUB16 - 1)) / SUB16 + 1) * SUB16;
      if (skip >= c_end - c_begin) return;
      c_begin += (int)skip;
    }
  }

  // this warp's needle rows as A fragments, negated, unpacked once
  const int r0 = blockIdx.y * BQ16 + warp * WR;
  uint32_t a[MT16][T::STEPS][4];
#pragma unroll
  for (int m = 0; m < MT16; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + m * 16 + g + 8 * r;
      const bool in = row < q;
      const unsigned long long h = in ? ~needles[row] : 0ull;
#pragma unroll
      for (int s = 0; s < T::STEPS; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          a[m][s][2 * hf + r] =
              in ? T::unpack(h, s * T::KS + hf * (T::KS / 2) + qd * T::EPR)
                 : 0u;
    }
  }
  int cnt[MT16][2];
#pragma unroll
  for (int m = 0; m < MT16; ++m) cnt[m][0] = cnt[m][1] = 0;

  for (int c0 = c_begin; c0 < c_end; c0 += SUB16) {
    // stage: item i is column j = i / 4 for lane 4 * (j % 8) + i % 4 of
    // n8 tile j / 8, whose B registers lie at sb + i * NB: consecutive
    // items fill consecutive 16 bytes, so the stores meet no bank conflict
    for (int i = threadIdx.x; i < 4 * SUB16; i += THREADS) {
      const int j = i >> 2, lq = i & 3;
      const int col = c0 + j;
      const bool in = col < c_end;
      const unsigned long long h = in ? hay[col] : 0ull;
      if (lq == 0) sinit[j] = (in && valid[col]) ? T::fold(t) : T::never();
      uint32_t w[NB];
#pragma unroll
      for (int s = 0; s < T::STEPS; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          w[2 * s + hf] =
              T::unpack(h, s * T::KS + hf * (T::KS / 2) + lq * T::EPR);
      uint4* dst = reinterpret_cast<uint4*>(sb + i * NB);
#pragma unroll
      for (int v = 0; v < NB / 4; ++v)
        dst[v] = make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
    }
    __syncthreads();
    if (r0 >= q) {
      // a ragged batch's empty warp: nothing to count
    } else if (MASKED) {
      // n8 tiles [0, lo) lie at or below the warp's first row, [lo, hi)
      // straddle its rows, [hi, NT8) lie past its last row
      const long long d = row_base + r0 - (col_base + c0);
      const int lo = tile_at(d + 1, 0), hi = tile_at(d + WR + 7, lo);
      for (int nt = lo; nt < hi; ++nt)
        n8_tile<T, true>(nt, 8 * nt - (int)d, sb, sinit, a, cnt, lane, g, qd);
#pragma unroll 4
      for (int nt = hi; nt < NT8; ++nt)
        n8_tile<T, false>(nt, 0, sb, sinit, a, cnt, lane, g, qd);
    } else {
#pragma unroll 4
      for (int nt = 0; nt < NT8; ++nt)
        n8_tile<T, false>(nt, 0, sb, sinit, a, cnt, lane, g, qd);
    }
    __syncthreads();
  }

  // the four lanes of a quad hold the same two rows
#pragma unroll
  for (int m = 0; m < MT16; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int v = cnt[m][r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int row = r0 + m * 16 + g + 8 * r;
      if (qd == 0 && row < q && v) atomicAdd(out + row, v);
    }
}

template <bool MASKED>
cudaError_t launch_bf16(const unsigned long long* nd, int q,
                        const unsigned long long* hs, const bool* vd, int n,
                        int t, long long row_base, long long col_base, int* o,
                        cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // gridDim.y is at most 65535 needle tiles: launch in slices of that
  const int step = 65535 * BQ16;
  cudaError_t err = cudaSuccess;
  for (int q0 = 0; q0 < q; q0 += step) {
    const int qs = min(step, q - q0);
    const int ytiles = (qs + BQ16 - 1) / BQ16;
    // split the columns so that ~16 blocks per SM are in the grid, each a
    // whole number of steps
    const int xb = max(1, (16 * sms + ytiles - 1) / ytiles);
    int cols = (n + xb - 1) / xb;
    cols = (cols + SUB16 - 1) / SUB16 * SUB16;
    const dim3 grid((n + cols - 1) / cols, ytiles);
    mma_count_kernel<BF16, MASKED><<<grid, THREADS, 0, s>>>(
        nd + q0, qs, hs, vd, n, t, row_base + q0, col_base, cols, o + q0);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
  }
  return err;
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
  if (bf16)
    err = masked ? launch_bf16<true>(nd, q, hs, vd, n, t, row_base, col_base, o, s)
                 : launch_bf16<false>(nd, q, hs, vd, n, t, row_base, col_base, o, s);
  else
    err = masked ? launch_wgmma<true>(nd, q, hs, vd, n, t, row_base, col_base, o, s)
                 : launch_wgmma<false>(nd, q, hs, vd, n, t, row_base, col_base, o, s);
  return (int)err;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
