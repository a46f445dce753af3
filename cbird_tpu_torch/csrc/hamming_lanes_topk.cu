// Exact per-needle k nearest 256-bit rows (kernel K5 of the port).
//
// Replaces cbird_tpu/ops/hamming.py hamming_lanes_topk (XLA: the lane
// distances of _chunk_dists_lanes and approx_min_k over 16k-row chunks),
// the k-nearest search of the orb index over 256-bit ORB descriptors:
// torch has neither a popcount nor approx_min_k.
//
// Contract (with the wrapper in ops/hamming_lanes.py): for each needle, the
// k valid rows with the smallest (distance, row) key among those at
// distance < bound (bound 257: every row), ascending; empty slots are
// (0x7FFF, -1).  A row is four 64-bit words.  Keys are unique, so the
// answer is exact and ties go to the lower row.  k <= 10 (the orb index's
// k; a larger list is a new instantiation).
//
// What bounds it on an H100: its +-1 product over K = 256, 512 tensor
// operations a pair at 1,979 TOPS dense (int8 and e4m3 alike): 0.278 ms per
// 2^30 pairs, 16 pairs a clock per SM.  Each unit of 192 needles reads the
// haystack packed (33 bytes a row), far under the memory bound at the orb
// index's needle counts; a pre-unpacked +-1 copy would read 256 bytes a row
// and pass it.
//
// The main form (lanes_wgmma, cbird_lanes_topk) is K1-mma's block
// (count_below_mma.cu) with a top-k epilogue: four warpgroups, one producer
// and three consumers, one block an SM, persistent over units of BQ = 192
// needles x a chunk of whole steps of SUB = 256 columns (one n-tile).
// - Operands e4m3 +-1 (bit 0 -> +1, 1 -> -1: 0x38, 0xB8, exact), sums f16
//   (|dot| <= 256, exact): dot = 256 - 2d.  A consumer holds its m64 tile of
//   needles as wgmma's A in registers (32 a thread at K = 256) beside the 64
//   f16x2 sums of an m64n256 tile, and runs eight wgmma.mma_async
//   m64n256k32 f16.e4m3.e4m3 a step with B read from shared memory.
// - The producer brings each step's packed rows (32 bytes and a valid
//   byte a column) into RAW_STAGES slots with bulk asynchronous copies,
//   unpacks them into a ring of STAGES slots in the K-major no-swizzle
//   layout the B descriptor reads (a column 256 bytes: a slot 64 KB), packs
//   the valid bytes into 32 bits a 32 columns beside them, fences
//   (fence.proxy.async) and arrives on the slot's full barrier.  The unpack
//   writes as many bytes a step as the three consumers' products read once,
//   so its 16-byte stores must meet no bank conflict: 8 lanes (one
//   wavefront) write one 128-byte row of core matrices (a column's four
//   words in one 8-lane group instead ran 1.35x slower, chip_tune.py k5).
// - The epilogue admits a column of row i only below the row's limit
//   lim_i: the bound, or, once the row's list holds KT keys, its last
//   distance.  It changes only between steps, and a unit visits its
//   columns in ascending order, so a later column at d == lim holds a
//   higher row than every key held: d < lim is exact, with ties to the
//   lower row.  Within a step whole keys are compared.
//   - Common case: per thread and row, the max of its 64 sums (32 packed
//     max.f16x2) against 256 - 2 lim; a warp vote skips the rest when no row
//     of the warp passes: half an instruction a pair.
//   - Rare case (admit): the four threads of the warp's quads take turns
//     (a row's 256 columns lie in its quad, 64 a thread) with one sorted
//     list of KT keys a row in shared memory.  A thread finds its passing
//     sums by groups of 8 registers (a group's max, then its registers),
//     takes each passing register by a select chain, reads its columns'
//     valid bits (only now), and inserts each admitted (d, column) key
//     below the list's last.  After the turns the row's limit is the
//     list's last distance, once it holds KT keys.  In an unbounded call
//     the first steps admit every column and the limit tightens as the
//     list fills, so the admitted columns die out, though with 16 rows a
//     warp the vote still takes the rare case at most steps.
//   - At a unit's end each row's list goes to scratch as (d << 32 | row)
//     keys, one list a chunk; lanes_merge takes a needle's chunks' lists
//     and writes the first k.
// - Validity needs no ninth k-step (K1-mma's bias step): only an admitted
//   column reads its bit.
// What holds it above its bound (chip_tune.py k5's forms that leave a part
// out): the products themselves, as the wgmma probe of chip_bounds.py
// sustains them (~128 clocks an m64n256k32 at the clock under load), and
// the units' padding to 192 rows; the epilogue and the unpack overlap them
// at a bound such as the orb index's.  An unbounded call takes the rare
// case at most steps and runs ~3x longer.
// The PTX helpers (barriers, bulk copies, descriptors, wgmma) are copies of
// count_below_mma.cu's: chip_tune.py rebuilds edits of that file's text.
//
// The popcount form (lanes_scan, cbird_lanes_topk_popc) stays as the
// yardstick; only chip_smoke.py's checks launch it.  A block holds 128
// needles, one a thread, in registers, and walks one split of the haystack:
// 256 rows at a time are staged in shared memory (with each row's validity
// as a distance offset that no bound admits) and read by broadcast; each
// thread computes its needle's distance to every row once (four __popcll)
// and keeps a sorted list of its KT best keys in registers: a key enters
// only below the list's last.  Each (needle, split) list goes to scratch,
// and lanes_merge as above.  Bounded by POPC issue: 8 a pair at 16 a clock
// per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MERGE_THREADS = 256;
// an empty slot: sorts after every d << 32 | row key and unpacks to
// (0x7FFF, -1)
constexpr long long EMPTY = (0x7FFFLL << 32) | 0xFFFFFFFFLL;

// lst ascending; the caller checked key < lst[KT - 1], which drops out
template <int KT>
__device__ __forceinline__ void insert(long long (&lst)[KT], long long key) {
#pragma unroll
  for (int j = KT - 1; j > 0; --j) {
    const long long prev = lst[j - 1];
    lst[j] = prev > key ? prev : (lst[j] > key ? key : lst[j]);
  }
  lst[0] = lst[0] > key ? key : lst[0];
}

template <int KT>
__global__ void __launch_bounds__(MERGE_THREADS)
lanes_merge(const long long* __restrict__ part, int q, int splits, int k,
            int* __restrict__ dists, int* __restrict__ rows) {
  const int i = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (i >= q) return;
  long long lst[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) lst[j] = EMPTY;
  for (int s = 0; s < splits; ++s) {
    const long long* src = part + (size_t)s * KT * q + i;
    for (int j = 0; j < KT; ++j) {  // each split's list is ascending
      const long long key = src[(size_t)j * q];
      if (key >= lst[KT - 1]) break;
      insert(lst, key);
    }
  }
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j < k) {
      dists[(size_t)i * k + j] = (int)(lst[j] >> 32);
      rows[(size_t)i * k + j] = (int)(lst[j] & 0xFFFFFFFFLL);
    }
  }
}

// ------------------------------------------------------ popcount (yardstick)
constexpr int THREADS = 128;  // needles per scan block, one a thread
constexpr int TILE = 256;     // haystack rows staged per step
constexpr int MISS = 512;     // an invalid row's distance offset

// Needle i's list over rows [split * span, + span) goes to part[(split *
// KT + j) * q + i], j < KT.
template <int KT>
__global__ void __launch_bounds__(THREADS)
lanes_scan(const unsigned long long* __restrict__ needles, int q,
           const unsigned long long* __restrict__ hay,
           const bool* __restrict__ valid, int n, int span, int bound,
           long long* __restrict__ part) {
  __shared__ ulonglong2 srow[TILE][2];
  __shared__ int smiss[TILE];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < q;
  unsigned long long a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (live) {
    const unsigned long long* p = needles + 4LL * i;
    a0 = p[0];
    a1 = p[1];
    a2 = p[2];
    a3 = p[3];
  }
  long long lst[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) lst[j] = EMPTY;
  const int r0 = min(n, blockIdx.y * span);
  const int r1 = min(n, r0 + span);
  const ulonglong2* rows = reinterpret_cast<const ulonglong2*>(hay);
  for (int t0 = r0; t0 < r1; t0 += TILE) {
    const int cnt = min(TILE, r1 - t0);
    __syncthreads();  // the last step's rows are read
    for (int c = threadIdx.x; c < cnt; c += THREADS) {
      srow[c][0] = rows[2LL * (t0 + c)];
      srow[c][1] = rows[2LL * (t0 + c) + 1];
      smiss[c] = valid[t0 + c] ? 0 : MISS;
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int c = 0; c < cnt; ++c) {
      const ulonglong2 x = srow[c][0], y = srow[c][1];
      const int d = __popcll(a0 ^ x.x) + __popcll(a1 ^ x.y) +
                    __popcll(a2 ^ y.x) + __popcll(a3 ^ y.y) + smiss[c];
      if (d < bound) {
        const long long key = ((long long)d << 32) | (long long)(t0 + c);
        if (key < lst[KT - 1]) insert(lst, key);
      }
    }
  }
  if (live) {
    long long* dst = part + (size_t)blockIdx.y * KT * q + i;
#pragma unroll
    for (int j = 0; j < KT; ++j) dst[(size_t)j * q] = lst[j];
  }
}

template <int KT>
cudaError_t launch_popc(const void* needles, int q, const void* hay,
                        const void* valid, int n, int k, int bound,
                        int splits, void* scratch, void* dists, void* rows,
                        cudaStream_t s) {
  const int span = (((n + splits - 1) / splits + TILE - 1) / TILE) * TILE;
  const dim3 grid((q + THREADS - 1) / THREADS, splits);
  auto part = static_cast<long long*>(scratch);
  lanes_scan<KT><<<grid, THREADS, 0, s>>>(
      static_cast<const unsigned long long*>(needles), q,
      static_cast<const unsigned long long*>(hay),
      static_cast<const bool*>(valid), n, span, bound, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lanes_merge<KT><<<(q + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                    0, s>>>(part, q, splits, k, static_cast<int*>(dists),
                            static_cast<int*>(rows));
  return cudaGetLastError();
}

// ------------------------------------------------------- e4m3: wgmma (main)
constexpr int STAGES = 2;      // ring slots of unpacked columns
constexpr int RAW_STAGES = 4;  // slots of packed columns: copies ahead
constexpr int SUB = 256;       // haystack columns a step: one n-tile
constexpr int NCONS = 3;       // consumer warpgroups
constexpr int BQ = NCONS * 64;                 // needle rows a unit
constexpr int WG_THREADS = 128 * (1 + NCONS);  // a producer, the consumers
// registers a thread after setmaxnreg: PROD_REGS the producer, the rest
// the consumers (a multiple of 8: 152)
constexpr int PROD_REGS = 56;
constexpr int CONS_REGS = (65536 - 128 * PROD_REGS) / (128 * NCONS) / 8 * 8;
constexpr int NACC = SUB / 4;      // f16 sums, two a register
constexpr int GROUP = 8 * 16 * 16;  // bytes of 8 columns: 16 k chunks of 16
constexpr int B_BYTES = SUB / 8 * GROUP;  // +-1 columns of a slot: 64 KB
constexpr int VB_BYTES = SUB / 8;         // their valid bits
constexpr int RAW_H = SUB * 32 + 16;      // packed columns, aligned
constexpr int RAW_V = SUB + 32;           // their valid bytes
// a list key: d << OFF_BITS | the column's offset in its unit's chunk
constexpr int OFF_BITS = 23;
constexpr uint32_t EMPTY32 = 0xFFFFFFFFu;
static_assert(NCONS * 128 * CONS_REGS + 128 * PROD_REGS <= 65536, "regs");

// each consumer row's list of KT 32-bit keys, laid out [warp][row g or g +
// 8][j][g]: entry j of a row LSTRIDE bytes after entry j - 1
constexpr int LSTRIDE = 8 * 4;
__host__ __device__ constexpr int list_bytes(int kt) {
  return NCONS * 4 * 2 * kt * LSTRIDE;
}
__host__ __device__ constexpr int smem_bytes(int kt) {
  return 1024 + STAGES * (B_BYTES + VB_BYTES) + RAW_STAGES * (RAW_H + RAW_V) +
         list_bytes(kt) + (2 * STAGES + RAW_STAGES) * 8;
}
static_assert(smem_bytes(10) <= 232448, "shared memory");

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

// shared-memory stores and loads by address
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t x, uint32_t y,
                                       uint32_t z, uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(x), "r"(y), "r"(z), "r"(w) : "memory");
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ unsigned long long lds64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared.b64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
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

// word w (0..15) of a 64-bit word's +-1 vector: byte b is +1 (e4m3 0x38)
// for a clear bit, -1 (0xB8) for a set one, of bit 32 * (w >> 3) + 8 * b +
// (w & 7).  A and B use the same order of the lanes, so the dot does not
// depend on it.
__device__ __forceinline__ uint32_t pm1_word(unsigned long long h, int w) {
  const uint32_t x = static_cast<uint32_t>(h >> (32 * (w >> 3))) >> (w & 7);
  return (x & 0x01010101u) * 0x80u + 0x38383838u;
}

// B descriptor (K-major, no swizzle): core matrices of 8 columns x 16
// bytes; the next 16 bytes of k (LBO) 128 bytes on, the next 8 columns
// (SBO) GROUP bytes on
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
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
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// the sums are read only after the wait: keep the compiler from moving
// their reads above it
template <int N>
__device__ __forceinline__ void acc_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// f16x2: the larger of each half
__device__ __forceinline__ uint32_t hmax2(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("max.f16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
// 1 if either half of x exceeds thr's
__device__ __forceinline__ uint32_t gt2(uint32_t x, uint32_t thr) {
  uint32_t r;
  asm("{\n.reg .pred p, q;\nsetp.gt.f16x2 p|q, %1, %2;\n"
      "or.pred p, p, q;\nselp.u32 %0, 1, 0, p;\n}"
      : "=r"(r) : "r"(x), "r"(thr));
  return r;
}
// the sum a limit admits above, 256 - 2 lim, in both halves (exact)
__device__ __forceinline__ uint32_t thr_of(int lim) {
  uint32_t r;
  asm("{\n.reg .f16 h;\ncvt.rn.f16.s32 h, %1;\nmov.b32 %0, {h, h};\n}"
      : "=r"(r) : "r"(256 - 2 * lim));
  return r;
}
// half H of x as an integer (the sums are integers)
template <int H>
__device__ __forceinline__ int half_int(uint32_t x) {
  int v;
  if (H == 0)
    asm("{\n.reg .f16 l, h;\nmov.b32 {l, h}, %1;\ncvt.rni.s32.f16 %0, l;\n}"
        : "=r"(v) : "r"(x));
  else
    asm("{\n.reg .f16 l, h;\nmov.b32 {l, h}, %1;\ncvt.rni.s32.f16 %0, h;\n}"
        : "=r"(v) : "r"(x));
  return v;
}

// A block's walk over its units (u = blockIdx.x, + gridDim.x, ...): unit u
// is needle rows [y * BQ, +BQ) against chunk x, columns [cs, cend), steps
// of SUB from cs.  Producer and consumers walk alike.
struct Walk {
  int n, units, xc, chunk;
  int u, y, x, cs, c0, cend;

  __device__ __forceinline__ bool unit() {
    for (; u < units; u += gridDim.x) {
      y = u / xc;
      x = u - y * xc;
      const long long s = static_cast<long long>(x) * chunk;
      if (s < n) {
        cs = c0 = static_cast<int>(s);
        cend = static_cast<int>(min(static_cast<long long>(n), s + chunk));
        return true;
      }
    }
    return false;
  }
  __device__ __forceinline__ bool step() {
    c0 += SUB;
    if (c0 < cend) return true;
    u += gridDim.x;
    return unit();
  }
};

// shared memory, by address
struct Ring {
  uint32_t b;      // STAGES x B_BYTES
  uint32_t vb;     // STAGES x VB_BYTES
  uint32_t raw_h;  // RAW_STAGES x RAW_H
  uint32_t raw_v;  // RAW_STAGES x RAW_V
  uint32_t lists;  // list_bytes(KT)
  uint32_t full, empty;  // STAGES barriers each, 8 bytes apart
  uint32_t raw;          // RAW_STAGES barriers
};

// the bulk copies of a step's packed columns and valid bytes into its
// slot, each from and to 16-byte boundaries around them
__device__ __forceinline__ void issue_step(
    const Ring& r, int slot, const Walk& w,
    const unsigned long long* hay, const unsigned char* valid) {
  const int cnt = min(SUB, w.cend - w.c0);
  const uintptr_t h0 =
      reinterpret_cast<uintptr_t>(hay + 4LL * w.c0) & ~uintptr_t(15);
  const uintptr_t h1 =
      (reinterpret_cast<uintptr_t>(hay + 4LL * (w.c0 + cnt)) + 15) &
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

__device__ __forceinline__ void producer(
    const Ring& r, Walk w, const unsigned long long* __restrict__ hay,
    const unsigned char* __restrict__ valid) {
  const int tid = threadIdx.x;  // 0..127
  const int wp = tid >> 5, lane = tid & 31;
  bool more = w.unit();
  Walk fill = w;  // thread 0's copy cursor, RAW_STAGES steps ahead
  bool fmore = more;
  if (tid == 0)
    for (int k = 0; k < RAW_STAGES && fmore; ++k) {
      issue_step(r, k, fill, hay, valid);
      fmore = fill.step();
    }
  for (int i = 0; more; ++i) {
    const int slot = i % STAGES, rslot = i % RAW_STAGES;
    // the packed columns are in; the consumers left the slot
    bar_wait(r.raw + 8 * rslot, (i / RAW_STAGES) & 1);
    bar_wait(r.empty + 8 * slot, ((i / STAGES) & 1) ^ 1);
    const int cnt = min(SUB, w.cend - w.c0);
    const int oh =
        static_cast<int>(reinterpret_cast<uintptr_t>(hay + 4LL * w.c0) & 15);
    const int ov = static_cast<int>(reinterpret_cast<uintptr_t>(valid + w.c0) & 15);
    const uint32_t rh = r.raw_h + rslot * RAW_H + oh;
    const uint32_t rv = r.raw_v + rslot * RAW_V + ov;
    const uint32_t sb = r.b + slot * B_BYTES;
    // a warp takes its quarter of the step, 8 columns an iteration, a lane
    // one 64-bit word (wd) of a column: lanes 8 wd .. 8 wd + 7 take word wd
    // of the 8 columns, so that each 8 lanes' 16-byte stores (a wavefront)
    // fill one 128-byte row of 8 core matrices: no bank conflict
    const int wd = lane >> 3;
#pragma unroll 2
    for (int it = 0; it < SUB / 32; ++it) {
      const int j = wp * (SUB / 4) + it * 8 + (lane & 7);
      const unsigned long long h = j < cnt ? lds64(rh + 32 * j + 8 * wd) : 0ull;
      const uint32_t col = sb + (j >> 3) * GROUP + (j & 7) * 16 + wd * 512;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        sts128(col + s * 128, pm1_word(h, 4 * s), pm1_word(h, 4 * s + 1),
               pm1_word(h, 4 * s + 2), pm1_word(h, 4 * s + 3));
    }
    // valid bits: word v holds columns 32 v .. 32 v + 31
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = wp * (SUB / 4) + half * 32 + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu, j < cnt && lds8(rv + j));
      if (lane == 0) sts32(r.vb + slot * VB_BYTES + 4 * (j >> 5), bits);
    }
    // the stores are generic-proxy writes that wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1, 128);  // every producer thread is done with the slot
    if (tid == 0) {
      bar_arrive(r.full + 8 * slot);
      if (fmore) {  // into the packed slot just read
        issue_step(r, rslot, fill, hay, valid);
        fmore = fill.step();
      }
    }
    more = w.step();
  }
}

// Insert key into the ascending list of KT keys at l0 (entry j at l0 +
// LSTRIDE j); the caller checked key < the last, which drops out
template <int KT>
__device__ __forceinline__ void insert_list(uint32_t l0, uint32_t key) {
  int j = KT - 1;
  for (; j > 0; --j) {
    const uint32_t prev = lds32(l0 + (j - 1) * LSTRIDE);
    if (prev < key) break;
    sts32(l0 + j * LSTRIDE, prev);
  }
  sts32(l0 + j * LSTRIDE, key);
}

// The rare case for this thread's row RR (rows g, g + 8): each column whose
// sum passes thr (d < lim), if valid, as a key into the row's list at l0.
// acc[2k + RR] holds columns 8k + 2qd and + 1 of the step, off columns into
// the unit's chunk.  The sums are searched in groups of 8 registers: a
// group's max, then its registers' passes, then each passing register
// taken by a select chain of 7
template <int KT, int RR>
__device__ __forceinline__ void admit(const int (&acc)[NACC], uint32_t thr,
                                      int lim, uint32_t l0, uint32_t vb,
                                      int off, int qd) {
  uint32_t last = lds32(l0 + (KT - 1) * LSTRIDE);
#pragma unroll
  for (int gr = 0; gr < NACC / 16; ++gr) {
    // acc[16 gr + 2j + RR]: the group's register j
    uint32_t mx = acc[16 * gr + RR];
#pragma unroll
    for (int j = 1; j < 8; ++j) mx = hmax2(mx, acc[16 * gr + 2 * j + RR]);
    if (!gt2(mx, thr)) continue;
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) m |= gt2(acc[16 * gr + 2 * j + RR], thr) << j;
    while (m) {
      const int jj = __ffs(m) - 1;
      m &= m - 1;
      uint32_t x = acc[16 * gr + RR];
#pragma unroll
      for (int j = 1; j < 8; ++j) x = jj == j ? acc[16 * gr + 2 * j + RR] : x;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = (256 - (h ? half_int<1>(x) : half_int<0>(x))) >> 1;
        const int col = 8 * (8 * gr + jj) + 2 * qd + h;
        if (d < lim && ((lds32(vb + 4 * (col >> 5)) >> (col & 31)) & 1u)) {
          const uint32_t key = (static_cast<uint32_t>(d) << OFF_BITS) |
                               static_cast<uint32_t>(off + col);
          if (key < last) {
            insert_list<KT>(l0, key);
            last = lds32(l0 + (KT - 1) * LSTRIDE);
          }
        }
      }
    }
  }
}

template <int KT>
__device__ __forceinline__ void consumer(
    const Ring& r, Walk w, const unsigned long long* __restrict__ needles,
    int q, int bound, long long* __restrict__ part) {
  // consumer 0 .. NCONS - 1, read through a shuffle so that the compiler
  // knows it is the same in every lane: wgmma must not sit in a divergent
  // path
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
  const int tid = threadIdx.x & 127;
  const int wp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  // the lists of rows g and g + 8 (row rr's entry j at lst[rr] + LSTRIDE j)
  const uint32_t lst[2] = {r.lists + ((c * 4 + wp) * 2 * KT * 8 + g) * 4,
                           r.lists + (((c * 4 + wp) * 2 + 1) * KT * 8 + g) * 4};
  uint32_t a[8][4];
  int acc[NACC];
  bool more = w.unit();
  int i = 0;  // the block's step count: the ring's slot and phase
  while (more) {
    const int r0 = w.y * BQ + c * 64;  // the consumer's first row
    // its needle rows as A fragments (PTX ISA, wgmma .m64nNk32 8-bit A:
    // register 2h + r of k-step s holds row 16 wp + g + 8r, k = 32 s + 16 h
    // + 4 qd + 0..3), unpacked once a unit
    int lim[2];  // the rows' limits
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 16 * wp + g + 8 * rr;
      const bool in = row < q;
      unsigned long long hw[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) hw[v] = in ? needles[4LL * row + v] : 0ull;
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          a[s][2 * hf + rr] = pm1_word(hw[s >> 1], 8 * (s & 1) + 4 * hf + qd);
      lim[rr] = in ? bound : 0;  // a row past q admits nothing
      if (qd == 0)
#pragma unroll
        for (int j = 0; j < KT; ++j) sts32(lst[rr] + j * LSTRIDE, EMPTY32);
    }
    __syncwarp();
    // held as they are: the compiler would otherwise recompute them from
    // the needle words before every product
#pragma unroll
    for (int e = 0; e < 32; ++e) asm volatile("" : "+r"(a[e >> 2][e & 3]));
    uint32_t thr[2] = {thr_of(lim[0]), thr_of(lim[1])};
    do {
      const int slot = i % STAGES;
      bar_wait(r.full + 8 * slot, (i / STAGES) & 1);
      const uint32_t sb = r.b + slot * B_BYTES;
      // the last epilogue's reads land before the products start
      acc_fence(acc);
      wgmma_fence();
      mma_e4m3<0>(acc, a[0], b_desc(sb));
#pragma unroll
      for (int s = 1; s < 8; ++s) mma_e4m3<1>(acc, a[s], b_desc(sb + 256 * s));
      wgmma_commit();
      wgmma_wait0();
      acc_fence(acc);
      // the common case: no sum of the warp's rows passes its limit (a
      // tree of maxima, four independent chains a row)
      uint32_t m[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          m[rr][t] = acc[2 * t + rr];
#pragma unroll
          for (int k = t + 4; k < NACC / 2; k += 4)
            m[rr][t] = hmax2(m[rr][t], acc[2 * k + rr]);
        }
      const uint32_t p0 = gt2(hmax2(hmax2(m[0][0], m[0][1]),
                                    hmax2(m[0][2], m[0][3])), thr[0]);
      const uint32_t p1 = gt2(hmax2(hmax2(m[1][0], m[1][1]),
                                    hmax2(m[1][2], m[1][3])), thr[1]);
      if (__any_sync(0xffffffffu, p0 | p1)) {
        const uint32_t vb = r.vb + slot * VB_BYTES;
        const int off = w.c0 - w.cs;
        // the quad's threads in turn: one list a row
#pragma unroll 1
        for (int t = 0; t < 4; ++t) {
          if (qd == t) {
            if (p0) admit<KT, 0>(acc, thr[0], lim[0], lst[0], vb, off, qd);
            if (p1) admit<KT, 1>(acc, thr[1], lim[1], lst[1], vb, off, qd);
          }
          __syncwarp();
        }
        // a row's limit: its list's last distance once it holds KT keys
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          lim[rr] = min(lim[rr], static_cast<int>(
              lds32(lst[rr] + (KT - 1) * LSTRIDE) >> OFF_BITS));
          thr[rr] = thr_of(lim[rr]);
        }
      }
      if (lane == 0) bar_arrive(r.empty + 8 * slot);
      ++i;
      w.c0 += SUB;
    } while (w.c0 < w.cend);
    // each row's list to scratch
    if (qd == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r0 + 16 * wp + g + 8 * rr;
        if (row >= q) continue;
        long long* dst = part + static_cast<size_t>(w.x) * KT * q + row;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const uint32_t key = lds32(lst[rr] + j * LSTRIDE);
          dst[static_cast<size_t>(j) * q] =
              key == EMPTY32
                  ? EMPTY
                  : (static_cast<long long>(key >> OFF_BITS) << 32) |
                        (w.cs + (key & ((1u << OFF_BITS) - 1)));
        }
      }
    }
    __syncwarp();
    w.u += gridDim.x;
    more = w.unit();
  }
}

template <int KT>
__global__ void __launch_bounds__(WG_THREADS, 1)
lanes_wgmma(const unsigned long long* __restrict__ needles, int q,
            const unsigned long long* __restrict__ hay,
            const unsigned char* __restrict__ valid, int n, int bound,
            int units, int xc, int chunk, long long* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring r;
  r.b = saddr(base);
  r.vb = r.b + STAGES * B_BYTES;
  r.raw_h = r.vb + STAGES * VB_BYTES;
  r.raw_v = r.raw_h + RAW_STAGES * RAW_H;
  r.lists = r.raw_v + RAW_STAGES * RAW_V;
  const uint32_t bars = r.lists + list_bytes(KT);
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
  w.u = blockIdx.x;
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PROD_REGS));
    producer(r, w, hay, valid);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONS_REGS));
    consumer<KT>(r, w, needles, q, bound, part);
  }
}

template <int KT>
cudaError_t launch_wgmma(const void* needles, int q, const void* hay,
                         const void* valid, int n, int k, int bound, int xc,
                         int chunk, void* scratch, void* dists, void* rows,
                         cudaStream_t s) {
  auto part = static_cast<long long*>(scratch);
  cudaError_t err = cudaSuccess;
  if (n > 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long units = static_cast<long long>((q + BQ - 1) / BQ) * xc;
    err = cudaFuncSetAttribute(lanes_wgmma<KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(KT));
    if (err != cudaSuccess) return err;
    const int grid = static_cast<int>(units < sms ? units : sms);
    lanes_wgmma<KT><<<grid, WG_THREADS, smem_bytes(KT), s>>>(
        static_cast<const unsigned long long*>(needles), q,
        static_cast<const unsigned long long*>(hay),
        static_cast<const unsigned char*>(valid), n, bound,
        static_cast<int>(units), xc, chunk, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // no rows: no chunk, every slot empty
  lanes_merge<KT><<<(q + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                    0, s>>>(part, q, n > 0 ? xc : 0, k,
                            static_cast<int*>(dists), static_cast<int*>(rows));
  return cudaGetLastError();
}

}  // namespace

// The k nearest rows of each of q needles (int64 [q, 4]) over n rows (int64
// [n, 4], valid bool [n]) at distance < bound, into dists and rows (int32
// [q, k]), on the tensor cores: xc chunks of chunk columns each (a multiple
// of 256, at most 2^23; (xc - 1) * chunk < n <= xc * chunk).  scratch holds
// xc * list_size(k) * q int64 keys (ops/hamming_lanes.py list_size).  The
// caller checks 0 <= bound <= 257, n < 2^31.
extern "C" int cbird_lanes_topk(const void* needles, int q, const void* hay,
                                const void* valid, int n, int k, int bound,
                                int xc, int chunk, void* scratch, void* dists,
                                void* rows, void* stream) {
  if (q == 0 || k == 0) return 0;
  if (n > 0 && (xc < 1 || chunk < SUB || chunk % SUB || chunk > (1 << OFF_BITS) ||
                static_cast<long long>(xc) * chunk < n ||
                static_cast<long long>(xc - 1) * chunk >= n ||
                static_cast<long long>((q + BQ - 1) / BQ) * xc > 0x7FFFFFFFLL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1)
    return (int)launch_wgmma<1>(needles, q, hay, valid, n, k, bound, xc, chunk,
                                scratch, dists, rows, s);
  if (k <= 10)
    return (int)launch_wgmma<10>(needles, q, hay, valid, n, k, bound, xc,
                                 chunk, scratch, dists, rows, s);
  return (int)cudaErrorInvalidValue;
}

// The same, by the popcount form (the yardstick) over splits haystack
// splits; scratch holds splits * list_size(k) * q int64 keys.  The caller
// checks 1 <= splits <= 65535.
extern "C" int cbird_lanes_topk_popc(const void* needles, int q,
                                     const void* hay, const void* valid, int n,
                                     int k, int bound, int splits,
                                     void* scratch, void* dists, void* rows,
                                     void* stream) {
  if (q == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1)
    return (int)launch_popc<1>(needles, q, hay, valid, n, k, bound, splits,
                               scratch, dists, rows, s);
  if (k <= 10)
    return (int)launch_popc<10>(needles, q, hay, valid, n, k, bound, splits,
                                scratch, dists, rows, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
