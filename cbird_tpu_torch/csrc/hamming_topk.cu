// Exact per-needle Hamming top-k (kernel K4 of the port).
//
// Replaces cbird_tpu/ops/pallas_hamming.py hamming_topk_pallas (_kernel),
// and with it the role of the XLA approx_min_k scan hamming_topk
// (cbird_tpu/ops/hamming.py) on the main path: torch has neither that
// operator nor a popcount.
//
// Contract (with the wrapper in ops/hamming_topk.py): for each needle, the
// k valid haystack rows with the smallest (distance, row) among those at
// distance < bound, ascending.  Keys are unique, so the answer is exact and
// ties at the boundary go to the lower store row.  k is not bounded: the
// self-search escalation asks for up to 65536.
//
// One kernel, topk_scan, computes each pair's distance once.  A hit (a
// valid column at distance < the needle's limit) appends key = d << 32 |
// row to the needle's slots through a per-needle cursor, and, in the first
// pass, adds one to the needle's distance histogram.  The cursor counts
// every hit; a slot is written only while it is below the capacity.  The
// wrapper then sorts each needle's slots and keeps k, which is the answer
// of every needle whose cursor stayed within the capacity.  A needle whose
// cursor passed it takes a second pass of the same kernel in cut mode,
// whose answer replaces the first: its limit becomes cut + 1, the
// smallest distance with k hits at or below it (from the now exact
// histogram), and the capacity the most hits at or below any such
// needle's cut, so that pass never overflows.  At the search's bound (5)
// hits are rare and the first pass is the only one.
//
// Layout: a block holds a tile of up to TQ needles (and their limits) in
// shared memory, read by broadcast, and CPT haystack columns per thread in
// registers, with validity folded into an offset added to the distance
// (MISS for tombstones and the ragged edge, so no limit is ever met).
// Every thread of the block loops over the same needles, so a warp's hits
// in one step belong to one needle: the append is warp-aggregated (one
// ballot per column slot, one atomicAdd on the cursor per warp and
// needle).  The histogram lives in shared memory ([TQ][bound] ints,
// dynamic), takes a shared atomic on hits only, and its nonzero bins go
// to the [Q, 65] global histogram at the block's end.
//
// What bounds it on an H100: for a batch of needles, POPC issue (two
// 32-bit POPC a pair, as count_below.cu's K1; the rest of a pair is two
// xors, one three-input add and a compare); for a lone needle, the
// haystack read (9 bytes a row): every thread holds columns, so one needle
// keeps the whole card busy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CPT = 4;                // haystack columns per thread
constexpr int CHUNK = THREADS * CPT;  // haystack columns per block
constexpr int TQ = 128;               // needles per block
constexpr int BINS = 65;              // distances 0..64
constexpr int MISS = 128;             // an invalid column's distance offset
constexpr int STEP = 65535 * TQ;      // needles per launch (gridDim.y)
constexpr unsigned FULL = 0xffffffffu;
// an empty slot: sorts after every d << 32 | row key and unpacks to the
// wrapper's (BAD_DIST, row -1)
constexpr long long EMPTY = (0x7FFFLL << 32) | 0xFFFFFFFFLL;

__global__ void fill_empty(long long* __restrict__ keys, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    keys[i] = EMPTY;
}

// Needle i is needles[rows[i]] (rows nullable: needles[i]); its slots are
// keys[i * c_all, + c_all).  hist (nullable): the first pass's histogram.
// cut (nullable): the limit of needle i is min(bound, cut[i] + 1), else
// bound.
__global__ void __launch_bounds__(THREADS)
topk_scan(const unsigned long long* __restrict__ needles,
          const long long* __restrict__ rows, int q,
          const unsigned long long* __restrict__ hay,
          const bool* __restrict__ valid, int n, int bound,
          int* __restrict__ hist, const int* __restrict__ cut,
          long long c_all, int* __restrict__ cursor,
          long long* __restrict__ keys) {
  extern __shared__ int shist[];  // [tq][bound], first pass only
  __shared__ unsigned long long sn[TQ];
  __shared__ int slim[TQ];
  const int i0 = blockIdx.y * TQ;
  const int tq = min(TQ, q - i0);
  for (int j = threadIdx.x; j < tq; j += THREADS) {
    sn[j] = needles[rows ? rows[i0 + j] : i0 + j];
    slim[j] = cut ? min(bound, cut[i0 + j] + 1) : bound;
  }
  if (hist)
    for (int j = threadIdx.x; j < tq * bound; j += THREADS) shist[j] = 0;
  const int c0 = blockIdx.x * CHUNK + threadIdx.x;
  unsigned long long h[CPT];
  int miss[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = c0 + k * THREADS;
    const bool in = c < n;
    h[k] = in ? hay[c] : 0ull;
    miss[k] = (in && valid[c]) ? 0 : MISS;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  for (int j = 0; j < tq; ++j) {
    const unsigned long long a = sn[j];
    const int lim = slim[j];
    int d[CPT];
    bool any = false;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      d[k] = __popcll(a ^ h[k]) + miss[k];
      any |= d[k] < lim;
    }
    if (!__any_sync(FULL, any)) continue;  // the common case: no hit
    // the warp's hits all belong to needle i0 + j: one cursor atomic
    unsigned b[CPT];
    int total = 0;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      b[k] = __ballot_sync(FULL, d[k] < lim);
      total += __popc(b[k]);
    }
    const int i = i0 + j;
    int base = 0;
    if (lane == 0) base = atomicAdd(cursor + i, total);
    base = __shfl_sync(FULL, base, 0);
    long long* dst = keys + (long long)i * c_all;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if (d[k] < lim) {
        const int slot = base + __popc(b[k] & below);
        if (slot < c_all)
          dst[slot] = ((long long)d[k] << 32) | (long long)(c0 + k * THREADS);
        if (hist) atomicAdd(shist + j * bound + d[k], 1);
      }
      base += __popc(b[k]);
    }
  }
  if (hist) {
    __syncthreads();
    for (int x = threadIdx.x; x < tq * bound; x += THREADS) {
      const int v = shist[x];
      if (v) atomicAdd(hist + (size_t)(i0 + x / bound) * BINS + x % bound, v);
    }
  }
}

}  // namespace

// One pass of topk_scan over q needles (rows: nullable int64 indices into
// needles).  It first zeroes hist [q, 65] (nullable) and cursor [q] and
// empties the q * c_all slots of keys.  The caller checks 0 <= bound <=
// 65, n < 2^31.
extern "C" int cbird_topk_scan(const void* needles, const void* rows, int q,
                               const void* hay, const void* valid, int n,
                               int bound, void* hist, const void* cut,
                               long long c_all, void* cursor, void* keys,
                               void* stream) {
  if (q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(cursor, 0, sizeof(int) * (size_t)q, s);
  if (err == cudaSuccess && hist)
    err = cudaMemsetAsync(hist, 0, sizeof(int) * BINS * (size_t)q, s);
  const long long slots = (long long)q * c_all;
  if (err == cudaSuccess && slots) {
    fill_empty<<<(int)min(1024LL, (slots + 255) / 256), 256, 0, s>>>(
        static_cast<long long*>(keys), slots);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || n == 0) return (int)err;
  const size_t smem = hist ? sizeof(int) * TQ * bound : 0;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(topk_scan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  auto nd = static_cast<const unsigned long long*>(needles);
  auto rw = static_cast<const long long*>(rows);
  for (int q0 = 0; err == cudaSuccess && q0 < q; q0 += STEP) {
    const int qs = min(STEP, q - q0);
    const dim3 grid((n + CHUNK - 1) / CHUNK, (qs + TQ - 1) / TQ);
    topk_scan<<<grid, THREADS, smem, s>>>(
        rw ? nd : nd + q0, rw ? rw + q0 : nullptr, qs,
        static_cast<const unsigned long long*>(hay),
        static_cast<const bool*>(valid), n, bound,
        hist ? static_cast<int*>(hist) + (size_t)q0 * BINS : nullptr,
        cut ? static_cast<const int*>(cut) + q0 : nullptr, c_all,
        static_cast<int*>(cursor) + q0,
        static_cast<long long*>(keys) + (long long)q0 * c_all);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
