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
// Two kernels.  lanes_scan: a block holds 128 needles, one a thread, in
// registers, and walks one split of the haystack: 256 rows at a time are
// staged in shared memory (with each row's validity as a distance offset
// that no bound admits) and read by broadcast; each thread computes its
// needle's distance to every row once (four __popcll) and keeps a sorted
// list of its KT best keys (d << 32 | row) in registers, KT 1 or 10, the
// smaller that holds k: a key enters only below the list's
// last, so after the first rows almost every row costs one compare.  Each
// (needle, split) list goes to scratch; lanes_merge takes one thread a
// needle through its splits' lists and writes the first k.  The splits
// give the card enough blocks when there are few needles.
//
// What bounds it on an H100: POPC issue.  A pair is four 64-bit xors and
// four __popcll (eight 32-bit POPC, at 16 a clock per SM), three adds and
// a compare; the haystack read (33 bytes a row) is far below that at any
// needle count of the orb index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // needles per scan block, one a thread
constexpr int TILE = 256;     // haystack rows staged per step
constexpr int MISS = 512;     // an invalid row's distance offset
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

template <int KT>
cudaError_t launch(const void* needles, int q, const void* hay,
                   const void* valid, int n, int k, int bound, int splits,
                   void* scratch, void* dists, void* rows, cudaStream_t s) {
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

}  // namespace

// The k nearest rows of each of q needles (int64 [q, 4]) over n rows (int64
// [n, 4], valid bool [n]) at distance < bound, into dists and rows (int32
// [q, k]).  scratch holds splits * list_size(k) * q int64 keys
// (ops/hamming_lanes.py list_size).  The caller checks 1 <= splits <=
// 65535, 0 <= bound <= 257, n < 2^31.
extern "C" int cbird_lanes_topk(const void* needles, int q, const void* hay,
                                const void* valid, int n, int k, int bound,
                                int splits, void* scratch, void* dists,
                                void* rows, void* stream) {
  if (q == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 1)
    err = launch<1>(needles, q, hay, valid, n, k, bound, splits, scratch,
                    dists, rows, s);
  else if (k <= 10)
    err = launch<10>(needles, q, hay, valid, n, k, bound, splits, scratch,
                     dists, rows, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
