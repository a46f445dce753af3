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
// Two kernels, both over (column chunk x needle tile) blocks, each block
// staging CHUNK haystack rows in shared memory with validity folded into a
// per-column bound (0 for tombstones and the ragged edge):
//   topk_hist:    hist[i][d] = #{valid j : popcount(n_i ^ h_j) = d < bound}.
//                 Each thread owns one needle and a private column of a
//                 shared [65 x THREADS] histogram, so no shared atomics;
//                 nonzero bins go to device memory with one atomicAdd each.
//   topk_collect: from the histogram the wrapper finds each needle's cut
//                 distance D (the smallest d with k rows at <= d) and a
//                 buffer offset; this kernel appends key = d << 32 | row for
//                 every row at d <= D through a per-needle atomic cursor.
//                 The wrapper sorts each needle's keys and keeps k.
// The distance bound keeps lists as short as the hits the caller keeps
// (hamming.py drops d >= threshold anyway), and the histogram sizes the
// buffer exactly, whatever k is.
//
// What bounds it on an H100: as in count_below.cu, popcount issue (each
// pair is scanned twice, once per kernel); hits are rare at the main path's
// bound (5), so the histogram and cursor traffic is small.  One needle per
// thread leaves most threads idle for a lone needle; a column-parallel
// form for small batches and a single fused pass are later performance
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // needles per block, one per thread
constexpr int CHUNK = 1024;   // haystack rows per block
constexpr int BINS = 65;      // distances 0..64
constexpr int STEP = 65535 * THREADS;  // needles per launch (gridDim.y)

__device__ __forceinline__ void stage(const unsigned long long* __restrict__ hay,
                                      const bool* __restrict__ valid, int c0,
                                      int cn, int bound,
                                      unsigned long long* sh, int* slim) {
  for (int j = threadIdx.x; j < cn; j += THREADS) {
    sh[j] = hay[c0 + j];
    slim[j] = valid[c0 + j] ? bound : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
topk_hist(const unsigned long long* __restrict__ needles, int q,
          const unsigned long long* __restrict__ hay,
          const bool* __restrict__ valid, int n, int bound,
          int* __restrict__ hist) {
  __shared__ unsigned long long sh[CHUNK];
  __shared__ int slim[CHUNK];
  __shared__ int sbin[BINS * THREADS];
  const int c0 = blockIdx.x * CHUNK;
  const int cn = min(CHUNK, n - c0);
  stage(hay, valid, c0, cn, bound, sh, slim);
  for (int b = 0; b < BINS; ++b) sbin[b * THREADS + threadIdx.x] = 0;
  __syncthreads();

  const int i = blockIdx.y * THREADS + threadIdx.x;
  if (i >= q) return;
  const unsigned long long a = needles[i];
  for (int j = 0; j < cn; ++j) {
    const int d = __popcll(a ^ sh[j]);
    if (d < slim[j]) ++sbin[d * THREADS + threadIdx.x];
  }
  for (int b = 0; b < BINS; ++b) {
    const int c = sbin[b * THREADS + threadIdx.x];
    if (c) atomicAdd(hist + (size_t)i * BINS + b, c);
  }
}

__global__ void __launch_bounds__(THREADS)
topk_collect(const unsigned long long* __restrict__ needles, int q,
             const unsigned long long* __restrict__ hay,
             const bool* __restrict__ valid, int n, int bound,
             const int* __restrict__ cut, const long long* __restrict__ off,
             int* __restrict__ cursor, long long* __restrict__ keys) {
  __shared__ unsigned long long sh[CHUNK];
  __shared__ int slim[CHUNK];
  const int c0 = blockIdx.x * CHUNK;
  const int cn = min(CHUNK, n - c0);
  stage(hay, valid, c0, cn, bound, sh, slim);
  __syncthreads();

  const int i = blockIdx.y * THREADS + threadIdx.x;
  if (i >= q) return;
  const unsigned long long a = needles[i];
  const int dcut = cut[i];
  long long* dst = keys + off[i];
  for (int j = 0; j < cn; ++j) {
    const int d = __popcll(a ^ sh[j]);
    if (d < slim[j] && d <= dcut) {
      const int slot = atomicAdd(cursor + i, 1);
      dst[slot] = ((long long)d << 32) | (long long)(c0 + j);
    }
  }
}

}  // namespace

extern "C" int cbird_topk_hist(const void* needles, int q, const void* hay,
                               const void* valid, int n, int bound, void* hist,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(hist, 0, sizeof(int) * BINS * (size_t)q, s);
  if (err != cudaSuccess || q == 0 || n == 0) return (int)err;
  auto nd = static_cast<const unsigned long long*>(needles);
  for (int q0 = 0; q0 < q; q0 += STEP) {  // gridDim.y <= 65535 tiles
    const int qs = min(STEP, q - q0);
    const dim3 grid((n + CHUNK - 1) / CHUNK, (qs + THREADS - 1) / THREADS);
    topk_hist<<<grid, THREADS, 0, s>>>(
        nd + q0, qs, static_cast<const unsigned long long*>(hay),
        static_cast<const bool*>(valid), n, bound,
        static_cast<int*>(hist) + (size_t)q0 * BINS);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
  }
  return (int)err;
}

extern "C" int cbird_topk_collect(const void* needles, int q, const void* hay,
                                  const void* valid, int n, int bound,
                                  const void* cut, const void* off,
                                  void* cursor, void* keys, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(cursor, 0, sizeof(int) * (size_t)q, s);
  if (err != cudaSuccess || q == 0 || n == 0) return (int)err;
  auto nd = static_cast<const unsigned long long*>(needles);
  for (int q0 = 0; q0 < q; q0 += STEP) {  // gridDim.y <= 65535 tiles
    const int qs = min(STEP, q - q0);
    const dim3 grid((n + CHUNK - 1) / CHUNK, (qs + THREADS - 1) / THREADS);
    topk_collect<<<grid, THREADS, 0, s>>>(
        nd + q0, qs, static_cast<const unsigned long long*>(hay),
        static_cast<const bool*>(valid), n, bound,
        static_cast<const int*>(cut) + q0,
        static_cast<const long long*>(off) + q0,
        static_cast<int*>(cursor) + q0, static_cast<long long*>(keys));
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
  }
  return (int)err;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
