// Hamming count-below-threshold (kernels K1 and K2 of the port).
//
// Replaces cbird_tpu/ops/mxu_count.py: mxu_count_below (_count_kernel, K1)
// and, with MASKED, mxu_count_triangle (_mask_kernel, K2).  It also takes
// the role of the XLA popcount scans _count_tile, _self_count_tile and
// hamming_count_below (cbird_tpu/ops/hamming.py).
//
// Contract: out[i] = #{ j < n : valid[j] and popcount(needles[i] ^ hay[j]) < t
//                              and (!MASKED or col_base + j > row_base + i) }.
// Hashes are one 64-bit pattern per row (the TPU's [N,2] uint32 layout
// came from its lack of 64-bit lanes).  Row validity of the needles is not
// masked here: the self-search caller zeroes invalid rows, as on the TPU.
//
// What bounds it on an H100: popcount issue.  Each pair is a 64-bit xor,
// two 32-bit POPC (16 per clock per SM on sm_90), a compare and an add on
// the CUDA cores, while the haystack is read once per needle tile (8 B/row),
// so at Q >= 64 it is far from the 3.35 TB/s memory bound.  The design keeps
// the per-pair work at those instructions: a block stages a chunk of CHUNK
// haystack rows
// in shared memory once, folds validity (and the ragged edge) into a
// per-column threshold (0 never hits), and each thread holds NPT needles
// in registers, so one shared-memory load feeds NPT pairs.  Blocks split
// over (column chunk x needle tile), so a 1024-needle batch against a
// 10M-row store runs ~10k blocks and fills all 132 SMs.  Each thread ends
// with one atomicAdd per needle (skipped when zero); integer sums are
// exact in any order.  The int8 tensor-core form (dot = 64 - 2*ham) of the
// same function is count_below_mma.cu; the video gate takes it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NPT = 4;                   // needles per thread
constexpr int QTILE = THREADS * NPT;     // needles per block
constexpr int CHUNK = 2048;              // haystack rows per block

template <bool MASKED>
__global__ void __launch_bounds__(THREADS)
count_kernel(const unsigned long long* __restrict__ needles, int q,
             const unsigned long long* __restrict__ hay,
             const bool* __restrict__ valid, int n, int t,
             long long row_base, long long col_base, int* __restrict__ out) {
  __shared__ unsigned long long sh[CHUNK];
  __shared__ int slim[CHUNK];
  const int c0 = blockIdx.x * CHUNK;
  const int cn = min(CHUNK, n - c0);
  for (int j = threadIdx.x; j < cn; j += THREADS) {
    const bool ok = valid[c0 + j];
    sh[j] = hay[c0 + j];
    slim[j] = ok ? t : 0;
  }
  __syncthreads();

  const int q0 = blockIdx.y * QTILE + threadIdx.x;
  unsigned long long a[NPT];
  int cnt[NPT];
  long long first[NPT];  // MASKED: column j counts only when j >= first
#pragma unroll
  for (int r = 0; r < NPT; ++r) {
    const int i = q0 + r * THREADS;
    a[r] = i < q ? needles[i] : 0ull;
    cnt[r] = 0;
    first[r] = row_base + i - col_base - c0 + 1;
  }
  for (int j = 0; j < cn; ++j) {
    const unsigned long long h = sh[j];
    const int lim = slim[j];
#pragma unroll
    for (int r = 0; r < NPT; ++r) {
      int hit = __popcll(a[r] ^ h) < lim;
      if (MASKED) hit &= (j >= first[r]);
      cnt[r] += hit;
    }
  }
#pragma unroll
  for (int r = 0; r < NPT; ++r) {
    const int i = q0 + r * THREADS;
    if (i < q && cnt[r]) atomicAdd(out + i, cnt[r]);
  }
}

}  // namespace

extern "C" int cbird_count_below(const void* needles, int q, const void* hay,
                                 const void* valid, int n, int t, int masked,
                                 long long row_base, long long col_base,
                                 void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)q, s);
  if (err != cudaSuccess || q == 0 || n == 0) return (int)err;
  auto nd = static_cast<const unsigned long long*>(needles);
  auto hs = static_cast<const unsigned long long*>(hay);
  auto vd = static_cast<const bool*>(valid);
  auto o = static_cast<int*>(out);
  // gridDim.y is at most 65535 needle tiles: launch in slices of that
  const int step = 65535 * QTILE;
  for (int q0 = 0; q0 < q; q0 += step) {
    const int qs = min(step, q - q0);
    const dim3 grid((n + CHUNK - 1) / CHUNK, (qs + QTILE - 1) / QTILE);
    if (masked)
      count_kernel<true><<<grid, THREADS, 0, s>>>(
          nd + q0, qs, hs, vd, n, t, row_base + q0, col_base, o + q0);
    else
      count_kernel<false><<<grid, THREADS, 0, s>>>(
          nd + q0, qs, hs, vd, n, t, row_base + q0, col_base, o + q0);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
  }
  return (int)err;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
