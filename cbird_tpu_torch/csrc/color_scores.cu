// The chamfer color score between 32-color descriptors (kernel K6).
//
// Computes the [Q, C] scores of cbird_tpu/ops/color.py _color_scores
// (two-sided: the side with more colors drives the sum, |numA - numB| > 2
// rejected) and _color_scores_oneside (side "ab" or "ba" fixed a launch,
// as color_self_block's count buckets dispatch it), which color_topk_local,
// color_topk and color_self_block rank (XLA in the JAX package).  The
// wrapper (ops/color_scores.py) sorts each chunk of a row and merges.
//
// Contract: out[q * ldo + c] = BAD (3e38) when a count is 0, valid[c] is
// false, base + c lies outside [lo, hi), or (two-sided) the counts differ
// by more than 2; else 1 + sum_{a < nA} f(min_{b < nB} d2(a, b)), with
// f(m) = sqrt(m) floored to 0 below 0.06, d2 = (dl*dl + du*du) + dv*dv of
// needle minus row, unfused (__fmul_rn / __fadd_rn), the minimum on d2 and
// the sum in ascending color order: each term and the score equal the
// plain twin's (color_scores_plain) bit for bit.
//
// What bounds it on an H100: FP32 issue.  A scored pair of nq x nh colors
// costs 3 subtracts, 3 multiplies, 2 adds and a min per color pair (~8650
// instructions at 31 x 31 colors) against 388 bytes a haystack row read
// once a block of QT needles, so it sits ~3 orders of magnitude above the
// memory bound.  The design keeps the work at those instructions: a
// block stages QT needles' colors in shared memory as float4 (one
// broadcast load a needle color), each thread holds one haystack row's 96
// floats in registers (statically indexed: the color loops are unrolled),
// and the loops run over the real counts only: the side's colors in the
// outer loop, the other side's in the inner one, so no running minima
// are kept beside the row.  Rejected pairs cost a store.  The output is
// written a needle at a time, consecutive threads on consecutive columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NC = 32;        // colors a descriptor
constexpr int THREADS = 128;  // haystack rows a block
constexpr int QT = 32;        // needles a block holds in shared memory
constexpr float BAD = 3.0e38f;
constexpr float FLOOR = 0.06f;

__device__ __forceinline__ float d2of(float4 a, float hl, float hu,
                                      float hv) {
  const float dl = __fsub_rn(a.x, hl);
  const float du = __fsub_rn(a.y, hu);
  const float dv = __fsub_rn(a.z, hv);
  return __fadd_rn(__fadd_rn(__fmul_rn(dl, dl), __fmul_rn(du, du)),
                   __fmul_rn(dv, dv));
}

__device__ __forceinline__ float finish(float m) {
  const float d = __fsqrt_rn(fmaxf(m, 0.f));
  return d < FLOOR ? 0.f : d;
}

// side: 0 two-sided, 1 "ab" (the needle's colors outer), 2 "ba"
__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ ncol, const int* __restrict__ ncnt,
             int q, const float* __restrict__ hcol,
             const int* __restrict__ hcnt, const bool* __restrict__ valid,
             int c, int side, long long base, long long lo, long long hi,
             float* __restrict__ out, long long ldo) {
  __shared__ float4 sn[QT][NC];
  __shared__ int scnt[QT];
  const int q0 = blockIdx.y * QT;
  const int qn = min(QT, q - q0);
  for (int t = threadIdx.x; t < QT * NC; t += THREADS) {
    const int r = t / NC, i = t % NC;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < qn) {
      const float* p = ncol + ((size_t)(q0 + r) * NC + i) * 3;
      v = make_float4(p[0], p[1], p[2], 0.f);
    }
    sn[r][i] = v;
  }
  if (threadIdx.x < QT)
    scnt[threadIdx.x] = threadIdx.x < qn ? ncnt[q0 + threadIdx.x] : 0;
  __syncthreads();

  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= c) return;
  const long long row = base + col;
  const int nh = hcnt[col];
  const bool ok = valid[col] && nh > 0 && row >= lo && row < hi;
  float h[NC * 3];
  const float4* hp = reinterpret_cast<const float4*>(hcol + (size_t)col * NC * 3);
#pragma unroll
  for (int k = 0; k < NC * 3 / 4; ++k) {
    const float4 f = ok ? hp[k] : make_float4(0.f, 0.f, 0.f, 0.f);
    h[4 * k] = f.x;
    h[4 * k + 1] = f.y;
    h[4 * k + 2] = f.z;
    h[4 * k + 3] = f.w;
  }
  float* o = out + col;
  for (int r = 0; r < qn; ++r) {
    const int nq = scnt[r];
    float score = BAD;
    const bool two = side == 0;
    const int diff = nq > nh ? nq - nh : nh - nq;
    if (ok && nq > 0 && !(two && diff > 2)) {
      const bool ab = two ? nq >= nh : side == 1;
      float s = 0.f;
      if (ab) {  // sum over the needle's colors of the min over the row's
        for (int i = 0; i < nq; ++i) {
          const float4 a = sn[r][i];
          float m = BAD;
#pragma unroll
          for (int j = 0; j < NC; ++j)
            if (j < nh) m = fminf(m, d2of(a, h[3 * j], h[3 * j + 1], h[3 * j + 2]));
          s = __fadd_rn(s, finish(m));
        }
      } else {  // sum over the row's colors of the min over the needle's
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          if (j < nh) {
            float m = BAD;
            for (int i = 0; i < nq; ++i)
              m = fminf(m, d2of(sn[r][i], h[3 * j], h[3 * j + 1], h[3 * j + 2]));
            s = __fadd_rn(s, finish(m));
          }
        }
      }
      score = __fadd_rn(1.f, s);
    }
    o[(size_t)(q0 + r) * ldo] = score;
  }
}

}  // namespace

extern "C" int cbird_color_scores(const void* ncol, const void* ncnt, int q,
                                  const void* hcol, const void* hcnt,
                                  const void* valid, int c, int side,
                                  long long base, long long lo, long long hi,
                                  void* out, long long ldo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q == 0 || c == 0) return 0;
  if (side < 0 || side > 2) return (int)cudaErrorInvalidValue;
  // gridDim.y is at most 65535 needle tiles: launch in slices of that
  const int step = 65535 * QT;
  cudaError_t err = cudaSuccess;
  for (int q0 = 0; q0 < q; q0 += step) {
    const int qs = q - q0 < step ? q - q0 : step;
    const dim3 grid((c + THREADS - 1) / THREADS, (qs + QT - 1) / QT);
    score_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(ncol) + (size_t)q0 * NC * 3,
        static_cast<const int*>(ncnt) + q0, qs,
        static_cast<const float*>(hcol), static_cast<const int*>(hcnt),
        static_cast<const bool*>(valid), c, side, base, lo, hi,
        static_cast<float*>(out) + (size_t)q0 * ldo, ldo);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
  }
  return (int)err;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
