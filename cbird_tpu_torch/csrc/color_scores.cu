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
// f(m) = sqrt(m) floored to 0 below 0.06 and d2 = fma(dv, dv, fma(dl, dl,
// du * du)) of needle minus row (__fmaf_rn, __fmul_rn: XLA's contraction
// on the CPU), the minimum on d2 and the sum in ascending color order:
// each term and the score equal the plain twin's (color_scores_plain) and
// the JAX package's bit for bit.
//
// What bounds it on an H100: FP32 issue.  A color pair costs 7
// instructions (3 subtracts, a multiply, 2 FMAs and a min: ~6750 at 31 x
// 31 colors) against 388 bytes a haystack row read once a block of QT
// needles, ~3 orders of magnitude above the memory bound.  An SM
// sub-partition issues one warp instruction a clock, so the design keeps
// the inner loop to those 7:
//
// - a block stages QT needles' colors in shared memory as float4 (one
//   broadcast load a needle color); each thread holds its haystack row's
//   96 floats in registers, statically indexed (the loop over them is
//   unrolled), with the slots at or past the row's count filled with a
//   copy of its color 0: a duplicate leaves every minimum bit-equal, so
//   no slot is tested in the loop;
// - one loop nest for both sides: the needle's colors outer (a trip
//   count the whole block shares), the row's 32 colors inner.  Side "ab"
//   keeps one running minimum and adds f(m) after each needle color; side
//   "ba" keeps 32 column minima and, after the needle loop, adds f(colmin
//   [j]) for j < count in ascending j (+0.0 for a padded slot, exact);
// - the two-sided form votes a warp at a time: a warp whose live rows all
//   take one side runs that side's loop; a warp of mixed rows runs one
//   pass that keeps both (one more min a pair) and each row takes its own;
// - side "ba" takes a row on two threads of 16 colors (SPLIT 2, 80
//   registers; the second thread of a row goes on from the first one's
//   sum, so the order stays ascending), the other sides a row a thread
//   (SPLIT 1, 168 registers, 3 blocks of 128 threads an SM, no spill):
//   a template instance chosen at launch by the side.
//
// chip_tune.py k6 times the other forms on an H100, as edits of this
// source: both sums in one pass for every two-sided warp (no vote) ran
// 20% slower at 1024 x 2^18; two threads a row 6% slower there and 9% on
// the "ab" side, 9% faster on the "ba" side; one thread a row on the
// "ba" side the reverse; needle tiles of 16 or 64 and 256 threads no
// faster; 128 registers (4 blocks an SM) 1% slower there and 26% on the
// "ba" side.
//
// Rejected pairs cost a store.  The output is written a needle at a time,
// consecutive threads on consecutive columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NC = 32;           // colors a descriptor
constexpr int THREADS = 128;     // threads a block
constexpr int QT = 32;           // needles a block holds in shared memory
constexpr float BAD = 3.0e38f;
constexpr float FLOOR = 0.06f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float d2of(float4 a, float hl, float hu,
                                      float hv) {
  const float dl = __fsub_rn(a.x, hl);
  const float du = __fsub_rn(a.y, hu);
  const float dv = __fsub_rn(a.z, hv);
  return __fmaf_rn(dv, dv, __fmaf_rn(dl, dl, __fmul_rn(du, du)));
}

__device__ __forceinline__ float finish(float m) {
  const float d = __fsqrt_rn(fmaxf(m, 0.f));
  return d < FLOOR ? 0.f : d;
}

// The needle loop over a[0..nq): AB adds to s_ab the finished minimum over
// the row's colors after each needle color; BA keeps the column minima cm.
// A thread holds NH = 32 / SPLIT of its row's colors.
template <int SPLIT, bool AB, bool BA, int NH = NC / SPLIT>
__device__ __forceinline__ void pass(const float4* a, int nq,
                                     const float (&h)[3 * NH], float& s_ab,
                                     float (&cm)[NH]) {
#pragma unroll 1
  for (int i = 0; i < nq; ++i) {
    const float4 ai = a[i];
    float m[2] = {BAD, BAD};
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const float d = d2of(ai, h[3 * j], h[3 * j + 1], h[3 * j + 2]);
      if (AB) m[j & 1] = fminf(m[j & 1], d);
      if (BA) cm[j] = fminf(cm[j], d);
    }
    if (AB) {
      float mm = fminf(m[0], m[1]);
      if (SPLIT > 1) mm = fminf(mm, __shfl_xor_sync(FULL, mm, 1));
      s_ab = __fadd_rn(s_ab, finish(mm));
    }
  }
}

// sum over the row's colors j < nh, in ascending j, of f(cm[j]); with
// SPLIT 2 the second thread of a row goes on from the first one's sum
template <int SPLIT, int NH = NC / SPLIT>
__device__ __forceinline__ float colsum(float (&cm)[NH], int half, int nh) {
#pragma unroll
  for (int j = 0; j < NH; ++j)
    cm[j] = half * NH + j < nh ? finish(cm[j]) : 0.f;
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < SPLIT; ++p) {
    if (half == p) {
#pragma unroll
      for (int j = 0; j < NH; ++j) s = __fadd_rn(s, cm[j]);
    }
    if (SPLIT > 1)
      s = __shfl_sync(FULL, s, (threadIdx.x & 31 & ~(SPLIT - 1)) | p);
  }
  return s;
}

// side: 0 two-sided, 1 "ab" (the needle's colors drive the sum), 2 "ba";
// SPLIT threads a haystack row (1 or 2)
template <int SPLIT>
__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ ncol, const int* __restrict__ ncnt,
             int q, const float* __restrict__ hcol,
             const int* __restrict__ hcnt, const bool* __restrict__ valid,
             int c, int side, long long base, long long lo, long long hi,
             float* __restrict__ out, long long ldo) {
  static_assert(SPLIT == 1 || SPLIT == 2, "a row on one or two threads");
  constexpr int NH = NC / SPLIT;  // a thread's colors of its row
  constexpr int ROWS = THREADS / SPLIT;  // haystack rows a block
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

  // every thread stays to the end: the warp votes take the whole warp
  const int half = threadIdx.x % SPLIT;
  const int col = blockIdx.x * ROWS + threadIdx.x / SPLIT;
  const bool in = col < c;
  const long long row = base + col;
  const int nh = in ? hcnt[col] : 0;
  const bool ok = nh > 0 && valid[col] && row >= lo && row < hi;
  float h[3 * NH];
  {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* hp =
        reinterpret_cast<const float4*>(hcol + (size_t)col * NC * 3);
    const float4 pad = ok ? hp[0] : z;  // the row's color 0
#pragma unroll
    for (int k = 0; k < 3 * NH / 4; ++k) {
      const float4 f = ok ? hp[half * (3 * NH / 4) + k] : z;
      h[4 * k] = f.x;
      h[4 * k + 1] = f.y;
      h[4 * k + 2] = f.z;
      h[4 * k + 3] = f.w;
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      if (half * NH + j >= nh) {
        h[3 * j] = pad.x;
        h[3 * j + 1] = pad.y;
        h[3 * j + 2] = pad.z;
      }
    }
  }
  float* o = out + col;
  const bool two = side == 0;
  for (int r = 0; r < qn; ++r) {
    const int nq = scnt[r];
    const int diff = nq > nh ? nq - nh : nh - nq;
    const bool live = ok && nq > 0 && !(two && diff > 2);
    const bool ab = two ? nq >= nh : side == 1;
    int mode = (__any_sync(FULL, live && ab) ? 1 : 0) |
               (__any_sync(FULL, live && !ab) ? 2 : 0);
    float s_ab = 0.f, s_ba = 0.f;
    float cm[NH];
#pragma unroll
    for (int j = 0; j < NH; ++j) cm[j] = BAD;
    if (mode == 1) {
      pass<SPLIT, true, false>(sn[r], nq, h, s_ab, cm);
    } else if (mode == 2) {
      pass<SPLIT, false, true>(sn[r], nq, h, s_ab, cm);
      s_ba = colsum<SPLIT>(cm, half, nh);
    } else if (mode == 3) {
      pass<SPLIT, true, true>(sn[r], nq, h, s_ab, cm);
      s_ba = colsum<SPLIT>(cm, half, nh);
    }
    if (in && half == SPLIT - 1)
      o[(size_t)(q0 + r) * ldo] =
          live ? __fadd_rn(1.f, ab ? s_ab : s_ba) : BAD;
  }
}

// One launch of score_kernel<SPLIT> per slice of at most 65535 needle
// tiles (gridDim.y's limit)
template <int SPLIT>
cudaError_t launch(const float* ncol, const int* ncnt, int q,
                   const float* hcol, const int* hcnt, const bool* valid,
                   int c, int side, long long base, long long lo,
                   long long hi, float* out, long long ldo, cudaStream_t s) {
  constexpr int ROWS = THREADS / SPLIT;
  const int step = 65535 * QT;
  for (int q0 = 0; q0 < q; q0 += step) {
    const int qs = q - q0 < step ? q - q0 : step;
    const dim3 grid((c + ROWS - 1) / ROWS, (qs + QT - 1) / QT);
    score_kernel<SPLIT><<<grid, THREADS, 0, s>>>(
        ncol + (size_t)q0 * NC * 3, ncnt + q0, qs, hcol, hcnt, valid, c,
        side, base, lo, hi, out + (size_t)q0 * ldo, ldo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int cbird_color_scores(const void* ncol, const void* ncnt, int q,
                                  const void* hcol, const void* hcnt,
                                  const void* valid, int c, int side,
                                  long long base, long long lo, long long hi,
                                  void* out, long long ldo, void* stream) {
  if (q == 0 || c == 0) return 0;
  if (side < 0 || side > 2) return (int)cudaErrorInvalidValue;
  const int split = side == 2 ? 2 : 1;  // threads a row, by the side
  auto go = split == 2 ? launch<2> : launch<1>;
  return (int)go(static_cast<const float*>(ncol),
                 static_cast<const int*>(ncnt), q,
                 static_cast<const float*>(hcol),
                 static_cast<const int*>(hcnt),
                 static_cast<const bool*>(valid), c, side, base, lo, hi,
                 static_cast<float*>(out), ldo,
                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
