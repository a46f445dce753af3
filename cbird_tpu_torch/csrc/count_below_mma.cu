// Hamming count-below-threshold on the tensor cores (kernel K1-mma).
//
// Replaces the TPU's +-1 matrix-product count kernels, which all compute the
// production K1's function (cbird_tpu/ops/mxu_count.py mxu_count_below):
// experiments/mxu_epilogue_ab.py count (v0-v2), count_jouter (v3) and
// count_packed (v4), experiments/mxu_i16_ab.py count_i16 and, as the bf16
// instantiation, experiments/mxu_count_sweep2.py mxu_count_bf16.  The TPU's
// int16 dot tile has no counterpart: mma.sync on s8 accumulates only in
// s32, as Mosaic refused i16 accumulation there.
//
// Contract: out[i] = #{ j < n : valid[j] and popcount(needles[i] ^ hay[j]) < t }
// for 0 <= t <= 63 (the caller takes the popcount K1 at t = 64).  Hashes are
// one 64-bit pattern per row.
//
// Form: a hash unpacked to a +-1 vector (bit 0 -> +1, bit 1 -> -1) gives
// dot(a, b) = 64 - 2 * ham(a, b), so ham < t <=> dot > 64 - 2t.  The product
// runs on mma.sync.m16n8k32 s8 (K = 64 is two k-steps; the bf16 form takes
// four m16n8k16 steps with f32 sums, exact since |dot| <= 64); the compare
// and the row sum stay in registers, and only [Q] counts reach memory.
// Validity is a per-column compare value, 64 - 2t for a valid column and a
// value no dot exceeds for an invalid one or one past the ragged edge, so K
// stays 64 (the TPU padded it to 96 with a penalty lane).
//
// Layout: each warp holds 2 m16 tiles of needles (32 rows) as A fragments in
// registers, unpacked once; a block of 8 warps (256 needles) streams its
// column range past them in steps of 256 columns.  Each step unpacks its
// columns once into shared memory, already in the B fragment order, so a
// lane fetches an n8 tile's fragments with one 16-byte load (two for bf16)
// and reuses them for both m tiles.  A 16-entry table maps 4 bits to 4
// packed +-1 bytes.  The bit order of the lanes is the same on both
// operands, and the dot does not depend on it.  Each thread ends with one
// atomicAdd per needle row and block, after a quad shuffle.
//
// What bounds it on an H100: per pair 128 int8 tensor operations (1,979
// TOPS dense) and an epilogue of a compare (the ALU pipe, 64 per clock per
// SM) and an add (either INT32 pipe) on 132 SMs; the haystack is read once
// per needle tile (8 B + 1 B a row).  The tensor operations bound the int8
// form, the epilogue just under them, ~7x below the popcount form's bound
// (2 POPC a pair at 16 per clock per SM).  This form is mma.sync; wgmma,
// TMA and a packed epilogue are later performance work.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 2;                  // m16 tiles per warp
constexpr int BQ = WARPS * MT * 16;    // needles per block
constexpr int SUB = 256;               // haystack columns per step
constexpr int NT = SUB / 8;            // n8 tiles per step

struct S8 {  // int8 operands, s32 sums
  static constexpr int KS = 32;        // k per mma
  static constexpr int STEPS = 64 / KS;
  static constexpr int EPR = 4;        // elements per 32-bit register
  typedef int Acc;
  __device__ static Acc never() { return INT_MAX; }
  __device__ static Acc rhs(int t) { return 64 - 2 * t; }
  __device__ static uint32_t unpack(unsigned long long h, int pos,
                                    const uint32_t* tab) {
    return tab[(h >> pos) & 15];
  }
  __device__ static void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct BF16 {  // bf16 operands, f32 sums
  static constexpr int KS = 16;
  static constexpr int STEPS = 64 / KS;
  static constexpr int EPR = 2;
  typedef float Acc;
  __device__ static Acc never() { return __int_as_float(0x7f800000); }
  __device__ static Acc rhs(int t) { return (float)(64 - 2 * t); }
  // +1.0 is 0x3F80; the bit sets the sign of its half
  __device__ static uint32_t unpack(unsigned long long h, int pos,
                                    const uint32_t*) {
    const uint32_t x = (uint32_t)(h >> pos) & 3u;
    return 0x3F803F80u | ((x & 1u) << 15) | ((x & 2u) << 30);
  }
  __device__ static void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Fragment order (PTX ISA, mma.m16n8k32 s8 and m16n8k16 bf16): lane = 4g + q.
// A register 2h + r of k-step s holds row g + 8r, k = s*KS + h*KS/2 + q*EPR
// and its next EPR - 1; B register 2s + h holds column g at the same k.  The
// sums land at rows g (c0, c1) and g + 8 (c2, c3), columns 2q and 2q + 1.
template <class T>
__global__ void __launch_bounds__(THREADS)
mma_count_kernel(const unsigned long long* __restrict__ needles, int q,
                 const unsigned long long* __restrict__ hay,
                 const bool* __restrict__ valid, int n, int t,
                 int cols_per_block, int* __restrict__ out) {
  typedef typename T::Acc Acc;
  constexpr int NB = 2 * T::STEPS;  // B registers per lane per n8 tile
  __shared__ __align__(16) uint32_t sb[NT * 32 * NB];
  __shared__ __align__(8) Acc slim[SUB];
  __shared__ uint32_t tab[16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  if (threadIdx.x < 16) {
    uint32_t v = 0;
    for (int e = 0; e < 4; ++e) v |= ((threadIdx.x >> e & 1) ? 0xFFu : 1u) << (8 * e);
    tab[threadIdx.x] = v;
  }
  __syncthreads();

  // this warp's needle rows as A fragments, unpacked once
  const int r0 = blockIdx.y * BQ + warp * (MT * 16);
  uint32_t a[MT][T::STEPS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + m * 16 + g + 8 * r;
      const bool in = row < q;
      const unsigned long long h = in ? needles[row] : 0ull;
#pragma unroll
      for (int s = 0; s < T::STEPS; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          a[m][s][2 * hf + r] =
              in ? T::unpack(h, s * T::KS + hf * (T::KS / 2) + qd * T::EPR, tab)
                 : 0u;
    }
  }
  int cnt[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) cnt[m][0] = cnt[m][1] = 0;

  const int c_begin = blockIdx.x * cols_per_block;
  const int c_end = min(n, c_begin + cols_per_block);
  for (int c0 = c_begin; c0 < c_end; c0 += SUB) {
    // stage: each column unpacked into the B registers of its four lanes
    for (int j = threadIdx.x; j < SUB; j += THREADS) {
      const int col = c0 + j;
      const bool in = col < c_end;
      const unsigned long long h = in ? hay[col] : 0ull;
      slim[j] = (in && valid[col]) ? T::rhs(t) : T::never();
      uint32_t* dst = sb + ((j >> 3) * 32 + (j & 7) * 4) * NB;
#pragma unroll
      for (int lq = 0; lq < 4; ++lq)
#pragma unroll
        for (int s = 0; s < T::STEPS; ++s)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            dst[lq * NB + 2 * s + hf] =
                T::unpack(h, s * T::KS + hf * (T::KS / 2) + lq * T::EPR, tab);
    }
    __syncthreads();
#pragma unroll 4
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[NB];
      const uint4* src = reinterpret_cast<const uint4*>(sb + (nt * 32 + lane) * NB);
#pragma unroll
      for (int v = 0; v < NB / 4; ++v) {
        const uint4 w = src[v];
        b[4 * v] = w.x; b[4 * v + 1] = w.y; b[4 * v + 2] = w.z; b[4 * v + 3] = w.w;
      }
      const Acc l0 = slim[nt * 8 + 2 * qd], l1 = slim[nt * 8 + 2 * qd + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        Acc c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int s = 0; s < T::STEPS; ++s) T::mma(c, a[m][s], b[2 * s], b[2 * s + 1]);
        cnt[m][0] += (c[0] > l0) + (c[1] > l1);
        cnt[m][1] += (c[2] > l0) + (c[3] > l1);
      }
    }
    __syncthreads();
  }

  // the four lanes of a quad hold the same two rows
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int v = cnt[m][r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int row = r0 + m * 16 + g + 8 * r;
      if (qd == 0 && row < q && v) atomicAdd(out + row, v);
    }
}

template <class T>
cudaError_t launch(const unsigned long long* nd, int q,
                   const unsigned long long* hs, const bool* vd, int n, int t,
                   int* o, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // gridDim.y is at most 65535 needle tiles: launch in slices of that
  const int step = 65535 * BQ;
  cudaError_t err = cudaSuccess;
  for (int q0 = 0; q0 < q; q0 += step) {
    const int qs = min(step, q - q0);
    const int ytiles = (qs + BQ - 1) / BQ;
    // split the columns so that ~16 blocks per SM are in the grid, each a
    // whole number of steps
    const int xb = max(1, (16 * sms + ytiles - 1) / ytiles);
    int cols = (n + xb - 1) / xb;
    cols = (cols + SUB - 1) / SUB * SUB;
    const dim3 grid((n + cols - 1) / cols, ytiles);
    mma_count_kernel<T><<<grid, THREADS, 0, s>>>(nd + q0, qs, hs, vd, n, t,
                                                 cols, o + q0);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
  }
  return err;
}

}  // namespace

extern "C" int cbird_count_below_mma(const void* needles, int q,
                                     const void* hay, const void* valid, int n,
                                     int t, int bf16, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)q, s);
  if (err != cudaSuccess || q == 0 || n == 0) return (int)err;
  auto nd = static_cast<const unsigned long long*>(needles);
  auto hs = static_cast<const unsigned long long*>(hay);
  auto vd = static_cast<const bool*>(valid);
  auto o = static_cast<int*>(out);
  err = bf16 ? launch<BF16>(nd, q, hs, vd, n, t, o, s)
             : launch<S8>(nd, q, hs, vd, n, t, o, s);
  return (int)err;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
