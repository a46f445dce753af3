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
// int16 dot tile has no counterpart: mma.sync on s8 accumulates only in
// s32, as Mosaic refused i16 accumulation there.  The popcount form of the
// same function (count_below.cu) stays as the yardstick.
//
// Contract: out[i] = #{ j < n : valid[j] and popcount(needles[i] ^ hay[j]) < t
//                              and (!MASKED or col_base + j > row_base + i) }
// for 0 <= t <= 65; t = 65 counts every valid column, as popcount < t does
// for any t >= 65, so the caller passes min(t, 65).  Hashes are one 64-bit
// pattern per row.  row_base and col_base are 64-bit global ids.
//
// Form: a hash unpacked to a +-1 vector (bit 0 -> +1, bit 1 -> -1) gives
// dot(a, b) = 64 - 2 * ham(a, b), so ham < t <=> dot > 64 - 2t.  The needles
// are unpacked negated, so the product runs mma.sync.m16n8k32 s8 (K = 64 is
// two k-steps; the bf16 form takes four m16n8k16 steps with f32 sums, exact
// since |dot| <= 64) as c = init - dot.  The epilogue is folded into init:
// 64 - 2t for a counted column (64 - 2t + 0.5 in bf16, so that c is never
// a signed zero), and 2^20, which no dot brings below 0, for an invalid
// column, one past the ragged edge or a masked pair.  A hit is then c < 0,
// and the count adds each accumulator's sign bit (one LEA.HI a pair in
// SASS, where a compare against a per-column limit and an add took two).
// The valid mask never widens K (the TPU padded it to 96 with a penalty
// lane).
//
// Layout: each warp holds 4 m16 tiles of needles (64 rows) as A fragments in
// registers, unpacked once; a block of 8 warps (512 needles) streams its
// column range past them in steps of 256 columns.  Each step unpacks its
// columns once into shared memory, already in the B fragment order (four
// threads a column, each writing its lane's 16 bytes next to its
// neighbour's, so the stores meet no bank conflict), so a lane fetches an
// n8 tile's fragments with one 16-byte load (two for bf16) and reuses them
// for all four m tiles.  A 16-entry table maps 4 bits to 4 packed +-1
// bytes.  The bit order of the lanes is the same on both operands, and the
// dot does not depend on it.  Each thread ends with one atomicAdd per
// needle row and block, after a quad shuffle.
//
// The mask (K2) is decided per tile, not per pair: a block starts at its
// first step that holds a column past its first row (and exits when it
// has none); in each step a warp skips the n8 tiles whose columns all lie
// at or below its first row, runs those whose columns all lie past its
// last row as K1 does, and only the n8 tiles that straddle its 64 rows
// (at most 9 of a step's 32) set the init of each masked pair.  So K2
// costs what K1-mma costs on the pairs above the diagonal, and nothing on
// those below it.
//
// What bounds it on an H100: per pair 128 int8 tensor operations (1,979
// TOPS dense) and an epilogue of one INT32 instruction on 132 SMs; the
// haystack is read once per needle tile (8 B + 1 B a row).  The tensor
// operations bound it, ~7x below the popcount form's bound (2 POPC a pair
// at 16 per clock per SM).  Below that bound, shared memory's 128 bytes a
// clock per SM feed the B fragments: 512 bytes a warp per n8 tile, so
// the more m tiles reuse them the fewer wavefronts a product needs, and
// the stage's stores must not conflict (a column's 64 bytes written by
// one thread meet 16-way conflicts, as many wavefronts as the products'
// loads take).  This form is mma.sync; wgmma with B from
// shared memory and TMA-fed column tiles are later performance work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 4;                  // m16 tiles per warp
constexpr int WR = MT * 16;            // needle rows per warp
constexpr int BQ = WARPS * WR;         // needles per block
constexpr int SUB = 256;               // haystack columns per step
constexpr int NT = SUB / 8;            // n8 tiles per step

struct S8 {  // int8 operands, s32 sums
  static constexpr int KS = 32;        // k per mma
  static constexpr int STEPS = 64 / KS;
  static constexpr int EPR = 4;        // elements per 32-bit register
  typedef int Acc;
  typedef int2 Acc2;
  __device__ static Acc fold(int t) { return 64 - 2 * t; }
  __device__ static Acc never() { return 1 << 20; }
  __device__ static int sign(Acc c) { return (int)((uint32_t)c >> 31); }
  __device__ static uint32_t unpack(unsigned long long h, int pos,
                                    const uint32_t* tab) {
    return tab[(h >> pos) & 15];
  }
  __device__ static void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                             uint32_t b1, const Acc (&c)[4]) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
  }
};

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
  __device__ static uint32_t unpack(unsigned long long h, int pos,
                                    const uint32_t*) {
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

// floor(x / 8) clamped to [lo, NT]: an n8 tile index
__device__ __forceinline__ int tile_at(long long x, int lo) {
  const long long f = x >= 0 ? x / 8 : -((7 - x) / 8);
  return f < lo ? lo : (f > NT ? NT : (int)f);
}

// One n8 tile of the step in shared memory against the warp's m tiles.
// MASK: rel is the tile's first column less the warp's first row (global
// ids); a pair counts only where its column exceeds its row.
template <class T, bool MASK>
__device__ __forceinline__ void n8_tile(
    int nt, int rel, const uint32_t* sb, const typename T::Acc* sinit,
    const uint32_t (&a)[MT][T::STEPS][4], int (&cnt)[MT][2], int lane,
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
  Acc c[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
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
    for (int m = 0; m < MT; ++m)
      T::mma(c[m], a[m][s], b[2 * s], b[2 * s + 1], c[m]);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    cnt[m][0] += T::sign(c[m][0]) + T::sign(c[m][1]);
    cnt[m][1] += T::sign(c[m][2]) + T::sign(c[m][3]);
  }
}

// Fragment order (PTX ISA, mma.m16n8k32 s8 and m16n8k16 bf16): lane = 4g + q.
// A register 2h + r of k-step s holds row g + 8r, k = s*KS + h*KS/2 + q*EPR
// and its next EPR - 1; B register 2s + h holds column g at the same k.  The
// sums land at rows g (c0, c1) and g + 8 (c2, c3), columns 2q and 2q + 1.
template <class T, bool MASKED>
__global__ void __launch_bounds__(THREADS)
mma_count_kernel(const unsigned long long* __restrict__ needles, int q,
                 const unsigned long long* __restrict__ hay,
                 const bool* __restrict__ valid, int n, int t,
                 long long row_base, long long col_base, int cols_per_block,
                 int* __restrict__ out) {
  typedef typename T::Acc Acc;
  constexpr int NB = 2 * T::STEPS;
  __shared__ __align__(16) uint32_t sb[NT * 32 * NB];
  __shared__ __align__(8) Acc sinit[SUB];
  __shared__ uint32_t tab[16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;

  int c_begin = blockIdx.x * cols_per_block;
  const int c_end = min(n, c_begin + cols_per_block);
  if (MASKED) {
    // steps whose columns all lie at or below the block's first row
    // count nothing: start past them, or leave (the whole block at once)
    const long long d = row_base + (long long)blockIdx.y * BQ
                        - (col_base + c_begin);
    if (d >= SUB - 1) {
      const long long skip = ((d - (SUB - 1)) / SUB + 1) * SUB;
      if (skip >= c_end - c_begin) return;
      c_begin += (int)skip;
    }
  }
  if (threadIdx.x < 16) {
    uint32_t v = 0;
    for (int e = 0; e < 4; ++e) v |= ((threadIdx.x >> e & 1) ? 0xFFu : 1u) << (8 * e);
    tab[threadIdx.x] = v;
  }
  __syncthreads();

  // this warp's needle rows as A fragments, negated, unpacked once
  const int r0 = blockIdx.y * BQ + warp * WR;
  uint32_t a[MT][T::STEPS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
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
              in ? T::unpack(h, s * T::KS + hf * (T::KS / 2) + qd * T::EPR, tab)
                 : 0u;
    }
  }
  int cnt[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) cnt[m][0] = cnt[m][1] = 0;

  for (int c0 = c_begin; c0 < c_end; c0 += SUB) {
    // stage: item i is column j = i / 4 for lane 4 * (j % 8) + i % 4 of
    // n8 tile j / 8, whose B registers lie at sb + i * NB: consecutive
    // items fill consecutive 16 bytes, so the stores meet no bank conflict
    for (int i = threadIdx.x; i < 4 * SUB; i += THREADS) {
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
              T::unpack(h, s * T::KS + hf * (T::KS / 2) + lq * T::EPR, tab);
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
      // straddle its rows, [hi, NT) lie past its last row
      const long long d = row_base + r0 - (col_base + c0);
      const int lo = tile_at(d + 1, 0), hi = tile_at(d + WR + 7, lo);
      for (int nt = lo; nt < hi; ++nt)
        n8_tile<T, true>(nt, 8 * nt - (int)d, sb, sinit, a, cnt, lane, g, qd);
#pragma unroll 4
      for (int nt = hi; nt < NT; ++nt)
        n8_tile<T, false>(nt, 0, sb, sinit, a, cnt, lane, g, qd);
    } else {
#pragma unroll 4
      for (int nt = 0; nt < NT; ++nt)
        n8_tile<T, false>(nt, 0, sb, sinit, a, cnt, lane, g, qd);
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

template <class T, bool MASKED>
cudaError_t launch(const unsigned long long* nd, int q,
                   const unsigned long long* hs, const bool* vd, int n, int t,
                   long long row_base, long long col_base, int* o,
                   cudaStream_t s) {
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
    mma_count_kernel<T, MASKED><<<grid, THREADS, 0, s>>>(
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
    err = masked ? launch<BF16, true>(nd, q, hs, vd, n, t, row_base, col_base, o, s)
                 : launch<BF16, false>(nd, q, hs, vd, n, t, row_base, col_base, o, s);
  else
    err = masked ? launch<S8, true>(nd, q, hs, vd, n, t, row_base, col_base, o, s)
                 : launch<S8, false>(nd, q, hs, vd, n, t, row_base, col_base, o, s);
  return (int)err;
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
