// Pigeonhole band counts (kernel K3 of the port).
//
// Replaces cbird_tpu/ops/pallas_band.py band_counts (_band_kernel) and the
// two XLA forms that share its contract in cbird_tpu/ops/pigeonhole.py:
// _band_chunk / _band_contrib (the band) and _run_tile / _run_contribs (the
// dense tiles of equal-key runs longer than the band).
//
// Contract.  One block of the pigeonhole count phase has sorted the store
// by that block's bits: sh (hashes, one 64-bit pattern per row), srow
// (original store rows) and svalid, each n_tot = n_pad + s long.  A pair of
// sorted positions (p, q) counts when popcount(sh[p] ^ sh[q]) < t, the bits
// under m[0] (the current block's mask) are equal, the bits under every
// earlier block's mask m[1..] differ (so each pair counts in one block
// only), and both rows are valid.  A counted pair adds one to out[p] when
// srow[p] < srow[q], else to out[q]: the smaller original store row is
// credited.  band: every pair p < q within one tile of s positions or
// between adjacent tiles.  run: every pair of tile ta x tile tb for each
// listed (ta, tb), tb >= ta + 2, in one launch (the XLA form dispatched
// one program per tile pair).  out is the csort vector of the XLA loop,
// bit for bit.
//
// What bounds it on an H100: integer instructions.  The inputs are read
// once per tile (12 B a row) while each row meets ~1.5 s others, so memory
// is far below its 3.35 TB/s.  A pair that fails the current-block test costs a
// 64-bit xor, a masked zero test and, in the band, a position compare (~5
// INT32 instructions at 64 per clock per SM); a pair with equal block keys
// adds two 32-bit POPC (16 per clock per SM) and a compare.  Hits are rare,
// so everything after the distance test is off the hot path.
//
// Design.  A CUDA block takes ROWS sorted rows of one tile into registers
// (RPT per thread, strided so a warp holds 32 consecutive sorted rows) and
// streams the window's columns through shared memory in CHUNK-column
// stages (24 KB; s itself goes up to 131072, so the 2s window never has to
// fit).  The rows of a warp sit in the same equal-key run except at run
// edges, so the branch on the current-block test is nearly warp-uniform.
//
// Window: forward, not the TPU kernel's symmetric one.  The forward window
// ([p+1, end of the next tile)) visits ~1.5 s pairs per row; the symmetric
// window ([tile-1, tile+2) tiles, counted only from the smaller-row side)
// visits 3 s and needs no column-side credit.  The TPU chose symmetric
// because a column-axis reduction was slow there.  Here a column-side
// credit is one global atomicAdd executed only on a hit, and hits need
// equal block keys and distance < t, so they are rare: the forward window
// halves the pair work for a negligible number of atomics.  Row-side
// credits collect in registers and end with one atomicAdd per row (skipped
// when zero).  Integer atomics are exact in any order.
//
// Masks ride in a by-value kernel argument (T <= 8).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RPT = 4;                // sorted rows per thread
constexpr int ROWS = THREADS * RPT;   // sorted rows per CUDA block
constexpr int CHUNK = 2048;           // window columns per shared stage
constexpr int MAX_MASKS = 8;

struct Masks {
  unsigned long long m[MAX_MASKS];  // m[0]: current block; then earlier
  int n;
};

// BAND: blockIdx.x is the row tile, the columns are (p, end of next tile).
// !BAND: blockIdx.x indexes the (ta, tb) list, the columns are tile tb.
template <bool BAND>
__global__ void __launch_bounds__(THREADS)
band_kernel(const unsigned long long* __restrict__ sh,
            const int* __restrict__ srow, const bool* __restrict__ svalid,
            int n_tot, int s, const Masks masks, int t,
            const int* __restrict__ tiles, int* __restrict__ out) {
  __shared__ unsigned long long c_hash[CHUNK];
  __shared__ int c_row[CHUNK];  // original row, -1 when invalid

  int ta, col_lo, col_hi;
  if (BAND) {
    ta = blockIdx.x;
  } else {
    ta = tiles[2 * blockIdx.x];
    const int tb = tiles[2 * blockIdx.x + 1];
    col_lo = tb * s;
    col_hi = col_lo + s;
  }
  const int r_lo = ta * s + blockIdx.y * ROWS;
  const int r_hi = min(ta * s + s, r_lo + ROWS);
  if (BAND) {
    col_lo = r_lo + 1;
    col_hi = min(ta * s + 2 * s, n_tot);
  }

  const int tid = threadIdx.x;
  unsigned long long a[RPT];
  int arow[RPT], pos[RPT], acc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    pos[k] = r_lo + tid + k * THREADS;
    const bool in = pos[k] < r_hi;
    a[k] = in ? sh[pos[k]] : 0ull;
    arow[k] = (in && svalid[pos[k]]) ? srow[pos[k]] : -1;
    acc[k] = 0;
  }
  const unsigned long long cur = masks.m[0];

  for (int c0 = col_lo; c0 < col_hi; c0 += CHUNK) {
    const int nc = min(CHUNK, col_hi - c0);
    __syncthreads();
    for (int j = tid; j < nc; j += THREADS) {
      c_hash[j] = sh[c0 + j];
      c_row[j] = svalid[c0 + j] ? srow[c0 + j] : -1;
    }
    __syncthreads();
    for (int j = 0; j < nc; ++j) {
      const unsigned long long b = c_hash[j];
      const int q = c0 + j;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const unsigned long long x = a[k] ^ b;
        bool cand = (x & cur) == 0ull;
        if (BAND) cand = cand && q > pos[k];
        if (cand && __popcll(x) < t) {
          // a near pair with equal current-block keys (rare): it counts
          // here only if no earlier block's keys were equal
          bool first = true;
#pragma unroll
          for (int i = 1; i < MAX_MASKS; ++i)
            if (i < masks.n) first = first && (x & masks.m[i]) != 0ull;
          const int brow = c_row[j];
          if (first && arow[k] >= 0 && brow >= 0) {
            if (arow[k] < brow)
              ++acc[k];
            else
              atomicAdd(out + q, 1);
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (acc[k]) atomicAdd(out + pos[k], acc[k]);
}

Masks pack(const unsigned long long* masks, int n_masks) {
  Masks m = {};
  for (int i = 0; i < n_masks && i < MAX_MASKS; ++i) m.m[i] = masks[i];
  m.n = n_masks;
  return m;
}

}  // namespace

// out[n_tot] = the band credits (zeroed here first).  The caller checks
// that n_pad = n_tot - s is a positive multiple of s, n_tot + s < 2^30 and
// 1 <= n_masks <= 8.
extern "C" int cbird_band_counts(const void* sh, const void* srow,
                                 const void* svalid, int n_tot, int s,
                                 const unsigned long long* masks,
                                 int n_masks, int t, void* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)n_tot, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tot - s) / s, (s + ROWS - 1) / ROWS);
  band_kernel<true><<<grid, THREADS, 0, st>>>(
      static_cast<const unsigned long long*>(sh),
      static_cast<const int*>(srow), static_cast<const bool*>(svalid), n_tot,
      s, pack(masks, n_masks), t, nullptr, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// out[n_tot] += the credits of the dense tiles tiles[n_pairs][2] (device,
// int32 (ta, tb)); the caller checks 0 <= ta, ta + 2 <= tb, (tb + 1) * s
// <= n_tot - s.
extern "C" int cbird_run_tiles(const void* sh, const void* srow,
                               const void* svalid, int n_tot, int s,
                               const unsigned long long* masks, int n_masks,
                               int t, const void* tiles, int n_pairs,
                               void* out, void* stream) {
  if (n_pairs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_pairs, (s + ROWS - 1) / ROWS);
  band_kernel<false><<<grid, THREADS, 0, st>>>(
      static_cast<const unsigned long long*>(sh),
      static_cast<const int*>(srow), static_cast<const bool*>(svalid), n_tot,
      s, pack(masks, n_masks), t, static_cast<const int*>(tiles),
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
