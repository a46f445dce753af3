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
// What bounds it on an H100: integer instructions on the pairs whose block
// keys are equal, the only ones that can count: two 32-bit POPC (16 per
// clock per SM) and a few INT32 each.  The inputs are read about once (12
// B a row).  Hits are rare, so everything after the distance test is off
// the hot path.
//
// Band design: run-bounded.  Only a row's own equal-key run can hold its
// partners, and the rows are sorted by the key, so a run is a contiguous
// range.  The work unit is a warp of 32 consecutive sorted rows (a row per
// lane, in registers).  The warp streams the columns from its first row +
// 1, 32 at a time: hash, row and validity, one coalesced load each a lane,
// issued a step ahead, staged through a per-warp slice of shared memory
// and read back by broadcast (reading them through L1 instead was slower
// on every block chip_tune.py times).  It stops at the smaller of its
// window end (the end of the tile after its last row's, never further:
// the pairs past it belong to the run tiles) and the first column past
// its last row whose key differs from that row's.  Every run of the
// warp's rows ends there or before, since the keys are sorted.
// The edge costs one ballot a 32-column step, so the warp finds it while
// it streams: no pass over the block and no operand beside the three.
// Invalid rows (tombstones, then the padding) follow the valid ones in the
// sorted order, unsorted among themselves: a run that reaches past the
// last valid row goes on while the invalid rows' keys happen to equal it,
// which only costs tests on rows that are credited nothing.  A warp with
// no valid row returns at once.  Row credits collect in registers and end
// with one atomicAdd per row; a column credit is one atomicAdd on a hit.
// Integer atomics are exact in any order.  Warps vary in work (a run of
// up to ~2 s rows stays in the band, a row's stream is up to 2 s columns
// long), so up to 8 warps share the columns of 32 rows (split_for), each
// taking SPAN columns in turn and stopping at the run edge on its own: a
// later warp returns at once when the run ends before its first column.
// Each warp tests its 32 columns a step without a branch (a bit mask of
// near pairs), so their loads and POPCs overlap, then walks the near
// pairs.
//
// Run tiles: the dense [s, s] tiles (ta, tb) of the equal-key runs longer
// than the band.  A run of a duplicate cluster makes them hit-dense: every
// pair of the tile may count.  The work unit is (tile pair, slice of
// RUN_ROWS rows of tile ta, slice of columns of tile tb), RUN_RPT rows a
// thread in registers, a block a unit; the unit streams its columns
// through shared memory, RUN_CHUNK at a time.  The launcher cuts the
// columns into slices so that the units fill the SMs about
// UNITS_PER_BLOCK times over, and a few tile pairs still spread over every
// SM.  A warp tests each of 32 columns against each of its rows and
// credits it without a branch (the block keys and the earlier blocks'
// masks too: a run tile's keys are mostly equal, so a distance-only pass
// first saves nothing).  Row credits collect in registers, one atomicAdd a
// row a unit.  A column's credits are bits of a 32-bit word a row, which
// a warp transpose (five shuffle rounds) hands to the column's lane, then
// a popc and a shared-memory sum over the block: one atomicAdd a column a
// unit, where the per-hit form issued one a lane a hit.  The tile list
// lies on the card ([P, 2] int32, built there from the runs' bounds,
// ops/pigeonhole.py run_tile_pairs); a pair outside the order is skipped.
// What bounds it: the 2 POPC an equal-key pair, as the band; the
// chip_tune.py k3run forms (rows a thread, chunks, a persistent grid,
// slices, unrolling) measured no faster.
//
// Masks ride in a by-value kernel argument (T <= 8).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;                 // warps per band block
constexpr int SPAN = 128;                // columns a warp takes in turn
static_assert(WARPS % 8 == 0 && SPAN % 32 == 0, "band block shape");
constexpr int RUN_THREADS = 256;         // run-tile block
constexpr int RUN_RPT = 4;               // run-tile rows per thread
constexpr int RUN_ROWS = RUN_THREADS * RUN_RPT;  // rows of ta a unit takes
constexpr int RUN_CHUNK = 256;           // columns staged at a time
constexpr int RUN_MIN_COLS = 64;         // the narrowest column slice
constexpr int UNITS_PER_BLOCK = 8;       // times the units fill the SMs
static_assert(RUN_CHUNK % 32 == 0 && RUN_MIN_COLS % 32 == 0, "run shape");
constexpr int MAX_MASKS = 8;

struct Masks {
  unsigned long long m[MAX_MASKS];  // m[0]: current block; then earlier
  int n;
};

// A near pair (x = a ^ b): are its current block keys equal and every
// earlier block's unequal, so that it counts in this block?
__device__ __forceinline__ bool first_block(unsigned long long x,
                                            const Masks& masks) {
  bool first = (x & masks.m[0]) == 0ull;
#pragma unroll
  for (int i = 1; i < MAX_MASKS; ++i)
    if (i < masks.n) first = first && (x & masks.m[i]) != 0ull;
  return first;
}

// The bits below k (k clamped to 0..32).
__device__ __forceinline__ unsigned below(int k) {
  return k >= 32 ? FULL : k <= 0 ? 0u : (1u << k) - 1u;
}

// Column q's hash and original row (-1 when invalid), or 0 and -1 past
// q_hi; the three loads issue together, so a hit waits on none of them.
__device__ __forceinline__ void load_column(
    const unsigned long long* __restrict__ sh, const int* __restrict__ srow,
    const bool* __restrict__ svalid, int q, int q_hi,
    unsigned long long& c, int& crow) {
  c = 0ull;
  crow = -1;
  if (q < q_hi) {
    c = sh[q];
    const int r = srow[q];
    crow = svalid[q] ? r : -1;
  }
}

__global__ void __launch_bounds__(32 * WARPS)
band_kernel(const unsigned long long* __restrict__ sh,
            const int* __restrict__ srow, const bool* __restrict__ svalid,
            int n_tot, int s, const Masks masks, int t, int split,
            int* __restrict__ out) {
  __shared__ unsigned long long c_hash[WARPS][32];
  __shared__ int c_row[WARPS][32];  // original row, -1 when invalid
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n_pad = n_tot - s;
  const int gw = blockIdx.x * WARPS + w;
  const int p0 = gw / split * 32, phase = gw % split;
  if (p0 >= n_pad) return;  // warp-uniform
  const int last = min(31, n_pad - 1 - p0);  // the last row's lane
  const int p_last = p0 + last;
  int q0 = p0 + 1 + phase * SPAN;  // this warp's first column
  if (phase) {
    // a later warp of the 32 rows: done unless the last row's run and
    // window reach its first column (the keys are sorted)
    if (q0 >= min((p_last / s + 2) * s, n_tot) ||
        ((sh[q0 - 1] ^ sh[p_last]) & masks.m[0]) != 0ull)
      return;
  }
  const int p = p0 + lane;
  const bool in = p < n_pad;
  const unsigned long long a = in ? sh[p] : 0ull;
  const int arow = (in && svalid[p]) ? srow[p] : -1;
  if (!__any_sync(FULL, arow >= 0)) return;
  const int wend = in ? min((p / s + 2) * s, n_tot) : 0;  // window end
  const unsigned long long key_last = __shfl_sync(FULL, a, last) & masks.m[0];
  int q_hi = __reduce_max_sync(FULL, wend);
  int acc = 0;
  unsigned long long c;
  int crow;
  load_column(sh, srow, svalid, q0 + lane, q_hi, c, crow);
  while (q0 < q_hi) {
    const int qc = q0 + lane;
    // the first column past the last row whose key differs ends its run
    const unsigned edge = __ballot_sync(
        FULL, qc < q_hi && qc > p_last && (c & masks.m[0]) != key_last);
    if (edge) q_hi = q0 + __ffs(edge) - 1;
    c_hash[w][lane] = c;
    c_row[w][lane] = crow;
    const unsigned valid_cols = __ballot_sync(FULL, crow >= 0);
    __syncwarp();
    // the next step's columns (past a span, the warp's next span) load
    // while this step's are tested
    int next = q0 + 32;
    if ((next - p0 - 1) % SPAN == 0) next += (split - 1) * SPAN;
    load_column(sh, srow, svalid, next + lane, q_hi, c, crow);
    // this row's columns here: valid ones in (p, min(wend, q_hi))
    const unsigned cols = arow < 0 ? 0u
        : valid_cols & below(min(wend, q_hi) - q0) & ~below(p + 1 - q0);
    // the distance test of all 32 columns without a branch, so their
    // loads and POPCs overlap
    unsigned near = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      near |= (unsigned)(__popcll(a ^ c_hash[w][j]) < t) << j;
    near &= cols;
    while (near) {  // rare but for duplicate clusters
      const int j = __ffs(near) - 1;
      near &= near - 1u;
      if (first_block(a ^ c_hash[w][j], masks)) {
        if (arow < c_row[w][j])
          ++acc;
        else
          atomicAdd(out + q0 + j, 1);
      }
    }
    __syncwarp();
    q0 = next;
  }
  if (acc) atomicAdd(out + p, acc);
}

// A pair (x = a ^ b) of the run tiles counts in this block: its current
// block keys are equal and each of the NM - 1 earlier blocks' differ; no
// branch.
template <int NM>
__device__ __forceinline__ bool counts_here(unsigned long long x,
                                            const Masks& masks) {
  bool ok = (x & masks.m[0]) == 0ull;
#pragma unroll
  for (int i = 1; i < NM; ++i) ok &= (x & masks.m[i]) != 0ull;
  return ok;
}

// 32 x 32 bits over a warp: bit c of lane r becomes bit r of lane c (five
// rounds, each swapping the off-diagonal halves of 2s x 2s blocks).
__device__ __forceinline__ unsigned transpose32(unsigned w, int lane) {
  unsigned m = 0x0000ffffu;  // the columns c with c & s == 0
#pragma unroll
  for (int s = 16; s; s >>= 1) {
    const unsigned o = __shfl_xor_sync(FULL, w, s);
    w = (lane & s) ? (w & ~m) | ((o >> s) & m) : (w & m) | ((o & m) << s);
    m ^= m << (s >> 1);
  }
  return w;
}

// A block a unit u = (pair * rs + row slice) * cs + column slice.  NM:
// the number of masks.
template <int NM>
__global__ void __launch_bounds__(RUN_THREADS)
run_kernel(const unsigned long long* __restrict__ sh,
           const int* __restrict__ srow, const bool* __restrict__ svalid,
           int n_tot, int s, const Masks masks, int t,
           const int* __restrict__ tiles, int rs, int cs,
           int width, int* __restrict__ out) {
  __shared__ unsigned long long c_hash[RUN_CHUNK];
  __shared__ int c_row[RUN_CHUNK];   // original row, -1 when invalid
  __shared__ int c_cred[RUN_CHUNK];  // the block's column credits
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_pad = n_tot - s;
  for (int j = tid; j < RUN_CHUNK; j += RUN_THREADS) c_cred[j] = 0;
  const long long u = blockIdx.x;  // the block's unit
  const int g = (int)(u / ((long long)rs * cs));
  const int r = (int)(u / cs % rs), c = (int)(u % cs);
  const int ta = tiles[2 * g], tb = tiles[2 * g + 1];
  if (ta < 0 || tb < ta + 2 || (long long)(tb + 1) * s > n_pad)
    return;  // block-uniform: not a run tile of this order
  const int r_lo = ta * s + r * RUN_ROWS;
  const int r_hi = min(ta * s + s, r_lo + RUN_ROWS);
  const int q_lo = tb * s + c * width;
  const int q_hi = min(tb * s + s, q_lo + width);
  unsigned long long a[RUN_RPT];
  int arow[RUN_RPT], acc[RUN_RPT];
#pragma unroll
  for (int k = 0; k < RUN_RPT; ++k) {
    const int p = r_lo + k * RUN_THREADS + tid;
    const bool in = p < r_hi;
    a[k] = in ? sh[p] : 0ull;
    arow[k] = (in && svalid[p]) ? srow[p] : -1;
    acc[k] = 0;
  }
  for (int q0 = q_lo; q0 < q_hi; q0 += RUN_CHUNK) {
    const int nc = min(RUN_CHUNK, q_hi - q0);
    __syncthreads();  // the last chunk's readers are done
    for (int j = tid; j < RUN_CHUNK; j += RUN_THREADS) {
      const bool in = j < nc;
      c_hash[j] = in ? sh[q0 + j] : 0ull;
      c_row[j] = (in && svalid[q0 + j]) ? srow[q0 + j] : -1;
    }
    __syncthreads();
    for (int j0 = 0; j0 < nc; j0 += 32) {
      // every pair of 32 columns tested and credited without a branch:
      // a row's credits in acc, a column's as bit j of cm (a row's)
      unsigned cm[RUN_RPT];
#pragma unroll
      for (int k = 0; k < RUN_RPT; ++k) cm[k] = 0;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const unsigned long long b = c_hash[j0 + j];
        const int cr = c_row[j0 + j];
#pragma unroll
        for (int k = 0; k < RUN_RPT; ++k) {
          const unsigned long long x = a[k] ^ b;
          const bool ok = (__popcll(x) < t) & counts_here<NM>(x, masks) &
                          (arow[k] >= 0) & (cr >= 0);
          acc[k] += ok & (arow[k] < cr);
          cm[k] |= (unsigned)(ok & (arow[k] > cr)) << j;
        }
      }
      // column j0 + lane's credits: bit lane of every lane's cm
      int mycol = 0;
#pragma unroll
      for (int k = 0; k < RUN_RPT; ++k)
        if (__any_sync(FULL, cm[k]))
          mycol += __popc(transpose32(cm[k], lane));
      if (mycol) atomicAdd(c_cred + j0 + lane, mycol);
    }
    __syncthreads();
    for (int j = tid; j < nc; j += RUN_THREADS) {
      const int v = c_cred[j];
      if (v) {
        atomicAdd(out + q0 + j, v);
        c_cred[j] = 0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RUN_RPT; ++k)
    if (acc[k]) atomicAdd(out + r_lo + k * RUN_THREADS + tid, acc[k]);
}

typedef void (*RunKernel)(const unsigned long long*, const int*,
                          const bool*, int, int, const Masks, int,
                          const int*, int, int, int, int*);

// run_kernel for n_masks masks (1..MAX_MASKS), or null
RunKernel run_kernel_for(int n_masks) {
  switch (n_masks) {
    case 1: return run_kernel<1>;
    case 2: return run_kernel<2>;
    case 3: return run_kernel<3>;
    case 4: return run_kernel<4>;
    case 5: return run_kernel<5>;
    case 6: return run_kernel<6>;
    case 7: return run_kernel<7>;
    case 8: return run_kernel<8>;
  }
  return nullptr;
}

// Warps that share the columns of 32 rows: the main path picks s from
// 1.5 to 3 average runs, so a larger tile means longer streams to deal
// out (chip_tune.py: at s=2048, 4 warps against 1 take the timed block
// from 0.42 to 0.16 ms and a random one from 0.075 to 0.083 ms).
int split_for(int s) {
  int split = 1;
  while (split < 8 && split * 512 <= s / 2) split *= 2;
  return split;
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
  const int split = split_for(s);
  const int rows_per_block = 32 * WARPS / split;
  const int grid = (n_tot - s + rows_per_block - 1) / rows_per_block;
  band_kernel<<<grid, 32 * WARPS, 0, st>>>(
      static_cast<const unsigned long long*>(sh),
      static_cast<const int*>(srow), static_cast<const bool*>(svalid), n_tot,
      s, pack(masks, n_masks), t, split, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// out[n_tot] += the credits of the dense tiles tiles[n_pairs][2] (device,
// int32 (ta, tb); a pair with ta < 0, tb < ta + 2 or (tb + 1) * s > n_tot - s
// is skipped).  A block a unit, the columns cut into slices of at least
// RUN_MIN_COLS for about UNITS_PER_BLOCK units a block of the blocks the
// SMs hold at once.
extern "C" int cbird_run_tiles(const void* sh, const void* srow,
                               const void* svalid, int n_tot, int s,
                               const unsigned long long* masks, int n_masks,
                               int t, const void* tiles, int n_pairs,
                               void* out, void* stream) {
  if (n_pairs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RunKernel kern = run_kernel_for(n_masks);
  if (!kern) return (int)cudaErrorInvalidValue;
  // blocks the SMs hold at once, by n_masks (one device a process on the
  // main path; a second card has as many SMs)
  static int caps[MAX_MASKS + 1] = {};
  int& cap = caps[n_masks];
  if (!cap) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, RUN_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    cap = sms * per_sm;
  }
  const int rs = (s + RUN_ROWS - 1) / RUN_ROWS;
  const long long base = (long long)n_pairs * rs;
  const long long want = (UNITS_PER_BLOCK * (long long)cap + base - 1) / base;
  const int max_cs = (s + RUN_MIN_COLS - 1) / RUN_MIN_COLS;
  const int cs0 = (int)(want < 1 ? 1 : want > max_cs ? max_cs : want);
  const int width = ((s + cs0 - 1) / cs0 + 31) / 32 * 32;
  const int cs = (s + width - 1) / width;
  const long long units = base * cs;
  kern<<<(int)units, RUN_THREADS, 0, st>>>(
      static_cast<const unsigned long long*>(sh),
      static_cast<const int*>(srow), static_cast<const bool*>(svalid), n_tot,
      s, pack(masks, n_masks), t, static_cast<const int*>(tiles), rs, cs,
      width, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* cbird_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
