"""Checks the rates behind chip_smoke.py's bounds on one NVIDIA GPU.

    python3 chip_bounds.py [OUT_DIR]     (default build/bounds)

chip_smoke.py bounds the count kernels by instruction issue: 2 POPC a
pair for the popcount K1 (count_below.cu), and for the tensor-core K1-mma
(count_below_mma.cu) the int8 / e4m3 tensor rate, at a per-SM rate a
clock and the card's maximum SM clock.  This script reads what the
compiler made of both and what the card sustains:

  sass     cuobjdump -sass of the count kernels (K1, K1-mma), the top-k
           scan (K4), the band counts (K3) and the 256-bit k-nearest
           search (K5 and its popcount form) and the color scores (K6)
           into OUT_DIR/<name>.sass,
           and per loop (a backward branch) the opcode counts of its body;
           for the wgmma kernels (K1-mma, K2-mma, K5) their main loop's
           warpgroup MMAs (QGMMA for e4m3, IGMMA for s8, HGMMA for bf16),
           moves, shifts, LEA, HADD2, barriers (SYNCS, BAR, WARPGROUP) and
           shared loads
           and stores: the script fails if a main loop holds no *GMMA or
           an mma.sync (IMMA, HMMA); for K6 its loops of 100 or more
           instructions (the color-pair loops and the needle loop around
           them): their FP32 opcodes (FADD, FMUL, FFMA, FMNMX) against
           all, and the script fails if one holds no FFMA (d2 is
           contracted as XLA contracts it)
  probes   kernels of 8 independent chains a thread, timed with
           CUDA events: POPC chained through an add (a += popc(a)), the
           epilogue's compare and add (x += d; c += x > lim), K1's
           pattern (c += popc(a ^ i)), the mma.sync product (4 chains of
           int8 mma.sync m16n8k32 a warp) and the mma.sync form's inner loop
           without its loads (4 m tiles of two chained k-steps from a
           folded init, their sign bits counted); each one's opcode counts
           a step, and the instructions it sustains per clock per SM (the
           mma's per warp, and its int8 TOPS); and the int8 wgmma in
           K1-mma's shape (m64n256k32, A from registers, B in the
           kernel's shared-memory layout, one block an SM): chains on one
           and on two warpgroups, and two warpgroups that count each
           product's sign bits after it, as IGMMA per clock per SM and
           int8 TOPS; and the e4m3 wgmma with f16 sums (K1-mma's and K5's
           products) chained on two warpgroups, as QGMMA per clock per SM
           and TOPS; the bf16 wgmma with f32 sums (m64n128k16, the bf16
           form's product) chained on two and three warpgroups, as HGMMA
           per clock per SM and TFLOPS; and K6's color-pair step (3
           subtracts, a multiply, 2 FMAs and a min) as FP32 instructions a
           clock per SM
  K1       the popcount K1 at Q=16384, N=2^21, t=5 (the K1 variants'
           shape, on operands made as chip_smoke's): 20 launches after
           K1-mma's two forms, as chip_smoke times them, and 100 alone,
           with the POPC a pair it needs over time and clock
  clocks   nvidia-smi clocks.sm, power.draw and the active clock event
           reasons sampled while each timed loop runs, beside
           clocks.max.sm; and in each probe block, the SM clock its run
           ran at (clock64 cycles over globaltimer ns)

Prints one JSON line per part and the card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np

PROBE_SRC = r"""
#include <cuda_runtime.h>
constexpr int CHAINS = 8;
__device__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
template <int OP>
__global__ void __launch_bounds__(256) probe(unsigned* out,
                                             unsigned long long* times,
                                             int iters, unsigned d,
                                             unsigned lim) {
  const unsigned long long c0 = clock64(), g0 = globaltimer();
  unsigned a[CHAINS], c[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    a[j] = (blockIdx.x * 256u + threadIdx.x) * 0x9E3779B9u + j;
    c[j] = 0;
  }
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if (OP == 0) {         // POPC chained through an add
        a[j] += __popc(a[j]);
      } else if (OP == 1) {  // the epilogue's compare and add
        a[j] += d;
        c[j] += a[j] > lim;
      } else {               // K1's pattern: xor, POPC, add
        c[j] += __popc(a[j] ^ (unsigned)i);
      }
    }
  }
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += a[j] + c[j];
  if (s == 0x12345678u) out[0] = s;  // keeps the chains live
  if (threadIdx.x == 0) {  // SM cycles and ns of this block's run
    unsigned long long* tb = times + 4 * blockIdx.x;
    tb[0] = c0; tb[1] = clock64(); tb[2] = g0; tb[3] = globaltimer();
  }
}
// the mma.sync product: CHAINS / 2 independent int8 m16n8k32 chains a
// warp (their accumulators in 16 registers, so no spill at 8 blocks a SM)
#define IMMA(x)                                                       \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "     \
               "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};" \
               : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3])       \
               : "r"(a), "r"(d))
__global__ void __launch_bounds__(256) imma_probe(unsigned* out,
                                                  unsigned long long* times,
                                                  int iters, unsigned d) {
  const unsigned long long c0 = clock64(), g0 = globaltimer();
  const unsigned a = (blockIdx.x * 256u + threadIdx.x) * 0x9E3779B9u;
  int x[4] = {0, 0, 0, 0}, y[4] = {0, 0, 0, 0}, z[4] = {0, 0, 0, 0},
      w[4] = {0, 0, 0, 0};
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    IMMA(x); IMMA(y); IMMA(z); IMMA(w);
  }
  const unsigned s = x[0] + x[1] + x[2] + x[3] + y[0] + y[1] + y[2] + y[3] +
                     z[0] + z[1] + z[2] + z[3] + w[0] + w[1] + w[2] + w[3];
  if (s == 0x12345678u) out[0] = s;
  if (threadIdx.x == 0) {
    unsigned long long* tb = times + 4 * blockIdx.x;
    tb[0] = c0; tb[1] = clock64(); tb[2] = g0; tb[3] = globaltimer();
  }
}
// the mma.sync form's inner loop without its loads: 4 m tiles of distinct A
// fragments against a B pair that changes each step, each tile two
// chained k-steps from a folded init, then its sign bits counted
__global__ void __launch_bounds__(256) imma_tile_probe(
    unsigned* out, unsigned long long* times, int iters, unsigned d) {
  const unsigned long long c0 = clock64(), g0 = globaltimer();
  const unsigned a0 = (blockIdx.x * 256u + threadIdx.x) * 0x9E3779B9u;
  unsigned a[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[m][r] = a0 * (4 * m + r + 1);
  int cnt = 0;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    const unsigned b0 = d ^ (unsigned)i, b1 = d + (unsigned)i;
    int x[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      x[m][0] = x[m][2] = i & 63;
      x[m][1] = x[m][3] = 63 - (i & 63);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+r"(x[m][0]), "+r"(x[m][1]), "+r"(x[m][2]), "+r"(x[m][3])
            : "r"(a[m][0]), "r"(a[m][1]), "r"(a[m][2]), "r"(a[m][3]),
              "r"(k ? b1 : b0), "r"(k ? b0 : b1));
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) cnt += (int)((unsigned)x[m][e] >> 31);
  }
  if (cnt == 0x12345678) out[0] = cnt;
  if (threadIdx.x == 0) {
    unsigned long long* tb = times + 4 * blockIdx.x;
    tb[0] = c0; tb[1] = clock64(); tb[2] = g0; tb[3] = globaltimer();
  }
}
// the int8 wgmma in K1-mma's shape: m64n256k32, A from registers, B (256 columns x 64 bytes of +-1)
// from shared memory in the kernel's K-major layout; WGS warpgroups a
// block, one block an SM, each a chain of two products a group on its own
// 128 accumulators.  Chained: one group in flight while the next is
// issued.  EPI: each group starts from 0 (scale-d 0) and waits, and its
// sums' sign bits are counted (the int8 form's count)
__device__ __forceinline__ void wgmma256(int (&d)[128], const unsigned (&a)[4],
                                         unsigned long long desc, int scale) {
#define D8(i)                                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
#undef D8
}
template <int WGS, bool EPI>
__global__ void __launch_bounds__(128 * WGS, 1) wgmma_probe(
    unsigned* out, unsigned long long* times, int iters) {
  __shared__ __align__(1024) uint4 b[256 * 64 / 16];
  const unsigned long long c0 = clock64(), g0 = globaltimer();
  for (int i = threadIdx.x; i < 256 * 64 / 16; i += blockDim.x)
    b[i] = make_uint4(0x01FF01FFu, 0xFF0101FFu, 0x0101FFFFu, 0xFFFF0101u);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(b));
  // K-major, no swizzle: LBO 128 bytes, SBO 512 (8 columns of 64 bytes)
  const unsigned long long desc =
      ((base & 0x3FFFF) >> 4) | (8ull << 16) | (32ull << 32);
  const unsigned a[4] = {0x01FF0101u * (threadIdx.x | 1), 0xFF01FF01u,
                         0x0101FF01u ^ threadIdx.x, 0xFFFF01FFu};
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  int cnt = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(acc[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    wgmma256(acc, a, desc, EPI ? 0 : 1);
    wgmma256(acc, a, desc + 16, 1);  // the second k32 step, 256 bytes on
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (EPI) {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 128; ++i) {
        asm volatile("" : "+r"(acc[i])::"memory");
        cnt += static_cast<int>(static_cast<unsigned>(acc[i]) >> 31);
      }
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int i = 0; i < 128; ++i) cnt += acc[i];
  if (cnt == 0x12345678) out[0] = cnt;
  if (threadIdx.x == 0) {
    unsigned long long* tb = times + 4 * blockIdx.x;
    tb[0] = c0; tb[1] = clock64(); tb[2] = g0; tb[3] = globaltimer();
  }
}
// the e4m3 wgmma with f16 sums (K1-mma's and K5's form): m64n256k32, +-1
// operands (0x38, 0xB8) in the same layout, WGS warpgroups a block, one
// block an SM, each a chain of two products a group on its own 64 registers
// of f16 pairs, one group in flight while the next is issued
__device__ __forceinline__ void wgmma256_f16(int (&d)[64], const unsigned (&a)[4],
                                             unsigned long long desc) {
#define D8(i)                                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.f16.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
#undef D8
}
template <int WGS>
__global__ void __launch_bounds__(128 * WGS, 1) wgmma_f16_probe(
    unsigned* out, unsigned long long* times, int iters) {
  __shared__ __align__(1024) uint4 b[256 * 64 / 16];
  const unsigned long long c0 = clock64(), g0 = globaltimer();
  for (int i = threadIdx.x; i < 256 * 64 / 16; i += blockDim.x)
    b[i] = make_uint4(0x38B83838u, 0xB83838B8u, 0x3838B8B8u, 0xB8B83838u);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(b));
  const unsigned long long desc =
      ((base & 0x3FFFF) >> 4) | (8ull << 16) | (32ull << 32);
  const unsigned a[4] = {0x38B83838u ^ ((threadIdx.x & 1) << 7), 0xB83838B8u,
                         0x3838B8B8u, 0xB8B83838u};
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    wgmma256_f16(acc, a, desc);
    wgmma256_f16(acc, a, desc + 16);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) cnt += acc[i];
  if (cnt == 0x12345678) out[0] = cnt;
  if (threadIdx.x == 0) {
    unsigned long long* tb = times + 4 * blockIdx.x;
    tb[0] = c0; tb[1] = clock64(); tb[2] = g0; tb[3] = globaltimer();
  }
}
// the bf16 wgmma with f32 sums (K1-mma's bf16 form): m64n128k16, +-1
// operands (0x3F80, 0xBF80) in the same layout, WGS warpgroups a block,
// one block an SM, each a chain of two products a group on its own 64
// f32 sums, one group in flight while the next is issued
__device__ __forceinline__ void wgmma128_bf16(float (&d)[64],
                                              const unsigned (&a)[4],
                                              unsigned long long desc) {
#define F8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
#undef F8
}
template <int WGS>
__global__ void __launch_bounds__(128 * WGS, 1) wgmma_bf16_probe(
    unsigned* out, unsigned long long* times, int iters) {
  __shared__ __align__(1024) uint4 b[256 * 64 / 16];
  const unsigned long long c0 = clock64(), g0 = globaltimer();
  for (int i = threadIdx.x; i < 256 * 64 / 16; i += blockDim.x)
    b[i] = make_uint4(0x3F80BF80u, 0xBF803F80u, 0x3F803F80u, 0xBF80BF80u);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(b));
  // K-major, no swizzle: LBO 128 bytes, SBO 512 (8 columns of 64 bytes)
  const unsigned long long desc =
      ((base & 0x3FFFF) >> 4) | (8ull << 16) | (32ull << 32);
  const unsigned a[4] = {0x3F80BF80u ^ ((threadIdx.x & 1) << 15),
                         0xBF803F80u, 0x3F803F80u, 0xBF80BF80u};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    wgmma128_bf16(acc, a, desc);
    wgmma128_bf16(acc, a, desc + 16);  // the next k16 step, 256 bytes on
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum += acc[i];
  if (sum == 1.2345f) out[0] = 1;
  if (threadIdx.x == 0) {
    unsigned long long* tb = times + 4 * blockIdx.x;
    tb[0] = c0; tb[1] = clock64(); tb[2] = g0; tb[3] = globaltimer();
  }
}
// K6's color-pair step (color_scores.cu): 3 subtracts, a multiply, 2
// FMAs and a min, on CHAINS independent minima a thread
__global__ void __launch_bounds__(256) k6_step_probe(
    unsigned* out, unsigned long long* times, int iters, unsigned d) {
  const unsigned long long c0 = clock64(), g0 = globaltimer();
  float a[CHAINS], m[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    a[j] = __uint_as_float(0x3f800000u | ((threadIdx.x * 977u + j) & 0xffffu));
    m[j] = 3.0e38f;
  }
  float hl = __uint_as_float(0x3f000000u | (d & 0xffffu));
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      const float dl = __fsub_rn(a[j], hl);
      const float du = __fsub_rn(a[j], m[j]);
      const float dv = __fsub_rn(hl, m[j]);
      m[j] = fminf(m[j], __fmaf_rn(dv, dv, __fmaf_rn(dl, dl,
                                                     __fmul_rn(du, du))));
    }
    hl = __fadd_rn(hl, 1.0f);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += m[j];
  if (s == 1.2345f) out[0] = 1;  // keeps the chains live
  if (threadIdx.x == 0) {
    unsigned long long* tb = times + 4 * blockIdx.x;
    tb[0] = c0; tb[1] = clock64(); tb[2] = g0; tb[3] = globaltimer();
  }
}
extern "C" int cbird_probe(int op, void* out, void* times, int blocks,
                           int iters, unsigned d, unsigned lim,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<unsigned*>(out);
  auto t = static_cast<unsigned long long*>(times);
  if (op == 0)
    probe<0><<<blocks, 256, 0, s>>>(o, t, iters, d, lim);
  else if (op == 1)
    probe<1><<<blocks, 256, 0, s>>>(o, t, iters, d, lim);
  else if (op == 2)
    probe<2><<<blocks, 256, 0, s>>>(o, t, iters, d, lim);
  else if (op == 3)
    imma_probe<<<blocks, 256, 0, s>>>(o, t, iters, d);
  else if (op == 4)
    imma_tile_probe<<<blocks, 256, 0, s>>>(o, t, iters, d);
  else if (op == 5)
    wgmma_probe<2, false><<<blocks, 256, 0, s>>>(o, t, iters);
  else if (op == 6)
    wgmma_probe<1, false><<<blocks, 128, 0, s>>>(o, t, iters);
  else if (op == 7)
    wgmma_probe<2, true><<<blocks, 256, 0, s>>>(o, t, iters);
  else if (op == 8)
    wgmma_f16_probe<2><<<blocks, 256, 0, s>>>(o, t, iters);
  else if (op == 10)
    wgmma_bf16_probe<2><<<blocks, 256, 0, s>>>(o, t, iters);
  else if (op == 11)
    wgmma_bf16_probe<3><<<blocks, 384, 0, s>>>(o, t, iters);
  else
    k6_step_probe<<<blocks, 256, 0, s>>>(o, t, iters, d);
  return (int)cudaGetLastError();
}
"""
CHAINS, THREADS = 8, 256
K6_STEP_OP = 9  # the probe of K6's color-pair step
K6_STEP_INSNS = 7  # its FP32 instructions a step
K6_FP32 = ("FADD", "FMUL", "FFMA", "FMNMX")
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
TARGET = re.compile(r"BRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def smi(query: str) -> str:
    """The first line nvidia-smi prints for ``query`` ("" if none)."""
    return (subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines() + [""])[0]


def sass_functions(text: str) -> dict[str, list[str]]:
    """cuobjdump -sass output -> {function name: its lines}."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name:
            out[name].append(line)
    return out


def loops(lines: list[str]) -> list[dict]:
    """Each backward branch's body (from its target to the branch): its
    length and opcode counts (the opcode before its first dot).  Targets
    are addresses (``BRA 0x990``) or labels (``BRA `(.L_x_3)``)."""
    insns, at = [], {}  # (address, opcode, line); target -> index
    for line in lines:
        m = LABEL.match(line)
        if m:
            at[m.group(1)] = len(insns)
        m = INSN.search(line)
        if m:
            at[hex(int(m.group(1), 16))] = len(insns)
            insns.append((m.group(2), line))
    out = []
    for k, (op, line) in enumerate(insns):
        t = TARGET.search(line)
        if not (op.startswith("BRA") and t):
            continue
        key = t.group(1)
        start = at.get(hex(int(key, 16)) if key.startswith("0x") else key)
        if start is not None and start < k:
            body = insns[start:k + 1]
            ops = collections.Counter(o.split(".")[0] for o, _ in body)
            out.append({"to": key, "instructions": len(body),
                        "opcodes": dict(ops.most_common())})
    return out


def k6_pair_loops(fn: str, lps: list[dict]) -> dict:
    """K6's loops of 100 or more instructions (a needle color against a
    row's 32 colors, and the needle loop around them): each one's FP32
    opcodes and its length, and ok when each holds an FFMA."""
    body = [lp for lp in lps if lp["instructions"] >= 100]
    rows = [{"instructions": lp["instructions"],
             "fp32": {o: lp["opcodes"].get(o, 0) for o in K6_FP32},
             "other": {o: c for o, c in lp["opcodes"].items()
                       if o not in K6_FP32}} for lp in body]
    return {"check": "K6 color-pair loops", "function": fn, "loops": rows,
            "ok": bool(rows) and all(r["fp32"]["FFMA"] > 0 for r in rows)}


def wgmma_main_loop(fn: str, lps: list[dict]) -> dict:
    """A tensor-core kernel's main loop (the loop with the most
    warpgroup MMAs, *GMMA: QGMMA for e4m3, IGMMA for s8): its opcode
    counts that matter, and ok when it holds a *GMMA and no mma.sync
    (IMMA, HMMA)."""
    def gmma(lp):
        return sum(c for o, c in lp["opcodes"].items() if o.endswith("GMMA"))
    body = max(lps, key=lambda lp: (gmma(lp), lp["instructions"]),
               default={"opcodes": {}, "instructions": 0})
    ops = body["opcodes"]
    picked = {o: c for o, c in ops.items() if o.endswith("GMMA") or o in (
        "IMMA", "HMMA", "MOV", "IMAD", "SHF", "LEA", "HADD2", "HMNMX2",
        "HSETP2", "VOTE", "SYNCS", "BAR", "WARPGROUP", "LDS", "STS")}
    return {"check": "wgmma main loop", "function": fn,
            "masked": "ILb1E" in fn, "instructions": body["instructions"],
            "opcodes": picked,
            "ok": gmma(body) > 0 and "IMMA" not in ops and "HMMA" not in ops}


class Clock:
    """nvidia-smi clocks.sm, power.draw and the active clock event reasons
    sampled in a thread while inside."""

    def __enter__(self):
        self.mhz, self.watts, self.reasons = [], [], set()
        self.stop = threading.Event()

        def poll():
            fields = "clocks.sm,power.draw,clocks_event_reasons.active"
            while not self.stop.is_set():
                row = smi(fields).split(",")
                try:
                    self.mhz.append(float(row[0].split()[0]))
                except ValueError:  # a field this nvidia-smi does not know
                    if fields == "clocks.sm":
                        return
                    fields = "clocks.sm"
                    continue
                if len(row) == 3:
                    self.watts.append(float(row[1].split()[0]))
                    self.reasons.add(row[2].strip())
        self.th = threading.Thread(target=poll, daemon=True)
        self.th.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.th.join()

    def summary(self) -> dict:
        a = np.array(self.mhz or [np.nan])
        w = np.array(self.watts or [np.nan])
        return {"samples": len(self.mhz), "min_mhz": float(a.min()),
                "median_mhz": float(np.median(a)), "max_mhz": float(a.max()),
                "max_watts": float(w.max()),
                "event_reasons": sorted(self.reasons)}


def build_probes(out_dir: str) -> str:
    """Compile PROBE_SRC with the package's nvcc flags into ``out_dir``.
    @return the library path"""
    from cbird_tpu_torch import _build
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    so = os.path.join(out_dir, "libprobe.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the probes:\n{proc.stderr}")
    return so


class Probes:
    """The probe kernels on the current CUDA device, 8 blocks per SM."""

    def __init__(self, torch, so: str):
        self.torch = torch
        self.lib = ctypes.CDLL(so)
        self.lib.cbird_probe.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.blocks = 8 * self.sms
        self.buf = torch.zeros(1, dtype=torch.int32, device="cuda")
        self.times = torch.zeros(4 * self.blocks, dtype=torch.int64,
                                 device="cuda")

    def run(self, op: int, iters: int, blocks: int | None = None) -> None:
        self.ran_blocks = blocks or self.blocks
        err = self.lib.cbird_probe(
            op, self.buf.data_ptr(), self.times.data_ptr(), self.ran_blocks,
            iters, 0x9E3779B9, 0x6A09E667,
            self.torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe {op}: CUDA error {err}")

    def clock64_mhz(self) -> dict:
        """The SM clock of the last launch: its blocks' clock64 cycles over
        globaltimer ns (the timer CUDA events read)."""
        tb = self.times.view(-1, 4)[:self.ran_blocks].cpu().numpy().astype(
            np.float64)
        mhz = (tb[:, 1] - tb[:, 0]) / (tb[:, 3] - tb[:, 2]) * 1e3
        return {"min": float(mhz.min()), "median": float(np.median(mhz)),
                "max": float(mhz.max())}

    def sm_clock_mhz(self, iters: int = 1 << 17) -> float:
        """The SM clock now: the median block of a short (~70 ms) run of
        K1's xor-POPC-add pattern."""
        self.run(2, iters)
        return self.clock64_mhz()["median"]


def timed_ms(torch, fn, reps: int) -> tuple[float, dict]:
    """Mean CUDA-event ms of ``reps`` calls after a warm-up, and the SM
    clock while they ran."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    with Clock() as clk:  # the launches are queued: sample while they run
        torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, clk.summary()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_bounds: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from cbird_tpu_torch import _build
    from cbird_tpu_torch.ops import count_below as cb
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        here, "build", "bounds")
    os.makedirs(out_dir, exist_ok=True)
    print(smi("name,power.limit"), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    print(json.dumps({"sms": sms, "clocks_max_sm_mhz": max_mhz}), flush=True)

    so = build_probes(out_dir)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = {}
    kernels = ("count_below", "count_below_mma", "hamming_topk", "band_count",
               "hamming_lanes_topk", "color_scores")
    for name, path in [(k, _build.build(k)) for k in kernels] + [("probe",
                                                                  so)]:
        text = subprocess.run([cuobjdump, "-sass", path], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
            f.write(text)
        for fn, lines in sass_functions(text).items():
            sass[fn] = loops(lines)
            print(json.dumps({"sass": fn, "loops": sass[fn]}), flush=True)
    ok = True
    for fn, lps in sass.items():
        if "wgmma_count_kernel" in fn or "lanes_wgmma" in fn:
            row = wgmma_main_loop(fn, lps)
            ok &= row["ok"]
            print(json.dumps(row), flush=True)
        if "score_kernel" in fn:
            row = k6_pair_loops(fn, lps)
            ok &= row["ok"]
            print(json.dumps(row), flush=True)

    pr = Probes(torch, so)
    iters = 1 << 19
    for op, name in ((0, "popc_chained"), (1, "compare_add"),
                     (2, "xor_popc_add"), (3, "imma_chained"),
                     (4, "imma_tiles")):
        if op >= 3:
            iters = 1 << 15  # a warp's mma takes a few clocks of the SM
        ms, clk = timed_ms(torch, lambda: pr.run(op, iters), 5)
        clk["clock64_mhz"] = pr.clock64_mhz()
        steps = pr.blocks * THREADS * CHAINS * iters
        fn = next(f for f in sass if (
            f"probeILi{op}E" in f and "wgmma" not in f if op < 3
            else ("imma_probe" if op == 3 else "imma_tile_probe") in f))
        body = max(sass[fn], key=lambda lp: lp["instructions"],
                   default={"opcodes": {}})
        # instructions a step: the loop body's, over its CHAINS steps
        per_step = {o: c / CHAINS for o, c in body["opcodes"].items()}
        row = {"probe": name, "ms": ms, "clock": clk,
               "opcodes_per_step": per_step}
        for o in ("POPC", "ISETP", "IADD3", "IMAD", "SEL", "LOP3", "VIADD",
                  "IMMA"):
            if o in per_step:
                # a warp issues one IMMA for its 32 threads
                rate = steps * per_step[o] / (ms * 1e-3 * sms) / (
                    32 if o == "IMMA" else 1)
                row[f"{o}_per_clk_sm_at_max"] = rate / (max_mhz * 1e6)
                row[f"{o}_per_clk_sm_at_clock64"] = rate / (
                    clk["clock64_mhz"]["median"] * 1e6)
        if "IMMA" in per_step:  # 16 x 8 x 32 multiply-adds each
            row["int8_tops"] = (steps / 32 * per_step["IMMA"] * 8192
                                / (ms * 1e-3) / 1e12)
        print(json.dumps(row), flush=True)

    # the int8 wgmma, one block an SM: IGMMA a clock per SM (each
    # m64n256k32: 64 x 256 x 32 multiply-adds), and the loop's opcodes
    for op, name, wgs in ((5, "wgmma_chained_2wg", 2),
                          (6, "wgmma_chained_1wg", 1),
                          (7, "wgmma_sign_epilogue_2wg", 2)):
        iters = 1 << 13
        ms, clk = timed_ms(torch, lambda: pr.run(op, iters, sms), 5)
        clk["clock64_mhz"] = pr.clock64_mhz()
        n = sms * wgs * iters * 2
        fn = next(f for f in sass if "wgmma_probe" in f and (
            f"ILi{wgs}ELb{int(op == 7)}E" in f))
        body = max(sass[fn], key=lambda lp: lp["instructions"],
                   default={"opcodes": {}})
        print(json.dumps({
            "probe": name, "ms": ms, "clock": clk,
            "IGMMA_per_clk_sm_at_max": n / (ms * 1e-3 * sms * max_mhz * 1e6),
            "IGMMA_per_clk_sm_at_clock64": n / (
                ms * 1e-3 * sms * clk["clock64_mhz"]["median"] * 1e6),
            "int8_tops": n * 64 * 256 * 32 * 2 / (ms * 1e-3) / 1e12,
            "loop_opcodes": body["opcodes"]}), flush=True)
    # the e4m3 wgmma with f16 sums on two warpgroups (K5's and K1-mma's
    # products): QGMMA a clock per SM, and its TOPS against the table's
    # 1979 for fp8
    iters = 1 << 13
    ms, clk = timed_ms(torch, lambda: pr.run(8, iters, sms), 5)
    clk["clock64_mhz"] = pr.clock64_mhz()
    n = sms * 2 * iters * 2
    fn = next(f for f in sass if "wgmma_f16_probe" in f)
    body = max(sass[fn], key=lambda lp: lp["instructions"],
               default={"opcodes": {}})
    print(json.dumps({
        "probe": "wgmma_e4m3_f16_chained_2wg", "ms": ms, "clock": clk,
        "QGMMA_per_clk_sm_at_max": n / (ms * 1e-3 * sms * max_mhz * 1e6),
        "QGMMA_per_clk_sm_at_clock64": n / (
            ms * 1e-3 * sms * clk["clock64_mhz"]["median"] * 1e6),
        "e4m3_f16_tops": n * 64 * 256 * 32 * 2 / (ms * 1e-3) / 1e12,
        "loop_opcodes": body["opcodes"]}), flush=True)

    # the bf16 wgmma with f32 sums on two and three warpgroups (K1-mma's
    # bf16 form): HGMMA a clock per SM, and its TFLOPS against the
    # table's 989 for bf16
    for op, wgs in ((10, 2), (11, 3)):
        iters = 1 << 13
        ms, clk = timed_ms(torch, lambda: pr.run(op, iters, sms), 5)
        clk["clock64_mhz"] = pr.clock64_mhz()
        n = sms * wgs * iters * 2
        fn = next(f for f in sass if "wgmma_bf16_probe" in f
                  and f"ILi{wgs}EE" in f)
        body = max(sass[fn], key=lambda lp: lp["instructions"],
                   default={"opcodes": {}})
        print(json.dumps({
            "probe": f"wgmma_bf16_f32_m64n128k16_chained_{wgs}wg", "ms": ms,
            "clock": clk,
            "HGMMA_per_clk_sm_at_max": n / (ms * 1e-3 * sms * max_mhz * 1e6),
            "HGMMA_per_clk_sm_at_clock64": n / (
                ms * 1e-3 * sms * clk["clock64_mhz"]["median"] * 1e6),
            "bf16_tflops": n * 64 * 128 * 16 * 2 / (ms * 1e-3) / 1e12,
            "loop_opcodes": body["opcodes"]}), flush=True)

    # K6's color-pair step (FP32 subtracts, a multiply, FMAs and a min):
    # the FP32 instructions it sustains a clock per SM, and the loop's
    # opcodes (chip_smoke.py prints it beside K6's bound, which takes the
    # peak of 128)
    iters = 1 << 16
    ms, clk = timed_ms(torch, lambda: pr.run(K6_STEP_OP, iters), 5)
    clk["clock64_mhz"] = pr.clock64_mhz()
    steps = pr.blocks * THREADS * CHAINS * iters
    fn = next(f for f in sass if "k6_step_probe" in f)
    body = max(sass[fn], key=lambda lp: lp["instructions"],
               default={"opcodes": {}})
    print(json.dumps({
        "probe": "k6_color_pair_step", "ms": ms, "clock": clk,
        "fp32_per_clk_sm_at_max": K6_STEP_INSNS * steps / (
            ms * 1e-3 * sms * max_mhz * 1e6),
        "fp32_per_clk_sm_at_clock64": K6_STEP_INSNS * steps / (
            ms * 1e-3 * sms * clk["clock64_mhz"]["median"] * 1e6),
        "loop_opcodes": body["opcodes"]}), flush=True)

    # the popcount K1 at the K1 variants' shape, on operands made as
    # chip_smoke's timing operands are: 20 launches after 20 of each form
    # of K1-mma (as chip_smoke times them), then 100 alone; after each, a
    # short probe reads the SM clock
    from chip_smoke import Smoke
    from cbird_tpu_torch.ops import count_below_mma as cm
    rng = np.random.default_rng(20261016)
    q, n = 16384, 1 << 21
    h64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    hay = torch.from_numpy(h64.view(np.int64)).cuda()
    vd = torch.from_numpy(rng.random(n) > 0.01).cuda()
    nd = torch.from_numpy(Smoke.flip_bits(
        h64[rng.integers(0, n, q)], rng.integers(0, 8, q), rng)
        .view(np.int64)).cuda()
    pairs = q * n
    for reps, mma_first in ((20, True), (100, False), (20, True)):
        if mma_first:
            for bf16 in (False, True):
                timed_ms(torch, lambda: cm.count_below_mma(nd, hay, vd, 5,
                                                           bf16=bf16), 20)
        ms, clk = timed_ms(torch, lambda: cb.count_below(nd, hay, vd, 5),
                           reps)
        pr.run(2, 1 << 15)
        clk["clock64_mhz_after"] = pr.clock64_mhz()
        print(json.dumps({
            "K1": f"Q={q} N=2^21 t=5", "launches": reps,
            "after_K1_mma": mma_first, "ms": ms, "clock": clk,
            "popc_per_clk_sm_at_max": 2 * pairs / (ms * 1e-3 * sms
                                                   * max_mhz * 1e6),
            "popc_per_clk_sm_at_clock64": 2 * pairs / (
                ms * 1e-3 * sms * clk["clock64_mhz_after"]["median"] * 1e6)}),
            flush=True)
    if not ok:
        print("chip_bounds: a wgmma kernel's main loop holds no warpgroup MMA "
              "or an mma.sync, or a K6 color-pair loop no FFMA",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
