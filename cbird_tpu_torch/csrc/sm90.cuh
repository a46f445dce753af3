// PTX helpers for Hopper (sm_90a) shared by the warp-specialised
// tensor-core kernels (count_below_mma.cu: K1-mma / K2-mma, both operand
// types; hamming_lanes_topk.cu: K5): mbarriers, bulk asynchronous copies,
// shared-memory stores and loads by address, the +-1 unpacks of a hash,
// the K-major no-swizzle B descriptor, the wgmma products and their fence,
// commit and wait.  The library's build hashes this header with each
// source that includes it (_build.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// waits for the phase of the given parity; a wait of 2^34 clocks (~8 s)
// means a broken ring, and traps rather than holding the card
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared-memory stores and loads by address: the rings' buffers are
// reached through computed addresses, and generic ones would cost a check
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t x, uint32_t y,
                                       uint32_t z, uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(x), "r"(y), "r"(z), "r"(w) : "memory");
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ unsigned long long lds64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared.b64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t lds8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// word w (0..15) of a 64-bit word's +-1 vector in e4m3: byte b is +1
// (0x38) for a clear bit, -1 (0xB8) for a set one, of bit 32 * (w >> 3) +
// 8 * b + (w & 7).  A and B use the same order of the lanes, so the dot
// does not depend on it; this one takes three instructions a word and no
// table.
__device__ __forceinline__ uint32_t pm1_word(unsigned long long h, int w) {
  const uint32_t x = static_cast<uint32_t>(h >> (32 * (w >> 3))) >> (w & 7);
  return (x & 0x01010101u) * 0x80u + 0x38383838u;
}

// word w (0..31) of a 64-bit word's +-1 vector in bf16: each half is +1
// (0x3F80) for a clear bit, -1 (0xBF80) for a set one; the sign bits are
// bits 15 and 31 of the half-word (w >> 4) shifted left by w & 15, that is
// its bits 15 - (w & 15) and 31 - (w & 15): every bit once over w.  Two
// instructions a word (a shift and a LOP3).
__device__ __forceinline__ uint32_t pm1_bf16(unsigned long long h, int w) {
  const uint32_t x = static_cast<uint32_t>(h >> (32 * (w >> 4))) << (w & 15);
  return (x & 0x80008000u) | 0x3F803F80u;
}

// B descriptor (K-major, no swizzle): core matrices of 8 columns x 16
// bytes; the next 16 bytes of k (LBO) lbo bytes on, the next 8 columns
// (SBO) sbo bytes on
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

#define D8(i)                                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define F8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS32                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define REGS64                                                              \
  REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"

// d (+)= A (64 x 32 e4m3, registers) x B (32 x 256 e4m3, shared memory),
// f16 sums two a register; d is zeroed first where SCALE_D is 0
template <int SCALE_D>
__device__ __forceinline__ void mma_e4m3(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.f16.e4m3.e4m3 {" REGS64 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}

// d (+)= A (64 x 16 bf16, registers) x B (16 x 128 bf16, shared memory,
// K-major), f32 sums; d is zeroed first where SCALE_D is 0
template <int SCALE_D>
__device__ __forceinline__ void mma_bf16(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}

// the same with B 16 x 256: 128 f32 sums a thread
template <int SCALE_D>
__device__ __forceinline__ void mma_bf16(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" REGS64 ", "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
        F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}
#undef D8
#undef F8
#undef REGS64
#undef REGS32

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}
// the sums are read only after the wait: keep the compiler from moving
// their reads above it
template <int N>
__device__ __forceinline__ void acc_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace
