// Hopper (sm_90a) building blocks for the attention kernels, in raw PTX:
// mbarriers, TMA tile loads and bulk copies, shared-memory matrix descriptors and the
// warpgroup matrix multiply (wgmma) with fp32 register accumulators.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a tile
// of R rows by 64 16-bit (bf16 or fp16) columns is R rows of 128 bytes, each 8-row group a
// 1024-byte swizzle atom. A 128-column tile is two such 64-column tiles one
// after the other (the swizzle's box is at most 128 bytes wide).
//
// Fragment layouts (PTX ISA, "wgmma .m64nNk16"): thread t of a warpgroup
// (warp w = t / 32, lane l) holds accumulator element d[4 j + e] at row
// 16 w + l / 4 + 8 (e / 2) and column 8 j + 2 (l % 4) + (e % 2). A register
// A operand of one k16 step takes the same rows and the columns of two
// consecutive 8-column chunks, as four bf16 or fp16 pairs.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and announce `bytes` of TMA traffic that completes this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------------

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes of global memory into shared memory (both
// 16-byte aligned, `bytes` a multiple of 16); completion is counted on
// `bar` in bytes, as a TMA box's.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- register budget of warp-specialised roles --------------------------------

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- shared-memory matrix descriptors (128-byte swizzle) ----------------------

// `lbo` and `sbo` in bytes. K-major operands (the reduction dim contiguous)
// use only sbo = 1024, the stride of 8-row groups; MN-major operands use
// lbo = the stride of 64-column tiles along N and sbo = 1024, the stride
// of 8-row groups along K.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

// ---- wgmma ---------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Whether a 16-bit element type is fp16 (else bf16): the wgmma input type
// and the pair packing follow it; the operand and fragment layouts are
// the same for both.
template <class E>
inline constexpr bool kF16 = std::is_same<E, __half>::value;

// Two floats as one pair of E (lo in the low half), rounded to nearest, as
// a register A operand takes them.
template <class E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kF16<E>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Keep the accumulator's registers from being touched across an
// asynchronous wgmma (the compiler does not know they are in flight).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The wgmma instructions, one per shape, with the input type TY ("bf16"
// or "f16") spliced into the opcode.
#define HOPPER_SS32(TY)                                               \
  asm volatile(                                                       \
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"                  \
      " wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"   \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                              \
      "%8, %9, %10, %11, %12, %13, %14, %15"                          \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),               \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),               \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])              \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOPPER_SS64(TY)                                               \
  asm volatile(                                                       \
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                  \
      " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"   \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                              \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                        \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                      \
      "%24, %25, %26, %27, %28, %29, %30, %31"                        \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),               \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),               \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),             \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),             \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),             \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])              \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOPPER_RS64(TY)                                                 \
  asm volatile(                                                         \
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                    \
      " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"     \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                          \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                        \
      "%24, %25, %26, %27, %28, %29, %30, %31"                          \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define HOPPER_SS128(TY)                                               \
  asm volatile(                                                        \
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"                   \
      " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"   \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                       \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                       \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                       \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                       \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                       \
      "%56, %57, %58, %59, %60, %61, %62, %63"                         \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),              \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),              \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),              \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),              \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),              \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),              \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),              \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),              \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),              \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),              \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
      : "l"(da), "l"(db), "r"(scale_d))

#define HOPPER_RS128(TY)                                                \
  asm volatile(                                                         \
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"                    \
      " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"    \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                          \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                        \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                        \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                        \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                        \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                        \
      "%56, %57, %58, %59, %60, %61, %62, %63"                          \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),               \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),               \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),               \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),               \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),               \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),               \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),               \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),               \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// D[64 x N] (+)= A[64 x 16] . B[16 x N] in fp32, inputs of type E (bf16 or
// fp16), A and B from shared memory, both K-major (wgmma_ss, N = 32, 64 or
// 128) or A from registers and B MN-major (wgmma_rs, N = 64 or 128).
// scale_d = 0 overwrites D.
template <int N, class E>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N = 32, 64 or 128");
  if constexpr (N == 32) {
    if constexpr (kF16<E>) HOPPER_SS32("f16"); else HOPPER_SS32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (kF16<E>) HOPPER_SS64("f16"); else HOPPER_SS64("bf16");
  } else {
    if constexpr (kF16<E>) HOPPER_SS128("f16"); else HOPPER_SS128("bf16");
  }
}

template <int N, class E>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N = 64 or 128");
  if constexpr (N == 64) {
    if constexpr (kF16<E>) HOPPER_RS64("f16"); else HOPPER_RS64("bf16");
  } else {
    if constexpr (kF16<E>) HOPPER_RS128("f16"); else HOPPER_RS128("bf16");
  }
}

}  // namespace hopper
