// Hopper (sm_90a) building blocks written as inline PTX, shared by the
// W8A16 matmul (int8_matmul.cu), the paged and ragged prefill attention
// (wgmma_attention.cuh), the decode attention (decode_attention.cu) and
// the grouped expert matmul (grouped_matmul.cu):
// 16- and 4-byte cp.async with zero fill, TMA tile loads, mbarriers,
// the async-proxy fence, named barriers, shared-memory matrix descriptors
// for the 128-byte swizzled layouts, the exact int8 -> bf16 and int8 -> fp16
// converts, the warp-level mma.sync m16n8k16, and wgmma.mma_async (f32
// accumulate) for the tile widths the kernels use.  The products take bf16
// or fp16 operands, chosen by a type tag (Wgmma's T, mma_16816's T): both
// are 2-byte types, so descriptors, swizzles and fragments are the same.
// Plain PTX instead of CuTe keeps the build to seconds.
//
// Shared-memory layout contract (128-byte swizzle, "SW128").  A tile is
// stored as 1024-byte atoms of 8 rows x 128 bytes (64 bf16).  Inside an
// atom the 16-byte chunk c of row r lies at r * 128 + ((c ^ r) * 16): the
// hardware applies the same XOR to address bits [4, 7) from bits [7, 10),
// so every atom must start on a 1024-byte boundary.
//   K-major operand (the contracted axis contiguous, e.g. x rows, K rows):
//     rows of the M or N axis at 128 bytes, 8-row groups at SBO = 1024;
//     a 16-deep k step advances the start address by 32 bytes.
//   MN-major operand (the M or N axis contiguous, e.g. V, a [K, N] weight):
//     rows of the K axis at 128 bytes holding 64 consecutive N values,
//     8-deep k groups at SBO, 64-wide N blocks at LBO.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dynamo {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; only the first `src_bytes` (0 or 16) are
// read, the rest of the 16 is written as zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
// 4-byte global -> shared copy (an f32 scale); src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Arrive on `bar` once every cp.async this thread has issued so far has
// landed (the arrival is counted against the barrier's expected count).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// TMA: the box of tensor map `map` at element coordinates (c0, c1[, c2]),
// innermost first, into shared memory at `dst`, completing its bytes on
// `bar`'s transaction count.  Coordinates past the tensor read as zeros.
// `map` is the generic address of a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Move registers between warpgroups: a producer gives up, consumers take.
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operand reads).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive on `bar` and raise the bytes its current phase waits for by
// `bytes` (the TMA loads that complete on it).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// Two floats rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two int8 values, at bits [0, 8) and [16, 24) of t (other bits ignored),
// as bf16x2, exactly and without a float convert: 0x4300 | (v & 127) is the
// bf16 128 + (v & 127); subtracting 128 (v >= 0) or 256 (v < 0, whose low
// seven bits are v + 128) leaves v.  Four integer/bf16 operations per pair
// instead of two I2F and a pack, which the conversion units run at a
// fraction of the rate.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t t) {
  const uint32_t mag = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t off = (t & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag), *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The same as fp16x2, exactly: 0x6400 | u is the fp16 1024 + u for u < 1024,
// and u = v + 128 is v's byte with its sign bit flipped; subtracting 1152
// (0x6480) leaves v.  (bf16's trick above needs bf16's 8-bit exponent.)
__device__ __forceinline__ uint32_t i8x2_to_f16x2(uint32_t t) {
  const uint32_t biased = ((t & 0x00ff00ffu) ^ 0x00800080u) | 0x64006400u;
  const uint32_t off = 0x64806480u;
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&biased), *reinterpret_cast<const __half2*>(&off));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Two floats rounded to fp16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 2-byte operand type T's versions of the above: T is __nv_bfloat16
// or __half.
template <class T>
__device__ __forceinline__ uint32_t i8x2_to_x2(uint32_t t) {
  if constexpr (std::is_same<T, __half>::value)
    return i8x2_to_f16x2(t);
  else
    return i8x2_to_bf16x2(t);
}
template <class T>
__device__ __forceinline__ uint32_t pack_x2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value)
    return pack_f16x2(lo, hi);
  else
    return pack_bf16x2(lo, hi);
}
// One float rounded to T.
template <class T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(x);
  else
    return __float2bfloat16(x);
}

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// C[16 x 8] += A[16 x 16] B[16 x 8] on one warp's tensor cores (mma.sync
// m16n8k16, T = bf16 or fp16 in, f32 accumulate), fragments in registers.
template <class T = __nv_bfloat16>
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                          uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R, int C>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N], T in (bf16 or fp16), f32
// accumulate, one warpgroup.  SS: A and B by descriptor; RS: A from registers (the
// m16n8k16 A fragment of each warp's 16 rows).  TB = 1 reads B MN-major;
// TA = 1 reads an SS A operand MN-major (M contiguous), else K-major.
// scale_d = 0 overwrites D.  Accumulator register i holds row
// 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
template <int N, int TB, int TA = 0, class T = __nv_bfloat16>
struct Wgmma;

#define DYN_WGMMA_T __nv_bfloat16
#define DYN_WGMMA_AB ".bf16.bf16"
#include "wgmma_ops.cuh"
#undef DYN_WGMMA_AB
#undef DYN_WGMMA_T
#define DYN_WGMMA_T __half
#define DYN_WGMMA_AB ".f16.f16"
#include "wgmma_ops.cuh"
#undef DYN_WGMMA_AB
#undef DYN_WGMMA_T

}  // namespace hopper
}  // namespace dynamo
