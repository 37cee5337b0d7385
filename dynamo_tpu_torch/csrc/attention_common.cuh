// Helpers shared by the paged decode and prefill attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dynamo {

// Paged-cache address of (layer, block id, k or v, in-block offset, kv head)
// in the cache [L, N, 2, Bs, Hk*D] (bf16, or the int8 payload of an int8
// cache): one KV head's row is D contiguous values.
template <class E>
__device__ inline const E* cache_row(const E* cache, int layer, int num_blocks, int block_size, int hkd,
                                     int bid, int kv, int off, int head, int d) {
  const size_t blk = ((size_t)layer * num_blocks + bid) * 2 + kv;
  return cache + (blk * block_size + off) * hkd + (size_t)head * d;
}

// Scale of (layer, block id, k or v, kv head, in-block offset) in an int8
// cache's scale pool [L, N, 2, Hp, Sp]: token-minor tiles padded to
// (Hp, Sp); only the [:Hk, :Bs] region is ever read.
__device__ inline float cache_scale(const float* scale, int layer, int num_blocks, int hp, int sp, int bid,
                                    int kv, int head, int off) {
  const size_t tile = ((size_t)layer * num_blocks + bid) * 2 + kv;
  return __ldg(scale + (tile * hp + head) * sp + off);
}

__device__ inline uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Values 8 * part .. 8 * part + 7 of a cache row as 8 bf16 (16 bytes): a
// bf16 row is read as it is; an int8 row is read as 8 bytes and converted,
// which is exact since |v| <= 127 fits bf16's 8-bit significand.
__device__ inline uint4 load8_bf16(const __nv_bfloat16* row, int part) {
  return __ldg(reinterpret_cast<const uint4*>(row) + part);
}

__device__ inline uint4 load8_bf16(const int8_t* row, int part) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row) + part);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = pack_bf16(__float2bfloat16((float)b[2 * i]), __float2bfloat16((float)b[2 * i + 1]));
  return out;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace dynamo
