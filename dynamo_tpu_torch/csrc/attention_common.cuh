// Helpers shared by the paged decode and prefill attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dynamo {

// Paged-cache address of (layer, block id, k or v, in-block offset, kv head)
// in the cache [L, N, 2, Bs, Hk*D]: one KV head's row is D contiguous values.
__device__ inline const __nv_bfloat16* cache_row(const __nv_bfloat16* cache, int layer, int num_blocks,
                                                 int block_size, int hkd, int bid, int kv, int off,
                                                 int head, int d) {
  const size_t blk = ((size_t)layer * num_blocks + bid) * 2 + kv;
  return cache + (blk * block_size + off) * hkd + (size_t)head * d;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace dynamo
