// Batched KV block gather/scatter over host memory.
//
// Reference parity: lib/llm/src/kernels/block_copy.cu (batched gather/scatter
// of KV blocks between device and host tiers).  The device side is the
// port's block gather/scatter over the paged cache; the *host* side —
// writing offloaded blocks into the host pool's rows and gathering rows out
// of it into contiguous host tensors — is this code.  Multi-threaded memcpy
// saturates host memory bandwidth for multi-MB transfers.

#include "dynamo_native.h"

#include <cstring>
#include <thread>
#include <vector>

namespace {

// Below this total size, thread spawn overhead exceeds the win.
constexpr uint64_t kParallelThreshold = 4ull << 20;  // 4 MiB

int resolve_threads(int threads, uint64_t total_bytes, size_t n_blocks) {
  if (total_bytes < kParallelThreshold || n_blocks < 2) return 1;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int max_threads = (int)std::min<uint64_t>(hw, n_blocks);
  if (threads <= 0) return std::min(max_threads, 8);
  return std::min(threads, max_threads);
}

template <bool kGather>
void copy_blocks(uint8_t *a, const uint8_t *b, uint64_t block_bytes,
                 const int64_t *ids, size_t n, int threads) {
  // gather: a=dst contiguous, b=src pool;  scatter: a=dst pool, b=src contig.
  auto run = [=](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      if (kGather)
        std::memcpy(a + i * block_bytes, b + (uint64_t)ids[i] * block_bytes,
                    block_bytes);
      else
        std::memcpy(a + (uint64_t)ids[i] * block_bytes, b + i * block_bytes,
                    block_bytes);
    }
  };
  int nt = resolve_threads(threads, block_bytes * n, n);
  if (nt <= 1) {
    run(0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  size_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    size_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(run, lo, hi);
  }
  for (auto &th : pool) th.join();
}

}  // namespace

extern "C" {

void dyn_blocks_gather(const uint8_t *src, uint64_t block_bytes,
                       const int64_t *ids, size_t n, uint8_t *dst,
                       int threads) {
  copy_blocks<true>(dst, src, block_bytes, ids, n, threads);
}

void dyn_blocks_scatter(uint8_t *dst, uint64_t block_bytes, const int64_t *ids,
                        size_t n, const uint8_t *src, int threads) {
  copy_blocks<false>(dst, src, block_bytes, ids, n, threads);
}

}  // extern "C"
