// KV prefix index — native core of the smart router.
//
// Reference parity: lib/llm/src/kv_router/indexer.rs:187-499 (RadixTree,
// find_matches, apply_event).  The reference keeps an explicit radix tree;
// because our block hashes are *chained* (a hash commits to its whole
// prefix, dynamo_tpu_torch/tokens.py), a flat hash -> holders map yields
// identical longest-prefix-match semantics with O(1) probes per block.
//
// Concurrency contract matches the reference (indexer.rs:36): single writer.
// A shared_mutex lets concurrent find_matches readers coexist with the one
// event-applying writer.

#include "dynamo_native.h"

#include <algorithm>
#include <mutex>
#include <shared_mutex>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// Holder sets are tiny (few workers replicate a block); a sorted small
// vector beats unordered_set on cache behavior and memory.
using WorkerVec = std::vector<uint64_t>;

inline bool vec_insert(WorkerVec &v, uint64_t w) {
  auto it = std::lower_bound(v.begin(), v.end(), w);
  if (it != v.end() && *it == w) return false;
  v.insert(it, w);
  return true;
}

inline bool vec_erase(WorkerVec &v, uint64_t w) {
  auto it = std::lower_bound(v.begin(), v.end(), w);
  if (it == v.end() || *it != w) return false;
  v.erase(it);
  return true;
}

inline bool vec_contains(const WorkerVec &v, uint64_t w) {
  return std::binary_search(v.begin(), v.end(), w);
}

}  // namespace

struct dyn_index {
  std::unordered_map<uint64_t, WorkerVec> holders;  // block hash -> workers
  std::unordered_map<uint64_t, std::unordered_set<uint64_t>> worker_blocks;
  mutable std::shared_mutex mu;
};

extern "C" {

dyn_index *dyn_index_new(void) { return new dyn_index(); }

void dyn_index_free(dyn_index *idx) { delete idx; }

void dyn_index_store(dyn_index *idx, uint64_t worker, const uint64_t *hashes,
                     size_t n) {
  std::unique_lock lock(idx->mu);
  auto &blocks = idx->worker_blocks[worker];
  for (size_t i = 0; i < n; ++i) {
    vec_insert(idx->holders[hashes[i]], worker);
    blocks.insert(hashes[i]);
  }
}

void dyn_index_remove(dyn_index *idx, uint64_t worker, const uint64_t *hashes,
                      size_t n) {
  std::unique_lock lock(idx->mu);
  auto wb = idx->worker_blocks.find(worker);
  for (size_t i = 0; i < n; ++i) {
    auto it = idx->holders.find(hashes[i]);
    if (it != idx->holders.end()) {
      vec_erase(it->second, worker);
      if (it->second.empty()) idx->holders.erase(it);
    }
    if (wb != idx->worker_blocks.end()) wb->second.erase(hashes[i]);
  }
}

void dyn_index_remove_worker(dyn_index *idx, uint64_t worker) {
  std::unique_lock lock(idx->mu);
  auto wb = idx->worker_blocks.find(worker);
  if (wb == idx->worker_blocks.end()) return;
  for (uint64_t h : wb->second) {
    auto it = idx->holders.find(h);
    if (it != idx->holders.end()) {
      vec_erase(it->second, worker);
      if (it->second.empty()) idx->holders.erase(it);
    }
  }
  idx->worker_blocks.erase(wb);
}

void dyn_index_clear(dyn_index *idx) {
  std::unique_lock lock(idx->mu);
  idx->holders.clear();
  idx->worker_blocks.clear();
}

uint64_t dyn_index_num_blocks(const dyn_index *idx) {
  std::shared_lock lock(idx->mu);
  return idx->holders.size();
}

uint64_t dyn_index_num_workers(const dyn_index *idx) {
  std::shared_lock lock(idx->mu);
  return idx->worker_blocks.size();
}

uint64_t dyn_index_num_worker_blocks(const dyn_index *idx, uint64_t worker) {
  std::shared_lock lock(idx->mu);
  auto wb = idx->worker_blocks.find(worker);
  return wb == idx->worker_blocks.end() ? 0 : wb->second.size();
}

size_t dyn_index_find_matches(const dyn_index *idx, const uint64_t *hashes,
                              size_t n, uint64_t *out_workers,
                              uint32_t *out_scores, size_t cap) {
  std::shared_lock lock(idx->mu);
  // `live` = workers that matched every block so far; workers that drop out
  // keep the score they had (longest prefix resident on that worker).
  WorkerVec live;
  std::vector<std::pair<uint64_t, uint32_t>> scores;  // small: one per worker
  for (size_t i = 0; i < n; ++i) {
    auto it = idx->holders.find(hashes[i]);
    if (it == idx->holders.end() || it->second.empty()) break;
    const WorkerVec &holders = it->second;
    if (i == 0) {
      live = holders;
    } else {
      WorkerVec next;
      next.reserve(live.size());
      std::set_intersection(live.begin(), live.end(), holders.begin(),
                            holders.end(), std::back_inserter(next));
      live.swap(next);
    }
    if (live.empty()) break;
    for (uint64_t w : live) {
      auto sit = std::find_if(scores.begin(), scores.end(),
                              [w](const auto &p) { return p.first == w; });
      if (sit == scores.end())
        scores.emplace_back(w, (uint32_t)(i + 1));
      else
        sit->second = (uint32_t)(i + 1);
    }
  }
  size_t written = std::min(cap, scores.size());
  for (size_t i = 0; i < written; ++i) {
    out_workers[i] = scores[i].first;
    out_scores[i] = scores[i].second;
  }
  return scores.size();
}

}  // extern "C"
