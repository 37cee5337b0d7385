/* The port's host helpers — C API.
 *
 * A copy of the JAX package's native runtime library (native/), kept inside
 * the port and built by dynamo_tpu_torch/native.py with g++:
 *   - KV prefix index        (ref: lib/llm/src/kv_router/indexer.rs:187-499)
 *   - batched KV block copy  (host-memory gather/scatter of whole blocks: the
 *                             KV host tier's pool rows)
 *   - engine KV event queue  (ref: lib/bindings/c/src/lib.rs:52,260 — C API a
 *                             native engine uses to publish stored/removed
 *                             events without touching Python)
 *
 * Pure C ABI so Python binds via ctypes and C++ engines can link directly.
 * Host code only: nothing here touches the card.
 */
#ifndef DYNAMO_NATIVE_H
#define DYNAMO_NATIVE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---------------------------------------------------------------- kv index */

typedef struct dyn_index dyn_index;

dyn_index *dyn_index_new(void);
void dyn_index_free(dyn_index *idx);

/* Record that `worker` now holds `n` blocks with these sequence hashes. */
void dyn_index_store(dyn_index *idx, uint64_t worker, const uint64_t *hashes,
                     size_t n);
/* Record that `worker` evicted these blocks. */
void dyn_index_remove(dyn_index *idx, uint64_t worker, const uint64_t *hashes,
                      size_t n);
/* Worker died/left: drop everything it held. */
void dyn_index_remove_worker(dyn_index *idx, uint64_t worker);
void dyn_index_clear(dyn_index *idx);

uint64_t dyn_index_num_blocks(const dyn_index *idx);
uint64_t dyn_index_num_workers(const dyn_index *idx);
/* Blocks the index holds for one worker (0 for an unknown worker). */
uint64_t dyn_index_num_worker_blocks(const dyn_index *idx, uint64_t worker);

/* Longest-prefix match: walk `hashes` (a request's chained block hashes) and
 * score each worker by how many consecutive prefix blocks it holds.  Writes
 * up to `cap` (worker, score) pairs; returns the number of matched workers
 * (which may exceed `cap`; callers pass cap >= num_workers). */
size_t dyn_index_find_matches(const dyn_index *idx, const uint64_t *hashes,
                              size_t n, uint64_t *out_workers,
                              uint32_t *out_scores, size_t cap);

/* ------------------------------------------------------------- block copy */

/* Gather `n` blocks of `block_bytes` each from `src` (an array of blocks,
 * block i at src + ids[i]*block_bytes) into contiguous `dst`.  Spawns up to
 * `threads` workers for large copies (0 = auto). */
void dyn_blocks_gather(const uint8_t *src, uint64_t block_bytes,
                       const int64_t *ids, size_t n, uint8_t *dst,
                       int threads);
/* Scatter contiguous `src` (n blocks) into `dst` at block indices `ids`. */
void dyn_blocks_scatter(uint8_t *dst, uint64_t block_bytes,
                        const int64_t *ids, size_t n, const uint8_t *src,
                        int threads);

/* ------------------------------------------------------------ event queue */

typedef struct dyn_events dyn_events;

enum {
  DYN_EVENT_STORED = 0,
  DYN_EVENT_REMOVED = 1,
};

dyn_events *dyn_events_new(size_t capacity);
void dyn_events_free(dyn_events *q);

/* Engine-side publish (thread-safe).  `parent_hash` is the sequence hash of
 * the block preceding hashes[0] (0 for root) — mirrors KvCacheEvent::Stored.
 * Returns 0 on success, -1 if the queue is full (event dropped). */
int dyn_events_publish(dyn_events *q, int32_t kind, uint64_t parent_hash,
                       const uint64_t *hashes, size_t n);

/* Drain up to `max_events` into flat buffers.  For event i:
 *   kinds[i], parents[i], offsets[i]..offsets[i+1] index into `hashes`
 * (offsets has max_events+1 entries).  Returns events drained. */
size_t dyn_events_drain(dyn_events *q, int32_t *kinds, uint64_t *parents,
                        uint64_t *hashes, size_t hashes_cap,
                        uint64_t *offsets, size_t max_events);

uint64_t dyn_events_dropped(const dyn_events *q);

/* ---------------------------------------------------------------- version */

const char *dyn_native_version(void);

#ifdef __cplusplus
}
#endif

#endif /* DYNAMO_NATIVE_H */
