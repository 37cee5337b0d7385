// Engine-side KV event queue — the C bindings surface (the port's copy).
//
// Reference parity: lib/bindings/c/src/lib.rs:52,260 (dynamo_llm_init +
// kv_event_publish_stored/removed for C++ engines).  A native engine (or the
// paged-cache bookkeeping in a C++ data loader) publishes Stored/Removed
// events into this bounded MPSC queue; the Python-side KvEventPublisher
// drains it in batches and forwards RouterEvents to the coordinator's
// kv_events subject.  Bounded + drop-counting so a wedged publisher can't
// OOM the engine (the indexer tolerates gaps; see indexer event-id gap log).

#include "dynamo_native.h"

#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Event {
  int32_t kind;
  uint64_t parent;
  std::vector<uint64_t> hashes;
};

}  // namespace

struct dyn_events {
  std::mutex mu;
  std::deque<Event> q;
  size_t capacity;
  uint64_t dropped = 0;
};

extern "C" {

dyn_events *dyn_events_new(size_t capacity) {
  auto *q = new dyn_events();
  q->capacity = capacity ? capacity : 1 << 16;
  return q;
}

void dyn_events_free(dyn_events *q) { delete q; }

int dyn_events_publish(dyn_events *q, int32_t kind, uint64_t parent_hash,
                       const uint64_t *hashes, size_t n) {
  std::lock_guard lock(q->mu);
  if (q->q.size() >= q->capacity) {
    ++q->dropped;
    return -1;
  }
  Event ev;
  ev.kind = kind;
  ev.parent = parent_hash;
  ev.hashes.assign(hashes, hashes + n);
  q->q.push_back(std::move(ev));
  return 0;
}

size_t dyn_events_drain(dyn_events *q, int32_t *kinds, uint64_t *parents,
                        uint64_t *hashes, size_t hashes_cap, uint64_t *offsets,
                        size_t max_events) {
  std::lock_guard lock(q->mu);
  size_t n_ev = 0, n_hash = 0;
  offsets[0] = 0;
  while (n_ev < max_events && !q->q.empty()) {
    Event &ev = q->q.front();
    if (n_hash + ev.hashes.size() > hashes_cap) {
      // An event too large to EVER fit must not wedge the queue head: drop
      // it and count it (the indexer tolerates gaps); otherwise leave it
      // for the next drain call.
      if (n_ev == 0 && ev.hashes.size() > hashes_cap) {
        ++q->dropped;
        q->q.pop_front();
        continue;
      }
      break;
    }
    kinds[n_ev] = ev.kind;
    parents[n_ev] = ev.parent;
    std::memcpy(hashes + n_hash, ev.hashes.data(),
                ev.hashes.size() * sizeof(uint64_t));
    n_hash += ev.hashes.size();
    ++n_ev;
    offsets[n_ev] = n_hash;
    q->q.pop_front();
  }
  return n_ev;
}

uint64_t dyn_events_dropped(const dyn_events *q) {
  std::lock_guard lock(const_cast<dyn_events *>(q)->mu);
  return q->dropped;
}

const char *dyn_native_version(void) { return "0.1.0"; }

}  // extern "C"
