"""ShardedKvIndexer — the prefix index split across N real KvIndexers.

A copy of ``dynamo_tpu/llm/kv_router/shards/indexer.py``.

Each shard is a plain `KvIndexer` (Python path — the native index has no
per-hash probe) fed only its key range: `apply_event` splits every
worker KV event with `partition.split_event` and forwards each piece to
its owning shard, so a replica process hosting one shard sees exactly
the event stream it would receive from a range-filtered subscription.

`find_matches` keeps the singleton signature by running a complete
in-process scatter-gather (shards/scatter.py `probe_shard` +
`gather_overlaps`), which makes it the reference answer the degraded
network path is tested against — equivalence with a singleton
`KvIndexer` fed the same events is pinned by the tests.
"""

from __future__ import annotations

import time
from typing import Sequence

from dynamo_tpu_torch.engine.counters import kv_shard_counters
from dynamo_tpu_torch.llm.kv.events import KvCacheEvent
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, OverlapScores
from dynamo_tpu_torch.llm.kv_router.shards.partition import split_event
from dynamo_tpu_torch.llm.kv_router.shards.scatter import gather_overlaps, probe_shard

__all__ = ["ShardedKvIndexer"]


class ShardedKvIndexer:
    def __init__(self, n_shards: int, generation: int = 0) -> None:
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self.generation = generation
        self._shards = [KvIndexer(use_native=False) for _ in range(n_shards)]
        # gap diagnostics live here: sub-events reach shards without ids
        self._last_event_id: dict[int, int] = {}

    def shard(self, shard_id: int) -> KvIndexer:
        return self._shards[shard_id]

    # ----------------------------------------------------------------- events
    def apply_event(self, worker_id: int, event: KvCacheEvent,
                    event_id: int | None = None) -> None:
        if event_id is not None:
            self._last_event_id[worker_id] = event_id
        for shard_id, sub in split_event(event, self.n_shards).items():
            self._shards[shard_id].apply_event(worker_id, sub)

    def remove_worker(self, worker_id: int) -> None:
        for s in self._shards:
            s.remove_worker(worker_id)
        self._last_event_id.pop(worker_id, None)

    def clear(self) -> None:
        for s in self._shards:
            s.clear()
        self._last_event_id.clear()

    # ---------------------------------------------------------------- queries
    def find_matches(self, seq_hashes: Sequence[int]) -> OverlapScores:
        t0 = time.perf_counter()
        replies = {
            s: probe_shard(self._shards[s], s, self.n_shards, seq_hashes,
                           self.generation)
            for s in range(self.n_shards)
        }
        scores, _ = gather_overlaps(seq_hashes, self.n_shards, replies,
                                    self.generation)
        kv_shard_counters.record_scatter(
            (time.perf_counter() - t0) * 1e3, fan_out=self.n_shards)
        return scores

    def workers(self) -> list[int]:
        out: set[int] = set()
        for s in self._shards:
            out.update(s.workers())
        return sorted(out)

    @property
    def num_blocks(self) -> int:
        return sum(s.num_blocks for s in self._shards)

    @property
    def resident_keys(self) -> int:
        return sum(s.resident_keys for s in self._shards)

    def shard_sizes(self) -> list[tuple[int, int]]:
        """Per-shard (device blocks, resident keys) — the /metrics
        gauges; also pushes them into the process-global counters so a
        scrape needs no reference to this object."""
        sizes = [(s.num_blocks, s.resident_keys) for s in self._shards]
        for shard_id, (blocks, keys) in enumerate(sizes):
            kv_shard_counters.set_shard_size(shard_id, blocks, keys)
        return sizes

    # --------------------------------------------------------------- handoff
    def export_shard(self, shard_id: int) -> tuple[dict[int, list[int]],
                                                   dict[int, list[int]]]:
        """Snapshot one shard's (device, persist) holder maps for an
        index handoff, in wire shape: hash -> sorted worker ids."""
        src = self._shards[shard_id]
        device = {h: sorted(src.holders_of(h))
                  for h in sorted(src._holders)}
        persist = {h: sorted(src.persist_holders_of(h))
                   for h in sorted(src._persist_holders)}
        return device, persist

    def import_shard(self, shard_id: int, device: dict[int, list[int]],
                     persist: dict[int, list[int]]) -> None:
        """Install a handed-off shard snapshot, replacing the local
        range.  The caller is responsible for the generation fence —
        an import only happens after the membership change that bumped
        it (lifecycle.py)."""
        from dynamo_tpu_torch.llm.kv.events import (  # local: avoid cycle at import
            TIER_PERSIST,
            KvStoredEvent,
        )
        fresh = KvIndexer(use_native=False)
        by_worker: dict[int, list[int]] = {}
        for h, wids in device.items():
            for w in wids:
                by_worker.setdefault(w, []).append(h)
        for w, hashes in sorted(by_worker.items()):
            fresh.apply_event(w, KvStoredEvent(block_hashes=sorted(hashes)))
        by_worker.clear()
        for h, wids in persist.items():
            for w in wids:
                by_worker.setdefault(w, []).append(h)
        for w, hashes in sorted(by_worker.items()):
            fresh.apply_event(
                w, KvStoredEvent(block_hashes=sorted(hashes),
                                 tier=TIER_PERSIST))
        self._shards[shard_id] = fresh
