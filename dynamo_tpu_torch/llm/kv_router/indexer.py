"""KvIndexer — the global prefix index: block hash → workers holding it.

The counterpart of ``dynamo_tpu/llm/kv_router/indexer.py``, with its split:
the device tier lives in the C++ index (``dynamo_tpu_torch/native.py``,
``csrc/host/kv_index.cpp``) unless ``use_native=False`` asks for the Python
one, which the sharded replicas and the planes' reference indexes do.  The
persistent tier (``tier="persist"`` events) is always indexed in Python and
scored apart.  The chained sequence hashes (dynamo_tpu_torch.tokens) make a
radix tree redundant — a block hash already commits to its entire prefix,
so a flat hash→workers map gives the same match semantics with O(1)
lookups, plus per-worker hash sets for O(worker's blocks) teardown.

The index is single-writer: apply events from one task/thread;
find_matches is read-only.  The first native index builds the host library
(seconds): an async caller loads it off the loop first
(``await asyncio.to_thread(native.load)``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Sequence

from dynamo_tpu_torch import native
from dynamo_tpu_torch.llm.kv.events import (
    TIER_DEVICE,
    TIER_PERSIST,
    KvCacheEvent,
    KvRemovedEvent,
    KvStoredEvent,
)

log = logging.getLogger("dynamo_tpu_torch.kv_router")

__all__ = ["KvIndexer", "OverlapScores"]


@dataclass
class OverlapScores:
    """worker_id → number of consecutive prefix blocks resident there
    (ref indexer.rs OverlapScores).  ``persist_scores`` is the same
    longest-prefix walk over each worker's PERSISTENT tier (llm/kv/
    persist.py): blocks a worker can restore host-side before prefill
    rather than already holding in HBM — the scheduler scores them at a
    discount."""

    scores: dict[int, int] = field(default_factory=dict)
    persist_scores: dict[int, int] = field(default_factory=dict)

    def best(self) -> tuple[int, int] | None:
        if not self.scores:
            return None
        wid = max(self.scores, key=lambda w: self.scores[w])
        return wid, self.scores[wid]


class KvIndexer:
    def __init__(self, use_native: bool | None = None) -> None:
        # the C++ index unless the Python one is asked for; a failed build
        # of the host library raises (no quiet fallback)
        self._native = native.NativeKvIndex() if use_native is not False else None
        # block sequence-hash → set of worker ids holding it (Python path)
        self._holders: dict[int, set[int]] = {}
        # worker id → hashes it holds (for teardown); on the native path the
        # workers that have stored, with no hashes (workers() lists them)
        self._worker_blocks: dict[int, set[int]] = {}
        # persistent tier (tier="persist" events) — always Python-side:
        # the native index only models the device tier
        self._persist_holders: dict[int, set[int]] = {}
        self._persist_worker_blocks: dict[int, set[int]] = {}
        # per-worker last event id (gap/ordering diagnostics)
        self._last_event_id: dict[int, int] = {}

    @property
    def is_native(self) -> bool:
        return self._native is not None

    # ---------------------------------------------------------------- queries
    def find_matches(self, seq_hashes: Sequence[int]) -> OverlapScores:
        """Longest-prefix match per worker over the request's block hashes."""
        persist = self._persist_matches(seq_hashes)
        if self._native is not None:
            return OverlapScores(self._native.find_matches(seq_hashes), persist)
        scores: dict[int, int] = {}
        live: set[int] | None = None  # workers matching every block so far
        for i, h in enumerate(seq_hashes):
            holders = self._holders.get(h)
            if not holders:
                break
            live = set(holders) if live is None else (live & holders)
            if not live:
                break
            for w in live:  # workers that dropped out keep their shorter score
                scores[w] = i + 1
        return OverlapScores(scores, persist)

    def _persist_matches(self, seq_hashes: Sequence[int]) -> dict[int, int]:
        """Longest prefix per worker over the persistent tier alone —
        what each worker could restore host-side starting from a cold
        device cache.  Conservative: the walk starts at the sequence
        root, so persist blocks that merely CONTINUE a device-resident
        prefix (device holds 0..k, persist holds k+1..) score 0 here;
        the scheduler only adds the persist term where it EXCEEDS the
        device score, so undercounting can never double-pay."""
        if not self._persist_holders:
            return {}
        scores: dict[int, int] = {}
        live: set[int] | None = None
        for i, h in enumerate(seq_hashes):
            holders = self._persist_holders.get(h)
            if not holders:
                break
            live = set(holders) if live is None else (live & holders)
            if not live:
                break
            for w in live:
                scores[w] = i + 1
        return scores

    # per-position probes for the sharded control plane: the holder set of
    # exactly one hash.  Python path only — shard replicas are built with
    # use_native=False, and the native index exposes no single-hash probe.
    def holders_of(self, h: int) -> frozenset[int]:
        """Device-tier workers holding block hash ``h``."""
        if self._native is not None:
            raise RuntimeError("holders_of: native index has no probe path")
        return frozenset(self._holders.get(h, ()))

    def persist_holders_of(self, h: int) -> frozenset[int]:
        """Persist-tier workers holding block hash ``h``."""
        return frozenset(self._persist_holders.get(h, ()))

    @property
    def resident_keys(self) -> int:
        """Distinct block hashes resident across both tiers (persist keys
        that also exist on device count once per tier; this tracks index
        memory, not bytes)."""
        return self.num_blocks + len(self._persist_holders)

    @property
    def num_blocks(self) -> int:
        if self._native is not None:
            return self._native.num_blocks
        return len(self._holders)

    def worker_blocks(self, worker_id: int) -> int:
        """How many device-tier blocks the index holds for one worker."""
        if self._native is not None:
            return self._native.worker_blocks(worker_id)
        return len(self._worker_blocks.get(worker_id, ()))

    def workers(self) -> list[int]:
        return sorted(self._worker_blocks)

    # ----------------------------------------------------------------- events
    def apply_event(self, worker_id: int, event: KvCacheEvent, event_id: int | None = None) -> None:
        if event_id is not None:
            last = self._last_event_id.get(worker_id)
            if last is not None and event_id != last + 1:
                log.debug(
                    "worker %s event id gap: %s -> %s", worker_id, last, event_id
                )
            self._last_event_id[worker_id] = event_id

        if getattr(event, "tier", TIER_DEVICE) == TIER_PERSIST:
            if isinstance(event, KvStoredEvent):
                blocks = self._persist_worker_blocks.setdefault(worker_id, set())
                for h in event.block_hashes:
                    self._persist_holders.setdefault(h, set()).add(worker_id)
                    blocks.add(h)
            elif isinstance(event, KvRemovedEvent):
                blocks = self._persist_worker_blocks.get(worker_id, set())
                for h in event.block_hashes:
                    holders = self._persist_holders.get(h)
                    if holders:
                        holders.discard(worker_id)
                        if not holders:
                            del self._persist_holders[h]
                    blocks.discard(h)
            return

        if self._native is not None:
            if isinstance(event, KvStoredEvent):
                # workers() tracks Stored only (as the Python path does)
                self._worker_blocks.setdefault(worker_id, set())
                self._native.store(worker_id, event.block_hashes)
            elif isinstance(event, KvRemovedEvent):
                self._native.remove(worker_id, event.block_hashes)
            return

        if isinstance(event, KvStoredEvent):
            blocks = self._worker_blocks.setdefault(worker_id, set())
            for h in event.block_hashes:
                self._holders.setdefault(h, set()).add(worker_id)
                blocks.add(h)
        elif isinstance(event, KvRemovedEvent):
            blocks = self._worker_blocks.get(worker_id, set())
            for h in event.block_hashes:
                holders = self._holders.get(h)
                if holders:
                    holders.discard(worker_id)
                    if not holders:
                        del self._holders[h]
                blocks.discard(h)

    def remove_worker(self, worker_id: int) -> None:
        """Worker died/left: drop all its blocks (ref: client watcher delete
        path, component/client.rs:145-154 → router stops picking it)."""
        for h in self._persist_worker_blocks.pop(worker_id, set()):
            holders = self._persist_holders.get(h)
            if holders:
                holders.discard(worker_id)
                if not holders:
                    del self._persist_holders[h]
        if self._native is not None:
            self._native.remove_worker(worker_id)
            self._worker_blocks.pop(worker_id, None)
            self._last_event_id.pop(worker_id, None)
            return
        for h in self._worker_blocks.pop(worker_id, set()):
            holders = self._holders.get(h)
            if holders:
                holders.discard(worker_id)
                if not holders:
                    del self._holders[h]
        self._last_event_id.pop(worker_id, None)

    def clear(self) -> None:
        if self._native is not None:
            self._native.clear()
        self._holders.clear()
        self._worker_blocks.clear()
        self._persist_holders.clear()
        self._persist_worker_blocks.clear()
        self._last_event_id.clear()
