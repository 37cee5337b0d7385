"""Scatter-gather overlap scoring across index shards.

A copy of ``dynamo_tpu/llm/kv_router/shards/scatter.py`` over the port's
``KvIndexer`` and ``KvScheduler``.

One routing decision needs the holder set of every prefix position of
the request.  Position i's key is owned by exactly one shard, so the
scatter sends the full hash list to every owning replica, each replica
answers with holders for just the positions it owns (`probe_shard`),
and the gather (`gather_overlaps`) re-runs the singleton KvIndexer's
longest-prefix intersection walk over the merged per-position sets.
With every shard present the result is bit-identical to a singleton
`KvIndexer.find_matches` fed the same events — tests pin this.

Failure semantics: a reply that is missing (deadline miss, replica
death mid-scatter) or fenced (stale generation) truncates the walk at
that shard's first owned position.  Scores degrade monotonically —
overlap can only be under-counted, never invented — and placement
proceeds on whatever survived; a missing shard never blocks the
decision.  `gather_partial_total` (engine/counters.py) counts how often
that happened.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Optional, Protocol, Sequence

from dynamo_tpu_torch.engine.counters import kv_shard_counters
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, OverlapScores
from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler
from dynamo_tpu_torch.llm.kv_router.shards.partition import shard_of

__all__ = [
    "ShardReply",
    "probe_shard",
    "gather_overlaps",
    "LocalShardClient",
    "ScatterGatherScheduler",
]


@dataclass
class ShardReply:
    """One shard's answer to a scatter: holder sets for the request
    positions it owns, fenced by the replica's view of the generation."""

    shard_id: int
    generation: int
    # request position -> worker ids holding that position's block
    holders: dict[int, frozenset[int]] = field(default_factory=dict)
    persist_holders: dict[int, frozenset[int]] = field(default_factory=dict)


def probe_shard(index: KvIndexer, shard_id: int, n_shards: int,
                seq_hashes: Sequence[int], generation: int) -> ShardReply:
    """Serve a scatter request from one shard's index: probe every
    position this shard owns.  Pure read — safe to serve concurrently
    with the replica's event-apply task only under the same
    single-writer rule the singleton index documents."""
    holders: dict[int, frozenset[int]] = {}
    persist: dict[int, frozenset[int]] = {}
    for i, h in enumerate(seq_hashes):
        if shard_of(h, n_shards) != shard_id:
            continue
        hs = index.holders_of(h)
        if hs:
            holders[i] = hs
        ps = index.persist_holders_of(h)
        if ps:
            persist[i] = ps
    return ShardReply(shard_id=shard_id, generation=generation,
                      holders=holders, persist_holders=persist)


def _walk(seq_hashes: Sequence[int], n_shards: int,
          replies: dict[int, Optional[ShardReply]], generation: int,
          persist_tier: bool) -> dict[int, int]:
    scores: dict[int, int] = {}
    live: Optional[set[int]] = None
    for i, h in enumerate(seq_hashes):
        rep = replies.get(shard_of(h, n_shards))
        if rep is None or rep.generation != generation:
            break  # degraded: truncate at the missing/fenced shard
        holders = (rep.persist_holders if persist_tier else rep.holders).get(i)
        if not holders:
            break
        live = set(holders) if live is None else (live & holders)
        if not live:
            break
        for w in live:
            scores[w] = i + 1
    return scores


def gather_overlaps(seq_hashes: Sequence[int], n_shards: int,
                    replies: dict[int, Optional[ShardReply]],
                    generation: int) -> tuple[OverlapScores, bool]:
    """Merge scatter replies into OverlapScores.  Returns the scores
    plus a ``partial`` flag: True when any shard owning at least one
    request position was missing or answered with a stale generation.
    Identical to the singleton longest-prefix walk when complete."""
    owned = {shard_of(h, n_shards) for h in seq_hashes}
    partial = any(
        replies.get(s) is None or replies[s].generation != generation
        for s in owned
    )
    scores = _walk(seq_hashes, n_shards, replies, generation, persist_tier=False)
    persist = _walk(seq_hashes, n_shards, replies, generation, persist_tier=True)
    return OverlapScores(scores, persist), partial


class ShardClient(Protocol):
    """Transport seam for one replica: in-process (LocalShardClient) or
    over the coordinator's pub/sub plane (lifecycle.PubSubShardClient)."""

    shard_id: int

    async def probe(self, seq_hashes: Sequence[int],
                    generation: int) -> ShardReply: ...


class LocalShardClient:
    """In-process client over a replica's KvIndexer, for single-process
    deployments and tests."""

    def __init__(self, shard_id: int, n_shards: int, index: KvIndexer,
                 generation_fn=None, delay_s: float = 0.0):
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.index = index
        # replica's OWN view of the generation (may lag the gatherer's —
        # that is the point of the fence); defaults to the gatherer's
        self._generation_fn = generation_fn
        # test hook: simulated probe latency, to force deadline misses
        self.delay_s = delay_s

    async def probe(self, seq_hashes: Sequence[int],
                    generation: int) -> ShardReply:
        if self.delay_s > 0:
            await asyncio.sleep(self.delay_s)
        gen = self._generation_fn() if self._generation_fn else generation
        return probe_shard(self.index, self.shard_id, self.n_shards,
                           seq_hashes, gen)


class ScatterGatherScheduler:
    """Fans overlap scoring out to shard replicas and folds the merged
    scores through the singleton KvScheduler's pure `score_candidates`
    seam, so the itemized logit breakdown survives sharding unchanged."""

    def __init__(self, scheduler: KvScheduler, clients: Sequence[ShardClient],
                 n_shards: int, deadline_s: float = 0.050,
                 generation: int = 0, clock=time.perf_counter):
        self.scheduler = scheduler
        self.clients = list(clients)
        self.n_shards = n_shards
        # per-shard gather deadline: a replica that cannot answer within
        # this bound is treated as absent for THIS decision only
        self.deadline_s = deadline_s
        self.generation = generation
        self._clock = clock

    def set_generation(self, generation: int) -> None:
        self.generation = generation

    async def _scatter(self, seq_hashes: Sequence[int]
                       ) -> dict[int, Optional[ShardReply]]:
        async def one(c: ShardClient):
            try:
                return await asyncio.wait_for(
                    c.probe(seq_hashes, self.generation), self.deadline_s)
            except (asyncio.TimeoutError, ConnectionError, OSError):
                return None

        t0 = self._clock()
        results = await asyncio.gather(*(one(c) for c in self.clients))
        replies: dict[int, Optional[ShardReply]] = {}
        for c, r in zip(self.clients, results):
            replies[c.shard_id] = r
        kv_shard_counters.record_scatter((self._clock() - t0) * 1e3,
                                         fan_out=len(self.clients))
        return replies

    async def overlaps(self, seq_hashes: Sequence[int]
                       ) -> tuple[OverlapScores, bool]:
        replies = await self._scatter(seq_hashes)
        scores, partial = gather_overlaps(seq_hashes, self.n_shards,
                                          replies, self.generation)
        if partial:
            kv_shard_counters.record_partial_gather()
        return scores, partial

    async def score_candidates(self, seq_hashes: Sequence[int],
                               request_tokens: int,
                               transfer_costs_s: Optional[dict[int, float]] = None,
                               ) -> list[tuple[int, float, dict]]:
        ov, _ = await self.overlaps(seq_hashes)
        return self.scheduler.score_candidates(
            ov.scores, request_tokens, persist_overlaps=ov.persist_scores,
            transfer_costs_s=transfer_costs_s)

    async def schedule(self, seq_hashes: Sequence[int], request_tokens: int,
                       transfer_costs_s: Optional[dict[int, float]] = None) -> int:
        ov, _ = await self.overlaps(seq_hashes)
        return self.scheduler.schedule(
            ov.scores, request_tokens, persist_overlaps=ov.persist_scores,
            transfer_costs_s=transfer_costs_s)
