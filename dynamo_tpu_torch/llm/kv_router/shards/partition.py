"""Key partitioning for the sharded prefix index.

A copy of ``dynamo_tpu/llm/kv_router/shards/partition.py``: the same
owners, sub-events and generations for the same keys and replicas.

The unit of ownership is a single chained-xxh3 block key (dynamo_tpu_torch.
tokens.sequence_hashes).  Because a block hash already commits to its
entire prefix, any position of any sequence can be scored by whichever
shard holds that one key — there is no tree to co-locate.  The partition
function takes the top 16 bits of the 64-bit key ("hash prefix", mirrors
the flat-map-as-radix-tree argument in kv_router/indexer.py) modulo the
shard count, so consecutive blocks of one sequence spray across shards
and no shard inherits a hot tenant's whole prefix.

Shards are a fixed keyspace partition; *replicas* are processes that own
shards.  `ShardMap` binds the two under a generation number derived from
the membership itself (`membership_generation`): every observer of the
same live replica set computes the same generation with no leader and no
shared counter, and scatter replies carrying a different generation are
rejected by the gather merge (shards/scatter.py) — the fence that keeps
a replica which missed a membership change from serving a range it no
longer owns.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.llm.kv.events import (
    KvCacheEvent,
    KvRemovedEvent,
    KvStoredEvent,
)
from dynamo_tpu_torch.tokens import compute_hash
from dynamo_tpu_torch.utils.chash import HashRing

__all__ = ["shard_of", "split_hashes", "split_event", "ShardMap",
           "membership_generation"]

# bits of hash prefix the partition keys on; 16 bits ≫ any plausible
# shard count, so ownership is stable under modulo for small N
SHARD_PREFIX_BITS = 16


def shard_of(block_hash: int, n_shards: int) -> int:
    """Owning shard of one chained block key."""
    if n_shards <= 1:
        return 0
    return ((block_hash & 0xFFFFFFFFFFFFFFFF) >> (64 - SHARD_PREFIX_BITS)) % n_shards


def split_hashes(block_hashes, n_shards: int) -> dict[int, list[int]]:
    """Group block keys by owning shard, preserving order within each."""
    out: dict[int, list[int]] = {}
    for h in block_hashes:
        out.setdefault(shard_of(h, n_shards), []).append(h)
    return out


def split_event(event: KvCacheEvent, n_shards: int) -> dict[int, KvCacheEvent]:
    """Split one worker KV event into per-shard sub-events covering only
    each shard's keys.  Parent hashes are dropped: the flat index never
    reads them, and a sub-event's first block's parent usually lives on
    another shard anyway."""
    if n_shards <= 1:
        return {0: event}
    parts = split_hashes(event.block_hashes, n_shards)
    out: dict[int, KvCacheEvent] = {}
    if isinstance(event, KvStoredEvent):
        tokens_by_hash = {}
        if event.token_blocks and len(event.token_blocks) == len(event.block_hashes):
            tokens_by_hash = dict(zip(event.block_hashes, event.token_blocks))
        for s, hashes in parts.items():
            out[s] = KvStoredEvent(
                block_hashes=hashes,
                parent_hash=None,
                token_blocks=[tokens_by_hash[h] for h in hashes] if tokens_by_hash else [],
                tier=event.tier,
            )
    else:
        for s, hashes in parts.items():
            out[s] = KvRemovedEvent(block_hashes=hashes, tier=event.tier)
    return out


def membership_generation(replicas, n_shards: int) -> int:
    """Content-addressed generation of one membership view: the xxh3 of
    the sorted replica set (plus the shard count).  Two replicas — or a
    replica and a gatherer — that observed the same membership agree on
    the fence value without ever talking to each other; one that missed
    a change disagrees and gets fenced.  ABA (membership returning to an
    exact prior composition) resurrects that composition's generation,
    which is benign for ownership (same set, same map) and bounds the
    staleness of a resurrected snapshot by the live event stream."""
    blob = "|".join(sorted(replicas)) + f"#{n_shards}"
    return compute_hash(blob.encode())


@dataclass
class ShardMap:
    """Which replica owns which shard, fenced by a generation.

    Built deterministically from the live replica set with the same
    consistent-hash ring the frontends use, so every observer of the
    same membership computes the same map — no leader election needed
    for read-path ownership."""

    n_shards: int
    generation: int = 0
    owners: dict[int, str] = field(default_factory=dict)  # shard -> replica id

    @classmethod
    def from_replicas(cls, replicas, n_shards: int,
                      generation: Optional[int] = None) -> "ShardMap":
        ring = HashRing(replicas)
        owners = {s: ring.lookup(f"shard/{s}") for s in range(n_shards)}
        if generation is None:
            generation = membership_generation(replicas, n_shards)
        return cls(n_shards=n_shards, generation=generation,
                   owners={s: o for s, o in owners.items() if o is not None})

    def owner(self, shard_id: int):
        return self.owners.get(shard_id)

    def shards_of(self, replica: str) -> list[int]:
        return sorted(s for s, o in self.owners.items() if o == replica)

    def rebind(self, replicas) -> "ShardMap":
        """Membership changed: recompute ownership and the fence."""
        return ShardMap.from_replicas(replicas, self.n_shards)

    def moved_shards(self, new: "ShardMap") -> list[int]:
        """Shards whose owner differs between two maps — exactly the
        ranges that need an index handoff."""
        return sorted(
            s for s in range(self.n_shards)
            if self.owners.get(s) != new.owners.get(s)
        )
