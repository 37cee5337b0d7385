"""Sharded control plane: hash-partitioned prefix index + scatter-gather.

The counterpart of ``dynamo_tpu/llm/kv_router/shards/``, module for module,
with the same wire frames, so replicas and schedulers of the two packages
share one coordinator.  It scales the router out of its singleton box: the
prefix index is partitioned by hash prefix of the chained block keys across N
replicas (`ShardedKvIndexer`), overlap scoring scatters to the owning
shards and merges with bounded deadlines (`ScatterGatherScheduler` —
a missing shard degrades scores, never blocks placement), and replica
membership/handoff rides the existing discovery-delete idiom with a
generation fence (`lifecycle.ShardReplica`).
"""

from dynamo_tpu_torch.llm.kv_router.shards.indexer import ShardedKvIndexer
from dynamo_tpu_torch.llm.kv_router.shards.lifecycle import (
    PubSubShardClient,
    ShardReplica,
)
from dynamo_tpu_torch.llm.kv_router.shards.partition import (
    ShardMap,
    membership_generation,
    shard_of,
    split_event,
    split_hashes,
)
from dynamo_tpu_torch.llm.kv_router.shards.scatter import (
    LocalShardClient,
    ScatterGatherScheduler,
    ShardReply,
    gather_overlaps,
    probe_shard,
)

__all__ = [
    "ShardedKvIndexer",
    "ScatterGatherScheduler",
    "ShardReplica",
    "PubSubShardClient",
    "LocalShardClient",
    "ShardMap",
    "ShardReply",
    "shard_of",
    "split_event",
    "split_hashes",
    "membership_generation",
    "gather_overlaps",
    "probe_shard",
]
