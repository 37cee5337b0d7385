"""KV cache events — how a worker tells a router what its cache holds.

``block_hashes`` are chained sequence hashes (``dynamo_tpu_torch.tokens``).
The wire codec lives with the router, which this package does not carry yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

__all__ = ["KvStoredEvent", "KvRemovedEvent", "KvCacheEvent"]

# cache tiers a block can be resident in (wire field "tier")
TIER_DEVICE = "device"
# event kinds (wire field "kind")
KIND_STORED = "stored"
KIND_REMOVED = "removed"


@dataclass
class KvStoredEvent:
    """Blocks became resident (and reusable) on a worker.  ``parent_hash``
    is the sequence hash of the block preceding the first one (None at the
    sequence root)."""

    block_hashes: list[int]
    parent_hash: Optional[int] = None
    token_blocks: list[list[int]] = field(default_factory=list)
    tier: str = TIER_DEVICE

    kind = KIND_STORED


@dataclass
class KvRemovedEvent:
    """Blocks were evicted from a worker's cache."""

    block_hashes: list[int]
    tier: str = TIER_DEVICE

    kind = KIND_REMOVED


KvCacheEvent = Union[KvStoredEvent, KvRemovedEvent]
