"""KV cache events — how a worker tells a router what its cache holds.

``block_hashes`` are chained sequence hashes (``dynamo_tpu_torch.tokens``).
The wire form (:func:`event_to_wire` / :func:`event_from_wire`) is the JAX
package's, key for key, so a router of either package reads the events of
a worker of either.

The ``tier``/``kind`` string constants are the one spelling of the event
plane's discriminators: producers (the engine, the persistent tier) and
consumers (``llm/kv_router/indexer.py``) import them.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional, Union

log = logging.getLogger("dynamo_tpu_torch.kv_router")

__all__ = ["TIER_DEVICE", "TIER_PERSIST", "KIND_STORED", "KIND_REMOVED", "KvStoredEvent",
           "KvRemovedEvent", "KvCacheEvent", "event_to_wire", "event_from_wire"]

# cache tiers a block can be resident in (wire field "tier")
TIER_DEVICE = "device"
TIER_PERSIST = "persist"
# event kinds (wire field "kind")
KIND_STORED = "stored"
KIND_REMOVED = "removed"

# every key a producer may put on the wire; event_from_wire drops anything
# else (a newer worker may tag events with fields this router does not know)
_WIRE_KEYS = frozenset({
    "event_id", "worker_id", "kind", "parent_hash", "block_hashes",
    "token_blocks", "tier",
})


@dataclass
class KvStoredEvent:
    """Blocks became resident (and reusable) on a worker.  ``parent_hash``
    is the sequence hash of the block preceding the first one (None at the
    sequence root)."""

    block_hashes: list[int]
    parent_hash: Optional[int] = None
    token_blocks: list[list[int]] = field(default_factory=list)  # optional token payload
    # which tier holds the blocks: "device" (a radix hit, free to reuse) or
    # "persist" (the disk tier: reusable after a host-side restore, so the
    # router scores it at a discount)
    tier: str = TIER_DEVICE

    kind = KIND_STORED


@dataclass
class KvRemovedEvent:
    """Blocks were evicted from a worker's cache."""

    block_hashes: list[int]
    tier: str = TIER_DEVICE

    kind = KIND_REMOVED


KvCacheEvent = Union[KvStoredEvent, KvRemovedEvent]


def event_to_wire(event_id: int, worker_id: int, ev: KvCacheEvent) -> dict:
    """The JSON-serialisable router event."""
    out = {"event_id": event_id, "worker_id": worker_id, "kind": ev.kind}
    if isinstance(ev, KvStoredEvent):
        out["parent_hash"] = ev.parent_hash
        out["block_hashes"] = ev.block_hashes
        if ev.token_blocks:
            out["token_blocks"] = ev.token_blocks
    else:
        out["block_hashes"] = ev.block_hashes
    if ev.tier != TIER_DEVICE:  # wire compatibility: old consumers never see the key
        out["tier"] = ev.tier
    return out


def event_from_wire(d: dict) -> tuple[int, int, KvCacheEvent]:
    unknown = set(d) - _WIRE_KEYS
    if unknown:
        # tolerate and drop, never raise: a newer producer may add fields
        log.debug("kv event: dropping unknown wire fields %s", sorted(unknown))
    tier = d.get("tier", TIER_DEVICE)
    if d["kind"] == KIND_STORED:
        ev: KvCacheEvent = KvStoredEvent(
            block_hashes=list(d["block_hashes"]),
            parent_hash=d.get("parent_hash"),
            token_blocks=[list(t) for t in d.get("token_blocks", [])],
            tier=tier,
        )
    else:
        ev = KvRemovedEvent(block_hashes=list(d["block_hashes"]), tier=tier)
    return d["event_id"], d["worker_id"], ev
