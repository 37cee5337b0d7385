"""Wire contracts for the sharded control plane.

A copy of ``dynamo_tpu/llm/kv_router/shards/wire.py``, byte for byte on the
wire: the same subjects, the same JSON keys in the same (sorted) order, and
integers that stay integers, so the two packages' replicas and schedulers
exchange frames on one coordinator.

Four payloads ride the coordinator's pub/sub plane, all JSON, all
discriminated by ``op`` and all carrying ``generation`` — the membership
fence doubles as the payload's version tag: a frame from
before a membership change is by definition from an older protocol
epoch and the receiver drops it.

  * **shard_announce** (`{ns}.kv_shards.announce`) — a replica declares
    which shards it serves at which generation; frontends and peers
    rebuild their ShardMap from the latest announce per replica.
  * **shard_scatter** (`{ns}.kv_shards.scatter.{shard}`) — overlap probe
    for one routing decision: the full hash list plus the subject the
    reply should land on.
  * **shard_reply** (reply subject from the request) — per-position
    holder sets for the shard's owned positions, both tiers.
  * **shard_handoff** (`{ns}.kv_shards.handoff.{shard}`) — a departing
    or re-balanced owner ships its range snapshot to the new owner.

Holder maps serialize as sorted ``[key, [worker_ids]]`` pairs rather
than JSON objects so integer keys survive the round trip and the bytes
are deterministic.
"""

from __future__ import annotations

import json
from typing import Mapping, Sequence

from dynamo_tpu_torch.llm.kv_router.shards.scatter import ShardReply

__all__ = [
    "shard_announce_subject", "shard_scatter_subject", "shard_handoff_subject",
    "encode_shard_announce", "decode_shard_announce",
    "encode_scatter_request", "decode_scatter_request",
    "encode_scatter_reply", "decode_scatter_reply",
    "encode_shard_handoff", "decode_shard_handoff",
]

OP_ANNOUNCE = "shard_announce"
OP_SCATTER = "shard_scatter"
OP_REPLY = "shard_reply"
OP_HANDOFF = "shard_handoff"


def shard_announce_subject(namespace: str) -> str:
    return f"{namespace}.kv_shards.announce"


def shard_scatter_subject(namespace: str, shard_id: int | str = "") -> str:
    base = f"{namespace}.kv_shards.scatter"
    return f"{base}.{shard_id}" if shard_id != "" else f"{base}.>"


def shard_handoff_subject(namespace: str, shard_id: int | str = "") -> str:
    base = f"{namespace}.kv_shards.handoff"
    return f"{base}.{shard_id}" if shard_id != "" else f"{base}.>"


def _pairs(m: Mapping[int, Sequence[int]]) -> list[list]:
    return [[int(k), sorted(int(w) for w in v)] for k, v in sorted(m.items())]


def _unpairs(pairs) -> dict[int, frozenset[int]]:
    return {int(k): frozenset(int(w) for w in v) for k, v in pairs}


# ------------------------------------------------------------------ announce
def encode_shard_announce(replica: str, shards: Sequence[int],
                          generation: int) -> bytes:
    return json.dumps({
        "op": "shard_announce",
        "replica": replica,
        "shards": sorted(shards),
        "generation": generation,
    }, sort_keys=True).encode()


def decode_shard_announce(payload: bytes) -> tuple[str, list[int], int]:
    d = json.loads(payload)
    if d["op"] == OP_ANNOUNCE:
        return d["replica"], list(d["shards"]), d["generation"]
    raise ValueError(f"expected {OP_ANNOUNCE}, got {d['op']!r}")


# ------------------------------------------------------------------- scatter
def encode_scatter_request(request_id: str, shard_id: int,
                           seq_hashes: Sequence[int], generation: int,
                           reply_subject: str) -> bytes:
    return json.dumps({
        "op": "shard_scatter",
        "request_id": request_id,
        "shard": shard_id,
        "seq_hashes": list(seq_hashes),
        "generation": generation,
        "reply_subject": reply_subject,
    }, sort_keys=True).encode()


def decode_scatter_request(payload: bytes) -> tuple[str, int, list[int], int, str]:
    d = json.loads(payload)
    if d["op"] == OP_SCATTER:
        return (d["request_id"], d["shard"], list(d["seq_hashes"]),
                d["generation"], d["reply_subject"])
    raise ValueError(f"expected {OP_SCATTER}, got {d['op']!r}")


def encode_scatter_reply(request_id: str, reply: ShardReply) -> bytes:
    return json.dumps({
        "op": "shard_reply",
        "request_id": request_id,
        "shard": reply.shard_id,
        "generation": reply.generation,
        "holders": _pairs(reply.holders),
        "persist_holders": _pairs(reply.persist_holders),
    }, sort_keys=True).encode()


def decode_scatter_reply(payload: bytes) -> tuple[str, ShardReply]:
    d = json.loads(payload)
    if d["op"] == OP_REPLY:
        return d["request_id"], ShardReply(
            shard_id=d["shard"],
            generation=d["generation"],
            holders=_unpairs(d["holders"]),
            persist_holders=_unpairs(d["persist_holders"]),
        )
    raise ValueError(f"expected {OP_REPLY}, got {d['op']!r}")


# ------------------------------------------------------------------- handoff
def encode_shard_handoff(shard_id: int, generation: int, source: str,
                         device: Mapping[int, Sequence[int]],
                         persist: Mapping[int, Sequence[int]]) -> bytes:
    return json.dumps({
        "op": "shard_handoff",
        "shard": shard_id,
        "generation": generation,
        "source": source,
        "device": _pairs(device),
        "persist": _pairs(persist),
    }, sort_keys=True).encode()


def decode_shard_handoff(payload: bytes
                         ) -> tuple[int, int, str, dict, dict]:
    d = json.loads(payload)
    if d["op"] == OP_HANDOFF:
        device = {int(k): [int(w) for w in v] for k, v in d["device"]}
        persist = {int(k): [int(w) for w in v] for k, v in d["persist"]}
        return d["shard"], d["generation"], d["source"], device, persist
    raise ValueError(f"expected {OP_HANDOFF}, got {d['op']!r}")
