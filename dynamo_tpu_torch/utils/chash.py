"""Consistent-hash ring for control-plane ownership.

A copy of the JAX package's ``utils/chash.py``: the same points and owners
for the same members and keys.  The HTTP frontends map session keys to
the frontend that terminated the session's earlier turns
(llm/http/affinity.py SessionAffinity), and the sharded router maps
index shards to router replicas with it (llm/kv_router/shards/partition.py
ShardMap).  The ring keeps two properties:

  * **uniformity** — with ``vnodes`` virtual points per node, key mass
    per node stays within a bounded factor of fair share;
  * **minimal movement** — adding or removing one node reassigns only
    the keys that land on that node's arcs (~1/n of the keyspace), so a
    frontend restart invalidates one frontend's sessions, not all of
    them.

Hashing is xxh3-64 (dynamo_tpu_torch.tokens.compute_hash) over UTF-8 key
bytes — the same primitive the block index keys on, so the ring adds no
new hash dependency and stays deterministic across processes.
"""

from __future__ import annotations

import bisect
from typing import Iterable, Optional

from dynamo_tpu_torch.tokens import compute_hash

__all__ = ["HashRing"]

# ring points are salted per vnode; 64 points/node keeps the max/mean
# node load under ~1.35 for the fleet sizes the control plane runs
# (2-16 frontends/replicas; ~1.5 by 64 nodes)
_DEFAULT_VNODES = 64


class HashRing:
    """Deterministic consistent-hash ring over string node ids."""

    def __init__(self, nodes: Iterable[str] = (),
                 vnodes: int = _DEFAULT_VNODES):
        if vnodes <= 0:
            raise ValueError("vnodes must be positive")
        self.vnodes = vnodes
        self._nodes: set[str] = set()
        self._points: list[int] = []       # sorted ring positions
        self._owners: dict[int, str] = {}  # position -> node id
        for n in nodes:
            self.add(n)

    # ------------------------------------------------------------ membership
    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for v in range(self.vnodes):
            p = compute_hash(f"{node}#{v}".encode())
            # collisions resolve by smallest node id so two processes
            # building the same ring always agree on the owner
            cur = self._owners.get(p)
            if cur is None:
                bisect.insort(self._points, p)
                self._owners[p] = node
            elif node < cur:
                self._owners[p] = node

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        for v in range(self.vnodes):
            p = compute_hash(f"{node}#{v}".encode())
            if self._owners.get(p) == node:
                del self._owners[p]
                i = bisect.bisect_left(self._points, p)
                if i < len(self._points) and self._points[i] == p:
                    self._points.pop(i)

    def nodes(self) -> set[str]:
        return set(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    # ---------------------------------------------------------------- lookup
    def lookup(self, key: str) -> Optional[str]:
        """The node owning ``key`` — the first ring point clockwise from
        the key's hash (wrapping), or None on an empty ring."""
        if not self._points:
            return None
        h = compute_hash(key.encode() if isinstance(key, str) else key)
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):
            i = 0
        return self._owners[self._points[i]]
