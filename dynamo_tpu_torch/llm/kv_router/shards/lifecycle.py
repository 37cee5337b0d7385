"""Shard replica lifecycle: discovery, membership, handoff, fencing.

A copy of ``dynamo_tpu/llm/kv_router/shards/lifecycle.py`` over the port's
coordinator client.

Registration reuses the worker discovery-delete idiom exactly
(kv_router/metrics_aggregator.py KvRouterSubscriber): each router
replica `kv_put`s itself under ``routers_prefix`` bound to a lease, and
every participant — replicas and frontends alike — `watch`es the prefix.
A put means a replica joined; a lease-expiry delete means it died.
Either way every observer independently rebinds the ShardMap from the
same sorted replica set with the same consistent-hash ring, deriving the
generation from the membership itself (partition.membership_generation):
no coordinator-side logic, no leader, and no counter to disagree on.

Two ordering rules close two races: a joining replica subscribes to EVERY handoff subject before it
announces itself, so the frames its own join triggers cannot outrun the
subscription; and a handoff frame that arrives before the local rebind
that justifies it is stashed and re-judged after the rebind instead of
being dropped on the floor.

On a rebind, the OLD owner of each moved shard (if still alive) ships
its range snapshot as a handoff frame; the new owner imports it only if
the frame's generation matches its current map — a replica that was
partitioned away and comes back with pre-handoff state fails this fence
and its frames (and scatter replies) are dropped rather than merged.
If the old owner died there is nothing to ship and the new owner serves
the range cold, repopulating from the live event stream; the gather
side sees that only as temporarily lower overlap scores.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
from typing import Optional, Sequence

from dynamo_tpu_torch.engine.counters import kv_shard_counters
from dynamo_tpu_torch.llm.kv.events import event_from_wire
from dynamo_tpu_torch.llm.kv_router.shards.indexer import ShardedKvIndexer
from dynamo_tpu_torch.llm.kv_router.shards.partition import ShardMap
from dynamo_tpu_torch.llm.kv_router.shards.scatter import ShardReply, probe_shard
from dynamo_tpu_torch.llm.kv_router.shards.wire import (
    decode_scatter_reply,
    decode_scatter_request,
    decode_shard_handoff,
    encode_scatter_reply,
    encode_scatter_request,
    encode_shard_announce,
    encode_shard_handoff,
    shard_announce_subject,
    shard_handoff_subject,
    shard_scatter_subject,
)

log = logging.getLogger("dynamo_tpu_torch.kv_router")

__all__ = ["ShardReplica", "PubSubShardClient", "DEFAULT_ROUTERS_PREFIX"]

DEFAULT_ROUTERS_PREFIX = "/kv_routers"


class ShardReplica:
    """One router replica: hosts its owned shards' index ranges, serves
    scatter probes, and participates in membership + handoff."""

    def __init__(self, coordinator, replica_id: str, n_shards: int,
                 namespace: str = "default",
                 routers_prefix: str = DEFAULT_ROUTERS_PREFIX,
                 lease_ttl_s: float = 10.0):
        self.coord = coordinator
        self.replica_id = replica_id
        self.namespace = namespace
        self.routers_prefix = routers_prefix
        self.lease_ttl_s = lease_ttl_s
        self.index = ShardedKvIndexer(n_shards)
        self.map = ShardMap(n_shards)
        self._replicas: set[str] = set()
        self._lease: Optional[int] = None
        self._watch_id: Optional[int] = None
        self._subs: dict[int, int] = {}     # shard -> scatter sub id
        self._handoff_subs: dict[int, int] = {}
        self._ev_sub: Optional[int] = None
        # handoff frames that raced ahead of our own rebind, re-judged
        # after every membership change (shard -> latest frame)
        self._pending_handoffs: dict[int, tuple[int, str, dict, dict]] = {}
        # rebinds and scatter replies spawned from sync callbacks:
        # retained so failures are logged, drained on stop()
        self._bg_tasks: set[asyncio.Task] = set()

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_done)
        return task

    def _bg_done(self, task: asyncio.Task) -> None:
        self._bg_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            log.error("shard replica %s background task failed",
                      self.replica_id, exc_info=task.exception())

    # -------------------------------------------------------------- lifecycle
    async def start(self) -> "ShardReplica":
        # subscribe to every handoff subject BEFORE announcing: the old
        # owners ship the moment they see our membership put, and a
        # frame published before our subscription lands is lost forever
        for s in range(self.index.n_shards):
            self._handoff_subs[s] = await self.coord.subscribe(
                shard_handoff_subject(self.namespace, s), self._on_handoff)
        self._lease = await self.coord.lease_create(ttl=self.lease_ttl_s)
        await self.coord.kv_put(
            f"{self.routers_prefix}/{self.replica_id}",
            {"replica": self.replica_id, "n_shards": self.index.n_shards},
            lease_id=self._lease,
        )
        self._watch_id, existing = await self.coord.watch(
            self.routers_prefix, self._on_membership)
        replicas = {k.rsplit("/", 1)[-1] for k in (existing or {})}
        replicas.add(self.replica_id)
        await self._rebind(replicas, ship_handoffs=False)
        return self

    async def stop(self) -> None:
        for t in list(self._bg_tasks):
            t.cancel()
        if self._bg_tasks:
            await asyncio.gather(*self._bg_tasks, return_exceptions=True)
        for sub in list(self._subs.values()) + list(self._handoff_subs.values()):
            try:
                await self.coord.unsubscribe(sub)
            except (ConnectionError, RuntimeError):
                pass
        self._subs.clear()
        self._handoff_subs.clear()
        if self._ev_sub is not None:
            try:
                await self.coord.unsubscribe(self._ev_sub)
            except (ConnectionError, RuntimeError):
                pass
            self._ev_sub = None
        if self._watch_id is not None:
            try:
                await self.coord.unwatch(self._watch_id)
            except (ConnectionError, RuntimeError):
                pass
            self._watch_id = None
        if self._lease is not None:
            try:
                await self.coord.lease_revoke(self._lease)
            except (ConnectionError, RuntimeError):
                pass
            self._lease = None

    # ------------------------------------------------------------- membership
    def _on_membership(self, event: str, key: str, value) -> None:
        rid = key.rsplit("/", 1)[-1]
        replicas = set(self._replicas)
        if event == "put":
            replicas.add(rid)
        elif event == "delete":
            replicas.discard(rid)
        if replicas != self._replicas:
            self._spawn(self._rebind(replicas, ship_handoffs=True))

    async def _rebind(self, replicas: set[str], ship_handoffs: bool) -> None:
        old = self.map
        self._replicas = set(replicas)
        self.map = old.rebind(sorted(replicas))
        self.index.generation = self.map.generation
        kv_shard_counters.set_generation(self.map.generation)
        moved = old.moved_shards(self.map)
        await self._resubscribe()
        await self.coord.publish(
            shard_announce_subject(self.namespace),
            encode_shard_announce(self.replica_id,
                                  self.map.shards_of(self.replica_id),
                                  self.map.generation))
        if ship_handoffs:
            for s in moved:
                if (old.owner(s) == self.replica_id
                        and self.map.owner(s) != self.replica_id):
                    device, persist = self.index.export_shard(s)
                    await self.coord.publish(
                        shard_handoff_subject(self.namespace, s),
                        encode_shard_handoff(s, self.map.generation,
                                             self.replica_id, device, persist))
        # re-judge frames that arrived before this rebind
        for s in sorted(self._pending_handoffs):
            generation, source, device, persist = self._pending_handoffs[s]
            if generation != self.map.generation:
                continue
            del self._pending_handoffs[s]
            if (source != self.replica_id
                    and self.map.owner(s) == self.replica_id):
                self.index.import_shard(s, device, persist)

    async def _resubscribe(self) -> None:
        owned = set(self.map.shards_of(self.replica_id))
        for s in list(self._subs):
            if s not in owned:
                await self.coord.unsubscribe(self._subs.pop(s))
        for s in sorted(owned - set(self._subs)):
            self._subs[s] = await self.coord.subscribe(
                shard_scatter_subject(self.namespace, s), self._on_scatter)
        for s in list(self._handoff_subs):
            if s not in owned:
                await self.coord.unsubscribe(self._handoff_subs.pop(s))
        for s in sorted(owned - set(self._handoff_subs)):
            self._handoff_subs[s] = await self.coord.subscribe(
                shard_handoff_subject(self.namespace, s), self._on_handoff)

    # ---------------------------------------------------------------- serving
    def _on_scatter(self, subject: str, payload: bytes) -> None:
        try:
            request_id, shard_id, seq_hashes, _gen, reply_subject = (
                decode_scatter_request(payload))
        except Exception:
            log.exception("bad scatter request on %s", subject)
            return
        # reply with OUR generation — the gatherer's fence decides; a
        # replica that lags a membership change must not forge currency
        reply = probe_shard(self.index.shard(shard_id), shard_id,
                            self.index.n_shards, seq_hashes,
                            self.map.generation)
        self._spawn(self.coord.publish(
            reply_subject, encode_scatter_reply(request_id, reply)))

    def _on_handoff(self, subject: str, payload: bytes) -> None:
        try:
            shard_id, generation, source, device, persist = (
                decode_shard_handoff(payload))
        except Exception:
            log.exception("bad handoff frame on %s", subject)
            return
        if source == self.replica_id:
            return
        if generation != self.map.generation:
            # either stale (will never match — bounded stash, one frame
            # per shard) or ahead of our own rebind (re-judged there)
            self._pending_handoffs[shard_id] = (
                generation, source, device, persist)
            return
        if self.map.owner(shard_id) != self.replica_id:
            return
        self.index.import_shard(shard_id, device, persist)

    # ------------------------------------------------------------ event plane
    async def subscribe_events(self, events_subject: str) -> None:
        """Feed this replica from the worker KV event plane; the sharded
        indexer's split keeps only owned ranges hot (a replica also
        indexes ranges it may inherit later — memory is bounded by the
        same eviction events workers publish)."""
        def _on_event(subject: str, payload: bytes) -> None:
            try:
                event_id, worker_id, ev = event_from_wire(json.loads(payload))
                self.index.apply_event(worker_id, ev, event_id=event_id)
            except Exception:
                log.exception("bad kv event on %s", subject)

        self._ev_sub = await self.coord.subscribe(events_subject, _on_event)


class PubSubShardClient:
    """ShardClient over the coordinator's pub/sub plane: publishes a
    scatter request on the shard's subject and waits for the reply on a
    private inbox subject.  Request ids are a per-client counter, so
    they are deterministic."""

    _ids = itertools.count(1)

    def __init__(self, coordinator, namespace: str, shard_id: int,
                 client_id: str):
        self.coord = coordinator
        self.namespace = namespace
        self.shard_id = shard_id
        self.client_id = client_id
        self._inbox = f"{namespace}.kv_shards.inbox.{client_id}.{shard_id}"
        self._sub: Optional[int] = None
        self._pending: dict[str, asyncio.Future] = {}

    def _on_reply(self, subject: str, payload: bytes) -> None:
        try:
            request_id, reply = decode_scatter_reply(payload)
        except Exception:
            log.exception("bad scatter reply on %s", subject)
            return
        fut = self._pending.pop(request_id, None)
        if fut is not None and not fut.done():
            fut.set_result(reply)

    async def start(self) -> "PubSubShardClient":
        self._sub = await self.coord.subscribe(self._inbox, self._on_reply)
        return self

    async def stop(self) -> None:
        if self._sub is not None:
            try:
                await self.coord.unsubscribe(self._sub)
            except (ConnectionError, RuntimeError):
                pass
            self._sub = None
        for fut in self._pending.values():
            if not fut.done():
                fut.cancel()
        self._pending.clear()

    async def probe(self, seq_hashes: Sequence[int],
                    generation: int) -> ShardReply:
        request_id = f"{self.client_id}:{self.shard_id}:{next(self._ids)}"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[request_id] = fut
        try:
            await self.coord.publish(
                shard_scatter_subject(self.namespace, self.shard_id),
                encode_scatter_request(request_id, self.shard_id,
                                       seq_hashes, generation, self._inbox))
            return await fut
        finally:
            self._pending.pop(request_id, None)
