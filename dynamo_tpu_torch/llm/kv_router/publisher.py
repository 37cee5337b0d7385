"""Worker-side publishers: KV cache events + forward-pass metrics.

The counterpart of ``dynamo_tpu/llm/kv_router/publisher.py``, with its
subjects and payloads.  Workers publish two things the router needs:

  * **KV events** (``{ns}.kv_events.{worker_id}``): Stored/Removed block
    events, consumed by the router's KvIndexer to keep the global prefix
    index fresh.
  * **ForwardPassMetrics** (``{ns}.kv_metrics.{worker_id}``): load snapshot
    (active slots, kv blocks, queue depth) scraped into the scheduler's
    cost model, on the coordinator's pub/sub plane.

Events come from the block manager's ``event_sink`` (and the engine's
persist-tier events) and, as in the JAX publisher, from a native C++
event queue when one is given (``native_queue``, a
``dynamo_tpu_torch.native.NativeEventQueue``: the C-bindings surface a
native engine publishes into), drained first on the same cadence.  The
engine thread appends to the buffer and ``flush`` swaps it out on the
event loop: a list append and a rebinding, each atomic under the GIL, so
neither side takes a lock the other could block on.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
from typing import Callable, Optional

from dynamo_tpu_torch import native
from dynamo_tpu_torch.llm.kv.events import (KvCacheEvent, KvRemovedEvent, KvStoredEvent,
                                            event_to_wire)
from dynamo_tpu_torch.llm.kv_router.scheduler import WorkerMetrics

log = logging.getLogger("dynamo_tpu_torch.kv_router")

__all__ = ["KvEventPublisher", "KvMetricsPublisher", "metrics_subject", "events_subject"]


def events_subject(namespace: str, worker_id: int | str = "") -> str:
    base = f"{namespace}.kv_events"
    return f"{base}.{worker_id}" if worker_id != "" else f"{base}.>"


def metrics_subject(namespace: str, worker_id: int | str = "") -> str:
    base = f"{namespace}.kv_metrics"
    return f"{base}.{worker_id}" if worker_id != "" else f"{base}.>"


class KvEventPublisher:
    """Buffers engine KV events and flushes them to the event plane.

    Hook `publisher.sink` up as the KvBlockManager's ``event_sink``; call
    ``start()`` to flush on a cadence, or ``flush()`` manually (tests).
    Event ids are monotonically increasing per worker so the indexer can
    spot gaps (ref RouterEvent ordering).
    """

    def __init__(
        self,
        coordinator,
        worker_id: int,
        namespace: str = "default",
        flush_interval_s: float = 0.05,
        native_queue=None,  # Optional[native.NativeEventQueue]
    ):
        self.coord = coordinator
        self.worker_id = worker_id
        self.namespace = namespace
        self.flush_interval_s = flush_interval_s
        self.native_queue = native_queue
        self._buf: list[KvCacheEvent] = []
        self._next_event_id = 0
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    # The engine thread calls this synchronously from the block manager.
    def sink(self, ev: KvCacheEvent) -> None:
        self._buf.append(ev)

    def _drain_native(self) -> None:
        if self.native_queue is None:
            return
        for kind, parent, hashes in self.native_queue.drain():
            if kind == native.EVENT_STORED:
                self._buf.append(KvStoredEvent(block_hashes=hashes, parent_hash=parent or None))
            else:
                self._buf.append(KvRemovedEvent(block_hashes=hashes))

    async def flush(self) -> int:
        """Publish all buffered events; returns how many went out."""
        self._drain_native()
        if not self._buf:
            return 0
        batch, self._buf = self._buf, []
        subject = events_subject(self.namespace, self.worker_id)
        for ev in batch:
            wire = event_to_wire(self._next_event_id, self.worker_id, ev)
            self._next_event_id += 1
            await self.coord.publish(subject, wire)
        return len(batch)

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.flush_interval_s)
            try:
                await self.flush()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("kv event flush failed; retrying")

    def start(self) -> "KvEventPublisher":
        self._task = asyncio.ensure_future(self._run())
        return self

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self.flush()


class KvMetricsPublisher:
    """Periodically publishes a worker's ForwardPassMetrics snapshot.

    ``source()`` returns the raw dict (EngineCore.metrics() shape); extra
    identity fields are attached here.
    """

    def __init__(
        self,
        coordinator,
        worker_id: int,
        source: Callable[[], dict],
        namespace: str = "default",
        interval_s: float = 1.0,
    ):
        self.coord = coordinator
        self.worker_id = worker_id
        self.source = source
        self.namespace = namespace
        self.interval_s = interval_s
        self._task: Optional[asyncio.Task] = None

    def snapshot(self) -> WorkerMetrics:
        raw = dict(self.source())
        known = {f.name for f in dataclasses.fields(WorkerMetrics)}
        return WorkerMetrics(
            worker_id=self.worker_id,
            **{k: v for k, v in raw.items() if k in known and k != "worker_id"},
        )

    async def publish_once(self) -> None:
        m = self.snapshot()
        payload = dataclasses.asdict(m)
        payload.pop("updated_at", None)
        await self.coord.publish(
            metrics_subject(self.namespace, self.worker_id),
            json.dumps(payload).encode(),
        )

    async def _run(self) -> None:
        while True:
            try:
                await self.publish_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("metrics publish failed; retrying")
            await asyncio.sleep(self.interval_s)

    def start(self) -> "KvMetricsPublisher":
        self._task = asyncio.ensure_future(self._run())
        return self

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
