"""Router-side aggregation: worker metrics + KV events off the event plane.

The counterpart of ``dynamo_tpu/llm/kv_router/metrics_aggregator.py``,
over the port's ``runtime/transports/coordinator.py`` client (the same
wire, so either package's router reads either package's workers).
Reference parity: lib/llm/src/kv_router/metrics_aggregator.rs:26-82
(KvMetricsAggregator / collect_endpoints_task) and the KvRouter event
subscription loop (kv_router.rs:97-118 → indexer apply_event).

`KvRouterSubscriber` is the one-call wiring that makes a KvRouter live on a
coordinator: it subscribes to kv_events (feeding the indexer), kv_metrics
(feeding the scheduler's cost model), and prunes workers whose metrics went
stale (lease-expiry analogue for the metrics plane).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Callable, Optional

from dynamo_tpu_torch.llm.kv.events import event_from_wire
from dynamo_tpu_torch.llm.kv_router.publisher import events_subject, metrics_subject
from dynamo_tpu_torch.llm.kv_router.router import KvRouter
from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler, WorkerMetrics

log = logging.getLogger("dynamo_tpu_torch.kv_router")

__all__ = ["KvMetricsAggregator", "KvRouterSubscriber"]


class KvMetricsAggregator:
    """Collects per-worker ForwardPassMetrics into a scheduler."""

    def __init__(
        self,
        coordinator,
        scheduler: KvScheduler,
        namespace: str = "default",
        stale_after_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.coord = coordinator
        self.scheduler = scheduler
        self.namespace = namespace
        self.stale_after_s = stale_after_s
        # injectable clock (tests reap at a virtual time)
        self._clock = clock
        self._sub_id: Optional[int] = None
        self._reaper: Optional[asyncio.Task] = None

    def _on_metrics(self, subject: str, payload: bytes) -> None:
        try:
            d = json.loads(payload)
            m = WorkerMetrics(**d)
            m.updated_at = self._clock()   # receipt time, aggregator clock
            self.scheduler.update_worker(m)
        except Exception:
            log.exception("bad metrics payload on %s", subject)

    async def _reap_stale(self) -> None:
        while True:
            await asyncio.sleep(self.stale_after_s / 2)
            now = self._clock()
            for wid, m in list(self.scheduler.workers().items()):
                if now - m.updated_at > self.stale_after_s:
                    log.warning("worker %s metrics stale; dropping from scheduler", wid)
                    self.scheduler.remove_worker(wid)

    async def start(self) -> "KvMetricsAggregator":
        self._sub_id = await self.coord.subscribe(
            metrics_subject(self.namespace), self._on_metrics
        )
        self._reaper = asyncio.ensure_future(self._reap_stale())
        return self

    async def stop(self) -> None:
        if self._reaper:
            self._reaper.cancel()
            try:
                await self._reaper
            except asyncio.CancelledError:
                pass
            self._reaper = None
        if self._sub_id is not None:
            await self.coord.unsubscribe(self._sub_id)
            self._sub_id = None


class KvRouterSubscriber:
    """Makes a KvRouter live: events → indexer, metrics → scheduler,
    hit-rate decisions → `{ns}.kv_hit_rate` for the metrics component,
    and (``workers_prefix``) discovery deletes → worker teardown, so a
    dead worker stops attracting prefix-hit routing the moment its lease
    expires instead of lingering until its metrics go stale."""

    def __init__(
        self,
        router: KvRouter,
        coordinator,
        namespace: str = "default",
        hit_rate_flush_s: float = 1.0,
        workers_prefix: Optional[str] = None,
    ):
        self.router = router
        self.coord = coordinator
        self.namespace = namespace
        self.hit_rate_flush_s = hit_rate_flush_s
        self.workers_prefix = workers_prefix
        self.aggregator = KvMetricsAggregator(coordinator, router.scheduler, namespace)
        self._ev_sub: Optional[int] = None
        self._watch_id: Optional[int] = None
        self._hit_task: Optional[asyncio.Task] = None

    def _on_discovery(self, event: str, key: str, value) -> None:
        if event != "delete":
            return
        try:
            wid = int(key.rsplit("/", 1)[-1], 16)
        except ValueError:
            return
        log.info("worker %x left discovery; removing from router", wid)
        self.router.remove_worker(wid)

    def _on_event(self, subject: str, payload: bytes) -> None:
        try:
            event_id, worker_id, ev = event_from_wire(json.loads(payload))
            self.router.indexer.apply_event(worker_id, ev, event_id=event_id)
        except Exception:
            log.exception("bad kv event on %s", subject)

    async def _flush_hit_events(self) -> None:
        while True:
            await asyncio.sleep(self.hit_rate_flush_s)
            try:
                for ev in self.router.scheduler.drain_hit_events():
                    await self.coord.publish(
                        f"{self.namespace}.kv_hit_rate",
                        json.dumps(
                            {
                                "worker_id": ev.worker_id,
                                "isl_blocks": ev.isl_blocks,
                                "overlap_blocks": ev.overlap_blocks,
                            }
                        ).encode(),
                    )
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("hit-rate flush failed; retrying")

    async def start(self) -> "KvRouterSubscriber":
        self._ev_sub = await self.coord.subscribe(
            events_subject(self.namespace), self._on_event
        )
        if self.workers_prefix:
            self._watch_id, _ = await self.coord.watch(
                self.workers_prefix, self._on_discovery
            )
        await self.aggregator.start()
        self._hit_task = asyncio.ensure_future(self._flush_hit_events())
        return self

    async def stop(self) -> None:
        if self._watch_id is not None:
            try:
                await self.coord.unwatch(self._watch_id)
            except (ConnectionError, RuntimeError):
                pass
            self._watch_id = None
        if self._hit_task:
            self._hit_task.cancel()
            try:
                await self._hit_task
            except asyncio.CancelledError:
                pass
            self._hit_task = None
        await self.aggregator.stop()
        if self._ev_sub is not None:
            await self.coord.unsubscribe(self._ev_sub)
            self._ev_sub = None
