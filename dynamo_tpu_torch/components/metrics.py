"""Standalone metrics aggregation component.

A copy of ``dynamo_tpu/components/metrics.py``: the same Prometheus text
for the same worker metrics and hit-rate events.

Reference parity: components/metrics/src/{lib,main}.rs — subscribes to
`kv_hit_rate` events and per-worker ForwardPassMetrics, aggregates, and
exposes Prometheus metrics (pull via /metrics; push mode posts the same
text body to a pushgateway URL, MetricsMode parity lib.rs:96).

Run via ``python -m dynamo_tpu_torch metrics --coordinator tcp://...`` or embed
MetricsService in-process (tests).
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from typing import Optional

from aiohttp import ClientSession, web

from dynamo_tpu_torch.llm.kv_router.publisher import metrics_subject
from dynamo_tpu_torch.llm.kv_router.scheduler import WorkerMetrics
from dynamo_tpu_torch.obs.metric_names import RouterMetric as RM

log = logging.getLogger("dynamo_tpu_torch.metrics")

__all__ = ["PrometheusMetricsCollector", "MetricsService"]


@dataclass
class _HitStats:
    decisions: int = 0
    isl_blocks: int = 0
    overlap_blocks: int = 0


class PrometheusMetricsCollector:
    """Aggregates worker metrics + hit-rate events; renders Prometheus text."""

    def __init__(self) -> None:
        self.workers: dict[int, WorkerMetrics] = {}
        self.hits: dict[int, _HitStats] = {}

    # ------------------------------------------------------------- ingestion
    def on_worker_metrics(self, m: WorkerMetrics) -> None:
        self.workers[m.worker_id] = m

    def on_hit_rate_event(self, worker_id: int, isl_blocks: int, overlap_blocks: int) -> None:
        s = self.hits.setdefault(worker_id, _HitStats())
        s.decisions += 1
        s.isl_blocks += isl_blocks
        s.overlap_blocks += overlap_blocks

    def remove_worker(self, worker_id: int) -> None:
        self.workers.pop(worker_id, None)

    # -------------------------------------------------------------- exposure
    def render(self) -> str:
        lines: list[str] = []

        def gauge(name: str, help_: str) -> None:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")

        gauge(RM.KV_BLOCKS_ACTIVE, "active KV blocks per worker")
        for wid, m in sorted(self.workers.items()):
            lines.append(f'{RM.KV_BLOCKS_ACTIVE}{{worker="{wid}"}} {m.kv_active_blocks}')
        gauge(RM.KV_BLOCKS_TOTAL, "total KV blocks per worker")
        for wid, m in sorted(self.workers.items()):
            lines.append(f'{RM.KV_BLOCKS_TOTAL}{{worker="{wid}"}} {m.kv_total_blocks}')
        gauge(RM.REQUEST_ACTIVE_SLOTS, "active request slots per worker")
        for wid, m in sorted(self.workers.items()):
            lines.append(f'{RM.REQUEST_ACTIVE_SLOTS}{{worker="{wid}"}} {m.request_active_slots}')
        gauge(RM.REQUESTS_WAITING, "queued requests per worker")
        for wid, m in sorted(self.workers.items()):
            lines.append(f'{RM.REQUESTS_WAITING}{{worker="{wid}"}} {m.num_requests_waiting}')
        gauge(RM.KV_CACHE_USAGE, "KV cache occupancy fraction per worker")
        for wid, m in sorted(self.workers.items()):
            lines.append(f'{RM.KV_CACHE_USAGE}{{worker="{wid}"}} {m.kv_usage:.6f}')

        lines.append(f"# HELP {RM.ROUTING_DECISIONS_TOTAL} KV-router decisions")
        lines.append(f"# TYPE {RM.ROUTING_DECISIONS_TOTAL} counter")
        for wid, s in sorted(self.hits.items()):
            lines.append(f'{RM.ROUTING_DECISIONS_TOTAL}{{worker="{wid}"}} {s.decisions}')
        lines.append(f"# HELP {RM.KV_HIT_RATE_PERCENT} cumulative prefix-hit rate")
        lines.append(f"# TYPE {RM.KV_HIT_RATE_PERCENT} gauge")
        for wid, s in sorted(self.hits.items()):
            rate = 100.0 * s.overlap_blocks / max(s.isl_blocks, 1)
            lines.append(f'{RM.KV_HIT_RATE_PERCENT}{{worker="{wid}"}} {rate:.3f}')
        return "\n".join(lines) + "\n"


class MetricsService:
    """Subscribes to the event plane and serves /metrics (pull) and/or pushes."""

    def __init__(
        self,
        coordinator,
        namespace: str = "default",
        host: str = "127.0.0.1",
        port: int = 9091,
        push_url: Optional[str] = None,
        push_interval_s: float = 5.0,
    ):
        self.coord = coordinator
        self.namespace = namespace
        self.host = host
        self.port = port
        self.push_url = push_url
        self.push_interval_s = push_interval_s
        self.collector = PrometheusMetricsCollector()
        self._subs: list[int] = []
        self._runner: Optional[web.AppRunner] = None
        self._push_task: Optional[asyncio.Task] = None

    # ---------------------------------------------------------- subscriptions
    def _on_metrics(self, subject: str, payload: bytes) -> None:
        try:
            self.collector.on_worker_metrics(WorkerMetrics(**json.loads(payload)))
        except Exception:
            log.exception("bad metrics payload on %s", subject)

    def _on_hit_rate(self, subject: str, payload: bytes) -> None:
        try:
            d = json.loads(payload)
            self.collector.on_hit_rate_event(
                d["worker_id"], d["isl_blocks"], d["overlap_blocks"]
            )
        except Exception:
            log.exception("bad hit-rate payload on %s", subject)

    # --------------------------------------------------------------- lifecycle
    async def start(self) -> "MetricsService":
        self._subs.append(
            await self.coord.subscribe(metrics_subject(self.namespace), self._on_metrics)
        )
        self._subs.append(
            await self.coord.subscribe(f"{self.namespace}.kv_hit_rate", self._on_hit_rate)
        )
        app = web.Application()
        app.router.add_get("/metrics", self._handle_metrics)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        self.port = self._runner.addresses[0][1]
        if self.push_url:
            self._push_task = asyncio.ensure_future(self._push_loop())
        return self

    async def stop(self) -> None:
        if self._push_task:
            self._push_task.cancel()
            try:
                await self._push_task
            except asyncio.CancelledError:
                pass
            self._push_task = None
        for sid in self._subs:
            try:
                await self.coord.unsubscribe(sid)
            except Exception:
                pass
        self._subs.clear()
        if self._runner:
            await self._runner.cleanup()
            self._runner = None

    async def _handle_metrics(self, request: web.Request) -> web.Response:
        return web.Response(text=self.collector.render(), content_type="text/plain")

    async def _push_loop(self) -> None:
        async with ClientSession() as session:
            while True:
                await asyncio.sleep(self.push_interval_s)
                try:
                    await session.post(self.push_url, data=self.collector.render())
                except asyncio.CancelledError:
                    raise
                except Exception:
                    log.warning("push to %s failed; retrying", self.push_url)
