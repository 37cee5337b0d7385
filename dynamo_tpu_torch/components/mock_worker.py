"""Mock worker: fake ForwardPassMetrics + KV events, no GPU required.

A copy of ``dynamo_tpu/components/mock_worker.py``: for the same worker id
and seed it publishes the same metrics and KV events.

Reference parity: components/metrics/src/bin/mock_worker.rs — lets the
whole metrics + router stack run on a laptop: the mock publishes plausible
load metrics and stored/removed block events, so a KvRouterSubscriber and
MetricsService behave exactly as with real engines.

Run via ``python -m dynamo_tpu_torch mock-worker --coordinator tcp://...`` or embed
(tests).
"""

from __future__ import annotations

import asyncio
import random
from typing import Optional

from dynamo_tpu_torch.llm.kv.events import KvRemovedEvent, KvStoredEvent
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, KvMetricsPublisher
from dynamo_tpu_torch.tokens import sequence_hashes

__all__ = ["MockWorker"]


class MockWorker:
    def __init__(
        self,
        coordinator,
        worker_id: int,
        namespace: str = "default",
        block_size: int = 16,
        total_blocks: int = 256,
        interval_s: float = 0.2,
        seed: Optional[int] = None,
    ):
        self.worker_id = worker_id
        self.block_size = block_size
        self.total_blocks = total_blocks
        self.interval_s = interval_s
        self._rng = random.Random(seed if seed is not None else worker_id)
        self._resident: list[int] = []  # block hashes currently "stored"
        self._active_slots = 0
        self.events = KvEventPublisher(
            coordinator, worker_id, namespace, flush_interval_s=interval_s / 2
        )
        self.metrics = KvMetricsPublisher(
            coordinator, worker_id, self._snapshot, namespace, interval_s=interval_s
        )
        self._task: Optional[asyncio.Task] = None

    def _snapshot(self) -> dict:
        return {
            "request_active_slots": self._active_slots,
            "request_total_slots": 8,
            "kv_active_blocks": len(self._resident),
            "kv_total_blocks": self.total_blocks,
            "num_requests_waiting": self._rng.randrange(0, 3),
            "cache_hit_rate": self._rng.random(),
        }

    def _tick(self) -> None:
        """One simulated engine step: maybe store a new sequence's blocks,
        maybe evict old ones — same event shapes a real engine emits."""
        self._active_slots = self._rng.randrange(0, 8)
        if self._rng.random() < 0.7:
            prompt = [self._rng.randrange(1000) for _ in range(self.block_size * self._rng.randrange(1, 5))]
            hashes = sequence_hashes(prompt, self.block_size)
            self._resident.extend(hashes)
            self.events.sink(KvStoredEvent(block_hashes=hashes))
        while len(self._resident) > self.total_blocks:
            evict = self._resident[: self.block_size]
            del self._resident[: self.block_size]
            self.events.sink(KvRemovedEvent(block_hashes=evict))

    async def _run(self) -> None:
        while True:
            self._tick()
            await asyncio.sleep(self.interval_s)

    async def start(self) -> "MockWorker":
        self.events.start()
        self.metrics.start()
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
        await self.events.stop()
        await self.metrics.stop()
