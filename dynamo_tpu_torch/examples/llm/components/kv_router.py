"""Router — KV-aware worker selection for the *_router example graphs.

The counterpart of the JAX package's
``examples/llm/components/kv_router.py``.  Wraps the KvRouter
(chained-hash prefix index + cost-model scheduler) and keeps it live off
the coordinator's KV-event / metrics subjects.  The Processor consults
`route` and then direct-dials the chosen GpuWorker instance.  Reference
analogue: examples/llm/components/kv_router.py +
components/router/src/main.rs.
"""

from __future__ import annotations

import asyncio
import logging

from dynamo_tpu_torch.sdk import async_on_start, dynamo_endpoint, service

from .worker import NAMESPACE

log = logging.getLogger("dynamo_tpu_torch.examples.kv_router")


@service(dynamo={"namespace": NAMESPACE})
class Router:
    def __init__(self):
        self._cfg = dict(self.service_config)
        self.router = None

    @async_on_start
    async def boot(self):
        from dynamo_tpu_torch import native
        from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvRouterSubscriber
        from dynamo_tpu_torch.llm.kv_router.router import KvRouter

        # the router's native index: build (or load) the host library off the loop
        await asyncio.to_thread(native.load)
        self.router = KvRouter(block_size=int(self._cfg.get("block-size", 16)))
        self.subscriber = await KvRouterSubscriber(
            self.router, self.dynamo_runtime.coordinator, NAMESPACE
        ).start()

    async def shutdown(self):
        if getattr(self, "subscriber", None) is not None:
            await self.subscriber.stop()

    @dynamo_endpoint
    async def route(self, req: dict):
        # delegate to the library's AsyncEngine surface so the decision
        # wire contract ({worker_id, overlap_*}, worker_id=None on cold
        # start) has exactly one definition (llm/kv_router/router.py)
        from dynamo_tpu_torch.runtime.engine import Context

        async for decision in self.router.generate(Context(req)):
            yield decision
