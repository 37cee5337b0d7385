"""PrefillWorker — disagg prefill side of the example graphs.

The counterpart of the JAX package's
``examples/llm/components/prefill_worker.py``.  Pulls remote-prefill work
from the coordinator queue, computes KV, pushes blocks to the decode
worker's transfer endpoint (an on-card copy when both engines share this
process, TCP otherwise) and notifies.  Its ``status`` endpoint reports the
prompts it handled and the kernels this process launched.  Reference analogue:
examples/llm/components/prefill_worker.py.
"""

from __future__ import annotations

import asyncio
import logging

from dynamo_tpu_torch.ops.kernels import launch_counts
from dynamo_tpu_torch.sdk import async_on_start, dynamo_endpoint, service

from .worker import NAMESPACE, build_engine, resolve_cfg_model, stop_engine

log = logging.getLogger("dynamo_tpu_torch.examples.prefill_worker")


@service(dynamo={"namespace": NAMESPACE}, resources={"gpu": 1})
class PrefillWorker:
    def __init__(self):
        self._cfg = dict(self.service_config)
        self._task = None
        self.worker = None

    @async_on_start
    async def boot(self):
        from dynamo_tpu_torch.llm.workers import PrefillWorker as EnginePrefillWorker

        rt = self.dynamo_runtime
        # off-loop: the model build blocks for seconds (see worker.boot)
        engine, _card = await asyncio.to_thread(
            build_engine, await resolve_cfg_model(self._cfg, rt))
        self.worker = EnginePrefillWorker(engine, rt.coordinator, NAMESPACE)
        self._task = asyncio.ensure_future(self.worker.run())

    async def shutdown(self):
        if self.worker is not None:
            self.worker.request_stop()
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, timeout=2)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._task.cancel()
        if self.worker is not None:
            await stop_engine(self.worker.engine)

    @dynamo_endpoint
    async def status(self, req: dict):
        yield {"handled": self.worker.handled if self.worker else 0,
               "launches": launch_counts()}
