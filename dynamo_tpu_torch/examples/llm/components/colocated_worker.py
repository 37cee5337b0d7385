"""ColocatedWorker — BOTH disagg roles in ONE process.

The counterpart of the JAX package's
``examples/llm/components/colocated_worker.py``.  Hosting the prefill and
the decode engine in one process makes the decode worker's transfer URL
resolve to the in-process endpoint registry, so every KV handoff is a
block gather on the card feeding the decode engine's scatter, with no host
staging and no TCP (llm/kv/transfer.py LocalKvTransferClient; the
reference needs NIXL prepped descriptors for this, vllm patch nixl.py
+394).

What disaggregation still buys here: the decode engine's batches never
absorb prompt tokens — prompts run in a dedicated prefill engine with its
own cache sizing and batch shape, and decode ITL stays flat.  The
separate-process ``disagg.py`` graph moves every handoff over TCP.

Config keys: everything GpuWorker takes, plus a ``prefill.`` prefix to
override the prefill engine's sizing (defaults mirror the decode side).
"""

from __future__ import annotations

import asyncio
import logging

from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.sdk import async_on_start, dynamo_endpoint, service

from .worker import (
    NAMESPACE,
    backend_input,
    build_engine,
    resolve_cfg_model,
    stop_engine,
    wire_output,
)

log = logging.getLogger("dynamo_tpu_torch.examples.colocated_worker")


@service(dynamo={"namespace": NAMESPACE}, resources={"gpu": 1})
class ColocatedWorker:
    """Decode engine + DecodeWorker + prefill engine + PrefillWorker in
    one process: the same-card disaggregated serving unit."""

    def __init__(self):
        self._cfg = dict(self.service_config)
        self.engine = None          # DecodeWorker wrapping the decode engine
        self.prefill = None         # PrefillWorker loop
        self._prefill_task = None

    @async_on_start
    async def boot(self):
        from dynamo_tpu_torch.cli import attach_worker_publishers
        from dynamo_tpu_torch.llm.disagg_router import (
            DisaggregatedRouter,
            DisaggRouterConf,
        )
        from dynamo_tpu_torch.llm.workers import DecodeWorker
        from dynamo_tpu_torch.llm.workers import PrefillWorker as EnginePrefillWorker

        rt = self.dynamo_runtime
        cfg = await resolve_cfg_model(self._cfg, rt)
        # off-loop: each model build blocks for seconds (see worker.boot)
        decode_engine, self.card = await asyncio.to_thread(build_engine, cfg)
        # prefill engine: same model, its own cache/batch sizing
        pcfg = dict(cfg)
        for k, v in list(cfg.items()):
            if k.startswith("prefill."):
                pcfg[k[len("prefill."):]] = v
        prefill_engine, _ = await asyncio.to_thread(build_engine, pcfg)

        conf = DisaggRouterConf(
            max_local_prefill_length=int(cfg.get("max-local-prefill-length", 0)),
        )
        self.engine = await DecodeWorker(
            decode_engine,
            coordinator=rt.coordinator,
            namespace=NAMESPACE,
            router=DisaggregatedRouter(conf, namespace=NAMESPACE),
        ).start()
        self.prefill = EnginePrefillWorker(
            prefill_engine, rt.coordinator, NAMESPACE
        )
        self._prefill_task = asyncio.ensure_future(self.prefill.run())
        attach_worker_publishers(rt, self.engine, NAMESPACE)

    async def shutdown(self):
        if self.prefill is not None:
            self.prefill.request_stop()
        if self._prefill_task is not None:
            try:
                await asyncio.wait_for(self._prefill_task, timeout=2)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._prefill_task.cancel()
        await stop_engine(self.engine)
        if self.prefill is not None:
            await stop_engine(self.prefill.engine)

    @dynamo_endpoint
    async def generate(self, req: dict):
        ctx = Context(backend_input(req))
        async for out in self.engine.generate(ctx):
            yield wire_output(out)
            if out.finished:
                return
