"""Processor — request preprocessing + worker routing for the example
graphs (the counterpart of the JAX package's
``examples/llm/components/processor.py``; reference analogue:
examples/llm/components/processor.py).

Takes an OpenAI-ish request dict ({prompt_token_ids | prompt, sampling,
stops}), tokenizes when a tokenizer is configured, picks a worker (KV-aware
via the Router component when ``router: kv``, else the client's built-in
routing), and streams the worker's deltas back, each decoded on its own
when a tokenizer is configured.
"""

from __future__ import annotations

import logging

from dynamo_tpu_torch.sdk import async_on_start, dynamo_endpoint, service
from dynamo_tpu_torch.sdk.service import ServiceClient

from .worker import NAMESPACE, GpuWorker

log = logging.getLogger("dynamo_tpu_torch.examples.processor")


def worker_payload(req: dict, tokenizer) -> dict:
    """The worker's request for one Processor request: token ids (the
    prompt tokenized when no ids were sent), sampling, stops, model."""
    token_ids = req.get("prompt_token_ids")
    if token_ids is None:
        if tokenizer is None:
            raise ValueError(
                "text prompt needs a configured tokenizer; send "
                "prompt_token_ids instead"
            )
        token_ids = tokenizer.encode(req["prompt"])
    return {
        "token_ids": list(map(int, token_ids)),
        "sampling": req.get("sampling", {}),
        "stops": req.get("stops", {}),
        "model": req.get("model", ""),
    }


def with_text(out: dict, tokenizer) -> dict:
    """A worker delta with its own tokens decoded into ``text``."""
    if tokenizer is not None and out.get("token_ids") and "text" not in out:
        out["text"] = tokenizer.decode(out["token_ids"])
    return out


@service(dynamo={"namespace": NAMESPACE})
class Processor:
    def __init__(self):
        self._cfg = dict(self.service_config)
        self.tokenizer = None
        self.router_client = None

    @async_on_start
    async def boot(self):
        rt = self.dynamo_runtime
        # the worker this processor targets comes from ITS outgoing link
        # edge in the serving graph (Frontend.link(Processor).link(X)) —
        # a YAML `worker:` key overrides for ad-hoc wiring
        worker_cls = None
        if self._cfg.get("worker") == "colocated":
            from .colocated_worker import ColocatedWorker

            worker_cls = ColocatedWorker
        elif self._cfg.get("worker") in (None, "gpu"):
            svc = getattr(self, "dynamo_service", None)
            graph = getattr(self, "dynamo_graph", None)
            if svc is not None and self._cfg.get("worker") is None:
                # only generate-serving link targets qualify: in router
                # graphs the processor's edge goes to the Router (whose
                # `route` endpoint is consulted separately)
                linked = [
                    t for t, m in svc._links
                    if (graph is None or m == graph)
                    and any(e.name == "generate" for e in t.endpoints)
                ]
                if linked:
                    worker_cls = linked[0]
        self.worker_client = ServiceClient(rt, worker_cls or GpuWorker)
        if self._cfg.get("router") == "kv":
            from .kv_router import Router

            self.router_client = ServiceClient(rt, Router)
        tok = self._cfg.get("tokenizer")
        if tok:
            from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper

            self.tokenizer = TokenizerWrapper.from_file(tok)

    async def shutdown(self):
        await self.worker_client.close()
        if self.router_client is not None:
            await self.router_client.close()

    async def _pick_instance(self, token_ids):
        if self.router_client is None:
            return None
        try:
            async for d in self.router_client.route({"token_ids": token_ids}):
                return d.get("worker_id")
        except Exception:
            log.exception("router unavailable; falling back to default routing")
        return None

    async def _direct_with_fallback(self, payload: dict, instance: int):
        """Stream from the router-pinned instance; if the dial fails
        before ANY output (stale/undiscovered worker id), re-dispatch via
        default routing — nothing was streamed, so the retry is safe."""
        started = False
        try:
            async for out in self.worker_client.generate.direct(
                    payload, instance):
                started = True
                yield out
            return
        except (KeyError, OSError):
            # dial failures only (OSError covers ConnectionError plus
            # gaierror/EHOSTUNREACH-class failures from open_connection) —
            # request-level errors (validation, serialization) would fail
            # identically on any worker and must surface, not retry
            if started:
                raise
            log.warning("direct dial to %x failed; rerouting", instance,
                        exc_info=True)
        async for out in self.worker_client.generate(payload):
            yield out

    @dynamo_endpoint
    async def process(self, req: dict):
        payload = worker_payload(req, self.tokenizer)
        instance = await self._pick_instance(payload["token_ids"])
        stream = (
            self._direct_with_fallback(payload, instance)
            if instance is not None
            else self.worker_client.generate(payload)
        )
        async for out in stream:
            yield with_text(out, self.tokenizer)
            if out.get("finish_reason"):
                return
