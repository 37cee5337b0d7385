"""Frontend — OpenAI HTTP entry of the example graphs.

The counterpart of the JAX package's
``examples/llm/components/frontend.py``: runs the port's HttpService (SSE
streaming, metrics, health) and bridges ParsedRequest → the Processor
component over the distributed runtime.  Reference analogue:
examples/llm/components/frontend.py.

An ``admission:`` block in the config (``planner.AdmissionConfig.from_dict``:
rate limits, priority classes, deadline-aware shedding) puts an
``AdmissionController`` in front of the HttpService, as in the JAX
frontend.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import AsyncIterator

from dynamo_tpu_torch.llm.openai import ParsedRequest
from dynamo_tpu_torch.llm.preprocessor import PromptFormatter
from dynamo_tpu_torch.llm.protocols import FinishReason, LLMEngineOutput
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.sdk import async_on_start, dynamo_endpoint, service
from dynamo_tpu_torch.sdk.service import ServiceClient

from .processor import Processor
from .worker import NAMESPACE

log = logging.getLogger("dynamo_tpu_torch.examples.frontend")


def _clean(d: dict) -> dict:
    return {k: v for k, v in d.items() if v is not None}


def processor_request(parsed: ParsedRequest, formatter: PromptFormatter) -> dict:
    """The Processor's request for one parsed OpenAI request: a chat
    rendered to a prompt, a completion's token ids or text."""
    req: dict = {
        "model": parsed.model,
        "sampling": _clean(dataclasses.asdict(parsed.sampling)),
        "stops": _clean(dataclasses.asdict(parsed.stops)),
    }
    if parsed.is_chat:
        req["prompt"] = formatter.render(parsed.messages)
    elif parsed.prompt_token_ids is not None:
        req["prompt_token_ids"] = list(parsed.prompt_token_ids)
    else:
        req["prompt"] = parsed.prompt
    return req


class _ProcessorEngine(AsyncEngine):
    """AsyncEngine adapter: ParsedRequest → Processor.process stream."""

    def __init__(self, client: ServiceClient):
        self.client = client
        self.formatter = PromptFormatter(None)

    def generate(self, request: Context) -> AsyncIterator[LLMEngineOutput]:
        return self._run(request)

    async def _run(self, request: Context) -> AsyncIterator[LLMEngineOutput]:
        req = processor_request(request.data, self.formatter)
        async for out in self.client.process(req):
            if request.is_killed:
                return
            fr = out.get("finish_reason")
            yield LLMEngineOutput(
                token_ids=list(out.get("token_ids", [])),
                text=out.get("text"),
                finish_reason=FinishReason(fr) if fr else None,
                cached_tokens=out.get("cached_tokens", 0),
            )
            if fr:
                return


@service(dynamo={"namespace": NAMESPACE})
class Frontend:
    def __init__(self):
        self._cfg = dict(self.service_config)
        self.http = None
        self.client = None

    @async_on_start
    async def boot(self):
        from dynamo_tpu_torch.llm.http import HttpService, ModelManager

        self.client = ServiceClient(self.dynamo_runtime, Processor)
        manager = ModelManager()
        manager.add_model(
            self._cfg.get("served_model_name", "dynamo-tpu"),
            _ProcessorEngine(self.client),
        )
        # SLA admission control: an `admission:` block enables rate
        # limits, priority classes and deadline-aware 429 shedding
        admission = None
        adm = self._cfg.get("admission")
        if adm:
            from dynamo_tpu_torch.planner import AdmissionConfig, AdmissionController

            admission = AdmissionController(AdmissionConfig.from_dict(adm))
        self.http = HttpService(
            manager,
            host=self._cfg.get("host", "127.0.0.1"),
            port=int(self._cfg.get("port", 8000)),
            admission=admission,
        )
        await self.http.start()
        self.port = self.http.port

    async def shutdown(self):
        if self.http is not None:
            await self.http.stop()
        if self.client is not None:
            await self.client.close()

    @dynamo_endpoint
    async def info(self, req: dict):
        yield {"port": self.http.port if self.http else None}
