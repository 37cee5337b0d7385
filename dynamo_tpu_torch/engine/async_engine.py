"""AsyncLLMEngine — asyncio front door over the engine thread.

Implements the runtime's AsyncEngine contract (generate(Context[BackendInput])
→ stream of LLMEngineOutput), which is what a worker serves.  The engine
core runs on its own thread; tokens cross back via
loop.call_soon_threadsafe into per-request asyncio queues.

Cancellation: a stopped/killed Context aborts the request in the core at
the next step boundary.

Disaggregation: :meth:`AsyncLLMEngine.generate_ex` takes the remote
prefill / remote decode flags, and :meth:`AsyncLLMEngine.run_on_engine`
runs a function on the engine thread at a step boundary (the KV scatter,
gather and prefill-done notify of ``llm/workers.py``).
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import AsyncIterator

from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm.protocols import BackendInput, LLMEngineOutput
from dynamo_tpu_torch.obs import tracing
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context

log = logging.getLogger("dynamo_tpu_torch.engine")

__all__ = ["AsyncLLMEngine"]


class AsyncLLMEngine(AsyncEngine):
    def __init__(self, core: EngineCore):
        self.core = core
        self._wake = threading.Event()
        self._shutdown = False
        self._thread: threading.Thread | None = None

    # --------------------------------------------------------------- lifecycle
    def start(self) -> "AsyncLLMEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="engine-core", daemon=True)
            self._thread.start()
        return self

    def shutdown(self) -> None:
        self._shutdown = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _run(self) -> None:
        # the engine thread launches on the core's device
        if self.core.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.core.device)
        while not self._shutdown:
            try:
                did_work = self.core.step()
            except Exception:
                log.exception("engine step failed; failing in-flight requests")
                self.core.fail_all()
                did_work = False
            if not did_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    async def run_on_engine(self, fn):
        """Run ``fn`` on the engine thread at a step boundary (cache/block
        bookkeeping must stay single-writer); await its result."""
        fut = self.core.run_on_step(fn)
        self._wake.set()
        return await asyncio.wrap_future(fut)

    # ---------------------------------------------------------------- generate
    def generate(self, request: Context[BackendInput]) -> AsyncIterator[LLMEngineOutput]:
        return self._generate(request)

    def generate_ex(
        self,
        request: Context[BackendInput],
        *,
        remote_prefill: bool = False,
        remote_decode: bool = False,
        on_allocated=None,
    ) -> AsyncIterator[LLMEngineOutput]:
        """generate() with the disaggregation flags: ``remote_prefill``
        stalls the request until a prefill worker delivers its KV;
        ``remote_decode`` runs the prefill only and holds the blocks for
        transfer-out; ``on_allocated(req)`` is called on the engine thread
        once the request's blocks are allocated."""
        return self._generate(request, remote_prefill=remote_prefill,
                              remote_decode=remote_decode, on_allocated=on_allocated)

    async def _generate(
        self,
        request: Context[BackendInput],
        *,
        remote_prefill: bool = False,
        remote_decode: bool = False,
        on_allocated=None,
    ) -> AsyncIterator[LLMEngineOutput]:
        inp = request.data
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue[LLMEngineOutput] = asyncio.Queue()

        def emit(out: LLMEngineOutput) -> None:
            loop.call_soon_threadsafe(out_q.put_nowait, out)

        # one span per engine-side generation, parented on the caller's
        # context; the engine thread has no ambient context, so req.trace
        # carries the pair
        span = tracing.start_span("engine.generate", attrs={"request_id": request.id})
        req = EngineRequest(
            request_id=request.id,
            prompt=list(inp.token_ids),
            sampling=inp.sampling,
            stops=inp.stops,
            emit=emit,
            remote_prefill=remote_prefill,
            remote_decode=remote_decode,
            on_allocated=on_allocated,
            trace=span.context(),
        )
        if tracing.enabled():
            tracing.collector.bind_request(request.id, span.trace_id)
        self.core.submit(req)
        self._wake.set()

        cancel_task = asyncio.ensure_future(request.stopped())
        get_task: asyncio.Future | None = None
        try:
            while True:
                get_task = asyncio.ensure_future(out_q.get())
                done, _ = await asyncio.wait(
                    [get_task, cancel_task], return_when=asyncio.FIRST_COMPLETED
                )
                if get_task in done:
                    out = get_task.result()
                    if req.queue_wait_s is not None and "queue_wait_s" not in request.annotations:
                        request.annotations["queue_wait_s"] = req.queue_wait_s
                    yield out
                    if out.finished:
                        return
                else:
                    get_task.cancel()
                    self.core.abort(req.request_id)
                    self._wake.set()
                    # drain until the core confirms cancellation
                    while True:
                        out = await out_q.get()
                        yield out
                        if out.finished:
                            return
        finally:
            # a consumer abandoning the stream lands here: without the
            # cancel, get_task stays pending on out_q.get() forever
            if get_task is not None and not get_task.done():
                get_task.cancel()
            cancel_task.cancel()
            if not request.is_stopped and req.finish_reason is None:
                # consumer dropped the stream mid-generation
                self.core.abort(req.request_id)
                self._wake.set()
            span.set(finish=str(req.finish_reason) if req.finish_reason else "",
                     queue_wait_s=req.queue_wait_s or 0.0).end()
