"""AsyncLLMEngine — asyncio front door over the engine thread.

Implements the runtime's AsyncEngine contract (generate(Context[BackendInput])
→ stream of LLMEngineOutput), which is what a worker serves.  The engine
core runs on its own thread; tokens cross back via
loop.call_soon_threadsafe into per-request asyncio queues.

Cancellation: a stopped/killed Context aborts the request in the core at
the next step boundary.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import AsyncIterator

from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm.protocols import BackendInput, LLMEngineOutput
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

    # ---------------------------------------------------------------- generate
    def generate(self, request: Context[BackendInput]) -> AsyncIterator[LLMEngineOutput]:
        return self._generate(request)

    async def _generate(self, request: Context[BackendInput]) -> AsyncIterator[LLMEngineOutput]:
        inp = request.data
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue[LLMEngineOutput] = asyncio.Queue()

        def emit(out: LLMEngineOutput) -> None:
            loop.call_soon_threadsafe(out_q.put_nowait, out)

        req = EngineRequest(
            request_id=request.id,
            prompt=list(inp.token_ids),
            sampling=inp.sampling,
            stops=inp.stops,
            emit=emit,
        )
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
