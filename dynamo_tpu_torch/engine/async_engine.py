"""AsyncLLMEngine — asyncio front door over the engine thread.

Implements the runtime's AsyncEngine contract (generate(Context[BackendInput])
→ stream of LLMEngineOutput), which is what a worker serves.  The engine
core runs on its own thread; tokens cross back via
loop.call_soon_threadsafe into per-request asyncio queues.

Cancellation: a stopped/killed Context, or a consumer that drops the
stream (a cancelled server task), aborts the request in the core at the
next step boundary.

On a mesh (a core whose model holds a ``utils/mesh.py`` mesh) a failed step
is fatal: a collective raised because a follower rank died (or the world
is otherwise broken), and no later step can succeed.  The engine fails its
requests, records the error in :attr:`AsyncLLMEngine.error`, calls
``on_fatal`` and stops its thread; ``run`` then exits non-zero.

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
        # a mesh's fatal step error, and who to tell
        self.error: BaseException | None = None
        self.on_fatal = None

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
        if hasattr(self.core, "close"):
            self.core.close()  # stop the kv-offload thread, if any

    def _run(self) -> None:
        # the engine thread launches on the core's device
        if self.core.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.core.device)
        try:
            while not self._shutdown:
                try:
                    did_work = self.core.step()
                except Exception as e:
                    log.exception("engine step failed; failing in-flight requests")
                    self.core.fail_all()
                    did_work = False
                    if getattr(self.core, "mesh", None) is not None:
                        # a broken world: every later collective would fail too
                        self.error = e
                        self._shutdown = True
                        if self.on_fatal is not None:
                            self.on_fatal(e)
                        return
                if not did_work:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
        finally:
            # no step boundary will come: an operation still queued would
            # leave its awaiter waiting forever
            self.core.fail_pending_ops(self._stopped_error())

    def _stopped_error(self) -> RuntimeError:
        return RuntimeError(f"the engine stopped{f' ({self.error!r})' if self.error else ''} "
                            "before running the operation")

    async def run_on_engine(self, fn):
        """Run ``fn`` on the engine thread at a step boundary (cache/block
        bookkeeping must stay single-writer); await its result.  Raises
        once the engine thread has stopped (shutdown or a fatal step)."""
        fut = self.core.run_on_step(fn)
        self._wake.set()
        if self._shutdown:
            # the thread may have drained its queue before this put
            self.core.fail_pending_ops(self._stopped_error())
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
        if self.error is not None:
            raise RuntimeError(f"the engine stopped after a fatal step error: {self.error!r}")
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
        aborted = finished = False
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
                    finished = out.finished
                    yield out
                    if finished:
                        return
                else:
                    get_task.cancel()
                    self.core.abort(req.request_id)
                    aborted = True
                    self._wake.set()
                    # drain until the core confirms cancellation
                    while True:
                        out = await out_q.get()
                        finished = out.finished
                        yield out
                        if finished:
                            return
        finally:
            # a consumer abandoning the stream lands here: without the
            # cancel, get_task stays pending on out_q.get() forever
            if get_task is not None and not get_task.done():
                get_task.cancel()
            cancel_task.cancel()
            if not aborted and not finished and req.finish_reason is None:
                # the consumer dropped the stream mid-generation, or the
                # task was cancelled with the context killed (a server
                # that lost its peer): either way nobody reads on.  Not
                # after the final output: the engine thread sets
                # finish_reason just after emitting it, and a late abort
                # of a finished id would cancel the next request of it
                self.core.abort(req.request_id)
                self._wake.set()
            span.set(finish=str(req.finish_reason) if req.finish_reason else "",
                     queue_wait_s=req.queue_wait_s or 0.0).end()
