"""Disaggregated prefill/decode worker roles.

The counterpart of ``dynamo_tpu/llm/workers.py``, with its queue payload
and transfer wire, so a JAX prefill worker can feed a port decode worker
and the reverse.  After the reference (examples/llm/components/worker.py,
prefill_worker.py, utils/prefill_queue.py):

  DecodeWorker.generate
    ├─ conditional disagg decision            (worker.py:180-207)
    ├─ local  → engine prefill+decode as one request
    └─ remote → allocate KV blocks up front, enqueue RemotePrefillRequest
                on the durable queue, stall until the prefill worker has
                written KV into those blocks and notified (worker.py:164-173,
                vllm patch scheduler stall)
  PrefillWorker.run
    └─ pull queue → prefill locally (remote_decode hold) → push blocks to
       the decode worker's transfer endpoint → notify → release
       (prefill_worker.py:119-177)

The KV hop rides llm/kv/transfer.py instead of NIXL: an on-card copy when
the decode worker's endpoint is in this process (a colocated prefill and
decode engine, as ``examples/llm/components/colocated_worker.py`` serves
them), TCP otherwise.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
from dataclasses import dataclass, field
from typing import AsyncIterator, Optional

import os

from dynamo_tpu_torch.engine.async_engine import AsyncLLMEngine
from dynamo_tpu_torch.engine.counters import kv_stream_counters
from dynamo_tpu_torch.llm.disagg_router import DisaggregatedRouter
from dynamo_tpu_torch.llm.kv.stream import KvStreamProducer, choose_handoff_path
from dynamo_tpu_torch.llm.kv.transfer import KvTransferClient, KvTransferServer
from dynamo_tpu_torch.obs.costs import transfer_costs
from dynamo_tpu_torch.llm.protocols import (
    BackendInput,
    FinishReason,
    LLMEngineOutput,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.obs import tracing
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger("dynamo_tpu_torch.workers")

__all__ = [
    "RemotePrefillRequest",
    "PrefillQueue",
    "DecodeWorker",
    "PrefillWorker",
]


@dataclass
class RemotePrefillRequest:
    """Work item on the prefill queue (ref vllm patch remote_prefill.py:
    RemotePrefillRequest{engine_id, request_id, prompt_token_ids,
    sampling_params, block_ids, computed_block_ids})."""

    request_id: str
    token_ids: list[int]
    block_ids: list[int]       # decode-side blocks to fill
    skip_blocks: int           # leading blocks already resident on decode side
    transfer_url: str          # decode worker's KvTransferServer
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    # dtspan trace context [trace_id, span_id] — optional; carries the
    # decode side's trace across the durable queue so the prefill
    # worker's spans land in the same trace (None when tracing is off)
    trace: Optional[list] = None

    def to_wire(self) -> bytes:
        d = dataclasses.asdict(self)
        return json.dumps(d).encode()

    @classmethod
    def from_wire(cls, data: bytes) -> "RemotePrefillRequest":
        d = json.loads(data)
        d["sampling"] = SamplingOptions(**d.get("sampling", {}))
        return cls(**d)


class PrefillQueue:
    """Durable ack'd work queue for remote prefills — JetStream parity
    (examples/llm/utils/nats_queue.py) on the coordinator queue plane."""

    def __init__(self, coordinator, namespace: str = "default"):
        self.coord = coordinator
        self.name = f"{namespace}_prefill_queue"

    async def push(self, req: RemotePrefillRequest) -> int:
        return await self.coord.queue_push(self.name, req.to_wire())

    async def pull(
        self, timeout_s: float = 0.0
    ) -> Optional[tuple[int, RemotePrefillRequest]]:
        item = await self.coord.queue_pull(self.name, timeout_s)
        if item is None:
            return None
        msg_id, payload = item
        try:
            return msg_id, RemotePrefillRequest.from_wire(payload)
        except Exception:
            # poison message: ack (drop) it or it redelivers forever,
            # killing every worker that pulls it
            log.exception("dropping undecodable prefill queue message %s", msg_id)
            await self.ack(msg_id)
            return None

    async def ack(self, msg_id: int) -> None:
        await self.coord.queue_ack(self.name, msg_id)

    async def nack(self, msg_id: int) -> None:
        await self.coord.queue_nack(self.name, msg_id)

    async def size(self) -> int:
        return await self.coord.queue_len(self.name)


class DecodeWorker(AsyncEngine):
    """The decode-side engine wrapper: owns the conditional disagg decision
    and the KV ingest endpoint.  Drop-in AsyncEngine, so it slots behind
    endpoints / pipelines exactly like a plain engine."""

    def __init__(
        self,
        engine: AsyncLLMEngine,
        coordinator=None,
        namespace: str = "default",
        router: Optional[DisaggregatedRouter] = None,
        transfer_host: str = "127.0.0.1",
    ):
        self.engine = engine
        self.coord = coordinator
        self.namespace = namespace
        self.router = router or DisaggregatedRouter(namespace=namespace)
        self.queue = PrefillQueue(coordinator, namespace) if coordinator else None
        self._transfer: Optional[KvTransferServer] = None
        self._transfer_host = transfer_host
        self._cached_depth = 0
        self._cached_depth_at = -1.0

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> "DecodeWorker":
        self._transfer = await KvTransferServer(
            write_sink=self._apply_write,
            notify_cb=self._on_notify,
            read_source=self._read_blocks,
            host=self._transfer_host,
        ).start()
        if self.coord is not None:
            await self.router.watch(self.coord)
        return self

    async def stop(self) -> None:
        if self._transfer:
            await self._transfer.stop()

    @property
    def transfer_url(self) -> str:
        return self._transfer.url

    # ------------------------------------------------- transfer plane bridge
    async def _apply_write(self, block_ids, arr, request_id=None) -> None:
        core = self.engine.core
        await self.engine.run_on_engine(
            lambda: core.scatter_external(block_ids, arr, request_id)
        )

    async def _read_blocks(self, block_ids):
        core = self.engine.core
        return await self.engine.run_on_engine(lambda: core.gather_blocks_np(block_ids))

    async def _on_notify(self, request_id, first_token, error) -> None:
        core = self.engine.core
        await self.engine.run_on_engine(
            lambda: core.complete_remote_prefill(request_id, first_token, error)
        )

    # ---------------------------------------------------------------- routing
    _QUEUE_DEPTH_TTL = 0.1  # seconds; routing heuristic tolerates staleness

    def _prefix_hit(self, token_ids: list[int]) -> tuple[int, list[int]]:
        # read-only dict probe against the block manager — GIL-safe from this
        # thread, at worst slightly stale, and avoids waiting out an engine
        # step boundary on the request's critical TTFT path
        core = self.engine.core
        seq = TokenBlockSequence(list(token_ids), core.config.block_size)
        hashes = seq.sequence_hashes()
        return core.prefix_hit_tokens(hashes, len(token_ids)), hashes

    async def _queue_depth(self) -> int:
        now = asyncio.get_running_loop().time()
        if now - self._cached_depth_at > self._QUEUE_DEPTH_TTL:
            self._cached_depth = await self.queue.size()
            self._cached_depth_at = now
        return self._cached_depth

    def _wire_edge(self) -> tuple[str, bool]:
        """(src, is_local) of the inbound KV edge: prefer a measured edge
        into our transfer endpoint (i.e. whichever prefill worker has
        actually been feeding us — obs/costs.py learns src/path from
        every push), defaulting to an unmeasured TCP edge so cold routing
        uses the conservative prior."""
        dst = self.transfer_url
        for (src, d, path) in transfer_costs.snapshot():
            if d == dst and path in ("ici", "dcn"):
                return src, path == "ici"
        return "prefill", False

    def _handoff_cost(
        self, token_ids: list[int], hit: int, hashes: list[int]
    ) -> tuple[str, float]:
        """NetKV-style transfer-cost term for the remote-prefill decision:
        predicted seconds to land this request's KV in OUR cache, over
        the cheapest of stream-over-the-wire vs persist-tier restore
        (when the persist index says the prefix is resident here).  Same
        thread-safety posture as ``_prefix_hit``: heuristic inputs."""
        core = self.engine.core
        bs = core.config.block_size
        total_blocks = -(-len(token_ids) // bs)
        remainder = max(0, total_blocks - hit // bs)
        if remainder == 0:
            return "ici", 0.0
        nbytes = core.kv_bytes_per_block() * remainder
        src, local = self._wire_edge()
        return choose_handoff_path(
            src, self.transfer_url, nbytes, local=local,
            persist_resident_blocks=core.persist_hit_blocks(hashes),
            total_blocks=remainder,
        )

    async def _should_remote(self, token_ids: list[int]) -> bool:
        if self.queue is None:
            return False
        hit, hashes = self._prefix_hit(token_ids)
        qsize = await self._queue_depth()
        path, cost = self._handoff_cost(token_ids, hit, hashes)
        if path == "persist":
            # the persist tier already holds (most of) this prefix
            # locally — restoring beats shipping fresh KV over the wire,
            # and the local prefill path is what triggers the restore
            remote = False
        else:
            remote = self.router.prefill_remote(
                len(token_ids), hit, qsize, transfer_cost_s=cost
            )
        # dtspan: the chosen handoff path + its predicted cost, on the
        # request's own trace (generate() runs under the request span)
        span = tracing.start_span(
            "disagg.route",
            attrs={"path": path, "cost_s": cost, "remote": remote,
                   "prefix_hit": hit, "queue": qsize},
        )
        span.end()
        return remote

    # --------------------------------------------------------------- generate
    def generate(self, request: Context[BackendInput]) -> AsyncIterator[LLMEngineOutput]:
        return self._generate(request)

    async def _generate(self, request: Context[BackendInput]):
        if not await self._should_remote(request.data.token_ids):
            async for out in self.engine.generate(request):
                yield out
            return
        async for out in self._generate_remote(request):
            yield out

    async def _generate_remote(self, request: Context[BackendInput]):
        loop = asyncio.get_running_loop()
        alloc_fut: asyncio.Future = loop.create_future()

        def on_allocated(req) -> None:  # engine thread
            ids, cached = list(req.block_ids), req.cached_tokens

            def _set() -> None:
                if not alloc_fut.done():
                    alloc_fut.set_result((ids, cached))

            loop.call_soon_threadsafe(_set)

        agen = self.engine.generate_ex(
            request, remote_prefill=True, on_allocated=on_allocated
        )
        first_task = asyncio.ensure_future(agen.__anext__())
        try:
            done, _ = await asyncio.wait(
                {first_task, alloc_fut}, return_when=asyncio.FIRST_COMPLETED
            )
            if alloc_fut in done:
                block_ids, cached = alloc_fut.result()
                bs = self.engine.core.config.block_size
                ctx_pair = tracing.current()
                await self.queue.push(
                    RemotePrefillRequest(
                        request_id=request.id,
                        token_ids=list(request.data.token_ids),
                        block_ids=block_ids,
                        skip_blocks=cached // bs,
                        transfer_url=self.transfer_url,
                        sampling=request.data.sampling,
                        trace=list(ctx_pair) if ctx_pair else None,
                    )
                )
            # stream everything the engine emits (first token arrives once a
            # prefill worker notifies)
            while True:
                out = await first_task
                yield out
                if out.finished:
                    return
                first_task = asyncio.ensure_future(agen.__anext__())
        except StopAsyncIteration:
            return
        finally:
            if not first_task.done():
                first_task.cancel()
                # let the cancellation reach the inner generator before
                # aclose() — aclose() on a still-running generator raises.
                # gather(return_exceptions=True) absorbs first_task's own
                # CancelledError/errors but still re-raises if THIS task is
                # cancelled from outside — swallowing that would wedge
                # shutdown (the caller's cancel would never land).
                await asyncio.gather(first_task, return_exceptions=True)
            if not alloc_fut.done():
                alloc_fut.cancel()
            await agen.aclose()


class PrefillWorker:
    """Pulls remote-prefill work, computes KV locally, pushes the blocks to
    the decode worker and notifies (ref prefill_worker.py:119-177).

    With ``stream=True`` (or ``DYN_KV_STREAM=1``) the push is the
    layer-wise streamed handoff (llm/kv/stream.py): a commit hook fires
    per prefill chunk and each committed span's layers go on the wire
    while later chunks still compute.  Any stream failure falls back to
    the blocking whole-cache push below — the fallback ladder in
    docs/kv_streaming.md."""

    def __init__(self, engine: AsyncLLMEngine, coordinator, namespace: str = "default",
                 stream: Optional[bool] = None):
        self.engine = engine
        self.queue = PrefillQueue(coordinator, namespace)
        self._stop = asyncio.Event()
        self.handled = 0
        if stream is None:
            stream = os.environ.get("DYN_KV_STREAM", "") == "1"
        self.stream = bool(stream)

    def request_stop(self) -> None:
        self._stop.set()

    async def run(self) -> None:
        """Main pull loop; returns after request_stop().  Transport errors
        back off and retry — the loop must outlive transient coordinator
        hiccups or every remote prefill stalls forever."""
        while not self._stop.is_set():
            try:
                item = await self.queue.pull(timeout_s=0.2)
            except Exception:
                log.exception("prefill queue pull failed; retrying")
                await asyncio.sleep(0.5)
                continue
            if item is None:
                continue
            msg_id, rpr = item
            try:
                await self.handle(rpr)
                await self.queue.ack(msg_id)
                self.handled += 1
            except Exception:
                log.exception("prefill of %s failed; nack for redelivery", rpr.request_id)
                try:
                    await self.queue.nack(msg_id)
                except Exception:
                    log.exception("nack of %s failed", msg_id)

    async def handle(self, rpr: RemotePrefillRequest) -> None:
        # dtspan: continue the decode side's trace across the queue hop —
        # the engine.generate span below and the kv.write_blocks/notify
        # spans all parent under this one
        token = tracing.attach(rpr.trace)
        span = (
            tracing.start_span(
                "disagg.prefill",
                attrs={"request_id": rpr.request_id,
                       "tokens": len(rpr.token_ids)})
            if rpr.trace else tracing.NOP_SPAN
        )
        try:
            await self._handle_inner(rpr)
        finally:
            span.end()
            tracing.detach(token)

    async def _handle_inner(self, rpr: RemotePrefillRequest) -> None:
        core = self.engine.core
        ctx: Context[BackendInput] = Context(
            BackendInput(
                token_ids=list(rpr.token_ids),
                sampling=rpr.sampling,
                stops=StopConditions(max_tokens=1),
            ),
            id=rpr.request_id,
        )
        client = None
        producer: Optional[KvStreamProducer] = None
        stream_task: Optional[asyncio.Task] = None
        if self.stream:
            # streamed handoff: dial the target and arm the commit hook
            # BEFORE prefill starts, so even the FIRST chunk's layers go
            # on the wire while later chunks compute.  The hook dict
            # write is GIL-atomic (same posture as the routing probes).
            client = await KvTransferClient.connect(rpr.transfer_url)
            producer = KvStreamProducer(
                self.engine, client, rpr.request_id,
                remote_block_ids=list(rpr.block_ids),
                skip_blocks=rpr.skip_blocks,
            )
            core.register_commit_hook(rpr.request_id, producer.on_commit)
            stream_task = asyncio.ensure_future(producer.run())
        try:
            outs = [o async for o in self.engine.generate_ex(ctx, remote_decode=True)]
            first_tokens = [t for o in outs for t in o.token_ids]
            failed = not first_tokens or any(
                o.finish_reason is FinishReason.ERROR for o in outs
            )
            streamed = False
            if stream_task is not None:
                if failed:
                    # a failed prefill never fires the done commit event —
                    # the drain would wait forever; cancel it instead
                    stream_task.cancel()
                    await asyncio.gather(stream_task, return_exceptions=True)
                else:
                    streamed = await stream_task
                stream_task = None
                if not streamed and (failed or producer.failure is not None):
                    # mid-stream sever / torn session / backpressure: the
                    # connection may be dead — redial for the fallback
                    # ladder (whole-cache push) and the notify
                    if producer.failure is not None:
                        kv_stream_counters.record_fallback()
                    await client.close()
                    client = None
            if client is None:
                client = await KvTransferClient.connect(rpr.transfer_url)
            if failed:
                await client.notify(rpr.request_id, -1, error="prefill failed")
                return
            local_ids = core.held_blocks(rpr.request_id)
            skip = rpr.skip_blocks
            if len(local_ids) != len(rpr.block_ids):
                await client.notify(rpr.request_id, -1, error="block count mismatch")
                return
            if not streamed and skip < len(local_ids):
                # blocking whole-cache push — the non-streamed default
                # AND the streamed path's fallback.
                # colocated target → device-side gather (blocks never leave
                # the card; the decode engine's scatter copies on the card).
                # Remote target → host staging + TCP.
                gather = (
                    core.gather_blocks_device
                    if getattr(client, "is_local", False)
                    else core.gather_blocks_np
                )
                arr = await self.engine.run_on_engine(
                    lambda: gather(local_ids[skip:])
                )
                await client.write_blocks(
                    rpr.block_ids[skip:], arr, request_id=rpr.request_id
                )
            await client.notify(rpr.request_id, first_tokens[0])
        finally:
            core.unregister_commit_hook(rpr.request_id)
            if stream_task is not None and not stream_task.done():
                stream_task.cancel()
                await asyncio.gather(stream_task, return_exceptions=True)
            if client is not None:
                await client.close()
            await self.engine.run_on_engine(
                lambda: core.release_held(rpr.request_id)
            )
