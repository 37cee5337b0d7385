"""Direct TCP request plane: serve an AsyncEngine over a duplex socket.

A copy of the JAX package's ``runtime/transports/tcp.py`` on the port's
framing, serde and tracing: the same frames byte for byte, so a port
client calls a JAX worker and a JAX client a port worker, and the trace
context rides the request header either way.

The reference sends requests over NATS and streams responses over a
dial-back TCP connection (pipeline/network/egress/push.rs:88-180,
tcp/server.rs:74).  Here both directions ride ONE connection, multiplexed
by request id — one hop fewer per token, and cancellation (stop/kill
control frames, ref ControlMessage network.rs:58) shares the socket.

Frames (framing.py headers):
  client → server:  {type:"request",  req_id} + payload(serde)
                    {type:"stop"|"kill", req_id}
                    {type:"ping", req_id}
  server → client:  {type:"item", req_id} + payload(serde)
                    {type:"end",  req_id}
                    {type:"error", req_id, error}
                    {type:"pong", req_id}

``ping``/``pong`` is the health probe: it rides the
same socket as requests, so a pong proves the whole request path — not just
that the port accepts connections.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.obs import tracing
from dynamo_tpu_torch.runtime import serde
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.transports.framing import (
    close_writer,
    read_frame,
    write_frame,
)
from dynamo_tpu_torch.runtime.transports.net import DEFAULT_NET
from dynamo_tpu_torch.runtime.transports.protocol import FrameType

log = logging.getLogger("dynamo_tpu_torch.tcp")

__all__ = [
    "EndpointTcpServer",
    "EndpointTcpClient",
    "TransportError",
    "EndpointDisconnected",
]

_END = object()
_PONG = object()

# Per-stream item-queue bound: under normal operation the consumer (an
# SSE writer, a router hop) drains faster than decode produces, so the
# queue never fills; if a consumer truly wedges, the read loop stops
# buffering at this watermark instead of growing without bound.
_STREAM_QUEUE_MAX = int(os.environ.get("DYNTPU_STREAM_QUEUE_MAX", "1024"))
# Dial bound: an unroutable peer must not wedge the connect lock (and
# everything queued behind it) for the kernel's full SYN backoff.
_DIAL_TIMEOUT_S = float(os.environ.get("DYNTPU_DIAL_TIMEOUT_S", "30"))


class TransportError(ConnectionError):
    """Typed failure on the endpoint request plane.  Subclasses
    ConnectionError so pre-existing handlers keep working; a migration
    decision keys off this type."""


class EndpointDisconnected(TransportError):
    """The peer vanished mid-stream — server death, socket cut, or a
    reset — as opposed to an application error the engine reported."""


class EndpointTcpServer:
    """Serves registered AsyncEngines over TCP; one server per process,
    engines keyed by endpoint name (subject)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *, net=None):
        self.host = host
        self.port = port
        self._net = net if net is not None else DEFAULT_NET
        self._engines: dict[str, AsyncEngine] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[asyncio.StreamWriter] = set()
        self._handlers: set[asyncio.Task] = set()
        # per-subject in-flight request counts + idle events: the drain
        # lifecycle (Endpoint.drain) waits on these so a deregistered
        # endpoint finishes its live streams before the process stops
        self._inflight: dict[str, int] = {}
        self._idle_events: dict[str, asyncio.Event] = {}
        # deterministic fault-injection seam: called
        # with each outbound frame header; may return "drop" (swallow the
        # frame) or "sever" (abort the peer's transport mid-stream)
        self.fault_hook: Optional[Callable[[dict], Optional[str]]] = None

    def register(self, subject: str, engine: AsyncEngine) -> None:
        self._engines[subject] = engine

    def unregister(self, subject: str) -> None:
        self._engines.pop(subject, None)

    # ------------------------------------------------------- drain support
    def inflight(self, subject: str) -> int:
        """Live request count for one registered subject."""
        return self._inflight.get(subject, 0)

    def _track(self, subject: str, delta: int) -> None:
        n = self._inflight.get(subject, 0) + delta
        self._inflight[subject] = n
        ev = self._idle_events.get(subject)
        if n <= 0:
            self._inflight.pop(subject, None)
            if ev:
                ev.set()
        elif ev:
            ev.clear()

    async def wait_idle(self, subject: str, timeout: float = 30.0) -> bool:
        """Block until no request for ``subject`` is in flight (True), or
        the timeout lapses with streams still live (False)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            ev = self._idle_events.setdefault(subject, asyncio.Event())
            ev.clear()
            # re-check after registering (no await in between): the last
            # stream may have finished before the event existed to be set
            if self._inflight.get(subject, 0) <= 0:
                return True
            remaining = deadline - loop.time()
            if remaining <= 0:
                return False
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                return self._inflight.get(subject, 0) <= 0
            # set() resolved our wait, but a request admitted between the
            # set and this wakeup may have re-cleared the event — loop and
            # re-read the live count instead of trusting the stale wake
            # (drain returning True with a live stream)

    async def start(self) -> "EndpointTcpServer":
        if self._server is None:
            self._server, self.port = await self._net.start_server(
                self._handle, self.host, self.port)
        return self

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # sever live connections so wait_closed() (which waits on all
            # handlers in py3.12) returns promptly
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            await self._reap_handlers()
            self._server = None

    async def _reap_handlers(self) -> None:
        """Cancel and await connection handlers still winding down —
        py3.10's wait_closed() doesn't wait on them, and a prompt stop()
        must not leave tasks to be destroyed with the loop."""
        for t in list(self._handlers):
            t.cancel()
        if self._handlers:
            await asyncio.gather(*self._handlers, return_exceptions=True)
        self._handlers.clear()

    async def abort(self) -> None:
        """Hard-kill: drop the listener and RST every live connection
        without flushing — the fault injector's 'worker died mid-stream'.
        Unlike stop(), peers see an abrupt reset, not a clean FIN."""
        if self._server:
            self._server.close()
            for w in list(self._conns):
                try:
                    w.transport.abort()
                except Exception:
                    log.debug("aborting connection transport failed",
                              exc_info=True)
            await self._server.wait_closed()
            await self._reap_handlers()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        task = asyncio.current_task()
        if task is not None:
            self._handlers.add(task)
            task.add_done_callback(self._handlers.discard)
        contexts: dict[int, Context] = {}
        tasks: dict[int, asyncio.Task] = {}
        wlock = asyncio.Lock()

        async def send(header: dict, payload: bytes = b"") -> None:
            hook = self.fault_hook
            if hook is not None:
                action = hook(header)
                if action == "drop":
                    return
                if action == "sever":
                    try:
                        writer.transport.abort()
                    except Exception:
                        log.debug("fault-hook sever abort failed",
                                  exc_info=True)
                    return
            async with wlock:
                if writer.is_closing():
                    # severed/closed transport: asyncio silently drops
                    # the bytes anyway — don't write into the void
                    # (data-after-sever, the framing guard checks this)
                    return
                try:
                    write_frame(writer, header, payload)
                    await writer.drain()
                except (ConnectionResetError, RuntimeError):
                    pass

        async def run_request(req_id: int, subject: str, data: Any,
                              trace=None) -> None:
            engine = self._engines.get(subject)
            if engine is None:
                await send({"type": FrameType.ERROR, "req_id": req_id,
                            "error": f"no endpoint {subject!r}"})
                return
            ctx = Context(data)
            contexts[req_id] = ctx
            self._track(subject, +1)
            # continue the caller's trace across the wire — this
            # task's contextvar carries it into engine.generate
            tracing.attach(trace)
            span = tracing.start_span(
                f"tcp.request.{subject}", attrs={"request_id": ctx.id})
            try:
                async for item in engine.generate(ctx):
                    await send({"type": FrameType.ITEM, "req_id": req_id}, serde.dumps(item))
                await send({"type": FrameType.END, "req_id": req_id})
            except Exception as e:
                log.exception("endpoint %s request failed", subject)
                await send({"type": FrameType.ERROR, "req_id": req_id, "error": str(e)})
            finally:
                span.end()
                self._track(subject, -1)
                contexts.pop(req_id, None)
                tasks.pop(req_id, None)

        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                header, payload = frame
                ftype = header.get("type")
                req_id = header.get("req_id")
                if ftype == FrameType.REQUEST:
                    data = serde.loads(payload)
                    tasks[req_id] = asyncio.ensure_future(
                        run_request(req_id, header.get("subject", ""), data,
                                    trace=tracing.extract(header))
                    )
                elif ftype == FrameType.STOP:
                    ctx = contexts.get(req_id)
                    if ctx:
                        ctx.stop_generating()
                elif ftype == FrameType.KILL:
                    ctx = contexts.get(req_id)
                    if ctx:
                        ctx.kill()
                elif ftype == FrameType.PING:
                    await send({"type": FrameType.PONG, "req_id": req_id})
        finally:
            # peer gone: kill all in-flight requests from this connection
            self._conns.discard(writer)
            try:
                for ctx in contexts.values():
                    ctx.kill()
                pending = [t for t in tasks.values() if not t.done()]
                for t in pending:
                    t.cancel()
                if pending:
                    # await the cancellations so stop()/abort() reaping
                    # this handler leaves no engine task to die with the
                    # loop
                    await asyncio.gather(*pending, return_exceptions=True)
            finally:
                # nested finally: _reap_handlers() cancelling us while we
                # await the gather above must still close the transport
                # (a cancel delivered mid-finally skips trailing lines)
                writer.close()


class EndpointTcpClient(AsyncEngine):
    """Client-side AsyncEngine proxy for one remote endpoint."""

    def __init__(self, host: str, port: int, subject: str, *, net=None):
        self.host = host
        self.port = port
        self.subject = subject
        self._net = net if net is not None else DEFAULT_NET
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._ids = itertools.count(1)
        self._streams: dict[int, asyncio.Queue] = {}
        self._read_task: Optional[asyncio.Task] = None
        self._wlock = asyncio.Lock()
        self._connect_lock = asyncio.Lock()
        self._connected = False
        self._closed = False
        self._idle = asyncio.Event()  # set while no streams are in flight
        self._idle.set()

    async def connect(self) -> "EndpointTcpClient":
        # serialized: concurrent reconnects (several in-flight requests
        # all retrying after a server restart) would otherwise dial twice,
        # overwrite each other's reader/writer, and leave two read loops
        # fighting over one StreamReader
        async with self._connect_lock:
            if self._closed:
                raise ConnectionError("endpoint client is closed")
            if not self._connected:
                # reconnect path: drop the previous socket/read task first
                # so N endpoint restarts don't leak N transports
                if self._read_task is not None:
                    self._read_task.cancel()
                if self._writer is not None:
                    try:
                        await close_writer(self._writer)
                    except Exception:
                        log.debug("closing stale endpoint socket failed",
                                  exc_info=True)
                    # drop the reference NOW: if the dial below fails,
                    # a later close() must not re-close the stale writer
                    self._reader = self._writer = None
                try:
                    self._reader, self._writer = await asyncio.wait_for(
                        self._net.open_connection(self.host, self.port),
                        _DIAL_TIMEOUT_S,
                    )
                except asyncio.TimeoutError:
                    raise TransportError(
                        f"dial {self.host}:{self.port} timed out after "
                        f"{_DIAL_TIMEOUT_S}s"
                    ) from None
                self._read_task = asyncio.ensure_future(
                    self._read_loop(self._reader)
                )
                self._connected = True
        return self

    async def close_when_idle(self, timeout: float = 60.0) -> None:
        """Close once in-flight streams finish (bounded).  Discovery
        deletes can be false positives — a lease that expired behind an
        event-loop stall while the worker is alive and mid-response;
        closing immediately would kill healthy streams.  A genuinely
        dead worker's streams break on their own socket error anyway."""
        try:
            await asyncio.wait_for(self._idle.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        await self.close()

    async def close(self) -> None:
        # under the connect lock + a closed flag: a close() racing a
        # mid-dial connect() must not be overwritten by the dial landing
        # afterwards (leaked socket + live read loop on a closed client)
        self._closed = True
        async with self._connect_lock:
            if self._read_task:
                self._read_task.cancel()
            # close AND await the transport teardown (bounded): stopping
            # at close() leaves a live transport for the sanitizer/GC;
            # null the reference so a second close() is a no-op, not a
            # double-close (the framing guard checks this)
            await close_writer(self._writer)
            self._reader = self._writer = None
            self._connected = False

    @staticmethod
    def _force_put(q: asyncio.Queue, item: Any) -> None:
        """Control markers (end/error/pong/disconnect) must land even on
        a full queue: evict the oldest buffered item to make room — the
        stream is terminating anyway, and a wedged consumer must still
        find its terminal marker when it wakes."""
        while True:
            try:
                q.put_nowait(item)
                return
            except asyncio.QueueFull:
                try:
                    q.get_nowait()
                except asyncio.QueueEmpty:
                    pass  # racing consumer freed space; retry the put

    async def _read_loop(self, reader) -> None:
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                header, payload = frame
                rid = header.get("req_id")
                q = self._streams.get(rid)
                if q is None:
                    continue
                ftype = header.get("type")
                if ftype == FrameType.ITEM:
                    item = serde.loads(payload)
                    # bounded-queue backpressure: a wedged
                    # consumer stops the read loop buffering at the
                    # watermark instead of growing without bound.  Poll
                    # rather than block in put(): a consumer cancelled
                    # mid-wait deregisters its stream, and a blocking
                    # put on its dead queue would wedge every stream
                    # multiplexed on this connection.
                    while True:
                        if self._streams.get(rid) is not q:
                            break  # consumer gone: drop the item
                        try:
                            q.put_nowait(item)
                            break
                        except asyncio.QueueFull:
                            await asyncio.sleep(0.01)
                elif ftype == FrameType.END:
                    self._force_put(q, _END)
                elif ftype == FrameType.PONG:
                    self._force_put(q, _PONG)
                elif ftype == FrameType.ERROR:
                    self._force_put(
                        q, RuntimeError(header.get("error", "remote error"))
                    )
        finally:
            # only the CURRENT read loop may do disconnect bookkeeping: a
            # cancelled stale loop (its connection already replaced by a
            # reconnect) must not mark the fresh connection dead or error
            # streams that are healthily served by the new loop
            if reader is self._reader:
                self._connected = False
                for q in self._streams.values():
                    self._force_put(q, EndpointDisconnected(
                        f"endpoint {self.subject!r} connection lost "
                        f"({self.host}:{self.port})"))

    async def _send(self, header: dict, payload: bytes = b"") -> None:
        async with self._wlock:
            try:
                write_frame(self._writer, header, payload)
                await self._writer.drain()
            except Exception:
                # a failed write means THIS socket is dead: mark it so the
                # next generate() (e.g. the service-layer retry) dials
                # fresh instead of deterministically reusing the corpse
                self._connected = False
                raise

    async def ping(self, timeout: float = 1.0) -> float:
        """Round-trip a ping control frame over the live request socket;
        returns the latency in seconds.  Raises TransportError (dead or
        unresponsive peer) — the health prober's suspect signal."""
        try:
            await self.connect()
        except OSError as e:
            if isinstance(e, TransportError):
                raise
            raise TransportError(
                f"dial {self.host}:{self.port} failed: {e}") from e
        req_id = next(self._ids)
        # a probe sees at most pong + disconnect marker; bounded
        q: asyncio.Queue = asyncio.Queue(4)
        self._streams[req_id] = q
        self._idle.clear()
        t0 = asyncio.get_running_loop().time()
        try:
            await self._send({"type": FrameType.PING, "req_id": req_id})
            try:
                item = await asyncio.wait_for(q.get(), timeout)
            except asyncio.TimeoutError:
                raise TransportError(
                    f"ping to {self.host}:{self.port} timed out after {timeout}s"
                ) from None
            if item is not _PONG:
                raise TransportError(
                    f"ping to {self.host}:{self.port} failed: {item!r}")
            return asyncio.get_running_loop().time() - t0
        except OSError as e:
            if not isinstance(e, TransportError):
                raise TransportError(
                    f"ping to {self.host}:{self.port} failed: {e}") from e
            raise
        finally:
            self._streams.pop(req_id, None)
            if not self._streams:
                self._idle.set()

    def generate(self, request: Context) -> AsyncIterator[Any]:
        return self._generate(request)

    async def _generate(self, request: Context) -> AsyncIterator[Any]:
        await self.connect()
        req_id = next(self._ids)
        q: asyncio.Queue = asyncio.Queue(_STREAM_QUEUE_MAX)
        # registered BEFORE the send (a reply must not race the
        # registration) — but cleaned up if the send itself fails, or the
        # entry and its queue leak forever
        self._streams[req_id] = q
        self._idle.clear()
        # the client-side half of the hop; inject() stamps this
        # span's context on the REQUEST header so the server continues
        # the same trace id
        span = tracing.start_span(
            f"tcp.call.{self.subject}", attrs={"request_id": request.id})
        try:
            await self._send(
                tracing.inject({"type": FrameType.REQUEST, "req_id": req_id,
                                "subject": self.subject}),
                serde.dumps(request.data),
            )
        except BaseException:
            span.end()
            self._streams.pop(req_id, None)
            if not self._streams:
                # mirror the finally-block bookkeeping: without this a
                # failed send on the only in-flight stream leaves _idle
                # cleared and close_when_idle() on a retiring connection
                # waits out its full timeout on an actually-idle client
                self._idle.set()
            raise
        cancel_task = asyncio.ensure_future(request.stopped())
        get_task: Optional[asyncio.Future] = None
        try:
            while True:
                get_task = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    [get_task, cancel_task], return_when=asyncio.FIRST_COMPLETED
                )
                if cancel_task in done and not get_task.done():
                    get_task.cancel()
                    try:
                        await self._send(
                            {"type": FrameType.KILL if request.is_killed else "stop",
                             "req_id": req_id}
                        )
                    except (ConnectionError, RuntimeError, OSError):
                        # peer already gone: cancelling a stream on a dead
                        # socket is a no-op — the read loop surfaces the
                        # disconnect through the queue on its own
                        pass
                    cancel_task = asyncio.ensure_future(asyncio.Event().wait())  # never again
                    continue
                item = get_task.result()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            span.end()
            cancel_task.cancel()
            if get_task is not None:
                # a consumer cancelled mid-wait must not leave the read
                # pending on the dead stream's queue
                get_task.cancel()
            self._streams.pop(req_id, None)
            if not self._streams:
                self._idle.set()
