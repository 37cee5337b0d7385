"""KV-block transfer plane: how a prefill worker's KV reaches a decode
worker's cache.

The counterpart of ``dynamo_tpu/llm/kv/transfer.py``, with its wire.  Two
paths:

  * **colocated** (path label ``ici``, the JAX package's name for it) —
    the decode worker's endpoint is served from this process: blocks stay
    torch tensors on the card, the prefill engine's gather feeds the decode
    engine's scatter, an on-card device-to-device copy (ops/block_copy.py).
  * **TCP** (path label ``dcn``) — gather stages blocks to pinned host
    memory, this module ships the bytes over TCP with two-part framing, and
    the receiver uploads and scatters them into its pool.

bf16 on the wire: torch has no numpy bf16 and the JAX package's
``ml_dtypes`` is not a dependency here, so a bf16 part travels as its
2-byte words under ``dtype: "bfloat16"`` (what the JAX package writes for
its ml_dtypes arrays, byte for byte) and unpacks as a ``torch.bfloat16``
view of those words.  Unpacked parts are CPU torch tensors.

Wire protocol (two-part frames, framing.py):
  {op: "write_blocks", block_ids, dtype, shape, request_id?} + raw bytes -> {ok}
  {op: "read_blocks", block_ids}     -> {ok, dtype, shape} + raw bytes
  {op: "notify", request_id, first_token, error?}            -> {ok}

plus the streamed layer-wise handoff session (llm/kv/stream.py owns the
session semantics; this module only moves its frames):
  {op: "stream_begin", v, session, request_id, num_layers}       -> {ok}
  {op: "write_layer", session, seq, chunk, layer, block_ids, …}
                                                  + raw bytes    -> {ok}
  {op: "stream_end", session, frames, sha}                       -> {ok}
  {op: "stream_abort", session}                                  -> {ok}

The ``write_blocks`` reply is sent only after the receiving engine applied
the scatter at a step boundary — so ``notify`` ordered after it can never
race the KV into a decode step (the reference gets this ordering from
NIXL transfer-completion notifications).  The same holds for
``stream_end``: its reply means the assembled cache is applied, so the
producer's notify keeps the identical ordering contract on the streamed
path.

Both client surfaces — ``KvTransferClient`` (wire) and
``LocalKvTransferClient`` (colocated fast path) — implement ONE
protocol: identical method signatures, identical argument coercion
(block ids to int, request ids to str), identical notify semantics.
The local client used to hand its callers' objects straight to the
server callbacks, so a non-string request id round-tripped differently
than over JSON — the streaming assembler is tested against either
surface, which only works because the two now agree.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import time
from typing import Awaitable, Callable, Optional

import warnings

import numpy as np
import torch

from dynamo_tpu_torch.obs import tracing
from dynamo_tpu_torch.obs.costs import transfer_costs
from dynamo_tpu_torch.runtime.transports.net import DEFAULT_NET
from dynamo_tpu_torch.runtime.transports.protocol import TransferOp
from dynamo_tpu_torch.runtime.transports.framing import (
    close_writer,
    read_frame,
    write_frame,
)

log = logging.getLogger("dynamo_tpu_torch.kv_transfer")

# Bound on one write/read round-trip under the per-connection lock:
# a wedged-but-connected peer must surface as ConnectionError —
# otherwise every transfer caller queues forever behind its lock.
# Generous: a multi-hundred-MB block push over TCP is normal.
_TRANSFER_TIMEOUT_S = float(os.environ.get("DYN_KV_TRANSFER_TIMEOUT_S", "60"))

__all__ = [
    "pack_blocks",
    "unpack_blocks",
    "KvTransferServer",
    "KvTransferClient",
    "LocalKvTransferClient",
]

# process-local endpoint registry: when a prefill worker dials a transfer
# URL served from THIS process (colocated prefill/decode), the handoff
# short-circuits to the server's sinks with DEVICE tensors: the prefill
# engine's gather feeds the decode engine's scatter on the card, no host
# staging, no TCP serialization.  Cross-process URLs fall through to TCP.
_LOCAL_ENDPOINTS: dict[str, "KvTransferServer"] = {}

# live path counters (observability + tests): a colocated deployment can
# ASSERT its handoffs rode the device path, not host TCP staging —
# "transfers took the fast path" becomes checkable instead of assumed
stats = {
    "local_write_calls": 0, "local_blocks": 0,
    "tcp_write_calls": 0, "tcp_blocks": 0,
}


def _arr_nbytes(arr) -> int:
    """Total byte size of a block tensor or (data, scale) pair (numpy
    arrays or torch tensors)."""
    parts = arr if isinstance(arr, (tuple, list)) else [arr]
    return sum(p.numel() * p.element_size() if isinstance(p, torch.Tensor)
               else int(p.nbytes) for p in parts)


# the wire name of a bf16 part, carried as 2-byte words; every other part's
# dtype name is numpy's own.  The persistent tier's files (persist.py) use
# the same two functions, so both formats are the JAX package's bytes.
_BF16 = "bfloat16"


def wire_part(p) -> tuple[dict, np.ndarray]:
    """One part -> (its header entry, a contiguous numpy view of its bytes)."""
    if isinstance(p, torch.Tensor):
        t = p.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": _BF16, "shape": list(t.shape)}, t.view(torch.int16).numpy()
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(p))
    return {"dtype": a.dtype.name, "shape": list(a.shape)}, a


def part_from_wire(meta: dict, payload, off: int = 0) -> tuple[torch.Tensor, int]:
    """One part's CPU tensor read from ``payload`` at ``off`` (a view of the
    received bytes, no copy), and the offset after it."""
    name, shape = meta["dtype"], [int(x) for x in meta["shape"]]
    word = np.dtype(np.int16) if name == _BF16 else np.dtype(name)
    count = int(np.prod(shape))
    a = np.frombuffer(payload, dtype=word, count=count, offset=off).reshape(shape)
    with warnings.catch_warnings():
        # the received bytes are read-only; the tensor is only read
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    if name == _BF16:
        t = t.view(torch.bfloat16)
    return t, off + count * word.itemsize


def pack_blocks(arr) -> tuple[dict, bytes]:
    """Blocks -> (wire header fields, payload bytes).

    ``arr`` is either one tensor or array (bf16 or f32 cache) or the int8
    cache's (data, scale) pair — the multi-part header keeps the wire format
    self-describing so mixed-precision workers interoperate explicitly.
    """
    parts = [wire_part(p) for p in (arr if isinstance(arr, (tuple, list)) else [arr])]
    if len(parts) == 1:
        # the JAX package's single-array header (what its older receivers read)
        meta, a = parts[0]
        return meta, a.tobytes()
    return {"parts": [m for m, _ in parts]}, b"".join(a.tobytes() for _, a in parts)


def unpack_blocks(header: dict, payload: bytes):
    """Inverse of :func:`pack_blocks`; returns a CPU tensor, or a tuple of
    them for multi-part (int8 cache) payloads.  Accepts the single-array
    header."""
    metas = header.get("parts")
    if metas is None:
        return part_from_wire(header, payload)[0]
    out, off = [], 0
    for m in metas:
        t, off = part_from_wire(m, payload, off)
        out.append(t)
    return out[0] if len(out) == 1 else tuple(out)


class KvTransferServer:
    """Per-worker ingest endpoint for KV blocks + prefill notifications.

    ``write_sink(block_ids, arr, request_id)`` must resolve once the blocks
    are applied to the engine cache; ``read_source(block_ids)`` returns
    staged blocks (for pull-mode transfer);
    ``notify_cb(request_id, first_token, error)`` delivers the prefill-done
    signal.
    """

    def __init__(
        self,
        write_sink: Callable[[list[int], object, Optional[str]], Awaitable[None]],
        notify_cb: Callable[[str, int, Optional[str]], Awaitable[None]],
        read_source: Optional[Callable[[list[int]], Awaitable[object]]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        net=None,
    ):
        from dynamo_tpu_torch.llm.kv.stream import KvStreamAssembler

        self.write_sink = write_sink
        self.notify_cb = notify_cb
        self.read_source = read_source
        self.host, self.port = host, port
        self._net = net or DEFAULT_NET
        self._server = None
        # decode-side streamed-handoff assembler (llm/kv/stream.py):
        # stream-session ops route here; a verified completion applies
        # through the same write_sink as a whole-cache push
        self.assembler = KvStreamAssembler(self._apply_stream)
        # fault seam: called per inbound frame with {"type": op, **header}
        # before dispatch; "drop" swallows the frame (no reply), "sever"
        # cuts the conn — the deterministic mid-stream kill for the
        # fallback tests
        self.fault_hook: Optional[Callable[[dict], Optional[str]]] = None

    async def _apply_stream(self, block_ids, arr, request_id) -> None:
        await self.write_sink(block_ids, arr, request_id)

    async def start(self) -> "KvTransferServer":
        self._server, self.port = await self._net.start_server(
            self._handle, self.host, self.port
        )
        _LOCAL_ENDPOINTS[self.url] = self
        return self

    async def stop(self) -> None:
        _LOCAL_ENDPOINTS.pop(self.url, None)
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    @property
    def url(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    async def _handle(self, reader, writer) -> None:
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                h, payload = frame
                op, rid = h.get("op"), h.get("id")
                hook = self.fault_hook
                if hook is not None:
                    action = hook({"type": op, **h})
                    if action == "drop":
                        continue  # swallowed: no dispatch, no reply
                    if action == "sever":
                        break  # cut the transport mid-stream
                # dtspan: a traced sender's context continues through the
                # receive-side apply (scatter waits for a step boundary, so
                # this span measures the full transfer-visible latency)
                trace = tracing.extract(h)
                span = (
                    tracing.start_span(
                        f"kv.server.{op}", parent=trace,
                        attrs={"request_id": h.get("request_id", ""),
                               "bytes": len(payload)})
                    if trace is not None else tracing.NOP_SPAN
                )
                try:
                    if op == TransferOp.WRITE_BLOCKS:
                        await self.write_sink(
                            h["block_ids"],
                            unpack_blocks(h, payload),
                            h.get("request_id"),
                        )
                        write_frame(writer, {"id": rid, "ok": True})
                    elif op == TransferOp.READ_BLOCKS:
                        if self.read_source is None:
                            raise RuntimeError("read_blocks unsupported on this worker")
                        meta, data = pack_blocks(await self.read_source(h["block_ids"]))
                        write_frame(writer, {"id": rid, "ok": True, **meta}, data)
                    elif op == TransferOp.NOTIFY:
                        await self.notify_cb(
                            h["request_id"], h.get("first_token", -1), h.get("error")
                        )
                        write_frame(writer, {"id": rid, "ok": True})
                    elif op in (
                        TransferOp.STREAM_BEGIN,
                        TransferOp.WRITE_LAYER,
                        TransferOp.STREAM_END,
                        TransferOp.STREAM_ABORT,
                    ):
                        extra = await self.assembler.handle(h, payload)
                        write_frame(writer,
                                    {"id": rid, "ok": True, **(extra or {})})
                    else:
                        write_frame(writer, {"id": rid, "error": f"unknown op {op!r}"})
                except Exception as e:
                    log.exception("kv transfer op %s failed", op)
                    write_frame(writer, {"id": rid, "error": str(e)})
                finally:
                    span.end()
                await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            await close_writer(writer)


class LocalKvTransferClient:
    """Colocated fast path: same protocol surface as
    :class:`KvTransferClient` (identical signatures and coercions — the
    unified-client contract in the module docstring), but ops invoke the
    target server's sinks directly — blocks stay tensors on the card end
    to end, so the copy is device-to-device with zero host staging or wire
    serialization.  Stream-session ops route into the same
    :class:`~dynamo_tpu_torch.llm.kv.stream.KvStreamAssembler` the wire path
    uses, so the streamed handoff is testable against either surface."""

    is_local = True

    def __init__(self, server: "KvTransferServer"):
        self._server = server

    @property
    def url(self) -> str:
        return self._server.url

    async def close(self) -> None:
        pass

    async def write_blocks(
        self,
        block_ids: list[int],
        arr,
        request_id: Optional[str] = None,
    ) -> None:
        stats["local_write_calls"] += 1
        stats["local_blocks"] += len(block_ids)
        nbytes = _arr_nbytes(arr)
        rid = None if request_id is None else str(request_id)
        span = tracing.start_span(
            "kv.write_blocks",
            attrs={"path": "ici", "blocks": len(block_ids), "bytes": nbytes,
                   "request_id": rid or ""},
        )
        t0 = time.perf_counter()
        try:
            await self._server.write_sink(
                [int(b) for b in block_ids], arr, rid
            )
        finally:
            transfer_costs.record(
                tracing.process_name(), self._server.url, "ici",
                nbytes, time.perf_counter() - t0,
            )
            span.end()

    # ------------------------------------------- streamed handoff session
    # Same assembler, same header schema as the wire — only the framing
    # is skipped.  llm/kv/stream.py's KvStreamSession drives these.
    async def stream_begin(self, header: dict) -> dict:
        return await self._server.assembler.handle(
            {**header, "op": TransferOp.STREAM_BEGIN})

    async def write_layer(self, header: dict, payload: bytes) -> dict:
        return await self._server.assembler.handle(
            {**header, "op": TransferOp.WRITE_LAYER}, payload)

    async def stream_end(self, header: dict) -> dict:
        return await self._server.assembler.handle(
            {**header, "op": TransferOp.STREAM_END})

    async def stream_abort(self, header: dict) -> dict:
        return await self._server.assembler.handle(
            {**header, "op": TransferOp.STREAM_ABORT})

    async def read_blocks(self, block_ids):
        if self._server.read_source is None:
            raise RuntimeError("read_blocks unsupported on this worker")
        span = tracing.start_span(
            "kv.read_blocks", attrs={"path": "ici", "blocks": len(block_ids)})
        t0 = time.perf_counter()
        try:
            out = await self._server.read_source([int(b) for b in block_ids])
        finally:
            span.end()
        transfer_costs.record(
            self._server.url, tracing.process_name(), "ici",
            _arr_nbytes(out), time.perf_counter() - t0,
        )
        return out

    async def notify(
        self, request_id: str, first_token: int, error: Optional[str] = None
    ) -> None:
        # same coercions a JSON round trip imposes on the wire client, so
        # notify_cb sees one type signature regardless of surface
        await self._server.notify_cb(
            str(request_id), int(first_token),
            None if error is None else str(error),
        )


class KvTransferClient:
    """Dial a worker's transfer endpoint and push/pull blocks.

    ``connect`` returns the in-process :class:`LocalKvTransferClient` when
    the URL is served from this very process (colocated engines), and a
    TCP client otherwise."""

    is_local = False

    def __init__(self, url: str, net=None):
        hostport = url.split("//", 1)[-1]
        host, port = hostport.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self._net = net or DEFAULT_NET
        self._reader = self._writer = None
        self._ids = itertools.count(1)
        self._lock = asyncio.Lock()

    @property
    def url(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    @classmethod
    async def connect(cls, url: str, *, net=None, force_tcp: bool = False):
        # DYN_KV_TRANSFER_FORCE_TCP=1 / force_tcp=True disables the
        # colocated shortcut (runs exercising the wire path)
        local = (
            None
            if force_tcp or os.environ.get("DYN_KV_TRANSFER_FORCE_TCP")
            else _LOCAL_ENDPOINTS.get(url)
        )
        if local is not None:
            return LocalKvTransferClient(local)
        self = cls(url, net=net)
        self._reader, self._writer = await self._net.open_connection(
            self.host, self.port
        )
        return self

    async def close(self) -> None:
        # close AND await the transport teardown (bounded): stopping at
        # close() leaks a live TCP transport at loop shutdown;
        # null the reference so a repeated close() cannot double-close
        await close_writer(self._writer)
        self._writer = None

    async def _roundtrip(self, header: dict, payload: bytes):
        write_frame(self._writer, header, payload)
        await self._writer.drain()
        return await read_frame(self._reader)

    async def _call(self, header: dict, payload: bytes = b"") -> tuple[dict, bytes]:
        async with self._lock:  # strict request/reply per connection
            header["id"] = next(self._ids)
            tracing.inject(header)  # dtspan: carry the caller's trace
            # bounded: the reply wait under the lock must not
            # wedge other transfers behind a dead-but-connected peer
            try:
                frame = await asyncio.wait_for(
                    self._roundtrip(header, payload), _TRANSFER_TIMEOUT_S
                )
            except asyncio.TimeoutError:
                raise ConnectionError(
                    f"kv transfer to {self.host}:{self.port} timed out "
                    f"after {_TRANSFER_TIMEOUT_S}s"
                ) from None
        if frame is None:
            raise ConnectionError("kv transfer peer closed")
        resp, data = frame
        if "error" in resp:
            raise RuntimeError(f"kv transfer error: {resp['error']}")
        return resp, data

    async def write_blocks(
        self,
        block_ids: list[int],
        arr,
        request_id: Optional[str] = None,
    ) -> None:
        """Push blocks into the peer's cache at ``block_ids`` (NIXL WRITE).
        ``request_id`` lets the receiver validate block ownership (a late
        write for an aborted request is dropped, not applied)."""
        stats["tcp_write_calls"] += 1
        stats["tcp_blocks"] += len(block_ids)
        meta, data = pack_blocks(arr)
        dst = f"{self.host}:{self.port}"
        span = tracing.start_span(
            "kv.write_blocks",
            attrs={"path": "dcn", "dst": dst, "blocks": len(block_ids),
                   "bytes": len(data), "request_id": request_id or ""},
        )
        t0 = time.perf_counter()
        try:
            await self._call(
                {
                    "op": TransferOp.WRITE_BLOCKS,
                    "block_ids": list(map(int, block_ids)),
                    "request_id": request_id,
                    **meta,
                },
                data,
            )
        finally:
            # the round-trip completes only after the receiver applied the
            # scatter, so this measures effective (not raw-socket) bandwidth
            transfer_costs.record(
                tracing.process_name(), dst, "dcn",
                len(data), time.perf_counter() - t0,
            )
            span.end()

    async def read_blocks(self, block_ids: list[int]):
        """Pull blocks out of the peer's cache (NIXL READ)."""
        src = f"{self.host}:{self.port}"
        span = tracing.start_span(
            "kv.read_blocks",
            attrs={"path": "dcn", "src": src, "blocks": len(block_ids)},
        )
        t0 = time.perf_counter()
        try:
            resp, data = await self._call(
                {"op": TransferOp.READ_BLOCKS,
                 "block_ids": list(map(int, block_ids))}
            )
        finally:
            span.end()
        transfer_costs.record(
            src, tracing.process_name(), "dcn",
            len(data), time.perf_counter() - t0,
        )
        return unpack_blocks(resp, data)

    async def notify(
        self, request_id: str, first_token: int, error: Optional[str] = None
    ) -> None:
        await self._call(
            {
                "op": TransferOp.NOTIFY,
                "request_id": str(request_id),
                "first_token": int(first_token),
                "error": error,
            }
        )

    # ------------------------------------------- streamed handoff session
    # Thin framed carriers for llm/kv/stream.py's KvStreamSession: every
    # op is a request/reply under the connection lock, so a rejected
    # frame (torn seq, unknown session) surfaces to the producer
    # immediately as RuntimeError and the fallback ladder engages before
    # more layers are wasted on a dead session.
    async def stream_begin(self, header: dict) -> dict:
        resp, _ = await self._call({**header, "op": TransferOp.STREAM_BEGIN})
        return resp

    async def write_layer(self, header: dict, payload: bytes) -> dict:
        resp, _ = await self._call(
            {**header, "op": TransferOp.WRITE_LAYER}, payload)
        return resp

    async def stream_end(self, header: dict) -> dict:
        resp, _ = await self._call({**header, "op": TransferOp.STREAM_END})
        return resp

    async def stream_abort(self, header: dict) -> dict:
        resp, _ = await self._call({**header, "op": TransferOp.STREAM_ABORT})
        return resp
