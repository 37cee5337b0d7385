"""Streamed KV handoff plane — layer-wise KV streaming over the transfer wire.

The counterpart of ``dynamo_tpu/llm/kv/stream.py``: the same session
protocol and the same bytes, so a payload's sha256 matches the JAX
package's (bf16 parts are their 2-byte words in both).

The blocking disagg handoff (llm/kv/transfer.py ``write_blocks``) ships
the whole KV cache in one push *after* prefill completes, so at long ISL
the transfer serializes behind compute.  The cache
is block-granular and layer-major, so each committed span's KV can
stream as soon as the engine commits it, overlapping transfer with the
remaining chunks' compute (FlowKV, arxiv 2504.03775).  This module owns
the whole streamed-handoff session:

  producer (prefill side)
    ``KvStreamProducer`` — drains the engine's per-commit hook
    (engine/core.py ``register_commit_hook``) into a bounded async
    queue, gathers each newly committed block span to host, and sends
    it as one ``WRITE_LAYER`` frame per layer through a
    ``KvStreamSession``.  Backpressure overflow or any transport error
    fails the session; the prefill worker then falls back to the
    blocking whole-cache push.

  session protocol (both sides)
    ``STREAM_BEGIN {v, session, request_id, num_layers}`` opens;
    ``WRITE_LAYER {session, seq, chunk, layer, block_ids, …}+payload``
    carries one layer of one committed chunk under a per-session
    monotonic ``seq``; ``STREAM_END {session, frames, sha}`` closes
    with a sha256 over every payload byte in seq order.  A missing,
    reordered or corrupted frame fails the sha/seq check at END — a
    torn stream is a MISS (the decode side assembles nothing), never
    wrong KV.  ``STREAM_ABORT`` is the producer's explicit give-up.

  assembler (decode side)
    ``KvStreamAssembler`` — stages arriving layers in host memory and
    applies the assembled ``[L, n, …]`` cache through the transfer
    server's ``write_sink`` (→ ``scatter_external``) only once the last
    layer landed AND the completion frame verified.  Partial sessions
    are discarded wholesale.

  routing
    ``choose_handoff_path`` — the NetKV-style transfer-cost term:
    cost-compares streaming over TCP (``dcn``) or the colocated path
    (``ici``) against a restore from the persist tier using the measured
    per-(src,dst,path) EWMA tables in obs/costs.py (the port has no
    persist tier yet, so its decode worker reports 0 resident blocks).

Granularity: as in the JAX package, the commit hook fires at prefill
CHUNK boundaries (the engine commits blocks per chunk) and the producer
fans each chunk out into per-layer frames.  With >=2 chunks the first
chunk's layers are on the wire while later chunks compute; a single-chunk
prefill degenerates to the blocking schedule.

Staged parts are CPU torch tensors (``transfer.unpack_blocks``); the
producer's chunks are whatever the engine's ``gather_blocks_np`` returns.
"""

from __future__ import annotations

import asyncio
import hashlib
import itertools
import logging
import os
import time
from typing import Awaitable, Callable, Optional

import torch

from dynamo_tpu_torch.engine.counters import kv_stream_counters
from dynamo_tpu_torch.obs import tracing
from dynamo_tpu_torch.obs.costs import transfer_costs
from dynamo_tpu_torch.runtime.transports.protocol import TransferOp

log = logging.getLogger("dynamo_tpu_torch.kv_stream")

__all__ = [
    "STREAM_VERSION",
    "KvStreamAssembler",
    "KvStreamSession",
    "KvStreamProducer",
    "choose_handoff_path",
]

# Versioned session header: receivers reject sessions whose major
# version they don't speak (an explicit error reply, so the producer
# falls back to the version-free whole-cache push instead of feeding
# frames into a peer that mis-parses them).
STREAM_VERSION = 1

# Bound on concurrently-open assembler sessions: a flood of abandoned
# BEGINs (crashing producers) must not grow host staging without bound.
_MAX_SESSIONS = 64

_SESSION_IDS = itertools.count(1)


def new_session_id(request_id: str) -> str:
    """Process-unique session id; readable in traces and logs."""
    return f"{request_id}@{os.getpid()}#{next(_SESSION_IDS)}"


def _layer_of(arr, layer: int):
    """Slice one layer out of a layer-major block stack ``[L, n, ...]``
    (a (data, scale) tuple of such for the quantized cache)."""
    if isinstance(arr, (tuple, list)):
        return tuple(p[layer] for p in arr)
    return arr[layer]


def _num_layers_of(arr) -> int:
    part = arr[0] if isinstance(arr, (tuple, list)) else arr
    return int(part.shape[0])


# --------------------------------------------------------------- assembler


class _Assembly:
    """One in-flight inbound session's host staging state."""

    def __init__(self, header: dict):
        self.session = header["session"]
        self.request_id = header.get("request_id")
        self.num_layers = int(header["num_layers"])
        self.next_seq = 0
        self.sha = hashlib.sha256()
        # chunk index -> (block_ids, {layer: arr-or-parts})
        self.chunks: dict[int, tuple[list[int], dict]] = {}

    def stage(self, header: dict, arr) -> None:
        chunk = int(header["chunk"])
        layer = int(header["layer"])
        ids = [int(b) for b in header["block_ids"]]
        if not 0 <= layer < self.num_layers:
            raise ValueError(f"layer {layer} outside [0, {self.num_layers})")
        got = self.chunks.setdefault(chunk, (ids, {}))
        if got[0] != ids:
            raise ValueError(f"chunk {chunk} block_ids changed mid-session")
        if layer in got[1]:
            raise ValueError(f"duplicate layer {layer} for chunk {chunk}")
        got[1][layer] = arr

    def assemble(self) -> tuple[list[int], object]:
        """Stack the staged layers back into the transfer layout
        ``[L, n, ...]`` (tuple-of-stacks for quantized parts); raises on
        any gap, so a hole can never assemble."""
        if not self.chunks:
            raise ValueError("empty stream session")
        order = sorted(self.chunks)
        if order != list(range(len(order))):
            raise ValueError(f"non-contiguous chunk set {order}")
        ids: list[int] = []
        per_layer: list[list] = [[] for _ in range(self.num_layers)]
        quant = None
        for c in order:
            c_ids, layers = self.chunks[c]
            if set(layers) != set(range(self.num_layers)):
                raise ValueError(
                    f"chunk {c} incomplete: has layers {sorted(layers)}")
            ids.extend(c_ids)
            for layer in range(self.num_layers):
                arr = layers[layer]
                is_q = isinstance(arr, tuple)
                if quant is None:
                    quant = is_q
                elif quant != is_q:
                    raise ValueError("mixed quantized/plain layer frames")
                per_layer[layer].append(arr)
        if quant:
            nparts = len(per_layer[0][0])
            parts = tuple(
                torch.stack([
                    torch.cat([chunk[p] for chunk in layer_chunks], dim=0)
                    for layer_chunks in per_layer
                ])
                for p in range(nparts)
            )
            return ids, parts
        full = torch.stack([
            torch.cat(layer_chunks, dim=0)
            for layer_chunks in per_layer
        ])
        return ids, full


class KvStreamAssembler:
    """Decode-side assembler: stages layer frames per session in host
    memory; on a verified completion frame, applies the whole assembled
    cache through ``write_sink`` in ONE call — the existing
    scatter-at-step-boundary / request-ownership validation path.  Any
    protocol violation (bad seq, bad sha, version mismatch, hole)
    discards the session and raises — the reply wire turns that into an
    error the producer treats as "fall back", and the decode request is
    admitted only by a later whole-cache push or local prefill.  Never
    partial KV."""

    def __init__(
        self,
        write_sink: Callable[[list[int], object, Optional[str]], Awaitable[None]],
    ):
        self.write_sink = write_sink
        self._sessions: dict[str, _Assembly] = {}
        # observability: how sessions ended on this side
        self.completed = 0
        self.aborted = 0
        self.rejected = 0

    async def handle(self, header: dict, payload: bytes = b"") -> dict:
        """Uniform stream-op entry used by both the TCP server dispatch
        and the colocated client's direct path."""
        op = header.get("op")
        if op == TransferOp.STREAM_BEGIN:
            return self.begin(header)
        if op == TransferOp.WRITE_LAYER:
            return self.write_layer(header, payload)
        if op == TransferOp.STREAM_END:
            return await self.end(header)
        if op == TransferOp.STREAM_ABORT:
            return self.abort(header)
        raise ValueError(f"not a stream op: {op!r}")

    # ----------------------------------------------------------- handlers
    def begin(self, header: dict) -> dict:
        v = header.get("v")
        if v != STREAM_VERSION:
            self.rejected += 1
            raise ValueError(
                f"unsupported kv stream version {v!r} (speak {STREAM_VERSION})")
        sid = header["session"]
        if sid in self._sessions:
            raise ValueError(f"duplicate stream session {sid!r}")
        if len(self._sessions) >= _MAX_SESSIONS:
            self.rejected += 1
            raise ValueError("too many open stream sessions")
        self._sessions[sid] = _Assembly(header)
        return {"session": sid}

    def _session(self, header: dict) -> _Assembly:
        sess = self._sessions.get(header.get("session"))
        if sess is None:
            raise ValueError(f"unknown stream session {header.get('session')!r}")
        return sess

    def write_layer(self, header: dict, payload: bytes) -> dict:
        from dynamo_tpu_torch.llm.kv.transfer import unpack_blocks

        sess = self._session(header)
        seq = int(header["seq"])
        if seq != sess.next_seq:
            # out-of-order / replayed frame: the session is torn; drop it
            # so END can only ever see a clean prefix
            self._sessions.pop(sess.session, None)
            self.rejected += 1
            raise ValueError(
                f"stream seq {seq} != expected {sess.next_seq} (torn)")
        try:
            sess.stage(header, unpack_blocks(header, payload))
        except Exception:
            self._sessions.pop(sess.session, None)
            self.rejected += 1
            raise
        sess.sha.update(payload)
        sess.next_seq += 1
        return {"seq": seq}

    async def end(self, header: dict) -> dict:
        sess = self._session(header)
        # completion verification: frame count, payload sha, then the
        # structural completeness check inside assemble().  Pop FIRST —
        # whatever the outcome, the session is over.
        self._sessions.pop(sess.session, None)
        frames = int(header.get("frames", -1))
        if frames != sess.next_seq:
            self.rejected += 1
            raise ValueError(
                f"completion frame count {frames} != received {sess.next_seq}")
        digest = sess.sha.hexdigest()
        if header.get("sha") != digest:
            self.rejected += 1
            raise ValueError("completion sha mismatch (torn stream = miss)")
        ids, arr = sess.assemble()
        await self.write_sink(ids, arr, sess.request_id)
        self.completed += 1
        return {"applied_blocks": len(ids)}

    def abort(self, header: dict) -> dict:
        if self._sessions.pop(header.get("session"), None) is not None:
            self.aborted += 1
        return {}


# ----------------------------------------------------------------- session


class KvStreamSession:
    """Producer-side session over EITHER transfer-client surface
    (``KvTransferClient`` on the wire, ``LocalKvTransferClient``
    in-process — the unified stream quartet).  Owns seq numbering, the
    rolling payload sha, and per-frame stream metrics."""

    def __init__(self, client, request_id: str, num_layers: int,
                 session_id: Optional[str] = None):
        self.client = client
        self.request_id = str(request_id)
        self.num_layers = int(num_layers)
        self.session_id = session_id or new_session_id(self.request_id)
        self.path = "ici" if getattr(client, "is_local", False) else "dcn"
        self._seq = 0
        self._chunk = 0
        self._sha = hashlib.sha256()
        self.bytes_sent = 0
        self.transfer_s = 0.0

    async def begin(self) -> None:
        kv_stream_counters.record_session()
        await self.client.stream_begin({
            "v": STREAM_VERSION,
            "session": self.session_id,
            "request_id": self.request_id,
            "num_layers": self.num_layers,
        })

    async def write_chunk(self, block_ids: list[int], arr,
                          compute_live: bool = True) -> None:
        """Send one committed block span as ``num_layers`` layer frames.
        ``arr`` is the span's layer-major stack ``[L, n, ...]`` (or the
        quantized (data, scale) pair).  ``compute_live=True`` means the
        producer's prefill is still computing — these frames' transfer
        time is HIDDEN under compute (the overlap_ratio numerator)."""
        from dynamo_tpu_torch.llm.kv.transfer import pack_blocks

        if _num_layers_of(arr) != self.num_layers:
            raise ValueError(
                f"chunk has {_num_layers_of(arr)} layers, "
                f"session opened with {self.num_layers}")
        ids = [int(b) for b in block_ids]
        for layer in range(self.num_layers):
            meta, data = pack_blocks(_layer_of(arr, layer))
            header = {
                "session": self.session_id,
                "seq": self._seq,
                "chunk": self._chunk,
                "layer": layer,
                "block_ids": ids,
                **meta,
            }
            self._sha.update(data)
            t0 = time.perf_counter()
            await self.client.write_layer(header, data)
            dt = time.perf_counter() - t0
            self._seq += 1
            self.bytes_sent += len(data)
            self.transfer_s += dt
            kv_stream_counters.record_layer(len(data), dt,
                                            hidden=compute_live)
        self._chunk += 1

    async def end(self) -> dict:
        resp = await self.client.stream_end({
            "session": self.session_id,
            "frames": self._seq,
            "sha": self._sha.hexdigest(),
        })
        # one aggregate sample per session: the cost tables learn the
        # streamed path's effective throughput alongside write_blocks'
        dst = getattr(self.client, "url", "")
        if self.transfer_s > 0 and dst:
            transfer_costs.record(tracing.process_name(), dst, self.path,
                                  self.bytes_sent, self.transfer_s)
        return resp

    async def abort(self) -> None:
        """Best-effort: the transport may already be dead."""
        try:
            await self.client.stream_abort({"session": self.session_id})
        except (ConnectionError, RuntimeError, OSError,
                asyncio.TimeoutError):
            pass


# ---------------------------------------------------------------- producer


class KvStreamProducer:
    """Prefill-worker side: bridges the engine's commit hook (engine
    thread, fires per committed chunk) into an async drain that streams
    each newly committed span.  The queue is BOUNDED: if the wire falls
    so far behind compute that ``max_pending`` commit events pile up,
    the stream declares itself failed and the worker falls back to the
    whole-cache push — backpressure never stalls the engine thread."""

    def __init__(self, engine, client, request_id: str,
                 remote_block_ids: list[int], skip_blocks: int = 0,
                 max_pending: int = 32):
        self._engine = engine
        self._client = client
        self.request_id = request_id
        self._remote_ids = [int(b) for b in remote_block_ids]
        self._skip = int(skip_blocks)
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max_pending)
        self._loop = asyncio.get_running_loop()
        self._overflow = False
        self.completed = False
        self.failure: Optional[str] = None
        self.session: Optional[KvStreamSession] = None

    # ------------------------------------------------- engine-thread side
    def on_commit(self, local_ids: list[int], done: bool) -> None:
        """Engine commit hook (engine/core.py ``_fire_commit_hook``):
        ``local_ids`` is the cumulative list of this request's committed
        prefill-side block ids; ``done`` marks the final (held-blocks)
        event.  Engine thread — hop to the loop, never block."""
        ids = [int(b) for b in local_ids]
        try:
            self._loop.call_soon_threadsafe(self._offer, ids, done)
        except RuntimeError:
            pass  # loop closed mid-shutdown; the worker is gone anyway

    def _offer(self, ids: list[int], done: bool) -> None:
        try:
            self._queue.put_nowait((ids, done))
        except asyncio.QueueFull:
            self._overflow = True

    # --------------------------------------------------------- drain side
    async def run(self) -> bool:
        """Drain commit events into layer frames; returns True when the
        completion frame was acked (KV fully applied on the decode
        side), False on any failure — the caller then runs the fallback
        ladder.  Cancellation-safe: the worker cancels this task when
        prefill itself errors."""
        core = self._engine.core
        sent = self._skip
        span = tracing.start_span(
            "kv.stream.produce",
            attrs={"request_id": self.request_id,
                   "skip_blocks": self._skip})
        try:
            while True:
                ids, done = await self._queue.get()
                if self._overflow:
                    raise BufferError(
                        "stream backpressure bound exceeded "
                        "(wire too far behind compute)")
                if len(ids) > len(self._remote_ids):
                    raise ValueError(
                        f"prefill committed {len(ids)} blocks but decode "
                        f"allocated {len(self._remote_ids)}")
                if len(ids) > sent:
                    delta = ids[sent:]
                    arr = await self._engine.run_on_engine(
                        lambda d=delta: core.gather_blocks_np(d)
                    )
                    if self.session is None:
                        self.session = KvStreamSession(
                            self._client, self.request_id,
                            _num_layers_of(arr))
                        await self.session.begin()
                    await self.session.write_chunk(
                        self._remote_ids[sent:len(ids)], arr,
                        compute_live=not done,
                    )
                    sent = len(ids)
                if done:
                    if self.session is None:
                        # nothing beyond the skipped prefix ever committed
                        # — nothing to stream, nothing applied remotely
                        return False
                    if sent != len(self._remote_ids):
                        raise ValueError(
                            f"stream ended at {sent}/"
                            f"{len(self._remote_ids)} blocks")
                    resp = await self.session.end()
                    span.set(
                        applied_blocks=int(resp.get("applied_blocks", 0)))
                    self.completed = True
                    return True
        except asyncio.CancelledError:
            self.failure = "cancelled"
            raise
        except (ConnectionError, RuntimeError, OSError, ValueError,
                BufferError, asyncio.TimeoutError) as e:
            self.failure = f"{type(e).__name__}: {e}"
            log.warning("kv stream for %s failed (%s); falling back",
                        self.request_id, self.failure)
            if self.session is not None:
                await self.session.abort()
            return False
        finally:
            span.set(completed=self.completed)
            if self.failure:
                span.set(failure=self.failure)
            span.end()


# ----------------------------------------------------------------- routing


def choose_handoff_path(
    src: str,
    dst: str,
    nbytes: int,
    local: bool = False,
    persist_resident_blocks: int = 0,
    total_blocks: int = 1,
) -> tuple[str, float]:
    """Transfer-aware path choice for one (prefill, decode) pair.

    Returns ``(path, cost_s)`` with ``path`` one of ``"ici"``/``"dcn"``
    (stream the KV over the wire) or ``"persist"`` (skip the remote
    prefill's transfer: the persist index says the prefix is already
    resident, so restoring it costs a shared-store read instead).
    Costs come from the measured EWMA tables (``obs.costs.cost_s``),
    falling back to the cold-edge priors (``obs.costs.PRIORS``).  The
    persist path only competes for the fraction of blocks it actually
    holds — a partial persist hit still pays the wire for the rest.
    """
    wire = "ici" if local else "dcn"
    stream_cost = transfer_costs.cost_s(src, dst, wire, nbytes)
    blocks = max(1, int(total_blocks))
    hit = max(0, min(int(persist_resident_blocks), blocks))
    if hit == 0:
        return wire, stream_cost
    hit_bytes = nbytes * hit // blocks
    rest_bytes = nbytes - hit_bytes
    persist_cost = transfer_costs.cost_s(dst, dst, "persist", hit_bytes)
    if rest_bytes > 0:
        persist_cost += transfer_costs.cost_s(src, dst, wire, rest_bytes)
    if persist_cost < stream_cost:
        return "persist", persist_cost
    return wire, stream_cost
