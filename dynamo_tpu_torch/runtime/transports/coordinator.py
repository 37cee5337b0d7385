"""The coordinator — control/event plane for the distributed runtime.

A copy of the JAX package's ``runtime/transports/coordinator.py``: the
same ops, frames and WAL, so either package's client talks to either's
server byte for byte.

One lightweight asyncio TCP service providing exactly the primitives the
reference gets from etcd + NATS (SURVEY.md §5 "distributed communication
backend", planes 1–3):

  KV + leases + watches   — service discovery, liveness, dynamic config
                            (etcd parity: transports/etcd.rs:40-255)
  pub/sub subjects        — KV events, hit-rate events
                            (NATS core parity: transports/nats.rs)
  durable work queues     — remote prefill queue w/ ack+redelivery
                            (JetStream parity: examples/llm/utils/nats_queue.py)

Failure detection improves on the reference's TTL-only leases: a lease dies
when its owning connection drops (instant) OR when its TTL lapses without
keepalive (backstop) — so a crashed worker vanishes from discovery in
milliseconds, mirroring the etcd lease-expiry → watcher-delete path
(lib/runtime/src/transports/etcd/lease.rs:19-51, component/client.rs:145).

Protocol: two-part frames (framing.py); header {op, id, ...}; replies echo
{id}.  Server pushes carry op "watch_event" / "message" / nothing (queue
deliveries are pull-based replies).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import itertools
import json
import logging
import os
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

from dynamo_tpu_torch.obs import tracing
from dynamo_tpu_torch.runtime.transports.protocol import CoordOp
from dynamo_tpu_torch.runtime.transports.framing import (
    close_writer,
    read_frame,
    write_frame,
)
from dynamo_tpu_torch.runtime.transports.net import DEFAULT_NET

log = logging.getLogger("dynamo_tpu_torch.coordinator")

# Bound on each coordinator round-trip made while holding the heal lock:
# a stalled coordinator must surface as a ConnectionError, not
# wedge every lease writer queued behind the heal — the serve_worker
# drain path rides these locks at shutdown.
_HEAL_TIMEOUT_S = float(os.environ.get("DYNTPU_HEAL_TIMEOUT_S", "5"))

# WAL on-disk format version, written as the {"t": "ver"} head record of
# every compacted wal.jsonl (wirecheck WR004)
WAL_VERSION = 1

__all__ = ["CoordinatorServer", "CoordinatorClient"]


def _match(pattern: str, subject: str) -> bool:
    """Exact match, or prefix match when the pattern ends with '>'."""
    if pattern.endswith(">"):
        return subject.startswith(pattern[:-1])
    return pattern == subject


# ============================================================ server ==========


@dataclass
class _Lease:
    lease_id: int
    ttl: float
    expires_at: float
    keys: set[str] = field(default_factory=set)
    conn_id: int = -1


@dataclass
class _QueueItem:
    msg_id: int
    payload: bytes
    header: dict


class CoordinatorServer:
    """``data_dir`` enables durability: unleased KV and queue state are
    appended to a write-ahead log and replayed on restart, so a coordinator
    crash loses no queued remote prefill or registered config (ref: raft-
    backed etcd, transports/etcd.rs:40-255, + JetStream file store,
    examples/llm/utils/nats_queue.py:21-59).  Lease-bound keys are
    deliberately ephemeral — their owners are gone after a restart; they
    re-register through the reconnecting client."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 data_dir: Optional[str] = None, *, net=None):
        self.host = host
        self.port = port
        self._data_dir = Path(data_dir) if data_dir else None
        self._net = net if net is not None else DEFAULT_NET
        # protocol-plane seam: when set, called with a crash-point label
        # ("wal.append.kv", "wal.fsync.qpush", "frame.send.watch_event",
        # ...) at every durability and send boundary.  The checker's hook
        # raises SimulatedCrash at a chosen (label, occurrence) to model a
        # process death there; production leaves it None — one attribute
        # test per boundary, nothing else.
        self.crash_hook: Optional[Callable[[str], None]] = None
        self._wal = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._kv: dict[str, Any] = {}
        self._kv_lease: dict[str, int] = {}
        self._leases: dict[int, _Lease] = {}
        # ids seeded from a ms epoch: a RESTARTED coordinator must never
        # reissue ids (lease/watch/sub ids are client-side handles and
        # instance identities; queue msg ids gate acks — reuse would let a
        # pre-restart consumer ack away someone else's in-flight message)
        self._ids = itertools.count(self._id_epoch())
        # watches: watch_id -> (prefix, writer, conn_id)
        self._watches: dict[int, tuple[str, asyncio.StreamWriter, int]] = {}
        # subs: sub_id -> (pattern, writer, conn_id)
        self._subs: dict[int, tuple[str, asyncio.StreamWriter, int]] = {}
        self._queues: dict[str, deque[_QueueItem]] = defaultdict(deque)
        self._queue_waiters: dict[str, deque[asyncio.Future]] = defaultdict(deque)
        self._pending_acks: dict[tuple[str, int], _QueueItem] = {}
        self._conn_ids = itertools.count(1)
        self._conn_leases: dict[int, set[int]] = defaultdict(set)
        self._expiry_task: Optional[asyncio.Task] = None
        self._write_locks: dict[int, asyncio.Lock] = {}
        self._conn_writers: dict[int, asyncio.StreamWriter] = {}
        # per-connection handler tasks (spawned inside asyncio's Server)
        # — reaped in stop()
        self._conn_tasks: dict[int, Optional[asyncio.Task]] = {}
        # blob store (plane 4 — NATS object-store parity, ref
        # lib/llm/src/model_card/model.rs:150-199 publishing model
        # artifacts for remote workers): name -> {size, sha256, meta,
        # file?}.  Payload bytes live on disk under data_dir/blobs
        # (content-addressed by sha256, WAL-indexed) or in memory without
        # a data_dir.  Uploads stream in chunks so multi-GB checkpoints
        # never materialise in one frame or one buffer.
        self._blobs: dict[str, dict] = {}
        self._blob_data: dict[str, bytes] = {}
        self._blob_uploads: dict[int, dict] = {}
        # background tasks (watcher notifies, long queue pulls): retained
        # so their exceptions are logged instead of vanishing at loop
        # teardown, and drained on stop() so no task outlives the server
        self._bg_tasks: set[asyncio.Task] = set()

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_done)
        return task

    def _bg_done(self, task: asyncio.Task) -> None:
        self._bg_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            log.error("coordinator background task failed",
                      exc_info=task.exception())

    @staticmethod
    def _id_epoch() -> int:
        # ~1ms resolution wall-clock, shifted so plenty of ids fit per epoch
        return (int(time.time() * 1e3) & 0x7FFFFFFFFF) << 20

    # ------------------------------------------------------------ durability
    def _log(self, rec: dict) -> None:
        if self._wal is None:
            return
        self._wal.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._wal.flush()
        if self.crash_hook is not None:
            self.crash_hook(f"wal.append.{rec.get('t')}")

    async def _log_durable(self, rec: dict) -> None:
        """Log + fsync for records whose reply promises durability (queue
        push/ack).  The fsync runs in a worker thread — a synchronous fsync
        on the event loop would stall every connection (keepalives could
        miss their TTL behind a burst of pushes)."""
        if self._wal is None:
            return
        self._log(rec)
        fd = self._wal.fileno()
        await asyncio.get_running_loop().run_in_executor(None, os.fsync, fd)
        if self.crash_hook is not None:
            self.crash_hook(f"wal.fsync.{rec.get('t')}")

    def _recover(self) -> None:
        """Replay the WAL, then rewrite it compacted (current state only)."""
        path = self._data_dir / "wal.jsonl"
        self._data_dir.mkdir(parents=True, exist_ok=True)
        queues: dict[str, dict[int, bytes]] = defaultdict(dict)
        max_id = 0
        if path.exists():
            with path.open() as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        log.warning("truncated WAL record skipped")
                        continue  # torn tail write — ignore
                    t = rec.get("t")
                    if t == "ver":
                        # format marker written at the head of every
                        # compacted WAL; current readers only need to
                        # know it exists (unknown versions still replay
                        # best-effort — the else arm skips unknown "t")
                        pass
                    elif t == "kv":
                        self._kv[rec["key"]] = rec.get("value")
                    elif t == "kvdel":
                        self._kv.pop(rec["key"], None)
                    elif t == "qpush":
                        queues[rec["q"]][rec["mid"]] = base64.b64decode(rec["p"])
                        max_id = max(max_id, rec["mid"])
                    elif t == "qack":
                        queues[rec["q"]].pop(rec["mid"], None)
                    elif t == "blob":
                        # re-index only blobs whose payload file survived
                        if (self._data_dir / "blobs" / rec["file"]).exists():
                            self._blobs[rec["name"]] = {
                                k: rec[k]
                                for k in ("size", "sha256", "meta", "file")
                            }
                    elif t == "blobdel":
                        self._blobs.pop(rec["name"], None)
        for q, items in queues.items():
            for mid, payload in sorted(items.items()):
                self._queues[q].append(_QueueItem(mid, payload, {"queue": q}))
        self._ids = itertools.count(max(max_id + 1, self._id_epoch()))
        # compact: snapshot current state, drop the acked/deleted history
        if self.crash_hook is not None:
            self.crash_hook("wal.compact.write")
        tmp = path.with_suffix(".tmp")
        with tmp.open("w") as f:
            # version tag first (wirecheck WR004): an old server replaying
            # this file skips the unknown "t" harmlessly; a future format
            # bump flips "v" so readers can detect it
            f.write(json.dumps({"t": "ver", "v": WAL_VERSION},
                               separators=(",", ":")) + "\n")
            for key, value in self._kv.items():
                f.write(json.dumps({"t": "kv", "key": key, "value": value},
                                   separators=(",", ":")) + "\n")
            for q, dq in self._queues.items():
                for item in dq:
                    f.write(json.dumps(
                        {"t": "qpush", "q": q, "mid": item.msg_id,
                         "p": base64.b64encode(item.payload).decode()},
                        separators=(",", ":")) + "\n")
            for name, rec in self._blobs.items():
                f.write(json.dumps({"t": "blob", "name": name, **rec},
                                   separators=(",", ":")) + "\n")
            # the rewrite must be as durable as the fsynced records it
            # replaces — flush+fsync file, then fsync the dir after rename
            f.flush()
            os.fsync(f.fileno())
        if self.crash_hook is not None:
            self.crash_hook("wal.compact.rename")
        tmp.replace(path)
        # GC blob-dir litter: temp files from crashed uploads, and payload
        # files no surviving index record references
        bdir = self._data_dir / "blobs"
        if bdir.is_dir():
            referenced = {r["file"] for r in self._blobs.values()
                          if "file" in r}
            for p in bdir.iterdir():
                if p.name.startswith(".up-") or p.name not in referenced:
                    try:
                        p.unlink()
                    except OSError:
                        pass
        dir_fd = os.open(self._data_dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        if self.crash_hook is not None:
            self.crash_hook("wal.compact.done")
        self._wal = path.open("a")

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> "CoordinatorServer":
        if self._data_dir is not None:
            self._recover()
        self._server, self.port = await self._net.start_server(
            self._handle, self.host, self.port)
        self._expiry_task = asyncio.ensure_future(self._expiry_loop())
        log.info("coordinator listening on %s:%s", self.host, self.port)
        return self

    async def stop(self) -> None:
        if self._expiry_task:
            self._expiry_task.cancel()
        if self._server:
            self._server.close()
            # sever live client connections so wait_closed() returns (py3.12
            # waits on all connection handlers)
            for w in list(self._conn_writers.values()):
                w.close()
            await self._server.wait_closed()
        # on py<3.12 wait_closed() does NOT wait for connection handlers:
        # cancel-and-reap them, or each _handle task outlives the server
        # (their finally blocks still run the connection-drop cleanup)
        handlers = [t for t in self._conn_tasks.values() if t is not None]
        for t in handlers:
            t.cancel()
        if handlers:
            await asyncio.gather(*handlers, return_exceptions=True)
        # drain retained background tasks (watcher notifies, queue pulls):
        # cancel-then-gather is bounded — nothing here waits on a peer
        for t in list(self._bg_tasks):
            t.cancel()
        if self._bg_tasks:
            await asyncio.gather(*self._bg_tasks, return_exceptions=True)
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    @property
    def url(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    async def _expiry_loop(self) -> None:
        while True:
            await asyncio.sleep(0.5)
            now = time.monotonic()
            for lease in [l for l in self._leases.values() if l.expires_at < now]:
                log.info("lease %s expired", lease.lease_id)
                self._revoke_lease(lease.lease_id)

    # ------------------------------------------------------------ connection
    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn_id = next(self._conn_ids)
        self._write_locks[conn_id] = asyncio.Lock()
        self._conn_writers[conn_id] = writer
        self._conn_tasks[conn_id] = asyncio.current_task()
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                header, payload = frame
                # dtspan: commands arriving inside a request trace get a
                # server-side span (untraced commands pay one dict lookup)
                trace = tracing.extract(header)
                span = (
                    tracing.start_span(f"coord.{header.get('op')}",
                                       parent=trace)
                    if trace is not None else tracing.NOP_SPAN
                )
                try:
                    await self._dispatch(conn_id, writer, header, payload)
                except Exception as e:  # protocol-level error back to caller
                    log.exception("coordinator op failed: %s", header.get("op"))
                    await self._send(conn_id, writer, {"id": header.get("id"), "error": str(e)})
                finally:
                    span.end()
        finally:
            # connection-drop cleanup: leases, watches, subs, pending queue acks
            for lease_id in list(self._conn_leases.pop(conn_id, ())):
                self._revoke_lease(lease_id)
            for wid in [w for w, (_, _, c) in self._watches.items() if c == conn_id]:
                del self._watches[wid]
            for sid in [s for s, (_, _, c) in self._subs.items() if c == conn_id]:
                del self._subs[sid]
            for (queue, msg_id), item in list(self._pending_acks.items()):
                if item.header.get("conn_id") == conn_id:
                    del self._pending_acks[(queue, msg_id)]
                    self._queue_deliver(queue, item)
            # abandon this connection's in-flight blob uploads
            for up_id in [u for u, st in self._blob_uploads.items()
                          if st.get("conn_id") == conn_id]:
                st = self._blob_uploads.pop(up_id)
                if "file" in st:
                    st["file"].close()
                    try:
                        st["path"].unlink()
                    except OSError:
                        pass
            self._write_locks.pop(conn_id, None)
            self._conn_writers.pop(conn_id, None)
            self._conn_tasks.pop(conn_id, None)
            writer.close()

    async def _send(self, conn_id: int, writer: asyncio.StreamWriter,
                    header: dict, payload: bytes = b"") -> None:
        lock = self._write_locks.get(conn_id)
        if lock is None:
            return
        if self.crash_hook is not None:
            self.crash_hook(
                f"frame.send.{header.get('op') or 'reply'}")
        async with lock:
            try:
                write_frame(writer, header, payload)
                await writer.drain()
            except (ConnectionResetError, RuntimeError):
                pass

    # --------------------------------------------------------------- dispatch
    async def _dispatch(self, conn_id: int, writer: asyncio.StreamWriter,
                        h: dict, payload: bytes) -> None:
        op = h.get("op")
        rid = h.get("id")

        if op == CoordOp.KV_PUT or op == CoordOp.KV_CREATE or op == CoordOp.KV_CREATE_OR_VALIDATE:
            key, value = h["key"], h.get("value")
            exists = key in self._kv
            if op == CoordOp.KV_CREATE and exists:
                await self._send(conn_id, writer, {"id": rid, "ok": False, "exists": True})
                return
            if op == CoordOp.KV_CREATE_OR_VALIDATE and exists:
                ok = self._kv[key] == value
                await self._send(conn_id, writer, {"id": rid, "ok": ok, "exists": True})
                return
            # validate the lease BEFORE any mutation: a failed put must
            # leave the key's previous value, lease binding, WAL record and
            # watchers all untouched
            lease_id = h.get("lease_id")
            lease = self._leases.get(lease_id) if lease_id else None
            if lease_id and lease is None:
                await self._send(conn_id, writer, {"id": rid, "error": "no such lease"})
                return
            # an overwrite changes the key's lease binding: detach from any
            # previous lease so the old owner's expiry can't delete it
            old_lease = self._kv_lease.pop(key, None)
            if old_lease and old_lease in self._leases:
                self._leases[old_lease].keys.discard(key)
            self._kv[key] = value
            if lease is not None:
                lease.keys.add(key)
                self._kv_lease[key] = lease_id
                if not old_lease:
                    # a previously-durable value must not resurrect on
                    # restart now that the key is lease-bound (ephemeral)
                    self._log({"t": "kvdel", "key": key})
            else:
                # only unleased KV is durable; leased state dies with owners
                self._log({"t": "kv", "key": key, "value": value})
            await self._notify_watchers("put", key, value)
            await self._send(conn_id, writer, {"id": rid, "ok": True})

        elif op == CoordOp.KV_GET:
            key = h["key"]
            await self._send(conn_id, writer,
                             {"id": rid, "ok": key in self._kv, "value": self._kv.get(key)})

        elif op == CoordOp.KV_GET_PREFIX:
            prefix = h["prefix"]
            items = {k: v for k, v in self._kv.items() if k.startswith(prefix)}
            await self._send(conn_id, writer, {"id": rid, "ok": True, "items": items})

        elif op == CoordOp.KV_DELETE:
            key = h["key"]
            existed = self._delete_key(key)
            await self._send(conn_id, writer, {"id": rid, "ok": existed})

        elif op == CoordOp.WATCH:
            prefix = h["prefix"]
            watch_id = next(self._ids)
            self._watches[watch_id] = (prefix, writer, conn_id)
            # initial snapshot as put events (etcd get+watch pattern)
            snapshot = {k: v for k, v in self._kv.items() if k.startswith(prefix)}
            await self._send(conn_id, writer,
                             {"id": rid, "ok": True, "watch_id": watch_id, "snapshot": snapshot})

        elif op == CoordOp.UNWATCH:
            self._watches.pop(h["watch_id"], None)
            await self._send(conn_id, writer, {"id": rid, "ok": True})

        elif op == CoordOp.LEASE_CREATE:
            ttl = float(h.get("ttl", 10.0))
            lease_id = next(self._ids)
            self._leases[lease_id] = _Lease(
                lease_id, ttl, time.monotonic() + ttl, conn_id=conn_id
            )
            self._conn_leases[conn_id].add(lease_id)
            await self._send(conn_id, writer, {"id": rid, "ok": True, "lease_id": lease_id})

        elif op == CoordOp.LEASE_KEEPALIVE:
            lease = self._leases.get(h["lease_id"])
            if lease:
                lease.expires_at = time.monotonic() + lease.ttl
            await self._send(conn_id, writer, {"id": rid, "ok": lease is not None})

        elif op == CoordOp.LEASE_REVOKE:
            self._revoke_lease(h["lease_id"])
            await self._send(conn_id, writer, {"id": rid, "ok": True})

        elif op == CoordOp.SUBSCRIBE:
            sub_id = next(self._ids)
            self._subs[sub_id] = (h["subject"], writer, conn_id)
            await self._send(conn_id, writer, {"id": rid, "ok": True, "sub_id": sub_id})

        elif op == CoordOp.UNSUBSCRIBE:
            self._subs.pop(h["sub_id"], None)
            await self._send(conn_id, writer, {"id": rid, "ok": True})

        elif op == CoordOp.PUBLISH:
            subject = h["subject"]
            n = 0
            for sub_id, (pattern, w, cid) in list(self._subs.items()):
                if _match(pattern, subject):
                    await self._send(cid, w, {"op": CoordOp.MESSAGE, "sub_id": sub_id,
                                              "subject": subject}, payload)
                    n += 1
            await self._send(conn_id, writer, {"id": rid, "ok": True, "delivered": n})

        elif op == CoordOp.QUEUE_PUSH:
            item = _QueueItem(next(self._ids), payload, {"queue": h["queue"]})
            await self._log_durable({"t": "qpush", "q": h["queue"], "mid": item.msg_id,
                                     "p": base64.b64encode(payload).decode()})
            self._queue_deliver(h["queue"], item)
            await self._send(conn_id, writer, {"id": rid, "ok": True, "msg_id": item.msg_id})

        elif op == CoordOp.QUEUE_PULL:
            # run as a task: a long pull must not stall this connection's
            # dispatch loop (keepalives and other ops share the socket)
            async def _pull(queue=h["queue"], timeout=h.get("timeout_ms", 0) / 1e3, rid=rid):
                item = await self._queue_take(queue, timeout)
                if item is None:
                    await self._send(conn_id, writer, {"id": rid, "ok": False, "empty": True})
                    return
                if conn_id not in self._write_locks:
                    # the puller's connection died while we waited: its
                    # cleanup sweep (the _handle finally) has already run,
                    # so registering into _pending_acks now would strand
                    # the item forever — no conn-drop pass will ever
                    # redeliver it.  Found by the protocol plane's
                    # queue-sever exploration (no_lost_messages).
                    self._queue_deliver(queue, item)
                    return
                item.header["conn_id"] = conn_id
                self._pending_acks[(queue, item.msg_id)] = item
                await self._send(conn_id, writer,
                                 {"id": rid, "ok": True, "msg_id": item.msg_id}, item.payload)

            self._spawn(_pull())

        elif op == CoordOp.QUEUE_ACK:
            key = (h["queue"], h["msg_id"])
            ok = self._pending_acks.pop(key, None) is not None
            if ok:
                await self._log_durable(
                    {"t": "qack", "q": h["queue"], "mid": h["msg_id"]}
                )
            await self._send(conn_id, writer, {"id": rid, "ok": ok})

        elif op == CoordOp.QUEUE_NACK:
            key = (h["queue"], h["msg_id"])
            item = self._pending_acks.pop(key, None)
            if item is not None:
                self._queue_deliver(h["queue"], item)
            await self._send(conn_id, writer, {"id": rid, "ok": item is not None})

        elif op == CoordOp.QUEUE_LEN:
            n = len(self._queues[h["queue"]]) + sum(
                1 for (q, _) in self._pending_acks if q == h["queue"]
            )
            await self._send(conn_id, writer, {"id": rid, "ok": True, "len": n})

        elif op == CoordOp.BLOB_BEGIN:
            up_id = next(self._ids)
            st: dict = {"conn_id": conn_id, "size": 0,
                        "sha": hashlib.sha256()}
            if self._data_dir is not None:
                bdir = self._data_dir / "blobs"
                bdir.mkdir(parents=True, exist_ok=True)
                st["path"] = bdir / f".up-{up_id}"
                st["file"] = st["path"].open("wb")
            else:
                st["buf"] = bytearray()
            self._blob_uploads[up_id] = st
            await self._send(conn_id, writer,
                             {"id": rid, "ok": True, "upload_id": up_id})

        elif op == CoordOp.BLOB_CHUNK:
            st = self._blob_uploads.get(h["upload_id"])
            if st is None:
                await self._send(conn_id, writer,
                                 {"id": rid, "error": "no such upload"})
                return
            st["sha"].update(payload)
            st["size"] += len(payload)
            if "file" in st:
                # file IO off the event loop: a slow disk must not stall
                # every connection's dispatch
                await asyncio.get_running_loop().run_in_executor(
                    None, st["file"].write, payload
                )
            else:
                st["buf"] += payload
            await self._send(conn_id, writer, {"id": rid, "ok": True})

        elif op == CoordOp.BLOB_COMMIT:
            st = self._blob_uploads.pop(h["upload_id"], None)
            if st is None:
                await self._send(conn_id, writer,
                                 {"id": rid, "error": "no such upload"})
                return
            name = h["name"]
            sha = st["sha"].hexdigest()
            rec = {"size": st["size"], "sha256": sha,
                   "meta": h.get("meta") or {}}
            if "file" in st:
                def _finalize(f=st["file"], src=st["path"],
                              dst=self._data_dir / "blobs" / sha):
                    # flush+fsync of a multi-GB upload off the event loop
                    # (a sync fsync here would stall every connection —
                    # keepalives would miss TTLs behind one big commit);
                    # content-addressed final name: identical re-pushes
                    # and same-bytes-different-name blobs share one file
                    f.flush()
                    os.fsync(f.fileno())
                    f.close()
                    os.replace(src, dst)

                await asyncio.get_running_loop().run_in_executor(
                    None, _finalize
                )
                rec["file"] = sha
                # durable like queue pushes: the ok reply PROMISES the
                # blob survives a crash, so the index record must be
                # fsynced, not merely flushed
                await self._log_durable({"t": "blob", "name": name, **rec})
            else:
                self._blob_data[name] = bytes(st.pop("buf"))
            old = self._blobs.get(name)
            self._blobs[name] = rec
            # GC a superseded payload file nothing references any more
            if old and "file" in old and old["file"] != rec.get("file") \
                    and not any(r.get("file") == old["file"]
                                for r in self._blobs.values()):
                try:
                    (self._data_dir / "blobs" / old["file"]).unlink()
                except OSError:
                    pass
            await self._send(conn_id, writer,
                             {"id": rid, "ok": True, "size": rec["size"],
                              "sha256": sha})

        elif op == CoordOp.BLOB_READ:
            rec = self._blobs.get(h["name"])
            if rec is None:
                await self._send(conn_id, writer,
                                 {"id": rid, "ok": False, "missing": True})
                return
            off = max(0, int(h.get("offset", 0)))
            ln = min(max(1, int(h.get("length", 1 << 20))), 4 << 20)
            if "file" in rec:
                path = self._data_dir / "blobs" / rec["file"]

                def _read(path=path, off=off, ln=ln):
                    with path.open("rb") as f:
                        f.seek(off)
                        return f.read(ln)

                data = await asyncio.get_running_loop().run_in_executor(
                    None, _read
                )
            else:
                data = self._blob_data.get(h["name"], b"")[off:off + ln]
            await self._send(
                conn_id, writer,
                {"id": rid, "ok": True, "size": rec["size"],
                 "sha256": rec["sha256"], "meta": rec["meta"],
                 "eof": off + len(data) >= rec["size"]},
                data,
            )

        elif op == CoordOp.BLOB_STAT:
            rec = self._blobs.get(h["name"])
            await self._send(conn_id, writer,
                             {"id": rid, "ok": rec is not None,
                              **(rec and {k: rec[k] for k in
                                          ("size", "sha256", "meta")} or {})})

        elif op == CoordOp.BLOB_LIST:
            prefix = h.get("prefix", "")
            items = {
                n: {k: r[k] for k in ("size", "sha256", "meta")}
                for n, r in self._blobs.items() if n.startswith(prefix)
            }
            await self._send(conn_id, writer,
                             {"id": rid, "ok": True, "items": items})

        elif op == CoordOp.BLOB_DELETE:
            rec = self._blobs.pop(h["name"], None)
            self._blob_data.pop(h["name"], None)
            if rec is not None and "file" in rec:
                self._log({"t": "blobdel", "name": h["name"]})
                # drop the payload file only when no other name shares it
                if not any(r.get("file") == rec["file"]
                           for r in self._blobs.values()):
                    try:
                        (self._data_dir / "blobs" / rec["file"]).unlink()
                    except OSError:
                        pass
            await self._send(conn_id, writer,
                             {"id": rid, "ok": rec is not None})

        elif op == CoordOp.PING:
            await self._send(conn_id, writer, {"id": rid, "ok": True})

        else:
            await self._send(conn_id, writer, {"id": rid, "error": f"unknown op {op!r}"})

    # ----------------------------------------------------------------- helpers
    def _delete_key(self, key: str) -> bool:
        existed = self._kv.pop(key, None) is not None
        lease_id = self._kv_lease.pop(key, None)
        if lease_id and lease_id in self._leases:
            self._leases[lease_id].keys.discard(key)
        if existed:
            if not lease_id:
                self._log({"t": "kvdel", "key": key})
            self._spawn(self._notify_watchers("delete", key, None))
        return existed

    def _revoke_lease(self, lease_id: int) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        self._conn_leases.get(lease.conn_id, set()).discard(lease_id)
        for key in list(lease.keys):
            self._kv.pop(key, None)
            self._kv_lease.pop(key, None)
            # a pre-lease durable value must not resurrect on restart
            self._log({"t": "kvdel", "key": key})
            self._spawn(self._notify_watchers("delete", key, None))

    async def _notify_watchers(self, event: str, key: str, value: Any) -> None:
        for watch_id, (prefix, writer, conn_id) in list(self._watches.items()):
            if key.startswith(prefix):
                await self._send(conn_id, writer, {
                    "op": CoordOp.WATCH_EVENT, "watch_id": watch_id,
                    "event": event, "key": key, "value": value,
                })

    def _queue_deliver(self, queue: str, item: _QueueItem) -> None:
        waiters = self._queue_waiters[queue]
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(item)
                return
        self._queues[queue].append(item)

    async def _queue_take(self, queue: str, timeout: float) -> Optional[_QueueItem]:
        q = self._queues[queue]
        if q:
            return q.popleft()
        if timeout <= 0:
            return None
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._queue_waiters[queue].append(fut)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return None


# ============================================================ client ==========


class CoordinatorClient:
    """Async client. Watches and subscriptions deliver via callbacks
    (scheduled on the client's event loop).

    ``reconnect=True`` makes the client survive a coordinator restart: on
    connection loss it redials with backoff and RE-REGISTERS its watches,
    subscriptions, leases, and lease-bound keys (fresh server-side ids,
    stable client-side handles) — so worker discovery heals without any
    caller code.  In-flight calls at the moment of disconnect still raise
    ConnectionError; callers retry (the workers' pull loops already do)."""

    def __init__(self, url: str, reconnect: bool = False, *, net=None):
        # url: tcp://host:port
        hostport = url.split("//", 1)[-1]
        host, port = hostport.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.reconnect = reconnect
        self._net = net if net is not None else DEFAULT_NET
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._read_task: Optional[asyncio.Task] = None
        self._keepalive_tasks: dict[int, asyncio.Task] = {}
        self._write_lock = asyncio.Lock()
        self.closed = asyncio.Event()
        self._closing = False
        # Callbacks are keyed by stable client-side HANDLES (the first
        # server id ever issued); live server ids map back to handles via
        # the *_by_srv tables, rebuilt wholesale on reconnect — so a
        # restarted server reusing id numbers can never misdirect or drop
        # a callback.
        self._watch_cbs: dict[int, Callable[[str, str, Any], None]] = {}
        self._watch_reg: dict[int, str] = {}          # handle -> prefix
        self._watch_by_srv: dict[int, int] = {}       # live watch_id -> handle
        self._watch_keys: dict[int, set] = {}         # handle -> known keys
        self._sub_cbs: dict[int, Callable[[str, bytes], None]] = {}
        self._sub_reg: dict[int, str] = {}            # handle -> subject
        self._sub_by_srv: dict[int, int] = {}         # live sub_id -> handle
        self._lease_srv: dict[int, int] = {}          # handle -> live lease_id
        self._lease_reg: dict[int, float] = {}        # handle -> ttl
        # key -> (value, lease handle, create-exclusive): the flag records
        # kv_create-established keys so heals re-acquire with kv_create
        # (never silently overwriting a new owner's claim)
        self._leased_kv: dict[str, tuple[Any, int, bool]] = {}
        self._reconnect_task: Optional[asyncio.Task] = None
        self._heal_lock = asyncio.Lock()  # serializes expired-lease heals
        self._reconnecting = False
        self._connected = asyncio.Event()  # socket open (internal sends ok)
        self._ready = asyncio.Event()      # re-registration done (user sends ok)
        self._epoch = 0  # bumped on every disconnect; guards stale writes

    async def connect(self) -> "CoordinatorClient":
        self._reader, self._writer = await self._net.open_connection(self.host, self.port)
        self._connected.set()
        self._ready.set()
        self._read_task = asyncio.ensure_future(self._read_loop())
        return self

    async def close(self) -> None:
        self._closing = True
        for t in self._keepalive_tasks.values():
            t.cancel()
        if self._reconnect_task:
            self._reconnect_task.cancel()
        if self._read_task:
            self._read_task.cancel()
        # close AND await the transport teardown (bounded) — stopping at
        # close() leaves a live TCP transport behind at loop shutdown;
        # null the reference so a repeated close() cannot double-close
        await close_writer(self._writer)
        self._writer = None
        self._connected.clear()
        self.closed.set()

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await read_frame(self._reader)
                if frame is None:
                    break
                header, payload = frame
                op = header.get("op")
                if op == CoordOp.WATCH_EVENT:
                    handle = self._watch_by_srv.get(header["watch_id"])
                    cb = self._watch_cbs.get(handle)
                    if cb:
                        key = header["key"]
                        known = self._watch_keys.setdefault(handle, set())
                        if header["event"] == "put":
                            known.add(key)
                        else:
                            known.discard(key)
                        cb(header["event"], key, header.get("value"))
                elif op == CoordOp.MESSAGE:
                    handle = self._sub_by_srv.get(header["sub_id"])
                    cb = self._sub_cbs.get(handle)
                    if cb:
                        cb(header["subject"], payload)
                else:
                    fut = self._pending.pop(header.get("id"), None)
                    if fut and not fut.done():
                        fut.set_result((header, payload))
        except asyncio.CancelledError:
            pass
        finally:
            # mark disconnected FIRST so no new _call can slip a future in
            # after the sweep below (it would hang forever)
            self._epoch += 1
            self._connected.clear()
            self._ready.clear()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("coordinator connection lost"))
            self._pending.clear()
            if self.reconnect and not self._closing and not self._reconnecting:
                self._reconnect_task = asyncio.ensure_future(self._reconnect_loop())
            elif not self._reconnecting:
                self.closed.set()

    async def _reconnect_loop(self) -> None:
        """Sole owner of redial + re-registration.  A connection that dies
        again mid-re-registration is retried HERE (the dying read loop sees
        _reconnecting and does not spawn a second loop)."""
        self._reconnecting = True
        delay = 0.1
        try:
            while not self._closing:
                # tear down the dead socket first: a server-side sever
                # only half-closes it (EOF), and replacing the reference
                # without closing leaks the old transport at every redial
                if self._writer is not None:
                    try:
                        await close_writer(self._writer)
                    except Exception:
                        log.debug("closing severed writer failed",
                                  exc_info=True)
                    self._writer = None
                try:
                    self._reader, self._writer = await self._net.open_connection(
                        self.host, self.port
                    )
                except OSError:
                    await asyncio.sleep(delay)
                    delay = min(delay * 1.6, 3.0)
                    continue
                self._connected.set()
                self._read_task = asyncio.ensure_future(self._read_loop())
                try:
                    await self._reregister()
                    # only now may USER calls flow: earlier they would hit
                    # stale lease mappings mid-re-registration
                    self._ready.set()
                    log.info("coordinator client reconnected to %s:%s",
                             self.host, self.port)
                    return
                except Exception:
                    log.exception("re-registration failed; redialing")
                    self._connected.clear()
                    try:
                        await close_writer(self._writer)
                    except Exception:
                        log.debug("closing stale writer failed",
                                  exc_info=True)
                    self._writer = None  # the next dial replaces it
                    await asyncio.sleep(delay)
        finally:
            self._reconnecting = False
            if self._closing or not self._connected.is_set():
                self.closed.set()

    async def _reregister(self) -> None:
        """Re-establish server-side state under the fresh connection."""
        self._watch_by_srv.clear()
        self._sub_by_srv.clear()
        for handle, prefix in list(self._watch_reg.items()):
            resp, _ = await self._call({"op": CoordOp.WATCH, "prefix": prefix}, _internal=True)
            self._watch_by_srv[resp["watch_id"]] = handle
            cb = self._watch_cbs.get(handle)
            snapshot = resp.get("snapshot", {})
            if cb:
                # synthesize deletes for keys that vanished while we were
                # down (e.g. a worker that crashed during the outage), then
                # replay the snapshot as puts
                known = self._watch_keys.setdefault(handle, set())
                for k in sorted(known - set(snapshot)):
                    cb("delete", k, None)
                for k, v in snapshot.items():
                    cb("put", k, v)
            self._watch_keys[handle] = set(snapshot)
        for handle, subject in list(self._sub_reg.items()):
            resp, _ = await self._call({"op": CoordOp.SUBSCRIBE, "subject": subject}, _internal=True)
            self._sub_by_srv[resp["sub_id"]] = handle
        for handle, ttl in list(self._lease_reg.items()):
            resp, _ = await self._call({"op": CoordOp.LEASE_CREATE, "ttl": ttl}, _internal=True)
            self._lease_srv[handle] = resp["lease_id"]
        for key, (value, lease_handle, created) in list(self._leased_kv.items()):
            live = self._lease_srv.get(lease_handle)
            if live is None:
                continue  # lease was revoked — never resurrect the key
            if created:
                # same race as the connected-expiry heal: the outage may
                # have outlived the lease TTL, and another process may
                # have legitimately claimed the key since — re-acquire
                # with create-exclusivity.  On conflict, an existing key
                # holding OUR value is the brief-drop case (the server
                # kept our old binding; its old lease will expire) — take
                # it over by rebinding to the fresh lease.  A different
                # value is a new owner: cede.
                resp, _ = await self._call({
                    "op": CoordOp.KV_CREATE, "key": key, "value": value,
                    "lease_id": live,
                }, _internal=True)
                if not resp.get("ok"):
                    cur, _ = await self._call(
                        {"op": CoordOp.KV_GET, "key": key}, _internal=True)
                    if cur.get("ok") and cur.get("value") == value:
                        await self._call({
                            "op": CoordOp.KV_PUT, "key": key, "value": value,
                            "lease_id": live,
                        }, _internal=True)
                    else:
                        log.warning(
                            "reconnect: key %s was claimed by another "
                            "owner during the outage; ceding it", key)
                        del self._leased_kv[key]
            else:
                await self._call({
                    "op": CoordOp.KV_PUT, "key": key, "value": value,
                    "lease_id": live,
                }, _internal=True)

    async def _call(self, header: dict, payload: bytes = b"",
                    _internal: bool = False) -> tuple[dict, bytes]:
        # Never write to a stale half-closed socket (the frame would
        # buffer silently and the future hang forever) — but a
        # reconnecting client WAITS OUT the redial window instead of
        # failing every in-flight caller for a transient drop (an event
        # loop stalled behind an XLA compile is enough to drop the
        # connection under load).  User calls additionally wait out
        # re-registration (lease-handle mappings are stale until it
        # completes); _reregister's own calls ride on _connected alone.
        gate = self._connected if _internal else self._ready
        if not gate.is_set():
            if self._closing or not self.reconnect:
                raise ConnectionError("coordinator disconnected")
            # race the redial against close(): a closing client must not
            # strand callers for the full grace
            g = asyncio.ensure_future(gate.wait())
            c = asyncio.ensure_future(self.closed.wait())
            try:
                await asyncio.wait(
                    {g, c}, return_when=asyncio.FIRST_COMPLETED,
                    timeout=float(os.environ.get("DYNTPU_RECONNECT_GRACE", "10")),
                )
            finally:
                g.cancel()
                c.cancel()
            if not gate.is_set():
                raise ConnectionError("coordinator disconnected")
        epoch = self._epoch
        rid = next(self._ids)
        header["id"] = rid
        tracing.inject(header)  # dtspan: carry the caller's trace context
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        async with self._write_lock:
            if epoch != self._epoch or not self._connected.is_set():
                self._pending.pop(rid, None)
                raise ConnectionError("coordinator disconnected")
            write_frame(self._writer, header, payload)
            await self._writer.drain()
        resp, pl = await fut
        if "error" in resp:
            raise RuntimeError(f"coordinator error: {resp['error']}")
        return resp, pl

    # ----------------------------------------------------------------- KV API
    async def _lease_call(self, header: dict, lease_handle: Optional[int]):
        """``_call`` with the lease handle resolved to its live server id,
        healing an expired-but-keepalive'd lease ONCE on 'no such lease'.

        The keepalive loop heals expiries on its half-TTL tick; a leased
        write landing INSIDE that window (expiry → next tick) would
        otherwise fail hard for a process that is demonstrably alive."""
        try:
            return await self._call(dict(
                header, lease_id=self._lease_srv.get(lease_handle, lease_handle)))
        except RuntimeError as e:
            if "no such lease" not in str(e) or self._closing \
                    or lease_handle not in self._lease_reg \
                    or lease_handle not in self._keepalive_tasks:
                # only keepalive'd leases heal — expiry of an
                # auto_keepalive=False lease is a deliberate signal
                raise
            await self._heal_expired_lease(
                lease_handle, self._lease_reg[lease_handle])
            return await self._call(dict(
                header, lease_id=self._lease_srv.get(lease_handle, lease_handle)))

    async def kv_put(self, key: str, value: Any, lease_id: Optional[int] = None) -> None:
        await self._lease_call(
            {"op": CoordOp.KV_PUT, "key": key, "value": value}, lease_id)
        if lease_id and self.reconnect:
            # a value update must not erase the key's create-exclusive
            # ownership record — heals would revert to blind overwrite
            prev = self._leased_kv.get(key)
            self._leased_kv[key] = (value, lease_id, bool(prev and prev[2]))

    async def kv_create(self, key: str, value: Any, lease_id: Optional[int] = None) -> bool:
        resp, _ = await self._lease_call(
            {"op": CoordOp.KV_CREATE, "key": key, "value": value}, lease_id)
        ok = bool(resp.get("ok"))
        if ok and lease_id and self.reconnect:
            self._leased_kv[key] = (value, lease_id, True)
        return ok

    async def kv_create_or_validate(self, key: str, value: Any) -> bool:
        resp, _ = await self._call({"op": CoordOp.KV_CREATE_OR_VALIDATE, "key": key, "value": value})
        return bool(resp.get("ok"))

    async def kv_get(self, key: str) -> Optional[Any]:
        resp, _ = await self._call({"op": CoordOp.KV_GET, "key": key})
        return resp.get("value") if resp.get("ok") else None

    async def kv_get_prefix(self, prefix: str) -> dict[str, Any]:
        resp, _ = await self._call({"op": CoordOp.KV_GET_PREFIX, "prefix": prefix})
        return resp.get("items", {})

    async def kv_delete(self, key: str) -> bool:
        self._leased_kv.pop(key, None)
        resp, _ = await self._call({"op": CoordOp.KV_DELETE, "key": key})
        return bool(resp.get("ok"))

    async def watch(
        self, prefix: str, callback: Callable[[str, str, Any], None]
    ) -> tuple[int, dict[str, Any]]:
        """Watch a prefix; callback(event, key, value).  Returns
        (watch_id, snapshot-at-watch-start)."""
        resp, _ = await self._call({"op": CoordOp.WATCH, "prefix": prefix})
        handle = resp["watch_id"]  # stable client handle = first server id
        self._watch_cbs[handle] = callback
        self._watch_by_srv[handle] = handle
        self._watch_reg[handle] = prefix
        snapshot = resp.get("snapshot", {})
        self._watch_keys[handle] = set(snapshot)
        return handle, snapshot

    async def unwatch(self, watch_id: int) -> None:
        self._watch_reg.pop(watch_id, None)
        self._watch_cbs.pop(watch_id, None)
        self._watch_keys.pop(watch_id, None)
        live = next(
            (s for s, h in self._watch_by_srv.items() if h == watch_id), watch_id
        )
        self._watch_by_srv.pop(live, None)
        await self._call({"op": CoordOp.UNWATCH, "watch_id": live})

    # -------------------------------------------------------------- lease API
    async def lease_create(self, ttl: float = 10.0, auto_keepalive: bool = True) -> int:
        resp, _ = await self._call({"op": CoordOp.LEASE_CREATE, "ttl": ttl})
        lease_id = resp["lease_id"]
        if self.reconnect:
            self._lease_srv[lease_id] = lease_id
            self._lease_reg[lease_id] = ttl
        if auto_keepalive:
            self._keepalive_tasks[lease_id] = asyncio.ensure_future(
                self._keepalive_loop(lease_id, ttl)
            )
        return lease_id

    async def _keepalive_loop(self, handle: int, ttl: float) -> None:
        # half-TTL ticks (ref transports/etcd/lease.rs:51); resolve the
        # handle each tick — reconnection swaps the server-side lease id
        while True:
            try:
                await asyncio.sleep(ttl / 2)
                resp, _ = await self._call({
                    "op": CoordOp.LEASE_KEEPALIVE,
                    "lease_id": self._lease_srv.get(handle, handle),
                })
                if not resp.get("ok") and handle in self._lease_reg \
                        and not self._closing:
                    # expired while CONNECTED (e.g. the event loop stalled
                    # past the TTL behind a long compile): the server
                    # already dropped the lease and deleted its keys.  The
                    # process is alive, so heal exactly like a reconnect
                    # does — fresh lease, re-put this lease's keys (the
                    # discovery watchers see delete→put and re-add us).
                    await self._heal_expired_lease(handle, ttl)
            except asyncio.CancelledError:
                return
            except (ConnectionError, RuntimeError, OSError):
                if not self.reconnect or self._closing:
                    return  # without reconnect, a lost lease stays lost

    async def _heal_expired_lease(self, handle: int, ttl: float) -> None:
        # serialize heals: the keepalive tick and any number of inline
        # _lease_call heals can race — interleaved lease_create/re-put
        # would strand keys on an orphaned (un-keepalive'd) lease.
        # Every round-trip under the lock is bounded: a stalled
        # coordinator surfaces as ConnectionError instead of wedging the
        # writers — and the serve_worker drain — queued behind the heal.
        async with self._heal_lock:
            try:
                probe, _ = await asyncio.wait_for(self._call({
                    "op": CoordOp.LEASE_KEEPALIVE,
                    "lease_id": self._lease_srv.get(handle, handle),
                }), _HEAL_TIMEOUT_S)
                if probe.get("ok"):
                    return  # another heal won while we waited on the lock
                resp, _ = await asyncio.wait_for(
                    self._call({"op": CoordOp.LEASE_CREATE, "ttl": ttl}),
                    _HEAL_TIMEOUT_S)
                live = resp["lease_id"]
                log.warning(
                    "lease %x expired while connected; healed as %x and "
                    "re-putting keys", handle, live,
                )
                for key, (value, lh, created) in list(self._leased_kv.items()):
                    if lh != handle:
                        continue
                    if created:
                        # the server-side expiry DELETED the key, so
                        # another process may have legitimately claimed it
                        # since — re-acquire with create-exclusivity and
                        # cede on conflict instead of silently overwriting
                        # the new owner's value and rebinding it to the
                        # healed lease
                        resp, _ = await asyncio.wait_for(self._call({
                            "op": CoordOp.KV_CREATE, "key": key, "value": value,
                            "lease_id": live,
                        }), _HEAL_TIMEOUT_S)
                        if not resp.get("ok"):
                            log.warning(
                                "heal: key %s was claimed by another owner "
                                "during lease expiry; ceding it", key)
                            del self._leased_kv[key]
                    else:
                        await asyncio.wait_for(self._call({
                            "op": CoordOp.KV_PUT, "key": key, "value": value,
                            "lease_id": live,
                        }), _HEAL_TIMEOUT_S)
            except asyncio.TimeoutError:
                raise ConnectionError(
                    "coordinator stalled during lease heal"
                ) from None
            # publish the mapping only AFTER the re-puts: a concurrent
            # writer meanwhile resolves the dead id, fails, and queues
            # behind the heal lock — its retry then lands strictly after
            # these re-puts, so a fresh value can never be reverted by
            # the heal's snapshot
            self._lease_srv[handle] = live

    async def lease_revoke(self, lease_id: int) -> None:
        t = self._keepalive_tasks.pop(lease_id, None)
        if t:
            t.cancel()
        self._lease_reg.pop(lease_id, None)
        # revoked keys must not resurrect through post-reconnect re-puts
        for key in [k for k, v in self._leased_kv.items() if v[1] == lease_id]:
            del self._leased_kv[key]
        live = self._lease_srv.pop(lease_id, lease_id)
        await self._call({"op": CoordOp.LEASE_REVOKE, "lease_id": live})

    # ------------------------------------------------------------- pub/sub API
    async def subscribe(self, subject: str, callback: Callable[[str, bytes], None]) -> int:
        resp, _ = await self._call({"op": CoordOp.SUBSCRIBE, "subject": subject})
        handle = resp["sub_id"]
        self._sub_cbs[handle] = callback
        self._sub_by_srv[handle] = handle
        self._sub_reg[handle] = subject
        return handle

    async def unsubscribe(self, sub_id: int) -> None:
        self._sub_reg.pop(sub_id, None)
        self._sub_cbs.pop(sub_id, None)
        live = next(
            (s for s, h in self._sub_by_srv.items() if h == sub_id), sub_id
        )
        self._sub_by_srv.pop(live, None)
        await self._call({"op": CoordOp.UNSUBSCRIBE, "sub_id": live})

    async def publish(self, subject: str, payload: bytes | dict) -> int:
        if isinstance(payload, dict):
            payload = json.dumps(payload).encode()
        resp, _ = await self._call({"op": CoordOp.PUBLISH, "subject": subject}, payload)
        return resp.get("delivered", 0)

    # --------------------------------------------------------------- queue API
    async def queue_push(self, queue: str, payload: bytes | dict) -> int:
        if isinstance(payload, dict):
            payload = json.dumps(payload).encode()
        resp, _ = await self._call({"op": CoordOp.QUEUE_PUSH, "queue": queue}, payload)
        return resp["msg_id"]

    async def queue_pull(self, queue: str, timeout_s: float = 0.0) -> Optional[tuple[int, bytes]]:
        resp, payload = await self._call(
            {"op": CoordOp.QUEUE_PULL, "queue": queue, "timeout_ms": int(timeout_s * 1e3)}
        )
        if not resp.get("ok"):
            return None
        return resp["msg_id"], payload

    async def queue_len(self, queue: str) -> int:
        """Depth incl. unacked deliveries (disagg router backpressure input)."""
        resp, _ = await self._call({"op": CoordOp.QUEUE_LEN, "queue": queue})
        return int(resp.get("len", 0))

    async def queue_ack(self, queue: str, msg_id: int) -> None:
        await self._call({"op": CoordOp.QUEUE_ACK, "queue": queue, "msg_id": msg_id})

    async def queue_nack(self, queue: str, msg_id: int) -> None:
        await self._call({"op": CoordOp.QUEUE_NACK, "queue": queue, "msg_id": msg_id})

    # ---------------------------------------------------------------- blob API
    async def blob_put(self, name: str, data, meta: Optional[dict] = None,
                       chunk_size: int = 1 << 20) -> dict:
        """Upload a blob: ``data`` is bytes or a filesystem path (streamed
        in chunks — a multi-GB checkpoint never materialises in memory).
        Returns {size, sha256}."""
        resp, _ = await self._call({"op": CoordOp.BLOB_BEGIN})
        up = resp["upload_id"]

        def chunks():
            if isinstance(data, (bytes, bytearray, memoryview)):
                b = bytes(data)
                for i in range(0, max(len(b), 1), chunk_size):
                    yield b[i:i + chunk_size]
            else:
                with open(data, "rb") as f:
                    while True:
                        b = f.read(chunk_size)
                        if not b:
                            return
                        yield b

        for c in chunks():
            await self._call({"op": CoordOp.BLOB_CHUNK, "upload_id": up}, c)
        resp, _ = await self._call(
            {"op": CoordOp.BLOB_COMMIT, "upload_id": up, "name": name,
             "meta": meta or {}}
        )
        return {"size": resp["size"], "sha256": resp["sha256"]}

    async def blob_get(self, name: str, dest=None,
                       chunk_size: int = 1 << 20):
        """Download a blob.  Returns the bytes, or — with ``dest`` (a
        path) — streams to ``dest``.part and renames on completion, so a
        failed or interrupted get never truncates or half-overwrites an
        existing destination.  Returns {size, sha256, meta}."""
        import os as _os

        off = 0
        part = f"{dest}.part" if dest is not None else None
        sink = None  # opened lazily after the first successful read
        buf = bytearray()
        ok = False
        try:
            while True:
                resp, payload = await self._call(
                    {"op": CoordOp.BLOB_READ, "name": name, "offset": off,
                     "length": chunk_size}
                )
                if not resp.get("ok"):
                    raise KeyError(f"no such blob: {name}")
                if dest is not None:
                    if sink is None:
                        sink = open(part, "wb")
                    sink.write(payload)
                else:
                    buf += payload
                off += len(payload)
                if resp.get("eof") or not payload:
                    meta = {"size": resp["size"], "sha256": resp["sha256"],
                            "meta": resp.get("meta", {})}
                    ok = True
                    break
        finally:
            if sink is not None:
                sink.close()
            if dest is not None:
                if ok:
                    if sink is None:  # zero-byte blob: still produce dest
                        open(part, "wb").close()
                    _os.replace(part, dest)
                else:
                    try:
                        _os.unlink(part)
                    except OSError:
                        pass
        return meta if dest is not None else bytes(buf)

    async def blob_stat(self, name: str) -> Optional[dict]:
        resp, _ = await self._call({"op": CoordOp.BLOB_STAT, "name": name})
        if not resp.get("ok"):
            return None
        return {k: resp[k] for k in ("size", "sha256", "meta")}

    async def blob_list(self, prefix: str = "") -> dict[str, dict]:
        resp, _ = await self._call({"op": CoordOp.BLOB_LIST, "prefix": prefix})
        return resp.get("items", {})

    async def blob_delete(self, name: str) -> bool:
        resp, _ = await self._call({"op": CoordOp.BLOB_DELETE, "name": name})
        return bool(resp.get("ok"))

    async def ping(self) -> bool:
        resp, _ = await self._call({"op": CoordOp.PING})
        return bool(resp.get("ok"))
