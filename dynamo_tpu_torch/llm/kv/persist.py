"""Persistent prefix-cache tier: content-addressed KV block store on disk.

The counterpart of ``dynamo_tpu/llm/kv/persist.py``, with its file format
byte for byte, so a store directory written by either package is read by
the other.  The fourth KV tier, below the device cache (KvBlockManager),
host RAM (HostKvPool) and the transfer plane (kv/transfer.py).  Blocks the
host pool publishes spill here from the kv-offload thread as block-group
files; ``EngineCore._restore_from_host`` falls through to this index when
the host pool misses, so a worker restart — or a replica that never
prefilled the prompt — re-enters the prefix as ``cached_tokens`` exactly
like a warm radix hit.

Key scheme: the chained xxh3-64 sequence hashes (dynamo_tpu_torch.tokens,
seed 1337) already commit to their entire prefix, so a flat
hash → (file, row) index gives true prefix-match semantics with no tree.
A *generation tag* (a hash of the model/cache identity, computed by the
engine) namespaces the store directory: a model or cache-layout change
opens a fresh generation and deletes the stale ones.

File format (one file per spilled block group)::

    magic   b"DTKVP1\\n"
    u64 LE  header length
    JSON    {version, generation, hashes, structure, leaves:
             [{dtype, shape}], payload_sha256, created}
    bytes   leaf payloads, concatenated in leaf order (C-order rows)

``structure`` says how to rebuild the block batch: ``leaf`` (one bf16/f32
tensor), ``quant`` (a QuantKvCache's data and scale) or ``tuple``.  A
bf16 leaf is its 2-byte words under the dtype name ``"bfloat16"`` (what
the JAX package writes for its ml_dtypes arrays) and loads as a
``torch.bfloat16`` view of those words, as on the transfer wire, whose
part codec (``transfer.wire_part`` / ``part_from_wire``) this module uses.
Loaded leaves are CPU tensors.
Payload integrity is a sha256; a corrupt file is deleted and reported as
a miss, never served.

Eviction: LRU by last-touch at file granularity under a byte size cap,
plus an optional TTL.  last_touch is mirrored to the file mtime so the
LRU order survives restarts.

Concurrency: internally locked (the engine thread matches/loads while
the kv-offload thread spills).  All file writes fsync off the event
loop — the engine threads are plain threads, and the async replicator
crosses into file I/O only via ``asyncio.to_thread``.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import shutil
import struct
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from dynamo_tpu_torch.engine.counters import persist_counters
from dynamo_tpu_torch.llm.kv.host_pool import flatten_blocks, unflatten_blocks
from dynamo_tpu_torch.llm.kv.transfer import part_from_wire, wire_part
from dynamo_tpu_torch.obs import tracing
from dynamo_tpu_torch.obs.costs import transfer_costs

log = logging.getLogger("dynamo_tpu_torch.kv.persist")

__all__ = [
    "PersistentKvStore",
    "PersistReplicator",
    "PrewarmActuator",
    "prewarm_key",
]

MAGIC = b"DTKVP1\n"
FORMAT_VERSION = 1
SUFFIX = ".dtkv"

@dataclass
class _GroupFile:
    path: Path
    size: int
    last_touch: float
    hashes: list[int]
    verified: bool = False  # payload sha checked at least once this run


class _StoreCorrupt(Exception):
    """A block-group file failed its integrity/format check."""


def _parse(data, generation: Optional[str] = None) -> tuple[dict, bytes]:
    """Split a block-group file into (header, payload), verifying magic,
    version, optional generation, and the payload sha256."""
    if not data.startswith(MAGIC):
        raise _StoreCorrupt("bad magic")
    off = len(MAGIC)
    if len(data) < off + 8:
        raise _StoreCorrupt("truncated header length")
    (hlen,) = struct.unpack("<Q", data[off:off + 8])
    off += 8
    if len(data) < off + hlen:
        raise _StoreCorrupt("truncated header")
    try:
        header = json.loads(data[off:off + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise _StoreCorrupt(f"header not JSON: {e}") from e
    if header.get("version") != FORMAT_VERSION:
        raise _StoreCorrupt(f"version {header.get('version')}")
    if generation is not None and header.get("generation") != generation:
        raise _StoreCorrupt(
            f"generation {header.get('generation')!r} != {generation!r}")
    payload = data[off + hlen:]
    if hashlib.sha256(payload).hexdigest() != header.get("payload_sha256"):
        raise _StoreCorrupt("payload sha256 mismatch")
    return header, payload


def _read_header(path: Path) -> dict:
    """Header only (cheap index rebuild at open; payload stays unread)."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise _StoreCorrupt("bad magic")
        raw = f.read(8)
        if len(raw) < 8:
            raise _StoreCorrupt("truncated header length")
        (hlen,) = struct.unpack("<Q", raw)
        blob = f.read(hlen)
        if len(blob) < hlen:
            raise _StoreCorrupt("truncated header")
    try:
        return json.loads(blob.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise _StoreCorrupt(f"header not JSON: {e}") from e


def _payload_leaves(header: dict, payload) -> list[torch.Tensor]:
    """The leaves as CPU tensors viewing ``payload`` (no copy)."""
    leaves = []
    off = 0
    for spec in header["leaves"]:
        try:
            t, off = part_from_wire(spec, payload, off)
        except ValueError as e:
            raise _StoreCorrupt("payload shorter than leaf specs") from e
        leaves.append(t)
    return leaves


class PersistentKvStore:
    """Content-addressed persistent block store keyed by sequence hash.

    ``max_bytes=0`` disables the size cap; ``ttl_s=0`` disables TTL.
    ``clock`` is injectable for eviction tests.
    """

    def __init__(self, root_dir: str | Path, generation: str, *,
                 max_bytes: int = 0, ttl_s: float = 0.0,
                 clock: Callable[[], float] = time.time):
        self.generation = str(generation)
        self.root = Path(root_dir)
        self.dir = self.root / self.generation
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._lock = threading.Lock()
        # seq_hash -> (stem, row); stem -> file info, LRU order (oldest
        # last_touch first)
        self._index: dict[int, tuple[str, int]] = {}
        self._files: "OrderedDict[str, _GroupFile]" = OrderedDict()
        self._removed: deque[int] = deque()  # evicted hashes → router events
        # stats
        self.hits = 0
        self.misses = 0
        self.spilled_bytes = 0
        self.evicted_files = 0
        self.evicted_blocks = 0
        self.invalid_files = 0
        self._open()

    # ------------------------------------------------------------------ open
    def _open(self) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        # generation invalidation: a model/config change must not serve
        # stale blocks, and must not leak the old generation's disk
        for sib in self.root.iterdir():
            if sib.is_dir() and sib.name != self.generation:
                log.info("persist: invalidating stale generation %s", sib.name)
                shutil.rmtree(sib, ignore_errors=True)
        for path in sorted(self.dir.glob(f"*{SUFFIX}")):
            try:
                header = _read_header(path)
                if header.get("version") != FORMAT_VERSION:
                    raise _StoreCorrupt("version")
                if header.get("generation") != self.generation:
                    raise _StoreCorrupt("generation")
                hashes = [int(h) for h in header["hashes"]]
            except (_StoreCorrupt, OSError, KeyError, ValueError) as e:
                log.warning("persist: dropping unreadable %s (%s)", path, e)
                self.invalid_files += 1
                path.unlink(missing_ok=True)
                continue
            st = path.stat()
            self._register(path.name[:-len(SUFFIX)], path, st.st_size,
                           st.st_mtime, hashes)
        self._files = OrderedDict(
            sorted(self._files.items(), key=lambda kv: kv[1].last_touch))
        with self._lock:
            self._sweep_locked()
        persist_counters.set_resident(self.resident_bytes)

    def _register(self, stem: str, path: Path, size: int, touch: float,
                  hashes: list[int]) -> None:
        self._files[stem] = _GroupFile(path=path, size=size,
                                       last_touch=touch, hashes=hashes)
        for row, h in enumerate(hashes):
            self._index.setdefault(h, (stem, row))

    # ----------------------------------------------------------------- state
    @property
    def resident_bytes(self) -> int:
        return sum(f.size for f in self._files.values())

    @property
    def resident_blocks(self) -> int:
        return len(self._index)

    def __contains__(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._index

    def has_file(self, stem: str) -> bool:
        with self._lock:
            return stem in self._files

    def resident_hashes(self) -> list[int]:
        """Snapshot of every resident sequence hash (restart announce)."""
        with self._lock:
            return list(self._index)

    # ----------------------------------------------------------------- spill
    def spill(self, seq_hashes: Sequence[int], blocks) -> int:
        """Persist the blocks not already resident; returns bytes written.

        ``blocks`` is block-major (``blocks[i]`` ↔ ``seq_hashes[i]``) in
        the structure HostKvPool stores (CPU tensors or numpy arrays).  Runs on the
        kv-offload thread — never the event loop.
        """
        with self._lock:
            seen: set[int] = set()
            rows = [i for i, h in enumerate(seq_hashes)
                    if h not in self._index and not (h in seen or seen.add(h))]
        if not rows:
            return 0
        fresh = [int(seq_hashes[i]) for i in rows]
        structure, leaves = flatten_blocks(blocks)
        idx = torch.as_tensor(rows, dtype=torch.long)
        metas, words = zip(*(wire_part(leaf.index_select(0, idx.to(leaf.device)))
                             for leaf in leaves))
        payload = b"".join(w.tobytes() for w in words)
        header = {
            "version": FORMAT_VERSION,
            "generation": self.generation,
            "hashes": fresh,
            "structure": structure,
            "leaves": list(metas),
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
            "created": self._clock(),
        }
        stem = (f"{fresh[0] & 0xFFFFFFFFFFFFFFFF:016x}"
                f"-{len(fresh)}-{header['payload_sha256'][:8]}")
        path = self.dir / f"{stem}{SUFFIX}"
        blob = self._encode(header, payload)
        self._write_atomic(path, blob)
        now = self._clock()
        os.utime(path, (now, now))
        with self._lock:
            if stem not in self._files:
                self._register(stem, path, len(blob), now, fresh)
                self._files.move_to_end(stem)
            self.spilled_bytes += len(blob)
            persist_counters.record_spill(len(blob))
            self._sweep_locked()
            persist_counters.set_resident(self.resident_bytes)
        return len(blob)

    @staticmethod
    def _encode(header: dict, payload: bytes) -> bytes:
        hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
        return MAGIC + struct.pack("<Q", len(hj)) + hj + payload

    def _write_atomic(self, path: Path, blob: bytes) -> None:
        tmp = path.with_name(f".tmp-{path.name}")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # ----------------------------------------------------------------- fetch
    def match_prefix(self, seq_hashes: Sequence[int]) -> list[int]:
        """Longest resident prefix (chained hashes: element-wise walk is a
        true prefix match).  Expired (TTL) entries count as misses and
        are reclaimed in place."""
        out: list[int] = []
        with self._lock:
            now = self._clock()
            for h in seq_hashes:
                ent = self._index.get(h)
                if ent is None:
                    break
                info = self._files.get(ent[0])
                if info is None:
                    break
                if self.ttl_s and now - info.last_touch > self.ttl_s:
                    self._remove_locked(ent[0])
                    break
                out.append(h)
            self.hits += len(out)
            if seq_hashes and not out:
                self.misses += 1
        return out

    def load(self, seq_hashes: Sequence[int]):
        """Blocks for ``seq_hashes`` (block-major, original structure).
        Raises KeyError if any is not resident or its file is corrupt —
        callers treat that as a miss."""
        if not seq_hashes:
            raise KeyError("empty load")
        t0 = time.perf_counter()
        span = tracing.start_span(
            "kv.persist_restore", attrs={"blocks": len(seq_hashes)})
        with self._lock:
            now = self._clock()
            per_file: "OrderedDict[str, list[tuple[int, int]]]" = OrderedDict()
            for pos, h in enumerate(seq_hashes):
                ent = self._index.get(h)
                if ent is None:
                    raise KeyError(f"block {h:#x} not resident in persist tier")
                per_file.setdefault(ent[0], []).append((pos, ent[1]))
            structure = None
            out_leaves: Optional[list[torch.Tensor]] = None
            for stem, pairs in per_file.items():
                info = self._files[stem]
                try:
                    data = bytearray(info.path.read_bytes())
                    header, payload = _parse(data, self.generation)
                    leaves = _payload_leaves(header, payload)
                except (OSError, _StoreCorrupt) as e:
                    log.warning("persist: corrupt %s on load (%s); dropping",
                                info.path, e)
                    self.invalid_files += 1
                    self._remove_locked(stem)
                    raise KeyError(f"persist file {stem} corrupt") from e
                info.verified = True
                info.last_touch = now
                self._files.move_to_end(stem)
                try:
                    os.utime(info.path, (now, now))
                except OSError:
                    pass
                if out_leaves is None:
                    structure = header["structure"]
                    out_leaves = [
                        torch.empty((len(seq_hashes),) + tuple(leaf.shape[1:]),
                                    dtype=leaf.dtype)
                        for leaf in leaves
                    ]
                for pos, row in pairs:
                    for out, leaf in zip(out_leaves, leaves):
                        out[pos] = leaf[row]
        assert out_leaves is not None and structure is not None
        nbytes = sum(leaf.numel() * leaf.element_size() for leaf in out_leaves)
        # measured restore cost: disk → this worker's host pool ("persist"
        # path in the per-(src,dst) table alongside the handoff paths)
        transfer_costs.record(
            "disk", tracing.process_name(), "persist",
            nbytes, time.perf_counter() - t0,
        )
        span.set(bytes=nbytes).end()
        return unflatten_blocks(structure, out_leaves)

    # -------------------------------------------------------------- eviction
    def _remove_locked(self, stem: str) -> None:
        info = self._files.pop(stem, None)
        if info is None:
            return
        for h in info.hashes:
            if self._index.get(h, (None,))[0] == stem:
                del self._index[h]
                self._removed.append(h)
        self.evicted_files += 1
        self.evicted_blocks += len(info.hashes)
        info.path.unlink(missing_ok=True)

    def _sweep_locked(self) -> None:
        now = self._clock()
        if self.ttl_s:
            expired = [s for s, f in self._files.items()
                       if now - f.last_touch > self.ttl_s]
            for stem in expired:
                self._remove_locked(stem)
        if self.max_bytes:
            while self._files and self.resident_bytes > self.max_bytes:
                oldest = next(iter(self._files))
                self._remove_locked(oldest)

    def sweep(self) -> None:
        with self._lock:
            self._sweep_locked()
        persist_counters.set_resident(self.resident_bytes)

    def drain_removed(self) -> list[int]:
        """Hashes evicted since the last drain — the engine forwards them
        as tier="persist" KvRemovedEvents so the router index stays true."""
        with self._lock:
            out = list(self._removed)
            self._removed.clear()
        return out

    # ------------------------------------------------------------ replication
    def export_files(self) -> list[tuple[str, Path, list[int], int]]:
        """Snapshot of (stem, path, hashes, size) for the replicator."""
        with self._lock:
            return [(s, f.path, list(f.hashes), f.size)
                    for s, f in self._files.items()]

    def import_file(self, data: bytes) -> int:
        """Adopt a block-group file fetched from the coordinator blob
        store.  Verifies format/generation/payload integrity; returns how
        many blocks became newly resident (0 for dup/mismatch)."""
        try:
            header, _payload = _parse(data, self.generation)
            hashes = [int(h) for h in header["hashes"]]
        except _StoreCorrupt as e:
            log.warning("persist: rejecting imported file (%s)", e)
            self.invalid_files += 1
            return 0
        with self._lock:
            fresh = [h for h in hashes if h not in self._index]
        if not fresh:
            return 0
        stem = (f"{hashes[0] & 0xFFFFFFFFFFFFFFFF:016x}"
                f"-{len(hashes)}-{header['payload_sha256'][:8]}")
        path = self.dir / f"{stem}{SUFFIX}"
        self._write_atomic(path, data)
        now = self._clock()
        os.utime(path, (now, now))
        with self._lock:
            if stem not in self._files:
                self._register(stem, path, len(data), now, hashes)
                self._files.move_to_end(stem)
            self._sweep_locked()
            persist_counters.set_resident(self.resident_bytes)
        return len(fresh)

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            return {
                "persist_files": len(self._files),
                "persist_blocks": len(self._index),
                "persist_resident_bytes": self.resident_bytes,
                "persist_spilled_bytes": self.spilled_bytes,
                "persist_hits": self.hits,
                "persist_misses": self.misses,
                "persist_evicted_files": self.evicted_files,
                "persist_evicted_blocks": self.evicted_blocks,
                "persist_invalid_files": self.invalid_files,
            }

    def close(self) -> None:
        persist_counters.set_resident(self.resident_bytes)


# --------------------------------------------------------------------- remote
def prewarm_key(namespace: str) -> str:
    return f"{namespace}/kvpersist/prewarm"


class PersistReplicator:
    """Replicated persist index over the coordinator (model_store idiom).

    Layout::

      KV   {ns}/kvpersist/{generation}/{stem} -> {hashes, size, sha256}
      blob kvpersist/{ns}/{generation}/{stem} -> block-group file bytes

    ``publish_once`` uploads local block-group files the index doesn't
    know; ``pull_once`` adopts remote files this store lacks (replica B
    restores prefixes replica A prefilled).  ``start()`` runs an
    immediate sync — the planner scale-up pre-warm — then keeps syncing
    on ``interval_s``.  All disk I/O crosses into threads via
    ``asyncio.to_thread`` (lint rule DT009 guards exactly this).
    """

    def __init__(self, coordinator, store: PersistentKvStore,
                 namespace: str = "default", interval_s: float = 5.0):
        self.coord = coordinator
        self.store = store
        self.namespace = namespace
        self.interval_s = interval_s
        self._known: set[str] = set()  # stems already on the coordinator
        self._task: Optional[asyncio.Task] = None
        self._boot: Optional[asyncio.Task] = None
        self.published_files = 0
        self.pulled_blocks = 0

    def _kv_prefix(self) -> str:
        return f"{self.namespace}/kvpersist/{self.store.generation}/"

    def _kv_key(self, stem: str) -> str:
        return f"{self._kv_prefix()}{stem}"

    def _blob_key(self, stem: str) -> str:
        from urllib.parse import quote

        return (f"kvpersist/{quote(self.namespace, safe='')}"
                f"/{self.store.generation}/{stem}")

    async def publish_once(self) -> int:
        """Upload local block-group files absent from the remote index."""
        n = 0
        for stem, path, hashes, _size in self.store.export_files():
            if stem in self._known:
                continue
            if await self.coord.kv_get(self._kv_key(stem)) is not None:
                self._known.add(stem)
                continue
            try:
                data = await asyncio.to_thread(path.read_bytes)
            except OSError:
                continue  # evicted between snapshot and read
            info = await self.coord.blob_put(self._blob_key(stem), data)
            await self.coord.kv_put(self._kv_key(stem), {
                "stem": stem,
                "hashes": hashes,
                "size": len(data),
                "sha256": info["sha256"],
            })
            self._known.add(stem)
            self.published_files += 1
            n += 1
        return n

    async def pull_once(self) -> int:
        """Adopt remote block-group files this store lacks; returns how
        many blocks became newly resident."""
        entries = await self.coord.kv_get_prefix(self._kv_prefix())
        n = 0
        for key, meta in entries.items():
            stem = key.rsplit("/", 1)[-1]
            if stem in self._known or self.store.has_file(stem):
                self._known.add(stem)
                continue
            try:
                data = await self.coord.blob_get(self._blob_key(stem))
            except KeyError:
                continue  # index ahead of blob (publish in flight)
            want = (meta or {}).get("sha256")
            if want and hashlib.sha256(data).hexdigest() != want:
                log.warning("persist: remote blob %s failed sha256; skipping",
                            stem)
                continue
            got = await asyncio.to_thread(self.store.import_file, data)
            self._known.add(stem)
            self.pulled_blocks += got
            n += got
        return n

    async def sync_once(self) -> tuple[int, int]:
        pulled = await self.pull_once()
        published = await self.publish_once()
        return pulled, published

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.sync_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("persist replication sync failed; retrying")

    async def start(self) -> "PersistReplicator":
        # immediate boot-time sync: a planner scale-up's fresh worker
        # pre-warms from the shared store before it takes traffic
        try:
            await self.sync_once()
        except Exception:
            log.exception("persist pre-warm sync failed; continuing cold")
        self._task = asyncio.ensure_future(self._run())
        return self

    def start_soon(self) -> "PersistReplicator":
        """Sync-context start (worker attach hooks): schedule start()
        and retain the handle so stop() drains a boot still in flight."""
        self._boot = asyncio.ensure_future(self.start())
        return self

    async def stop(self) -> None:
        if self._boot:
            self._boot.cancel()
            try:
                await self._boot
            except asyncio.CancelledError:
                pass
            self._boot = None
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


class PrewarmActuator:
    """Planner actuator: on a scale-up plan, publish a pre-warm hint so
    replicas know a persist sync is expected.  The freshly-started
    worker's PersistReplicator performs the actual pull at boot; the
    hint records which tick asked for it (observability + a future
    watch-based trigger)."""

    def __init__(self, coordinator, namespace: str = "default"):
        self.coord = coordinator
        self.namespace = namespace
        self._last: Optional[tuple[int, int]] = None
        self.epoch = 0

    async def apply(self, plan) -> None:
        cur = (plan.prefill_replicas, plan.decode_replicas)
        last, self._last = self._last, cur
        if last is None or (cur[0] <= last[0] and cur[1] <= last[1]):
            return
        self.epoch += 1
        await self.coord.kv_put(prewarm_key(self.namespace), {
            "epoch": self.epoch,
            "tick": plan.tick,
            "prefill_replicas": plan.prefill_replicas,
            "decode_replicas": plan.decode_replicas,
            "reason": getattr(plan, "reason", ""),
        })
