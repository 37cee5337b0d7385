"""Simulated workers priced from the card's own serving figures.

The counterpart of the JAX package's ``load/workers.py``: the same
``SimWorker`` (slot-gated admission, decode time-sliced across the
requests decoding at once, LRU KV eviction publishing real
``KvRemovedEvent``s, a kill/restore surface for failure storms) and the
same ``LatencyModel`` durations.  The JAX model prices a worker from its
perf plane's predicted TPU latencies, times a scale; the port's prices it
from what the H100 measured serving Llama-3-8B, at scale 1:
``LatencyModel.from_card()`` reads the committed ``load/card_latency.json``,
which ``chip_smoke.py``'s ``load`` line writes out:

    prefill_ms_per_token    the default path's prefill dispatch seconds over
                            the fresh prompt tokens they prefilled
    decode_ms_per_step      its decode-burst seconds over the row-steps they
                            decoded (each request's tokens after its
                            first): ONE row's step, the unit ``decode``
                            below multiplies by the rows decoding at once
    router_ms_per_decision  one singleton KV-router decision (hash, match,
                            score, pick)
    kv_bytes_per_block      ``EngineCore.kv_bytes_per_block()`` of that
                            engine, what a handoff moves per block

A moved serving figure moves every simulated capacity number, and the
load gate (LD001/LD002) says so.  Control-plane costs are wall costs
independent of the model, which is why the singleton router can become
the wall at high worker counts.

All cache traffic goes through the real ``event_to_wire`` codec so the
router's indexer sees production-shaped event streams.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

from dynamo_tpu_torch.llm.kv.events import (
    KvRemovedEvent,
    KvStoredEvent,
    event_to_wire,
)
from dynamo_tpu_torch.llm.kv_router.scheduler import WorkerMetrics

__all__ = ["LatencyModel", "SimWorker", "SimWorkerDied", "DEFAULT_CARD_LATENCY"]

DEFAULT_CARD_LATENCY = Path(__file__).resolve().parent / "card_latency.json"

# the figures a card file must hold, each a positive number
_CARD_KEYS = ("prefill_ms_per_token", "decode_ms_per_step",
              "router_ms_per_decision", "kv_bytes_per_block", "scale")


class LatencyModel:
    """Virtual-time costs for one simulated deployment."""

    def __init__(self, *, prefill_ms_per_token: float,
                 decode_ms_per_step: float,
                 router_ms_per_decision: float,
                 kv_bytes_per_block: int,
                 scale: float = 1.0):
        self.prefill_ms_per_token = prefill_ms_per_token
        self.decode_ms_per_step = decode_ms_per_step
        self.router_ms_per_decision = router_ms_per_decision
        self.kv_bytes_per_block = kv_bytes_per_block
        self.scale = scale

    @classmethod
    def from_card(cls, path: Optional[Path] = None,
                  scale: Optional[float] = None) -> "LatencyModel":
        """The model the card measured (``path``, default the committed
        ``card_latency.json``).  A missing or malformed file raises,
        naming the path: there is no fallback figure.  ``DTLOAD_SCALE``
        (or ``scale``) overrides the file's scale, which makes the run
        non-pinned for the load gate's drift rules."""
        p = Path(path) if path is not None else DEFAULT_CARD_LATENCY
        try:
            data = json.loads(p.read_text())
        except FileNotFoundError:
            raise FileNotFoundError(
                f"card latency file {p} is missing: the load plane prices "
                "its workers from it (chip_smoke.py's load line writes "
                "its figures)") from None
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(f"card latency file {p} is unreadable: {e}") from None
        bad = [k for k in _CARD_KEYS
               if not isinstance(data, dict)
               or not isinstance(data.get(k), (int, float))
               or isinstance(data.get(k), bool) or data[k] <= 0]
        if bad:
            raise ValueError(f"card latency file {p} lacks a positive {', '.join(bad)}")
        if scale is None:
            scale = float(os.environ.get("DTLOAD_SCALE", "") or data["scale"])
        return cls(
            prefill_ms_per_token=float(data["prefill_ms_per_token"]),
            decode_ms_per_step=float(data["decode_ms_per_step"]),
            router_ms_per_decision=float(data["router_ms_per_decision"]),
            kv_bytes_per_block=int(data["kv_bytes_per_block"]),
            scale=scale,
        )

    # ------------------------------------------------------------- durations
    def prefill_s(self, new_tokens: int) -> float:
        return max(0, new_tokens) * self.prefill_ms_per_token * self.scale / 1e3

    def decode_step_s(self) -> float:
        return self.decode_ms_per_step * self.scale / 1e3

    def router_s(self) -> float:
        return self.router_ms_per_decision / 1e3

    def transfer_bytes(self, blocks: int) -> int:
        return blocks * self.kv_bytes_per_block


class SimWorkerDied(Exception):
    """The worker was killed while serving (failure storm)."""


class SimWorker:
    """One simulated engine: ``slots`` concurrent requests, a
    ``kv_blocks``-deep LRU device cache, decode time-sliced across the
    requests actively decoding on the chip."""

    def __init__(self, wid: int, lat: LatencyModel, *,
                 publish: Callable[[dict], None],
                 clock: Callable[[], float] = time.monotonic,
                 slots: int = 8, kv_blocks: int = 4096,
                 block_size: int = 16):
        self.wid = wid
        self.lat = lat
        self.publish = publish
        self.clock = clock
        self.slots = slots
        self.kv_blocks = kv_blocks
        self.block_size = block_size
        self.alive = True
        self.completed = 0
        self.tokens_out = 0
        self.evicted_blocks = 0
        self._sem = asyncio.Semaphore(slots)
        self._active = 0
        self._waiting = 0
        self._decoding = 0
        self._resident: dict[int, None] = {}   # insertion order = LRU order
        self._event_id = 0

    # -------------------------------------------------------------- KV cache
    def _resident_prefix(self, hashes: Sequence[int]) -> int:
        k = 0
        for h in hashes:
            if h not in self._resident:
                break
            k += 1
            self._resident[h] = self._resident.pop(h)   # LRU touch
        return k

    def _emit(self, ev) -> None:
        self._event_id += 1
        self.publish(event_to_wire(self._event_id, self.wid, ev))

    def _store(self, hashes: Sequence[int], known: int) -> None:
        new = [h for h in hashes[known:] if h not in self._resident]
        if new:
            parent = hashes[known - 1] if known > 0 else None
            for h in new:
                self._resident[h] = None
            self._emit(KvStoredEvent(block_hashes=new, parent_hash=parent))
        if len(self._resident) > self.kv_blocks:
            n_evict = len(self._resident) - self.kv_blocks
            victims = list(self._resident)[:n_evict]
            for h in victims:
                del self._resident[h]
            self.evicted_blocks += len(victims)
            self._emit(KvRemovedEvent(block_hashes=victims))

    # --------------------------------------------------------------- serving
    def _check_alive(self) -> None:
        if not self.alive:
            raise SimWorkerDied(f"worker {self.wid} died mid-serve")

    async def prefill(self, hashes: Sequence[int], isl_tokens: int,
                      pre_delay_s: float = 0.0) -> int:
        """Prefill only (disagg prefill role).  Returns the warm-prefix
        block count it reused; publishes the new blocks as stored."""
        self._waiting += 1
        await self._sem.acquire()
        self._waiting -= 1
        self._active += 1
        try:
            self._check_alive()
            known = self._resident_prefix(hashes)
            new_tokens = isl_tokens - known * self.block_size
            if pre_delay_s > 0:
                await asyncio.sleep(pre_delay_s)
            await asyncio.sleep(self.lat.prefill_s(new_tokens))
            self._check_alive()
            self._store(hashes, known)
            return known
        finally:
            self._active -= 1
            self._sem.release()

    async def decode(self, hashes: Sequence[int], osl: int,
                     pre_delay_s: float = 0.0,
                     prefill_tokens: int = 0) -> tuple[float, float, int]:
        """Hold a slot and decode ``osl`` tokens, time-sliced across the
        chip's active decodes.  ``prefill_tokens`` > 0 folds a local
        prefill in first (aggregated serving); 0 means the KV arrived by
        transfer (disagg decode role).  Returns (t_first_token, t_done,
        warm_prefix_blocks)."""
        self._waiting += 1
        await self._sem.acquire()
        self._waiting -= 1
        self._active += 1
        try:
            self._check_alive()
            known = self._resident_prefix(hashes)
            if pre_delay_s > 0:
                await asyncio.sleep(pre_delay_s)
            if prefill_tokens > 0:
                new_tokens = max(0, prefill_tokens - known * self.block_size)
                await asyncio.sleep(self.lat.prefill_s(new_tokens))
                self._check_alive()
            self._store(hashes, known)
            step = self.lat.decode_step_s()
            self._decoding += 1
            try:
                await asyncio.sleep(step * max(1, self._decoding))
                t_first = self.clock()
                # two chunks, concurrency resampled between them:
                # scheduling-point economy over per-token fidelity
                left = max(0, osl - 1)
                for n in (left // 2, left - left // 2):
                    if n:
                        await asyncio.sleep(
                            n * step * max(1, self._decoding))
                    self._check_alive()
            finally:
                self._decoding -= 1
            t_done = self.clock()
            self.completed += 1
            self.tokens_out += osl
            return t_first, t_done, known
        finally:
            self._active -= 1
            self._sem.release()

    # --------------------------------------------------------------- control
    def kill(self) -> None:
        self.alive = False

    def restore(self) -> None:
        """Back from the dead, cache cold (the harness already tore the
        worker out of the router index)."""
        self._resident.clear()
        self.alive = True

    def metrics(self) -> WorkerMetrics:
        return WorkerMetrics(
            worker_id=self.wid,
            request_active_slots=self._active,
            request_total_slots=self.slots,
            kv_active_blocks=len(self._resident),
            kv_total_blocks=self.kv_blocks,
            num_requests_waiting=self._waiting,
            updated_at=self.clock(),
        )
