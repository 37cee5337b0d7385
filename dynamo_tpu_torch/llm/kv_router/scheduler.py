"""KvScheduler — pick the decode worker for a request.

The counterpart of ``dynamo_tpu/llm/kv_router/scheduler.py``.  Cost model
carried over from the reference (kv_router/scheduler.rs:236-330,
DefaultWorkerSelector):

    logit = 2.0 * overlap − kv_usage − normalized_active_slots

where overlap is the prefix-hit fraction of the request's blocks, kv_usage
is the worker's cache occupancy [0,1], and normalized_active_slots its
request-slot occupancy [0,1].  Highest logit wins; ties break randomly.
The selector is pluggable (ref WorkerSelector trait, kv_router.rs:57).
"""

from __future__ import annotations

import random
import statistics
import time
from dataclasses import dataclass, field
from typing import Optional, Protocol

__all__ = ["WorkerMetrics", "KvScheduler", "DefaultWorkerSelector", "KVHitRateEvent",
           "AllWorkersBusy"]


@dataclass
class WorkerMetrics:
    """A worker's published load (ref ForwardPassMetrics,
    kv_router/protocols.rs:30-47)."""

    worker_id: int
    request_active_slots: int = 0
    request_total_slots: int = 1
    kv_active_blocks: int = 0
    kv_total_blocks: int = 1
    num_requests_waiting: int = 0
    cache_hit_rate: float = 0.0
    updated_at: float = field(default_factory=time.monotonic)

    @property
    def kv_usage(self) -> float:
        return self.kv_active_blocks / max(self.kv_total_blocks, 1)

    @property
    def slot_usage(self) -> float:
        return self.request_active_slots / max(self.request_total_slots, 1)


@dataclass
class KVHitRateEvent:
    """Emitted per routing decision for the metrics plane
    (ref kv_router/scheduler.rs:31)."""

    worker_id: int
    isl_blocks: int       # request length in blocks
    overlap_blocks: int   # blocks already resident on the chosen worker


class WorkerSelector(Protocol):
    def select(
        self,
        workers: dict[int, WorkerMetrics],
        overlaps: dict[int, int],
        request_blocks: int,
    ) -> Optional[int]: ...


class DefaultWorkerSelector:
    def __init__(self, rng: Optional[random.Random] = None):
        self._rng = rng or random.Random()

    def select(
        self,
        workers: dict[int, WorkerMetrics],
        overlaps: dict[int, int],
        request_blocks: int,
    ) -> Optional[int]:
        if not workers:
            return None
        best_logit = None
        best: list[int] = []
        for wid, m in workers.items():
            overlap = overlaps.get(wid, 0) / max(request_blocks, 1)
            logit = 2.0 * overlap - m.kv_usage - m.slot_usage
            if best_logit is None or logit > best_logit + 1e-9:
                best_logit, best = logit, [wid]
            elif abs(logit - best_logit) <= 1e-9:
                best.append(wid)
        return self._rng.choice(best)


class AllWorkersBusy(Exception):
    """No worker has spare slots (ref scheduler.rs:146-160 waits on capacity)."""


class KvScheduler:
    """Combines worker metrics + overlap scores into routing decisions."""

    def __init__(self, selector: Optional[WorkerSelector] = None, block_size: int = 16,
                 persist_weight: float = 1.0, transfer_weight: float = 0.0):
        self.selector = selector or DefaultWorkerSelector()
        self.block_size = block_size
        # relative worth of a persistent-tier prefix block vs a device-
        # resident one (device term weighs 2.0 in the selector logit):
        # restoring from disk beats re-prefilling but costs a host-side
        # load + scatter, so it scores at persist_weight/2.0 of a warm
        # hit.  0 disables persist-aware routing.
        self.persist_weight = persist_weight
        # NetKV transfer-cost term (logit −= transfer_weight * cost_s per
        # candidate, cost from obs/costs.py via the caller): a decode
        # worker that is cheap to reach (on the card, or over TCP) beats an equally
        # loaded one behind an expensive hop.  0 (default) disables it.
        self.transfer_weight = transfer_weight
        self._workers: dict[int, WorkerMetrics] = {}
        self._suspects: set[int] = set()
        self._hit_events: list[KVHitRateEvent] = []

    # ------------------------------------------------------------ worker set
    def update_worker(self, metrics: WorkerMetrics) -> None:
        self._workers[metrics.worker_id] = metrics

    def remove_worker(self, worker_id: int) -> None:
        self._workers.pop(worker_id, None)
        self._suspects.discard(worker_id)

    def workers(self) -> dict[int, WorkerMetrics]:
        return dict(self._workers)

    # ---------------------------------------------------------- suspect state
    # fed by a health monitor: a suspect worker stops attracting prefix-hit
    # routing seconds before its lease would expire, but is NOT forgotten —
    # a recovered probe restores it.
    def mark_suspect(self, worker_id: int) -> None:
        self._suspects.add(worker_id)

    def clear_suspect(self, worker_id: int) -> None:
        self._suspects.discard(worker_id)

    def suspects(self) -> set[int]:
        return set(self._suspects)

    # -------------------------------------------------------------- schedule
    def _fold_overlaps(self, overlaps: dict[int, int], request_blocks: int,
                       persist_overlaps: Optional[dict[int, int]],
                       transfer_costs_s: Optional[dict[int, float]],
                       ) -> dict[int, float]:
        """Fold persist-tier and transfer-cost terms into effective
        overlap counts so the WorkerSelector protocol (and custom
        selectors) stays unchanged.

        Persistent-tier matches enter as a DISCOUNTED overlap term: only
        the blocks persist offers beyond the device prefix count, scaled
        so the selector's 2.0*overlap weight nets out to persist_weight
        per persist block.  Transfer costs are scaled so the selector's
        2.0/request_blocks overlap normalization nets out to a logit
        delta of −transfer_weight * cost_s per candidate (llm/kv/
        stream.py's choose_handoff_path supplies the per-worker predicted
        seconds)."""
        eff: dict[int, float] = dict(overlaps)
        if persist_overlaps and self.persist_weight > 0:
            for w, p in persist_overlaps.items():
                extra = p - overlaps.get(w, 0)
                if extra > 0:
                    eff[w] = (overlaps.get(w, 0)
                              + (self.persist_weight / 2.0) * extra)
        if transfer_costs_s and self.transfer_weight > 0:
            for w, cost in transfer_costs_s.items():
                if cost > 0:
                    eff[w] = (eff.get(w, 0)
                              - (self.transfer_weight / 2.0) * cost
                              * request_blocks)
        return eff

    def score_candidates(self, overlaps: dict[int, int], request_tokens: int,
                         persist_overlaps: Optional[dict[int, int]] = None,
                         transfer_costs_s: Optional[dict[int, float]] = None,
                         ) -> list[tuple[int, float, dict]]:
        """Pure scoring seam: every non-suspect worker's logit with the
        terms itemized, best first (ties broken by worker id — no RNG,
        no state mutation, no hit events).

        Returns ``[(worker_id, logit, breakdown)]`` where ``breakdown``
        holds the additive terms {overlap, persist, transfer, kv_usage,
        slot_usage} and ``logit == sum(breakdown.values())``, matching
        the DefaultWorkerSelector cost model over folded overlaps
        exactly: the surface a test holds a routing decision's terms to."""
        request_blocks = max(1, request_tokens // self.block_size)
        scored: list[tuple[int, float, dict]] = []
        for wid, m in self._workers.items():
            if wid in self._suspects:
                continue
            overlap_term = 2.0 * overlaps.get(wid, 0) / request_blocks
            persist_term = 0.0
            if persist_overlaps and self.persist_weight > 0:
                extra = persist_overlaps.get(wid, 0) - overlaps.get(wid, 0)
                if extra > 0:
                    persist_term = (self.persist_weight * extra
                                    / request_blocks)
            transfer_term = 0.0
            if transfer_costs_s and self.transfer_weight > 0:
                cost = transfer_costs_s.get(wid, 0.0)
                if cost > 0:
                    transfer_term = -self.transfer_weight * cost
            breakdown = {
                "overlap": overlap_term,
                "persist": persist_term,
                "transfer": transfer_term,
                "kv_usage": -m.kv_usage,
                "slot_usage": -m.slot_usage,
            }
            scored.append((wid, sum(breakdown.values()), breakdown))
        scored.sort(key=lambda t: (-t[1], t[0]))
        return scored

    def schedule(self, overlaps: dict[int, int], request_tokens: int,
                 persist_overlaps: Optional[dict[int, int]] = None,
                 transfer_costs_s: Optional[dict[int, float]] = None) -> int:
        request_blocks = max(1, request_tokens // self.block_size)
        candidates = {w: m for w, m in self._workers.items()
                      if w not in self._suspects}
        device_overlaps = overlaps
        overlaps = self._fold_overlaps(overlaps, request_blocks,
                                       persist_overlaps, transfer_costs_s)
        # every worker suspect = probes failing cluster-wide (or the probe
        # plane itself broke): routing somewhere beats routing nowhere
        wid = self.selector.select(candidates or self._workers, overlaps,
                                   request_blocks)
        if wid is None:
            raise AllWorkersBusy("no live workers")
        self._hit_events.append(
            KVHitRateEvent(wid, request_blocks, device_overlaps.get(wid, 0))
        )
        # optimistic local update so burst arrivals spread before the next
        # metrics scrape lands
        m = self._workers.get(wid)
        if m is not None:
            m.request_active_slots += 1
        return wid

    def drain_hit_events(self) -> list[KVHitRateEvent]:
        out, self._hit_events = self._hit_events, []
        return out

    # --------------------------------------------------------------- summary
    def load_summary(self) -> dict:
        """load avg/std across workers (ref scoring.rs:22-52 ProcessedEndpoints)."""
        if not self._workers:
            return {"load_avg": 0.0, "load_std": 0.0, "workers": 0}
        loads = [m.request_active_slots for m in self._workers.values()]
        return {
            "load_avg": statistics.fmean(loads),
            "load_std": statistics.pstdev(loads) if len(loads) > 1 else 0.0,
            "workers": len(loads),
        }
