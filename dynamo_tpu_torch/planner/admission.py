"""Admission control for the HTTP frontend: rate limits, priorities,
deadline-aware shedding.

A copy of the JAX package's ``planner/admission.py``: the same decisions
on the same clock.

A frontend facing heavy traffic must bound its queues — accepting every
request lets queue wait grow without limit and blows every SLA at once.
This controller sits in front of engine dispatch (llm/http/service.py)
and decides, per request:

  * **token-bucket rate limiting** per tenant (header ``x-tenant``):
    sustained rate + burst; over-rate requests shed immediately with a
    Retry-After derived from the bucket's refill time.
  * **priority classes** (header ``x-priority`` or body ``priority``):
    ``high`` / ``normal`` / ``low`` map to levels; when the service is at
    capacity, waiters are dispatched strictly by level (FIFO within one).
  * **bounded queues + deadline-aware shedding**: each class has a queue
    bound and a max wait.  At enqueue time the controller estimates this
    request's queue wait from live TTFT/service-time EWMAs (fed by the
    frontend metrics plane) and the number of same-or-higher-priority
    waiters ahead; an estimate past the class deadline sheds NOW (429 +
    Retry-After) instead of letting the client burn its own timeout in
    our queue.  A request whose ACTUAL wait hits the deadline is shed at
    expiry too (the estimate was optimistic).

The clock is injectable so every decision is deterministic under test.
"""

from __future__ import annotations

import asyncio
import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "AdmissionRejected",
    "PriorityClass",
    "AdmissionConfig",
    "TokenBucket",
    "AdmissionController",
    "Ticket",
]


class AdmissionRejected(Exception):
    """Shed decision: HTTP 429 with a Retry-After hint (seconds)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(1, math.ceil(retry_after_s))


@dataclass(frozen=True)
class PriorityClass:
    name: str
    level: int               # lower = more important
    max_queue_depth: int     # waiters of this class beyond this are shed
    max_wait_s: float        # deadline: estimated/actual wait past this sheds


def default_priorities() -> dict[str, PriorityClass]:
    return {
        "high": PriorityClass("high", 0, max_queue_depth=64, max_wait_s=30.0),
        "normal": PriorityClass("normal", 1, max_queue_depth=32, max_wait_s=10.0),
        "low": PriorityClass("low", 2, max_queue_depth=16, max_wait_s=2.0),
    }


@dataclass
class AdmissionConfig:
    max_concurrent: int = 8
    # per-tenant token bucket; rate <= 0 disables rate limiting
    rate_tokens_per_s: float = 0.0
    burst_tokens: float = 16.0
    priorities: dict[str, PriorityClass] = field(default_factory=default_priorities)
    default_priority: str = "normal"
    # prior estimate of one request's service time, used until live
    # TTFT/duration observations arrive from the metrics plane
    default_service_s: float = 0.5
    ewma_alpha: float = 0.2

    @classmethod
    def from_dict(cls, d: dict) -> "AdmissionConfig":
        """Build from a YAML/JSON ``admission:`` block (example graph
        configs, ServiceConfig).  Priority entries override the defaults
        by name: ``{low: {level: 2, max_wait_s: 1.5}}``."""
        priorities = default_priorities()
        for name, pc in (d.get("priorities") or {}).items():
            base = priorities.get(name)
            priorities[name] = PriorityClass(
                name=name,
                level=int(pc.get("level", base.level if base else 1)),
                max_queue_depth=int(pc.get(
                    "max_queue_depth", base.max_queue_depth if base else 32)),
                max_wait_s=float(pc.get(
                    "max_wait_s", base.max_wait_s if base else 10.0)),
            )
        return cls(
            max_concurrent=int(d.get("max_concurrent", 8)),
            rate_tokens_per_s=float(d.get("rate_tokens_per_s", 0.0)),
            burst_tokens=float(d.get("burst_tokens", 16.0)),
            priorities=priorities,
            default_priority=str(d.get("default_priority", "normal")),
            default_service_s=float(d.get("default_service_s", 0.5)),
        )


class TokenBucket:
    """Classic token bucket with an injectable clock (held by caller)."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = now

    def _refill(self, now: float) -> None:
        self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
        self.last = now

    def try_take(self, n: float, now: float) -> bool:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def time_until(self, n: float, now: float) -> float:
        """Seconds until ``n`` tokens will be available (0 if now)."""
        self._refill(now)
        if self.tokens >= n:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return (n - self.tokens) / self.rate


class Ticket:
    """An admitted request's capacity hold; release() frees the slot and
    feeds the service-time EWMA."""

    def __init__(self, controller: "AdmissionController", started: float):
        self._controller = controller
        self._started = started
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._controller._release(self._started)


class _Waiter:
    __slots__ = ("level", "seq", "future", "shed")

    def __init__(self, level: int, seq: int, future: asyncio.Future):
        self.level = level
        self.seq = seq
        self.future = future
        self.shed = False

    def __lt__(self, other: "_Waiter") -> bool:
        return (self.level, self.seq) < (other.level, other.seq)


class AdmissionController:
    def __init__(self, config: Optional[AdmissionConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or AdmissionConfig()
        self.clock = clock
        self._buckets: dict[str, TokenBucket] = {}
        self._running = 0
        self._waiters: list[_Waiter] = []  # heap by (level, seq)
        self._seq = 0
        # live latency estimates (EWMA, seconds) — fed by the frontend's
        # metrics plane (Metrics.ttft_listeners) and completed tickets
        self.ttft_ewma: Optional[float] = None
        self.itl_ewma: Optional[float] = None
        self.service_ewma: Optional[float] = None
        # counters for the Prometheus surface
        self.admitted_total = 0
        self.shed_total: dict[str, int] = {}

    # -------------------------------------------------------------- estimates
    def _ewma(self, cur: Optional[float], v: float) -> float:
        a = self.config.ewma_alpha
        return v if cur is None else (1 - a) * cur + a * v

    def observe_ttft(self, seconds: float) -> None:
        self.ttft_ewma = self._ewma(self.ttft_ewma, seconds)

    def observe_itl(self, seconds: float) -> None:
        self.itl_ewma = self._ewma(self.itl_ewma, seconds)

    def observe_service(self, seconds: float) -> None:
        self.service_ewma = self._ewma(self.service_ewma, seconds)

    def estimated_service_s(self) -> float:
        """Best current estimate of one request's engine occupancy: the
        duration EWMA when we have one, else TTFT (a lower bound — the
        queue estimate stays optimistic, the deadline check at expiry
        backstops it), else the configured prior."""
        if self.service_ewma is not None:
            return self.service_ewma
        if self.ttft_ewma is not None:
            return self.ttft_ewma
        return self.config.default_service_s

    # ------------------------------------------------------------- admission
    def _priority(self, name: Optional[str]) -> PriorityClass:
        cfg = self.config
        return cfg.priorities.get(name or "", cfg.priorities[cfg.default_priority])

    def _shed(self, pc: PriorityClass, msg: str, retry_after: float) -> AdmissionRejected:
        self.shed_total[pc.name] = self.shed_total.get(pc.name, 0) + 1
        return AdmissionRejected(msg, retry_after)

    async def acquire(self, tenant: str = "default",
                      priority: Optional[str] = None,
                      cost: float = 1.0) -> Ticket:
        """Admit or shed.  Raises AdmissionRejected on shed; returns a
        Ticket (caller must release()) on admit."""
        now = self.clock()
        pc = self._priority(priority)
        cfg = self.config
        if cfg.rate_tokens_per_s > 0:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    cfg.rate_tokens_per_s, cfg.burst_tokens, now)
            if not bucket.try_take(cost, now):
                wait = bucket.time_until(cost, now)
                raise self._shed(
                    pc, f"tenant {tenant!r} over rate limit", wait)

        # drop stale shed/timed-out waiters so they can't block the fast path
        while self._waiters and (self._waiters[0].shed or self._waiters[0].future.done()):
            heapq.heappop(self._waiters)

        if self._running < cfg.max_concurrent and not self._waiters:
            self._running += 1
            self.admitted_total += 1
            return Ticket(self, now)

        # queue bound per class
        depth = sum(1 for w in self._waiters
                    if not w.shed and w.level == pc.level)
        if depth >= pc.max_queue_depth:
            raise self._shed(
                pc, f"{pc.name} queue full ({depth} waiting)",
                self.estimated_service_s())

        # deadline-aware shed at enqueue: estimated wait = slots that must
        # free before this request runs, paced by the live service estimate
        ahead = sum(1 for w in self._waiters
                    if not w.shed and w.level <= pc.level)
        service = self.estimated_service_s()
        est_wait = service * (ahead + 1) / max(cfg.max_concurrent, 1)
        if est_wait > pc.max_wait_s:
            raise self._shed(
                pc,
                f"{pc.name} estimated queue wait {est_wait:.2f}s exceeds "
                f"deadline {pc.max_wait_s:.2f}s",
                est_wait)

        self._seq += 1
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        waiter = _Waiter(pc.level, self._seq, fut)
        heapq.heappush(self._waiters, waiter)
        try:
            await asyncio.wait_for(fut, timeout=pc.max_wait_s)
        except asyncio.TimeoutError:
            waiter.shed = True  # lazily discarded at dispatch/acquire
            if fut.done() and not fut.cancelled():
                # the slot was granted in the same instant — hand it back
                self._release(None)
            raise self._shed(
                pc, f"{pc.name} queue wait exceeded deadline "
                f"{pc.max_wait_s:.2f}s", service) from None
        except asyncio.CancelledError:
            waiter.shed = True
            if fut.done() and not fut.cancelled():
                # the slot was granted in the same instant — hand it back
                self._release(None)
            raise
        self.admitted_total += 1
        return Ticket(self, self.clock())

    def _release(self, started: Optional[float]) -> None:
        if started is not None:
            self.observe_service(max(0.0, self.clock() - started))
        while self._waiters:
            waiter = heapq.heappop(self._waiters)
            if waiter.shed or waiter.future.done():
                continue
            waiter.future.set_result(None)  # slot transfers, _running unchanged
            return
        self._running = max(0, self._running - 1)

    # --------------------------------------------------------------- insight
    def stats(self) -> dict:
        return {
            "running": self._running,
            "waiting": sum(1 for w in self._waiters if not w.shed),
            "admitted_total": self.admitted_total,
            "shed_total": dict(self.shed_total),
            "ttft_ewma_s": self.ttft_ewma,
            "service_ewma_s": self.service_ewma,
        }
