"""Planner loop: live metrics in, plans out, actuators apply them.

A copy of ``dynamo_tpu/planner/core.py`` over the port's coordinator client
and supervisor.  As the Dynamo Planner component, it is a control loop that subscribes to per-worker ForwardPassMetrics on the
event plane ({ns}.kv_metrics.*, the same subjects the KV router schedules
on), measures per-pool saturation, and re-plans worker allocation.

The loop is deliberately thin: every decision lives in the pure policy
(planner/policy.py), and every side effect lives in a pluggable actuator:

  * :class:`SupervisorActuator` — local process scaling through the sdk
    supervisor (sdk/serving.py ServeSupervisor.scale), including role
    flips (one pool scales down as the other scales up).
  * :class:`LogActuator` — dry-run: log the plan (the ``planner``
    command's default).
  * the k8s operator (deploy/operator.py) embeds the same policy
    functions directly rather than running this loop — cluster scaling
    actuates through spec reconcile, not a callback.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Callable, Optional, Protocol

from dynamo_tpu_torch.llm.kv.persist import PrewarmActuator  # planner-facing re-export
from dynamo_tpu_torch.llm.kv_router.publisher import metrics_subject
from dynamo_tpu_torch.planner.policy import (
    MetricsSnapshot,
    Plan,
    PlannerConfig,
    PlannerPolicy,
    PoolSnapshot,
    WorkerSample,
)

log = logging.getLogger("dynamo_tpu_torch.planner")

__all__ = ["PlannerLoop", "Actuator", "LogActuator", "SupervisorActuator",
           "PrewarmActuator"]


class Actuator(Protocol):
    async def apply(self, plan: Plan) -> None: ...


class LogActuator:
    """Dry-run actuation: log every plan, act on nothing."""

    def __init__(self) -> None:
        self.plans: list[Plan] = []

    async def apply(self, plan: Plan) -> None:
        self.plans.append(plan)
        log.info(
            "plan tick=%d prefill=%d decode=%d flip=%s (%s)",
            plan.tick, plan.prefill_replicas, plan.decode_replicas,
            plan.flip, plan.reason,
        )


class SupervisorActuator:
    """Scale sdk-supervised worker processes toward the plan.  A role
    flip needs no special casing: the plan's replica numbers already
    moved one worker between pools, so two scale() calls realize it.
    Downscales are graceful: the supervisor's SIGTERM triggers the
    worker's drain lifecycle (deregister → finish in-flight → exit), so
    a flip completes live streams instead of amputating them."""

    def __init__(self, supervisor, prefill_service: str, decode_service: str):
        self.supervisor = supervisor
        self.prefill_service = prefill_service
        self.decode_service = decode_service

    async def apply(self, plan: Plan) -> None:
        # scale the shrinking pool first so a flip frees its chips before
        # the growing pool's new worker asks the allocator for them
        down_first = plan.flip == "prefill_to_decode"
        order = (
            [(self.prefill_service, plan.prefill_replicas),
             (self.decode_service, plan.decode_replicas)]
        )
        if not down_first:
            order.reverse()
        for name, replicas in order:
            await self.supervisor.scale(name, replicas)


class PlannerLoop:
    """Subscribe → snapshot → plan → actuate, every ``interval_s``.

    Pool membership comes from live coordinator registrations under each
    pool's dyn:// endpoint prefix; freshness from the metrics plane
    subscription.  ``mix_source`` optionally supplies the observed
    (isl_mean, osl_mean) traffic mix (e.g. from the frontend's
    preprocessor stats) — the role-flip machine uses it to recognize the
    decode-heavy long-OSL regime.
    """

    def __init__(
        self,
        coordinator,
        namespace: str = "default",
        policy: Optional[PlannerPolicy] = None,
        config: Optional[PlannerConfig] = None,
        prefill_component: str = "prefill",
        prefill_endpoint: str = "generate",
        decode_component: str = "decode",
        decode_endpoint: str = "generate",
        prefill_queue: Optional[str] = None,
        interval_s: float = 2.0,
        stale_after_s: float = 15.0,
        actuators: tuple = (),
        mix_source: Optional[Callable[[], tuple[float, float]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.coord = coordinator
        # injectable clock: metric freshness (stale_after_s) can run on a
        # virtual clock
        self._clock = clock
        self.namespace = namespace
        self.policy = policy or PlannerPolicy(config)
        self.prefill_component = prefill_component
        self.prefill_endpoint = prefill_endpoint
        self.decode_component = decode_component
        self.decode_endpoint = decode_endpoint
        self.prefill_queue = prefill_queue or f"{namespace}_prefill_queue"
        self.interval_s = interval_s
        self.stale_after_s = stale_after_s
        self.actuators = list(actuators)
        self.mix_source = mix_source
        self.tick = 0
        self.last_plan: Optional[Plan] = None
        # desired replica counts carried tick-to-tick; initialized from
        # the first observation's registered counts
        self._replicas: dict[str, Optional[int]] = {"prefill": None, "decode": None}
        self._metrics: dict[int, dict] = {}
        self._sub: Optional[int] = None
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------- ingestion
    def _on_metrics(self, subject: str, payload: bytes) -> None:
        try:
            d = json.loads(payload)
            d["_rx"] = self._clock()
            self._metrics[int(d["worker_id"])] = d
        except Exception:
            log.exception("bad kv_metrics payload on %s", subject)

    async def _pool_ids(self, component: str, endpoint: str) -> list[int]:
        prefix = (f"{self.namespace}/components/{component}"
                  f"/endpoints/{endpoint}/")
        insts = await self.coord.kv_get_prefix(prefix)
        ids = []
        for k in insts:
            try:
                ids.append(int(k.rsplit("/", 1)[-1], 16))
            except ValueError:
                continue
        return ids

    def _samples(self, ids: list[int]) -> tuple[WorkerSample, ...]:
        now = self._clock()
        out = []
        for wid in ids:
            m = self._metrics.get(wid)
            if not m or now - m.get("_rx", 0.0) > self.stale_after_s:
                continue
            out.append(WorkerSample(
                worker_id=wid,
                request_active_slots=int(m.get("request_active_slots", 0)),
                request_total_slots=int(m.get("request_total_slots", 1)),
                kv_active_blocks=int(m.get("kv_active_blocks", 0)),
                kv_total_blocks=int(m.get("kv_total_blocks", 1)),
                num_requests_waiting=int(m.get("num_requests_waiting", 0)),
            ))
        return tuple(out)

    # -------------------------------------------------------------- planning
    async def snapshot(self) -> MetricsSnapshot:
        pf_ids = await self._pool_ids(self.prefill_component, self.prefill_endpoint)
        dc_ids = await self._pool_ids(self.decode_component, self.decode_endpoint)
        try:
            depth = await self.coord.queue_len(self.prefill_queue)
        except Exception:
            depth = 0
        if self._replicas["prefill"] is None:
            self._replicas["prefill"] = max(1, len(pf_ids))
        if self._replicas["decode"] is None:
            self._replicas["decode"] = max(1, len(dc_ids))
        isl, osl = self.mix_source() if self.mix_source else (0.0, 0.0)
        return MetricsSnapshot(
            tick=self.tick,
            prefill=PoolSnapshot(
                replicas=self._replicas["prefill"],
                registered=len(pf_ids),
                samples=self._samples(pf_ids),
                queue_depth=depth,
            ),
            decode=PoolSnapshot(
                replicas=self._replicas["decode"],
                registered=len(dc_ids),
                samples=self._samples(dc_ids),
            ),
            isl_mean=isl,
            osl_mean=osl,
        )

    async def tick_once(self) -> Plan:
        snap = await self.snapshot()
        decided = self.policy.plan(snap)
        self._replicas["prefill"] = decided.prefill_replicas
        self._replicas["decode"] = decided.decode_replicas
        self.last_plan = decided
        self.tick += 1
        for actuator in self.actuators:
            try:
                await actuator.apply(decided)
            except Exception:
                log.exception("actuator %r failed for tick %d",
                              actuator, decided.tick)
        return decided

    # -------------------------------------------------------------- lifecycle
    async def attach(self) -> "PlannerLoop":
        """Subscribe to the metrics plane without starting the periodic
        task — callers that drive tick_once() themselves (tests, a host
        process with its own cadence) get deterministic tick counts."""
        if self._sub is None:
            self._sub = await self.coord.subscribe(
                metrics_subject(self.namespace), self._on_metrics)
        return self

    async def start(self) -> "PlannerLoop":
        await self.attach()
        self._task = asyncio.ensure_future(self._run())
        return self

    async def _run(self) -> None:
        while True:
            try:
                await self.tick_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("planner tick failed; retrying")
            await asyncio.sleep(self.interval_s)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._sub is not None:
            try:
                await self.coord.unsubscribe(self._sub)
            except Exception:
                pass
            self._sub = None
