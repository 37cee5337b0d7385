"""The macro-simulation harness: real control plane, simulated scale.

The counterpart of the JAX package's ``load/sim.py`` over the port's
control plane (its ``analysis/detloop.py``, KV event codec, indexers,
scheduler, consistent-hash ring, transfer-cost table, admission
controller and planner policy), with the same topologies, cells, load
levels and router stress price.  Two things differ: the workers are
priced from the card's own serving figures (``LatencyModel.from_card``),
and a disaggregated cell prices its prefill-to-decode handoff on the
``"nvlink"`` path, since two simulated workers are two cards (the port's
``"ici"`` is the copy within one card).

One *cell* = (scenario family, topology) at one offered-load level.
``run_cell`` builds the real router stack — ``KvIndexer`` fed through
the real KV-event wire codec, ``KvScheduler`` with the real selector
cost model, the real ``AdmissionController`` — on a seeded ``DetLoop``,
then replays a generated trace against SimWorkers that consume virtual
time per the card's measured latencies.  Routing, admission, planner
role-flip and persist/transfer scoring all execute their actual code
paths; only chips and sockets are simulated.

Offered load is derived from the modeled capacity (min of worker-pool
throughput and the serialized router's decision rate) so ``level=1.0``
means "at the knee's doorstep" on every topology, and ``level=2.0`` is
a genuine overload.  Duration is level-independent: a level-2 cell
carries twice the requests of level-1.

Determinism contract: same (family, topology, seed, level, target,
latency model) → byte-identical ``canonical_bytes``.  The gate's LD003
rule holds this line; everything here avoids wall clock, global RNG,
and unordered iteration.
"""

from __future__ import annotations

import asyncio
import math
import os
import random
from dataclasses import dataclass, replace
from typing import Optional, Union

from dynamo_tpu_torch.analysis.detloop import DetLoop, RandomScheduler, run_deterministic
from dynamo_tpu_torch.llm.kv.events import event_from_wire
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.scheduler import (
    AllWorkersBusy,
    DefaultWorkerSelector,
    KvScheduler,
)
from dynamo_tpu_torch.llm.kv_router.shards.indexer import ShardedKvIndexer
from dynamo_tpu_torch.utils.chash import HashRing
from dynamo_tpu_torch.load.traffic import FAMILIES, generate
from dynamo_tpu_torch.load.workers import LatencyModel, SimWorker, SimWorkerDied
from dynamo_tpu_torch.obs.costs import TransferCostTable
from dynamo_tpu_torch.planner.admission import (
    AdmissionConfig,
    AdmissionController,
    AdmissionRejected,
    PriorityClass,
)
from dynamo_tpu_torch.planner.policy import (
    MetricsSnapshot,
    PlannerPolicy,
    PoolSnapshot,
    WorkerSample,
)
from dynamo_tpu_torch.tokens import sequence_hashes

__all__ = [
    "Topology",
    "TOPOLOGIES",
    "CELLS",
    "LOAD_LEVELS",
    "default_target",
    "run_cell",
    "sweep",
    "canonical_bytes",
    "knee_level",
]


@dataclass(frozen=True)
class Topology:
    name: str
    n_workers: int
    disagg: bool = False
    n_prefill: int = 0          # of n_workers, when disagg
    slots: int = 8
    kv_blocks: int = 4096
    # sharded control plane (llm/kv_router/shards/): number of router
    # replicas, each owning a hash partition of the prefix index and
    # serializing only its own decisions.  1 = the singleton router.
    router_shards: int = 1
    # per-topology router decision cost override (ms).  The default
    # LatencyModel prices a decision at the card run's measured singleton
    # cost, where the pool is the wall at any modeled scale; the
    # router-stress topologies below price it at the production-index
    # per-decision cost instead (full radix walk + scoring over a large
    # fleet) — the regime ROADMAP item 1 targets — so the singleton
    # router IS the binding constraint and sharding is measurable.
    router_ms: Optional[float] = None
    # per-topology offered-load grid override (None = LOAD_LEVELS);
    # the r-cells need headroom levels to locate each shard count's knee
    levels: Optional[tuple[float, ...]] = None

    @property
    def n_decode(self) -> int:
        return self.n_workers - (self.n_prefill if self.disagg else 0)


# offered-load grid for the router-stress cells: levels are priced off
# the SINGLETON's capacity for every shard count (see _derive), so the
# same level means the same absolute offered rps across r1/r2/r4 and
# knee levels are directly comparable.  The JAX plane chose 120ms a
# decision to keep the singleton router wall ~10x below its pool wall.
# At the card's figures a row's decode step is several ms, so the pool
# wall sits only a few times above the singleton's: the top levels meet
# the pool too, and there r2 and r4 knee at the same level (sharding
# still moves the knee past r1's, LD005).
ROUTER_STRESS_MS = 120.0
SHARD_LEVELS: tuple[float, ...] = (0.5, 1.0, 2.0, 4.0, 8.0)

TOPOLOGIES: dict[str, Topology] = {
    t.name: t for t in [
        Topology(name="w1", n_workers=1),
        Topology(name="w4", n_workers=4),
        Topology(name="w16", n_workers=16, disagg=True, n_prefill=4),
        # router-stress trio: identical pool, identical SLA, identical
        # offered-load pricing — only the shard count varies
        Topology(name="w16r1", n_workers=16, disagg=True, n_prefill=4,
                 router_shards=1, router_ms=ROUTER_STRESS_MS,
                 levels=SHARD_LEVELS),
        Topology(name="w16r2", n_workers=16, disagg=True, n_prefill=4,
                 router_shards=2, router_ms=ROUTER_STRESS_MS,
                 levels=SHARD_LEVELS),
        Topology(name="w16r4", n_workers=16, disagg=True, n_prefill=4,
                 router_shards=4, router_ms=ROUTER_STRESS_MS,
                 levels=SHARD_LEVELS),
    ]
}

# the committed capacity grid: every family on every topology except the
# steady floor twice over — 10 cells spanning 4 families x 3 topologies,
# plus the sharded-router trio on the session-heavy agentic family
CELLS: tuple[tuple[str, str], ...] = (
    ("steady", "w1"), ("steady", "w4"), ("steady", "w16"),
    ("agentic", "w1"), ("agentic", "w4"), ("agentic", "w16"),
    ("burst", "w4"), ("burst", "w16"),
    ("failure", "w4"), ("failure", "w16"),
    ("agentic", "w16r1"), ("agentic", "w16r2"), ("agentic", "w16r4"),
)

LOAD_LEVELS: tuple[float, ...] = (0.5, 1.0, 2.0)

# offered = level * this fraction of modeled capacity: level 1.0 runs
# warm but under the knee, level 2.0 is structurally past it
_UTILIZATION = 0.7
_SCRAPE_EVERY_S = 0.1
_PLANNER_TICK_S = 2.0

# the transfer-cost path of a disaggregated handoff: the prefill and the
# decode worker are two cards of one host (obs/topology.py's NVLink rate
# until a transfer is recorded)
_HANDOFF_PATH = "nvlink"


def default_target() -> int:
    """Requests per cell at level 1.0 (DTLOAD_TARGET overrides; a
    non-default value marks the run non-pinned for the drift rules)."""
    return int(os.environ.get("DTLOAD_TARGET", "") or 160)


def _lvl_key(level: float) -> str:
    return f"{level:g}"


@dataclass(frozen=True)
class _Derived:
    offered_rps: float
    duration_s: float
    sla_ttft_s: float
    service_s: float


def _router_s(topo: Topology, lat: LatencyModel) -> float:
    """Per-decision router cost, honoring the topology override."""
    return topo.router_ms / 1e3 if topo.router_ms is not None \
        else lat.router_s()


def _derive(spec, topo: Topology, lat: LatencyModel, level: float,
            target: int) -> _Derived:
    isl_tokens = spec.isl_blocks_mean * spec.block_size
    # mean engine occupancy of one request: a local prefill plus a
    # decode time-sliced across a full complement of co-resident slots
    # (the saturation regime — SimWorker scales step time by co-residency)
    service_s = (lat.prefill_s(isl_tokens)
                 + spec.osl_mean * lat.decode_step_s() * topo.slots)
    pool_cap = topo.n_decode * topo.slots / service_s
    r_s = _router_s(topo, lat)
    # deliberately SINGLETON-priced: router_cap ignores router_shards so
    # one level is the same absolute offered rps on every shard count —
    # the r-cells' knee comparison needs a common x-axis
    router_cap = 1.0 / r_s
    sys_cap = min(pool_cap, 0.9 * router_cap)
    base = _UTILIZATION * sys_cap
    duration = target / base
    sla = spec.sla_ttft_factor * (r_s
                                  + lat.prefill_s(isl_tokens)
                                  + lat.decode_step_s())
    return _Derived(offered_rps=level * base, duration_s=duration,
                    sla_ttft_s=sla, service_s=service_s)


def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]


def _admission_config(topo: Topology, d: _Derived) -> AdmissionConfig:
    # deadlines scale with the cell's SLA so shedding engages near the
    # knee instead of at the defaults' wall-clock-sized waits
    def pc(name: str, level: int, depth_mult: int, wait_mult: float):
        return PriorityClass(name, level,
                             max_queue_depth=depth_mult * topo.n_decode
                             * topo.slots,
                             max_wait_s=round(wait_mult * d.sla_ttft_s, 9))
    return AdmissionConfig(
        max_concurrent=topo.n_decode * topo.slots,
        priorities={
            "high": pc("high", 0, 8, 16.0),
            "normal": pc("normal", 1, 4, 8.0),
            "low": pc("low", 2, 2, 2.0),
        },
        default_service_s=round(d.service_s, 9),
    )


def run_cell(family: str, topology: Union[str, Topology], *, seed: int,
             level: float = 1.0, target_requests: Optional[int] = None,
             lat: Optional[LatencyModel] = None,
             collect_decisions: bool = False) -> dict:
    """One deterministic simulated cell.  Returns ``{"metrics", "census",
    "decisions"?}`` — everything the gate snapshots, rounded for stable
    canonical bytes."""
    spec = FAMILIES[family]
    topo = TOPOLOGIES[topology] if isinstance(topology, str) else topology
    lat = lat or LatencyModel.from_card()
    target = target_requests if target_requests is not None \
        else default_target()
    d = _derive(spec, topo, lat, level, target)
    # keep multi-turn sessions inside the trace window on fast topologies
    if spec.turns_max > 1:
        spec = replace(spec, think_s=min(
            spec.think_s, d.duration_s / (4.0 * spec.turns_max)))
    reqs = generate(spec, seed=seed, rps=d.offered_rps,
                    duration_s=d.duration_s)
    bs = spec.block_size

    loop = DetLoop(RandomScheduler(seed),
                   horizon_s=max(600.0, 40.0 * d.duration_s),
                   max_steps=max(300_000, 600 * max(1, len(reqs))))

    state = {
        "ttfts": [], "itls": [], "completed": 0, "shed": 0, "failed": 0,
        "tokens_out": 0, "router_busy": 0.0, "decisions": 0, "top1": 0,
        "overlap_blocks": 0, "isl_blocks": 0, "load_std_sum": 0.0,
        "load_std_n": 0, "t_end": 0.0,
    }
    census: dict[str, int] = {}
    decisions: list[dict] = []

    def bump(key: str, n: int = 1) -> None:
        census[key] = census.get(key, 0) + n

    async def _main() -> None:
        clock = loop.time
        n_shards = topo.router_shards
        if n_shards > 1:
            # the REAL sharded index: events split by hash ownership,
            # lookups run the scatter-gather merge (shards/scatter.py)
            indexer = ShardedKvIndexer(n_shards)
        else:
            indexer = KvIndexer(use_native=False)   # env-independent facts

        def publish(wire: dict) -> None:
            eid, wid, ev = event_from_wire(wire)
            indexer.apply_event(wid, ev, eid)
            bump("kv_events")

        decode_workers = {
            i: SimWorker(i, lat, publish=publish, clock=clock,
                         slots=topo.slots, kv_blocks=topo.kv_blocks,
                         block_size=bs)
            for i in range(topo.n_decode)
        }
        prefill_workers = [
            SimWorker(100 + i, lat, publish=publish, clock=clock,
                      slots=topo.slots, kv_blocks=topo.kv_blocks,
                      block_size=bs)
            for i in range(topo.n_prefill if topo.disagg else 0)
        ]
        selector = DefaultWorkerSelector(
            random.Random(f"dtload:{seed}:selector"))
        sched = KvScheduler(selector, block_size=bs,
                            transfer_weight=1.0 if topo.disagg else 0.0)
        costs = TransferCostTable(clock=clock)
        admission = AdmissionController(_admission_config(topo, d),
                                        clock=clock)
        for w in decode_workers.values():
            sched.update_worker(w.metrics())
        r_s = _router_s(topo, lat)
        # one lock per router replica: each replica serializes its own
        # decisions; sessions stick to a replica via the same consistent-
        # hash ring the frontends use (utils/chash.py), so a multi-turn
        # session's decisions stay ordered on one replica
        router_locks = [asyncio.Lock() for _ in range(n_shards)]
        if n_shards > 1:
            ring = HashRing(f"replica-{i}" for i in range(n_shards))
            replica_ix = {f"replica-{i}": i for i in range(n_shards)}

            def replica_of(session) -> int:
                return replica_ix[ring.lookup(f"session:{session}")]
        else:
            def replica_of(session) -> int:
                return 0
        t0 = clock()

        async def route(req):
            """The serialized router: one decision at a time PER REPLICA,
            each consuming its modeled cost — the singleton wall ROADMAP
            item 1 predicts (measurable as router_busy_frac), and the
            knob the sharded cells turn."""
            async with router_locks[replica_of(req.session)]:
                await asyncio.sleep(r_s)
                state["router_busy"] += r_s
                hashes = sequence_hashes(req.token_ids, bs)
                match = indexer.find_matches(hashes)
                tcosts = None
                pw = None
                if topo.disagg:
                    pw = min((w for w in prefill_workers if w.alive),
                             key=lambda w: (w._active + w._waiting, w.wid),
                             default=None)
                    if pw is not None:
                        nbytes = lat.transfer_bytes(len(hashes))
                        tcosts = {
                            wid: costs.cost_s(f"w{pw.wid}", f"w{wid}",
                                              _HANDOFF_PATH, nbytes)
                            for wid, w in decode_workers.items() if w.alive
                        }
                scored = sched.score_candidates(
                    match.scores, len(req.token_ids),
                    persist_overlaps=match.persist_scores,
                    transfer_costs_s=tcosts)
                wid = sched.schedule(
                    match.scores, len(req.token_ids),
                    persist_overlaps=match.persist_scores,
                    transfer_costs_s=tcosts)
                return hashes, match, wid, scored, pw

        async def handle(req) -> None:
            try:
                ticket = await admission.acquire(req.tenant, req.priority)
            except AdmissionRejected:
                state["shed"] += 1
                bump("shed")
                return
            t_arrive = clock()
            try:
                for attempt in (0, 1):
                    try:
                        hashes, match, wid, scored, pw = await route(req)
                    except AllWorkersBusy:
                        state["shed"] += 1
                        bump("shed_busy")
                        return
                    w = decode_workers[wid]
                    overlap = match.scores.get(wid, 0)
                    state["decisions"] += 1
                    if scored and wid == scored[0][0]:
                        state["top1"] += 1
                    state["overlap_blocks"] += overlap
                    state["isl_blocks"] += len(hashes)
                    if collect_decisions:
                        decisions.append({
                            "rid": req.rid, "session": req.session,
                            "turn": req.turn, "worker": wid,
                            "overlap_blocks": overlap,
                            "isl_blocks": len(hashes),
                        })
                    try:
                        if topo.disagg and pw is not None:
                            await pw.prefill(hashes, len(req.token_ids))
                            move = max(0, len(hashes) - overlap)
                            nbytes = lat.transfer_bytes(move)
                            src, dst = f"w{pw.wid}", f"w{wid}"
                            tr_s = costs.cost_s(src, dst, _HANDOFF_PATH,
                                                nbytes)
                            if move:
                                await asyncio.sleep(tr_s)
                                costs.record(src, dst, _HANDOFF_PATH, nbytes,
                                             tr_s)
                                bump("kv_transfers")
                            t_first, t_done, _ = await w.decode(
                                hashes, req.osl)
                        else:
                            t_first, t_done, _ = await w.decode(
                                hashes, req.osl,
                                prefill_tokens=len(req.token_ids))
                        ttft = t_first - t_arrive
                        itl = (t_done - t_first) / max(1, req.osl - 1)
                        state["ttfts"].append(ttft)
                        state["itls"].append(itl)
                        state["completed"] += 1
                        state["tokens_out"] += req.osl
                        admission.observe_ttft(ttft)
                        admission.observe_itl(itl)
                        return
                    except SimWorkerDied:
                        bump("worker_died")
                        if attempt == 0:
                            bump("retried")
                            continue
                        state["failed"] += 1
                        return
            finally:
                ticket.release()

        async def scrape() -> None:
            while True:
                await asyncio.sleep(_SCRAPE_EVERY_S)
                for w in decode_workers.values():
                    if w.alive:
                        sched.update_worker(w.metrics())
                ls = sched.load_summary()
                state["load_std_sum"] += ls["load_std"]
                state["load_std_n"] += 1

        async def planner_ticks() -> None:
            policy = PlannerPolicy()
            tick = 0
            osl_mean = float(spec.osl_mean)
            isl_mean = float(spec.isl_blocks_mean * bs)
            while True:
                await asyncio.sleep(_PLANNER_TICK_S)
                tick += 1

                def samples(ws):
                    return tuple(
                        WorkerSample(
                            worker_id=w.wid,
                            request_active_slots=m.request_active_slots,
                            request_total_slots=m.request_total_slots,
                            kv_active_blocks=m.kv_active_blocks,
                            kv_total_blocks=m.kv_total_blocks,
                            num_requests_waiting=m.num_requests_waiting,
                        )
                        for w in ws if w.alive
                        for m in (w.metrics(),))
                live_pf = [w for w in prefill_workers if w.alive]
                live_dc = [w for w in decode_workers.values() if w.alive]
                snap = MetricsSnapshot(
                    tick=tick,
                    prefill=PoolSnapshot(
                        replicas=len(prefill_workers),
                        registered=len(live_pf),
                        samples=samples(prefill_workers),
                        queue_depth=sum(w._waiting for w in live_pf)),
                    decode=PoolSnapshot(
                        replicas=len(decode_workers),
                        registered=len(live_dc),
                        samples=samples(decode_workers.values())),
                    isl_mean=isl_mean, osl_mean=osl_mean)
                p = policy.plan(snap)
                bump("planner_ticks")
                if p.flip:
                    bump("planner_flips")

        async def failure_storm() -> None:
            for at_frac, action, ordinal in spec.failures:
                when = t0 + at_frac * d.duration_s
                delay = when - clock()
                if delay > 0:
                    await asyncio.sleep(delay)
                w = decode_workers[ordinal % len(decode_workers)]
                if action == "kill":
                    w.kill()
                    sched.mark_suspect(w.wid)
                    bump("kills")
                    # the health plane's lease expiry follows shortly
                    await asyncio.sleep(2 * _SCRAPE_EVERY_S)
                    indexer.remove_worker(w.wid)
                    sched.remove_worker(w.wid)
                else:
                    w.restore()
                    sched.clear_suspect(w.wid)
                    sched.update_worker(w.metrics())
                    bump("restores")

        scrape_task = asyncio.ensure_future(scrape())
        plan_task = (asyncio.ensure_future(planner_ticks())
                     if topo.disagg else None)
        fail_task = (asyncio.ensure_future(failure_storm())
                     if spec.failures else None)

        req_tasks = []
        for req in reqs:
            delay = req.arrival_s - (clock() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
            req_tasks.append(asyncio.ensure_future(handle(req)))
        await asyncio.gather(*req_tasks)
        if fail_task is not None:
            await fail_task
        for t in (scrape_task, plan_task):
            if t is None:
                continue
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
        state["t_end"] = clock() - t0

    run_deterministic(loop, _main())
    loop.close()

    span = max(state["t_end"], 1e-9)
    ttfts = sorted(state["ttfts"])
    itls = sorted(state["itls"])
    n = len(reqs)
    metrics = {
        "offered_rps": round(d.offered_rps, 3),
        "duration_s": round(d.duration_s, 3),
        "sla_ttft_ms": round(d.sla_ttft_s * 1e3, 3),
        "requests": n,
        "completed": state["completed"],
        "shed_rate": round((state["shed"] + state["failed"]) / max(1, n), 4),
        "ttft_p50_ms": round(_pct(ttfts, 0.50) * 1e3, 3),
        "ttft_p95_ms": round(_pct(ttfts, 0.95) * 1e3, 3),
        "ttft_p99_ms": round(_pct(ttfts, 0.99) * 1e3, 3),
        "itl_p50_ms": round(_pct(itls, 0.50) * 1e3, 3),
        "itl_p99_ms": round(_pct(itls, 0.99) * 1e3, 3),
        "itl_mean_ms": round(
            sum(itls) / len(itls) * 1e3 if itls else 0.0, 3),
        "output_tok_s": round(state["tokens_out"] / span, 3),
        "overlap_ratio": round(
            state["overlap_blocks"] / max(1, state["isl_blocks"]), 4),
        "decision_top1_frac": round(
            state["top1"] / max(1, state["decisions"]), 4),
        "load_std": round(
            state["load_std_sum"] / max(1, state["load_std_n"]), 4),
        # busy fraction of the AGGREGATE replica budget: span seconds of
        # wall per replica — for shards=1 this is the singleton's
        # serialized busy fraction, unchanged
        "router_busy_frac": round(
            state["router_busy"] / (span * topo.router_shards), 4),
    }
    if topo.router_shards > 1:
        metrics["router_shards"] = topo.router_shards
    out = {"metrics": metrics, "census": dict(sorted(census.items()))}
    if collect_decisions:
        out["decisions"] = decisions
    return out


def canonical_bytes(result: dict) -> bytes:
    """Stable byte serialization of a cell result — the LD003 twin-run
    comparison surface."""
    import json

    return json.dumps(
        {"metrics": result["metrics"], "census": result["census"]},
        sort_keys=True, separators=(",", ":")).encode()


def knee_level(levels: dict, sla_ttft_ms: float) -> Optional[float]:
    """Lowest offered-load level whose p99 TTFT breaches the SLA or
    whose shed rate exceeds 1% — None when capacity holds everywhere."""
    for lvl in sorted(levels, key=float):
        m = levels[lvl]
        if m["ttft_p99_ms"] > sla_ttft_ms or m["shed_rate"] > 0.01:
            return float(lvl)
    return None


def sweep(*, budget: int = 1, seed_base: int = 0,
          target_requests: Optional[int] = None,
          lat: Optional[LatencyModel] = None,
          cells: Optional[tuple] = None) -> dict:
    """The full capacity grid.  ``budget`` adds extra seeds per cell
    (each with its own twin-determinism check) on top of the pinned
    level sweep; facts' level metrics always come from ``seed_base``
    so the committed manifest is budget-independent."""
    lat = lat or LatencyModel.from_card()
    target = target_requests if target_requests is not None \
        else default_target()
    out_cells: dict[str, dict] = {}
    for family, topology in (cells or CELLS):
        name = f"{family}/{topology}"
        grid = TOPOLOGIES[topology].levels or LOAD_LEVELS
        levels: dict[str, dict] = {}
        census: dict[str, int] = {}
        base_level1 = None
        for level in grid:
            res = run_cell(family, topology, seed=seed_base, level=level,
                           target_requests=target, lat=lat)
            levels[_lvl_key(level)] = res["metrics"]
            for k, v in res["census"].items():
                census[k] = census.get(k, 0) + v
            if level == 1.0:
                base_level1 = res
        twin_match = True
        for i in range(max(1, budget)):
            seed = seed_base + i
            first = base_level1 if i == 0 else run_cell(
                family, topology, seed=seed, level=1.0,
                target_requests=target, lat=lat)
            twin = run_cell(family, topology, seed=seed, level=1.0,
                            target_requests=target, lat=lat)
            if canonical_bytes(first) != canonical_bytes(twin):
                twin_match = False
        sla = levels[_lvl_key(1.0)]["sla_ttft_ms"]
        knee = knee_level(levels, sla)
        out_cells[name] = {
            "levels": levels,
            "census": census,
            "twin_match": twin_match,
            "knee_level": knee,
        }
    return {
        "cells": out_cells,
        "params": {
            "target_requests": target,
            "levels": [float(x) for x in LOAD_LEVELS],
            "scale": lat.scale,
            "prefill_ms_per_token": round(lat.prefill_ms_per_token, 9),
            "decode_ms_per_step": round(lat.decode_ms_per_step, 9),
            "router_ms_per_decision": lat.router_ms_per_decision,
            "kv_bytes_per_block": lat.kv_bytes_per_block,
        },
    }
