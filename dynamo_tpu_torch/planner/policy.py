"""Pure planner policy: metrics snapshot in → plan out.

A copy of ``dynamo_tpu/planner/policy.py``: the same plans and states for
the same snapshots.  As in the Dynamo Planner, the planner continuously
re-plans worker allocation from live KV/queue metrics.  This module is the
decision kernel of our planner subsystem — deterministic and free of IO,
clocks, and randomness, so the whole policy is testable by simulation on
CPU (the tests drive it through a scripted load trace).

Three cooperating decision surfaces:

  * **prefill_replica_target** — queue-depth levelling for prefill pools
    (replicas toward ceil(depth / target_per_replica)).
  * **decode_replica_target** — HPA-style levelling on decode saturation
    (max of slot/KV usage per worker, averaged over the REPORTING workers).
    Stale-metrics rule: when fewer workers report fresh metrics than are
    registered, the policy HOLDS current replicas — silent workers may be
    saturated, and multiplying average usage by the fresh-only count would
    shrink the product and drive a bogus scale-down.
  * **plan()** — the full per-tick decision: both pool targets, plus the
    prefill↔decode role-flip state machine (hysteresis via patience +
    cooldown tick counters carried in an explicit, immutable PolicyState).

Every consumer shares these functions: the planner loop (planner/core.py),
the k8s operator's autoscaler (deploy/operator.py), and the sdk supervisor
actuator (planner/core.py SupervisorActuator) — one formula, three
actuation backends.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

__all__ = [
    "WorkerSample",
    "PoolSnapshot",
    "MetricsSnapshot",
    "PlannerConfig",
    "PolicyState",
    "Plan",
    "PlannerPolicy",
    "plan",
    "prefill_replica_target",
    "decode_replica_target",
    "step_replicas",
]


def _clamp(v: int, lo: int, hi: int) -> int:
    return min(hi, max(lo, v))


@dataclass(frozen=True)
class WorkerSample:
    """One worker's fresh ForwardPassMetrics, reduced to the planner's
    inputs (ref kv_router/protocols.rs:30-47)."""

    worker_id: int
    request_active_slots: int = 0
    request_total_slots: int = 1
    kv_active_blocks: int = 0
    kv_total_blocks: int = 1
    num_requests_waiting: int = 0

    @property
    def usage(self) -> float:
        """Saturation = max(slot usage, KV usage): a worker is full when
        EITHER resource runs out (slots gate admission, KV gates length)."""
        slot = self.request_active_slots / max(self.request_total_slots, 1)
        kv = self.kv_active_blocks / max(self.kv_total_blocks, 1)
        return max(slot, kv)


@dataclass(frozen=True)
class PoolSnapshot:
    """One pool (prefill or decode) as the planner sees it this tick."""

    replicas: int = 1        # current desired replica count (last plan)
    registered: int = 0      # live coordinator registrations
    samples: tuple = ()      # WorkerSamples with FRESH metrics (reporting subset)
    queue_depth: int = 0     # pending work (remote-prefill queue for prefill)

    @property
    def usage(self) -> Optional[float]:
        """Mean saturation over reporting workers; None when nobody reports."""
        if not self.samples:
            return None
        return sum(s.usage for s in self.samples) / len(self.samples)


@dataclass(frozen=True)
class MetricsSnapshot:
    """Everything plan() may look at for one tick.  ``tick`` is the only
    notion of time — the policy never reads a clock."""

    tick: int
    prefill: PoolSnapshot
    decode: PoolSnapshot
    isl_mean: float = 0.0    # observed input-length mix (tokens)
    osl_mean: float = 0.0    # observed output-length mix (tokens)


@dataclass(frozen=True)
class PlannerConfig:
    prefill_min: int = 1
    prefill_max: int = 8
    decode_min: int = 1
    decode_max: int = 8
    # prefill queue levelling: replicas toward ceil(depth / per_replica)
    queue_target_per_replica: int = 4
    # decode saturation levelling (HPA target)
    decode_target_usage: float = 0.7
    # role-flip state machine
    flip_high: float = 0.85       # a pool at/above this is "hot"
    flip_low: float = 0.25        # a pool at/below this is "idle"
    flip_patience: int = 3        # consecutive hot ticks before flipping
    flip_cooldown: int = 10       # ticks between flips (no thrash)
    # a mix counts as decode-heavy when osl_mean >= ratio * isl_mean —
    # the long-OSL regime where decode capacity, not prefill, is scarce
    decode_heavy_osl_ratio: float = 1.0


@dataclass(frozen=True)
class PolicyState:
    """Flip hysteresis, carried explicitly: plan() is a pure transition
    (state, snapshot) -> (state', Plan)."""

    prefill_hot_ticks: int = 0
    decode_hot_ticks: int = 0
    cooldown: int = 0


@dataclass(frozen=True)
class Plan:
    """One tick's decision.  ``flip`` is advisory role conversion — the
    replica numbers already include its effect, so an actuator that only
    understands per-pool scaling still converges to the same shape."""

    tick: int
    prefill_replicas: int
    decode_replicas: int
    flip: Optional[str] = None   # "prefill_to_decode" | "decode_to_prefill"
    decode_usage: Optional[float] = None
    prefill_queue_depth: int = 0
    reason: str = ""


def step_replicas(current: int, want: int) -> int:
    """Asymmetric levelling: scale up jumps straight to the target (queued
    work is latency), scale down steps ONE replica per tick (cheap
    hysteresis — a transiently cool signal must not flap the pool)."""
    if want > current:
        return want
    if want < current:
        return current - 1
    return current


def prefill_replica_target(queue_depth: int, current: int, per_replica: int,
                           lo: int, hi: int) -> int:
    """Queue-depth levelling: replicas toward ceil(depth / per_replica),
    clamped to [lo, hi]."""
    per = max(1, per_replica)
    return _clamp(math.ceil(queue_depth / per), lo, hi)


def decode_replica_target(
    current: int,
    registered: int,
    usages: list[float] | tuple[float, ...],
    target_usage: float,
    lo: int,
    hi: int,
) -> tuple[int, Optional[float]]:
    """(want, usage) from decode-side saturation with the HPA formula
    ceil(reporting × usage / target).

    The multiplier is the REPORTING worker count, not desired replicas:
    during a scale-up the new pods haven't registered yet, and multiplying
    by the desired count would compound the same saturation into max
    within two ticks.

    Stale-metrics rule: when fewer workers report than are
    registered — publisher lag, worker startup, a wedged engine — HOLD at
    the clamped current value exactly like the no-metrics case.  The
    silent workers may be saturated; shrinking the product to the fresh
    subset would scale DOWN on absence of evidence.  [lo, hi] edits still
    apply on hold."""
    if not usages or len(usages) < registered:
        return _clamp(current, lo, hi), None
    usage = sum(usages) / len(usages)
    target = max(1e-3, target_usage)
    want = _clamp(math.ceil(len(usages) * usage / target), lo, hi)
    return want, usage


def plan(cfg: PlannerConfig, state: PolicyState,
         snap: MetricsSnapshot) -> tuple[PolicyState, Plan]:
    """One planning tick: level both pools toward their signals, then run
    the role-flip state machine.

    Flip rules (all deterministic on the snapshot + carried state):

      * prefill→decode: decode hot (usage ≥ flip_high), prefill idle
        (empty queue, usage ≤ flip_low), and the traffic mix decode-heavy
        (osl_mean ≥ ratio·isl_mean), sustained for ``flip_patience``
        consecutive ticks — then one prefill worker converts to decode.
      * decode→prefill: prefill queue over capacity while decode idle,
        sustained likewise.
      * after any flip, ``flip_cooldown`` ticks must pass before another.

    A flip moves ONE replica between pools on top of the levelled targets
    (bounded by each pool's [min, max]), so repeated decisions converge
    instead of oscillating."""
    pf, dc = snap.prefill, snap.decode

    pf_want = prefill_replica_target(
        pf.queue_depth, pf.replicas, cfg.queue_target_per_replica,
        cfg.prefill_min, cfg.prefill_max)
    dc_want, dc_usage = decode_replica_target(
        dc.replicas, dc.registered, [s.usage for s in dc.samples],
        cfg.decode_target_usage, cfg.decode_min, cfg.decode_max)
    pf_repl = step_replicas(pf.replicas, pf_want)
    dc_repl = step_replicas(dc.replicas, dc_want)

    pf_usage = pf.usage
    prefill_hot = pf.queue_depth > cfg.queue_target_per_replica * max(pf.registered, 1)
    prefill_idle = pf.queue_depth == 0 and (pf_usage is None or pf_usage <= cfg.flip_low)
    decode_hot = dc_usage is not None and dc_usage >= cfg.flip_high
    decode_idle = dc_usage is not None and dc_usage <= cfg.flip_low
    decode_heavy_mix = snap.osl_mean >= cfg.decode_heavy_osl_ratio * max(snap.isl_mean, 1.0)

    decode_hot_ticks = (
        state.decode_hot_ticks + 1
        if decode_hot and prefill_idle and decode_heavy_mix else 0
    )
    prefill_hot_ticks = (
        state.prefill_hot_ticks + 1 if prefill_hot and decode_idle else 0
    )
    cooldown = max(0, state.cooldown - 1)

    flip = None
    reason = f"queue={pf.queue_depth} decode_usage=" + (
        f"{dc_usage:.3f}" if dc_usage is not None else "hold")
    # the donor gate checks PRE-levelling replicas (the pool still has a
    # worker to give at tick start): both the flip and a step-down remove
    # exactly one worker per tick, so the flip REPLACES the donor's
    # levelling step rather than stacking on it — the receiving pool gets
    # one replica beyond its own levelled target
    if cooldown == 0:
        if decode_hot_ticks >= cfg.flip_patience and pf.replicas > cfg.prefill_min:
            flip = "prefill_to_decode"
        elif prefill_hot_ticks >= cfg.flip_patience and dc.replicas > cfg.decode_min:
            flip = "decode_to_prefill"
    if flip == "prefill_to_decode":
        pf_repl = max(cfg.prefill_min, min(pf_repl, pf.replicas - 1))
        dc_repl = min(cfg.decode_max, dc_repl + 1)
    elif flip == "decode_to_prefill":
        dc_repl = max(cfg.decode_min, min(dc_repl, dc.replicas - 1))
        pf_repl = min(cfg.prefill_max, pf_repl + 1)
    if flip:
        reason += f" flip={flip}"
        cooldown = cfg.flip_cooldown
        decode_hot_ticks = prefill_hot_ticks = 0

    new_state = PolicyState(
        prefill_hot_ticks=prefill_hot_ticks,
        decode_hot_ticks=decode_hot_ticks,
        cooldown=cooldown,
    )
    return new_state, Plan(
        tick=snap.tick,
        prefill_replicas=pf_repl,
        decode_replicas=dc_repl,
        flip=flip,
        decode_usage=dc_usage,
        prefill_queue_depth=pf.queue_depth,
        reason=reason,
    )


class PlannerPolicy:
    """Thin stateful wrapper over plan() for callers that don't want to
    thread PolicyState themselves (planner loop, interactive use).  All
    decision logic stays in the pure function."""

    def __init__(self, config: Optional[PlannerConfig] = None):
        self.config = config or PlannerConfig()
        self.state = PolicyState()

    def plan(self, snap: MetricsSnapshot) -> Plan:
        self.state, decided = plan(self.config, self.state, snap)
        return decided

    def reset(self) -> None:
        self.state = PolicyState()
