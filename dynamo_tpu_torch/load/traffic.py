"""Seeded production-shaped traffic for the scale-simulation plane.

The counterpart of the JAX package's ``load/traffic.py``: the same
scenario families and the same draws, over the port's
``tokens.sequence_hashes``, so one seed gives the same requests in both
packages, token for token.

The generator is pure and deterministic: ``generate(spec, seed=, rps=,
duration_s=)`` returns the same request list byte-for-byte on every
machine (sub-streams are seeded by string tags, never by wall clock or
global RNG state).  Shapes modeled, per the FlowKV / Prefill-as-a-Service
observation that cache economies only pay off under production traffic:

  * **multi-turn agent sessions** — turn k's prompt is exactly turn
    k-1's prompt + the assistant's reply + the new user turn, so the
    previous turn's prefill blocks are a true prefix of the next turn
    (the router's chained sequence hashes match without any special
    casing here);
  * **tenant skew** — tenants drawn Zipf(a); each tenant has a fixed
    system-prompt prefix shared by all its sessions (cross-session
    overlap, not just intra-session);
  * **diurnal ramp** — sinusoidal rate modulation over the trace;
  * **burst storms** — windows where the arrival rate multiplies;
  * **failure storms** — a schedule of kill/restore marks the harness
    applies to simulated workers mid-trace.

Arrivals are an open-loop non-homogeneous Poisson process (thinning),
so an overloaded system sheds or queues — offered load never back-offs
to fit capacity, which is what makes the capacity knee observable.
"""

from __future__ import annotations

import bisect
import math
import random
from dataclasses import dataclass
from typing import Sequence

from dynamo_tpu_torch.tokens import sequence_hashes

__all__ = [
    "Request",
    "ScenarioSpec",
    "FAMILIES",
    "generate",
    "tenant_mass",
    "prefix_share",
    "arrival_histogram",
]

_VOCAB = 32000


@dataclass(frozen=True)
class Request:
    """One generated request, ready for the harness to dispatch."""

    rid: int
    arrival_s: float
    tenant: str
    session: str
    turn: int                 # 0-based turn index within the session
    token_ids: tuple          # full prompt (history included)
    osl: int                  # output tokens to decode
    priority: str = "normal"

    @property
    def isl(self) -> int:
        return len(self.token_ids)


@dataclass(frozen=True)
class ScenarioSpec:
    """One scenario family's shape.  Rates and durations are supplied by
    the harness (derived from the topology's capacity), so the same spec
    scales from a smoke run to a nightly million-request trace."""

    name: str
    family: str
    turns_max: int = 1
    think_s: float = 2.0            # virtual pause between a session's turns
    shared_prefix_blocks: int = 0   # tenant system-prompt depth (blocks)
    isl_blocks_mean: int = 8        # mean first-turn prompt length (blocks)
    osl_mean: int = 48              # mean output tokens
    num_tenants: int = 32
    zipf_a: float = 1.1
    diurnal_amplitude: float = 0.0  # rate *= 1 + A*sin(2*pi*t/period)
    diurnal_period_s: float = 60.0
    # burst storms: (start_frac, duration_frac, rate_multiplier)
    bursts: tuple = ()
    # failure storms: (at_frac, "kill"|"restore", worker_ordinal)
    failures: tuple = ()
    # TTFT SLA = factor * unloaded TTFT (router hop + one prefill)
    sla_ttft_factor: float = 20.0
    block_size: int = 16


FAMILIES: dict[str, ScenarioSpec] = {
    s.name: s for s in [
        # single-turn, no shared prefix: the pure routing/admission floor
        ScenarioSpec(name="steady", family="steady", turns_max=1,
                     shared_prefix_blocks=0, zipf_a=0.0),
        # agentic sessions with deep shared prefixes — the regime where
        # overlap-aware placement has to beat load balancing
        ScenarioSpec(name="agentic", family="agentic", turns_max=4,
                     think_s=1.5, shared_prefix_blocks=6,
                     isl_blocks_mean=8, osl_mean=64, num_tenants=16,
                     zipf_a=1.2),
        # diurnal ramp + a mid-trace burst storm
        ScenarioSpec(name="burst", family="burst", turns_max=2,
                     shared_prefix_blocks=3, diurnal_amplitude=0.5,
                     bursts=((0.45, 0.15, 3.0),), zipf_a=1.1),
        # a worker dies mid-trace and returns cold later
        ScenarioSpec(name="failure", family="failure", turns_max=2,
                     shared_prefix_blocks=3,
                     failures=((0.35, "kill", 0), (0.7, "restore", 0))),
    ]
}


def _rng(seed: int, tag: str) -> random.Random:
    """Independent deterministic sub-stream (str seeding is stable)."""
    return random.Random(f"dtload:{seed}:{tag}")


def _zipf_cum(n: int, a: float) -> list[float]:
    if a <= 0:
        w = [1.0] * n
    else:
        w = [1.0 / (r ** a) for r in range(1, n + 1)]
    total = sum(w)
    cum, acc = [], 0.0
    for x in w:
        acc += x / total
        cum.append(acc)
    return cum


def _rate_mult(spec: ScenarioSpec, t: float, duration_s: float) -> float:
    m = 1.0 + spec.diurnal_amplitude * math.sin(
        2.0 * math.pi * t / max(spec.diurnal_period_s, 1e-9))
    for start_frac, dur_frac, mult in spec.bursts:
        start = start_frac * duration_s
        if start <= t < start + dur_frac * duration_s:
            m *= mult
    return max(m, 0.0)


def _peak_mult(spec: ScenarioSpec) -> float:
    peak = 1.0 + spec.diurnal_amplitude
    for _s, _d, mult in spec.bursts:
        peak = max(peak, (1.0 + spec.diurnal_amplitude) * mult)
    return peak


def _tokens(rng: random.Random, n: int) -> list[int]:
    return [rng.randrange(_VOCAB) for _ in range(n)]


def _draw_len(rng: random.Random, mean: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(rng.expovariate(1.0 / max(mean, 1)))))


def generate(spec: ScenarioSpec, *, seed: int, rps: float,
             duration_s: float) -> list[Request]:
    """Open-loop trace: session starts arrive Poisson at
    ``rps / mean_turns`` modulated by the diurnal/burst envelope; each
    start expands into 1..turns_max turns spaced ``think_s`` apart."""
    bs = spec.block_size
    mean_turns = (1 + spec.turns_max) / 2.0
    session_rate = max(rps, 1e-9) / mean_turns
    lam_max = session_rate * _peak_mult(spec)

    arr = _rng(seed, "arrivals")
    zipf = _zipf_cum(spec.num_tenants, spec.zipf_a)
    prefix_cache: dict[str, list[int]] = {}

    requests: list[Request] = []
    rid = 0
    t = 0.0
    sess_no = 0
    while True:
        t += arr.expovariate(lam_max)
        if t >= duration_s:
            break
        # thinning: keep the candidate with prob rate(t)/rate_max
        if arr.random() >= _rate_mult(spec, t, duration_s) / _peak_mult(spec):
            continue
        tenant = f"t{bisect.bisect_left(zipf, arr.random())}"
        sess_no += 1
        session = f"s{sess_no}"
        srng = _rng(seed, f"session:{session}")
        n_turns = srng.randint(1, spec.turns_max)

        prefix = prefix_cache.get(tenant)
        if prefix is None:
            prefix = _tokens(_rng(seed, f"prefix:{tenant}"),
                             spec.shared_prefix_blocks * bs)
            prefix_cache[tenant] = prefix

        history = list(prefix)
        arrival = t
        for turn in range(n_turns):
            if arrival >= duration_s:
                break
            user_mean = max(bs, spec.isl_blocks_mean * bs - len(prefix)
                            if turn == 0 else 2 * bs)
            user = _tokens(srng, _draw_len(srng, user_mean, 4,
                                           8 * spec.isl_blocks_mean * bs))
            osl = _draw_len(srng, spec.osl_mean, 4, 4 * spec.osl_mean)
            p = srng.random()
            priority = "high" if p < 0.1 else ("low" if p > 0.9 else "normal")
            token_ids = tuple(history + user)
            requests.append(Request(
                rid=rid, arrival_s=round(arrival, 6), tenant=tenant,
                session=session, turn=turn, token_ids=token_ids, osl=osl,
                priority=priority))
            rid += 1
            # the served prompt + the assistant reply becomes the next
            # turn's history — an exact prefix, so prefill blocks reuse
            history = list(token_ids) + _tokens(srng, osl)
            arrival += spec.think_s + srng.expovariate(2.0 / spec.think_s)
    requests.sort(key=lambda r: (r.arrival_s, r.rid))
    return requests


# ------------------------------------------------------------------ oracles
# Distribution checks the tests pin the generator's shape with.


def tenant_mass(requests: Sequence[Request], top: int = 1) -> float:
    """Fraction of requests belonging to the ``top`` busiest tenants."""
    counts: dict[str, int] = {}
    for r in requests:
        counts[r.tenant] = counts.get(r.tenant, 0) + 1
    if not counts:
        return 0.0
    busiest = sorted(counts.values(), reverse=True)[:top]
    return sum(busiest) / len(requests)


def prefix_share(requests: Sequence[Request], block_size: int = 16) -> float:
    """Fraction of prompt blocks (over the whole trace, arrival order)
    whose chained sequence hash was already produced by an earlier
    request — the trace's intrinsic cache-reuse ceiling."""
    seen: set[int] = set()
    total = dup = 0
    for r in requests:
        for h in sequence_hashes(r.token_ids, block_size):
            total += 1
            if h in seen:
                dup += 1
            else:
                seen.add(h)
    return dup / total if total else 0.0


def arrival_histogram(requests: Sequence[Request], duration_s: float,
                      bins: int = 12) -> list[int]:
    out = [0] * bins
    for r in requests:
        i = min(bins - 1, int(r.arrival_s / max(duration_s, 1e-9) * bins))
        out[i] += 1
    return out
