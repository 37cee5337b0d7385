"""Prefill-batching and lookahead counters, one pair per engine.

The counterpart of the two families of ``dynamo_tpu/engine/counters.py``
that the PyTorch engine feeds.  The JAX package keeps one process-global
pair; here each ``EngineCore`` owns its pair (``prefill_counters``,
``lookahead_counters``) and records into it at the JAX engine's sites, its
``metrics()`` reads it, and the HTTP metrics endpoint
(``llm/http/metrics.py``) renders the served engine's pair.  So engines in
one process do not add into each other.  The names rendered:

    dynamo_tpu_engine_prefill_dispatches_total     counter
    dynamo_tpu_engine_prefill_tokens_total         counter
    dynamo_tpu_engine_prefill_batch_occupancy      gauge (rows/dispatch)
    dynamo_tpu_engine_prefill_budget_utilization   gauge (used/offered)
    dynamo_tpu_engine_unified_dispatches_total     counter
    dynamo_tpu_engine_unified_decode_rows_total    counter
    dynamo_tpu_engine_unified_prefill_tokens_total counter
    dynamo_tpu_engine_unified_budget_utilization   gauge (used/offered)
    dynamo_tpu_engine_lookahead_bursts_total       counter
    dynamo_tpu_engine_lookahead_hits_total         counter
    dynamo_tpu_engine_lookahead_mispredicts_total  counter
    dynamo_tpu_engine_lookahead_commits_total      counter
    dynamo_tpu_engine_lookahead_flushes_total      counter
    dynamo_tpu_engine_lookahead_dispatch_depth     gauge (turns/result read)
"""

from __future__ import annotations

__all__ = ["PrefillCounters", "LookaheadCounters"]


class PrefillCounters:
    def __init__(self) -> None:
        self.dispatches_total = 0
        self.rows_total = 0
        self.tokens_total = 0
        self.budget_offered_total = 0
        self.budget_used_total = 0
        self.unified_dispatches_total = 0
        self.unified_decode_rows_total = 0
        self.unified_prefill_tokens_total = 0
        self.unified_budget_offered_total = 0
        self.unified_budget_used_total = 0

    def record(self, rows: int, tokens: int, budget: int = 0) -> None:
        """One prefill dispatch: ``rows`` sequences packed, ``tokens``
        prompt tokens computed.  ``budget`` is the token budget offered
        (0 for legacy one-request / seq-parallel dispatches — those don't
        count toward budget utilization)."""
        self.dispatches_total += 1
        self.rows_total += rows
        self.tokens_total += tokens
        if budget > 0:
            self.budget_offered_total += budget
            self.budget_used_total += tokens

    def record_unified(self, decode_rows: int, prefill_tokens: int,
                       budget: int) -> None:
        """One unified mixed dispatch: ``decode_rows`` 1-token decode
        rows plus ``prefill_tokens`` prompt tokens packed on one flat
        axis, under an offered budget of ``budget`` tokens."""
        self.unified_dispatches_total += 1
        self.unified_decode_rows_total += decode_rows
        self.unified_prefill_tokens_total += prefill_tokens
        self.unified_budget_offered_total += budget
        self.unified_budget_used_total += decode_rows + prefill_tokens

    @property
    def unified_budget_utilization(self) -> float:
        """(decode rows + prefill tokens) / budget offered over unified
        dispatches."""
        if not self.unified_budget_offered_total:
            return 0.0
        return (self.unified_budget_used_total
                / self.unified_budget_offered_total)

    @property
    def batch_occupancy(self) -> float:
        """Mean sequences per prefill dispatch (lifetime)."""
        if not self.dispatches_total:
            return 0.0
        return self.rows_total / self.dispatches_total

    @property
    def budget_utilization(self) -> float:
        """Tokens packed / budget offered over batched dispatches."""
        if not self.budget_offered_total:
            return 0.0
        return self.budget_used_total / self.budget_offered_total


class LookaheadCounters:
    """Double-buffered dispatch (engine/core.py lookahead scheduler)
    counters.

        dynamo_tpu_engine_lookahead_bursts_total       counter (fused
                                                       multi-turn dispatches)
        dynamo_tpu_engine_lookahead_hits_total         counter (burst rows
                                                       whose predicted token
                                                       count held to the end)
        dynamo_tpu_engine_lookahead_mispredicts_total  counter (rows where a
                                                       stop fired mid-burst
                                                       and the tail was
                                                       discarded)
        dynamo_tpu_engine_lookahead_commits_total      counter (speculative
                                                       next-turn builds
                                                       committed as-is)
        dynamo_tpu_engine_lookahead_flushes_total      counter (speculative
                                                       builds discarded —
                                                       admission/finish
                                                       changed the plan)
        dynamo_tpu_engine_lookahead_dispatch_depth     gauge (device turns
                                                       folded per result read,
                                                       last burst)

    A *burst* is one fused dispatch that runs ``depth`` unified turns
    on the device with a single trailing result read — the
    prediction being that every active decode row yields exactly one
    token per turn unless a stop fires.  ``hits``/``mispredicts``
    count rows, ``commits``/``flushes`` count speculative host-side
    prebuilds of the *next* turn's dispatch operands.
    """

    def __init__(self) -> None:
        self.bursts_total = 0
        self.hits_total = 0
        self.mispredicts_total = 0
        self.commits_total = 0
        self.flushes_total = 0
        self.dispatch_depth = 0

    def record_burst(self, depth: int, hits: int, mispredicts: int) -> None:
        """One fused burst landed: ``depth`` device turns folded into
        one result read; ``hits`` rows consumed every predicted token,
        ``mispredicts`` rows stopped mid-burst (tail discarded)."""
        self.bursts_total += 1
        self.hits_total += hits
        self.mispredicts_total += mispredicts
        self.dispatch_depth = depth

    def record_commit(self) -> None:
        self.commits_total += 1

    def record_flush(self) -> None:
        self.flushes_total += 1
