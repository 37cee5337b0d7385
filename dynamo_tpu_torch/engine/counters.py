"""Prefill-batching and lookahead counters, one pair per engine, and the
streamed KV handoff's counters, one per process.

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

__all__ = ["PrefillCounters", "LookaheadCounters", "KvStreamCounters", "kv_stream_counters"]


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


class KvStreamCounters:
    """Streamed KV handoff (llm/kv/stream.py) counters, under the JAX
    package's names (``obs/metric_names.py`` ``KvStreamMetric``):

        dynamo_tpu_kv_stream_sessions_total     counter (STREAM_BEGINs sent)
        dynamo_tpu_kv_stream_layers_sent_total  counter (WRITE_LAYER frames)
        dynamo_tpu_kv_stream_bytes_total        counter (layer payload bytes)
        dynamo_tpu_kv_stream_fallbacks_total    counter (sessions that fell
                                                back to the whole-cache push)
        dynamo_tpu_kv_stream_overlap_ratio      gauge

    ``overlap_ratio`` is transfer seconds HIDDEN under prefill compute
    (frames sent while later chunks were still computing) over total
    streamed transfer seconds.  One per process, as in the JAX package: a
    prefill worker's producer records, whichever engine it serves.
    """

    def __init__(self) -> None:
        self.reset()

    def record_session(self) -> None:
        self.sessions_total += 1

    def record_layer(self, nbytes: int, seconds: float, hidden: bool) -> None:
        """One WRITE_LAYER frame acked: ``hidden`` marks frames sent while
        the producer's prefill was still computing."""
        self.layers_sent_total += 1
        self.bytes_total += nbytes
        self.transfer_seconds_total += seconds
        if hidden:
            self.hidden_seconds_total += seconds

    def record_fallback(self) -> None:
        self.fallbacks_total += 1

    @property
    def overlap_ratio(self) -> float:
        if self.transfer_seconds_total <= 0:
            return 0.0
        return self.hidden_seconds_total / self.transfer_seconds_total

    def reset(self) -> None:
        """Test isolation hook — the counters are process-global."""
        self.sessions_total = 0
        self.layers_sent_total = 0
        self.bytes_total = 0
        self.fallbacks_total = 0
        self.transfer_seconds_total = 0.0
        self.hidden_seconds_total = 0.0


kv_stream_counters = KvStreamCounters()
