"""Prefill-batching and lookahead counters, one pair per engine, and the
persistent tier's and the streamed KV handoff's counters, one per process.

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

The persistent tier's family (:class:`PersistCounters`) is process-global,
as in the JAX package: the store records its spills and residency where
it has no engine at hand.  So are the streamed KV handoff's
(:class:`KvStreamCounters`) and the sharded router control plane's
(:class:`KvShardCounters`), which have no engine either.
"""

from __future__ import annotations

__all__ = ["PrefillCounters", "LookaheadCounters", "PersistCounters", "persist_counters",
           "KvStreamCounters", "kv_stream_counters", "KvShardCounters", "kv_shard_counters"]


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


class PersistCounters:
    """Persistent prefix-cache tier (``llm/kv/persist.py``) counters.

        dynamo_tpu_engine_persist_hits_total            counter (blocks)
        dynamo_tpu_engine_persist_misses_total          counter (lookups
                                                        that restored
                                                        nothing)
        dynamo_tpu_engine_persist_restored_tokens_total counter
        dynamo_tpu_engine_persist_spill_bytes_total     counter
        dynamo_tpu_engine_persist_resident_bytes        gauge

    The store records spill volume and residency; the engine's restore
    path records hits/misses/restored tokens at commit time, so a match
    that failed to land on the device never counts as a hit.
    """

    def __init__(self) -> None:
        self.reset()

    def record_restore(self, blocks: int, tokens: int) -> None:
        self.hits_total += blocks
        self.restored_tokens_total += tokens

    def record_miss(self) -> None:
        self.misses_total += 1

    def record_spill(self, nbytes: int) -> None:
        self.spill_bytes_total += nbytes

    def set_resident(self, nbytes: int) -> None:
        self.resident_bytes = nbytes

    def reset(self) -> None:
        """Test isolation hook — the counters are process-global."""
        self.hits_total = 0
        self.misses_total = 0
        self.restored_tokens_total = 0
        self.spill_bytes_total = 0
        self.resident_bytes = 0


persist_counters = PersistCounters()


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


class KvShardCounters:
    """Sharded control plane (llm/kv_router/shards/) counters.

        dynamo_tpu_kv_shard_scatters_total        counter (gather rounds)
        dynamo_tpu_kv_shard_gather_partial_total  counter (rounds where a
                                                  shard missed its deadline
                                                  or answered stale)
        dynamo_tpu_kv_shard_fanout_latency_ms     histogram (scatter issue
                                                  → last reply/deadline)
        dynamo_tpu_kv_shard_generation            gauge (current fence)
        dynamo_tpu_kv_shard_last_fan_out          gauge (shards in the
                                                  last scatter round)
        dynamo_tpu_kv_shard_index_blocks{shard=}  gauge (device blocks)
        dynamo_tpu_kv_shard_resident_keys{shard=} gauge (distinct keys,
                                                  both tiers)

    The fan-out histogram lives here (cumulative bucket counts over the
    fixed ladder below) rather than in http/metrics.py's Histogram so
    the router layer stays free of the HTTP module; the render side
    turns the buckets into Prometheus histogram lines.
    """

    FANOUT_BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                         25.0, 50.0, 100.0)

    def __init__(self) -> None:
        self.reset()

    def record_scatter(self, fanout_ms: float, fan_out: int = 0) -> None:
        """One scatter round completed (all replies in, or deadline)."""
        self.scatters_total += 1
        self.fanout_ms_sum += fanout_ms
        self.last_fan_out = fan_out
        for i, edge in enumerate(self.FANOUT_BUCKETS_MS):
            if fanout_ms <= edge:
                self.fanout_bucket_counts[i] += 1

    def record_partial_gather(self) -> None:
        self.gather_partial_total += 1

    def set_generation(self, generation: int) -> None:
        self.generation = generation

    def set_shard_size(self, shard_id: int, index_blocks: int,
                       resident_keys: int) -> None:
        self.index_blocks[shard_id] = index_blocks
        self.resident_keys[shard_id] = resident_keys

    @property
    def gather_partial_frac(self) -> float:
        if not self.scatters_total:
            return 0.0
        return self.gather_partial_total / self.scatters_total

    def reset(self) -> None:
        """Test isolation hook — the counters are process-global."""
        self.scatters_total = 0
        self.gather_partial_total = 0
        self.fanout_ms_sum = 0.0
        self.fanout_bucket_counts = [0] * len(self.FANOUT_BUCKETS_MS)
        self.last_fan_out = 0
        self.generation = 0
        self.index_blocks: dict[int, int] = {}
        self.resident_keys: dict[int, int] = {}


kv_shard_counters = KvShardCounters()
