"""The metric names the port renders on ``/metrics``.

A subset of ``dynamo_tpu/obs/metric_names.py``, spelled exactly as there,
so a dashboard or scraper reads either package's endpoint: the HTTP
service plane (admission shedding included), the fault plane, the
engine's prefill-batching, unified-dispatch, lookahead and
persistent-tier families and its step timeline, the
measured KV-transfer edges, the streamed KV handoff, the sharded router
control plane, the standalone metrics component's per-worker gauges and
the perf model's predicted-vs-measured rows and the perf plane's
``dynamo_tpu_perf_predicted_step_ms``, read from the port's committed
``analysis/perf_manifest.json``.  Every name is a full literal,
never composed.  ``SCHEMA`` is the name -> (type, labels) contract the
metrics plane (``analysis/metcheck.py``) holds the rendered census to.
"""

from __future__ import annotations

__all__ = ["SHARD_PREFIX", "HttpMetric", "FaultMetric", "EngineMetric", "KvTransferMetric",
           "KvStreamMetric", "KvShardMetric", "PerfMetric", "RouterMetric", "SCHEMA"]

# the sharded control plane's family prefix, kept only for prefix-scoped
# scraping; the names below never compose it
SHARD_PREFIX = "dynamo_tpu_kv_shard"


class HttpMetric:
    """HTTP service plane (``llm/http/metrics.py`` Metrics.render)."""

    REQUESTS_TOTAL = "dynamo_tpu_http_service_requests_total"
    INFLIGHT_REQUESTS = "dynamo_tpu_http_service_inflight_requests"
    OUTPUT_TOKENS_TOTAL = "dynamo_tpu_http_service_output_tokens_total"
    ADMISSION_SHED_TOTAL = "dynamo_tpu_http_service_admission_shed_total"
    TTFT_SECONDS = "dynamo_tpu_http_service_ttft_seconds"
    INTER_TOKEN_SECONDS = "dynamo_tpu_http_service_inter_token_seconds"
    QUEUE_WAIT_SECONDS = "dynamo_tpu_http_service_queue_wait_seconds"
    REQUEST_SECONDS = "dynamo_tpu_http_service_request_seconds"


class FaultMetric:
    """Fault plane (``fault/counters.py`` process-global counters)."""

    MIGRATIONS_TOTAL = "dynamo_tpu_fault_migrations_total"
    DRAINS_IN_PROGRESS = "dynamo_tpu_fault_drains_in_progress"
    SUSPECT_INSTANCES = "dynamo_tpu_fault_suspect_instances"


class EngineMetric:
    """Engine plane: prefill batching, unified dispatch, lookahead, the
    persistent tier (``engine/counters.py``) and the step timeline
    (``obs/timeline.py``)."""

    PREFILL_DISPATCHES_TOTAL = "dynamo_tpu_engine_prefill_dispatches_total"
    PREFILL_TOKENS_TOTAL = "dynamo_tpu_engine_prefill_tokens_total"
    PREFILL_BATCH_OCCUPANCY = "dynamo_tpu_engine_prefill_batch_occupancy"
    PREFILL_BUDGET_UTILIZATION = "dynamo_tpu_engine_prefill_budget_utilization"
    UNIFIED_DISPATCHES_TOTAL = "dynamo_tpu_engine_unified_dispatches_total"
    UNIFIED_DECODE_ROWS_TOTAL = "dynamo_tpu_engine_unified_decode_rows_total"
    UNIFIED_PREFILL_TOKENS_TOTAL = "dynamo_tpu_engine_unified_prefill_tokens_total"
    UNIFIED_BUDGET_UTILIZATION = "dynamo_tpu_engine_unified_budget_utilization"
    LOOKAHEAD_BURSTS_TOTAL = "dynamo_tpu_engine_lookahead_bursts_total"
    LOOKAHEAD_HITS_TOTAL = "dynamo_tpu_engine_lookahead_hits_total"
    LOOKAHEAD_MISPREDICTS_TOTAL = "dynamo_tpu_engine_lookahead_mispredicts_total"
    LOOKAHEAD_COMMITS_TOTAL = "dynamo_tpu_engine_lookahead_commits_total"
    LOOKAHEAD_FLUSHES_TOTAL = "dynamo_tpu_engine_lookahead_flushes_total"
    LOOKAHEAD_DISPATCH_DEPTH = "dynamo_tpu_engine_lookahead_dispatch_depth"
    PERSIST_HITS_TOTAL = "dynamo_tpu_engine_persist_hits_total"
    PERSIST_MISSES_TOTAL = "dynamo_tpu_engine_persist_misses_total"
    PERSIST_RESTORED_TOKENS_TOTAL = "dynamo_tpu_engine_persist_restored_tokens_total"
    PERSIST_SPILL_BYTES_TOTAL = "dynamo_tpu_engine_persist_spill_bytes_total"
    PERSIST_RESIDENT_BYTES = "dynamo_tpu_engine_persist_resident_bytes"
    STEPS_TOTAL = "dynamo_tpu_engine_steps_total"
    BUSY_STEPS_TOTAL = "dynamo_tpu_engine_busy_steps_total"
    STEP_WALL_SECONDS_TOTAL = "dynamo_tpu_engine_step_wall_seconds_total"
    STEP_PHASE_SECONDS_TOTAL = "dynamo_tpu_engine_step_phase_seconds_total"
    HOST_GAP_MS_PER_TURN = "dynamo_tpu_engine_host_gap_ms_per_turn"
    STEP_WALL_MS_EWMA = "dynamo_tpu_engine_step_wall_ms_ewma"
    HOST_GAP_MS_EWMA = "dynamo_tpu_engine_host_gap_ms_ewma"


class KvTransferMetric:
    """Measured KV-transfer cost edges (``obs/costs.py``)."""

    CALLS_TOTAL = "dynamo_tpu_kv_transfer_calls_total"
    BYTES_TOTAL = "dynamo_tpu_kv_transfer_bytes_total"
    SECONDS_TOTAL = "dynamo_tpu_kv_transfer_seconds_total"
    MBPS = "dynamo_tpu_kv_transfer_mbps"
    LATENCY_MS = "dynamo_tpu_kv_transfer_latency_ms"


class KvStreamMetric:
    """Streamed KV handoff (``llm/kv/stream.py`` counters)."""

    SESSIONS_TOTAL = "dynamo_tpu_kv_stream_sessions_total"
    LAYERS_SENT_TOTAL = "dynamo_tpu_kv_stream_layers_sent_total"
    BYTES_TOTAL = "dynamo_tpu_kv_stream_bytes_total"
    FALLBACKS_TOTAL = "dynamo_tpu_kv_stream_fallbacks_total"
    OVERLAP_RATIO = "dynamo_tpu_kv_stream_overlap_ratio"


class KvShardMetric:
    """Sharded control plane (``llm/kv_router/shards/`` counters)."""

    SCATTERS_TOTAL = "dynamo_tpu_kv_shard_scatters_total"
    GATHER_PARTIAL_TOTAL = "dynamo_tpu_kv_shard_gather_partial_total"
    GENERATION = "dynamo_tpu_kv_shard_generation"
    FANOUT_LATENCY_MS = "dynamo_tpu_kv_shard_fanout_latency_ms"
    LAST_FAN_OUT = "dynamo_tpu_kv_shard_last_fan_out"
    INDEX_BLOCKS = "dynamo_tpu_kv_shard_index_blocks"
    RESIDENT_KEYS = "dynamo_tpu_kv_shard_resident_keys"


class PerfMetric:
    """The perf plane's predicted step latency (``analysis/perfcheck.py``)
    and the runtime predicted-vs-measured dispatch rows
    (``obs/perfmodel.py``)."""

    PREDICTED_STEP_MS = "dynamo_tpu_perf_predicted_step_ms"
    PREDICTED_DISPATCH_MS = "dynamo_tpu_perf_predicted_dispatch_ms"
    MEASURED_DISPATCH_MS = "dynamo_tpu_perf_measured_dispatch_ms"
    DISPATCHES_TOTAL = "dynamo_tpu_perf_dispatches_total"
    MODEL_ERROR_RATIO = "dynamo_tpu_perf_model_error_ratio"


class RouterMetric:
    """Standalone metrics aggregation component
    (``components/metrics.py`` PrometheusMetricsCollector)."""

    KV_BLOCKS_ACTIVE = "dynamo_tpu_kv_blocks_active"
    KV_BLOCKS_TOTAL = "dynamo_tpu_kv_blocks_total"
    REQUEST_ACTIVE_SLOTS = "dynamo_tpu_request_active_slots"
    REQUESTS_WAITING = "dynamo_tpu_requests_waiting"
    KV_CACHE_USAGE = "dynamo_tpu_kv_cache_usage"
    ROUTING_DECISIONS_TOTAL = "dynamo_tpu_routing_decisions_total"
    KV_HIT_RATE_PERCENT = "dynamo_tpu_kv_hit_rate_percent"


# name -> (type, labels): the committed label-schema contract, exactly the
# names the port renders, each entry equal to the JAX package's.  Histogram
# entries list their sample labels WITHOUT the implicit "le" (the render
# side adds it on _bucket lines); the metrics plane's census
# (analysis/metcheck.py) normalizes the same way before comparing.
SCHEMA: dict[str, tuple[str, tuple[str, ...]]] = {
    HttpMetric.REQUESTS_TOTAL: ("counter", ("model", "endpoint", "status")),
    HttpMetric.INFLIGHT_REQUESTS: ("gauge", ("model",)),
    HttpMetric.OUTPUT_TOKENS_TOTAL: ("counter", ("model",)),
    HttpMetric.ADMISSION_SHED_TOTAL: ("counter", ("model", "priority")),
    HttpMetric.TTFT_SECONDS: ("histogram", ("model",)),
    HttpMetric.INTER_TOKEN_SECONDS: ("histogram", ("model",)),
    HttpMetric.QUEUE_WAIT_SECONDS: ("histogram", ("model",)),
    HttpMetric.REQUEST_SECONDS: ("histogram", ("model", "status")),
    FaultMetric.MIGRATIONS_TOTAL: ("counter", ()),
    FaultMetric.DRAINS_IN_PROGRESS: ("gauge", ()),
    FaultMetric.SUSPECT_INSTANCES: ("gauge", ()),
    EngineMetric.PREFILL_DISPATCHES_TOTAL: ("counter", ()),
    EngineMetric.PREFILL_TOKENS_TOTAL: ("counter", ()),
    EngineMetric.PREFILL_BATCH_OCCUPANCY: ("gauge", ()),
    EngineMetric.PREFILL_BUDGET_UTILIZATION: ("gauge", ()),
    EngineMetric.UNIFIED_DISPATCHES_TOTAL: ("counter", ()),
    EngineMetric.UNIFIED_DECODE_ROWS_TOTAL: ("counter", ()),
    EngineMetric.UNIFIED_PREFILL_TOKENS_TOTAL: ("counter", ()),
    EngineMetric.UNIFIED_BUDGET_UTILIZATION: ("gauge", ()),
    EngineMetric.LOOKAHEAD_BURSTS_TOTAL: ("counter", ()),
    EngineMetric.LOOKAHEAD_HITS_TOTAL: ("counter", ()),
    EngineMetric.LOOKAHEAD_MISPREDICTS_TOTAL: ("counter", ()),
    EngineMetric.LOOKAHEAD_COMMITS_TOTAL: ("counter", ()),
    EngineMetric.LOOKAHEAD_FLUSHES_TOTAL: ("counter", ()),
    EngineMetric.LOOKAHEAD_DISPATCH_DEPTH: ("gauge", ()),
    EngineMetric.PERSIST_HITS_TOTAL: ("counter", ()),
    EngineMetric.PERSIST_MISSES_TOTAL: ("counter", ()),
    EngineMetric.PERSIST_RESTORED_TOKENS_TOTAL: ("counter", ()),
    EngineMetric.PERSIST_SPILL_BYTES_TOTAL: ("counter", ()),
    EngineMetric.PERSIST_RESIDENT_BYTES: ("gauge", ()),
    EngineMetric.STEPS_TOTAL: ("counter", ()),
    EngineMetric.BUSY_STEPS_TOTAL: ("counter", ()),
    EngineMetric.STEP_WALL_SECONDS_TOTAL: ("counter", ()),
    EngineMetric.STEP_PHASE_SECONDS_TOTAL: ("counter", ("phase",)),
    EngineMetric.HOST_GAP_MS_PER_TURN: ("gauge", ()),
    EngineMetric.STEP_WALL_MS_EWMA: ("gauge", ()),
    EngineMetric.HOST_GAP_MS_EWMA: ("gauge", ()),
    KvTransferMetric.CALLS_TOTAL: ("counter", ("src", "dst", "path")),
    KvTransferMetric.BYTES_TOTAL: ("counter", ("src", "dst", "path")),
    KvTransferMetric.SECONDS_TOTAL: ("counter", ("src", "dst", "path")),
    KvTransferMetric.MBPS: ("gauge", ("src", "dst", "path")),
    KvTransferMetric.LATENCY_MS: ("gauge", ("src", "dst", "path")),
    KvStreamMetric.SESSIONS_TOTAL: ("counter", ()),
    KvStreamMetric.LAYERS_SENT_TOTAL: ("counter", ()),
    KvStreamMetric.BYTES_TOTAL: ("counter", ()),
    KvStreamMetric.FALLBACKS_TOTAL: ("counter", ()),
    KvStreamMetric.OVERLAP_RATIO: ("gauge", ()),
    KvShardMetric.SCATTERS_TOTAL: ("counter", ()),
    KvShardMetric.GATHER_PARTIAL_TOTAL: ("counter", ()),
    KvShardMetric.GENERATION: ("gauge", ()),
    KvShardMetric.FANOUT_LATENCY_MS: ("histogram", ()),
    KvShardMetric.LAST_FAN_OUT: ("gauge", ()),
    KvShardMetric.INDEX_BLOCKS: ("gauge", ("shard",)),
    KvShardMetric.RESIDENT_KEYS: ("gauge", ("shard",)),
    PerfMetric.PREDICTED_STEP_MS: (
        "gauge", ("entrypoint", "config", "signature", "bound")),
    PerfMetric.PREDICTED_DISPATCH_MS: ("gauge", ("kind",)),
    PerfMetric.MEASURED_DISPATCH_MS: ("gauge", ("kind",)),
    PerfMetric.DISPATCHES_TOTAL: ("counter", ("kind",)),
    PerfMetric.MODEL_ERROR_RATIO: ("gauge", ("kind",)),
    RouterMetric.KV_BLOCKS_ACTIVE: ("gauge", ("worker",)),
    RouterMetric.KV_BLOCKS_TOTAL: ("gauge", ("worker",)),
    RouterMetric.REQUEST_ACTIVE_SLOTS: ("gauge", ("worker",)),
    RouterMetric.REQUESTS_WAITING: ("gauge", ("worker",)),
    RouterMetric.KV_CACHE_USAGE: ("gauge", ("worker",)),
    RouterMetric.ROUTING_DECISIONS_TOTAL: ("counter", ("worker",)),
    RouterMetric.KV_HIT_RATE_PERCENT: ("gauge", ("worker",)),
}
