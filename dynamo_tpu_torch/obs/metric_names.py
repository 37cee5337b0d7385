"""The metric names the port renders on ``/metrics``.

A subset of ``dynamo_tpu/obs/metric_names.py``, spelled exactly as there,
so a dashboard or scraper reads either package's endpoint: the HTTP
service plane, the engine's prefill-batching, unified-dispatch and
lookahead families, the measured KV-transfer edges and the streamed KV
handoff.  Every name is a full literal, never composed.
"""

from __future__ import annotations

__all__ = ["HttpMetric", "EngineMetric", "KvTransferMetric", "KvStreamMetric"]


class HttpMetric:
    """HTTP service plane (``llm/http/metrics.py`` Metrics.render)."""

    REQUESTS_TOTAL = "dynamo_tpu_http_service_requests_total"
    INFLIGHT_REQUESTS = "dynamo_tpu_http_service_inflight_requests"
    OUTPUT_TOKENS_TOTAL = "dynamo_tpu_http_service_output_tokens_total"
    TTFT_SECONDS = "dynamo_tpu_http_service_ttft_seconds"
    INTER_TOKEN_SECONDS = "dynamo_tpu_http_service_inter_token_seconds"
    QUEUE_WAIT_SECONDS = "dynamo_tpu_http_service_queue_wait_seconds"
    REQUEST_SECONDS = "dynamo_tpu_http_service_request_seconds"


class EngineMetric:
    """Engine plane: prefill batching, unified dispatch and lookahead
    (``engine/counters.py``)."""

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
