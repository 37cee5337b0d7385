"""HTTP service metrics in Prometheus text exposition format.

The counterpart of ``dynamo_tpu/llm/http/metrics.py`` for the families the
port feeds: request counters by model/endpoint/status, the inflight gauge
with its guard, output tokens, the TTFT, inter-token, queue-wait and
request-duration histograms, the served engine's prefill,
unified-dispatch and lookahead counters (``engine/counters.py``), the
streamed KV handoff's counters and the measured KV-transfer edges
(``obs/costs.py``, rendered once an edge has a sample).  Every
name comes from ``obs/metric_names.py`` and every line is rendered as the
JAX package renders it.  No prometheus client dependency — the text format
is trivial to emit.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Iterator

from dynamo_tpu_torch.engine.counters import (LookaheadCounters, PrefillCounters,
                                              kv_stream_counters)
from dynamo_tpu_torch.obs.costs import transfer_costs
from dynamo_tpu_torch.obs.metric_names import EngineMetric as EM
from dynamo_tpu_torch.obs.metric_names import HttpMetric as HM
from dynamo_tpu_torch.obs.metric_names import KvStreamMetric as STM
from dynamo_tpu_torch.obs.metric_names import KvTransferMetric as KM

__all__ = ["Histogram", "Metrics", "InflightGuard"]

# seconds; TTFT and whole-request durations share one ladder
_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# finer ladder for per-token gaps — ITL sits well under the request
# ladder's first bound on warm decode
_ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5)


class Histogram:
    """Minimal Prometheus histogram (cumulative buckets + sum + count)."""

    def __init__(self, buckets: tuple = _BUCKETS) -> None:
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last = +Inf
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        # first bucket with bound >= v; past the ladder = the +Inf slot
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.total += v
        self.n += 1

    def render(self, name: str, labels: str) -> Iterator[str]:
        cum = 0
        for b, c in zip(self.buckets, self.counts):
            cum += c
            yield f'{name}_bucket{{{labels},le="{b}"}} {cum}'
        yield f'{name}_bucket{{{labels},le="+Inf"}} {self.n}'
        yield f'{name}_sum{{{labels}}} {round(self.total, 6)}'
        yield f'{name}_count{{{labels}}} {self.n}'


class Metrics:
    def __init__(self, core=None) -> None:
        # the served EngineCore whose counters the engine families render
        # (None, as for out=echo: they render as zeros)
        self.core = core
        # (model, endpoint, status) -> count
        self.requests: dict[tuple[str, str, str], int] = defaultdict(int)
        # model -> inflight
        self.inflight: dict[str, int] = defaultdict(int)
        self.tokens_out: dict[str, int] = defaultdict(int)
        self.ttft: dict[str, Histogram] = defaultdict(Histogram)
        # per-token gap after the first token; multi-token emissions spread
        # the emission gap evenly across their tokens
        self.itl: dict[str, Histogram] = defaultdict(lambda: Histogram(_ITL_BUCKETS))
        # submit -> slot admission wait inside the engine (from
        # EngineRequest.queue_wait_s via Context annotations)
        self.queue_wait: dict[str, Histogram] = defaultdict(Histogram)
        # duration keyed by (model, status): near-zero error/disconnect
        # requests must not pull the success series' percentiles down
        self.duration: dict[tuple[str, str], Histogram] = defaultdict(Histogram)

    def guard(self, model: str, endpoint: str) -> "InflightGuard":
        return InflightGuard(self, model, endpoint)

    def render(self) -> str:
        lines: list[str] = []
        lines.append(f"# TYPE {HM.REQUESTS_TOTAL} counter")
        for (model, endpoint, status), n in sorted(self.requests.items()):
            lines.append(
                f'{HM.REQUESTS_TOTAL}{{model="{model}",endpoint="{endpoint}",status="{status}"}} {n}'
            )
        lines.append(f"# TYPE {HM.INFLIGHT_REQUESTS} gauge")
        for model, n in sorted(self.inflight.items()):
            lines.append(f'{HM.INFLIGHT_REQUESTS}{{model="{model}"}} {n}')
        lines.append(f"# TYPE {HM.OUTPUT_TOKENS_TOTAL} counter")
        for model, n in sorted(self.tokens_out.items()):
            lines.append(f'{HM.OUTPUT_TOKENS_TOTAL}{{model="{model}"}} {n}')
        lines.append(f"# TYPE {HM.TTFT_SECONDS} histogram")
        for model, h in sorted(self.ttft.items()):
            lines.extend(h.render(HM.TTFT_SECONDS, f'model="{model}"'))
        lines.append(f"# TYPE {HM.INTER_TOKEN_SECONDS} histogram")
        for model, h in sorted(self.itl.items()):
            lines.extend(h.render(HM.INTER_TOKEN_SECONDS, f'model="{model}"'))
        lines.append(f"# TYPE {HM.QUEUE_WAIT_SECONDS} histogram")
        for model, h in sorted(self.queue_wait.items()):
            lines.extend(h.render(HM.QUEUE_WAIT_SECONDS, f'model="{model}"'))
        lines.append(f"# TYPE {HM.REQUEST_SECONDS} histogram")
        for (model, status), h in sorted(self.duration.items()):
            lines.extend(h.render(HM.REQUEST_SECONDS, f'model="{model}",status="{status}"'))
        # prefill batching: how well the token-budget ragged prefill packs
        # the device
        if self.core is not None:
            pc, lc = self.core.prefill_counters, self.core.lookahead_counters
        else:
            pc, lc = PrefillCounters(), LookaheadCounters()
        for name, typ, val in (
                (EM.PREFILL_DISPATCHES_TOTAL, "counter", pc.dispatches_total),
                (EM.PREFILL_TOKENS_TOTAL, "counter", pc.tokens_total),
                (EM.PREFILL_BATCH_OCCUPANCY, "gauge", round(pc.batch_occupancy, 6)),
                (EM.PREFILL_BUDGET_UTILIZATION, "gauge", round(pc.budget_utilization, 6)),
                # unified mixed prefill+decode dispatch
                (EM.UNIFIED_DISPATCHES_TOTAL, "counter", pc.unified_dispatches_total),
                (EM.UNIFIED_DECODE_ROWS_TOTAL, "counter", pc.unified_decode_rows_total),
                (EM.UNIFIED_PREFILL_TOKENS_TOTAL, "counter", pc.unified_prefill_tokens_total),
                (EM.UNIFIED_BUDGET_UTILIZATION, "gauge",
                 round(pc.unified_budget_utilization, 6)),
                # lookahead bursts and the speculative next-turn prebuilds
                (EM.LOOKAHEAD_BURSTS_TOTAL, "counter", lc.bursts_total),
                (EM.LOOKAHEAD_HITS_TOTAL, "counter", lc.hits_total),
                (EM.LOOKAHEAD_MISPREDICTS_TOTAL, "counter",
                 lc.mispredicts_total),
                (EM.LOOKAHEAD_COMMITS_TOTAL, "counter", lc.commits_total),
                (EM.LOOKAHEAD_FLUSHES_TOTAL, "counter", lc.flushes_total),
                (EM.LOOKAHEAD_DISPATCH_DEPTH, "gauge", lc.dispatch_depth),
                # streamed KV handoff (llm/kv/stream.py): layer frames sent,
                # and how often a stream fell back to the whole-cache push
                (STM.SESSIONS_TOTAL, "counter", kv_stream_counters.sessions_total),
                (STM.LAYERS_SENT_TOTAL, "counter", kv_stream_counters.layers_sent_total),
                (STM.BYTES_TOTAL, "counter", kv_stream_counters.bytes_total),
                (STM.FALLBACKS_TOTAL, "counter", kv_stream_counters.fallbacks_total),
                (STM.OVERLAP_RATIO, "gauge", round(kv_stream_counters.overlap_ratio, 6))):
            lines.append(f"# TYPE {name} {typ}")
            lines.append(f"{name} {val}")
        # measured KV-transfer costs per (src, dst, path) edge
        costs = transfer_costs.snapshot()
        if costs:
            for name, typ in ((KM.CALLS_TOTAL, "counter"), (KM.BYTES_TOTAL, "counter"),
                              (KM.SECONDS_TOTAL, "counter"), (KM.MBPS, "gauge"),
                              (KM.LATENCY_MS, "gauge")):
                lines.append(f"# TYPE {name} {typ}")
                for (src, dst, path), e in sorted(costs.items()):
                    val = {KM.CALLS_TOTAL: e["calls"], KM.BYTES_TOTAL: e["bytes"],
                           KM.SECONDS_TOTAL: round(e["seconds"], 6),
                           KM.MBPS: round(e["ewma_mbps"], 6),
                           KM.LATENCY_MS: round(e["ewma_latency_s"] * 1e3, 6)}[name]
                    lines.append(f'{name}{{src="{src}",dst="{dst}",path="{path}"}} {val}')
        return "\n".join(lines) + "\n"


class InflightGuard:
    """Counts a request as inflight until closed; records final status."""

    def __init__(self, metrics: Metrics, model: str, endpoint: str):
        self._m = metrics
        self.model = model
        self.endpoint = endpoint
        self._status = "error"
        self._t0 = time.monotonic()
        self._saw_first = False
        self._last_tok = 0.0
        self._m.inflight[model] += 1

    def first_token(self) -> None:
        """Record TTFT once, at the first generated-token emission."""
        if not self._saw_first:
            self._saw_first = True
            now = time.monotonic()
            self._last_tok = now
            self._m.ttft[self.model].observe(now - self._t0)

    def tokens(self, k: int) -> None:
        """Record a k-token emission: TTFT on the first, then the
        emission gap spread as k equal inter-token observations (so the
        histogram count tracks tokens, and multi-step decode bursts
        don't read as one slow token)."""
        if k <= 0:
            return
        if not self._saw_first:
            self.first_token()
            k -= 1
            if k <= 0:
                return
        now = time.monotonic()
        per = (now - self._last_tok) / k
        h = self._m.itl[self.model]
        for _ in range(k):
            h.observe(per)
        self._last_tok = now

    def ok(self) -> None:
        self._status = "success"

    def status(self, s: str) -> None:
        self._status = s

    def close(self) -> None:
        self._m.inflight[self.model] -= 1
        self._m.requests[(self.model, self.endpoint, self._status)] += 1
        self._m.duration[(self.model, self._status)].observe(time.monotonic() - self._t0)
