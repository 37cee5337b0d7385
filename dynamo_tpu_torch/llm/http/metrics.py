"""HTTP service metrics in Prometheus text exposition format.

The counterpart of ``dynamo_tpu/llm/http/metrics.py`` for the families the
port feeds: request counters by model/endpoint/status, the inflight gauge
with its guard, output tokens, the admission controller's sheds, the
TTFT, inter-token, queue-wait and request-duration histograms, the fault
plane's process-global counters (``fault/counters.py``), the served
engine's prefill, unified-dispatch and lookahead counters
(``engine/counters.py``), the persistent KV tier's and the streamed KV
handoff's counters, the sharded router control plane's family, the served
engine's step timeline
(``obs/timeline.py``), the measured KV-transfer edges (``obs/costs.py``,
rendered once an edge has a sample) and the served engine's
predicted-vs-measured dispatch rows (``obs/perfmodel.py``, rendered once a
kind has been dispatched).  Every name comes from ``obs/metric_names.py``
and every line is rendered as the JAX package renders it.  No prometheus
client dependency — the text format is trivial to emit.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Iterator

from dynamo_tpu_torch.engine.counters import (LookaheadCounters, PrefillCounters,
                                              kv_shard_counters, kv_stream_counters,
                                              persist_counters)
from dynamo_tpu_torch.fault.counters import counters as fault_counters
from dynamo_tpu_torch.obs.costs import transfer_costs
from dynamo_tpu_torch.obs.metric_names import EngineMetric as EM
from dynamo_tpu_torch.obs.metric_names import FaultMetric as FM
from dynamo_tpu_torch.obs.metric_names import HttpMetric as HM
from dynamo_tpu_torch.obs.metric_names import KvShardMetric as SHM
from dynamo_tpu_torch.obs.metric_names import KvStreamMetric as STM
from dynamo_tpu_torch.obs.metric_names import KvTransferMetric as KM
from dynamo_tpu_torch.obs.metric_names import PerfMetric as PM
from dynamo_tpu_torch.obs.timeline import PHASES, StepTimeline

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
        # the perf plane's predicted step latencies, from the port's committed
        # perf manifest (a JSON read, once; nothing is priced here)
        try:
            from dynamo_tpu_torch.analysis.perfcheck import manifest_predictions

            self.predicted_steps = manifest_predictions()
        except Exception:
            self.predicted_steps = []
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
        # (model, priority) -> requests shed by admission control (429)
        self.shed: dict[tuple[str, str], int] = defaultdict(int)
        # live TTFT taps (seconds) — the admission controller subscribes
        # here so its deadline estimates track the serving latency plane
        self.ttft_listeners: list = []

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
        lines.append(f"# TYPE {HM.ADMISSION_SHED_TOTAL} counter")
        for (model, priority), n in sorted(self.shed.items()):
            lines.append(
                f'{HM.ADMISSION_SHED_TOTAL}{{model="{model}",priority="{priority}"}} {n}')
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
        # fault plane (process-global): migrations performed, drains live,
        # instances currently suspect per the health probes
        for name, typ, val in (
                (FM.MIGRATIONS_TOTAL, "counter", fault_counters.migrations_total),
                (FM.DRAINS_IN_PROGRESS, "gauge", fault_counters.drains_in_progress),
                (FM.SUSPECT_INSTANCES, "gauge", fault_counters.suspect_instances())):
            lines.append(f"# TYPE {name} {typ}")
            lines.append(f"{name} {val}")
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
                # persistent prefix-cache tier (llm/kv/persist.py): blocks and
                # tokens restored from disk instead of re-prefilled, spill
                # volume, and the store's footprint
                (EM.PERSIST_HITS_TOTAL, "counter", persist_counters.hits_total),
                (EM.PERSIST_MISSES_TOTAL, "counter", persist_counters.misses_total),
                (EM.PERSIST_RESTORED_TOKENS_TOTAL, "counter",
                 persist_counters.restored_tokens_total),
                (EM.PERSIST_SPILL_BYTES_TOTAL, "counter", persist_counters.spill_bytes_total),
                (EM.PERSIST_RESIDENT_BYTES, "gauge", persist_counters.resident_bytes),
                # streamed KV handoff (llm/kv/stream.py): layer frames sent,
                # and how often a stream fell back to the whole-cache push
                (STM.SESSIONS_TOTAL, "counter", kv_stream_counters.sessions_total),
                (STM.LAYERS_SENT_TOTAL, "counter", kv_stream_counters.layers_sent_total),
                (STM.BYTES_TOTAL, "counter", kv_stream_counters.bytes_total),
                (STM.FALLBACKS_TOTAL, "counter", kv_stream_counters.fallbacks_total),
                (STM.OVERLAP_RATIO, "gauge", round(kv_stream_counters.overlap_ratio, 6))):
            lines.append(f"# TYPE {name} {typ}")
            lines.append(f"{name} {val}")
        # sharded router control plane (llm/kv_router/shards/, process-global):
        # scatter rounds, partial gathers (a shard missed its deadline or
        # answered behind the generation fence), fan-out latency, per-shard
        # index gauges
        sc = kv_shard_counters
        for name, typ, val in (
                (SHM.SCATTERS_TOTAL, "counter", sc.scatters_total),
                (SHM.GATHER_PARTIAL_TOTAL, "counter", sc.gather_partial_total),
                (SHM.GENERATION, "gauge", sc.generation),
                (SHM.LAST_FAN_OUT, "gauge", sc.last_fan_out)):
            lines.append(f"# TYPE {name} {typ}")
            lines.append(f"{name} {val}")
        lines.append(f"# TYPE {SHM.FANOUT_LATENCY_MS} histogram")
        for edge, count in zip(sc.FANOUT_BUCKETS_MS, sc.fanout_bucket_counts):
            lines.append(f'{SHM.FANOUT_LATENCY_MS}_bucket{{le="{edge}"}} {count}')
        lines.append(f'{SHM.FANOUT_LATENCY_MS}_bucket{{le="+Inf"}} {sc.scatters_total}')
        lines.append(f"{SHM.FANOUT_LATENCY_MS}_sum {round(sc.fanout_ms_sum, 6)}")
        lines.append(f"{SHM.FANOUT_LATENCY_MS}_count {sc.scatters_total}")
        if sc.index_blocks:
            lines.append(f"# TYPE {SHM.INDEX_BLOCKS} gauge")
            for shard_id, blocks in sorted(sc.index_blocks.items()):
                lines.append(f'{SHM.INDEX_BLOCKS}{{shard="{shard_id}"}} {blocks}')
            lines.append(f"# TYPE {SHM.RESIDENT_KEYS} gauge")
            for shard_id, keys in sorted(sc.resident_keys.items()):
                lines.append(f'{SHM.RESIDENT_KEYS}{{shard="{shard_id}"}} {keys}')
        # the served engine's step timeline: per-phase wall attribution plus
        # the host gap a dispatching step spends outside dispatch, overlap
        # and readback
        tl = (self.core.timeline if self.core is not None else StepTimeline()).snapshot()
        lines.append(f"# TYPE {EM.STEPS_TOTAL} counter")
        lines.append(f"{EM.STEPS_TOTAL} {tl['steps_total']}")
        lines.append(f"# TYPE {EM.BUSY_STEPS_TOTAL} counter")
        lines.append(f"{EM.BUSY_STEPS_TOTAL} {tl['busy_steps_total']}")
        lines.append(f"# TYPE {EM.STEP_WALL_SECONDS_TOTAL} counter")
        lines.append(f"{EM.STEP_WALL_SECONDS_TOTAL} {round(tl['wall_seconds_total'], 6)}")
        lines.append(f"# TYPE {EM.STEP_PHASE_SECONDS_TOTAL} counter")
        for ph in PHASES:
            lines.append(f'{EM.STEP_PHASE_SECONDS_TOTAL}{{phase="{ph}"}} '
                         f"{round(tl['phases'][ph], 6)}")
        lines.append(f"# TYPE {EM.HOST_GAP_MS_PER_TURN} gauge")
        lines.append(f"{EM.HOST_GAP_MS_PER_TURN} {round(tl['host_gap_ms_per_turn'], 6)}")
        # smoothed per-step companions to the lifetime means above
        lines.append(f"# TYPE {EM.STEP_WALL_MS_EWMA} gauge")
        lines.append(f"{EM.STEP_WALL_MS_EWMA} {round(tl['ewma_wall_ms'], 6)}")
        lines.append(f"# TYPE {EM.HOST_GAP_MS_EWMA} gauge")
        lines.append(f"{EM.HOST_GAP_MS_EWMA} {round(tl['ewma_host_gap_ms'], 6)}")
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
        # the perf plane's roofline-predicted step latency per (entrypoint,
        # config, signature), read from the committed manifest at start
        rows = self.predicted_steps
        if rows:
            lines.append(f"# TYPE {PM.PREDICTED_STEP_MS} gauge")
            for r in rows:
                labels = (f'entrypoint="{r["entrypoint"]}",'
                          f'config="{r["config"]}",'
                          f'signature="{r["signature"]}",'
                          f'bound="{r["bound"]}"')
                lines.append(
                    f"{PM.PREDICTED_STEP_MS}{{{labels}}} "
                    f"{r['predicted_ms']}")
        # the served engine's roofline against its measured dispatch phase,
        # per dispatch kind
        recon = (self.core.perf_model.reconcile(self.core.timeline)
                 if self.core is not None else [])
        for name, field, typ in ((PM.PREDICTED_DISPATCH_MS, "predicted_ms", "gauge"),
                                 (PM.MEASURED_DISPATCH_MS, "measured_ms", "gauge"),
                                 (PM.DISPATCHES_TOTAL, "dispatches", "counter"),
                                 (PM.MODEL_ERROR_RATIO, "error_ratio", "gauge")):
            rendered = [r for r in recon if r.get(field) is not None]
            if not rendered:
                continue
            lines.append(f"# TYPE {name} {typ}")
            for r in rendered:
                lines.append(f'{name}{{kind="{r["kind"]}"}} {r[field]}')
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
            dt = now - self._t0
            self._m.ttft[self.model].observe(dt)
            for listener in self._m.ttft_listeners:
                listener(dt)

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
