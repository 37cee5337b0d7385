"""Chrome trace-event JSON export (Perfetto-loadable).

A copy of the JAX package's ``obs/export.py``: the same document from the
same span records, so the two packages' traces load side by side.

Converts collector span records into the Trace Event Format that
``chrome://tracing`` and https://ui.perfetto.dev both load: one
complete event (``"ph": "X"``) per span plus process-name metadata
events, timestamps in wall-clock microseconds (each process's
monotonic clock is re-anchored via :data:`tracing.EPOCH_NS`, so spans
collected from different processes line up on one axis).

``engine.step`` spans that carry the roofline envelope
(``predicted_dispatch_ms`` / ``measured_dispatch_ms`` attrs, see
``obs/timeline.py``) additionally emit a counter event (``"ph": "C"``)
per step, so the predicted-vs-measured dispatch latency renders as a
stacked counter track above the step spans.
"""

from __future__ import annotations

from dynamo_tpu_torch.obs import tracing

__all__ = ["chrome_trace", "trace_for_request"]


def _pid_for(proc: str, pids: dict) -> int:
    if proc not in pids:
        pids[proc] = len(pids) + 1
    return pids[proc]


def chrome_trace(spans: list[dict]) -> dict:
    """Build a Chrome trace-event document from collector records
    (``tracing.Collector`` dicts).  Spans from any mix of traces and
    processes are accepted; each distinct ``proc`` gets its own track."""
    pids: dict = {}
    events = []
    for s in spans:
        pid = _pid_for(s.get("proc") or "proc", pids)
        args = {
            "trace_id": s["trace"],
            "span_id": s["span"],
        }
        if s.get("parent"):
            args["parent_id"] = s["parent"]
        args.update(s.get("attrs") or {})
        events.append({
            "ph": "X",
            "name": s["name"],
            "cat": "dtspan",
            "ts": (tracing.EPOCH_NS + s["ts"]) / 1e3,   # wall-clock us
            "dur": s["dur"] / 1e3,                       # us
            "pid": pid,
            "tid": 1,
            "args": args,
        })
        attrs = s.get("attrs") or {}
        if "measured_dispatch_ms" in attrs:
            # counter track: predicted-vs-measured dispatch ms
            counter = {"measured": attrs["measured_dispatch_ms"]}
            if "predicted_dispatch_ms" in attrs:
                counter["predicted"] = attrs["predicted_dispatch_ms"]
            events.append({
                "ph": "C",
                "name": "dispatch_ms (dtperf predicted vs measured)",
                "cat": "dtperf",
                "ts": (tracing.EPOCH_NS + s["ts"]) / 1e3,
                "pid": pid,
                "tid": 1,
                "args": counter,
            })
    for proc, pid in pids.items():
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 1,
            "args": {"name": proc},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def trace_for_request(request_id: str) -> dict | None:
    """Chrome trace for one request id (backs
    ``/debug/traces/{request_id}`` and the ``trace`` command);
    None when the request was never traced or has aged out of the
    ring."""
    trace_id = tracing.collector.trace_for_request(request_id)
    if trace_id is None:
        return None
    spans = tracing.collector.spans_for_trace(trace_id)
    if not spans:
        return None
    return chrome_trace(spans)
