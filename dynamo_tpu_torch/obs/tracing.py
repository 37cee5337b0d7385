"""Span core for the dtspan tracing plane.

A copy of the JAX package's ``obs/tracing.py``: the same environment
variables (``DYNAMO_TRACE``, ``DYN_TRACE_PROC``) and span names.

Design constraints:

- **Near-zero cost when disabled.**  Every entrypoint first checks one
  module-level bool; the disabled path returns a preallocated no-op
  span singleton — no object allocation, no clock read, no contextvar
  write on the token path.
- **Contextvar propagation.**  The current span context rides a
  ``contextvars.ContextVar`` so it follows ``asyncio`` task switches
  for free.  Threads that are *not* spawned per-request (the engine
  thread) carry context explicitly: ``EngineRequest.trace`` holds the
  ``(trace_id, span_id)`` pair and engine-side spans pass it as
  ``parent=``.
- **Wire propagation.**  :func:`inject` stamps the current context
  into a JSON-framed message header under the
  ``protocol.TRACE_FIELD`` key; :func:`extract` reads it back on the
  receiving side.  One trace id thus stitches frontend -> router ->
  prefill -> KV transfer -> decode across processes.
- **Bounded collector.**  Finished spans land in a per-process ring
  buffer (``deque(maxlen=...)``); a bounded ``request_id -> trace_id``
  map backs ``/debug/traces/{request_id}``.  Memory is O(ring size)
  regardless of traffic.

Timestamps are monotonic (``time.monotonic_ns``) for correct
durations; the module records one wall-clock anchor at import so the
exporter can place spans from different processes on a shared
wall-clock axis (see :data:`EPOCH_NS`).
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Optional

__all__ = [
    "Span",
    "attach",
    "collector",
    "current",
    "detach",
    "enable",
    "enabled",
    "extract",
    "inject",
    "new_trace_id",
    "set_process",
    "start_span",
]

# wall-clock anchor: wall_ns = EPOCH_NS + monotonic_ns.  Each process
# computes its own at import; all are anchored to the same wall clock,
# so cross-process spans line up to NTP precision — plenty for
# millisecond-scale serving phases.
EPOCH_NS = time.time_ns() - time.monotonic_ns()

_enabled = bool(os.environ.get("DYNAMO_TRACE"))

# (trace_id, span_id) of the active span, or None
_current: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "dtspan_current", default=None
)

_proc = os.environ.get("DYN_TRACE_PROC") or f"proc-{os.getpid()}"


def enable(on: bool = True) -> None:
    """Turn the tracing plane on/off process-wide (also settable via the
    ``DYNAMO_TRACE=1`` environment variable at import)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def set_process(name: str) -> None:
    """Name this process's track in exported traces (e.g. ``frontend``,
    ``prefill-0``).  Defaults to ``DYN_TRACE_PROC`` or ``proc-{pid}``."""
    global _proc
    _proc = name


def process_name() -> str:
    return _proc


def new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class Collector:
    """Bounded ring buffer of finished span records.

    Records are plain dicts (immutable once appended); ``deque.append``
    is atomic under the GIL, so the hot path takes no lock.  The
    ``request_id -> trace_id`` map (for ``/debug/traces/{rid}``) is
    bounded by LRU-ish FIFO eviction under a small lock — it is only
    touched once per request, never per token.
    """

    def __init__(self, maxlen: int = 4096, max_requests: int = 2048) -> None:
        self.spans: deque = deque(maxlen=maxlen)
        self._rid_to_trace: OrderedDict[str, str] = OrderedDict()
        self._max_requests = max_requests
        self._lock = threading.Lock()

    def add(self, record: dict) -> None:
        self.spans.append(record)

    def bind_request(self, request_id: str, trace_id: str) -> None:
        with self._lock:
            self._rid_to_trace[request_id] = trace_id
            while len(self._rid_to_trace) > self._max_requests:
                self._rid_to_trace.popitem(last=False)

    def trace_for_request(self, request_id: str) -> Optional[str]:
        with self._lock:
            return self._rid_to_trace.get(request_id)

    def spans_for_trace(self, trace_id: str) -> list[dict]:
        return [s for s in list(self.spans) if s["trace"] == trace_id]

    def reset(self) -> None:
        """Test isolation hook."""
        self.spans.clear()
        with self._lock:
            self._rid_to_trace.clear()


collector = Collector()


class Span:
    """One timed operation.  Create via :func:`start_span`; finish with
    :meth:`end` or use as a context manager.  ``set()`` attaches
    key/value attributes (kept small — they ride the ring buffer)."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "start_ns", "attrs", "_token", "_ended",
    )

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 attrs: Optional[dict] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.start_ns = time.monotonic_ns()
        self._token = _current.set((trace_id, self.span_id))
        self._ended = False

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def context(self) -> tuple:
        """(trace_id, span_id) — pass as ``parent=`` across threads."""
        return (self.trace_id, self.span_id)

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        end_ns = time.monotonic_ns()
        try:
            _current.reset(self._token)
        except ValueError:
            # ended in a different context than it started (e.g. a span
            # handed across tasks) — clearing beats leaking
            _current.set(None)
        collector.add({
            "name": self.name,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "ts": self.start_ns,
            "dur": end_ns - self.start_ns,
            "proc": _proc,
            "attrs": self.attrs,
        })

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NopSpan:
    """Disabled-path span: every method is a no-op returning self, so
    call sites never branch.  One process-wide instance — zero
    allocation when tracing is off."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    attrs: dict = {}

    def set(self, **attrs) -> "_NopSpan":
        return self

    def context(self) -> None:
        return None

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOP_SPAN = _NopSpan()


def start_span(name: str, parent: Optional[tuple] = None,
               attrs: Optional[dict] = None):
    """Start a span.  ``parent`` overrides the contextvar (explicit
    cross-thread handoff); otherwise the current context is the parent;
    otherwise a fresh trace id is minted (root span).  Returns the
    no-op singleton when tracing is disabled."""
    if not _enabled:
        return NOP_SPAN
    ctx = parent if parent is not None else _current.get()
    if ctx is not None:
        trace_id, parent_id = ctx
    else:
        trace_id, parent_id = new_trace_id(), None
    return Span(name, trace_id, parent_id, attrs)


def current() -> Optional[tuple]:
    """(trace_id, span_id) of the active context, or None."""
    if not _enabled:
        return None
    return _current.get()


def attach(ctx: Optional[tuple]):
    """Make ``ctx`` the current context (e.g. after :func:`extract` on
    a server); returns a token for :func:`detach`.  None ctx is fine —
    the token still restores the previous state."""
    return _current.set(tuple(ctx) if ctx else None)


def detach(token) -> None:
    try:
        _current.reset(token)
    except ValueError:
        _current.set(None)


# --------------------------------------------------------------- wire helpers
# The field name lives in transports/protocol.py (single source of
# truth for wire literals — the dtwire plane audits it there); import
# lazily to keep obs dependency-free for non-wire users.

def _trace_field() -> str:
    from dynamo_tpu_torch.runtime.transports.protocol import TRACE_FIELD
    return TRACE_FIELD


def inject(header: dict) -> dict:
    """Stamp the current trace context into a wire message header (a
    JSON-framed dict).  No-op (and no allocation) when tracing is off
    or no context is active.  Returns ``header`` for chaining."""
    if not _enabled:
        return header
    ctx = _current.get()
    if ctx is not None:
        header[_trace_field()] = [ctx[0], ctx[1]]
    return header


def extract(header: dict) -> Optional[tuple]:
    """Read a trace context out of a received wire header; None when
    absent or malformed (never raises — tracing must not take down the
    data path)."""
    if not _enabled:
        return None
    raw = header.get(_trace_field())
    if (
        isinstance(raw, (list, tuple)) and len(raw) == 2
        and all(isinstance(x, str) for x in raw)
    ):
        return (raw[0], raw[1])
    return None
