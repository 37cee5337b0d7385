"""Engine step timeline: per-phase wall-time attribution for
``EngineCore.step``.

A copy of the JAX package's ``obs/timeline.py`` (the same phases, kinds,
formula and readers), with two differences:

* each ``EngineCore`` owns its own :class:`StepTimeline` (and its own
  ``PerfModel``), because the port runs several engine threads in one
  process (colocated disaggregation, a router over several engines) and
  the in-step state of one timeline cannot take interleaved
  ``begin``/``mark``/``end`` calls.  The module-level ``step_timeline``
  stays for code written against the JAX package's global;
* in eager PyTorch "dispatch" is the host enqueuing every kernel of the
  forward (thousands of launches a decode step), not the asynchronous
  enqueue of one compiled program, so the dispatch phase is host time.
  The formula and the phase names are kept for parity; the host gap is
  still wall - dispatch - overlap - readback (- collective);
* on a mesh of more than one rank the engine marks a ``collective`` phase
  the JAX package has no counterpart of (there a collective is part of the
  one compiled program): the broadcast of each dispatch to the shard
  followers, and the waits inside the forward (all-reduce, all-gather,
  the fed-back tokens), moved out of ``dispatch`` by :meth:`StepTimeline.
  move` so that the host's enqueue does not absorb them.  Like readback it
  is a wait, not a host bubble, and the host gap excludes it.

The model is mark-based: :meth:`StepTimeline.begin` opens a step,
``mark(phase)`` attributes *all elapsed time since the previous mark*
to ``phase``, and :meth:`end` attributes the residue to ``host_post``
— so the phase sum equals the step wall time **by construction** (the
>= 95 % acceptance bound holds with slack; the only loss is float
rounding).

Phases (what the marks mean, in step order):

    kv_spill_restore  host<->device KV block traffic (_drain_offload)
    host_ops          cross-thread op/abort queues
    admission         _admit: block allocation, grammar budget, slots
    host_build        numpy dispatch-operand builds (tokens, block
                      tables, penalty buffers, grammar rows)
    upload            the dispatch's host->device operand copies
    dispatch          the model call: the host enqueuing its kernels
                      (on CPU tensors this includes compute)
    collective        (a mesh only, not one of PHASES) rank 0's waits in
                      collectives: the dispatch broadcast and the
                      forward's all-reduces and all-gathers
    overlap           host work performed *while the device computes*
                      (lookahead dispatch: next-turn speculative build
                      + waiting-queue drain between dispatch and
                      readback) — concurrent with device time, so it
                      is excluded from the host gap
    readback          the one result read — blocks until device compute
                      lands, so device time not overlapped with host
                      work shows up here
    host_post         sampled-token append, stop conditions, emit

The headline derived number is **host_gap_ms_per_turn** — wall time
per dispatching step spent *outside* dispatch+overlap+readback, i.e.
the host bubble a double-buffered dispatch must close.
Overlapped host work is not a bubble: the device is busy underneath
it, so the phase-sum==wall invariant holds while the gap shrinks.  The
aggregates are always on (a handful of ``perf_counter`` calls per
step, no allocation); full per-step records are kept only in a small
ring buffer, and per-step *spans* are emitted only when the tracing
plane is enabled.

The dispatch mark additionally takes the **dispatch kind** (``step``,
``decode_multi``, ``prefill_ragged``, ``unified``, ``unified_burst``,
``spec_verify``; the JAX package's ``sp_prefill`` is not ported) so measured dispatch seconds split per dispatch
entry point — the denominator of the predicted-vs-measured model-error
gauge (``obs/perfmodel.py``).  When tracing is enabled,
``end`` also emits one ``engine.step`` span per busy step carrying the
phase breakdown and the roofline-predicted dispatch envelope, which
the Chrome export renders as a predicted-vs-measured counter track.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

__all__ = ["StepTimeline", "step_timeline", "PHASES", "COLLECTIVE"]

PHASES = (
    "kv_spill_restore",
    "host_ops",
    "admission",
    "host_build",
    "upload",
    "dispatch",
    "overlap",
    "readback",
    "host_post",
)

# the mesh's phase: marked only by an engine on a mesh of more than one rank,
# so it is not among the JAX package's PHASES (the /metrics family renders
# those); the snapshot adds it where it was marked
COLLECTIVE = "collective"

_DISPATCH_PHASES = ("upload", "dispatch", "readback")


class StepTimeline:
    """One engine thread writes, metrics readers read (torn reads of
    monotonically-increasing floats are acceptable for monitoring).
    ``perf_model`` prices the ``engine.step`` spans' dispatch envelope
    (None: the module-level ``perf_model``)."""

    def __init__(self, keep_steps: int = 256,
                 clock: Callable[[], float] = time.perf_counter,
                 perf_model=None) -> None:
        self._lock = threading.Lock()
        self.perf_model = perf_model
        # injectable so simulated engines (load plane) can stamp steps
        # at virtual time; the default stays the high-resolution counter
        self._clock = clock
        self.recent: deque = deque(maxlen=keep_steps)
        self.reset()

    def reset(self) -> None:
        """Test isolation hook."""
        self.steps_total = 0          # begin/end pairs seen
        self.busy_steps_total = 0     # steps that ran >= 1 device dispatch
        self.wall_s_total = 0.0       # busy-step wall time
        self.phase_s_total = {p: 0.0 for p in PHASES}
        self.host_gap_s_total = 0.0   # busy wall - dispatch-overlap-readback
        self.ewma_wall_s = 0.0
        self.ewma_host_gap_s = 0.0
        # measured dispatch time split by dispatch kind — the
        # denominator of the model-error gauge
        self.dispatch_kind_s: dict[str, float] = {}
        self.dispatch_kind_n: dict[str, int] = {}
        self._alpha = 0.05
        self._t0: Optional[float] = None
        self._t0_ns = 0
        self._last = 0.0
        self._phases: dict = {}
        self._step_kinds: dict = {}

    # ------------------------------------------------------------ hot path
    def begin(self) -> None:
        now = self._clock()
        self._t0 = now
        self._last = now
        self._phases = {}
        self._step_kinds = {}
        self._t0_ns = time.monotonic_ns()

    def mark(self, phase: str, kind: Optional[str] = None) -> None:
        if self._t0 is None:
            return  # dispatch helper invoked outside step() (tests)
        now = self._clock()
        delta = now - self._last
        self._phases[phase] = self._phases.get(phase, 0.0) + delta
        if kind is not None:
            self.dispatch_kind_s[kind] = \
                self.dispatch_kind_s.get(kind, 0.0) + delta
            self.dispatch_kind_n[kind] = \
                self.dispatch_kind_n.get(kind, 0) + 1
            self._step_kinds[kind] = \
                self._step_kinds.get(kind, 0.0) + delta
        self._last = now

    def move(self, seconds: float, src: str, dst: str) -> None:
        """Re-attribute ``seconds`` of this step already marked as ``src``
        to ``dst`` (at most what ``src`` holds)."""
        if self._t0 is None or seconds <= 0:
            return
        seconds = min(seconds, self._phases.get(src, 0.0))
        self._phases[src] = self._phases.get(src, 0.0) - seconds
        self._phases[dst] = self._phases.get(dst, 0.0) + seconds

    def end(self, trace: Optional[tuple] = None) -> None:
        if self._t0 is None:
            return
        now = self._clock()
        phases = self._phases
        phases["host_post"] = phases.get("host_post", 0.0) + (now - self._last)
        wall = now - self._t0
        t0_ns = self._t0_ns
        self._t0 = None
        busy = any(phases.get(p) for p in _DISPATCH_PHASES)
        self.steps_total += 1
        if not busy:
            return  # idle polls would drown the per-turn numbers
        gap = (wall - phases.get("dispatch", 0.0)
               - phases.get("overlap", 0.0)
               - phases.get("readback", 0.0)
               - phases.get(COLLECTIVE, 0.0))
        self.busy_steps_total += 1
        self.wall_s_total += wall
        self.host_gap_s_total += gap
        for p, v in phases.items():
            self.phase_s_total[p] = self.phase_s_total.get(p, 0.0) + v
        a = self._alpha
        self.ewma_wall_s = wall if self.busy_steps_total == 1 else (
            (1 - a) * self.ewma_wall_s + a * wall)
        self.ewma_host_gap_s = gap if self.busy_steps_total == 1 else (
            (1 - a) * self.ewma_host_gap_s + a * gap)
        self.recent.append({"wall_s": wall, "phases": dict(phases)})
        self._emit_step_span(trace, t0_ns, wall, phases)

    # ----------------------------------------------------------- trace emit
    def _emit_step_span(self, trace: Optional[tuple], t0_ns: int,
                        wall: float, phases: dict) -> None:
        """One ``engine.step`` span per busy step when the tracing
        plane is on: phase breakdown, per-kind dispatch ms, and the
        roofline-predicted dispatch envelope (the Chrome export turns
        the predicted/measured pair into a counter track)."""
        from dynamo_tpu_torch.obs import tracing

        if not tracing.enabled():
            return
        kinds = dict(self._step_kinds)
        attrs: dict = {
            "phases_ms": {
                p: round(v * 1e3, 3) for p, v in sorted(phases.items())
            },
            "dispatch_kinds": sorted(kinds),
            "measured_dispatch_ms": round(
                sum(kinds.values()) * 1e3, 3),
        }
        # predicted envelope: the roofline of each offered kind
        try:
            pm = self.perf_model
            if pm is None:
                from dynamo_tpu_torch.obs.perfmodel import perf_model as pm

            preds = [pm.predicted_ms(k) for k in kinds]
            if preds and all(p is not None for p in preds):
                attrs["predicted_dispatch_ms"] = round(sum(preds), 3)
        except Exception:
            pass  # monitoring must never break the step loop
        trace_id, parent = (trace if trace else
                            (tracing.new_trace_id(), None))
        tracing.collector.add({
            "name": "engine.step",
            "trace": trace_id,
            "span": tracing._new_span_id(),
            "parent": parent,
            "ts": t0_ns,
            "dur": int(wall * 1e9),
            "proc": tracing.process_name(),
            "attrs": attrs,
        })

    # ------------------------------------------------------------- readers
    @property
    def host_gap_ms_per_turn(self) -> float:
        """Mean host bubble per dispatching step."""
        if not self.busy_steps_total:
            return 0.0
        return self.host_gap_s_total / self.busy_steps_total * 1e3

    def snapshot(self) -> dict:
        """Dict for /metrics rendering and serve_bench banking."""
        return {
            "steps_total": self.steps_total,
            "busy_steps_total": self.busy_steps_total,
            "wall_seconds_total": self.wall_s_total,
            "host_gap_ms_per_turn": self.host_gap_ms_per_turn,
            "ewma_wall_ms": self.ewma_wall_s * 1e3,
            "ewma_host_gap_ms": self.ewma_host_gap_s * 1e3,
            "phases": {p: self.phase_s_total.get(p, 0.0) for p in PHASES
                       + ((COLLECTIVE,) if COLLECTIVE in self.phase_s_total else ())},
            "dispatch_kinds": {
                k: {
                    "seconds": self.dispatch_kind_s[k],
                    "count": self.dispatch_kind_n.get(k, 0),
                }
                for k in sorted(self.dispatch_kind_s)
            },
        }


step_timeline = StepTimeline()
