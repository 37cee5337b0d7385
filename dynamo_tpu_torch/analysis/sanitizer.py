"""dtsan over the port: a runtime sanitizer for the port's event loops.

The counterpart of the JAX package's ``analysis/sanitizer.py``, with the
same four instruments, modes and ``DYNAMO_SANITIZE`` /
``DYNAMO_SANITIZE_BLOCK_S`` environment variables.  The static planes
prove properties the AST can see; this module witnesses the ones only
the clock can: a task still pending when the run that spawned it has
returned, a callback that held the event loop for 250 ms, a TCP
transport nobody tore down, a frame written after the peer severed the
stream.  Four independent instruments, each installable on its own:

  TaskTracker              every task created on any loop is recorded
                           with its creation traceback; pending tasks at
                           a test boundary are leaks
  BlockingCallbackMonitor  wall-clocks every event-loop callback; over
                           threshold -> report, with the blocking stack
                           sampled live by a watchdog thread
  TransportTracker         every selector-loop socket transport is
                           recorded with its creation traceback; alive
                           and not closing at a test boundary -> leak
  FrameStateMachine        per-writer protocol checker for the port's
                           runtime/transports/framing.py: no
                           data-after-sever, no double-close

The pytest side (``pytest_sanitizer.py``, loaded with ``pytest -p
dynamo_tpu_torch.analysis.pytest_sanitizer``) turns these into per-test
failures: task-leak checking by default, ``DYNAMO_SANITIZE=1`` for the
full set, ``DYNAMO_SANITIZE=0`` for none.  ``chip_smoke.py`` installs the
full set around the streamed bf16 disaggregated run on the card.

Everything installs by patching narrow, stable seams (the event-loop
policy's ``new_event_loop``, ``Handle._run``, the selector loop's
``_make_socket_transport``, and the port's framing functions across
every port module that imported them) and every patch is reversible.
The JAX package's sanitizer patches the same asyncio seams, and both can
be installed in one process (a port test under the JAX suite's default
leak check): each install wraps whatever is there, so installs and
uninstalls must nest, last in first out, and ``uninstall()`` refuses to
restore a seam someone patched after it rather than drop their patch.
The framing guard patches only the port's modules (the package itself
or a name under it), never the JAX package's.
"""

from __future__ import annotations

import asyncio
import gc
import os
import sys
import threading
import time
import traceback
import weakref
from asyncio import events as _aio_events
from asyncio import selector_events as _aio_selector
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

__all__ = [
    "TaskTracker",
    "BlockingCallbackMonitor",
    "TransportTracker",
    "FrameStateMachine",
    "FrameProtocolError",
    "FramingGuard",
    "Sanitizer",
    "MODE_OFF",
    "MODE_LEAKS",
    "MODE_FULL",
    "mode_from_env",
]

# the port's package: the modules FramingGuard may patch
PORT_PACKAGE = __name__.split(".")[0]

MODE_OFF = "off"
MODE_LEAKS = "leaks"   # task-leak checking only (the tier-1 default)
MODE_FULL = "full"     # + blocking callbacks, transports, framing guard


def mode_from_env(default: str = MODE_LEAKS) -> str:
    """DYNAMO_SANITIZE: unset -> ``default``; 0/off -> off; 1/full -> full."""
    raw = os.environ.get("DYNAMO_SANITIZE", "").strip().lower()
    if raw in ("0", "off", "no", "false"):
        return MODE_OFF
    if raw in ("1", "full", "on", "yes", "true"):
        return MODE_FULL
    if raw in ("leaks", "leak"):
        return MODE_LEAKS
    return default


# Frames from these files are noise in a creation traceback: the
# machinery between user code and the recorded event.
_INTERNAL_FILES = (os.sep + "asyncio" + os.sep, os.path.abspath(__file__))


def _creation_stack(limit: int = 16) -> list[traceback.FrameSummary]:
    stack = traceback.extract_stack()
    user = [f for f in stack
            if not any(m in (f.filename or "") for m in _INTERNAL_FILES)]
    return (user or stack)[-limit:]


def _format_stack(stack: Iterable[traceback.FrameSummary]) -> str:
    return "".join(traceback.format_list(list(stack))).rstrip()


def _restore(owner, attr: str, mine, orig, what: str) -> None:
    """Put ``orig`` back on ``owner.attr`` if ``mine`` is still what is
    there; if another instrument wrapped the seam after this one, raise
    instead of dropping its patch (installs must nest)."""
    if getattr(owner, attr) is not mine:
        raise RuntimeError(
            f"dtsan: {what} uninstalled out of order: {attr} was patched again "
            "after this install; uninstall the later install first")
    setattr(owner, attr, orig)


# ------------------------------------------------------------ task tracker ----


class _TrackedTask(asyncio.tasks.Task):
    """Task subclass that remembers whether anyone ever asked it to
    cancel.  A pending-at-teardown task whose owner DID call cancel()
    (but returned before the loop could deliver it) is drained
    best-effort, not leaked — only never-cancelled pending tasks fail
    the default leak check."""

    def cancel(self, msg=None):
        self.dt_cancel_requested = True
        return super().cancel(msg) if msg is not None else super().cancel()


@dataclass
class TaskRecord:
    name: str
    coro: str
    epoch: int
    stack: list = field(repr=False, default_factory=list)

    def render(self) -> str:
        return (
            f"task {self.name!r} ({self.coro}) created at:\n"
            + _format_stack(self.stack)
        )


class TaskTracker:
    """Records the creation traceback of every task on every loop.

    Install patches the event-loop policy's ``new_event_loop`` so every
    subsequently created loop (asyncio.new_event_loop, asyncio.run, the
    threads the mesh tests spawn) gets a recording task factory.
    An *epoch* is a test window: ``begin_epoch()`` at test start, then
    ``pending_in_epoch()`` at teardown — any task created during the
    window and still not done is a leak (the tests here drive loops with
    bare ``run_until_complete``, so a pending task at that point is
    frozen forever, and at interpreter exit it is destroyed pending with
    its exception lost).
    """

    def __init__(self) -> None:
        self._records: dict[int, tuple[weakref.ref, TaskRecord]] = {}
        self._epoch = 0
        self._lock = threading.Lock()
        self._orig_new_event_loop = None
        self._patch = None
        self.installed = False

    # -------------------------------------------------------------- install
    def install(self) -> None:
        if self.installed:
            return
        tracker = self

        self._orig_new_event_loop = (
            _aio_events.BaseDefaultEventLoopPolicy.new_event_loop
        )
        orig = self._orig_new_event_loop

        def new_event_loop(policy):
            loop = orig(policy)
            tracker.instrument_loop(loop)
            return loop

        _aio_events.BaseDefaultEventLoopPolicy.new_event_loop = (
            new_event_loop
        )
        self._patch = new_event_loop
        self.installed = True

    def uninstall(self) -> None:
        if not self.installed:
            return
        _restore(_aio_events.BaseDefaultEventLoopPolicy, "new_event_loop",
                 self._patch, self._orig_new_event_loop, "TaskTracker")
        self.installed = False

    def instrument_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        """Attach the recording task factory (chains any existing one)."""
        tracker = self
        prev = loop.get_task_factory()

        def factory(lp, coro, **kw):
            if prev is not None:
                task = prev(lp, coro, **kw)
            else:
                task = _TrackedTask(coro, loop=lp, **kw)
            tracker.record(task, coro)
            return task

        loop.set_task_factory(factory)

    # ------------------------------------------------------------ recording
    def record(self, task: "asyncio.Task", coro: Any = None) -> None:
        rec = TaskRecord(
            name=task.get_name(),
            coro=getattr(coro, "__qualname__", None) or repr(coro),
            epoch=self._epoch,
            stack=_creation_stack(),
        )
        with self._lock:
            self._records[id(task)] = (weakref.ref(task), rec)

    # --------------------------------------------------------------- epochs
    def begin_epoch(self) -> int:
        """Open a new test window; prune records of collected tasks."""
        with self._lock:
            self._epoch += 1
            dead = [k for k, (ref, _) in self._records.items()
                    if ref() is None]
            for k in dead:
                del self._records[k]
            return self._epoch

    def tracked_in_epoch(self) -> int:
        """Tasks recorded in the current epoch, done or not."""
        with self._lock:
            return sum(1 for _, rec in self._records.values()
                       if rec.epoch == self._epoch)

    def pending_in_epoch(
        self,
        epoch: Optional[int] = None,
        include_cancel_requested: bool = False,
    ) -> list[tuple["asyncio.Task", TaskRecord]]:
        """Live, not-done tasks created in ``epoch`` (default: current).
        Tasks whose owner already requested cancellation are excluded
        unless ``include_cancel_requested`` — see _TrackedTask."""
        epoch = self._epoch if epoch is None else epoch
        out = []
        with self._lock:
            items = list(self._records.values())
        for ref, rec in items:
            task = ref()
            if task is None or rec.epoch != epoch:
                continue
            if not include_cancel_requested and getattr(
                task, "dt_cancel_requested", False
            ):
                continue
            try:
                if not task.done():
                    out.append((task, rec))
            except Exception:  # loop half-torn-down: treat as leaked
                out.append((task, rec))
        return out


# ------------------------------------------- blocking-callback monitor ----


@dataclass
class BlockingCallback:
    where: str
    duration_s: float
    epoch: int
    blocked_stack: str = ""     # sampled live by the watchdog, if caught
    gc_s: float = 0.0           # the interpreter's collections inside it

    def render(self) -> str:
        gc_note = (f" (of which {self.gc_s * 1e3:.0f}ms in the garbage "
                   "collector)" if self.gc_s else "")
        msg = (
            f"event-loop callback blocked for {self.duration_s * 1e3:.0f}ms"
            f"{gc_note}: {self.where}"
        )
        if self.blocked_stack:
            msg += f"\nstack sampled while blocking:\n{self.blocked_stack}"
        return msg


class BlockingCallbackMonitor:
    """Wall-clocks every event-loop callback via ``Handle._run``.

    A callback that exceeds ``threshold_s`` produces a report.  A single
    daemon watchdog thread samples ``sys._current_frames()`` for any
    thread whose current callback has already run half the threshold, and
    again at each of its ticks (an eighth of the threshold apart) while it
    runs on, so the report carries the latest stack *while it was
    blocking* — the half of DT003 that static analysis cannot see (a C
    extension, a slow device dispatch, a sync socket hidden behind three
    calls).  Sampling from half the threshold on gives every report a
    stack: one sample only past the threshold misses a callback that ends
    before the next tick.  The time the interpreter's garbage collector
    ran inside the callback (``gc.callbacks``) is reported beside it, and
    a task's wake-up names the task's coroutine.
    """

    MAX_REPORTS = 100

    def __init__(self, threshold_s: float = 0.1):
        self.threshold_s = threshold_s
        self.reports: list[BlockingCallback] = []
        # thread id -> [t0, stack | None, gc seconds, gc start | None]
        self._active: dict[int, list] = {}
        self._epoch = 0
        self._orig_run = None
        self._patch = None
        self._stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        self.installed = False

    def install(self) -> None:
        if self.installed:
            return
        mon = self
        self._orig_run = _aio_events.Handle._run
        orig = self._orig_run

        def _run(handle):
            tid = threading.get_ident()
            slot = [time.perf_counter(), None, 0.0, None]
            mon._active[tid] = slot
            try:
                return orig(handle)
            finally:
                dt = time.perf_counter() - slot[0]
                mon._active.pop(tid, None)
                if dt >= mon.threshold_s and len(mon.reports) < mon.MAX_REPORTS:
                    mon.reports.append(BlockingCallback(
                        where=mon._describe(handle),
                        duration_s=dt,
                        epoch=mon._epoch,
                        blocked_stack=slot[1] or "",
                        gc_s=slot[2],
                    ))

        _aio_events.Handle._run = _run
        self._patch = _run
        gc.callbacks.append(self._on_gc)
        self._stop.clear()
        self._watchdog = threading.Thread(
            target=self._watch, name="dtsan-watchdog", daemon=True
        )
        self._watchdog.start()
        self.installed = True

    def uninstall(self) -> None:
        if not self.installed:
            return
        _restore(_aio_events.Handle, "_run", self._patch, self._orig_run,
                 "BlockingCallbackMonitor")
        gc.callbacks.remove(self._on_gc)
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2)
        self.installed = False

    def _on_gc(self, phase: str, info: dict) -> None:
        """``gc.callbacks`` hook: add a collection's time to the callback
        running on the collecting thread, if any."""
        slot = self._active.get(threading.get_ident())
        if slot is None:
            return
        if phase == "start":
            slot[3] = time.perf_counter()
        elif slot[3] is not None:
            slot[2] += time.perf_counter() - slot[3]
            slot[3] = None

    @staticmethod
    def _describe(handle) -> str:
        cb = getattr(handle, "_callback", None)
        name = getattr(cb, "__qualname__", None) or repr(cb)
        task = getattr(cb, "__self__", None)
        if isinstance(task, asyncio.Task):
            coro = task.get_coro()
            name += (f" of task {task.get_name()!r} "
                     f"({getattr(coro, '__qualname__', None) or coro!r})")
        src = getattr(handle, "_source_traceback", None)
        if src:
            last = src[-1]
            return f"{name} (scheduled at {last.filename}:{last.lineno})"
        return name

    def _watch(self) -> None:
        interval = max(self.threshold_s / 8.0, 0.005)
        while not self._stop.wait(interval):
            now = time.perf_counter()
            for tid, slot in list(self._active.items()):
                if now - slot[0] >= self.threshold_s / 2:
                    frame = sys._current_frames().get(tid)
                    if frame is not None:
                        slot[1] = "".join(
                            traceback.format_stack(frame, limit=12)
                        ).rstrip()

    # --------------------------------------------------------------- epochs
    def begin_epoch(self) -> None:
        self._epoch += 1

    def reports_in_epoch(self) -> list[BlockingCallback]:
        return [r for r in self.reports if r.epoch == self._epoch]


# --------------------------------------------------------- transport leaks ----


@dataclass
class TransportRecord:
    epoch: int
    stack: list = field(repr=False, default_factory=list)

    def render(self, transport) -> str:
        return (
            f"unclosed TCP transport {transport!r} created at:\n"
            + _format_stack(self.stack)
        )


class TransportTracker:
    """Records every selector-loop socket transport (both directions:
    ``open_connection`` dials and ``start_server`` accepts go through
    ``_make_socket_transport``).  A transport still alive and not
    ``is_closing()`` at a test boundary means some path skipped
    ``close_writer`` — the dynamic twin of DT007."""

    def __init__(self) -> None:
        self._records: dict[int, tuple[weakref.ref, TransportRecord]] = {}
        self._epoch = 0
        self._orig_make = None
        self._patch = None
        self.installed = False

    def install(self) -> None:
        if self.installed:
            return
        tracker = self
        self._orig_make = _aio_selector.BaseSelectorEventLoop._make_socket_transport
        orig = self._orig_make

        def _make_socket_transport(loop, *a, **kw):
            transport = orig(loop, *a, **kw)
            tracker._records[id(transport)] = (
                weakref.ref(transport),
                TransportRecord(epoch=tracker._epoch,
                                stack=_creation_stack()),
            )
            return transport

        _aio_selector.BaseSelectorEventLoop._make_socket_transport = (
            _make_socket_transport
        )
        self._patch = _make_socket_transport
        self.installed = True

    def uninstall(self) -> None:
        if not self.installed:
            return
        _restore(_aio_selector.BaseSelectorEventLoop, "_make_socket_transport",
                 self._patch, self._orig_make, "TransportTracker")
        self.installed = False

    def begin_epoch(self) -> None:
        self._epoch += 1
        dead = [k for k, (ref, _) in self._records.items() if ref() is None]
        for k in dead:
            del self._records[k]

    def tracked_in_epoch(self) -> int:
        """Transports recorded in the current epoch, closed or not."""
        return sum(1 for _, rec in list(self._records.values())
                   if rec.epoch == self._epoch)

    def unclosed_in_epoch(self) -> list[tuple[Any, TransportRecord]]:
        out = []
        for ref, rec in list(self._records.values()):
            t = ref()
            if t is None or rec.epoch != self._epoch:
                continue
            try:
                if not t.is_closing():
                    out.append((t, rec))
            except Exception:
                pass
        return out


# ------------------------------------------------------ frame state machine ----


class FrameProtocolError(RuntimeError):
    """An illegal transition on a framed stream (strict mode)."""


class FrameStateMachine:
    """Protocol checker for one framed stream (framing.py wire contract).

    States::

        OPEN ──sever──▶ SEVERED ──close──▶ CLOSED
          │                                  ▲
          └────────────close─────────────────┘

    Legal writes happen only in OPEN.  ``sever`` is the peer going away
    (EOF on read, reset) or a local ``close()`` scheduling teardown —
    after it, writing is the "data-after-sever" bug (bytes to a dead
    peer, or interleaved into a teardown).  ``close`` is terminal;
    closing twice is the "double-close" bug (two owners both think they
    hold the writer).  In strict mode violations raise
    FrameProtocolError; otherwise they accumulate in ``violations``.
    """

    OPEN, SEVERED, CLOSED = "open", "severed", "closed"

    def __init__(self, name: str = "stream", strict: bool = True):
        self.name = name
        self.strict = strict
        self.state = self.OPEN
        self.violations: list[str] = []

    def _violate(self, msg: str) -> None:
        full = f"frame protocol violation on {self.name}: {msg}"
        self.violations.append(full)
        if self.strict:
            raise FrameProtocolError(full)

    def on_write(self) -> None:
        if self.state == self.SEVERED:
            self._violate("data-after-sever (write on a severed stream)")
        elif self.state == self.CLOSED:
            self._violate("data-after-close (write on a closed stream)")

    def on_sever(self) -> None:
        if self.state == self.OPEN:
            self.state = self.SEVERED

    def on_close(self) -> None:
        if self.state == self.CLOSED:
            self._violate("double-close")
        self.state = self.CLOSED


class FramingGuard:
    """Wraps the port's runtime/transports/framing.py in per-writer state
    machines.

    ``write_frame``/``close_writer`` are imported *by name* into every
    transport module, so patching the framing module alone would miss
    the live call sites — install rewrites the function objects in every
    already-imported port module that holds a reference to the originals,
    and uninstall puts them back.  ``frames_in_epoch`` counts the frames
    written through the guard since the epoch began.  Machines are non-strict here: violations
    accumulate per epoch and the pytest plugin turns them into failures
    (a strict raise inside a transport's close path would mask the
    test's own result).
    """

    def __init__(self) -> None:
        self._machines: "weakref.WeakKeyDictionary[Any, FrameStateMachine]" = (
            weakref.WeakKeyDictionary()
        )
        self.violations: list[tuple[int, str]] = []   # (epoch, message)
        self._epoch = 0
        # (module, attr, orig, wrapper)
        self._patched: list[tuple[Any, str, Any, Any]] = []
        self.frames_in_epoch = 0
        self.installed = False

    def machine_for(self, writer) -> FrameStateMachine:
        m = self._machines.get(writer)
        if m is None:
            m = FrameStateMachine(name=repr(writer), strict=False)
            self._machines[writer] = m
        return m

    # ------------------------------------------------------------- install
    def install(self) -> None:
        if self.installed:
            return
        from dynamo_tpu_torch.runtime.transports import framing

        guard = self
        orig_write = framing.write_frame
        orig_close = framing.close_writer

        def write_frame(writer, header, payload=b""):
            m = guard.machine_for(writer)
            if writer.is_closing():
                m.on_sever()
            m.on_write()
            guard.frames_in_epoch += 1
            guard._collect(m)
            return orig_write(writer, header, payload)

        async def close_writer(writer, timeout: float = 2.0):
            if writer is not None:
                m = guard.machine_for(writer)
                m.on_close()
                guard._collect(m)
            return await orig_close(writer, timeout)

        self._patch_everywhere(orig_write, write_frame)
        self._patch_everywhere(orig_close, close_writer)
        self.installed = True

    def uninstall(self) -> None:
        if not self.installed:
            return
        for module, attr, orig, wrapper in reversed(self._patched):
            _restore(module, attr, wrapper, orig, "FramingGuard")
        self._patched.clear()
        self.installed = False

    def _patch_everywhere(self, orig, wrapper) -> None:
        for module in list(sys.modules.values()):
            name = getattr(module, "__name__", "") if module is not None else ""
            if not (name == PORT_PACKAGE or name.startswith(PORT_PACKAGE + ".")):
                continue
            for attr, value in list(vars(module).items()):
                if value is orig:
                    setattr(module, attr, wrapper)
                    self._patched.append((module, attr, orig, wrapper))

    def _collect(self, m: FrameStateMachine) -> None:
        while m.violations:
            self.violations.append((self._epoch, m.violations.pop(0)))

    # --------------------------------------------------------------- epochs
    def begin_epoch(self) -> None:
        self._epoch += 1
        self.frames_in_epoch = 0

    def violations_in_epoch(self) -> list[str]:
        return [msg for ep, msg in self.violations if ep == self._epoch]


# ----------------------------------------------------------------- facade ----


class Sanitizer:
    """The full instrument set behind one install/uninstall pair."""

    def __init__(self, mode: str = MODE_LEAKS,
                 blocking_threshold_s: float = 0.1):
        self.mode = mode
        self.tasks = TaskTracker()
        self.blocking = BlockingCallbackMonitor(blocking_threshold_s)
        self.transports = TransportTracker()
        self.framing = FramingGuard()

    def install(self) -> "Sanitizer":
        if self.mode == MODE_OFF:
            return self
        self.tasks.install()
        if self.mode == MODE_FULL:
            self.blocking.install()
            self.transports.install()
            self.framing.install()
        return self

    def uninstall(self) -> None:
        # the reverse of install's order, so each seam unwinds last in,
        # first out
        self.framing.uninstall()
        self.transports.uninstall()
        self.blocking.uninstall()
        self.tasks.uninstall()

    def begin_epoch(self) -> None:
        self.tasks.begin_epoch()
        self.blocking.begin_epoch()
        self.transports.begin_epoch()
        self.framing.begin_epoch()

    def epoch_report(self) -> list[str]:
        """Human-readable findings for the current epoch ([] = clean)."""
        if self.mode == MODE_OFF:
            return []
        out = [
            "leaked " + rec.render()
            for _, rec in self.tasks.pending_in_epoch()
        ]
        if self.mode == MODE_FULL:
            out += [r.render() for r in self.blocking.reports_in_epoch()]
            out += [
                rec.render(t) for t, rec in self.transports.unclosed_in_epoch()
            ]
            out += self.framing.violations_in_epoch()
        return out
