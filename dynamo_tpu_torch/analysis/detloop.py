"""Deterministic asyncio machinery for the protocol plane (dtproto).

The counterpart of the JAX package's ``analysis/detloop.py``: the same
loop, schedulers and in-memory network, so a seed and a choice list mean
the same interleaving in both packages' planes when the code under them
schedules alike.  ``MemNet`` decodes its transcripts with the port's
``runtime/transports/framing.py``.

Three pieces, all schedule-owned by a seeded scheduler:

``DetLoop``
    A minimal event loop (``asyncio.AbstractEventLoop`` surface, not a
    ``BaseEventLoop`` subclass — no selector, no real clock).  It keeps
    its own ready list and timer heap; each ``_run_once`` the scheduler
    picks exactly ONE ready callback, so the interleaving of every task
    in the system is a sequence of explicit, replayable choices.  Time
    is virtual: ``loop.time()`` only advances when nothing is runnable,
    jumping straight to the next timer — a 10-second lease TTL costs
    zero wall-clock.  ``run_in_executor`` runs the function inline
    (deterministic, and it is how ``asyncio.to_thread`` fsyncs land
    inside the model rather than on a real thread pool).

``RandomScheduler`` / ``PctScheduler``
    Seeded strategies over the ready list.  Random is uniform; PCT
    assigns seeded priorities per callback label and demotes the
    current leader at seeded change points — long stretches of one
    task, with injected priority inversions (the schedules that shake
    out ordering bugs uniform sampling rarely hits).

``MemNet``
    An in-memory implementation of the ``runtime/transports/net.py``
    seam: paired ``StreamReader``s speaking the real ``framing.py``
    bytes, with per-connection sever triggers ("cut this peer at its
    k-th server→client frame") and whole-server kill (crash modeling).
    Every byte crossing a channel is recorded, so the checker can
    reconstruct per-channel op-transition state machines afterwards.

Determinism contract: given the same scenario code, seed, and crash
plan, two runs produce byte-identical schedule traces.  Every choice
the loop makes is appended to ``loop.choices``; a replay token embeds
that list and ``forced_choices`` re-executes it exactly.

No scenario code lives here: see ``analysis/protocheck.py``.
"""

from __future__ import annotations

import asyncio
import contextvars
import heapq
import itertools
import logging
import random
import sys
import time as _time
import weakref
from typing import Any, Callable, Optional

log = logging.getLogger("dynamo_tpu_torch.analysis.detloop")

__all__ = [
    "DetLoop",
    "RandomScheduler",
    "PctScheduler",
    "MemNet",
    "SimulatedCrash",
    "DeadlockError",
    "HorizonExceeded",
    "ReplayMismatch",
    "run_deterministic",
]

# virtual wall-clock epoch: time.time() inside a deterministic run reads
# epoch + loop.time(), so WAL id epochs and persist timestamps are stable
VIRTUAL_EPOCH = 1_700_000_000.0


class SimulatedCrash(BaseException):
    """Raised by a crash hook to model instant process death.

    BaseException on purpose: the coordinator's per-op ``except
    Exception`` error-reply path must NOT catch it — a dead process
    sends no error reply."""


class DeadlockError(RuntimeError):
    """Nothing runnable, nothing scheduled, main not done."""


class HorizonExceeded(RuntimeError):
    """Virtual time or step budget ran out before quiescence."""


class ReplayMismatch(RuntimeError):
    """A forced choice didn't fit the observed ready list."""


# --------------------------------------------------------------- schedulers


class RandomScheduler:
    """Uniform seeded pick over the ready list."""

    name = "random"

    def __init__(self, seed: int):
        self.seed = seed
        self.rng = random.Random(seed)

    def choose(self, ready: list) -> int:
        return self.rng.randrange(len(ready))


class PctScheduler:
    """PCT-style priority scheduler (Burckhardt et al.): each callback
    label gets a seeded priority; the highest-priority ready handle
    runs.  At ``depth`` seeded change points the current leader is
    demoted below everyone, forcing a priority inversion — the class of
    schedule that exposes ordering bugs with probabilistic guarantees
    uniform random rarely reaches."""

    name = "pct"

    def __init__(self, seed: int, depth: int = 3, span: int = 4000):
        self.seed = seed
        self.rng = random.Random(seed)
        self.depth = depth
        self._prio: dict[str, float] = {}
        self._steps = 0
        self._change = sorted(self.rng.randrange(1, span)
                              for _ in range(depth))

    def choose(self, ready: list) -> int:
        self._steps += 1
        labels = [h.label for h in ready]
        for lbl in labels:
            if lbl not in self._prio:
                self._prio[lbl] = 1.0 + self.rng.random()
        if self._change and self._steps >= self._change[0]:
            self._change.pop(0)
            top = max(labels, key=lambda l: self._prio[l])
            self._prio[top] = self.rng.random() * 0.5
        # ties (same label twice) resolve FIFO: earliest index wins
        return max(range(len(ready)),
                   key=lambda i: (self._prio[labels[i]], -i))


def make_scheduler(seed: int):
    """Seed parity alternates strategy so one seed range sweeps both."""
    return PctScheduler(seed) if seed % 2 else RandomScheduler(seed)


# ------------------------------------------------------------------- handles


class _Handle:
    """Loop-owned callback record (asyncio.Handle has __slots__ and
    cannot carry the label/seq bookkeeping the scheduler needs)."""

    __slots__ = ("callback", "args", "context", "label", "seq", "when",
                 "_cancelled")

    def __init__(self, callback, args, context, label, seq, when=None):
        self.callback = callback
        self.args = args
        self.context = context
        self.label = label
        self.seq = seq
        self.when = when
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    def cancelled(self) -> bool:
        return self._cancelled

    def __lt__(self, other) -> bool:  # heap tiebreak
        return (self.when, self.seq) < (other.when, other.seq)


def _label_of(callback) -> str:
    """Stable, address-free label for a callback: task steps get their
    coroutine's qualname, plain callbacks their own."""
    owner = getattr(callback, "__self__", None)
    if isinstance(owner, asyncio.Task):
        coro = owner.get_coro()
        return getattr(coro, "__qualname__", None) or type(coro).__name__
    if isinstance(owner, asyncio.Future):
        return "Future._schedule_callbacks"
    return (getattr(callback, "__qualname__", None)
            or type(callback).__name__)


# ---------------------------------------------------------------------- loop


class DetLoop(asyncio.AbstractEventLoop):
    def __init__(self, scheduler=None, *,
                 forced_choices: Optional[list[int]] = None,
                 horizon_s: float = 1800.0, max_steps: int = 250_000):
        self.scheduler = scheduler or RandomScheduler(0)
        self._ready: list[_Handle] = []
        self._timers: list[_Handle] = []
        self._vtime = 0.0
        self._seq = itertools.count()
        self._stopping = False
        self._running = False
        self._closed = False
        self._horizon = horizon_s
        self._max_steps = max_steps
        self._steps = 0
        self._label_counts: dict[str, int] = {}
        # the two replay artifacts: every scheduling decision, and the
        # resulting execution order as "label#occurrence" strings
        self.choices: list[int] = []
        self.trace: list[str] = []
        self._forced = list(forced_choices) if forced_choices else None
        self._exceptions: list[dict] = []
        self._asyncgens: "weakref.WeakSet" = weakref.WeakSet()
        self._ag_closers: set = set()
        self._all_tasks: "weakref.WeakSet" = weakref.WeakSet()

    # ------------------------------------------------------------ scheduling
    def call_soon(self, callback, *args, context=None):
        if self._closed:  # teardown GC stragglers: nothing left to run
            return _Handle(callback, args, None, "closed", -1)
        h = _Handle(callback, args,
                    context if context is not None
                    else contextvars.copy_context(),
                    _label_of(callback), next(self._seq))
        self._ready.append(h)
        return h

    call_soon_threadsafe = call_soon

    def call_later(self, delay, callback, *args, context=None):
        return self.call_at(self._vtime + max(0.0, delay), callback, *args,
                            context=context)

    def call_at(self, when, callback, *args, context=None):
        if self._closed:
            return _Handle(callback, args, None, "closed", -1, when)
        h = _Handle(callback, args,
                    context if context is not None
                    else contextvars.copy_context(),
                    _label_of(callback), next(self._seq), when)
        heapq.heappush(self._timers, h)
        return h

    def time(self) -> float:
        return self._vtime

    # --------------------------------------------------------------- futures
    def create_future(self) -> asyncio.Future:
        return asyncio.Future(loop=self)

    def create_task(self, coro, *, name=None, context=None):
        # context kwarg is 3.11+: drop it on 3.10 (callers here never pass it)
        t = asyncio.Task(coro, loop=self, name=name)
        self._all_tasks.add(t)
        return t

    def run_in_executor(self, executor, func, *args):
        """Inline execution: deterministic, and the only way crash hooks
        firing inside ``asyncio.to_thread`` fsyncs stay on the model's
        schedule.  The future resolves immediately; the awaiter still
        passes through the ready queue (a scheduling point)."""
        fut = self.create_future()
        try:
            fut.set_result(func(*args))
        except SimulatedCrash:
            raise  # process death: unwind the caller, no result to deliver
        except BaseException as e:
            fut.set_exception(e)
        return fut

    # ------------------------------------------------------------- lifecycle
    def is_running(self) -> bool:
        return self._running

    def is_closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        for t in list(self._ag_closers):
            t.cancel()
        self._ag_closers.clear()
        # a modeled death strands tasks mid-flight (or before their first
        # step); reap their coroutines now rather than leaving them for a
        # heap-proportional gc pass — closing here keeps the "never
        # awaited" / "destroyed but pending" warnings from firing at
        # interpreter exit no matter when the strays are collected.  This
        # loop stays the running one meanwhile: a finally block that
        # spawns a task (a client's reconnect) puts it here, to be reaped
        # in turn, not on the thread's default event loop
        prev = asyncio.events._get_running_loop()
        asyncio.events._set_running_loop(self)
        reaped: set[int] = set()
        try:
            while True:
                stray = [t for t in list(self._all_tasks)
                         if not t.done() and id(t) not in reaped]
                if not stray:
                    break
                for task in stray:
                    reaped.add(id(task))
                    task._log_destroy_pending = False
                    try:
                        task.get_coro().close()
                    except BaseException:
                        pass  # a finally block died against the closed loop
        finally:
            asyncio.events._set_running_loop(prev)
        self._all_tasks.clear()
        self._ready.clear()
        self._timers.clear()

    def stop(self) -> None:
        self._stopping = True

    def get_debug(self) -> bool:
        return False

    def set_debug(self, enabled: bool) -> None:
        pass

    async def shutdown_asyncgens(self) -> None:
        closing = [ag.aclose() for ag in list(self._asyncgens)]
        for c in closing:
            try:
                await c
            except BaseException as e:
                # teardown of a crashed run: generators die with the
                # model's own SimulatedCrash/CancelledError
                log.debug("asyncgen close failed during loop shutdown: %r",
                          e, exc_info=True)

    async def shutdown_default_executor(self, timeout=None) -> None:
        return

    # ----------------------------------------------------------- error sink
    def call_exception_handler(self, context: dict) -> None:
        # collected, not printed: abandoned post-crash tasks routinely die
        # with SimulatedCrash/ConnectionResetError and that's the model
        # working, not noise for stderr
        self._exceptions.append(context)

    def default_exception_handler(self, context: dict) -> None:
        self._exceptions.append(context)

    def set_exception_handler(self, handler) -> None:
        pass

    def get_exception_handler(self):
        return None

    # ------------------------------------------------------------ run loops
    def _ag_firstiter(self, agen) -> None:
        self._asyncgens.add(agen)

    def _ag_finalizer(self, agen) -> None:
        if not self._closed:
            t = self.create_task(agen.aclose())
            self._ag_closers.add(t)
            t.add_done_callback(self._ag_closers.discard)

    def run_forever(self) -> None:
        if self._running:
            raise RuntimeError("loop already running")
        old_hooks = sys.get_asyncgen_hooks()
        sys.set_asyncgen_hooks(firstiter=self._ag_firstiter,
                               finalizer=self._ag_finalizer)
        asyncio.events._set_running_loop(self)
        self._running = True
        try:
            while not self._stopping:
                self._run_once()
        finally:
            self._stopping = False
            self._running = False
            asyncio.events._set_running_loop(None)
            sys.set_asyncgen_hooks(*old_hooks)

    def run_until_complete(self, future):
        fut = asyncio.ensure_future(future, loop=self)
        fut.add_done_callback(lambda f: self.stop())
        self.run_forever()
        if not fut.done():
            raise RuntimeError("loop stopped before future completed")
        return fut.result()

    def _run_once(self) -> None:
        # expire due timers into the ready list (seq order: deterministic)
        while self._timers and self._timers[0].when <= self._vtime:
            h = heapq.heappop(self._timers)
            if not h._cancelled:
                self._ready.append(h)
        if any(h._cancelled for h in self._ready):
            self._ready = [h for h in self._ready if not h._cancelled]
        # canonicalize: stable-sort by label so the ready list is identical
        # across interpreter runs even where set-iteration order (str hash)
        # permuted same-label callbacks at creation — schedules become
        # label-isomorphic, which is what traces and replay tokens key on
        self._ready.sort(key=lambda h: h.label)
        if not self._ready:
            while self._timers and self._timers[0]._cancelled:
                heapq.heappop(self._timers)
            if not self._timers:
                raise DeadlockError(
                    f"deadlock at vt={self._vtime:.3f}: nothing runnable, "
                    "nothing scheduled")
            nxt = self._timers[0].when
            if nxt > self._horizon:
                raise HorizonExceeded(
                    f"virtual-time horizon {self._horizon}s exceeded "
                    f"(next timer at {nxt:.1f}s)")
            self.trace.append(f"<advance:{nxt:.6f}>")
            self._vtime = nxt
            return
        self._steps += 1
        if self._steps > self._max_steps:
            raise HorizonExceeded(f"step budget {self._max_steps} exceeded")
        if self._forced:
            idx = self._forced.pop(0)
            if idx >= len(self._ready):
                raise ReplayMismatch(
                    f"forced choice {idx} outside ready list of "
                    f"{len(self._ready)} at step {self._steps}")
        else:
            idx = self.scheduler.choose(self._ready)
        h = self._ready.pop(idx)
        self.choices.append(idx)
        occ = self._label_counts.get(h.label, 0)
        self._label_counts[h.label] = occ + 1
        self.trace.append(f"{h.label}#{occ}")
        h.context.run(h.callback, *h.args)


def run_deterministic(loop: DetLoop, main, epoch: float = VIRTUAL_EPOCH):
    """``loop.run_until_complete(main)`` under the virtual clock.

    ``time.time`` / ``time.monotonic`` / ``time.perf_counter`` read the
    loop's virtual time for the duration — coordinator id epochs, lease
    expiry arithmetic and persist timestamps all become functions of the
    schedule alone.  References bound before the patch (pytest's timer,
    the logging module's cached formatter time) keep the real clock.
    """
    saved = (_time.time, _time.monotonic, _time.perf_counter)
    _time.time = lambda: epoch + loop.time()
    _time.monotonic = lambda: loop.time()
    _time.perf_counter = lambda: loop.time()
    try:
        return loop.run_until_complete(main)
    finally:
        _time.time, _time.monotonic, _time.perf_counter = saved


# ----------------------------------------------------------------- MemNet


class _FrameCounter:
    """Incremental complete-frame count over an append-only byte buffer
    (framing layout: [u32 hlen][u32 plen][header][payload])."""

    __slots__ = ("buf", "off", "count")

    def __init__(self):
        self.buf = bytearray()
        self.off = 0
        self.count = 0

    def feed(self, data: bytes) -> int:
        import struct

        self.buf += data
        while self.off + 8 <= len(self.buf):
            hlen, plen = struct.unpack_from(">II", self.buf, self.off)
            end = self.off + 8 + hlen + plen
            if end > len(self.buf):
                break
            self.off = end
            self.count += 1
        return self.count


class MemStreamWriter:
    """StreamWriter surface over one direction of a MemConn."""

    def __init__(self, conn: "_MemConn", direction: str):
        self._conn = conn
        self._dir = direction

    def write(self, data: bytes) -> None:
        self._conn.send(self._dir, data)

    async def drain(self) -> None:
        if self._conn.closed[self._dir]:
            raise ConnectionResetError("write to severed mem-connection")
        await asyncio.sleep(0)  # a real drain is a scheduling point

    def close(self) -> None:
        self._conn.close()

    def is_closing(self) -> bool:
        return self._conn.closed[self._dir]

    async def wait_closed(self) -> None:
        return

    def get_extra_info(self, name: str, default=None):
        return default

    @property
    def transport(self) -> "MemStreamWriter":
        return self  # .abort() lives here

    def abort(self) -> None:
        self._conn.close()


class _MemConn:
    """One full-duplex connection: two StreamReaders fed by the opposite
    writer.  ``c2s`` is client→server, ``s2c`` server→client."""

    def __init__(self, net: "MemNet", port: int, conn_no: int):
        self.net = net
        self.port = port
        self.conn_no = conn_no
        self.readers = {"c2s": asyncio.StreamReader(),
                        "s2c": asyncio.StreamReader()}
        self.closed = {"c2s": False, "s2c": False}

    def send(self, direction: str, data: bytes) -> None:
        if self.closed[direction]:
            return  # writes into a severed transport vanish, like TCP
        n = self.net._record(self, direction, data)
        plan = self.net.sever_plan
        if (plan is not None and plan["conn"] == self.conn_no
                and plan["direction"] == direction
                and n >= plan["after_frames"]):
            self.net.sever_plan = None
            self.close()
            return  # the triggering frame is lost with the connection
        self.readers[direction].feed_data(data)

    def close(self) -> None:
        for d, reader in self.readers.items():
            if not self.closed[d]:
                self.closed[d] = True
                reader.feed_eof()


class MemServer:
    """Handle returned by MemNet.start_server — the asyncio.Server
    surface the transports' stop() paths use."""

    def __init__(self, net: "MemNet", port: int, cb):
        self.net = net
        self.port = port
        self.cb = cb
        self.conns: list[_MemConn] = []
        self.tasks: "set[asyncio.Task]" = set()
        self.closed = False

    def close(self) -> None:
        self.closed = True
        self.net._servers.pop(self.port, None)

    async def wait_closed(self) -> None:
        return


class MemNet:
    """In-memory Net (transports/net.py seam) for the DetLoop.

    ``sever_plan`` cuts one connection at its k-th complete frame in one
    direction (the crash-op vocabulary's "sever" against an exact frame
    ordinal); ``kill_server`` models whole-process death.  All channel
    bytes are retained per (port, conn, direction) for the checker's
    transition extraction.
    """

    def __init__(self, loop: DetLoop):
        self.loop = loop
        self._servers: dict[int, MemServer] = {}
        self._ports = itertools.count(10001)
        self.conns: list[_MemConn] = []
        self.port_names: dict[int, str] = {}
        self.sever_plan: Optional[dict] = None
        self._counters: dict[tuple, _FrameCounter] = {}

    # ------------------------------------------------------------- Net API
    async def start_server(self, cb, host: str, port: int):
        if port == 0:
            port = next(self._ports)
        if port in self._servers:
            raise OSError(98, f"mem port {port} already bound")
        srv = MemServer(self, port, cb)
        self._servers[port] = srv
        return srv, port

    async def open_connection(self, host: str, port: int):
        srv = self._servers.get(port)
        if srv is None or srv.closed:
            raise ConnectionRefusedError(111, f"mem connect refused :{port}")
        await asyncio.sleep(0)  # dialing is a scheduling point
        conn = _MemConn(self, port, len(self.conns) + 1)
        self.conns.append(conn)
        srv.conns.append(conn)
        server_writer = MemStreamWriter(conn, "s2c")
        t = self.loop.create_task(
            self._serve(srv, conn, server_writer))
        srv.tasks.add(t)
        t.add_done_callback(srv.tasks.discard)
        return conn.readers["s2c"], MemStreamWriter(conn, "c2s")

    @staticmethod
    async def _serve(srv: MemServer, conn: _MemConn, writer) -> None:
        try:
            await srv.cb(conn.readers["c2s"], writer)
        except asyncio.CancelledError:
            raise
        except SimulatedCrash:
            pass  # the crash already tore the server down
        except (ConnectionError, RuntimeError):
            pass  # handler died against a severed peer: modeled noise

    # ------------------------------------------------------------- recorder
    def _record(self, conn: _MemConn, direction: str, data: bytes) -> int:
        key = (conn.port, conn.conn_no, direction)
        ctr = self._counters.get(key)
        if ctr is None:
            ctr = self._counters[key] = _FrameCounter()
        return ctr.feed(data)

    def name_port(self, port: int, name: str) -> None:
        """Label a bound port with its service name for fact extraction."""
        self.port_names[port] = name

    def channel_frames(self) -> dict[tuple[str, str], list[dict]]:
        """Decoded frame headers per (service, direction), connection
        transcripts concatenated in connection order."""
        from dynamo_tpu_torch.runtime.transports.framing import decode_frames

        out: dict[tuple[str, str], list[dict]] = {}
        for (port, conn_no, direction), ctr in sorted(self._counters.items()):
            name = self.port_names.get(port, f"port{port}")
            headers = [h for h, _ in decode_frames(bytes(ctr.buf))]
            out.setdefault((name, direction), []).extend(headers)
        return out

    # ------------------------------------------------------------ crash ops
    def sever_conn_after(self, conn_no: int, after_frames: int,
                         direction: str = "s2c") -> None:
        self.sever_plan = {"conn": conn_no, "direction": direction,
                           "after_frames": after_frames}

    def kill_server(self, port: int) -> Optional[MemServer]:
        """Instant process death: unbind the port, sever every live
        connection, cancel the handler tasks.  Sync on purpose — crash
        hooks call it from inside the dying server's own stack."""
        srv = self._servers.pop(port, None)
        if srv is None:
            return None
        srv.closed = True
        for conn in srv.conns:
            conn.close()
        for t in list(srv.tasks):
            t.cancel()
        return srv
