"""Deterministic fault injection for tests and the soak harness.

A copy of the JAX package's ``fault/injector.py`` on the port's TCP request
plane and coordinator.

Every fault the plane defends against can be produced on demand, at an
exact point in the protocol, with no sleeps-and-hope timing:

  * ``kill_tcp_server``  — worker death: RST every connection mid-stream
    and stop listening (discovery key survives until lease expiry, like a
    real crash);
  * ``drop_frames`` / ``sever_after`` — transport faults at the N-th
    outbound frame, via the server's ``fault_hook`` seam;
  * ``stall_coordinator`` — control-plane brownout: the coordinator stops
    dispatching until released (lease keepalives and watches stall).

Injectors restore every seam they install (``clear`` / the returned
release callables), so one test's chaos can't leak into the next.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Callable, Optional

log = logging.getLogger("dynamo_tpu_torch.fault")

__all__ = ["FaultInjector", "CRASH_OPS"]

# The crash-op vocabulary, the JAX package's own: every fault this injector
# can produce, named, and what the fault soak picks from with a seeded RNG.
#
#   kill   — process death: RST every connection, stop listening
#            (kill_tcp_server)
#   sever  — cut one peer's transport at an exact outbound frame
#            (sever_after)
#   drop   — swallow N outbound frames of one type (drop_frames)
#   stall  — control-plane brownout: dispatch frozen until release
#            (stall_coordinator)
#   crash  — durability-boundary death at a WAL append/fsync/compact; the
#            JAX package's protocol model checker drives it, and this
#            injector has no seam for it (a real process cannot un-crash)
CRASH_OPS = ("kill", "sever", "drop", "stall", "crash")


def _tcp_server(target):
    """Accept a DistributedRuntime or a bare EndpointTcpServer."""
    return getattr(target, "_tcp_server", None) or target


class FaultInjector:
    """``seed=`` makes every choice the injector itself takes (which op,
    which frame ordinal) deterministic: two injectors built with the same
    seed produce the same fault sequence, so a soak failure replays."""

    def __init__(self, seed: Optional[int] = None) -> None:
        self._hooked = []  # (server, prior_hook)
        self._stalls = []  # release callables
        self.seed = seed
        self.rng = random.Random(seed)

    def choose_op(self, ops: Optional[tuple[str, ...]] = None) -> str:
        """Seeded pick from the crash-op vocabulary (soak-loop driver)."""
        pool = [op for op in (ops or CRASH_OPS) if op in CRASH_OPS]
        if not pool:
            raise ValueError(f"no valid crash ops in {ops!r}")
        return self.rng.choice(pool)

    # ---------------------------------------------------------- worker death
    async def kill_tcp_server(self, target) -> None:
        """Abort the worker's request plane mid-stream — the 'process
        died' fault.  Peers see a reset, not a clean end-of-stream."""
        server = _tcp_server(target)
        log.info("FAULT: killing tcp server on port %s", server.port)
        await server.abort()

    # ------------------------------------------------------- frame-level faults
    def _install(self, target, hook) -> None:
        server = _tcp_server(target)
        self._hooked.append((server, server.fault_hook))
        server.fault_hook = hook

    def drop_frames(self, target, ftype: str = "item", nth: int = 1,
                    count: int = 1) -> Callable[[], int]:
        """Silently drop the ``nth``..``nth+count-1``-th outbound frames of
        ``ftype``.  Returns a callable reporting how many were dropped."""
        seen = 0
        dropped = 0

        def hook(header: dict) -> Optional[str]:
            nonlocal seen, dropped
            if header.get("type") != ftype:
                return None
            seen += 1
            if nth <= seen < nth + count:
                dropped += 1
                return "drop"
            return None

        self._install(target, hook)
        return lambda: dropped

    def sever_after(self, target, n_items: int, ftype: str = "item") -> None:
        """Cut the peer's transport the moment the ``n_items``-th frame of
        ``ftype`` would go out — a worker dying exactly mid-token."""
        seen = 0

        def hook(header: dict) -> Optional[str]:
            nonlocal seen
            if header.get("type") != ftype:
                return None
            seen += 1
            if seen >= n_items:
                return "sever"
            return None

        self._install(target, hook)

    def clear(self, target=None) -> None:
        """Remove installed frame hooks (all, or just ``target``'s)."""
        keep = []
        for server, prior in self._hooked:
            if target is None or server is _tcp_server(target):
                server.fault_hook = prior
            else:
                keep.append((server, prior))
        self._hooked = keep

    # ---------------------------------------------------- coordinator brownout
    def stall_coordinator(self, coord_server) -> Callable[[], None]:
        """Freeze the coordinator's dispatch loop (every client call hangs)
        until the returned release() — an event-loop stall / GC-pause /
        network-partition stand-in for the control plane."""
        gate = asyncio.Event()
        orig = coord_server._dispatch

        async def stalled(*args, **kwargs):
            await gate.wait()
            return await orig(*args, **kwargs)

        coord_server._dispatch = stalled
        released = False

        def release() -> None:
            nonlocal released
            if not released:
                released = True
                coord_server._dispatch = orig
                gate.set()
                try:
                    self._stalls.remove(release)
                except ValueError:
                    pass

        self._stalls.append(release)
        log.info("FAULT: coordinator stalled")
        return release

    # ------------------------------------------------------------- teardown
    def release_all(self) -> None:
        """Undo everything still installed — call from test teardown."""
        self.clear()
        for release in list(self._stalls):
            release()
