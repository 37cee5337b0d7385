"""Active health probing over the TCP request plane.

A copy of the JAX package's ``fault/health.py``.

Discovery (coordinator leases) tells us a worker died only after its TTL
lapses — typically seconds of requests routed into a black hole.  The
HealthMonitor pings each live instance over the SAME socket requests ride
(transports/tcp.py ``ping``/``pong`` control frames), so a worker whose
process is gone — or whose event loop is wedged — turns *suspect* within
a probe interval, and routing deprioritizes it immediately:

  * Client.pick_random / pick_round_robin skip suspect ids while any
    healthy instance remains (runtime/distributed.py _candidate_ids)
  * the KV-router scheduler drops suspects from its candidate set
    (llm/kv_router/scheduler.py mark_suspect) via on_suspect/on_recover

Suspect is a soft state: a successful probe clears it, and discovery
delete (lease expiry / drain) removes the instance outright.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Optional

from dynamo_tpu_torch.fault.counters import counters
from dynamo_tpu_torch.runtime.transports.tcp import TransportError

log = logging.getLogger("dynamo_tpu_torch.fault")

__all__ = ["HealthMonitor"]


class HealthMonitor:
    """Probe a Client's instances; track suspects.

    ``fail_threshold`` consecutive probe failures mark an instance
    suspect; one success clears it.  ``on_suspect``/``on_recover`` hooks
    fan the state out (e.g. into a KvScheduler's worker set).
    """

    def __init__(
        self,
        client,
        interval_s: float = 1.0,
        timeout_s: float = 1.0,
        fail_threshold: int = 2,
        on_suspect: Optional[Callable[[int], None]] = None,
        on_recover: Optional[Callable[[int], None]] = None,
    ):
        self.client = client
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.fail_threshold = max(1, fail_threshold)
        self.on_suspect = on_suspect
        self.on_recover = on_recover
        self._failures: dict[int, int] = {}
        self._suspects: set[int] = set()
        self._task: Optional[asyncio.Task] = None
        self.probes = 0  # total probe rounds (test observability)

    # ---------------------------------------------------------------- state
    def is_suspect(self, instance_id: int) -> bool:
        return instance_id in self._suspects

    def suspect_ids(self) -> set[int]:
        return set(self._suspects)

    def _mark(self, iid: int) -> None:
        if iid not in self._suspects:
            self._suspects.add(iid)
            log.warning("instance %x suspect after %d failed probes",
                        iid, self._failures.get(iid, 0))
            if self.on_suspect:
                self.on_suspect(iid)

    def _clear(self, iid: int) -> None:
        self._failures.pop(iid, None)
        if iid in self._suspects:
            self._suspects.discard(iid)
            log.info("instance %x recovered", iid)
            if self.on_recover:
                self.on_recover(iid)

    # --------------------------------------------------------------- probing
    async def probe_once(self) -> None:
        """One probe round over the client's current instance list."""
        live = set(self.client.instance_ids())
        # instances that left discovery are neither suspect nor failing
        for iid in list(self._suspects - live):
            self._suspects.discard(iid)
        for iid in list(self._failures.keys() - live):
            self._failures.pop(iid, None)
        for iid in live:
            try:
                conn = self.client._conn(iid)
                await conn.ping(self.timeout_s)
            except (TransportError, ConnectionError, OSError, KeyError):
                n = self._failures.get(iid, 0) + 1
                self._failures[iid] = n
                if n >= self.fail_threshold:
                    self._mark(iid)
            else:
                self._clear(iid)
        self.probes += 1

    async def _run(self) -> None:
        while True:
            try:
                await self.probe_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("health probe round failed; continuing")
            await asyncio.sleep(self.interval_s)

    # -------------------------------------------------------------- lifecycle
    async def start(self) -> "HealthMonitor":
        if self._task is None:
            counters.register_suspect_source(self.suspect_ids)
            self._task = asyncio.ensure_future(self._run())
        return self

    async def stop(self) -> None:
        counters.unregister_suspect_source(self.suspect_ids)
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
