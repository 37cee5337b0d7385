"""DistributedRuntime — the cluster handle.

A copy of the JAX package's ``runtime/distributed.py`` on the port's
coordinator client and TCP request plane: the same discovery keys,
subjects and instance records, so port and JAX processes discover and
call each other through either package's coordinator.  ``drain`` keeps
the fault plane's drains-in-progress gauge (``fault/counters.py``), and a
``Client``'s ``health`` is a ``fault.HealthMonitor`` when a caller sets one.

Namespace → Component → Endpoint naming, endpoint serving with lease-backed
discovery, clients with watch-driven instance lists and routing modes.

Reference parity: lib/runtime/src/distributed.rs:32 (DistributedRuntime),
component.rs:107-295 (Component/Endpoint/Namespace, key scheme
"{ns}/components/{comp}/{ep}:{lease}"), component/endpoint.rs:57-141
(serve + discovery registration), component/client.rs:52-267 (Client,
RouterMode random/round_robin/direct, wait_for_endpoints, watch-driven
instance updates on lease expiry).

The transports differ by design: discovery/lease/events ride the
coordinator (transports/coordinator.py) and requests ride direct TCP
(transports/tcp.py) — see transports/__init__.py for the mapping.
"""

from __future__ import annotations

import asyncio
import logging
import random as _random
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient
from dynamo_tpu_torch.runtime.transports.tcp import EndpointTcpClient, EndpointTcpServer

log = logging.getLogger("dynamo_tpu_torch.runtime")

__all__ = ["DistributedRuntime", "Namespace", "Component", "Endpoint", "Client", "Instance"]


@dataclass(frozen=True)
class Instance:
    instance_id: int
    host: str
    port: int
    subject: str
    metadata: dict | None = None


class DistributedRuntime:
    def __init__(self, config: Optional[RuntimeConfig] = None, *, net=None):
        self.config = config or RuntimeConfig()
        # connection factory threaded into every transport this runtime
        # opens (transports/net.py); None = real sockets.
        self._net = net
        self.coordinator: Optional[CoordinatorClient] = None
        self._tcp_server: Optional[EndpointTcpServer] = None
        self.primary_lease: Optional[int] = None
        # every Endpoint.serve() registers here so drain_all() can run the
        # graceful-drain lifecycle over the whole process on shutdown
        self._served: list[tuple["Endpoint", int]] = []
        # services wired onto this runtime (router subscribers, metric
        # aggregators) register their stop() here; shutdown() runs them
        # first so their background tasks drain before the transports
        # they ride on close (otherwise the tasks leak)
        self._on_shutdown: list[Callable[[], Any]] = []

    @classmethod
    async def connect(cls, config: Optional[RuntimeConfig] = None, *,
                      net=None) -> "DistributedRuntime":
        rt = cls(config, net=net)
        # reconnect=True: a coordinator restart re-registers this runtime's
        # leases, discovery keys, watches and subs automatically
        rt.coordinator = await CoordinatorClient(
            rt.config.coordinator_url, reconnect=True, net=net
        ).connect()
        rt.primary_lease = await rt.coordinator.lease_create(rt.config.lease_ttl_s)
        return rt

    def on_shutdown(self, stop: Callable[[], Any]) -> None:
        """Register an async callable to run first at shutdown()."""
        self._on_shutdown.append(stop)

    async def shutdown(self) -> None:
        stops, self._on_shutdown = self._on_shutdown, []
        for stop in reversed(stops):  # LIFO: later services stop first
            try:
                await stop()
            except Exception:
                log.debug("on_shutdown hook failed", exc_info=True)
        if self._tcp_server:
            await self._tcp_server.stop()
        if self.coordinator:
            await self.coordinator.close()

    async def drain_all(self, timeout: float = 30.0) -> None:
        """Gracefully drain every endpoint this runtime serves: discovery
        keys go first (no new routing), live streams finish, then subjects
        deregister.  Callers follow with shutdown().  The serve_worker
        SIGTERM path rides this so a supervisor downscale / planner role
        flip never amputates in-flight requests."""
        served, self._served = self._served, []
        await asyncio.gather(
            *(ep.drain(lease_id=iid, timeout=timeout) for ep, iid in served),
            return_exceptions=True,
        )

    @property
    def instance_id(self) -> int:
        """This process's cluster identity (its primary lease id)."""
        return self.primary_lease or 0

    async def tcp_server(self) -> EndpointTcpServer:
        """Lazily started shared endpoint server (ref: lazy TCP server,
        distributed.rs)."""
        if self._tcp_server is None:
            self._tcp_server = await EndpointTcpServer(
                host=self.config.host, port=self.config.port, net=self._net
            ).start()
        return self._tcp_server

    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, name)


@dataclass
class Namespace:
    runtime: DistributedRuntime
    name: str

    def component(self, name: str) -> "Component":
        return Component(self.runtime, self.name, name)

    # namespace-scoped events (ref traits/events.rs)
    async def publish(self, subject: str, payload: bytes | dict) -> int:
        return await self.runtime.coordinator.publish(f"{self.name}.{subject}", payload)

    async def subscribe(self, subject: str, cb: Callable[[str, bytes], None]) -> int:
        return await self.runtime.coordinator.subscribe(f"{self.name}.{subject}", cb)


@dataclass
class Component:
    runtime: DistributedRuntime
    namespace: str
    name: str

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.runtime, self.namespace, self.name, name)

    @property
    def event_prefix(self) -> str:
        return f"{self.namespace}.{self.name}"

    async def publish(self, subject: str, payload: bytes | dict) -> int:
        return await self.runtime.coordinator.publish(f"{self.event_prefix}.{subject}", payload)

    async def subscribe(self, subject: str, cb: Callable[[str, bytes], None]) -> int:
        return await self.runtime.coordinator.subscribe(f"{self.event_prefix}.{subject}", cb)


class Endpoint:
    def __init__(self, runtime: DistributedRuntime, namespace: str, component: str, name: str):
        self.runtime = runtime
        self.namespace = namespace
        self.component = component
        self.name = name

    @property
    def discovery_prefix(self) -> str:
        return f"{self.namespace}/components/{self.component}/endpoints/{self.name}/"

    def subject(self, instance_id: int) -> str:
        # "{ns}_{comp}.{ep}-{lease:x}" in the reference (component.rs:262)
        return f"{self.namespace}_{self.component}.{self.name}-{instance_id:x}"

    @property
    def url(self) -> str:
        return f"dyn://{self.namespace}.{self.component}.{self.name}"

    # ------------------------------------------------------------------ serve
    async def serve(
        self, engine: AsyncEngine, metadata: Optional[dict] = None,
        lease_id: Optional[int] = None,
    ) -> Instance:
        """Register this engine as a live instance of the endpoint."""
        rt = self.runtime
        server = await rt.tcp_server()
        instance_id = lease_id or rt.primary_lease
        subject = self.subject(instance_id)
        server.register(subject, engine)
        info = {
            "instance_id": instance_id,
            "host": server.host,
            "port": server.port,
            "subject": subject,
            "metadata": metadata or {},
        }
        key = f"{self.discovery_prefix}{instance_id:x}"
        created = await rt.coordinator.kv_create(key, info, lease_id=instance_id)
        if not created:
            raise RuntimeError(f"endpoint instance already registered at {key}")
        rt._served.append((self, instance_id))
        log.info("serving %s as instance %x on %s:%s", self.url, instance_id, info["host"], info["port"])
        return Instance(instance_id, info["host"], info["port"], subject, metadata)

    async def drain(self, lease_id: Optional[int] = None, timeout: float = 30.0) -> bool:
        """Graceful drain of this endpoint's instance (ref: the reference
        workers deregister-then-drain on shutdown).  Order matters:

          1. delete the discovery key — routing stops sending new work;
          2. wait for in-flight requests on the subject to finish;
          3. deregister the engine from the TCP server.

        Returns True if the subject went idle inside ``timeout``.  Safe to
        call twice (the second delete/unregister is a no-op)."""
        from dynamo_tpu_torch.fault.counters import counters

        rt = self.runtime
        iid = lease_id or rt.primary_lease
        subject = self.subject(iid)
        counters.drains_in_progress += 1
        try:
            try:
                # bounded: a stalled coordinator must not hold up process
                # shutdown — if the delete can't land, the lease expiry
                # deletes the key for us; keep draining local streams
                await asyncio.wait_for(
                    rt.coordinator.kv_delete(f"{self.discovery_prefix}{iid:x}"),
                    min(2.0, timeout))
            except (ConnectionError, RuntimeError, asyncio.TimeoutError):
                log.warning("drain of %s: discovery delete failed", self.url)
            rt._served = [(e, i) for e, i in rt._served
                          if not (i == iid and e.subject(i) == subject)]
            idle = True
            if rt._tcp_server is not None:
                idle = await rt._tcp_server.wait_idle(subject, timeout)
                if not idle:
                    log.warning(
                        "drain of %s instance %x timed out with %d streams live",
                        self.url, iid, rt._tcp_server.inflight(subject))
                rt._tcp_server.unregister(subject)
            log.info("drained %s instance %x (idle=%s)", self.url, iid, idle)
            return idle
        finally:
            counters.drains_in_progress -= 1

    # ----------------------------------------------------------------- client
    async def client(self) -> "Client":
        c = Client(self)
        await c.start()
        # vended clients die with the runtime: callers that never reach
        # their close() (or forget it) must not leak watch subscriptions
        # and endpoint transports past shutdown (close() is idempotent)
        self.runtime.on_shutdown(c.close)
        return c


class Client(AsyncEngine):
    """Watch-driven endpoint client with routing modes (ref client.rs:52)."""

    def __init__(self, endpoint: Endpoint):
        self.endpoint = endpoint
        self._instances: dict[int, Instance] = {}
        self._conns: dict[int, EndpointTcpClient] = {}
        # round-robin cursor: the LAST instance id handed out.  Tracking
        # the id (not a list index) keeps rotation stable when membership
        # churn reshuffles the sorted id list under us.
        self._rr_last: Optional[int] = None
        # optional fault/health.HealthMonitor (anything with
        # is_suspect(instance_id)); picks deprioritize suspect instances
        self.health = None
        self._watch_id: Optional[int] = None
        self._changed = asyncio.Event()
        # seen-then-deleted instance ids, insertion-ordered so the churn
        # bound evicts OLDEST-first (an arbitrary set.pop() could evict a
        # recently-dead id, handing it back the discovery grace window
        # and re-adding the failover latency the no-grace rule avoids)
        self._removed: dict[int, None] = {}
        self._retiring: set[tuple] = set()  # (conn, drain task) pairs

    async def start(self) -> None:
        coord = self.endpoint.runtime.coordinator
        self._watch_id, snapshot = await coord.watch(
            self.endpoint.discovery_prefix, self._on_event
        )
        for key, value in snapshot.items():
            self._add(value)

    async def close(self) -> None:
        if self._watch_id is not None:
            wid, self._watch_id = self._watch_id, None  # idempotent close
            try:
                await self.endpoint.runtime.coordinator.unwatch(wid)
            except (ConnectionError, RuntimeError):
                pass
        for conn in self._conns.values():
            await conn.close()
        for conn, task in list(self._retiring):
            task.cancel()
            await conn.close()
        self._retiring.clear()

    # ------------------------------------------------------------- discovery
    def _on_event(self, event: str, key: str, value: Any) -> None:
        if event == "put":
            self._add(value)
        elif event == "delete":
            iid = int(key.rsplit("/", 1)[-1], 16)
            self._instances.pop(iid, None)
            self._removed.pop(iid, None)  # re-death refreshes recency
            self._removed[iid] = None
            while len(self._removed) > 1024:  # bound long-lived churn
                del self._removed[next(iter(self._removed))]
            conn = self._conns.pop(iid, None)
            if conn:
                # retire, don't kill: the delete may be a false positive
                # (lease expired behind a stall, worker alive mid-stream).
                # Tracked so Client.close() can reap drains still pending.
                task = asyncio.ensure_future(conn.close_when_idle())
                entry = (conn, task)
                self._retiring.add(entry)
                task.add_done_callback(
                    lambda _t, e=entry: self._retiring.discard(e))
        # swap-then-set: waiters hold the OLD event object, so a consumer
        # can never clear() away a notification another waiter needed
        ev, self._changed = self._changed, asyncio.Event()
        ev.set()

    def _add(self, info: dict) -> None:
        inst = Instance(
            instance_id=info["instance_id"],
            host=info["host"],
            port=info["port"],
            subject=info["subject"],
            metadata=info.get("metadata"),
        )
        self._instances[inst.instance_id] = inst
        self._removed.pop(inst.instance_id, None)

    def instance_ids(self) -> list[int]:
        return sorted(self._instances)

    def instances(self) -> list[Instance]:
        return [self._instances[i] for i in self.instance_ids()]

    async def _wait_until(self, pred, timeout: float) -> bool:
        """Await ``pred()`` truth driven by discovery events; False on
        timeout.  Snapshots the CURRENT change event before re-checking
        the predicate — the notifier swaps in a fresh event on every
        change, so a notification between check and wait is never lost."""
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            ev = self._changed
            if pred():
                return True
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return False
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                pass

    async def wait_for_instances(self, n: int = 1, timeout: float = 30.0) -> list[int]:
        """Block until >= n instances are live (ref wait_for_endpoints)."""
        if not await self._wait_until(lambda: len(self._instances) >= n, timeout):
            raise TimeoutError(
                f"only {len(self._instances)}/{n} instances of {self.endpoint.url}"
            )
        return self.instance_ids()

    # --------------------------------------------------------------- routing
    def _conn(self, instance_id: int) -> EndpointTcpClient:
        inst = self._instances.get(instance_id)
        if inst is None:
            raise KeyError(f"instance {instance_id:x} of {self.endpoint.url} not found")
        conn = self._conns.get(instance_id)
        if conn is None:
            conn = EndpointTcpClient(inst.host, inst.port, inst.subject,
                                     net=self.endpoint.runtime._net)
            self._conns[instance_id] = conn
        return conn

    def _candidate_ids(self, exclude: Optional[set] = None) -> list[int]:
        """Live instance ids minus exclusions, with suspect instances
        deprioritized: a suspect id is only eligible when every healthy id
        is also excluded (better a maybe-dead worker than none)."""
        ids = self.instance_ids()
        if exclude:
            ids = [i for i in ids if i not in exclude] or ids
        if self.health is not None:
            healthy = [i for i in ids if not self.health.is_suspect(i)]
            if healthy:
                return healthy
        return ids

    def pick_random(self, exclude: Optional[set] = None) -> int:
        ids = self._candidate_ids(exclude)
        if not ids:
            raise RuntimeError(f"no instances of {self.endpoint.url}")
        return _random.choice(ids)

    def pick_round_robin(self) -> int:
        ids = self._candidate_ids()
        if not ids:
            raise RuntimeError(f"no instances of {self.endpoint.url}")
        # first id strictly after the last pick, wrapping — the first call
        # starts at ids[0] (no pre-increment skip), and a membership change
        # just continues the rotation from the same cursor id
        if self._rr_last is None:
            pick = ids[0]
        else:
            pick = next((i for i in ids if i > self._rr_last), ids[0])
        self._rr_last = pick
        return pick

    def direct(self, request: Context, instance_id: int) -> AsyncIterator[Any]:
        return self._direct_stream(request, instance_id)

    async def _direct_stream(self, request: Context, instance_id: int):
        if instance_id not in self._instances and instance_id not in self._removed:
            # a KV-aware router can learn a worker (via its event plane)
            # a beat before this client's discovery watch does — give
            # discovery a short grace before declaring the id dead.  Ids
            # this client has seen REGISTER AND THEN DELETE get no grace:
            # that worker positively died, and stalling a pinned request
            # 1s per failover would be pure added TTFT.
            await self._wait_until(
                lambda: instance_id in self._instances
                or instance_id in self._removed,
                1.0,
            )
        async for item in self._conn(instance_id).generate(request):
            yield item

    def random(self, request: Context) -> AsyncIterator[Any]:
        return self._routed_stream(request, self.pick_random)

    def round_robin(self, request: Context) -> AsyncIterator[Any]:
        return self._routed_stream(request, self.pick_round_robin)

    async def _routed_stream(self, request: Context, pick):
        if not self._instances:
            # an empty instance map is usually a transient window — a
            # worker still booting, or the coordinator reconnect replaying
            # this watch's delete→put churn — not a dead deployment; give
            # discovery a moment before declaring "no instances"
            await self._wait_until(lambda: self._instances, 3.0)
        async for item in self._conn(pick()).generate(request):
            yield item

    # default AsyncEngine surface = random routing
    def generate(self, request: Context) -> AsyncIterator[Any]:
        return self.random(request)
