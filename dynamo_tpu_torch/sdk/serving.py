"""Serve a graph: in-process (tests, ``run``) or supervised subprocesses.

The counterpart of the JAX package's ``sdk/serving.py`` on the port's
runtime.  ``serve_graph`` boots a graph's closure in this process;
``ServeSupervisor`` spawns one ``python -m dynamo_tpu_torch.sdk.serve_worker``
process per service worker and keeps them alive, pinning each to its GPUs
through :class:`GpuAllocator`.

Reference parity: deploy/dynamo/sdk/cli/serving.py (circus arbiter spawning
one process per component worker) + cli/serve_dynamo.py:57 (per-worker
entry registering component endpoints in the DistributedRuntime) +
cli/allocator.py (ResourceAllocator pinning GPUs via CUDA_VISIBLE_DEVICES).

Differences from the JAX package, all on failure or shutdown paths: a
``serve_graph`` whose service fails to boot stops what it already started
before it raises; the supervisor waits for its workers off the event loop
(a coordinator it started shares that loop and must keep answering the
drains), and ``stop`` gives every worker the same drain window as
``_stop_worker`` before a SIGKILL, and returns their exit codes.
"""

from __future__ import annotations

import asyncio
import logging
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.sdk.config import ServiceConfig
from dynamo_tpu_torch.sdk.service import (
    DynamoService,
    EndpointAdapter,
    ServiceClient,
)

log = logging.getLogger("dynamo_tpu_torch.serve")

__all__ = ["serve_graph", "serve_service", "ServeHandle", "ServeSupervisor", "GpuAllocator"]

WORKER_MODULE = "dynamo_tpu_torch.sdk.serve_worker"


# -------------------------------------------------------------- in-process ----


@dataclass
class ServeHandle:
    """Running graph: per-service runtimes + instances; stop() tears down."""

    runtimes: list[DistributedRuntime] = field(default_factory=list)
    instances: dict[str, object] = field(default_factory=dict)  # inner objects by name
    clients: list[ServiceClient] = field(default_factory=list)

    async def stop(self) -> None:
        # instance-level shutdown hooks first (HTTP servers, pull loops)
        for inst in self.instances.values():
            hook = getattr(inst, "shutdown", None)
            if hook is not None:
                try:
                    await hook()
                except Exception:
                    log.exception("instance shutdown failed")
        for c in self.clients:
            await c.close()
        for rt in self.runtimes:
            await rt.shutdown()


async def serve_service(
    svc: DynamoService,
    runtime: DistributedRuntime,
    config: Optional[ServiceConfig] = None,
    handle: Optional[ServeHandle] = None,
    graph: Optional[str] = None,
):
    """Instantiate one service and register its endpoints (the
    serve_dynamo.py:57 analogue).  Returns the inner instance."""
    obj = svc.inner.__new__(svc.inner)
    # wire dependencies before __init__ so constructors may touch them
    for dep in svc.dependencies:
        client = ServiceClient(runtime, dep.target)
        obj.__dict__[f"_dep_{dep.attr}"] = client
        if handle is not None:
            handle.clients.append(client)
    # per-service YAML/env args land on the instance before __init__, and
    # the runtime itself so components can build ad-hoc ServiceClients /
    # reach the coordinator (prefill queue, KV events); the service object
    # + graph module let components follow their own link edges
    obj.service_config = (config or ServiceConfig.from_env()).for_service(svc.name)
    obj.dynamo_runtime = runtime
    obj.dynamo_service = svc
    obj.dynamo_graph = graph
    obj.__init__()

    for hook in svc.on_start_hooks:
        await getattr(obj, hook)()

    component = runtime.namespace(svc.namespace).component(svc.component)
    for spec in svc.endpoints:
        adapter = EndpointAdapter(getattr(obj, spec.method))
        await component.endpoint(spec.name).serve(adapter)
    return obj


async def serve_graph(
    entry: DynamoService,
    config: Optional[ServiceConfig] = None,
    runtime_config: Optional[RuntimeConfig] = None,
    graph: Optional[str] = None,
) -> ServeHandle:
    """Serve the entry's whole closure in this process (one runtime + lease
    per service, like separate workers would hold) — the test seam the
    reference gets from its sdk test pipeline (tests/test_e2e.py).

    ``graph``: the graph MODULE name whose link edges define the closure
    — pass it whenever this process may have imported other graph modules
    (they all mutate the shared component classes; see closure()).

    A service that fails to boot raises here, after the services already
    booted (and the failed one's runtime) are stopped."""
    if graph is not None and entry._links and len(entry.boot_order(graph)) == 1 \
            and len(entry.boot_order()) > 1:
        # a typo'd / mismatched module name would otherwise silently
        # deploy a one-node graph
        raise ValueError(
            f"graph {graph!r} matches no link edges from {entry.name} "
            f"(edges were created by "
            f"{sorted({m for _, m in entry._links if m})}); pass the "
            "module that built this graph's chain"
        )
    handle = ServeHandle()
    try:
        # dependencies first so their endpoints exist when dependents boot
        for svc in entry.boot_order(graph):
            rt = await DistributedRuntime.connect(runtime_config)
            handle.runtimes.append(rt)
            obj = await serve_service(svc, rt, config, handle, graph=graph)
            handle.instances[svc.name] = obj
    except BaseException:
        await handle.stop()
        raise
    return handle


# ------------------------------------------------------------- gpu allocator ----


class GpuAllocator:
    """Assign GPUs to worker processes (ResourceAllocator parity,
    cli/allocator.py:136; the counterpart of the JAX package's
    ``TpuAllocator``).

    Pool from DYNTPU_GPUS ("0,1,2,3"; an entry may repeat, and two workers
    given the same index share that card); a service asking
    resources={"gpu": n} gets n entries, expressed to the child as
    CUDA_VISIBLE_DEVICES.  A service asking for none gets an empty
    CUDA_VISIBLE_DEVICES, so the frontend, processor and router never open
    a CUDA context.
    """

    def __init__(self, gpus: Optional[list[int]] = None):
        if gpus is None:
            raw = os.environ.get("DYNTPU_GPUS", "")
            gpus = [int(c) for c in raw.split(",") if c.strip()] if raw else []
        self.free = list(gpus)

    def allocate(self, svc: DynamoService) -> dict[str, str]:
        """Allocate one *worker's* GPUs (call once per worker process)."""
        want = int(svc.resources.get("gpu", 0))
        if want == 0:
            return {"CUDA_VISIBLE_DEVICES": ""}
        if len(self.free) < want:
            raise RuntimeError(
                f"service {svc.name} wants {want} GPUs, only {len(self.free)} free"
            )
        mine, self.free = self.free[:want], self.free[want:]
        return {"CUDA_VISIBLE_DEVICES": ",".join(map(str, mine))}

    def release(self, env_extra: dict[str, str]) -> None:
        """Return a dead worker's GPUs to the pool."""
        gpus = env_extra.get("CUDA_VISIBLE_DEVICES", "")
        if gpus:
            self.free.extend(int(c) for c in gpus.split(","))


# ------------------------------------------------------------- supervisor ----


class ServeSupervisor:
    """Spawn one OS process per service worker and keep them alive
    (the circus-arbiter analogue, serving.py:243)."""

    def __init__(
        self,
        graph: str,  # "package.module:EntryService"
        config: Optional[ServiceConfig] = None,
        coordinator_url: Optional[str] = None,
        restart: bool = True,
        drain_grace_s: float = 12.0,
    ):
        self.graph = graph
        self.config = config or ServiceConfig()
        self.coordinator_url = coordinator_url
        self.restart = restart
        # SIGTERM → serve_worker drains (discovery delete, finish streams)
        # → exits; only after this window does the supervisor SIGKILL
        self.drain_grace_s = drain_grace_s
        self.procs: dict[str, subprocess.Popen] = {}
        self._envs: dict[str, dict[str, str]] = {}  # per-worker env_extra for respawn
        self._coordinator = None
        self.allocator = GpuAllocator()

    def _load_entry(self) -> DynamoService:
        import importlib

        mod_name, _, attr = self.graph.partition(":")
        sys.path.insert(0, os.getcwd())
        entry = getattr(importlib.import_module(mod_name), attr)
        if not isinstance(entry, DynamoService):
            raise TypeError(f"{self.graph} is not a @service")
        return entry

    async def start(self) -> None:
        if self.coordinator_url is None:
            from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorServer

            self._coordinator = await CoordinatorServer(port=0).start()
            self.coordinator_url = self._coordinator.url
        entry = self._load_entry()
        for svc in entry.boot_order(self.graph.partition(":")[0]):
            for worker_idx in range(svc.workers):
                # each worker process gets its own GPUs from the pool
                self._spawn(svc, worker_idx, self.allocator.allocate(svc))

    def _spawn(self, svc: DynamoService, worker_idx: int, env_extra: dict) -> None:
        env = dict(os.environ)
        env.update(env_extra)
        env.update(self.config.to_env())
        env["DYNTPU_COORDINATOR"] = self.coordinator_url
        # worker drains strictly inside our SIGKILL escalation window
        env.setdefault("DYNTPU_DRAIN_GRACE_S",
                       str(max(1.0, self.drain_grace_s - 2.0)))
        key = f"{svc.name}:{worker_idx}"
        self._envs[key] = dict(env_extra)
        self.procs[key] = subprocess.Popen(
            [sys.executable, "-m", WORKER_MODULE, self.graph, svc.name],
            env=env,
        )
        log.info("spawned %s (pid %s)", key, self.procs[key].pid)

    async def _reap(self, key: str, proc: subprocess.Popen) -> int:
        """Wait (off the loop) for a terminated worker's exit, SIGKILLing
        it after drain_grace_s; returns its exit code."""
        try:
            code = await asyncio.to_thread(proc.wait, timeout=self.drain_grace_s)
        except subprocess.TimeoutExpired:
            log.warning("%s did not drain in %.1fs; killing", key, self.drain_grace_s)
            proc.kill()
            code = await asyncio.to_thread(proc.wait)
        log.info("stopped %s (exit %s)", key, code)
        return code

    async def _stop_worker(self, key: str) -> None:
        """Gracefully stop one worker and return its GPUs; popped from
        procs FIRST so watch() can never mistake the exit for a crash.
        SIGTERM triggers the worker's drain lifecycle (serve_worker.py:
        deregister from discovery, finish in-flight streams); SIGKILL only
        lands after drain_grace_s — so a downscale completes live requests
        instead of amputating them."""
        proc = self.procs.pop(key, None)
        if proc is None:
            return
        proc.terminate()
        await self._reap(key, proc)
        self.allocator.release(self._envs.pop(key, {}))

    async def scale(self, service_name: str, replicas: int) -> int:
        """Level one service's worker-process count toward ``replicas``
        (a prefill↔decode role flip is one pool scaling down while the
        other scales up, GPUs flowing through the allocator).  Returns the
        new count."""
        replicas = max(0, int(replicas))
        entry = self._load_entry()
        by_name = {s.name: s for s in entry.closure(self.graph.partition(":")[0])}
        svc = by_name.get(service_name)
        if svc is None:
            raise KeyError(f"service {service_name!r} not in graph {self.graph}")
        mine = sorted(
            (k for k in self.procs if k.rsplit(":", 1)[0] == service_name),
            key=lambda k: int(k.rsplit(":", 1)[1]),
        )
        # scale down: stop highest worker indices first
        for key in mine[replicas:][::-1]:
            await self._stop_worker(key)
        # scale up: fill the missing indices
        have = {int(k.rsplit(":", 1)[1]) for k in self.procs
                if k.rsplit(":", 1)[0] == service_name}
        for idx in range(replicas):
            if idx not in have:
                self._spawn(svc, idx, self.allocator.allocate(svc))
        return sum(1 for k in self.procs
                   if k.rsplit(":", 1)[0] == service_name)

    async def watch(self) -> None:
        """Restart crashed workers until stop() (watcher loop parity)."""
        entry = self._load_entry()
        by_name = {s.name: s for s in entry.closure(self.graph.partition(":")[0])}
        while self.procs:
            await asyncio.sleep(0.5)
            for key, proc in list(self.procs.items()):
                code = proc.poll()
                if code is None:
                    continue
                name, _, idx = key.partition(":")
                if self.restart and code != 0:
                    log.warning("%s exited %s — restarting", key, code)
                    # respawn with the same GPU pinning
                    self._spawn(by_name[name], int(idx), self._envs[key])
                else:
                    del self.procs[key]
                    self.allocator.release(self._envs.pop(key, {}))

    async def stop(self) -> dict[str, int]:
        """SIGTERM every worker, wait for their drains (SIGKILL after
        drain_grace_s) and stop the coordinator this supervisor started.
        Returns each worker's exit code by ``Service:index``."""
        procs, self.procs = dict(self.procs), {}
        for proc in procs.values():
            proc.terminate()
        codes = await asyncio.gather(*(self._reap(k, p) for k, p in procs.items()))
        for key in procs:
            self.allocator.release(self._envs.pop(key, {}))
        if self._coordinator:
            await self._coordinator.stop()
            self._coordinator = None
        return dict(zip(procs, codes))
