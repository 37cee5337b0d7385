"""Multi-process runtime: one rank mesh spanning processes and hosts.

The counterpart of ``dynamo_tpu/runtime/multihost.py``.  JAX runs one
process per host and ``jax.distributed`` makes the devices of every host
one device list; the port runs one process per rank (``torch.distributed``),
so the same bootstrap joins ranks instead of hosts:

  1. every rank knows (group, num_processes, process_id) — the JAX package's
     ``DYN_MH_*`` variables, read by :func:`spec_from_env`;
  2. rank 0 starts the world's ``TCPStore`` and publishes its address under
     ``mh/{group}/torch_store`` in the control plane (the coordinator's KV
     store, beside the JAX package's ``mh/{group}/jax_coordinator``), with a
     ``kv_create`` as the JAX package does, so a restart cannot clobber a
     live rendezvous; an explicit ``store_addr`` (``DYN_MH_STORE``) skips
     the rendezvous, as ``run --tp N`` on one host does for the followers it
     starts;
  3. every rank calls ``init_process_group`` over that store; after that
     ``utils/mesh.py::build_mesh`` lays the world out on the mesh axes.

The backend is NCCL on CUDA and gloo on the CPU.  gloo on CUDA is used only
when ``DYN_MH_BACKEND=gloo`` (or ``spec.backend``) names it: NCCL refuses two
ranks on one card, and the bootstrap raises, naming the card, before NCCL is
asked.  Nothing switches backends by itself.  A single-process spec is a
no-op.
"""

from __future__ import annotations

import asyncio
import datetime
import os
import socket
import time
from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["MultiHostSpec", "bootstrap", "global_mesh", "spec_from_env", "shutdown",
           "STORE_KEY", "IDLE_TIMEOUT_S"]

# the control-plane key of a group's TCPStore address
STORE_KEY = "mh/{group}/torch_store"

# an idle server's followers wait in a broadcast for the next dispatch: the
# world's collectives must not time out while no request arrives
IDLE_TIMEOUT_S = 7 * 24 * 3600.0


@dataclass
class MultiHostSpec:
    num_processes: int = 1
    process_id: int = 0
    group: str = "default"
    # control-plane URL for the rendezvous (tcp://host:port); unused when
    # store_addr is given
    coordinator_url: Optional[str] = None
    # explicit TCPStore address host:port (skips the rendezvous)
    store_addr: Optional[str] = None
    # "nccl" or "gloo"; None: NCCL on CUDA, gloo on the CPU
    backend: Optional[str] = None
    # how long a collective may wait for its peers (an idle server's
    # followers wait for the next dispatch); a test world sets it short, so
    # a desynchronised world fails instead of hanging
    timeout_s: float = IDLE_TIMEOUT_S

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1


def spec_from_env() -> MultiHostSpec:
    """A spec from the ``DYN_MH_*`` variables (what ``run --tp/--nnodes``
    exports for its rank processes)."""
    return MultiHostSpec(
        num_processes=int(os.environ.get("DYN_MH_NPROCS", "1")),
        process_id=int(os.environ.get("DYN_MH_RANK", "0")),
        group=os.environ.get("DYN_MH_GROUP", "default"),
        coordinator_url=os.environ.get("DYN_MH_COORDINATOR"),
        store_addr=os.environ.get("DYN_MH_STORE"),
        backend=os.environ.get("DYN_MH_BACKEND") or None,
        timeout_s=float(os.environ.get("DYN_MH_TIMEOUT_S", IDLE_TIMEOUT_S)),
    )


def free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _host_ip(coordinator_url: str) -> str:
    """This host's address as the other ranks reach it (the TCPStore rank 0
    serves): loopback when the coordinator itself is on loopback (every rank
    is on this host), else the address this host's name resolves to."""
    from urllib.parse import urlparse

    if (urlparse(coordinator_url).hostname or "") in ("127.0.0.1", "localhost", "::1"):
        return "127.0.0.1"
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


async def _rendezvous(spec: MultiHostSpec, timeout: float) -> str:
    """Rank 0 publishes its TCPStore address; the others wait for it."""
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient

    key = STORE_KEY.format(group=spec.group)
    client = await CoordinatorClient(spec.coordinator_url).connect()
    try:
        if spec.process_id == 0:
            addr = f"{_host_ip(spec.coordinator_url)}:{free_port()}"
            # kv_create: a stale address from a dead group must not linger
            if not await client.kv_create(key, addr):
                await client.kv_put(key, addr)
            return addr
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            addr = await client.kv_get(key)
            if addr:
                return str(addr)
            await asyncio.sleep(0.1)
        raise TimeoutError(f"rendezvous key {key} not published within {timeout}s")
    finally:
        await client.close()


def _run_sync(coro):
    """Run a coroutine to completion whether or not the caller is already in
    an event loop."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        return ex.submit(asyncio.run, coro).result()


def _backend(spec: MultiHostSpec, device: torch.device) -> str:
    backend = spec.backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"DYN_MH_BACKEND must be nccl or gloo, not {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, this rank has {device}")
    return backend


def _check_devices(store, spec: MultiHostSpec, device: torch.device) -> None:
    """NCCL runs one rank per card: raise, naming the card, when two ranks
    of the world hold the same one."""
    props = torch.cuda.get_device_properties(device)
    mine = f"{socket.gethostname()}/{props.uuid}"
    store.set(f"device/{spec.process_id}", mine)
    for r in range(spec.num_processes):
        if r == spec.process_id:
            continue
        other = store.get(f"device/{r}").decode()
        if other == mine:
            raise RuntimeError(
                f"ranks {min(r, spec.process_id)} and {max(r, spec.process_id)} share "
                f"{device} ({props.name}, {props.uuid}): NCCL refuses two ranks on one card; "
                "give each rank its own card, or set DYN_MH_BACKEND=gloo")


def bootstrap(spec: MultiHostSpec, device=None, timeout: float = 120.0) -> Optional[str]:
    """Join this process into the world as rank ``spec.process_id`` on
    ``device`` (cuda unless named).  Returns the backend, or None for a
    single-process spec, which is a no-op."""
    if not spec.is_multihost:
        return None
    import torch.distributed as dist

    from dynamo_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    backend = _backend(spec, dev)
    addr = spec.store_addr
    if addr is None:
        if spec.coordinator_url is None:
            raise ValueError("a multi-process bootstrap needs coordinator_url or store_addr")
        addr = _run_sync(_rendezvous(spec, timeout))
    host, port = addr.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), spec.num_processes, is_master=spec.process_id == 0,
                          timeout=datetime.timedelta(seconds=timeout))
    if backend == "nccl":
        _check_devices(store, spec, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=spec.process_id,
                            world_size=spec.num_processes,
                            timeout=datetime.timedelta(seconds=spec.timeout_s))
    return backend


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], device=None):
    """The mesh over the whole world (every host's ranks): a thin alias of
    ``utils/mesh.py::build_mesh``, so the runtime and the sharding specs
    build the same mesh."""
    from dynamo_tpu_torch.utils.mesh import build_mesh

    return build_mesh(shape, axis_names, device=device)
