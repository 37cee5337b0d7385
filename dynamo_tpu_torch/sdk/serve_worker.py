"""Per-process worker entry (ref cli/serve_dynamo.py:57): connect to the
coordinator, serve ONE service's endpoints, run until terminated.

The counterpart of the JAX package's ``sdk/serve_worker.py``.  Usage
(spawned by ServeSupervisor): python -m dynamo_tpu_torch.sdk.serve_worker
<module:Entry> <ServiceName>; env: DYNTPU_COORDINATOR, DYNTPU_SERVICE_CONFIG,
DYNTPU_DRAIN_GRACE_S.  Every log line carries the service's name, as the
supervisor's workers share its output.  On SIGTERM or SIGINT the worker
drains, then runs the instance's ``shutdown`` hook (the engine thread, an
HTTP server, a pull loop), which the JAX worker leaves to process exit, and
exits 0.
"""

from __future__ import annotations

import asyncio
import importlib
import logging
import os
import signal
import sys

from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.sdk.config import ServiceConfig
from dynamo_tpu_torch.sdk.serving import serve_service

log = logging.getLogger("dynamo_tpu_torch.serve_worker")


async def amain(graph: str, service_name: str) -> None:
    mod_name, _, attr = graph.partition(":")
    sys.path.insert(0, os.getcwd())
    entry = getattr(importlib.import_module(mod_name), attr)
    svc = next(s for s in entry.closure(mod_name) if s.name == service_name)

    # the handlers go in before the service does: a stop that arrives
    # while the service starts (it may already answer requests) drains it
    # once it is up instead of killing the process
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    cfg = RuntimeConfig(coordinator_url=os.environ["DYNTPU_COORDINATOR"])
    runtime = await DistributedRuntime.connect(cfg)
    obj = await serve_service(svc, runtime, ServiceConfig.from_env(), graph=mod_name)
    log.info("%s serving (pid %s)", service_name, os.getpid())
    await stop.wait()
    # graceful drain: discovery keys go first so routing stops sending
    # work, in-flight streams finish, then the transport stops — a
    # supervisor downscale never amputates live requests.  Grace bounded
    # below the supervisor's SIGKILL escalation window.
    grace = float(os.environ.get("DYNTPU_DRAIN_GRACE_S", "10"))
    try:
        await asyncio.wait_for(runtime.drain_all(timeout=grace), grace + 2)
    except asyncio.TimeoutError:
        log.warning("%s drain timed out after %.1fs", service_name, grace)
    hook = getattr(obj, "shutdown", None)
    if hook is not None:
        await hook()
    await runtime.shutdown()
    log.info("%s drained and stopped", service_name)


def main() -> None:
    graph, service_name = sys.argv[1], sys.argv[2]
    logging.basicConfig(level=logging.INFO,
                        format=f"[{service_name}] %(levelname)s %(name)s: %(message)s")
    asyncio.run(amain(graph, service_name))


if __name__ == "__main__":
    main()
