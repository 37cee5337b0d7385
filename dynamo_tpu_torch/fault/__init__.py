"""The fault plane: request migration, health probes, graceful drain.

The counterpart of ``dynamo_tpu/fault/``, on the port's distributed
runtime and TCP request plane:

  * :class:`MigratingClient`  — mid-stream request migration + connect
    retry over a ``runtime.distributed.Client`` (migration.py)
  * :class:`HealthMonitor`    — active ping probes over the TCP request
    plane; marks instances *suspect* seconds before their coordinator
    lease would expire (health.py)
  * ``Endpoint.drain()`` / ``DistributedRuntime.drain_all()`` — the
    graceful-drain lifecycle lives on runtime.distributed; this package
    carries its counters
  * :class:`FaultInjector`    — deterministic fault injection for tests
    and the soak harness (injector.py)

As in the JAX package, nothing in the serving commands wires a
``MigratingClient`` or a ``HealthMonitor``: a caller wraps its client in
them (the tests and ``chip_smoke.py`` do).
"""

from dynamo_tpu_torch.fault.counters import FaultCounters, counters
from dynamo_tpu_torch.fault.health import HealthMonitor
from dynamo_tpu_torch.fault.injector import FaultInjector
from dynamo_tpu_torch.fault.migration import MigrationExhausted, MigratingClient

__all__ = [
    "MigratingClient",
    "MigrationExhausted",
    "HealthMonitor",
    "FaultInjector",
    "FaultCounters",
    "counters",
]
