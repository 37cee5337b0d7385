"""Process-global fault-plane counters.

A copy of the JAX package's ``fault/counters.py``.  Kept dependency-free
so both the runtime layer (Endpoint.drain) and the llm layer
(http/metrics.py render) can import them without cycles.  The HTTP
metrics endpoint exposes these as:

    dynamo_tpu_fault_migrations_total      counter
    dynamo_tpu_fault_drains_in_progress    gauge
    dynamo_tpu_fault_suspect_instances     gauge
"""

from __future__ import annotations

from typing import Callable, Iterable

__all__ = ["FaultCounters", "counters"]


class FaultCounters:
    def __init__(self) -> None:
        self.migrations_total = 0
        self.drains_in_progress = 0
        # live suspect-set providers (HealthMonitor registers itself);
        # callables so the gauge reads current state, not a stale count
        self._suspect_sources: list[Callable[[], Iterable[int]]] = []

    def register_suspect_source(self, source: Callable[[], Iterable[int]]) -> None:
        self._suspect_sources.append(source)

    def unregister_suspect_source(self, source: Callable[[], Iterable[int]]) -> None:
        try:
            self._suspect_sources.remove(source)
        except ValueError:
            pass

    def suspect_instances(self) -> int:
        seen: set[int] = set()
        for source in self._suspect_sources:
            try:
                seen.update(source())
            except Exception:
                continue
        return len(seen)

    def reset(self) -> None:
        """Test isolation hook — the counters are process-global."""
        self.migrations_total = 0
        self.drains_in_progress = 0
        self._suspect_sources.clear()


counters = FaultCounters()
