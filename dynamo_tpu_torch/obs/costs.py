"""Measured KV-transfer cost tables.

Every KV movement on the serving path records ``(src, dst, path,
bytes, seconds)`` here:

    path="ici"      LocalKvTransferClient — the colocated shortcut
                    (in-process; on one H100 an on-card device copy:
                    the label is the JAX package's, kept so the two
                    packages' tables and metrics read alike)
    path="dcn"      KvTransferClient over TCP — the cross-host DCN hop
    path="persist"  persist-tier restore (shared-store read +
                    restore-through-host)

Per key the table keeps lifetime totals plus an EWMA of throughput
(MB/s) and per-call latency — the measured cost term NetKV-style
transfer-aware disagg routing needs (`overlap − kv_usage − slot_usage
− transfer_cost`, ROADMAP item 1).  Exported on ``/metrics`` as

    dynamo_tpu_kv_transfer_calls_total{src,dst,path}
    dynamo_tpu_kv_transfer_bytes_total{src,dst,path}
    dynamo_tpu_kv_transfer_seconds_total{src,dst,path}
    dynamo_tpu_kv_transfer_mbps{src,dst,path}           (EWMA)
    dynamo_tpu_kv_transfer_latency_ms{src,dst,path}     (EWMA)

Process-global singleton, same idiom as ``engine/counters.py``: the
kv layer records, the http layer renders, benchmarks read.

A copy of the JAX package's ``obs/costs.py`` but for its cold-edge priors,
which the JAX package draws from its TPU topology table: here they are
:data:`PRIORS`, the H100's published HBM rate for the on-card copy and
assumed link rates for the others.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

__all__ = ["PRIORS", "TransferCostTable", "prior_cost_s", "transfer_costs"]

# Cold-edge priors per path: (bytes/s, latency s).  "ici": an on-card copy
# reads and writes each byte once, so half the H100's published 3.35 TB/s
# of HBM; "dcn": an assumed 25 Gbps NIC; "persist": an assumed 1 GB/s
# shared-store read.  None of these is a measurement: the first recorded
# transfer on an edge replaces its prior.
PRIORS = {
    "ici": (3.35e12 / 2, 10e-6),
    "dcn": (3.125e9, 50e-6),
    "persist": (1e9, 1e-3),
}
# derate on the priors: real transfers pay serialization and host hops
# that a link rate ignores, so a prior under-promises
_PRIOR_EFFICIENCY = 0.6


def prior_cost_s(path: str, nbytes: int) -> float:
    """Heuristic seconds to move ``nbytes`` over a never-measured path:
    latency floor + derated-rate term (unknown paths get the slowest)."""
    bw, lat = PRIORS.get(path, PRIORS["persist"])
    return lat + nbytes / (bw * _PRIOR_EFFICIENCY)


class TransferCostTable:
    def __init__(self, alpha: float = 0.2,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._alpha = alpha
        # injectable so the load plane's macro-simulation can run the
        # EWMAs at DetLoop virtual time instead of silently mixing
        # wall-clock into a simulated trace
        self._clock = clock
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Test isolation hook."""
        # (src, dst, path) -> dict of running stats
        self.table: dict[tuple, dict] = {}

    def record(self, src: str, dst: str, path: str,
               nbytes: int, seconds: float) -> None:
        if seconds <= 0:
            seconds = 1e-9  # clock granularity floor; keep the sample
        mbps = nbytes / seconds / 1e6
        key = (src, dst, path)
        a = self._alpha
        now = self._clock()
        with self._lock:
            e = self.table.get(key)
            if e is None:
                self.table[key] = {
                    "calls": 1, "bytes": nbytes, "seconds": seconds,
                    "ewma_mbps": mbps, "ewma_latency_s": seconds,
                    "updated_at": now,
                }
                return
            e["calls"] += 1
            e["bytes"] += nbytes
            e["seconds"] += seconds
            e["ewma_mbps"] = (1 - a) * e["ewma_mbps"] + a * mbps
            e["ewma_latency_s"] = (1 - a) * e["ewma_latency_s"] + a * seconds
            e["updated_at"] = now

    def cost_s(self, src: str, dst: str, path: str,
               nbytes: int) -> float:
        """Predicted seconds to move ``nbytes`` over an edge.

        Measured edges use the EWMA throughput.  Never-observed edges
        fall back to the prior (derated link rate + latency,
        :func:`prior_cost_s`) so transfer-aware
        routing always has a finite cost instead of a cold-miss
        surprise; the first real transfer replaces the prior.  Use
        :meth:`measured` to distinguish the two.
        """
        with self._lock:
            e = self.table.get((src, dst, path))
            if e is None or e["ewma_mbps"] <= 0:
                return prior_cost_s(path, nbytes)
            return nbytes / (e["ewma_mbps"] * 1e6)

    def measured(self, src: str, dst: str, path: str) -> bool:
        """True when the edge has at least one recorded transfer (so
        ``cost_s`` is measurement, not the prior)."""
        with self._lock:
            return (src, dst, path) in self.table

    def snapshot(self) -> dict[tuple, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self.table.items()}


transfer_costs = TransferCostTable()
