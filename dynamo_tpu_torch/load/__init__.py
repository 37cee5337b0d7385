"""dtload — scale-simulation plane (macro-simulation at virtual time).

The counterpart of the JAX package's ``load/``.  It extends the protocol
plane's DetLoop from correctness checking to capacity measurement: the
port's REAL control-plane components (KvIndexer, KvScheduler,
AdmissionController, planner policy) run against simulated workers whose
dispatch durations come from the H100's own serving figures (the
committed ``load/card_latency.json``), under production-shaped traffic
from a seeded generator.  A ten-minute, many-thousand-request trace runs in
seconds of wall clock, byte-identically per seed.

    load/traffic.py   seeded scenario generator (sessions, Zipf tenants,
                      diurnal ramps, bursts, failure storms)
    load/workers.py   LatencyModel (from load/card_latency.json)
                      + SimWorker (slot-gated, time-sliced, KV-evicting)
    load/sim.py       the harness: run_cell / sweep over topologies and
                      offered-load levels

The capacity gate lives in analysis/loadcheck.py (`python -m dynamo_tpu_torch lint
--load`, rules LD001-LD005 against analysis/load_manifest.json).
"""

from dynamo_tpu_torch.load.traffic import (
    FAMILIES,
    Request,
    ScenarioSpec,
    arrival_histogram,
    generate,
    prefix_share,
    tenant_mass,
)
from dynamo_tpu_torch.load.workers import LatencyModel, SimWorker, SimWorkerDied
from dynamo_tpu_torch.load.sim import (
    LOAD_LEVELS,
    TOPOLOGIES,
    Topology,
    canonical_bytes,
    run_cell,
    sweep,
)

__all__ = [
    "FAMILIES",
    "Request",
    "ScenarioSpec",
    "arrival_histogram",
    "generate",
    "prefix_share",
    "tenant_mass",
    "LatencyModel",
    "SimWorker",
    "SimWorkerDied",
    "LOAD_LEVELS",
    "TOPOLOGIES",
    "Topology",
    "canonical_bytes",
    "run_cell",
    "sweep",
]
