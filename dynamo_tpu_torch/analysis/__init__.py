"""The port's analysis planes: so far the protocol plane (dtproto).

``detloop.py`` is the deterministic event loop, schedulers and in-memory
network; ``protocheck.py`` runs the control plane's eight scenarios on
them against the committed ``proto_manifest.json``; ``cli.py`` is
``python -m dynamo_tpu_torch lint --proto``.  The JAX package's other
planes are not ported yet (ROADMAP, Queue A).
"""

from dynamo_tpu_torch.analysis.detloop import (
    DetLoop,
    MemNet,
    PctScheduler,
    RandomScheduler,
    SimulatedCrash,
    run_deterministic,
)
from dynamo_tpu_torch.analysis.protocheck import (
    DEFAULT_PROTO_MANIFEST_PATH,
    PROTO_RULES,
    SCENARIOS,
    CrashPlan,
    ProtoManifest,
    check_proto,
    decode_token,
    encode_token,
    explore_scenario,
    replay_token,
    run_one,
    run_proto,
)

__all__ = [
    "DetLoop",
    "MemNet",
    "PctScheduler",
    "RandomScheduler",
    "SimulatedCrash",
    "run_deterministic",
    "DEFAULT_PROTO_MANIFEST_PATH",
    "PROTO_RULES",
    "SCENARIOS",
    "CrashPlan",
    "ProtoManifest",
    "check_proto",
    "decode_token",
    "encode_token",
    "explore_scenario",
    "replay_token",
    "run_one",
    "run_proto",
]
