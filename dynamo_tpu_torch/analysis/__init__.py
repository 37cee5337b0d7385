"""The port's analysis planes.

- The source planes: ``core.py`` (rule registry, noqa, baseline, the
  per-file driver), ``rules_async.py`` (DT001-DT004) and ``project.py``
  (the interprocedural index, DT005-DT009), against the port's committed
  ``baseline.json``: ``python -m dynamo_tpu_torch lint [--project]``.
- The protocol plane: ``detloop.py`` is the deterministic event loop,
  schedulers and in-memory network; ``protocheck.py`` runs the control
  plane's eight scenarios on them against the committed
  ``proto_manifest.json`` (``lint --proto``).
- The scale-simulation plane: ``loadcheck.py`` sweeps ``load/``'s
  capacity grid against the committed ``load_manifest.json`` (``lint
  --load``).

``cli.py`` is the ``lint`` command.  The JAX package's other planes are
either not port targets or not ported yet (ROADMAP, Queue A).
"""

from dynamo_tpu_torch.analysis.core import (
    DEFAULT_BASELINE_PATH,
    Baseline,
    Finding,
    Rule,
    all_rules,
    lint_file,
    lint_paths,
)
from dynamo_tpu_torch.analysis.detloop import (
    DetLoop,
    MemNet,
    PctScheduler,
    RandomScheduler,
    SimulatedCrash,
    run_deterministic,
)
from dynamo_tpu_torch.analysis.loadcheck import (
    DEFAULT_LOAD_MANIFEST_PATH,
    LOAD_RULES,
    LoadFinding,
    LoadManifest,
    check_load,
    run_load,
)
from dynamo_tpu_torch.analysis.project import (
    ProjectIndex,
    ProjectRule,
    lint_project,
    project_rules,
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
    "DEFAULT_BASELINE_PATH",
    "Baseline",
    "Finding",
    "Rule",
    "all_rules",
    "lint_file",
    "lint_paths",
    "ProjectIndex",
    "ProjectRule",
    "lint_project",
    "project_rules",
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
    "DEFAULT_LOAD_MANIFEST_PATH",
    "LOAD_RULES",
    "LoadFinding",
    "LoadManifest",
    "check_load",
    "run_load",
]
