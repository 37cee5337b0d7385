"""The port's analysis planes.

- The source planes: ``core.py`` (rule registry, noqa, baseline, the
  per-file driver), ``rules_async.py`` (DT001-DT004), ``rules_torch.py``
  (the hot-path rules, DT101-DT105) and ``project.py`` (the
  interprocedural index, DT005-DT009), against the port's committed
  ``baseline.json``: ``python -m dynamo_tpu_torch lint [--project]``.
- The protocol plane: ``detloop.py`` is the deterministic event loop,
  schedulers and in-memory network; ``protocheck.py`` runs the control
  plane's eight scenarios on them against the committed
  ``proto_manifest.json`` (``lint --proto``).
- The scale-simulation plane: ``loadcheck.py`` sweeps ``load/``'s
  capacity grid against the committed ``load_manifest.json`` (``lint
  --load``).
- The wire plane: ``wirecheck.py`` extracts the cross-process message
  contracts (WR001-WR007) against the committed ``wire_manifest.json``
  (``lint --wire``).
- The metrics plane: ``metcheck.py`` audits the /metrics surface
  (MT001-MT005) against the committed ``metrics_manifest.json``,
  ``obs/metric_names.SCHEMA`` and ``docs/torch_observability.md``
  (``lint --metrics``).
- The kernel plane: ``kerncheck.py`` audits the CUDA kernels of
  ``ops/kernels/registry.py`` (KN001-KN006: budgets, plan walks, the plain
  versions' NaN-poisoned padding oracles, work and plan costs, the census)
  against the committed ``kern_manifest.json`` (``lint --kern``).
- The perf plane: ``perfcheck.py`` prices every step function on meta
  tensors against the H100's rates (PF001-PF004) against the committed
  ``perf_manifest.json`` (``lint --perf``); ``/metrics`` renders its
  predictions as ``dynamo_tpu_perf_predicted_step_ms``.
- The compile plane: ``tracecheck.py`` holds the entry points' dispatch
  signature census, in-place cache writes, f32 upcasts and footprint
  (TR001-TR007) against the committed ``trace_manifest.json`` (``lint
  --trace``), and records a run's dispatches against its declared matrix.
- The sharding plane: ``shardcheck.py`` holds what each rank of the
  (1, 4) audit mesh holds, rank 0's collectives a decode turn and each
  rank's in-place cache write (SH001-SH005) against the committed
  ``shard_manifest.json`` (``lint --shard``).
- The runtime sanitizer (dtsan): ``sanitizer.py`` (task leaks, blocking
  callbacks, unclosed transports, the framing guard) and its standalone
  pytest plugin ``pytest_sanitizer.py``.

``cli.py`` is the ``lint`` command; ``lint --all`` runs the ten passes.
The perf, trace and shard planes read one registry of entry points
(``perfcheck.build_perf_registry``) and walk it the same way
(``perfcheck.walk``).
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
from dynamo_tpu_torch.analysis.kerncheck import (
    DEFAULT_KERN_MANIFEST_PATH,
    KERN_RULES,
    check_kern_facts,
    collect_kern_facts,
    run_kern,
)
from dynamo_tpu_torch.analysis.loadcheck import (
    DEFAULT_LOAD_MANIFEST_PATH,
    LOAD_RULES,
    LoadFinding,
    LoadManifest,
    check_load,
    run_load,
)
from dynamo_tpu_torch.analysis.metcheck import (
    DEFAULT_METRICS_MANIFEST_PATH,
    MET_RULES,
    MetricFinding,
    MetricsManifest,
    check_metric_facts,
    collect_metric_facts,
    run_metrics,
)
from dynamo_tpu_torch.analysis.perfcheck import (
    DEFAULT_PERF_MANIFEST_PATH,
    PERF_RULES,
    check_perf_facts,
    collect_perf_facts,
    manifest_predictions,
    run_perf,
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
from dynamo_tpu_torch.analysis.sanitizer import (
    MODE_FULL,
    MODE_LEAKS,
    MODE_OFF,
    FramingGuard,
    Sanitizer,
    mode_from_env,
)
from dynamo_tpu_torch.analysis.shardcheck import (
    DEFAULT_SHARD_MANIFEST_PATH,
    SHARD_RULES,
    check_shard_facts,
    collect_shard_facts,
    run_shard,
)
from dynamo_tpu_torch.analysis.tracecheck import (
    DEFAULT_TRACE_MANIFEST_PATH,
    TRACE_RULES,
    check_trace_facts,
    collect_trace_facts,
    record_dispatches,
    run_trace,
)
from dynamo_tpu_torch.analysis.wirecheck import (
    DEFAULT_WIRE_MANIFEST_PATH,
    WIRE_RULES,
    WireFinding,
    WireManifest,
    check_wire,
    collect_wire_facts,
    run_wire,
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
    "DEFAULT_WIRE_MANIFEST_PATH",
    "WIRE_RULES",
    "WireFinding",
    "WireManifest",
    "check_wire",
    "collect_wire_facts",
    "run_wire",
    "DEFAULT_METRICS_MANIFEST_PATH",
    "MET_RULES",
    "MetricFinding",
    "MetricsManifest",
    "check_metric_facts",
    "collect_metric_facts",
    "run_metrics",
    "DEFAULT_KERN_MANIFEST_PATH",
    "KERN_RULES",
    "check_kern_facts",
    "collect_kern_facts",
    "run_kern",
    "DEFAULT_PERF_MANIFEST_PATH",
    "PERF_RULES",
    "check_perf_facts",
    "collect_perf_facts",
    "manifest_predictions",
    "run_perf",
    "DEFAULT_TRACE_MANIFEST_PATH",
    "TRACE_RULES",
    "check_trace_facts",
    "collect_trace_facts",
    "record_dispatches",
    "run_trace",
    "DEFAULT_SHARD_MANIFEST_PATH",
    "SHARD_RULES",
    "check_shard_facts",
    "collect_shard_facts",
    "run_shard",
    "MODE_FULL",
    "MODE_LEAKS",
    "MODE_OFF",
    "FramingGuard",
    "Sanitizer",
    "mode_from_env",
]
