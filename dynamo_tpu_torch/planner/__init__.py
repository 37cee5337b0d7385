"""The planner subsystem: admission control for the HTTP frontend
(``admission.py``), the pure planning policy over live ForwardPassMetrics
(``policy.py``) and its loop and actuators (``core.py``: the log, the sdk
supervisor, the persist pre-warm hint).

The counterpart of ``dynamo_tpu/planner/``, with the same exports.
"""

from dynamo_tpu_torch.planner.admission import (
    AdmissionConfig,
    AdmissionController,
    AdmissionRejected,
    PriorityClass,
    TokenBucket,
)
from dynamo_tpu_torch.planner.core import (
    LogActuator,
    PlannerLoop,
    PrewarmActuator,
    SupervisorActuator,
)
from dynamo_tpu_torch.planner.policy import (
    MetricsSnapshot,
    Plan,
    PlannerConfig,
    PlannerPolicy,
    PolicyState,
    PoolSnapshot,
    WorkerSample,
    decode_replica_target,
    plan,
    prefill_replica_target,
    step_replicas,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionRejected",
    "PriorityClass",
    "TokenBucket",
    "LogActuator",
    "PlannerLoop",
    "PrewarmActuator",
    "SupervisorActuator",
    "MetricsSnapshot",
    "Plan",
    "PlannerConfig",
    "PlannerPolicy",
    "PolicyState",
    "PoolSnapshot",
    "WorkerSample",
    "decode_replica_target",
    "plan",
    "prefill_replica_target",
    "step_replicas",
]
