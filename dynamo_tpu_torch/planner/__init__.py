"""The planner subsystem's admission control for the HTTP frontend.

The counterpart of ``dynamo_tpu/planner/``'s admission half
(``admission.py``: per-tenant rate limits, priority classes,
deadline-aware shedding).  The planning policy and its actuators
(``policy.py``, ``core.py``) are not ported yet (ROADMAP A17).
"""

from dynamo_tpu_torch.planner.admission import (
    AdmissionConfig,
    AdmissionController,
    AdmissionRejected,
    PriorityClass,
    TokenBucket,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionRejected",
    "PriorityClass",
    "TokenBucket",
]
