"""KV-cache-aware smart routing: the counterpart of ``dynamo_tpu/llm/kv_router/``.

Workers publish cache events (stored/removed block hashes, device and
persistent tiers) and load metrics; the router keeps a global index of
which worker holds which prefix blocks and scores workers by overlap vs
load for each incoming request.  The wire (subjects, event and metrics
payloads, recordings) is the JAX package's.
"""

from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, OverlapScores
from dynamo_tpu_torch.llm.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvScheduler,
    WorkerMetrics,
)
from dynamo_tpu_torch.llm.kv_router.router import KvRouter

__all__ = [
    "KvIndexer",
    "OverlapScores",
    "KvScheduler",
    "DefaultWorkerSelector",
    "WorkerMetrics",
    "KvRouter",
]
