"""Aggregated serving with KV-aware routing across worker replicas.
Run: python -m dynamo_tpu_torch serve dynamo_tpu_torch.examples.llm.graphs.agg_router:Frontend \\
         -f dynamo_tpu_torch/examples/llm/configs/agg_router.yaml
(Reference analogue: examples/llm/graphs/agg_router.py)"""

from dynamo_tpu_torch.examples.llm.components.frontend import Frontend
from dynamo_tpu_torch.examples.llm.components.kv_router import Router
from dynamo_tpu_torch.examples.llm.components.processor import Processor
from dynamo_tpu_torch.examples.llm.components.worker import GpuWorker

Frontend.link(Processor).link(Router).link(GpuWorker)
