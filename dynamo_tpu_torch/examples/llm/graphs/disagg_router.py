"""Disaggregated serving + KV-aware routing.
Run: python -m dynamo_tpu_torch serve dynamo_tpu_torch.examples.llm.graphs.disagg_router:Frontend \\
         -f dynamo_tpu_torch/examples/llm/configs/disagg_router.yaml
(Reference analogue: examples/llm/graphs/disagg_router.py)"""

from dynamo_tpu_torch.examples.llm.components.frontend import Frontend
from dynamo_tpu_torch.examples.llm.components.kv_router import Router
from dynamo_tpu_torch.examples.llm.components.prefill_worker import PrefillWorker
from dynamo_tpu_torch.examples.llm.components.processor import Processor
from dynamo_tpu_torch.examples.llm.components.worker import GpuWorker

Frontend.link(Processor).link(Router).link(GpuWorker).link(PrefillWorker)
