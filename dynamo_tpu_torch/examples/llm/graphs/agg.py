"""Aggregated serving: one worker does prefill + decode.
Run: python -m dynamo_tpu_torch serve dynamo_tpu_torch.examples.llm.graphs.agg:Frontend \\
         -f dynamo_tpu_torch/examples/llm/configs/agg.yaml
(Reference analogue: examples/llm/graphs/agg.py)"""

from dynamo_tpu_torch.examples.llm.components.frontend import Frontend
from dynamo_tpu_torch.examples.llm.components.processor import Processor
from dynamo_tpu_torch.examples.llm.components.worker import GpuWorker

Frontend.link(Processor).link(GpuWorker)
