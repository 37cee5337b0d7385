"""Disaggregated serving: decode worker + remote prefill worker, each in a
process of its own.
Run: DYNTPU_GPUS=0,1 python -m dynamo_tpu_torch serve \\
         dynamo_tpu_torch.examples.llm.graphs.disagg:Frontend \\
         -f dynamo_tpu_torch/examples/llm/configs/disagg.yaml
(DYNTPU_GPUS=0,0 puts both workers on one card.)
(Reference analogue: examples/llm/graphs/disagg.py)"""

from dynamo_tpu_torch.examples.llm.components.frontend import Frontend
from dynamo_tpu_torch.examples.llm.components.prefill_worker import PrefillWorker
from dynamo_tpu_torch.examples.llm.components.processor import Processor
from dynamo_tpu_torch.examples.llm.components.worker import GpuWorker

Frontend.link(Processor).link(GpuWorker).link(PrefillWorker)
