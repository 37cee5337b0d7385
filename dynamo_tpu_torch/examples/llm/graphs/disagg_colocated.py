"""Disaggregated serving with both roles in one worker process.

One ColocatedWorker process per card hosts the prefill and the decode
engine, so every KV handoff is an on-card block copy, never host TCP.
The disagg.py graph (a PrefillWorker process of its own) moves every
handoff over TCP.

Run: python -m dynamo_tpu_torch serve dynamo_tpu_torch.examples.llm.graphs.disagg_colocated:Frontend \\
         -f dynamo_tpu_torch/examples/llm/configs/disagg_colocated.yaml
"""

from dynamo_tpu_torch.examples.llm.components.colocated_worker import ColocatedWorker
from dynamo_tpu_torch.examples.llm.components.frontend import Frontend
from dynamo_tpu_torch.examples.llm.components.processor import Processor

Frontend.link(Processor).link(ColocatedWorker)
