"""Python SDK — declarative serving graphs.

The counterpart of the JAX package's ``sdk/``: ``@service`` components with
``@dynamo_endpoint``s, ``depends()`` cross-component clients, ``.link()``
graph edges, YAML ServiceConfig with Common inheritance, in-process serving
(``serve_graph``) and a process supervisor (``python -m dynamo_tpu_torch
serve``, sdk/serving.py), all on the port's distributed runtime.

Reference parity: deploy/dynamo/sdk (BentoML-forked @service model,
SURVEY.md §2.7), with the supervisor in place of circus.
"""

from dynamo_tpu_torch.sdk.config import ServiceConfig
from dynamo_tpu_torch.sdk.service import (
    DynamoService,
    async_on_start,
    depends,
    dynamo_endpoint,
    service,
)
from dynamo_tpu_torch.sdk.serving import ServeHandle, serve_graph

__all__ = [
    "ServiceConfig",
    "DynamoService",
    "service",
    "dynamo_endpoint",
    "async_on_start",
    "depends",
    "serve_graph",
    "ServeHandle",
]
