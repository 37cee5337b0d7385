"""Runtime abstractions the engine plugs into: the AsyncEngine and its
request Context, pipelines of operators, the echo engine, and the
distributed runtime (``distributed.py``) over the transports."""

from dynamo_tpu_torch.runtime.echo import EchoEngine
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.pipeline import Operator, build_pipeline

__all__ = ["AsyncEngine", "Context", "Operator", "build_pipeline", "EchoEngine"]
