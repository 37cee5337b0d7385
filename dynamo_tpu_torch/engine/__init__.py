"""The in-process PyTorch engine: continuous batching over the paged KV cache.

Prefill and decode share one model forward; a block manager with prefix
reuse owns the cache blocks, and an asyncio front door plugs the engine into
the runtime's AsyncEngine contract.
"""

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.async_engine import AsyncLLMEngine

__all__ = ["EngineConfig", "EngineCore", "AsyncLLMEngine"]
