"""PyTorch model implementations: ``nn.Module``s over the paged KV cache."""

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.deepseek import DeepseekConfig, DeepseekModel
from dynamo_tpu_torch.models.llama import LlamaModel

__all__ = ["ModelConfig", "LlamaModel", "DeepseekConfig", "DeepseekModel"]
