"""OpenAI-compatible HTTP frontend (aiohttp)."""

from dynamo_tpu_torch.llm.http.service import HttpService, ModelManager

__all__ = ["HttpService", "ModelManager"]
