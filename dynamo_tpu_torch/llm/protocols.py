"""Engine-agnostic request/response protocol.

Engines consume a :class:`BackendInput` (token ids + sampling + stop
conditions) and emit :class:`LLMEngineOutput` deltas — the same dataclasses,
field for field, as ``dynamo_tpu.llm.protocols``, so a worker can serve
either engine behind one front door.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = [
    "FinishReason",
    "SamplingOptions",
    "StopConditions",
    "BackendInput",
    "LLMEngineOutput",
]


class FinishReason(str, enum.Enum):
    EOS = "eos"          # hit an end-of-sequence token
    STOP = "stop"        # hit a stop sequence / stop token
    LENGTH = "length"    # max_tokens or model context limit
    CANCELLED = "cancelled"
    ERROR = "error"

    def as_openai(self) -> str:
        """Map to OpenAI finish_reason strings."""
        if self in (FinishReason.EOS, FinishReason.STOP):
            return "stop"
        if self is FinishReason.LENGTH:
            return "length"
        return "stop" if self is FinishReason.CANCELLED else "error"


@dataclass
class SamplingOptions:
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0
    # drop candidates with prob < min_p * max_prob.  0 = disabled
    min_p: float = 0.0
    # OpenAI logit_bias: token id -> additive bias in [-100, 100]
    logit_bias: Optional[dict[int, float]] = None
    seed: Optional[int] = None
    # OpenAI penalties over generated tokens
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # logprob reporting: chosen-token logprob and top-N alternatives
    logprobs: bool = False
    top_logprobs: int = 0
    # constrained decoding (grammar-masked sampling)
    json_mode: bool = False
    guided_choice: Optional[list[str]] = None
    guided_regex: Optional[str] = None

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclass
class StopConditions:
    max_tokens: Optional[int] = None
    stop: list[str] = field(default_factory=list)          # stop strings (detok layer)
    stop_token_ids: list[int] = field(default_factory=list)
    ignore_eos: bool = False
    min_tokens: int = 0


@dataclass
class BackendInput:
    """What an engine consumes: tokens in, sampling+stop config."""

    token_ids: list[int] = field(default_factory=list)
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stops: StopConditions = field(default_factory=StopConditions)
    model: str = ""
    annotations: dict[str, Any] = field(default_factory=dict)


@dataclass
class LLMEngineOutput:
    """A streamed engine delta: newly generated token ids (usually one)."""

    token_ids: list[int] = field(default_factory=list)
    finish_reason: Optional[FinishReason] = None
    cached_tokens: int = 0      # prefix-cache hit length for this request
    text: Optional[str] = None
    # per-token logprob data (aligned with token_ids), when requested
    logprobs: Optional[list[float]] = None
    # per-token top-N candidates as (token_id, logprob) pairs
    top_logprobs: Optional[list[list[tuple]]] = None
    # display-form logprobs (token strings + bytes), filled by the Backend:
    # [{token, logprob, bytes, top_logprobs: [{token, logprob, bytes}]}]
    logprob_content: Optional[list[dict]] = None

    def __post_init__(self):
        if isinstance(self.finish_reason, str):
            self.finish_reason = FinishReason(self.finish_reason)

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None
