"""Engine stubs and the local serving pipeline.

The counterpart of ``dynamo_tpu/llm/engines.py``: ``EchoEngineCore``
(``run out=echo``) and ``ScriptedEngine`` make every serving-stack feature
testable with no model, and ``build_serving_pipeline`` wraps an engine in
the preprocessor and the detokenizing backend.
"""

from __future__ import annotations

from typing import AsyncIterator

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols import BackendInput, FinishReason, LLMEngineOutput
from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.pipeline import build_pipeline

__all__ = ["EchoEngineCore", "ScriptedEngine", "build_serving_pipeline"]


class ScriptedEngine(AsyncEngine):
    """Emits a fixed sequence of text deltas, ignoring the input — lets
    protocol-surface tests (tool-call parsing, stop jail, SSE framing)
    script exact model output without a model."""

    def __init__(self, deltas: list[str]):
        self.deltas = list(deltas)

    def generate(self, request) -> AsyncIterator[LLMEngineOutput]:
        return self._run(request)

    async def _run(self, request) -> AsyncIterator[LLMEngineOutput]:
        for i, d in enumerate(self.deltas):
            if getattr(request, "is_stopped", False):
                yield LLMEngineOutput(finish_reason=FinishReason.CANCELLED)
                return
            yield LLMEngineOutput(
                token_ids=[i],
                text=d,
                finish_reason=(
                    FinishReason.STOP if i + 1 == len(self.deltas) else None
                ),
            )


class EchoEngineCore(AsyncEngine):
    """Echoes the prompt's token ids back, one per step."""

    def generate(self, request: Context[BackendInput]) -> AsyncIterator[LLMEngineOutput]:
        return self._run(request)

    async def _run(self, request: Context[BackendInput]) -> AsyncIterator[LLMEngineOutput]:
        inp = request.data
        max_tokens = inp.stops.max_tokens or len(inp.token_ids)
        for i, tid in enumerate(inp.token_ids):
            if request.is_stopped:
                yield LLMEngineOutput(token_ids=[], finish_reason=FinishReason.CANCELLED)
                return
            last = i + 1 >= max_tokens or i + 1 >= len(inp.token_ids)
            out = LLMEngineOutput(
                token_ids=[tid],
                finish_reason=FinishReason.LENGTH if last else None,
            )
            if inp.sampling.logprobs or inp.sampling.top_logprobs:
                # deterministic fake logprobs so the protocol surface is
                # testable without a model (real values come from the engine)
                out.logprobs = [-0.5]
                if inp.sampling.top_logprobs > 0:
                    out.top_logprobs = [[(tid, -0.5)]]
            yield out
            if last:
                return


def build_serving_pipeline(
    engine: AsyncEngine, card: ModelDeploymentCard, tokenizer: TokenizerWrapper | None = None
) -> AsyncEngine:
    """frontend-ready pipeline: ParsedRequest → preprocess → engine → detok."""
    pre = OpenAIPreprocessor(card, tokenizer)
    # constrained decoding: the core compiles grammar tables from this
    # tokenizer lazily on the first constrained request
    core = getattr(engine, "core", None)
    if core is not None and hasattr(core, "attach_grammar_tokenizer"):
        core.attach_grammar_tokenizer(pre.tokenizer, card.eos_token_ids)
    return build_pipeline(engine, pre, Backend(pre.tokenizer))
