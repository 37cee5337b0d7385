"""Backend — the detokenizing postprocessor operator.

Wraps the engine: on the response path it incrementally detokenizes token
deltas into text, holds back text that might be the start of a stop
sequence (the "jail"), and maps finish reasons.  The counterpart of
``dynamo_tpu/llm/backend.py``.
"""

from __future__ import annotations

from typing import AsyncIterator

from dynamo_tpu_torch.llm.protocols import BackendInput, FinishReason, LLMEngineOutput
from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.pipeline import Operator

__all__ = ["Backend"]


class Backend(Operator):
    def __init__(self, tokenizer: TokenizerWrapper):
        self.tokenizer = tokenizer

    async def forward(self, request: Context[BackendInput]) -> Context[BackendInput]:
        return request

    def backward(
        self, stream: AsyncIterator[LLMEngineOutput], request: Context[BackendInput]
    ) -> AsyncIterator[LLMEngineOutput]:
        return self._detokenize(stream, request)

    def _logprob_content(self, out: LLMEngineOutput) -> list[dict]:
        """Map engine logprob data (token ids) to OpenAI display form
        (token strings + UTF-8 bytes), one entry per emitted token."""
        entries = []
        tops = out.top_logprobs or [None] * len(out.token_ids)
        for tid, lp, top in zip(out.token_ids, out.logprobs, tops):
            s = self.tokenizer.decode([tid], skip_special_tokens=False)
            e = {"token": s, "logprob": lp, "bytes": list(s.encode())}
            if top:
                e["top_logprobs"] = [
                    {
                        "token": (ts := self.tokenizer.decode([int(i)], skip_special_tokens=False)),
                        "logprob": float(l),
                        "bytes": list(ts.encode()),
                    }
                    for i, l in top
                ]
            else:
                e["top_logprobs"] = []
            entries.append(e)
        return entries

    async def _detokenize(
        self, stream: AsyncIterator[LLMEngineOutput], request: Context[BackendInput]
    ) -> AsyncIterator[LLMEngineOutput]:
        decoder = self.tokenizer.decode_stream()
        stop_strings = request.data.stops.stop
        max_stop = max((len(s) for s in stop_strings), default=0)
        held = ""  # jail: text that may be a stop-string prefix

        async for out in stream:
            text = ""
            for tid in out.token_ids:
                text += decoder.step(tid)
            held += text
            if out.logprobs is not None:
                out.logprob_content = self._logprob_content(out)

            if stop_strings:
                hit = None
                for s in stop_strings:
                    i = held.find(s)
                    if i >= 0 and (hit is None or i < hit[0]):
                        hit = (i, s)
                if hit is not None:
                    out.text = held[: hit[0]]
                    out.finish_reason = FinishReason.STOP
                    yield out
                    request.stop_generating()
                    return
                # release everything that can no longer start a stop string
                safe = len(held) - (max_stop - 1)
                if out.finished:
                    out.text = held
                    held = ""
                elif safe > 0:
                    out.text = held[:safe]
                    held = held[safe:]
                else:
                    out.text = ""
            else:
                out.text = held
                held = ""
            yield out
            if out.finished:
                return
