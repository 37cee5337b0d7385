"""Pipeline composition: operators around an engine.

A serving pipeline is  frontend → op₁ → op₂ → … → engine, where each operator
transforms the request on the way down (``forward``) and wraps the response
stream on the way back up (``backward``).  The preprocessor (OpenAI → tokens)
and the detokenizing backend are both operators.  The counterpart of
``dynamo_tpu/runtime/pipeline.py``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, AsyncIterator, Generic, Sequence, TypeVar

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context

ReqIn = TypeVar("ReqIn")
ReqOut = TypeVar("ReqOut")
RespIn = TypeVar("RespIn")
RespOut = TypeVar("RespOut")

__all__ = ["Operator", "build_pipeline"]


class Operator(ABC, Generic[ReqIn, ReqOut, RespIn, RespOut]):
    """A bidirectional pipeline stage."""

    @abstractmethod
    async def forward(self, request: Context[ReqIn]) -> Context[ReqOut]:
        """Transform the request on its way to the engine."""

    def backward(
        self, stream: AsyncIterator[RespIn], request: Context[ReqIn]
    ) -> AsyncIterator[RespOut]:
        """Transform the response stream on its way back.  Default: identity.

        ``request`` is the *incoming* request this operator saw, so backward
        passes can consult what forward computed (via ``request.annotations``).
        """
        return stream  # type: ignore[return-value]


class _PipelineEngine(AsyncEngine):
    def __init__(self, engine: AsyncEngine, operators: Sequence[Operator]):
        self._engine = engine
        self._operators = list(operators)

    async def _run(self, request: Context) -> AsyncIterator[Any]:
        seen: list[tuple[Operator, Context]] = []
        req = request
        for op in self._operators:
            seen.append((op, req))
            req = await op.forward(req)
        stream = self._engine.generate(req)
        for op, op_req in reversed(seen):
            stream = op.backward(stream, op_req)
        async for item in stream:
            yield item

    def generate(self, request: Context) -> AsyncIterator[Any]:
        return self._run(request)


def build_pipeline(engine: AsyncEngine, *operators: Operator) -> AsyncEngine:
    """Compose ``operators`` (outermost first) around ``engine``.

    ``build_pipeline(e, a, b)``: requests flow a.forward → b.forward → e;
    responses flow e → b.backward → a.backward.
    """
    return _PipelineEngine(engine, operators)
