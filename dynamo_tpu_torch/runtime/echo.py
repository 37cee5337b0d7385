"""Echo engines — the test seam every distributed feature is exercised with.

A copy of the JAX package's ``runtime/echo.py``.

Reference parity: lib/llm/src/engines.rs:40-100 (EchoEngineCore with
DYN_TOKEN_ECHO_DELAY_MS, EchoEngineFull); used the same way here — pipeline,
router, HTTP and disaggregation tests run against echo engines so no model
weights or accelerator are needed.
"""

from __future__ import annotations

import asyncio
import os
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context

__all__ = ["EchoEngine"]


class EchoEngine(AsyncEngine):
    """Streams each element of the request payload back, one per tick.

    The payload may be a list (token ids) or a string (split into chars).
    Delay between items comes from ``delay_s`` or DYNTPU_TOKEN_ECHO_DELAY_MS.
    """

    def __init__(self, delay_s: float | None = None):
        if delay_s is None:
            delay_s = float(os.environ.get("DYNTPU_TOKEN_ECHO_DELAY_MS", "0")) / 1e3
        self.delay_s = delay_s

    async def _run(self, request: Context) -> AsyncIterator[Any]:
        items = request.data
        for item in items:
            if request.is_stopped:
                break
            if self.delay_s:
                await asyncio.sleep(self.delay_s)
            yield item

    def generate(self, request: Context) -> AsyncIterator[Any]:
        return self._run(request)
