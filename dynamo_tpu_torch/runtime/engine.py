"""The AsyncEngine abstraction: one request in, a stream of responses out.

``Context`` is the request envelope (payload + id + cancellation); an
``AsyncEngine`` turns a ``Context[T]`` into an async iterator of ``U``.
"""

from __future__ import annotations

import asyncio
import uuid
from abc import ABC, abstractmethod
from typing import Any, AsyncIterator, Generic, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")

__all__ = ["Context", "AsyncEngine"]


class Context(Generic[T]):
    """A request envelope: payload + id + cancellation.

    ``stop_generating()`` asks the engine to finish gracefully;
    ``kill()`` demands immediate abort.
    """

    __slots__ = ("data", "id", "_stop", "_kill", "annotations")

    def __init__(self, data: T = None, id: Optional[str] = None):
        self.data = data
        self.id = id or uuid.uuid4().hex
        self._stop = asyncio.Event()
        self._kill = asyncio.Event()
        # free-form per-request annotations
        self.annotations: dict[str, Any] = {}

    def map(self, data: U) -> "Context[U]":
        """New payload, same identity, annotations and cancellation."""
        ctx: Context[U] = Context.__new__(Context)
        ctx.data = data
        ctx.id = self.id
        ctx._stop = self._stop
        ctx._kill = self._kill
        ctx.annotations = self.annotations
        return ctx

    def stop_generating(self) -> None:
        self._stop.set()

    def kill(self) -> None:
        self._kill.set()
        self._stop.set()

    @property
    def is_stopped(self) -> bool:
        return self._stop.is_set()

    @property
    def is_killed(self) -> bool:
        return self._kill.is_set()

    async def stopped(self) -> None:
        """Wait until stop or kill is requested."""
        await self._stop.wait()


class AsyncEngine(ABC, Generic[T, U]):
    """generate(Context[T]) -> async stream of U."""

    @abstractmethod
    def generate(self, request: Context[T]) -> AsyncIterator[U]:
        """Return an async iterator of responses.  Implementations must
        respect ``request.is_stopped`` / ``request.is_killed``."""

    async def generate_all(self, request: Context[T]) -> list[U]:
        """Drain the stream (testing / non-streaming callers)."""
        return [item async for item in self.generate(request)]
