"""Pluggable connection factory for the stream transports.

A copy of the JAX package's ``runtime/transports/net.py``.

Every place the runtime opens or accepts a TCP stream (coordinator
server/client, endpoint TCP server/client) routes through a ``Net``
instance instead of calling ``asyncio.start_server`` /
``asyncio.open_connection`` directly.  The default ``Net`` is exactly
those calls — zero behavior change, zero hot-path cost (one attribute
lookup at *connection* time, never per frame).

The seam exists for the JAX package's protocol plane
(``analysis/detloop.MemNet``):
an in-memory transport that speaks the same ``framing.py`` bytes over
paired ``StreamReader``s inside a deterministic event loop, so the
model checker can run the real coordinator/drain/replication code with
scheduled severs and crash-point injection, no sockets involved.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Tuple

__all__ = ["Net", "DEFAULT_NET"]

ConnectionCb = Callable[[asyncio.StreamReader, asyncio.StreamWriter],
                        Awaitable[None]]


class Net:
    """Real-socket connection factory (the production default)."""

    async def start_server(self, cb: ConnectionCb, host: str,
                           port: int) -> Tuple[object, int]:
        """Start a stream server; returns ``(server, bound_port)``.

        ``server`` exposes ``close()`` / ``wait_closed()`` like
        ``asyncio.Server`` (MemNet returns its own handle with the same
        surface).
        """
        server = await asyncio.start_server(cb, host, port)
        bound = server.sockets[0].getsockname()[1] if server.sockets else port
        return server, bound

    async def open_connection(
        self, host: str, port: int,
    ) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter]:
        return await asyncio.open_connection(host, port)


DEFAULT_NET = Net()
