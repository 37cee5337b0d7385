"""Two-part length-prefixed framing: JSON header + binary payload.

A copy of the JAX package's ``runtime/transports/framing.py`` (the same
bytes on the wire).

Frame layout: [u32 header_len][u32 payload_len][header JSON][payload bytes]
(big-endian).  The header carries control/routing metadata; the payload is
opaque bytes (JSON bodies, or raw tensor data for KV-block transfer, which
must not pay a JSON/base64 tax).  Control frames (stop/kill, and the
fault plane's ping/pong health probes — transports/tcp.py) are
header-only: zero payload, so a probe costs 8 bytes + the header.

Reference parity: lib/runtime/src/pipeline/network/codec/two_part.rs.
"""

from __future__ import annotations

import asyncio
import json
import struct
from typing import Any, Optional

_HDR = struct.Struct(">II")

MAX_FRAME = 1 << 30  # 1 GiB guard

__all__ = ["write_frame", "read_frame", "close_writer", "decode_frames",
           "FrameError"]


class FrameError(Exception):
    pass


async def close_writer(writer: Optional[asyncio.StreamWriter],
                       timeout: float = 2.0) -> None:
    """Close a StreamWriter AND await its transport teardown, bounded.

    ``writer.close()`` alone only schedules the close — nothing awaits
    ``connection_lost``, so shutdown paths that stop at close() leak
    live TCP transports (a task-leak checker catches this).  The
    wait is bounded: a transport whose peer never acknowledges the FIN
    must not wedge a drain, and errors are swallowed — the socket may
    already be dead, which is fine on a close path."""
    if writer is None:
        return
    try:
        writer.close()
        await asyncio.wait_for(writer.wait_closed(), timeout)
    except (asyncio.TimeoutError, OSError, RuntimeError):
        pass  # already-dead socket or closing loop: nothing left to tear down
    except asyncio.CancelledError:
        # every closer of one writer awaits the same close-waiter future,
        # and cancelling one of them (a reconnect loop stopped by close())
        # cancels that future under the others: only this task's own
        # cancellation propagates
        task = asyncio.current_task()
        if task is None or task.cancelling():
            raise


def encode_frame(header: dict[str, Any], payload: bytes = b"") -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return _HDR.pack(len(hdr), len(payload)) + hdr + payload


def write_frame(writer: asyncio.StreamWriter, header: dict[str, Any], payload: bytes = b"") -> None:
    writer.write(encode_frame(header, payload))


def decode_frames(data: bytes) -> list[tuple[dict, bytes]]:
    """Decode a captured byte stream into its complete frames.

    Offline twin of ``read_frame`` for recorded transcripts (the
    protocol plane's channel recorder, wire-fixture tests).  A trailing
    partial frame — a transcript cut mid-frame by a sever or crash — is
    ignored rather than an error; a malformed complete frame still
    raises ``FrameError``.
    """
    frames: list[tuple[dict, bytes]] = []
    off = 0
    while off + _HDR.size <= len(data):
        hlen, plen = _HDR.unpack_from(data, off)
        if hlen > MAX_FRAME or plen > MAX_FRAME:
            raise FrameError(f"oversized frame: header={hlen} payload={plen}")
        end = off + _HDR.size + hlen + plen
        if end > len(data):
            break  # torn tail
        hdr = data[off + _HDR.size:off + _HDR.size + hlen]
        try:
            header = json.loads(hdr)
        except json.JSONDecodeError as e:
            raise FrameError(f"bad frame header: {e}") from e
        frames.append((header, data[end - plen:end] if plen else b""))
        off = end
    return frames


async def read_frame(reader: asyncio.StreamReader) -> Optional[tuple[dict, bytes]]:
    """Read one frame; returns None on clean EOF."""
    try:
        prefix = await reader.readexactly(_HDR.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    hlen, plen = _HDR.unpack(prefix)
    if hlen > MAX_FRAME or plen > MAX_FRAME:
        raise FrameError(f"oversized frame: header={hlen} payload={plen}")
    try:
        hdr = await reader.readexactly(hlen)
        payload = await reader.readexactly(plen) if plen else b""
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    try:
        header = json.loads(hdr)
    except json.JSONDecodeError as e:
        raise FrameError(f"bad frame header: {e}") from e
    return header, payload
