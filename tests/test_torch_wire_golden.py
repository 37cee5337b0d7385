"""The JAX package's committed wire recordings (``tests/wire_golden/``)
decoded by the port's code and re-encoded byte for byte.

The port speaks the JAX package's wire: its framing, coordinator
protocol, DTKVP1 persist files, router KV events, streamed KV handoff
sessions and shard scatter replies must read the bytes a JAX peer (or a
JAX worker's snapshot on disk) wrote, and write the same bytes back.  The
last test builds every recording with the port's encoders from the
generator's inputs and compares it with the committed file.
"""

import asyncio
import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.llm.kv import persist
from dynamo_tpu_torch.llm.kv.events import KvStoredEvent, event_from_wire, event_to_wire
from dynamo_tpu_torch.llm.kv.stream import STREAM_VERSION, KvStreamAssembler
from dynamo_tpu_torch.llm.kv.transfer import pack_blocks, unpack_blocks
from dynamo_tpu_torch.llm.kv_router.shards.scatter import ShardReply
from dynamo_tpu_torch.llm.kv_router.shards.wire import decode_scatter_reply, encode_scatter_reply
from dynamo_tpu_torch.runtime.transports.framing import encode_frame, read_frame
from dynamo_tpu_torch.runtime.transports.protocol import CoordOp, FrameType, TransferOp

GOLDEN = Path(__file__).parent / "wire_golden"


def _decode_frames(blob: bytes):
    """The port's async ``read_frame`` over a fed StreamReader until EOF."""

    async def drain():
        reader = asyncio.StreamReader()
        reader.feed_data(blob)
        reader.feed_eof()
        frames = []
        while (frame := await read_frame(reader)) is not None:
            frames.append(frame)
        return frames

    return asyncio.run(drain())


def _reencoded(name: str):
    committed = (GOLDEN / name).read_bytes()
    frames = _decode_frames(committed)
    return committed, frames, b"".join(encode_frame(h, p) for h, p in frames)


# ------------------------------------------------------------ frames ----


def test_tcp_sequence_decodes_and_reencodes():
    committed, frames, again = _reencoded("tcp_sequence.bin")
    assert [h["type"] for h, _ in frames] == [FrameType.REQUEST, FrameType.ITEM, FrameType.ITEM,
                                              FrameType.END, FrameType.PING, FrameType.PONG]
    req, preq = frames[0]
    assert req["req_id"] == 7 and req["subject"] == "gen" and preq == b'{"prompt":"hi"}'
    assert [p for _, p in frames[1:3]] == [b'{"token":"a"}', b'{"token":"b"}']
    assert all(p == b"" for _, p in frames[3:])
    assert again == committed


def test_coordinator_command_decodes_and_reencodes():
    committed, ((header, payload),), again = _reencoded("coordinator_command.bin")
    assert header == {"op": CoordOp.KV_PUT, "id": 42, "key": "instances/worker-0",
                      "value": {"host": "10.0.0.1", "port": 9000}}
    assert payload == b"" and again == committed
    hlen, plen = struct.unpack(">II", committed[:8])
    assert len(committed) == 8 + hlen + plen


# ------------------------------------------------------ router event ----


def test_router_kv_event_decodes_and_reencodes():
    committed = (GOLDEN / "router_kv_event.jsonl").read_bytes()
    event_id, worker_id, ev = event_from_wire(json.loads(committed.decode()))
    assert (event_id, worker_id) == (5, 3)
    assert isinstance(ev, KvStoredEvent)
    assert (ev.block_hashes, ev.parent_hash, ev.token_blocks, ev.tier) == (
        [111, 222], None, [[1, 2], [3, 4]], "persist")
    line = json.dumps(event_to_wire(event_id, worker_id, ev), separators=(",", ":")) + "\n"
    assert line.encode() == committed
    d = json.loads(committed)
    d.update(ts=1700000000.5, v=1, layer_tags=[0, 1])  # unknown fields are dropped
    assert event_from_wire(d)[:2] == (5, 3)


# ------------------------------------------------------------ DTKVP1 ----


def test_dtkvp1_blob_parses_and_reencodes():
    committed = (GOLDEN / "dtkvp1_blob.bin").read_bytes()
    header, payload = persist._parse(committed, "golden-gen")
    assert header["version"] == persist.FORMAT_VERSION
    assert header["hashes"] == [12345, 67890]
    assert header["leaves"] == [{"dtype": "uint8", "shape": [2, 16]}]
    assert payload == bytes(range(32))
    assert hashlib.sha256(payload).hexdigest() == header["payload_sha256"]
    with pytest.raises(Exception):
        persist._parse(committed, "other-gen")
    assert persist.PersistentKvStore._encode(header, payload) == committed


# ------------------------------------------------- KV stream session ----


def test_kv_stream_session_decodes_and_reencodes():
    committed, frames, again = _reencoded("kv_stream_session.bin")
    assert [h["op"] for h, _ in frames] == [TransferOp.STREAM_BEGIN, TransferOp.WRITE_LAYER,
                                            TransferOp.WRITE_LAYER, TransferOp.STREAM_END]
    begin, _ = frames[0]
    assert (begin["v"], begin["session"], begin["request_id"], begin["num_layers"]) == (
        STREAM_VERSION, "golden-sess", "golden-req", 2)
    sha = hashlib.sha256()
    for seq, (h, p) in enumerate(frames[1:3]):
        assert (h["seq"], h["layer"], h["chunk"], h["block_ids"]) == (seq, seq, 0, [0])
        arr = unpack_blocks(h, p)
        assert isinstance(arr, torch.Tensor) and arr.dtype == torch.float32
        assert arr.shape == (1, 8)
        sha.update(p)
    end, pend = frames[3]
    assert pend == b"" and end["frames"] == 2 and end["sha"] == sha.hexdigest()
    assert again == committed


def test_kv_stream_session_admitted_by_the_assembler():
    frames = _decode_frames((GOLDEN / "kv_stream_session.bin").read_bytes())
    applied = []

    async def run():
        async def sink(ids, arr, rid):
            applied.append((list(ids), arr, rid))

        asm = KvStreamAssembler(sink)
        for h, p in frames:
            await asm.handle(h, p)

    asyncio.run(run())
    ((ids, arr, rid),) = applied
    arr = torch.as_tensor(np.asarray(arr))
    assert ids == [0] and rid == "golden-req" and tuple(arr.shape) == (2, 1, 8)
    assert float(arr[1].sum()) == 2 * float(arr[0].sum())


# ------------------------------------------------ shard scatter reply ----


def test_shard_scatter_reply_roundtrip():
    committed = (GOLDEN / "shard_scatter_reply.bin").read_bytes()
    request_id, reply = decode_scatter_reply(committed)
    assert request_id == "golden-frontend:2:1"
    assert (reply.shard_id, reply.generation) == (2, 123456789)
    assert reply.holders == {0: frozenset({0, 3}), 4: frozenset({1})}
    assert reply.persist_holders == {4: frozenset({7})}
    assert encode_scatter_reply(request_id, reply) == committed


# ------------------------------------- the port's encoders, from scratch ----


def _port_recordings() -> dict:
    """Each recording as the JAX generator (``wire_golden/generate.py``)
    builds it, from the same inputs, through the port's encoders."""
    tcp = [({"type": FrameType.REQUEST, "req_id": 7, "subject": "gen"}, b'{"prompt":"hi"}'),
           ({"type": FrameType.ITEM, "req_id": 7}, b'{"token":"a"}'),
           ({"type": FrameType.ITEM, "req_id": 7}, b'{"token":"b"}'),
           ({"type": FrameType.END, "req_id": 7}, b""),
           ({"type": FrameType.PING, "req_id": 8}, b""),
           ({"type": FrameType.PONG, "req_id": 8}, b"")]
    ev = KvStoredEvent(block_hashes=[111, 222], parent_hash=None,
                       token_blocks=[[1, 2], [3, 4]], tier="persist")
    payload = bytes(range(32))
    dtkvp1 = {"version": persist.FORMAT_VERSION, "generation": "golden-gen",
              "hashes": [12345, 67890], "structure": {"kind": "list", "n": 1},
              "leaves": [{"dtype": "uint8", "shape": [2, 16]}],
              "payload_sha256": hashlib.sha256(payload).hexdigest(), "created": 1700000000.0}
    sha = hashlib.sha256()
    session = [({"v": STREAM_VERSION, "session": "golden-sess", "request_id": "golden-req",
                 "num_layers": 2, "op": TransferOp.STREAM_BEGIN, "id": 1}, b"")]
    for layer in range(2):
        meta, data = pack_blocks(torch.arange(8, dtype=torch.float32).reshape(1, 8) * (layer + 1))
        sha.update(data)
        session.append(({"session": "golden-sess", "seq": layer, "chunk": 0, "layer": layer,
                         "block_ids": [0], **meta, "op": TransferOp.WRITE_LAYER,
                         "id": 2 + layer}, data))
    session.append(({"session": "golden-sess", "frames": 2, "sha": sha.hexdigest(),
                     "op": TransferOp.STREAM_END, "id": 4}, b""))
    reply = ShardReply(shard_id=2, generation=123456789,
                       holders={0: frozenset({3, 0}), 4: frozenset({1})},
                       persist_holders={4: frozenset({7})})
    return {
        "tcp_sequence.bin": b"".join(encode_frame(h, p) for h, p in tcp),
        "coordinator_command.bin": encode_frame(
            {"op": CoordOp.KV_PUT, "id": 42, "key": "instances/worker-0",
             "value": {"host": "10.0.0.1", "port": 9000}}, b""),
        "router_kv_event.jsonl": (json.dumps(event_to_wire(5, 3, ev), separators=(",", ":"))
                                  + "\n").encode(),
        "dtkvp1_blob.bin": persist.PersistentKvStore._encode(dtkvp1, payload),
        "kv_stream_session.bin": b"".join(encode_frame(h, p) for h, p in session),
        "shard_scatter_reply.bin": encode_scatter_reply("golden-frontend:2:1", reply),
    }


@pytest.mark.parametrize("name", sorted(_port_recordings()))
def test_port_encoders_write_the_committed_bytes(name):
    assert _port_recordings()[name] == (GOLDEN / name).read_bytes()


def test_every_recording_is_covered():
    assert sorted(_port_recordings()) == sorted(
        p.name for p in GOLDEN.iterdir() if p.suffix in (".bin", ".jsonl"))
