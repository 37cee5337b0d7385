"""The port's distributed runtime against the JAX package's.

* The JAX package's runtime tests, on the port: contexts, echo engine and
  pipelines, layered config; the coordinator, endpoint serving, discovery,
  routing and cancellation, reconnects and lease healing; the standalone
  KV router service; the TCP request plane under failure (typed errors,
  prompt stop, ping, frame drop and sever through the server's fault hook,
  in-flight tracking).
* The wire: serde bytes of the LLM types, and the bytes a request frame
  puts on a socket, equal the JAX package's.
* Across the packages: a port worker at ``dyn://`` answers a JAX client and
  a JAX worker answers a port client, through either package's
  coordinator, with the greedy token streams of a direct JAX engine.
* One trace: a request traced at a port client keeps its trace id in the
  worker's spans.
* End to end in subprocesses: ``coordinator``, ``run in=dyn:// --device
  cpu``, ``models add`` and ``http``; the HTTP answer equals a direct
  engine's.
"""

import asyncio
import dataclasses
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dynamo_tpu_torch
from dynamo_tpu.engine import AsyncLLMEngine as JaxAsyncLLMEngine
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.runtime import serde as jax_serde
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxDistributedRuntime
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.transports import framing as jax_framing
from dynamo_tpu.runtime.transports.coordinator import CoordinatorServer as JaxCoordinatorServer
from dynamo_tpu.runtime.transports.tcp import EndpointTcpClient as JaxEndpointTcpClient
from dynamo_tpu_torch.cli import start_router_service
from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.llm.kv.events import KvStoredEvent, event_to_wire
from dynamo_tpu_torch.llm.kv_router.publisher import events_subject, metrics_subject
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.obs import tracing
from dynamo_tpu_torch.runtime import AsyncEngine, Context, EchoEngine, Operator, build_pipeline
from dynamo_tpu_torch.runtime import serde
from dynamo_tpu_torch.runtime.config import RuntimeConfig, env_is_truthy
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.protocols import parse_endpoint_url
from dynamo_tpu_torch.runtime.transports import framing
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer
from dynamo_tpu_torch.runtime.transports.tcp import (
    EndpointDisconnected,
    EndpointTcpClient,
    EndpointTcpServer,
    TransportError,
)
from dynamo_tpu_torch.tokens import sequence_hashes
from tests.conftest import make_tiny_hf_checkpoint

REPO = Path(__file__).resolve().parent.parent
PKG = dynamo_tpu_torch.__name__
BS = 16

serde.register_llm_types()
jax_serde.register_llm_types()


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


# ------------------------------------------------------------ runtime core


def test_echo_engine_streams():
    assert run(EchoEngine().generate_all(Context([1, 2, 3]))) == [1, 2, 3]


def test_context_stop_halts_stream():
    async def go():
        ctx = Context(list(range(1000)))
        got = []
        async for item in EchoEngine(delay_s=0.001).generate(ctx):
            got.append(item)
            if len(got) == 3:
                ctx.stop_generating()
        return got

    assert len(run(go())) == 3


def test_context_map_shares_cancellation():
    ctx = Context({"a": 1})
    mapped = ctx.map([1, 2])
    ctx.stop_generating()
    assert mapped.is_stopped
    assert mapped.id == ctx.id


def test_child_context_tree():
    parent = Context()
    child = parent.child()
    parent.kill()
    assert child.is_killed
    p2 = Context()
    c2 = p2.child()
    c2.stop_generating()
    assert not p2.is_stopped


class Doubler(Operator):
    async def forward(self, request):
        return request.map([x * 2 for x in request.data])

    def backward(self, stream, request):
        async def gen():
            async for item in stream:
                yield item + 1

        return gen()


def test_pipeline_forward_and_backward():
    pipe = build_pipeline(EchoEngine(), Doubler(), Doubler())
    # forward: [1,2] -> [2,4] -> [4,8]; backward adds 1 twice
    assert run(pipe.generate_all(Context([1, 2]))) == [6, 10]


def test_config_env_overrides(monkeypatch):
    monkeypatch.setenv("DYNTPU_NAMESPACE", "testns")
    monkeypatch.setenv("DYNTPU_PORT", "7777")
    monkeypatch.setenv("DYNTPU_IS_STATIC", "true")
    cfg = RuntimeConfig.from_settings()
    assert (cfg.namespace, cfg.port, cfg.is_static) == ("testns", 7777, True)
    assert parse_endpoint_url("dyn://a.b.c").url == "dyn://a.b.c"
    assert tuple(parse_endpoint_url("b.c")) == ("dynamo", "b", "c")


def test_env_truthiness(monkeypatch):
    monkeypatch.setenv("X_FLAG", "yes")
    assert env_is_truthy("X_FLAG")
    monkeypatch.setenv("X_FLAG", "0")
    assert not env_is_truthy("X_FLAG")
    monkeypatch.setenv("X_FLAG", "bogus")
    with pytest.raises(ValueError):
        env_is_truthy("X_FLAG")


def test_jsonl_log_lines_equal_jax():
    """The structured log formatter writes the JAX package's line for the
    same record, so one log pipeline reads either package's workers."""
    import logging

    from dynamo_tpu.runtime.logging import JsonlFormatter as JaxJsonlFormatter
    from dynamo_tpu_torch.runtime.logging import JsonlFormatter

    rec = logging.LogRecord("dynamo.worker", logging.WARNING, __file__, 1, "served %d", (3,),
                            None)
    rec.created = 1_700_000_000.25
    line = JsonlFormatter().format(rec)
    assert line == JaxJsonlFormatter().format(rec)
    assert json.loads(line) == {"time": "2023-11-14T22:13:20", "level": "WARNING",
                                "target": "dynamo.worker", "message": "served 3"}


# ------------------------------------------------------------- coordinator


async def _coordinator():
    return await CoordinatorServer(port=0).start()


async def _runtime(url) -> DistributedRuntime:
    return await DistributedRuntime.connect(RuntimeConfig(coordinator_url=url, lease_ttl_s=2.0))


def test_kv_lease_watch():
    async def go():
        srv = await _coordinator()
        try:
            c1 = await CoordinatorClient(srv.url).connect()
            c2 = await CoordinatorClient(srv.url).connect()
            events = []
            _, snap = await c2.watch("ns/", lambda e, k, v: events.append((e, k, v)))
            assert snap == {}
            lease = await c1.lease_create(ttl=5.0)
            await c1.kv_put("ns/a", {"x": 1}, lease_id=lease)
            assert await c2.kv_get("ns/a") == {"x": 1}
            assert not await c1.kv_create("ns/a", {"x": 2})  # create-if-absent
            await asyncio.sleep(0.05)
            assert ("put", "ns/a", {"x": 1}) in events
            # connection drop revokes the lease -> key vanishes, watcher told
            await c1.close()
            await asyncio.sleep(0.2)
            assert await c2.kv_get("ns/a") is None
            assert ("delete", "ns/a", None) in events
            await c2.close()
        finally:
            await srv.stop()

    run(go())


def test_pubsub_and_queue():
    async def go():
        srv = await _coordinator()
        try:
            a = await CoordinatorClient(srv.url).connect()
            b = await CoordinatorClient(srv.url).connect()
            got = []
            await b.subscribe("ns.kv_events.>", lambda subj, pl: got.append((subj, pl)))
            assert await a.publish("ns.kv_events.w1", b"hello") == 1
            await asyncio.sleep(0.05)
            assert got == [("ns.kv_events.w1", b"hello")]
            # work queue with ack + nack redelivery
            await a.queue_push("prefill", b"job1")
            msg = await b.queue_pull("prefill", timeout_s=1)
            assert msg is not None and msg[1] == b"job1"
            await b.queue_nack("prefill", msg[0])
            msg2 = await b.queue_pull("prefill", timeout_s=1)
            assert msg2 is not None and msg2[1] == b"job1"
            await b.queue_ack("prefill", msg2[0])
            assert await b.queue_pull("prefill") is None
            await a.close()
            await b.close()
        finally:
            await srv.stop()

    run(go())


# -------------------------------------------------------- endpoint serving


def test_endpoint_serve_discover_route():
    async def go():
        srv = await _coordinator()
        try:
            worker1 = await _runtime(srv.url)
            worker2 = await _runtime(srv.url)
            frontend = await _runtime(srv.url)
            await worker1.namespace("dyn").component("backend").endpoint("generate").serve(
                EchoEngine())
            await worker2.namespace("dyn").component("backend").endpoint("generate").serve(
                EchoEngine())
            client = await frontend.namespace("dyn").component("backend").endpoint(
                "generate").client()
            ids = await client.wait_for_instances(2)
            assert ids == [worker1.instance_id, worker2.instance_id]
            # random + round-robin + direct all produce the stream
            assert [x async for x in client.generate(Context([1, 2, 3]))] == [1, 2, 3]
            assert [x async for x in client.round_robin(Context(["a", "b"]))] == ["a", "b"]
            assert [x async for x in client.direct(Context([9]), worker2.instance_id)] == [9]
            # typed payloads cross the wire (serde round trip)
            out = [x async for x in client.generate(
                Context([protocols.BackendInput(token_ids=[5])]))]
            assert isinstance(out[0], protocols.BackendInput) and out[0].token_ids == [5]
            # worker death: shutdown -> connection drop -> instance removed
            await worker2.shutdown()
            await asyncio.sleep(0.2)
            assert client.instance_ids() == [worker1.instance_id]
            await client.close()
            await frontend.shutdown()
            await worker1.shutdown()
        finally:
            await srv.stop()

    run(go())


class SlowEngine(AsyncEngine):
    def __init__(self, delay_s=0.01, n=1000):
        self.delay_s = delay_s
        self.n = n

    def generate(self, request):
        return self._run(request)

    async def _run(self, request):
        for i in range(self.n):
            if request.is_stopped:
                return
            await asyncio.sleep(self.delay_s)
            yield i


def test_remote_cancellation():
    async def go():
        srv = await _coordinator()
        try:
            worker = await _runtime(srv.url)
            await worker.namespace("dyn").component("slow").endpoint("generate").serve(
                SlowEngine())
            frontend = await _runtime(srv.url)
            client = await frontend.namespace("dyn").component("slow").endpoint(
                "generate").client()
            await client.wait_for_instances(1)
            ctx = Context(None)
            got = []
            async for item in client.generate(ctx):
                got.append(item)
                if len(got) == 3:
                    ctx.stop_generating()
            # stop propagated to the remote context: stream ended early
            assert 3 <= len(got) < 20
            await client.close()
            await frontend.shutdown()
            await worker.shutdown()
        finally:
            await srv.stop()

    run(go())


def test_tcp_client_reconnects_after_server_restart():
    async def go():
        srv = await EndpointTcpServer().start()
        srv.register("s", EchoEngine())
        port = srv.port
        client = await EndpointTcpClient("127.0.0.1", port, "s").connect()

        async def one():
            return [o async for o in client.generate(Context([1, 2, 3]))]

        assert await one() == [1, 2, 3]
        await srv.stop()  # severs the live connection
        await asyncio.sleep(0.05)
        srv2 = await EndpointTcpServer(port=port).start()
        srv2.register("s", EchoEngine())
        try:
            for _ in range(50):
                try:
                    assert await one() == [1, 2, 3]
                    break
                except ConnectionError:
                    await asyncio.sleep(0.05)  # the first call may hit the race
            else:
                raise AssertionError("client never recovered")
        finally:
            await srv2.stop()
        await client.close()

    run(go())


def test_direct_dial_discovery_grace():
    async def go():
        srv = await _coordinator()
        try:
            worker1 = await _runtime(srv.url)
            frontend = await _runtime(srv.url)
            await worker1.namespace("dyn").component("backend").endpoint("generate").serve(
                EchoEngine())
            client = await frontend.namespace("dyn").component("backend").endpoint(
                "generate").client()
            await client.wait_for_instances(1)
            worker2 = await _runtime(srv.url)

            async def register():
                await asyncio.sleep(0.1)
                await worker2.namespace("dyn").component("backend").endpoint(
                    "generate").serve(EchoEngine())

            reg = asyncio.ensure_future(register())
            out = [x async for x in client.direct(Context([7]), worker2.instance_id)]
            await reg
            assert out == [7]
            # an id that never appears exhausts the grace and raises
            t0 = asyncio.get_running_loop().time()
            with pytest.raises(KeyError):
                async for _ in client.direct(Context([1]), 0xdead):
                    pass
            assert asyncio.get_running_loop().time() - t0 >= 0.9
            # a seen-then-deleted id gets no grace
            await worker2.shutdown()
            assert await client._wait_until(lambda: worker2.instance_id in client._removed, 5.0)
            t0 = asyncio.get_running_loop().time()
            with pytest.raises(KeyError):
                async for _ in client.direct(Context([1]), worker2.instance_id):
                    pass
            assert asyncio.get_running_loop().time() - t0 < 0.5
            await client.close()
            await frontend.shutdown()
            await worker1.shutdown()
        finally:
            await srv.stop()

    run(go())


def test_lease_expiry_while_connected_heals():
    async def go():
        srv = await _coordinator()
        try:
            c = await CoordinatorClient(srv.url, reconnect=True).connect()
            lease = await c.lease_create(0.6)
            assert await c.kv_create("heal/worker", {"v": 1}, lease_id=lease)
            srv._revoke_lease(c._lease_srv.get(lease, lease))  # server-side expiry
            reader = await CoordinatorClient(srv.url).connect()
            assert await reader.kv_get("heal/worker") is None
            for _ in range(40):
                await asyncio.sleep(0.1)
                if await reader.kv_get("heal/worker") == {"v": 1}:
                    break
            assert await reader.kv_get("heal/worker") == {"v": 1}
            await reader.close()
            await c.close()
        finally:
            await srv.stop()

    run(go())


def test_leased_write_inside_expiry_window_heals():
    async def go():
        srv = await _coordinator()
        try:
            c = await CoordinatorClient(srv.url, reconnect=True).connect()
            lease = await c.lease_create(30.0)
            assert await c.kv_create("w/a", {"v": 1}, lease_id=lease)
            srv._revoke_lease(c._lease_srv.get(lease, lease))
            assert await c.kv_create("w/b", {"v": 2}, lease_id=lease)
            reader = await CoordinatorClient(srv.url).connect()
            assert await reader.kv_get("w/a") == {"v": 1}
            assert await reader.kv_get("w/b") == {"v": 2}
            await reader.close()
            await c.close()
        finally:
            await srv.stop()

    run(go())


def test_call_waits_out_reconnect_window():
    async def go():
        srv = await _coordinator()
        try:
            c = await CoordinatorClient(srv.url, reconnect=True).connect()
            await c.kv_put("rw/x", {"v": 1})
            c._writer.close()
            await asyncio.sleep(0.05)
            await c.kv_put("rw/y", {"v": 2})
            assert await c.kv_get("rw/y") == {"v": 2}
            await c.close()
        finally:
            await srv.stop()

    run(go())


def test_routed_call_waits_for_first_instance():
    async def go():
        srv = await _coordinator()
        try:
            worker = await _runtime(srv.url)
            frontend = await _runtime(srv.url)
            client = await frontend.namespace("dyn").component("backend").endpoint(
                "generate").client()

            async def late_register():
                await asyncio.sleep(0.15)
                await worker.namespace("dyn").component("backend").endpoint(
                    "generate").serve(EchoEngine())

            reg = asyncio.ensure_future(late_register())
            out = [x async for x in client.generate(Context([4, 5]))]
            await reg
            assert out == [4, 5]
            await client.close()
            await frontend.shutdown()
            await worker.shutdown()
        finally:
            await srv.stop()

    run(go())


def test_discovery_delete_does_not_kill_inflight_stream():
    async def go():
        srv = await _coordinator()
        try:
            worker = await _runtime(srv.url)
            frontend = await _runtime(srv.url)
            await worker.namespace("dyn").component("backend").endpoint("generate").serve(
                SlowEngine())
            client = await frontend.namespace("dyn").component("backend").endpoint(
                "generate").client()
            await client.wait_for_instances(1)
            got = []

            async def consume():
                async for x in client.generate(Context(None)):
                    got.append(x)
                    if len(got) >= 8:
                        return

            task = asyncio.ensure_future(consume())
            await asyncio.sleep(0.03)
            # a TTL expiry's watcher delete, server-side
            prefix = "dyn/components/backend/endpoints/generate/"
            for key in list(srv._kv):
                if key.startswith(prefix):
                    srv._kv.pop(key)
                    await srv._notify_watchers("delete", key, None)
            await task  # all 8 items, not dead mid-stream
            assert got == list(range(8))
            await client.close()
            await frontend.shutdown()
            await worker.shutdown()
        finally:
            await srv.stop()

    run(go())


# ---------------------------------------------------------- router service


def test_router_service_end_to_end():
    async def go():
        srv = await CoordinatorServer(port=0).start()
        rt_router = await DistributedRuntime.connect(RuntimeConfig(coordinator_url=srv.url))
        rt_client = await DistributedRuntime.connect(RuntimeConfig(coordinator_url=srv.url))
        pub = await CoordinatorClient(srv.url).connect()
        try:
            await start_router_service(rt_router, "ns1", block_size=BS)
            prompt = list(range(1, 49))  # 3 full blocks
            wid = 7
            await pub.publish(metrics_subject("ns1", wid), json.dumps({
                "worker_id": wid, "request_active_slots": 1, "request_total_slots": 8,
                "kv_active_blocks": 3, "kv_total_blocks": 64}).encode())
            await pub.publish(events_subject("ns1", wid), json.dumps(event_to_wire(
                1, wid, KvStoredEvent(block_hashes=list(sequence_hashes(prompt, BS)),
                                      parent_hash=None))).encode())
            await asyncio.sleep(0.2)  # subscription delivery
            client = await rt_client.namespace("ns1").component("router").endpoint(
                "generate").client()
            outs = [o async for o in client.generate(Context({"token_ids": prompt + [99, 100]}))]
            assert outs and outs[0]["worker_id"] == wid
            assert outs[0]["overlap_blocks"] == 3
            assert outs[0]["overlap_tokens"] == 3 * BS
        finally:
            await pub.close()
            await rt_client.shutdown()
            await rt_router.shutdown()
            await srv.stop()

    run(go())


# -------------------------------------------------------------- tcp faults


def test_server_death_mid_stream_is_typed_error():
    async def go():
        srv = await EndpointTcpServer().start()
        srv.register("s", SlowEngine(delay_s=0.02))
        client = await EndpointTcpClient("127.0.0.1", srv.port, "s").connect()
        got = []
        with pytest.raises(EndpointDisconnected) as exc_info:
            async for item in client.generate(Context(None)):
                got.append(item)
                if len(got) == 3:
                    await srv.abort()
        assert isinstance(exc_info.value, TransportError)
        assert isinstance(exc_info.value, ConnectionError)
        assert "connection lost" in str(exc_info.value)
        assert got == [0, 1, 2]
        await client.close()

    run(go())


def test_stop_and_kill_after_peer_disconnect_are_noops():
    async def go():
        srv = await EndpointTcpServer().start()
        srv.register("s", SlowEngine(delay_s=0.02))
        client = await EndpointTcpClient("127.0.0.1", srv.port, "s").connect()
        ctx = Context(None)
        got = []
        with pytest.raises(EndpointDisconnected):
            async for item in client.generate(ctx):
                got.append(item)
                if len(got) == 2:
                    await srv.abort()
                    await asyncio.sleep(0.05)
                    ctx.stop_generating()  # a no-op, not a crash
        await client.close()
        srv2 = await EndpointTcpServer().start()
        srv2.register("s", EchoEngine())
        c2 = await EndpointTcpClient("127.0.0.1", srv2.port, "s").connect()
        await c2._send({"type": "stop", "req_id": 999})
        await c2._send({"type": "kill", "req_id": 999})
        assert [x async for x in c2.generate(Context([1, 2]))] == [1, 2]
        await c2.close()
        await srv2.stop()

    run(go())


def test_server_stop_cancels_handlers_promptly():
    async def go():
        srv = await EndpointTcpServer().start()
        srv.register("s", SlowEngine(delay_s=0.05, n=10_000))
        client = await EndpointTcpClient("127.0.0.1", srv.port, "s").connect()
        agen = client.generate(Context(None))
        assert await agen.__anext__() == 0  # request provably in flight
        t0 = asyncio.get_running_loop().time()
        await srv.stop()
        assert asyncio.get_running_loop().time() - t0 < 2.0
        with pytest.raises(EndpointDisconnected):
            await agen.__anext__()
        await client.close()

    run(go())


def test_ping_pong_and_ping_failure():
    async def go():
        srv = await EndpointTcpServer().start()
        srv.register("s", EchoEngine())
        client = await EndpointTcpClient("127.0.0.1", srv.port, "s").connect()
        assert 0 <= await client.ping(timeout=1.0) < 1.0
        assert [x async for x in client.generate(Context([7]))] == [7]
        await srv.stop()
        await asyncio.sleep(0.02)
        with pytest.raises(TransportError):
            await client.ping(timeout=0.3)
        await client.close()
        dead = EndpointTcpClient("127.0.0.1", srv.port, "s")
        with pytest.raises(TransportError):
            await dead.ping(timeout=0.3)
        await dead.close()

    run(go())


def test_fault_hook_drops_and_severs_frames():
    """The server's frame hook (the seam the JAX package's fault injector
    drives): drop the 2nd item frame, then sever at the 2nd item."""
    def nth_item(n, action):
        seen = [0]

        def hook(header):
            if header.get("type") == "item":
                seen[0] += 1
                if seen[0] == n:
                    return action
            return None
        return hook, seen

    async def go():
        srv = await EndpointTcpServer().start()
        srv.register("s", EchoEngine())
        client = await EndpointTcpClient("127.0.0.1", srv.port, "s").connect()
        srv.fault_hook, _ = nth_item(2, "drop")
        assert [x async for x in client.generate(Context([1, 2, 3]))] == [1, 3]
        srv.fault_hook = None
        assert [x async for x in client.generate(Context([1, 2]))] == [1, 2]
        srv.fault_hook, _ = nth_item(2, "sever")
        with pytest.raises(EndpointDisconnected):
            async for _ in client.generate(Context([1, 2, 3])):
                pass
        srv.fault_hook = None
        await srv.stop()
        await client.close()

    run(go())


def test_inflight_tracking_and_wait_idle():
    async def go():
        srv = await EndpointTcpServer().start()
        srv.register("s", SlowEngine(delay_s=0.02, n=5))
        client = await EndpointTcpClient("127.0.0.1", srv.port, "s").connect()
        assert srv.inflight("s") == 0
        assert await srv.wait_idle("s", timeout=0.1) is True
        agen = client.generate(Context(None))
        await agen.__anext__()
        assert srv.inflight("s") == 1
        drained = asyncio.ensure_future(srv.wait_idle("s", timeout=5.0))
        assert [x async for x in agen] == [1, 2, 3, 4]
        assert await drained is True
        assert srv.inflight("s") == 0
        await srv.stop()
        await client.close()

    run(go())


# -------------------------------------------------------------------- wire


def _inputs(pkg):
    return pkg.BackendInput(
        token_ids=[1, 5, 9], sampling=pkg.SamplingOptions(temperature=0.0, top_k=3, seed=7,
                                                          logit_bias={4: -1.5}),
        stops=pkg.StopConditions(max_tokens=4, stop=["w3"]), model="tiny",
        annotations={"k": [1, 2]})


def test_serde_bytes_equal_jax():
    for port_obj, jax_obj in (
            (_inputs(protocols), _inputs(jax_protocols)),
            (protocols.LLMEngineOutput(token_ids=[3], finish_reason=protocols.FinishReason.LENGTH,
                                       cached_tokens=16, logprobs=[-0.5]),
             jax_protocols.LLMEngineOutput(token_ids=[3],
                                           finish_reason=jax_protocols.FinishReason.LENGTH,
                                           cached_tokens=16, logprobs=[-0.5])),
            ({"token_ids": [1, 2], "nested": [{"a": None}]},) * 2):
        raw = serde.dumps(port_obj)
        assert raw == jax_serde.dumps(jax_obj)
        # each package decodes the other's bytes to its own types, and
        # encodes them back to the same bytes (JSON makes int keys strings)
        back, jback = serde.loads(raw), jax_serde.loads(raw)
        assert type(back).__name__ == type(jback).__name__ == type(port_obj).__name__
        assert serde.dumps(back) == jax_serde.dumps(jback) == raw


def test_request_frame_bytes_equal_jax():
    """The bytes each package's endpoint client writes for the same request
    (frame header, subject, serde payload), read off a raw socket."""
    async def first_frame(client_cls, ctx):
        got = asyncio.get_running_loop().create_future()

        async def handle(reader, writer):
            # one frame: two big-endian u32 lengths, then header and payload
            head = await reader.readexactly(8)
            hl, pl = struct.unpack(">II", head)
            got.set_result(head + await reader.readexactly(hl + pl))
            # end the stream cleanly, as a worker with nothing to say would
            framing.write_frame(writer, {"type": "end", "req_id": 1})
            await writer.drain()
            await reader.read()  # until the client closes
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        client = client_cls("127.0.0.1", port, "ns_comp.ep-1f")
        assert [x async for x in client.generate(ctx)] == []
        data = await asyncio.wait_for(got, 5)
        await client.close()
        server.close()
        await server.wait_closed()
        return data

    async def go():
        port_bytes = await first_frame(EndpointTcpClient, Context(_inputs(protocols)))
        jax_bytes = await first_frame(JaxEndpointTcpClient, JaxContext(_inputs(jax_protocols)))
        return port_bytes, jax_bytes

    port_bytes, jax_bytes = run(go())
    assert port_bytes == jax_bytes
    # and the framing encodes an arbitrary header + payload alike
    h, payload = {"type": "item", "req_id": 3, "x": [1.5, None]}, b"\x00\x01payload"
    assert framing.encode_frame(h, payload) == jax_framing.encode_frame(h, payload)


# ------------------------------------------------------- across the packages


BASE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64,
            prefill_buckets=[16, 32, 64, 128])
PROMPTS = ([5, 17, 33, 2, 90, 41, 7], list(range(3, 40)), [250, 3, 3, 3])


@pytest.fixture(scope="module")
def engines():
    """A port and a JAX AsyncLLMEngine on the same tiny f32 model, and the
    JAX engine's greedy streams of PROMPTS (made directly, no runtime)."""
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    model = LlamaModel.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                                       device="cpu"))
    port = AsyncLLMEngine(EngineCore(model, EngineConfig(**BASE), eos_token_ids=[],
                                     device="cpu")).start()
    jeng = JaxAsyncLLMEngine(JaxEngineCore(jmodel, jparams, JaxEngineConfig(**BASE),
                                           eos_token_ids=[])).start()
    try:
        async def direct():
            return [await _stream(jeng, JaxContext, jax_protocols, p) for p in PROMPTS]

        ref = run(direct())
        yield port, jeng, ref
    finally:
        port.shutdown()
        jeng.shutdown()


def _request(pkg, prompt):
    return pkg.BackendInput(token_ids=list(prompt), sampling=pkg.SamplingOptions(temperature=0),
                            stops=pkg.StopConditions(max_tokens=8, ignore_eos=True))


async def _stream(engine, ctx_cls, pkg, prompt):
    return [t async for o in engine.generate(ctx_cls(_request(pkg, prompt)))
            for t in o.token_ids]


@pytest.mark.parametrize("coordinator", ["port", "jax"])
@pytest.mark.parametrize("worker", ["port", "jax"])
def test_worker_answers_the_other_package(engines, worker, coordinator):
    """A worker of one package at dyn://dynamo.backend.generate answers a
    client of the other: the greedy streams of a direct JAX engine."""
    port_engine, jax_engine, ref = engines
    sides = {"port": (DistributedRuntime, RuntimeConfig, Context, protocols, port_engine),
             "jax": (JaxDistributedRuntime, JaxRuntimeConfig, JaxContext, jax_protocols,
                     jax_engine)}
    client_side = "jax" if worker == "port" else "port"

    async def go():
        srv = await (CoordinatorServer if coordinator == "port" else JaxCoordinatorServer)(
            port=0).start()
        rt_cls, cfg_cls, _, _, engine = sides[worker]
        w = await rt_cls.connect(cfg_cls(coordinator_url=srv.url))
        c_rt_cls, c_cfg_cls, ctx_cls, pkg, _ = sides[client_side]
        f = await c_rt_cls.connect(c_cfg_cls(coordinator_url=srv.url))
        try:
            inst = await w.namespace("dynamo").component("backend").endpoint("generate").serve(
                engine)
            client = await f.namespace("dynamo").component("backend").endpoint(
                "generate").client()
            assert await client.wait_for_instances(1, timeout=5) == [inst.instance_id]
            return [await _stream(client, ctx_cls, pkg, p) for p in PROMPTS]
        finally:
            await f.shutdown()
            await w.shutdown()
            await srv.stop()

    assert run(go()) == ref


@pytest.fixture()
def traced():
    was = tracing.enabled()
    tracing.enable(True)
    tracing.collector.reset()
    yield
    tracing.enable(was)
    tracing.collector.reset()


def test_trace_id_crosses_the_wire(engines, traced):
    """A request traced at a port client: the worker's request span, its
    engine's generation and the engine's steps carry the client's trace
    id."""
    port_engine = engines[0]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        w = await DistributedRuntime.connect(RuntimeConfig(coordinator_url=srv.url))
        f = await DistributedRuntime.connect(RuntimeConfig(coordinator_url=srv.url))
        try:
            await w.namespace("dynamo").component("backend").endpoint("generate").serve(
                port_engine)
            client = await f.namespace("dynamo").component("backend").endpoint(
                "generate").client()
            await client.wait_for_instances(1, timeout=5)
            with tracing.start_span("client.root") as root:
                await _stream(client, Context, protocols, PROMPTS[0])
            await port_engine.run_on_engine(lambda: None)  # the last step's span is in
            return root.trace_id
        finally:
            await f.shutdown()
            await w.shutdown()
            await srv.stop()

    trace_id = run(go())
    names = [s["name"] for s in tracing.collector.spans_for_trace(trace_id)]
    assert "client.root" in names and "engine.generate" in names and "engine.step" in names
    assert any(n.startswith("tcp.call.") for n in names)
    assert any(n.startswith("tcp.request.") for n in names)


# ------------------------------------------------ end to end in subprocesses


ENGINE_FLAGS = ["--dtype", "float32", "--max-model-len", "64", "--num-blocks", "16",
                "--max-batch-size", "2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("runtime") / "tiny"
    make_tiny_hf_checkpoint(d)
    return d


def _get(url, timeout=2.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def test_coordinator_worker_models_http_subprocesses(tiny_dir):
    """``coordinator``, ``run in=dyn:// out=gpu --device cpu``, ``models
    add`` and ``http``, each a process as a user starts them: the HTTP
    answer is a direct engine's greedy text, and every process exits 0 on
    SIGTERM."""
    from dynamo_tpu_torch.cli import build_local_engine, parse_args
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.openai import parse_request

    cport, hport = _free_port(), _free_port()
    coord = f"tcp://127.0.0.1:{cport}"
    ep = "dyn://dynamo.backend.generate"
    body = {"model": "tiny", "prompt": "hello world w3 w5", "max_tokens": 6, "temperature": 0}

    def spawn(*args):
        return subprocess.Popen([sys.executable, "-m", PKG, *args], cwd=str(REPO), env=_env(),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = {"coordinator": spawn("coordinator", "--host", "127.0.0.1", "--port", str(cport))}
    try:
        deadline = time.monotonic() + 15
        while True:
            try:
                socket.create_connection(("127.0.0.1", cport), timeout=0.5).close()
                break
            except OSError:
                assert time.monotonic() < deadline, "no coordinator"
                time.sleep(0.05)
        procs["worker"] = spawn("run", f"in={ep}", "out=gpu", "--device", "cpu",
                                "--model-path", str(tiny_dir), "--coordinator", coord,
                                *ENGINE_FLAGS)
        procs["http"] = spawn("http", "--http-port", str(hport), "--coordinator", coord)
        added = subprocess.run([sys.executable, "-m", PKG, "models", "add", "tiny", ep,
                                "--model-path", str(tiny_dir), "--coordinator", coord],
                               cwd=str(REPO), env=_env(), capture_output=True, text=True,
                               timeout=30)
        assert added.returncode == 0 and added.stdout.strip() == f"added tiny -> {ep}", added
        listed = subprocess.run([sys.executable, "-m", PKG, "models", "list", "--coordinator",
                                 coord], cwd=str(REPO), env=_env(), capture_output=True,
                                text=True, timeout=30)
        assert listed.stdout.strip() == f"tiny\t{ep}", listed
        base = f"http://127.0.0.1:{hport}"
        answer = None
        while answer is None:
            assert all(p.poll() is None for p in procs.values()), {
                k: p.poll() for k, p in procs.items()}
            assert time.monotonic() < deadline + 30, "no answer from the frontend"
            try:
                if [m["id"] for m in _get(f"{base}/v1/models")["data"]] != ["tiny"]:
                    time.sleep(0.1)
                    continue
                req = urllib.request.Request(f"{base}/v1/completions",
                                             data=json.dumps(body).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as r:
                    answer = json.loads(r.read())
            except OSError:  # frontend not up, or the worker not yet registered
                time.sleep(0.1)
    finally:
        for name in ("http", "worker", "coordinator"):
            p = procs.get(name)
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
        logs = {}
        for name, p in procs.items():
            try:
                logs[name] = (p.wait(timeout=20), p.stdout.read())
            except subprocess.TimeoutExpired:
                p.kill()
                logs[name] = (p.wait(), p.stdout.read())
    assert all(rc == 0 for rc, _ in logs.values()), logs
    assert "serving tiny at dyn://dynamo.backend.generate" in logs["worker"][1]

    engine, card = build_local_engine(parse_args(["run", "in=http", "out=gpu", "--device", "cpu",
                                                  "--model-path", str(tiny_dir),
                                                  "--model-name", "tiny", *ENGINE_FLAGS]))
    try:
        pipe = build_serving_pipeline(engine, card)

        async def direct():
            ctx = Context(parse_request(body, chat=False))
            return "".join([o.text or "" async for o in pipe.generate(ctx)])

        text = asyncio.run(direct())
    finally:
        engine.shutdown()
    assert answer["choices"][0]["text"] == text
    assert answer["choices"][0]["finish_reason"] == "length"


def test_worker_lease_outlives_a_slow_engine_build(tiny_dir, monkeypatch):
    """``run in=dyn://`` builds its engine off the event loop: a build that
    blocks for most of the lease TTL must not hold back the first
    keepalive.  Held back, the lease lapses after the worker registered,
    and discovery drops the worker (a delete) until the keepalive's heal
    puts it back; a request routed in that window finds no instance."""
    from dynamo_tpu_torch import cli

    ttl, build_s = 3.0, 2.4
    real_build, real_config = cli.build_local_engine, cli._runtime_config

    def slow_build(args):
        time.sleep(build_s)  # blocking, as a CUDA context and a weight load are
        return real_build(args)

    monkeypatch.setattr(cli, "build_local_engine", slow_build)
    monkeypatch.setattr(cli, "_runtime_config",
                        lambda args: dataclasses.replace(real_config(args), lease_ttl_s=ttl))

    async def go():
        srv = await CoordinatorServer(port=0).start()
        watcher = await CoordinatorClient(srv.url).connect()
        events = []
        await watcher.watch("dynamo/components/backend/", lambda ev, key, value: events.append(ev))
        args = cli.parse_args(["run", "in=dyn://dynamo.backend.generate", "out=echo",
                               "--model-path", str(tiny_dir), "--coordinator", srv.url])
        worker = asyncio.ensure_future(cli._cmd_run(args))
        try:
            t0 = time.monotonic()
            while "put" not in events:
                assert time.monotonic() - t0 < 10 and not worker.done(), events
                await asyncio.sleep(0.05)
            await asyncio.sleep(ttl + 1.5)  # past the lapse a held-back keepalive leaves
            return list(events)
        finally:
            worker.cancel()
            await asyncio.gather(worker, return_exceptions=True)
            await watcher.close()
            await srv.stop()

    assert asyncio.run(go()) == ["put"]


def test_close_writer_survives_a_cancelled_second_closer():
    """Two closers await one writer's close (a reconnect loop tearing down
    a severed socket, and ``close()`` stopping that loop): cancelling one
    must not cancel the other's wait, which returns as the close lands."""
    async def go():
        peers = []
        server = await asyncio.start_server(lambda r, w: peers.append(w), "127.0.0.1", 0)
        _, writer = await asyncio.open_connection(
            "127.0.0.1", server.sockets[0].getsockname()[1])
        try:
            first = asyncio.ensure_future(framing.close_writer(writer))
            second = asyncio.ensure_future(framing.close_writer(writer))
            await asyncio.sleep(0)  # both are awaiting the close now
            first.cancel()
            await asyncio.gather(first, second, return_exceptions=True)
            return first.cancelled(), second.exception()
        finally:
            for peer in peers:
                await framing.close_writer(peer)
            server.close()
            await server.wait_closed()

    assert asyncio.run(go()) == (True, None)
