"""The port's streamed KV handoff, and disaggregation across the packages.

Mirrors ``tests/test_kv_stream.py``: layer-wise session parity over both
transfer-client surfaces (TCP and the colocated in-process path) and for
the int8 cache's (data, scale) pair; a torn stream (bad sha, wrong frame
count, out-of-order seq) is a miss and a version mismatch is refused;
``choose_handoff_path`` both ways and the router's transfer-cost veto; the
``/metrics`` lines; and the streamed handoff end to end on two of the
port's engines (chunked prefill), token-identical to the blocking push
and to the JAX engine's local stream, its first layer frame on the wire
before the prefill engine's generate span closes, and a stream severed
mid-session falling back to the whole-cache push.

Then the two packages together, over TCP: a bf16 payload packs to the
JAX package's bytes and a session's sha256 is the JAX session's; a port
``CoordinatorClient`` and ``PrefillQueue`` work against the JAX
``CoordinatorServer``; a JAX prefill worker feeds a port decode worker
and a port prefill worker feeds a JAX decode worker, with the f32 and the
int8 cache, and each stream equals the JAX engine's local one.
"""

import asyncio
import contextlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import AsyncLLMEngine as JaxAsyncLLMEngine
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import disagg_router as jax_router
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.llm import workers as jax_workers
from dynamo_tpu.llm.kv import stream as jax_stream
from dynamo_tpu.llm.kv import transfer as jax_transfer
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.transports import coordinator as jax_coordinator
from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.counters import kv_stream_counters
from dynamo_tpu_torch.llm.disagg_router import DisaggregatedRouter, DisaggRouterConf
from dynamo_tpu_torch.llm.http.metrics import Metrics
from dynamo_tpu_torch.llm.kv import transfer
from dynamo_tpu_torch.llm.kv.stream import KvStreamSession, choose_handoff_path
from dynamo_tpu_torch.llm.kv.transfer import (KvTransferClient, KvTransferServer,
                                              LocalKvTransferClient, pack_blocks)
from dynamo_tpu_torch.llm.protocols import (BackendInput, SamplingOptions, StopConditions)
from dynamo_tpu_torch.llm.workers import (DecodeWorker, PrefillQueue, PrefillWorker,
                                          RemotePrefillRequest)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.obs import tracing
from dynamo_tpu_torch.obs.costs import transfer_costs
from dynamo_tpu_torch.obs.metric_names import KvStreamMetric as STM
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer
from dynamo_tpu_torch.runtime.transports.protocol import TransferOp

BASE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64)


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _stream_state():
    """The stream counters and the measured-cost tables are process-wide."""
    for k in transfer.stats:
        transfer.stats[k] = 0
    kv_stream_counters.reset()
    transfer_costs.reset()
    yield
    kv_stream_counters.reset()
    transfer_costs.reset()


# ------------------------------------------------ session parity (unit) ----


def _sink_server():
    applied = []

    async def sink(ids, arr, rid):
        applied.append((list(ids), arr, rid))

    async def notify(rid, first_token, error):
        pass

    return applied, KvTransferServer(write_sink=sink, notify_cb=notify)


@pytest.mark.parametrize("surface", ["tcp", "local"])
def test_stream_session_parity_both_surfaces(surface):
    """One KvStreamSession drives either client surface and the decode side
    admits one complete, bit-exact cache."""
    gen = torch.Generator().manual_seed(11)
    chunks = [torch.randn((2, 2, 3), generator=gen) for _ in range(2)]
    full = torch.cat(chunks, dim=1)

    async def go():
        applied, srv = _sink_server()
        await srv.start()
        try:
            cli = await KvTransferClient.connect(srv.url, force_tcp=(surface == "tcp"))
            assert isinstance(cli, LocalKvTransferClient) == (surface == "local")
            sess = KvStreamSession(cli, "req-1", num_layers=2)
            await sess.begin()
            for ids, arr in zip([[0, 1], [2, 3]], chunks):
                await sess.write_chunk(ids, arr)
            resp = await sess.end()
            assert resp.get("applied_blocks") == 4
            await cli.close()
        finally:
            await srv.stop()
            await asyncio.sleep(0.05)  # let the handler task reap
        return applied

    ((ids, arr, rid),) = run(go())
    assert ids == [0, 1, 2, 3] and rid == "req-1"
    assert torch.equal(arr, full)
    assert kv_stream_counters.sessions_total == 1
    assert kv_stream_counters.layers_sent_total == 4
    assert kv_stream_counters.bytes_total == full.numel() * 4


def test_stream_session_parity_int8_tuple():
    """The int8 cache's (data, scale) pair rides the multi-part header and
    reassembles into the same tuple of stacks."""
    gen = torch.Generator().manual_seed(12)
    data = torch.randint(-128, 128, (2, 4, 3), generator=gen, dtype=torch.int8)
    scale = torch.randn((2, 4, 1), generator=gen)

    async def go():
        applied, srv = _sink_server()
        await srv.start()
        try:
            cli = await KvTransferClient.connect(srv.url, force_tcp=True)
            sess = KvStreamSession(cli, "req-q", num_layers=2)
            await sess.begin()
            await sess.write_chunk([0, 1], (data[:, :2], scale[:, :2]))
            await sess.write_chunk([2, 3], (data[:, 2:], scale[:, 2:]))
            await sess.end()
            await cli.close()
        finally:
            await srv.stop()
            await asyncio.sleep(0.05)
        return applied

    ((ids, arr, rid),) = run(go())
    assert ids == [0, 1, 2, 3] and rid == "req-q"
    assert isinstance(arr, tuple) and len(arr) == 2
    assert arr[0].dtype == torch.int8 and torch.equal(arr[0], data)
    assert torch.equal(arr[1], scale)


# -------------------------------------------------- torn stream = miss ----


def _torn_case(tamper):
    """A 1-chunk/2-layer session whose completion ``tamper`` corrupts:
    NOTHING is admitted, and a late END cannot admit it either."""
    chunk = torch.randn((2, 2, 3), generator=torch.Generator().manual_seed(13))

    async def go():
        applied, srv = _sink_server()
        await srv.start()
        try:
            cli = await KvTransferClient.connect(srv.url, force_tcp=True)
            sess = KvStreamSession(cli, "req-t", num_layers=2)
            await sess.begin()
            await sess.write_chunk([0, 1], chunk)
            with pytest.raises(RuntimeError):
                await tamper(cli, sess)
            with pytest.raises(RuntimeError):
                await cli.stream_end({"session": sess.session_id, "frames": 2,
                                      "sha": sess._sha.hexdigest()})
            await cli.close()
            assert srv.assembler.completed == 0
            assert srv.assembler.rejected >= 1
        finally:
            await srv.stop()
            await asyncio.sleep(0.05)
        return applied

    assert run(go()) == []


async def _bad_sha(cli, sess):
    await cli.stream_end({"session": sess.session_id, "frames": 2, "sha": "0" * 64})


async def _wrong_count(cli, sess):
    await cli.stream_end({"session": sess.session_id, "frames": 1,
                          "sha": sess._sha.hexdigest()})


async def _out_of_order(cli, sess):
    # a skipped sequence number = frames lost on the wire
    await cli.write_layer({"session": sess.session_id, "seq": 7, "chunk": 1, "layer": 0,
                           "block_ids": [2], "dtype": "float32", "shape": [1, 3]},
                          np.zeros((1, 3), np.float32).tobytes())


@pytest.mark.parametrize("tamper", [_bad_sha, _wrong_count, _out_of_order],
                         ids=["bad_sha", "wrong_frame_count", "out_of_order_seq"])
def test_torn_stream_is_miss(tamper):
    _torn_case(tamper)


def test_stream_begin_version_mismatch_rejected():
    async def go():
        applied, srv = _sink_server()
        await srv.start()
        try:
            cli = await KvTransferClient.connect(srv.url, force_tcp=True)
            with pytest.raises(RuntimeError):
                await cli.stream_begin({"v": 99, "session": "s", "request_id": "r",
                                        "num_layers": 1})
            await cli.close()
        finally:
            await srv.stop()
            await asyncio.sleep(0.05)
        return applied

    assert run(go()) == []


# --------------------------------------------- transfer-aware routing ----


def test_choose_handoff_path_both_directions():
    # a measured fast TCP edge, nothing in persist: stream over the wire
    transfer_costs.record("p", "d", "dcn", 100_000_000, 0.1)  # 1 GB/s
    path, cost = choose_handoff_path("p", "d", 8_000_000, persist_resident_blocks=0,
                                     total_blocks=4)
    assert path == "dcn" and 0 < cost < 1.0
    # slow wire, fast persist restore of the whole prefix: restore wins
    transfer_costs.record("p2", "d", "dcn", 1_000_000, 1.0)  # 1 MB/s
    transfer_costs.record("d", "d", "persist", 100_000_000, 0.1)
    path2, cost2 = choose_handoff_path("p2", "d", 8_000_000, persist_resident_blocks=4,
                                       total_blocks=4)
    assert path2 == "persist" and cost2 < transfer_costs.cost_s("p2", "d", "dcn", 8_000_000)
    # a partial persist hit still pays the wire for the rest: with a glacial
    # persist tier the wire keeps the whole transfer
    transfer_costs.record("p3", "d3", "dcn", 100_000_000, 0.1)
    transfer_costs.record("d3", "d3", "persist", 1_000_000, 10.0)
    path3, _ = choose_handoff_path("p3", "d3", 8_000_000, persist_resident_blocks=2,
                                   total_blocks=4)
    assert path3 == "dcn"
    # colocated: the on-card path, priced by its prior until measured
    path4, cost4 = choose_handoff_path("p", "d9", 8_000_000, local=True)
    assert path4 == "ici" and not transfer_costs.measured("p", "d9", "ici") and cost4 < cost


def test_router_max_transfer_cost_vetoes_remote():
    r = DisaggregatedRouter(DisaggRouterConf(max_local_prefill_length=0,
                                             max_transfer_cost_s=0.5))
    assert r.prefill_remote(100, 0, 0, transfer_cost_s=0.4) is True
    assert r.prefill_remote(100, 0, 0, transfer_cost_s=0.6) is False
    # the default conf: transfer cost never vetoes
    r2 = DisaggregatedRouter(DisaggRouterConf(max_local_prefill_length=0))
    assert r2.prefill_remote(100, 0, 0, transfer_cost_s=1e9) is True


def test_metrics_render_stream_counters():
    kv_stream_counters.record_session()
    kv_stream_counters.record_layer(100, 0.01, hidden=True)
    kv_stream_counters.record_layer(100, 0.01, hidden=False)
    kv_stream_counters.record_fallback()
    text = Metrics().render()
    assert f"{STM.SESSIONS_TOTAL} 1" in text
    assert f"{STM.LAYERS_SENT_TOTAL} 2" in text
    assert f"{STM.BYTES_TOTAL} 200" in text
    assert f"{STM.FALLBACKS_TOTAL} 1" in text
    assert f"{STM.OVERLAP_RATIO} 0.5" in text


# ------------------------------------------------- in-process disagg e2e ----


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))


def jax_local(models, prompt, n, **cfg_kw):
    """The JAX EngineCore's greedy stream for one prompt."""
    jmodel, jparams, _ = models
    core = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**BASE, **cfg_kw))
    outs = []
    core.submit(JaxEngineRequest(request_id="ref", prompt=list(prompt),
                                 sampling=jax_protocols.SamplingOptions(temperature=0.0),
                                 stops=jax_protocols.StopConditions(max_tokens=n),
                                 emit=outs.append))
    for _ in range(500):
        if not core.has_work():
            break
        core.step()
    return [t for o in outs for t in o.token_ids]


@pytest.fixture()
def force_tcp(monkeypatch):
    monkeypatch.setenv("DYN_KV_TRANSFER_FORCE_TCP", "1")


@pytest.fixture()
def traced():
    was = tracing.enabled()
    tracing.enable(True)
    tracing.collector.reset()
    yield tracing
    tracing.enable(was)
    tracing.collector.reset()


def _engine(model, chunk=None, cache_dtype=None):
    kw = dict(BASE, **({"prefill_chunk_tokens": chunk} if chunk else {}),
              **({"cache_dtype": cache_dtype} if cache_dtype else {}))
    return AsyncLLMEngine(EngineCore(model, EngineConfig(**kw), device="cpu")).start()


def _ctx(prompt, n):
    return Context(BackendInput(token_ids=list(prompt), sampling=SamplingOptions(temperature=0.0),
                                stops=StopConditions(max_tokens=n)))


# the longest the prefill engine holds its last chunk for the first layer
# frame (seconds); a handoff that streams only after compute waits it out
HOLD_LAST_CHUNK_S = 10.0


def _hold_last_chunk(core, chunk: int, first_layer: threading.Event, hold: dict) -> None:
    """Keep ``core`` from dispatching a request's last prefill chunk until
    ``first_layer`` is set (the decode side's server took a layer frame) or
    HOLD_LAST_CHUNK_S has passed (``hold["gave_up"]``).  The engine thread
    goes on stepping meanwhile, so the stream's gathers still run."""
    real = core._prefill_ready
    hold["gave_up"] = False

    def ready(req):
        if not real(req):
            return False
        if req.prompt_len - req.computed_tokens > chunk or first_layer.is_set():
            return True
        deadline = hold.setdefault("deadline", time.monotonic() + HOLD_LAST_CHUNK_S)
        if time.monotonic() < deadline:
            return False
        hold["gave_up"] = True
        return True

    core._prefill_ready = ready


async def _disagg_run(model, prompt, n, *, stream, chunk=16, sever_at=None, cache_dtype=None,
                      hold=None):
    """One in-process disagg generation on a fresh coordinator and engine
    pair (chunked prefill), streamed or blocking, optionally severing the
    connection at the ``sever_at``-th layer frame, or (``hold``, a dict the
    run fills) holding the prefill's last chunk until the first layer frame
    has landed (:func:`_hold_last_chunk`).  Returns (tokens, root span)."""
    ctx = _ctx(prompt, n)
    srv = await CoordinatorServer(port=0).start()
    decode_engine = _engine(model, cache_dtype=cache_dtype)
    prefill_engine = _engine(model, chunk=chunk, cache_dtype=cache_dtype)
    try:
        c_dec = await CoordinatorClient(srv.url).connect()
        c_pre = await CoordinatorClient(srv.url).connect()
        worker = DecodeWorker(decode_engine, coordinator=c_dec, namespace="kvs",
                              router=DisaggregatedRouter(
                                  DisaggRouterConf(max_local_prefill_length=0), namespace="kvs"))
        await worker.start()
        if sever_at is not None:
            seen = []

            def hook(frame):
                if frame["type"] == TransferOp.WRITE_LAYER:
                    seen.append(frame)
                    if len(seen) == sever_at:
                        return "sever"
                return None

            worker._transfer.fault_hook = hook
        if hold is not None:
            first_layer = threading.Event()

            def mark(frame):
                if frame["type"] == TransferOp.WRITE_LAYER:
                    first_layer.set()
                return None

            worker._transfer.fault_hook = mark
            _hold_last_chunk(prefill_engine.core, chunk, first_layer, hold)
        prefill = PrefillWorker(prefill_engine, c_pre, "kvs", stream=stream)
        prefill_task = asyncio.ensure_future(prefill.run())
        root = tracing.start_span("http.request", attrs={"request_id": ctx.id})
        toks = [t for o in await worker.generate_all(ctx) for t in o.token_ids]
        root.end()
        assert prefill.handled == 1
        assert prefill_engine.core._held == {}
        await asyncio.sleep(0.3)  # let the prefill side's spans land
        prefill.request_stop()
        await prefill_task
        await worker.stop()
        await c_dec.close()
        await c_pre.close()
        return toks, root
    finally:
        decode_engine.shutdown()
        prefill_engine.shutdown()
        await srv.stop()
        await asyncio.sleep(0.05)


def _span_descendants(spans, root_id):
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    out, todo = [], [root_id]
    while todo:
        sid = todo.pop()
        for s in kids.get(sid, []):
            out.append(s)
            todo.append(s["span"])
    return out


def test_disagg_streamed_parity_and_overlap(models, force_tcp, traced):
    """The streamed handoff gives the blocking push's tokens (the JAX
    engine's local stream) and overlaps: with the prefill engine's last
    chunk held until the decode side's server has taken the first layer
    frame (at most HOLD_LAST_CHUNK_S), that frame lands while compute is
    still to come, so before the prefill engine's generate span closes.  A
    handoff that sends only after compute never lands a frame during the
    hold and fails."""
    _, _, model = models
    prompt = np.random.default_rng(5).integers(1, 256, size=64).tolist()
    expected = jax_local(models, prompt, 6)
    toks_blocking, _ = run(_disagg_run(model, prompt, 6, stream=False))
    assert toks_blocking == expected

    kv_stream_counters.reset()
    transfer_costs.reset()
    tracing.collector.reset()
    hold = {}
    toks_streamed, root = run(_disagg_run(model, prompt, 6, stream=True, hold=hold))
    assert toks_streamed == expected
    assert not hold["gave_up"], "no layer frame landed while the last chunk was held"
    assert kv_stream_counters.sessions_total == 1
    assert kv_stream_counters.fallbacks_total == 0
    # 64 tokens in 16-token chunks of 8-token blocks, 2 layers
    assert kv_stream_counters.layers_sent_total >= 4
    assert kv_stream_counters.bytes_total > 0
    assert kv_stream_counters.overlap_ratio > 0

    spans = tracing.collector.spans_for_trace(root.trace_id)
    names = [s["name"] for s in spans]
    assert {"kv.stream.produce", "kv.server.write_layer", "kv.server.stream_end"} <= set(names)
    assert "kv.write_blocks" not in names  # no blocking push happened
    dp = next(s for s in spans if s["name"] == "disagg.prefill")
    eng = next(s for s in _span_descendants(spans, dp["span"]) if s["name"] == "engine.generate")
    first_layer_ts = min(s["ts"] for s in spans if s["name"] == "kv.server.write_layer")
    assert first_layer_ts < eng["ts"] + eng["dur"]
    assert any(k[2] == "dcn" for k in transfer_costs.snapshot())


def test_disagg_midstream_sever_falls_back_to_parity(models, force_tcp, traced):
    """A sever at the 2nd layer frame kills the stream: the worker falls
    back to the whole-cache push on a fresh connection, the tokens are the
    same, and the fallback is counted."""
    _, _, model = models
    prompt = np.random.default_rng(6).integers(1, 256, size=64).tolist()
    expected = jax_local(models, prompt, 6)
    toks, root = run(_disagg_run(model, prompt, 6, stream=True, sever_at=2))
    assert toks == expected
    assert kv_stream_counters.fallbacks_total >= 1
    names = [s["name"] for s in tracing.collector.spans_for_trace(root.trace_id)]
    assert "kv.write_blocks" in names and "kv.server.write_blocks" in names


def test_disagg_streamed_parity_int8_cache(models, force_tcp):
    """The int8 cache's pair streams as multi-part layer frames and decodes
    to the JAX engine's local tokens over the int8 cache."""
    _, _, model = models
    prompt = np.random.default_rng(7).integers(1, 256, size=48).tolist()
    expected = jax_local(models, prompt, 5, cache_dtype="int8")
    toks, _ = run(_disagg_run(model, prompt, 5, stream=True, cache_dtype="int8"))
    assert toks == expected
    assert kv_stream_counters.sessions_total == 1
    assert kv_stream_counters.fallbacks_total == 0
    assert kv_stream_counters.layers_sent_total >= 2


def test_colocated_streamed_handoff(models):
    """The streamed session over the colocated surface: the same tokens,
    with the session's frames counted and no TCP write."""
    _, _, model = models
    prompt = np.random.default_rng(8).integers(1, 256, size=40).tolist()
    expected = jax_local(models, prompt, 5)
    toks, _ = run(_disagg_run(model, prompt, 5, stream=True))
    assert toks == expected
    assert kv_stream_counters.sessions_total == 1 and kv_stream_counters.fallbacks_total == 0
    assert transfer.stats["tcp_write_calls"] == 0
    assert any(k[2] == "ici" for k in transfer_costs.snapshot())


# ------------------------------------------------- across the two packages ----


def test_bf16_pack_bytes_equal_jax():
    vals = np.random.default_rng(3).standard_normal((2, 3, 2, 4, 6)).astype(np.float32)
    jarr = np.asarray(jnp.asarray(vals, dtype=jnp.bfloat16))
    tarr = torch.from_numpy(vals).to(torch.bfloat16)
    assert pack_blocks(tarr) == jax_transfer.pack_blocks(jarr)
    # and each side unpacks the other's
    meta, data = jax_transfer.pack_blocks(jarr)
    assert torch.equal(transfer.unpack_blocks(meta, data), tarr)
    back = jax_transfer.unpack_blocks(*pack_blocks(tarr))
    assert np.array_equal(back.view(np.uint16), jarr.view(np.uint16))


class _Recorder:
    """A client surface that records a session's frames."""

    is_local = False
    url = ""

    def __init__(self):
        self.frames = []

    async def stream_begin(self, header):
        return {}

    async def write_layer(self, header, payload):
        self.frames.append((dict(header, session=None), payload))
        return {}

    async def stream_end(self, header):
        self.frames.append(("end", header["frames"], header["sha"]))
        return {}


def test_stream_session_sha_equals_jax():
    """Two bf16 chunks of a 3-layer stack and an int8 pair: the same frame
    headers and payload bytes, and the same completion sha, from either
    package's session."""
    vals = np.random.default_rng(4).standard_normal((3, 4, 2, 2, 8)).astype(np.float32)
    jbf = np.asarray(jnp.asarray(vals, dtype=jnp.bfloat16))
    tbf = torch.from_numpy(vals).to(torch.bfloat16)
    q = np.random.default_rng(5).integers(-127, 128, (3, 2, 2, 2, 8)).astype(np.int8)
    sc = np.random.default_rng(6).random((3, 2, 2, 8, 128)).astype(np.float32)

    async def go(session_cls, chunks):
        rec = _Recorder()
        sess = session_cls(rec, "r", num_layers=3, session_id="s")
        await sess.begin()
        for ids, arr in chunks:
            await sess.write_chunk(ids, arr)
        await sess.end()
        return rec.frames

    for jchunks, tchunks in (
            ([([0, 1], jbf[:, :2]), ([2, 3], jbf[:, 2:])],
             [([0, 1], tbf[:, :2]), ([2, 3], tbf[:, 2:])]),
            ([([5, 6], (q, sc))], [([5, 6], (torch.from_numpy(q), torch.from_numpy(sc)))])):
        ref = run(go(jax_stream.KvStreamSession, jchunks))
        out = run(go(KvStreamSession, tchunks))
        assert out == ref


def test_port_queue_against_jax_coordinator():
    """A port CoordinatorClient and PrefillQueue against the JAX server; a
    JAX queue pulls what the port pushed, and the router's published conf
    reaches a JAX router's watch."""
    async def go():
        srv = await jax_coordinator.CoordinatorServer(port=0).start()
        try:
            c = await CoordinatorClient(srv.url).connect()
            jc = await jax_coordinator.CoordinatorClient(srv.url).connect()
            rpr = RemotePrefillRequest(
                request_id="r1", token_ids=[1, 2, 3], block_ids=[7, 8], skip_blocks=1,
                transfer_url="tcp://127.0.0.1:1",
                sampling=SamplingOptions(temperature=0.5, seed=3))
            q, jq = PrefillQueue(c, "x"), jax_workers.PrefillQueue(jc, "x")
            await q.push(rpr)
            assert await q.size() == 1 and await jq.size() == 1
            msg_id, got = await jq.pull(timeout_s=1.0)
            assert got.to_wire() == rpr.to_wire()
            await jq.ack(msg_id)
            assert await q.size() == 0
            jr = jax_router.DisaggregatedRouter(namespace="x")
            await jr.watch(jc)
            await DisaggregatedRouter(namespace="x").publish(
                c, DisaggRouterConf(max_local_prefill_length=7))
            await asyncio.sleep(0.1)
            assert jr.conf.max_local_prefill_length == 7
            await c.close()
            await jc.close()
        finally:
            await srv.stop()
            await asyncio.sleep(0.05)

    run(go())


@contextlib.asynccontextmanager
async def _cross_pair(decode_engine, prefill_engine, decode_pkg, prefill_pkg, ns):
    """A JAX coordinator, a decode worker of ``decode_pkg`` and a prefill
    worker of ``prefill_pkg`` (each module namespace: workers, router,
    coordinator), every prompt sent remote."""
    srv = await jax_coordinator.CoordinatorServer(port=0).start()
    try:
        c_dec = await decode_pkg["coord"].CoordinatorClient(srv.url).connect()
        c_pre = await prefill_pkg["coord"].CoordinatorClient(srv.url).connect()
        router = decode_pkg["router"].DisaggregatedRouter(
            decode_pkg["router"].DisaggRouterConf(max_local_prefill_length=0), namespace=ns)
        worker = decode_pkg["workers"].DecodeWorker(decode_engine, coordinator=c_dec,
                                                    namespace=ns, router=router)
        await worker.start()
        prefill = prefill_pkg["workers"].PrefillWorker(prefill_engine, c_pre, ns)
        task = asyncio.ensure_future(prefill.run())
        try:
            yield worker, prefill
        finally:
            prefill.request_stop()
            await task
            await worker.stop()
            await c_dec.close()
            await c_pre.close()
    finally:
        await srv.stop()
        await asyncio.sleep(0.05)


def _pkgs():
    """The port's and the JAX package's worker, router and coordinator
    modules under the same keys."""
    from dynamo_tpu_torch.llm import disagg_router, workers
    from dynamo_tpu_torch.runtime.transports import coordinator

    port = {"coord": coordinator, "router": disagg_router, "workers": workers}
    jax_pkg = {"coord": jax_coordinator, "router": jax_router, "workers": jax_workers}
    return port, jax_pkg


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
@pytest.mark.parametrize("direction", ["jax_prefill_port_decode", "port_prefill_jax_decode"])
def test_cross_package_handoff_over_tcp(models, cache_dtype, direction):
    """One package's prefill worker feeds the other's decode worker over
    TCP: the stream equals the JAX engine's local one, and the handed-over
    parts are (int8, f32) with the int8 cache."""
    jmodel, jparams, model = models
    prompt = np.random.default_rng(9).integers(1, 256, size=30).tolist()
    kw = {"cache_dtype": cache_dtype} if cache_dtype else {}
    expected = jax_local(models, prompt, 8, **kw)
    port, jax_pkg = _pkgs()
    jax_engine = JaxAsyncLLMEngine(JaxEngineCore(jmodel, jparams,
                                                 JaxEngineConfig(**BASE, **kw))).start()
    port_engine = _engine(model, cache_dtype=cache_dtype)
    if direction == "jax_prefill_port_decode":
        pair = (port_engine, jax_engine, port, jax_pkg)
        ctx, decode_core = _ctx(prompt, 8), port_engine.core
    else:
        pair = (jax_engine, port_engine, jax_pkg, port)
        ctx = JaxContext(jax_protocols.BackendInput(
            token_ids=list(prompt), sampling=jax_protocols.SamplingOptions(temperature=0.0),
            stops=jax_protocols.StopConditions(max_tokens=8)))
        decode_core = jax_engine.core
    seen = []
    real = decode_core.scatter_external

    def spy(block_ids, blocks, request_id=None):
        parts = blocks if isinstance(blocks, (tuple, list)) else (blocks,)
        seen.append([str(p.dtype).replace("torch.", "") for p in parts])
        return real(block_ids, blocks, request_id)

    decode_core.scatter_external = spy

    async def go():
        async with _cross_pair(*pair, "xp") as (worker, prefill):
            toks = [t for o in await worker.generate_all(ctx) for t in o.token_ids]
            assert prefill.handled == 1
            return toks

    try:
        assert run(go()) == expected
    finally:
        del decode_core.scatter_external
        jax_engine.shutdown()
        port_engine.shutdown()
    assert seen == [["int8", "float32"] if cache_dtype else ["float32"]]


def test_stream_end_assembles_off_the_event_loop(monkeypatch):
    """The decode side's END copies every staged layer frame into the
    cache layout before the write; for a long prompt that copy takes
    hundreds of ms, so it runs off the event loop: the sanitizer's
    blocking monitor sees no loop callback over its 0.25 s threshold while
    an assembly that takes 0.3 s runs, and the session still applies."""
    import hashlib

    from dynamo_tpu_torch.analysis.sanitizer import BlockingCallbackMonitor
    from dynamo_tpu_torch.llm.kv import stream as port_stream

    real = port_stream._Assembly.assemble

    def slow(self):
        time.sleep(0.3)
        return real(self)

    monkeypatch.setattr(port_stream._Assembly, "assemble", slow)
    applied = []

    async def sink(ids, arr, rid):
        applied.append((ids, arr, rid))

    async def run():
        asm = port_stream.KvStreamAssembler(sink)
        asm.begin({"v": port_stream.STREAM_VERSION, "session": "s", "request_id": "r",
                   "num_layers": 2, "op": TransferOp.STREAM_BEGIN})
        sha = hashlib.sha256()
        for layer in range(2):
            meta, data = transfer.pack_blocks(torch.full((1, 8), float(layer + 1)))
            sha.update(data)
            asm.write_layer({"session": "s", "seq": layer, "chunk": 0, "layer": layer,
                             "block_ids": [0], **meta}, data)
        return await asm.end({"session": "s", "frames": 2, "sha": sha.hexdigest()})

    mon = BlockingCallbackMonitor(threshold_s=0.25)
    mon.install()
    try:
        mon.begin_epoch()
        assert asyncio.run(run()) == {"applied_blocks": 1}
        reports = mon.reports_in_epoch()
    finally:
        mon.uninstall()
    assert not reports, [r.render() for r in reports]
    ((ids, arr, rid),) = applied
    assert ids == [0] and rid == "r" and tuple(arr.shape) == (2, 1, 8)
