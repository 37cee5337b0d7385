"""Disaggregated prefill/decode through the port, against the JAX engine.

Mirrors ``tests/test_disagg.py`` (all but its tensor-parallel decode
case): the transfer plane and the router engine-free, then a decode worker
and a prefill worker on two of the port's engines in one process, with a
coordinator.  Both engines serve the JAX package's random init of
``ModelConfig.tiny()`` carried over by ``params_from_jax`` (f32, on the
CPU), and every remote-prefill greedy stream must equal the JAX
``EngineCore``'s local stream for the same prompt token for token: over
TCP with the f32 and the int8 cache (a second request hitting the decode
side's prefix cache, so ``skip_blocks > 0``), and on the colocated path
(blocks handed over as tensors, no host staging, no TCP).  Then a
cancelled remote prefill, JSON mode across the split, and a decode worker
that speculates.
"""

import asyncio
import contextlib

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.counters import kv_stream_counters
from dynamo_tpu_torch.engine.grammar import INIT_STATE, JsonGrammar
from dynamo_tpu_torch.llm.disagg_router import DisaggregatedRouter, DisaggRouterConf
from dynamo_tpu_torch.llm.kv import transfer
from dynamo_tpu_torch.llm.kv.transfer import (KvTransferClient, KvTransferServer, pack_blocks,
                                              unpack_blocks)
from dynamo_tpu_torch.llm.protocols import (BackendInput, FinishReason, SamplingOptions,
                                            StopConditions)
from dynamo_tpu_torch.llm.workers import (DecodeWorker, PrefillQueue, PrefillWorker,
                                          RemotePrefillRequest)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.obs.costs import transfer_costs
from dynamo_tpu_torch.ops import block_copy
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer

BASE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64)
EOS = 2


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_plane():
    """The transfer stats, cost table and stream counters are process-wide."""
    for k in transfer.stats:
        transfer.stats[k] = 0
    transfer_costs.reset()
    kv_stream_counters.reset()
    yield
    transfer_costs.reset()
    kv_stream_counters.reset()


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))


def jax_local(models, requests, **cfg_kw):
    """The JAX EngineCore's greedy streams, one request at a time:
    ``requests`` is [(prompt, max_tokens)]."""
    jmodel, jparams, _ = models
    core = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**BASE, **cfg_kw))
    streams = []
    for i, (prompt, n) in enumerate(requests):
        outs = []
        core.submit(JaxEngineRequest(
            request_id=f"ref-{i}", prompt=list(prompt),
            sampling=jax_protocols.SamplingOptions(temperature=0.0),
            stops=jax_protocols.StopConditions(max_tokens=n), emit=outs.append))
        for _ in range(500):
            if not core.has_work():
                break
            core.step()
        streams.append([t for o in outs for t in o.token_ids])
    return streams


def make_engine(model, **kw):
    return AsyncLLMEngine(EngineCore(model, EngineConfig(**{**BASE, **kw}), device="cpu")).start()


async def drain(engine_like, prompt, n, **sampling):
    ctx = Context(BackendInput(token_ids=list(prompt),
                               sampling=SamplingOptions(**{"temperature": 0.0, **sampling}),
                               stops=StopConditions(max_tokens=n)))
    return [t for o in await engine_like.generate_all(ctx) for t in o.token_ids]


@contextlib.asynccontextmanager
async def disagg_pair(model, ns, decode_kw=None, prefill_kw=None, prefill_worker=True,
                      max_local=0):
    """A coordinator, a decode worker routing every prompt longer than
    ``max_local`` to the prefill queue, and (unless ``prefill_worker`` is
    False) a prefill worker pulling it; everything stopped on exit."""
    srv = await CoordinatorServer(port=0).start()
    decode_engine = make_engine(model, **(decode_kw or {}))
    prefill_engine = make_engine(model, **(prefill_kw or {}))
    clients, task = [], None
    try:
        c_dec = await CoordinatorClient(srv.url).connect()
        clients.append(c_dec)
        worker = DecodeWorker(decode_engine, coordinator=c_dec, namespace=ns,
                              router=DisaggregatedRouter(
                                  DisaggRouterConf(max_local_prefill_length=max_local),
                                  namespace=ns))
        await worker.start()
        prefill = None
        if prefill_worker:
            c_pre = await CoordinatorClient(srv.url).connect()
            clients.append(c_pre)
            prefill = PrefillWorker(prefill_engine, c_pre, ns)
            task = asyncio.ensure_future(prefill.run())
        try:
            yield worker, prefill, c_dec
        finally:
            if prefill is not None:
                prefill.request_stop()
                await task
            await worker.stop()
            for c in clients:
                await c.close()
    finally:
        decode_engine.shutdown()
        prefill_engine.shutdown()
        await srv.stop()
        await asyncio.sleep(0.05)  # let the servers' handler tasks reap


@pytest.fixture()
def force_tcp(monkeypatch):
    """Pin the transfer plane to the wire: colocated engines would
    otherwise take the in-process shortcut (covered by its own test)."""
    monkeypatch.setenv("DYN_KV_TRANSFER_FORCE_TCP", "1")


# ---------------------------------------------------------- transfer plane ----


@pytest.mark.parametrize("kind", ["float32", "int8_pair", "bfloat16"])
def test_pack_unpack_roundtrip(kind):
    gen = torch.Generator().manual_seed(0)
    if kind == "int8_pair":
        arr = (torch.randint(-127, 128, (2, 3, 2, 4, 6), generator=gen, dtype=torch.int8),
               torch.rand((2, 3, 2, 8, 128), generator=gen))
    else:
        arr = torch.randn((2, 3, 2, 4, 6), generator=gen).to(getattr(torch, kind))
    meta, data = pack_blocks(arr)
    out = unpack_blocks(meta, data)
    parts = arr if isinstance(arr, tuple) else (arr,)
    outs = out if isinstance(out, tuple) else (out,)
    assert len(outs) == len(parts)
    for a, b in zip(parts, outs):
        assert b.dtype == a.dtype and b.shape == a.shape and b.device.type == "cpu"
        assert torch.equal(a, b)
    if kind == "bfloat16":
        assert meta == {"dtype": "bfloat16", "shape": [2, 3, 2, 4, 6]}
        assert len(data) == arr.numel() * 2
    if kind == "int8_pair":
        assert [m["dtype"] for m in meta["parts"]] == ["int8", "float32"]


def test_transfer_server_write_read_notify():
    async def go():
        store = torch.zeros((2, 8, 2, 4, 6))  # a [L, N, 2, Bs, HkD] pool
        notifications = []

        async def sink(block_ids, arr, request_id=None):
            block_copy.scatter_blocks_inplace(store, block_ids, arr)

        async def source(block_ids):
            return block_copy.gather_blocks(store, block_ids)

        async def notify(rid, tok, err):
            notifications.append((rid, tok, err))

        srv = await KvTransferServer(sink, notify, source).start()
        try:
            client = await KvTransferClient.connect(srv.url, force_tcp=True)
            blocks = np.random.default_rng(0).standard_normal((2, 3, 2, 4, 6)).astype(np.float32)
            await client.write_blocks([1, 5, 2], blocks)
            assert torch.equal(store[:, [1, 5, 2]], torch.from_numpy(blocks))
            got = await client.read_blocks([5, 2])
            assert torch.equal(got, store[:, [5, 2]])
            await client.notify("req-1", 42)
            assert notifications == [("req-1", 42, None)]
            await client.close()
        finally:
            await srv.stop()
            await asyncio.sleep(0.05)
        assert transfer.stats["tcp_write_calls"] == 1 and transfer.stats["tcp_blocks"] == 3

    run(go())


@pytest.mark.parametrize("quant", [False, True])
def test_block_copy_gather_scatter(quant):
    """Both parts of an int8 cache move whole, pad lanes included; blocks
    are cast to the cache's dtype."""
    gen = torch.Generator().manual_seed(1)
    if quant:
        from dynamo_tpu_torch.ops.kv_quant import QuantKvCache

        cache = QuantKvCache(torch.randint(-127, 128, (2, 6, 2, 4, 8), generator=gen,
                                           dtype=torch.int8),
                             torch.rand((2, 6, 2, 8, 128), generator=gen))
        parts = tuple(cache)
    else:
        cache = torch.randn((2, 6, 2, 4, 8), generator=gen)
        parts = (cache,)
    got = block_copy.gather_blocks(cache, [4, 1])
    got_parts = tuple(got) if quant else (got,)
    assert type(got) is type(cache)
    for p, g in zip(parts, got_parts):
        assert torch.equal(g, p[:, [4, 1]])
    assert block_copy.gather_blocks_padded is block_copy.gather_blocks
    moved = block_copy.scatter_blocks(cache, [0, 5], got)
    for p, m in zip(parts, tuple(moved) if quant else (moved,)):
        assert torch.equal(m[:, [0, 5]], p[:, [4, 1]]) and torch.equal(m[:, 1:5], p[:, 1:5])
    if not quant:  # f64 blocks land as the cache's f32
        block_copy.scatter_blocks_inplace(cache, [3], got[:, :1].double())
        assert cache.dtype == torch.float32 and torch.equal(cache[:, 3], got[:, 0])


# ------------------------------------------------------------ disagg router ----


def test_disagg_decision():
    r = DisaggregatedRouter(DisaggRouterConf(max_local_prefill_length=100,
                                             max_prefill_queue_size=2))
    assert r.prefill_remote(prefill_length=500, prefix_hit_length=0, queue_size=0)
    # a prefix hit shrinks the effective prefill below the threshold
    assert not r.prefill_remote(prefill_length=500, prefix_hit_length=450, queue_size=0)
    # a deep queue forces local
    assert not r.prefill_remote(prefill_length=500, prefix_hit_length=0, queue_size=2)


def test_disagg_conf_hot_reload():
    async def go():
        srv = await CoordinatorServer(port=0).start()
        try:
            c = await CoordinatorClient(srv.url).connect()
            r = DisaggregatedRouter(namespace="ns1")
            await r.watch(c)
            assert r.conf.max_local_prefill_length == 512
            await r.publish(c, DisaggRouterConf(max_local_prefill_length=64,
                                                max_prefill_queue_size=4))
            await asyncio.sleep(0.1)
            assert r.conf.max_local_prefill_length == 64
            assert r.conf.max_prefill_queue_size == 4
            await c.close()
        finally:
            await srv.stop()

    run(go())


def test_prefill_queue_roundtrip():
    async def go():
        srv = await CoordinatorServer(port=0).start()
        try:
            c = await CoordinatorClient(srv.url).connect()
            q = PrefillQueue(c, "nsq")
            rpr = RemotePrefillRequest(
                request_id="r1", token_ids=[1, 2, 3], block_ids=[7, 8], skip_blocks=1,
                transfer_url="tcp://127.0.0.1:1", sampling=SamplingOptions(temperature=0.0))
            await q.push(rpr)
            assert await q.size() == 1
            msg_id, got = await q.pull(timeout_s=1.0)
            assert got == rpr
            assert await q.size() == 1  # unacked still counts (backpressure)
            await q.ack(msg_id)
            assert await q.size() == 0
            await c.close()
        finally:
            await srv.stop()

    run(go())


# ------------------------------------------------------------- full e2e -------


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_disagg_e2e_matches_jax_local(models, force_tcp, cache_dtype, monkeypatch):
    """Remote-prefill decode gives the JAX engine's local greedy tokens,
    also for a second request that hits the decode side's prefix cache
    (``skip_blocks > 0``); with the int8 cache the wire carries (int8, f32)
    pairs; a short prompt under a raised threshold stays local."""
    _, _, model = models
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, 256, size=30).tolist()
    prompt3 = rng.integers(1, 256, size=12).tolist()
    kw = {"cache_dtype": cache_dtype} if cache_dtype else {}
    expected, expected3 = jax_local(models, [(prompt, 8), (prompt3, 4)], **kw)
    assert len(expected) == 8

    payload_parts: list = []
    real_pack = transfer.pack_blocks

    def spy_pack(arr):
        parts = list(arr) if isinstance(arr, (tuple, list)) else [arr]
        payload_parts.append([str(p.dtype).replace("torch.", "") for p in parts])
        return real_pack(arr)

    monkeypatch.setattr(transfer, "pack_blocks", spy_pack)

    async def go():
        async with disagg_pair(model, "e2e", kw, kw) as (worker, prefill, c_dec):
            assert await drain(worker, prompt, 8) == expected
            assert prefill.handled == 1
            assert prefill.engine.core._held == {}  # released after transfer
            assert payload_parts[0] == (["int8", "float32"] if cache_dtype else ["float32"])
            # the decode side's prefix cache holds the first 3 full blocks now
            assert worker._prefix_hit(prompt)[0] == 24
            assert await drain(worker, prompt, 8) == expected
            assert prefill.handled == 2
            await worker.router.publish(c_dec, DisaggRouterConf(max_local_prefill_length=1000))
            await asyncio.sleep(0.1)
            assert await drain(worker, prompt3, 4) == expected3
            assert prefill.handled == 2  # handled locally
            assert worker.engine.core.metrics()["prefill_dispatches_total"] == 1

    run(go())
    assert transfer.stats["tcp_write_calls"] == 2 and transfer.stats["local_write_calls"] == 0
    # the second push skipped the three blocks the decode side held
    assert transfer.stats["tcp_blocks"] == 4 + 1


def test_colocated_handoff_skips_host_staging(models, monkeypatch):
    """Colocated engines move KV blocks as tensors, never through the host
    gather or the wire; the stats count only local writes."""
    _, _, model = models
    prompt = np.random.default_rng(13).integers(1, 256, size=30).tolist()
    (expected,) = jax_local(models, [(prompt, 8)])
    staged = {"np_gathers": 0, "packs": 0, "scatter_types": []}
    real_gather_np = EngineCore.gather_blocks_np
    real_scatter = EngineCore.scatter_external
    real_pack = transfer.pack_blocks

    def spy_gather_np(self, bids):
        staged["np_gathers"] += 1
        return real_gather_np(self, bids)

    def spy_scatter(self, bids, blocks, request_id=None):
        staged["scatter_types"].append(type(blocks))
        return real_scatter(self, bids, blocks, request_id)

    def spy_pack(arr):
        staged["packs"] += 1
        return real_pack(arr)

    monkeypatch.setattr(EngineCore, "gather_blocks_np", spy_gather_np)
    monkeypatch.setattr(EngineCore, "scatter_external", spy_scatter)
    monkeypatch.setattr(transfer, "pack_blocks", spy_pack)

    async def go():
        async with disagg_pair(model, "ici") as (worker, prefill, _):
            assert await drain(worker, prompt, 8) == expected
            assert prefill.handled == 1

    run(go())
    assert staged["np_gathers"] == 0 and staged["packs"] == 0
    assert staged["scatter_types"] == [torch.Tensor]
    assert transfer.stats["local_write_calls"] == 1 and transfer.stats["local_blocks"] == 4
    assert transfer.stats["tcp_write_calls"] == 0
    assert any(path == "ici" for _, _, path in transfer_costs.snapshot())


def test_remote_prefill_cancellation(models):
    """Aborting a stalled remote-prefill request frees its slot and blocks;
    a late notify is ignored and a late KV write dropped."""
    _, _, model = models

    async def go():
        async with disagg_pair(model, "cx", prefill_worker=False) as (worker, _, _c):
            ctx = Context(BackendInput(token_ids=list(range(1, 30)),
                                       sampling=SamplingOptions(temperature=0.0),
                                       stops=StopConditions(max_tokens=4)))
            outs = []

            async def consume():
                async for out in worker.generate(ctx):
                    outs.append(out)

            task = asyncio.ensure_future(consume())
            await asyncio.sleep(0.3)
            assert await worker.queue.size() == 1  # enqueued, nobody pulling
            ctx.stop_generating()
            await asyncio.wait_for(task, timeout=5)
            assert outs and outs[-1].finish_reason is FinishReason.CANCELLED

            engine = worker.engine
            core = engine.core
            await engine.run_on_engine(lambda: core.complete_remote_prefill(ctx.id, 3))
            before = core.cache.clone()
            stale = np.ones((2, 1, 2, 8, core.cache.shape[-1]), np.float32)
            await engine.run_on_engine(
                lambda: core.scatter_external([0], stale, request_id=ctx.id))
            assert torch.equal(core.cache, before)
            assert core.block_manager.active_blocks == 0

    run(go())


def test_disagg_json_mode_end_to_end(models, force_tcp):
    """JSON mode across the split: the prefill worker samples the
    grammar-masked first token, the decode worker continues the automaton
    from it, and the text parses as JSON (or is a prefix the tables
    accept)."""
    import json as _json

    _, _, model = models
    toks: list = [None] * 256
    for b in range(125):
        toks[3 + b] = bytes([b])
    grammar = JsonGrammar.from_token_bytes(toks, eos_ids=[EOS])

    def grammar_engine():
        return AsyncLLMEngine(EngineCore(model, EngineConfig(**BASE), device="cpu",
                                         eos_token_ids=[EOS], grammar=grammar)).start()

    async def go():
        srv = await CoordinatorServer(port=0).start()
        decode_engine, prefill_engine = grammar_engine(), grammar_engine()
        try:
            c_dec = await CoordinatorClient(srv.url).connect()
            c_pre = await CoordinatorClient(srv.url).connect()
            worker = DecodeWorker(decode_engine, coordinator=c_dec, namespace="jdis",
                                  router=DisaggregatedRouter(
                                      DisaggRouterConf(max_local_prefill_length=0),
                                      namespace="jdis"))
            await worker.start()
            prefill = PrefillWorker(prefill_engine, c_pre, "jdis")
            task = asyncio.ensure_future(prefill.run())
            ctx = Context(BackendInput(token_ids=list(range(5, 25)),
                                       sampling=SamplingOptions(temperature=1.0, json_mode=True),
                                       stops=StopConditions(max_tokens=40)))
            outs = [o async for o in worker.generate(ctx)]
            assert prefill.handled == 1
            prefill.request_stop()
            await task
            await worker.stop()
            await c_dec.close()
            await c_pre.close()
            return outs
        finally:
            decode_engine.shutdown()
            prefill_engine.shutdown()
            await srv.stop()
            await asyncio.sleep(0.05)

    outs = run(go())
    ids = [t for o in outs for t in o.token_ids]
    assert ids
    if outs[-1].finish_reason is FinishReason.EOS:
        raw = b"".join(toks[t] for t in ids if t != EOS and toks[t])
        _json.loads(raw.decode("utf-8", errors="replace"))
    else:  # LENGTH: a valid JSON prefix — replay the automaton
        s, d, st = INIT_STATE, 0, 0
        for t in ids:
            assert grammar.tables.valid_mask(s, d, st)[t]
            s, d, st = grammar.tables.advance(s, d, st, t)


def test_disagg_decode_with_speculation(models, force_tcp):
    """Prompt-lookup speculation on the DECODE worker composes with remote
    prefill: the JAX engine's local greedy tokens, with verify turns."""
    _, _, model = models
    pat = np.random.default_rng(11).integers(1, 256, size=6).tolist()
    prompt = (pat * 4)[:22]
    (expected,) = jax_local(models, [(prompt, 10)])

    async def go():
        async with disagg_pair(model, "spdis", decode_kw=dict(spec_tokens=4)) as (worker,
                                                                                   prefill, _):
            assert await drain(worker, prompt, 10) == expected
            assert prefill.handled == 1
            assert worker.engine.core.spec_steps > 0

    run(go())
