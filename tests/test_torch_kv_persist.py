"""The port's persistent prefix-cache tier, against the JAX package's.

Mirrors ``tests/test_kv_persist.py``: the content-addressed store (spill,
match, load, tuple structure, restart, generation invalidation, a corrupt
file as a miss, TTL, size cap, counters, import/export), restart-warm
restores through the port's ``EngineCore`` (the JAX package's random init
of ``ModelConfig.tiny()`` over ``params_from_jax``, f32, on the CPU), a
cross-replica restore over the port's coordinator, the replicator, the
pre-warm actuator and the event wire with a tier.  Across the packages:
the file bytes of one block group are equal, a store directory written by
either package is read by the other, the generation tag is equal for the
same config, and a store written by a JAX engine warm-restores a port
engine with the JAX engine's stream, and the reverse.
"""

import asyncio
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.llm.kv import events as jax_events
from dynamo_tpu.llm.kv.persist import PersistentKvStore as JaxPersistentKvStore
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.ops.kv_quant import QuantKvCache as JaxQuantKvCache
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.counters import persist_counters
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm.http.metrics import Metrics
from dynamo_tpu_torch.llm.kv.events import (KvRemovedEvent, KvStoredEvent, event_from_wire,
                                            event_to_wire)
from dynamo_tpu_torch.llm.kv.persist import (PersistentKvStore, PersistReplicator,
                                             PrewarmActuator, prewarm_key)
from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.obs.metric_names import EngineMetric as EM
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))


def _blocks(n, shape=(2, 3, 8, 4), seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + shape).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------- store unit ---


def test_store_spill_match_load_roundtrip(tmp_path):
    store = PersistentKvStore(tmp_path, generation="g1")
    hashes = [11, 22, 33]
    data = _blocks(3)
    assert store.spill(hashes, data) > 0
    assert store.match_prefix([11, 22, 33, 44]) == [11, 22, 33]
    np.testing.assert_array_equal(_np(store.load([11, 22, 33])), data)
    # re-spill of resident content writes nothing new
    assert store.spill(hashes, _blocks(3, seed=9)) == 0
    np.testing.assert_array_equal(_np(store.load(hashes)), data)
    store.close()


def test_store_tuple_structure_roundtrip(tmp_path):
    store = PersistentKvStore(tmp_path, generation="g1")
    data = (_blocks(2, seed=1), _blocks(2, shape=(4, 2), seed=2))
    store.spill([7, 8], data)
    out = store.load([7, 8])
    assert isinstance(out, tuple) and len(out) == 2
    np.testing.assert_array_equal(_np(out[0]), data[0])
    np.testing.assert_array_equal(_np(out[1]), data[1])
    store.close()


def test_store_int8_and_bf16_blocks_roundtrip_bit_exact(tmp_path):
    """An int8 cache's batch comes back as a QuantKvCache, a bf16 one as
    bf16, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    q = QuantKvCache(torch.randint(-127, 128, (2, 2, 2, 8, 4), generator=gen, dtype=torch.int8),
                     torch.rand((2, 2, 2, 8, 128), generator=gen))
    bf = torch.randn((2, 2, 2, 8, 4), generator=gen).to(torch.bfloat16)
    store = PersistentKvStore(tmp_path, generation="g")
    store.spill([1, 2], q)
    store.spill([3, 4], bf)
    got = store.load([2, 1])
    assert isinstance(got, QuantKvCache)
    assert torch.equal(got.data, q.data[[1, 0]]) and torch.equal(got.scale, q.scale[[1, 0]])
    got = store.load([3, 4])
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                       bf.view(torch.int16))
    store.close()


def test_store_restart_reindexes_same_generation(tmp_path):
    hashes = [101, 102]
    data = _blocks(2, seed=3)
    store = PersistentKvStore(tmp_path, generation="gen-a")
    store.spill(hashes, data)
    store.close()
    store2 = PersistentKvStore(tmp_path, generation="gen-a")
    assert sorted(store2.resident_hashes()) == sorted(hashes)
    assert store2.match_prefix(hashes) == hashes
    np.testing.assert_array_equal(_np(store2.load(hashes)), data)
    store2.close()


def test_store_generation_invalidation(tmp_path):
    store = PersistentKvStore(tmp_path, generation="gen-a")
    store.spill([1, 2], _blocks(2))
    store.close()
    store2 = PersistentKvStore(tmp_path, generation="gen-b")
    assert store2.resident_hashes() == []
    assert store2.match_prefix([1, 2]) == []
    assert not (tmp_path / "gen-a").exists()
    store2.close()


def test_store_corrupt_file_is_a_miss_not_a_crash(tmp_path):
    store = PersistentKvStore(tmp_path, generation="g1")
    store.spill([5, 6], _blocks(2))
    files = store.export_files()
    assert len(files) == 1
    _, path, _, _ = files[0]
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF  # flip a payload byte → sha mismatch
    path.write_bytes(bytes(raw))
    with pytest.raises(KeyError):
        store.load([5, 6])
    assert store.stats()["persist_invalid_files"] == 1
    assert store.match_prefix([5, 6]) == []
    assert sorted(store.drain_removed()) == [5, 6]
    store.close()


def test_store_ttl_eviction(tmp_path):
    now = [1000.0]
    store = PersistentKvStore(tmp_path, generation="g1", ttl_s=60.0, clock=lambda: now[0])
    store.spill([1, 2], _blocks(2))
    assert store.match_prefix([1, 2]) == [1, 2]
    now[0] += 120.0
    assert store.match_prefix([1, 2]) == []  # expired → reclaimed in place
    assert store.stats()["persist_evicted_blocks"] == 2
    assert sorted(store.drain_removed()) == [1, 2]
    assert store.stats()["persist_resident_bytes"] == 0
    store.close()


def test_store_size_cap_evicts_lru_first(tmp_path):
    now = [0.0]
    probe = PersistentKvStore(tmp_path / "probe", generation="g")
    one_file = probe.spill([999], _blocks(1))
    probe.close()
    store = PersistentKvStore(tmp_path / "main", generation="g", max_bytes=3 * one_file,
                              clock=lambda: now[0])
    for i, h in enumerate([1, 2, 3]):
        now[0] = float(i)
        store.spill([h], _blocks(1, seed=i))
    now[0] = 10.0
    store.load([1])  # LRU refresh happens on load (match is a probe)
    now[0] = 11.0
    store.spill([4], _blocks(1, seed=4))  # over cap → evict oldest
    resident = set(store.resident_hashes())
    assert resident == {1, 3, 4}
    assert store.stats()["persist_evicted_files"] == 1
    assert 2 in store.drain_removed()
    store.close()


def test_store_hit_miss_counters(tmp_path):
    store = PersistentKvStore(tmp_path, generation="g1")
    store.spill([1], _blocks(1))
    store.match_prefix([1])
    store.match_prefix([42])  # nothing matched → one miss
    s = store.stats()
    assert s["persist_hits"] == 1 and s["persist_misses"] == 1
    store.close()


def test_store_import_export_file(tmp_path):
    a = PersistentKvStore(tmp_path / "a", generation="g")
    data = _blocks(2, seed=5)
    a.spill([61, 62], data)
    (stem, path, hashes, size) = a.export_files()[0]
    assert hashes == [61, 62] and size == path.stat().st_size
    b = PersistentKvStore(tmp_path / "b", generation="g")
    assert b.import_file(path.read_bytes()) == 2
    np.testing.assert_array_equal(_np(b.load([61, 62])), data)
    assert b.has_file(stem)
    assert b.import_file(path.read_bytes()) == 0  # already resident
    a.close()
    b.close()


# ------------------------------------------------------ across the packages


def _bf16(n, seed):
    return _blocks(n, seed=seed).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "tuple"])
def test_block_group_file_bytes_equal_jax(tmp_path, kind):
    """The same blocks spilled by both stores at the same clock: the same
    file name and the same bytes."""
    if kind == "float32":
        ref = _blocks(3, seed=1)
        port = torch.from_numpy(ref.copy())
    elif kind == "bfloat16":
        ref = _bf16(3, seed=1)
        port = torch.from_numpy(ref.view(np.int16).copy()).view(torch.bfloat16)
    else:
        ref = (_blocks(3, seed=1), _blocks(3, shape=(4, 2), seed=2).astype(np.int8))
        port = tuple(torch.from_numpy(a.copy()) for a in ref)
    clock = lambda: 1234.5  # noqa: E731
    a = PersistentKvStore(tmp_path / "port", generation="g", clock=clock)
    b = JaxPersistentKvStore(tmp_path / "jax", generation="g", clock=clock)
    assert a.spill([7, 8, 9], port) == b.spill([7, 8, 9], ref) > 0
    [(stem_a, path_a, _, _)] = a.export_files()
    [(stem_b, path_b, _, _)] = b.export_files()
    assert stem_a == stem_b and path_a.name == path_b.name
    assert path_a.read_bytes() == path_b.read_bytes()
    a.close()
    b.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_directory_read_by_the_other_package(tmp_path, writer):
    data = _bf16(4, seed=3)
    words = torch.from_numpy(data.view(np.int16).copy())
    if writer == "port":
        w = PersistentKvStore(tmp_path, generation="g")
        w.spill([1, 2, 3, 4], words.view(torch.bfloat16))
        w.close()
        r = JaxPersistentKvStore(tmp_path, generation="g")
        got = r.load([2, 3])
        assert got.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(got.view(np.int16), data[1:3].view(np.int16))
    else:
        w = JaxPersistentKvStore(tmp_path, generation="g")
        w.spill([1, 2, 3, 4], data)
        w.close()
        r = PersistentKvStore(tmp_path, generation="g")
        got = r.load([2, 3])
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), words[1:3])
    assert sorted(r.resident_hashes()) == [1, 2, 3, 4]
    r.close()


def test_int8_block_group_written_by_the_port_loads_in_jax(tmp_path):
    """The port writes an int8 batch under ``quant``; the JAX store rebuilds
    it as its QuantKvCache with the same bytes."""
    gen = torch.Generator().manual_seed(1)
    q = QuantKvCache(torch.randint(-127, 128, (2, 2, 2, 8, 4), generator=gen, dtype=torch.int8),
                     torch.rand((2, 2, 2, 8, 128), generator=gen))
    w = PersistentKvStore(tmp_path, generation="g")
    w.spill([5, 6], q)
    w.close()
    r = JaxPersistentKvStore(tmp_path, generation="g")
    got = r.load([5, 6])
    assert isinstance(got, JaxQuantKvCache)
    np.testing.assert_array_equal(got.data, q.data.numpy())
    np.testing.assert_array_equal(got.scale, q.scale.numpy())
    r.close()


@pytest.mark.parametrize("cache_dtype", [None, "int8", "float32"])
def test_generation_equals_jax(models, cache_dtype):
    jmodel, _, model = models
    dt = cache_dtype or model.config.dtype
    assert EngineCore._persist_generation(model, dt) == \
        JaxEngineCore._persist_generation(jmodel, cache_dtype or jmodel.config.dtype)
    assert EngineCore._persist_generation(model, dt) != EngineCore._persist_generation(
        model, "bfloat16")


# ------------------------------------------------------ engine restart-warm


def _persist_cfg(persist_dir, **kw):
    return dict(max_batch_size=2, max_model_len=64, block_size=8, num_blocks=8,
                num_host_blocks=32, kv_persist_dir=str(persist_dir), **kw)


def collect_greedy(core, prompt, n, request_id="r1"):
    outs = []
    req = EngineRequest(request_id=request_id, prompt=list(prompt),
                        sampling=SamplingOptions(temperature=0.0),
                        stops=StopConditions(max_tokens=n), emit=outs.append)
    core.submit(req)
    for _ in range(n + 40):
        if not core.step():
            break
    return [t for o in outs for t in o.token_ids], outs, req


def jax_collect_greedy(core, prompt, n, request_id="r1"):
    outs = []
    req = JaxEngineRequest(request_id=request_id, prompt=list(prompt),
                           sampling=jax_protocols.SamplingOptions(temperature=0.0),
                           stops=jax_protocols.StopConditions(max_tokens=n), emit=outs.append)
    core.submit(req)
    for _ in range(n + 40):
        if not core.step():
            break
    return [t for o in outs for t in o.token_ids], outs, req


def _port_core(models, persist_dir, **kw):
    return EngineCore(models[2], EngineConfig(**_persist_cfg(persist_dir, **kw)), device="cpu")


def _jax_core(models, persist_dir, **kw):
    return JaxEngineCore(models[0], models[1], JaxEngineConfig(**_persist_cfg(persist_dir, **kw)))


def _fill_and_close(core, collect, prompt, n=6):
    """Decode the prompt on a cold engine, churn it out to the host (which
    writes through to persist), then close the engine."""
    rng = np.random.RandomState(99)
    got, _, _ = collect(core, prompt, n, request_id="cold")
    for i in range(4):
        collect(core, list(rng.randint(1, 128, size=24)), 2, request_id=f"churn{i}")
    core.flush_host_offload()
    assert core.metrics()["persist_blocks"] > 0, "host publishes should write through"
    core.close()
    return got


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_restart_warm_restores_prefix(models, tmp_path, cache_dtype):
    """A fresh engine (empty host pool) over the same persist dir restores
    the prefix and decodes as before — and as the JAX engine decodes."""
    persist_counters.reset()
    prompt = list(np.random.RandomState(7).randint(1, 128, size=24))
    got1 = _fill_and_close(_port_core(models, tmp_path, cache_dtype=cache_dtype),
                           collect_greedy, prompt)
    core2 = _port_core(models, tmp_path, cache_dtype=cache_dtype)
    assert core2.host_pool.stored_blocks == 0  # genuinely cold host tier
    got2, _, req2 = collect_greedy(core2, prompt, 6, request_id="warm")
    assert req2.cached_tokens > 0, "persist restore should shorten prefill"
    assert got2 == got1
    assert core2.metrics()["persist_hits"] > 0
    assert persist_counters.hits_total > 0
    text = Metrics(core=core2).render()
    line = next(x for x in text.splitlines() if x.startswith(f"{EM.PERSIST_HITS_TOTAL} "))
    assert float(line.split()[-1]) > 0
    core2.close()
    jcore = JaxEngineCore(models[0], models[1], JaxEngineConfig(
        max_batch_size=2, max_model_len=64, block_size=8, num_blocks=8, cache_dtype=cache_dtype))
    assert jax_collect_greedy(jcore, prompt, 6)[0] == got1


def test_restart_with_different_generation_is_cold(models, tmp_path):
    prompt = list(np.random.RandomState(11).randint(1, 128, size=24))
    _fill_and_close(_port_core(models, tmp_path), collect_greedy, prompt)
    core2 = _port_core(models, tmp_path, cache_dtype="int8")  # another cache layout
    assert core2.persist_store.resident_hashes() == []
    core2.close()


def test_persist_disabled_by_default(models):
    core = EngineCore(models[2], EngineConfig(max_batch_size=2, max_model_len=64, block_size=8,
                                              num_blocks=8, num_host_blocks=32), device="cpu")
    assert core.persist_store is None
    assert "persist_blocks" not in core.metrics()
    assert core.persist_hit_blocks([1, 2]) == 0
    core.close()


def test_persist_needs_the_host_tier(models, tmp_path, caplog):
    core = EngineCore(models[2], EngineConfig(max_model_len=64, block_size=8, num_blocks=8,
                                              kv_persist_dir=str(tmp_path)), device="cpu")
    assert core.persist_store is None
    assert "ignored: the persistent tier stages through the host pool" in caplog.text


def test_restart_announces_resident_blocks_as_persist_events(models, tmp_path):
    prompt = list(np.random.RandomState(5).randint(1, 128, size=24))
    _fill_and_close(_port_core(models, tmp_path), collect_greedy, prompt)
    core = _port_core(models, tmp_path)
    seen = []
    core.block_manager.event_sink = seen.append
    core.step()  # events drain on the engine thread
    stored = [e for e in seen if isinstance(e, KvStoredEvent) and e.tier == "persist"]
    assert stored and sorted(stored[0].block_hashes) == sorted(
        core.persist_store.resident_hashes())
    hashes = [h for h in core.persist_store.resident_hashes()]
    assert core.persist_hit_blocks(hashes[:1]) == 1
    core.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_warm_restores_across_the_packages(models, tmp_path, writer):
    """A store written by one package's engine warm-restores the other's
    engine, which then decodes the writer's stream."""
    prompt = list(np.random.RandomState(13).randint(1, 128, size=24))
    if writer == "jax":
        got1 = _fill_and_close(_jax_core(models, tmp_path), jax_collect_greedy, prompt)
        reader, collect = _port_core(models, tmp_path), collect_greedy
    else:
        got1 = _fill_and_close(_port_core(models, tmp_path), collect_greedy, prompt)
        reader, collect = _jax_core(models, tmp_path), jax_collect_greedy
    assert reader.persist_store.resident_hashes() != []
    got2, _, req2 = collect(reader, prompt, 6, request_id="warm")
    assert req2.cached_tokens > 0
    assert got2 == got1
    reader.close()


# -------------------------------------------------------- replication (e2e)


def test_cross_replica_restore(models, tmp_path):
    """Replica A prefills and publishes; replica B (its own persist dir, a
    fresh engine) pulls through the coordinator and serves the prefix warm."""
    prompt = list(np.random.RandomState(21).randint(1, 128, size=24))
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    got1 = _fill_and_close(_port_core(models, dir_a), collect_greedy, prompt)
    core_b = _port_core(models, dir_b)
    assert core_b.persist_store.resident_hashes() == []

    async def replicate():
        srv = await CoordinatorServer(port=0).start()
        c = await CoordinatorClient(srv.url).connect()
        try:
            store_a = PersistentKvStore(dir_a, generation=core_b.persist_store.generation)
            try:
                assert await PersistReplicator(c, store_a, namespace="t").publish_once() > 0
            finally:
                store_a.close()
            assert await PersistReplicator(c, core_b.persist_store, namespace="t").pull_once() > 0
        finally:
            await c.close()
            await srv.stop()

    run(replicate())
    assert core_b.persist_store.resident_hashes() != []
    got2, _, req2 = collect_greedy(core_b, prompt, 6, request_id="replB")
    assert req2.cached_tokens > 0
    assert got2 == got1
    core_b.close()


def test_replicator_start_stop(tmp_path):
    async def go():
        srv = await CoordinatorServer(port=0).start()
        c = await CoordinatorClient(srv.url).connect()
        store = PersistentKvStore(tmp_path, generation="g")
        store.spill([1, 2], _blocks(2))
        rep = PersistReplicator(c, store, namespace="n", interval_s=60.0)
        try:
            rep.start_soon()
            for _ in range(100):
                if rep.published_files:
                    break
                await asyncio.sleep(0.02)
            assert rep.published_files == 1
        finally:
            await rep.stop()
            store.close()
            await c.close()
            await srv.stop()

    run(go())


def test_prewarm_actuator_scale_up_only():
    def plan(tick, prefill, decode, reason=""):
        return types.SimpleNamespace(tick=tick, prefill_replicas=prefill,
                                     decode_replicas=decode, reason=reason)

    async def go():
        srv = await CoordinatorServer(port=0).start()
        c = await CoordinatorClient(srv.url).connect()
        try:
            act = PrewarmActuator(c, namespace="ns")
            key = prewarm_key("ns")
            await act.apply(plan(1, 1, 1))
            assert await c.kv_get(key) is None  # baseline, not a scale-up
            await act.apply(plan(2, 2, 1, reason="queue"))
            hint = await c.kv_get(key)
            assert hint["tick"] == 2 and hint["epoch"] == 1 and hint["reason"] == "queue"
            await act.apply(plan(3, 1, 1))
            assert (await c.kv_get(key))["epoch"] == 1  # scale-down: no-op
        finally:
            await c.close()
            await srv.stop()

    run(go())


# ------------------------------------------------------- the event wire ----


def test_events_wire_tier_roundtrip():
    ev = KvStoredEvent(block_hashes=[1, 2], parent_hash=None, tier="persist")
    wire = event_to_wire(7, 3, ev)
    assert wire["tier"] == "persist"
    _, _, back = event_from_wire(wire)
    assert back.tier == "persist" and back.block_hashes == [1, 2]
    # the device tier stays off the wire (old consumers never see the key)
    assert "tier" not in event_to_wire(8, 3, KvStoredEvent(block_hashes=[9]))
    _, _, dev = event_from_wire(event_to_wire(8, 3, KvRemovedEvent([9])))
    assert dev.tier == "device"
    # the JAX package reads it the same way
    _, _, jback = jax_events.event_from_wire(wire)
    assert jback.tier == "persist" and jback.block_hashes == [1, 2]
