"""The port's host-RAM KV offload tier, against the JAX package's.

Mirrors ``tests/test_host_offload.py``: the pool's bookkeeping (round trip,
LRU, a shape change refused, hit/miss counters, reserve/abort, an
oversized batch, duplicates) on numpy inputs as there, and then the
port's pool and the JAX pool driven through one sequence of operations
side by side.  The engine tests run the port's ``EngineCore`` on the JAX
package's random init of ``ModelConfig.tiny()`` (``params_from_jax``,
f32, on the CPU) with a tiny device pool and a host pool: a prompt
served, churned out of the device cache, and served again must come back
from the host (``cached_tokens`` > 0), with the restored blocks equal to
the blocks before eviction, and every greedy stream equal to the JAX
``EngineCore``'s under the same tiers, with the f32 and the int8 cache.
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu import cli as jax_cli
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.llm.kv.host_pool import HostKvPool as JaxHostKvPool
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu_torch import cli
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm.kv.host_pool import HostKvPool
from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache
from tests.conftest import make_tiny_hf_checkpoint

TIERS = dict(max_batch_size=2, max_model_len=64, block_size=8, num_blocks=8,
             num_host_blocks=32)


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


def collect_greedy(core, prompt, n, request_id="r1"):
    """The port engine's greedy stream, stepped on this thread."""
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


def _blocks(n, shape=(2, 4), seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + shape).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------- pool unit ----


def test_pool_store_match_gather_roundtrip():
    pool = HostKvPool(8)
    data = _blocks(3)
    assert pool.store([11, 22, 33], data) == 3
    assert pool.match_prefix([11, 22, 33, 44]) == [11, 22, 33]
    assert pool.match_prefix([22, 33]) == [22, 33]  # chained hashes → any subchain
    np.testing.assert_array_equal(_np(pool.gather([22, 33])), data[1:])
    # re-store of resident hashes copies nothing new
    assert pool.store([11, 22], _blocks(2, seed=9)) == 0
    np.testing.assert_array_equal(_np(pool.gather([11])), data[:1])


def test_pool_lru_eviction():
    pool = HostKvPool(4)
    pool.store([1, 2, 3, 4], _blocks(4))
    pool.gather([1])  # touch 1 → 2 becomes oldest
    pool.store([5], _blocks(1, seed=1))
    assert 2 not in pool
    assert all(h in pool for h in (1, 3, 4, 5))
    assert pool.evicted_blocks == 1


def test_pool_rejects_shape_change():
    pool = HostKvPool(4)
    pool.store([1], _blocks(1))
    with pytest.raises(ValueError):
        pool.store([2], _blocks(1, shape=(3, 3)))
    with pytest.raises(ValueError):
        pool.store([2], (_blocks(1), _blocks(1)))  # another structure
    # the rejected stores must not poison the pool
    assert pool.match_prefix([1]) == [1]
    assert pool.store([3], _blocks(1, seed=2)) == 1
    assert pool.resident == 2


def test_pool_hit_miss_counters():
    pool = HostKvPool(8)
    pool.store([1, 2], _blocks(2))
    assert pool.match_prefix([1, 2, 3]) == [1, 2]  # 2 hits, 1 miss
    pool.match_prefix([9])                         # 1 miss
    s = pool.stats()
    assert s["host_blocks_hits"] == 2
    assert s["host_blocks_misses"] == 2


def test_pool_reserve_abort_leaks_nothing():
    """A failed write between reserve and publish must return every row:
    free list restored, nothing resident, full capacity still usable."""
    pool = HostKvPool(2)
    hids, rows = pool.reserve([1, 2], _blocks(2))
    assert len(hids) == 2 and len(pool._free) == 0
    pool.abort(hids)
    assert len(pool._free) == 2
    assert pool.resident == 0
    assert pool.match_prefix([1, 2]) == []  # aborted rows never match
    assert pool.store([3, 4], _blocks(2)) == 2
    assert pool.match_prefix([3, 4]) == [3, 4]


def test_pool_overflow_batch_keeps_prefix_and_pool_sane():
    """One store batch larger than the whole pool keeps the EARLIEST
    blocks and leaves the pool fully functional."""
    pool = HostKvPool(4)
    hashes = list(range(100, 106))
    assert pool.store(hashes, _blocks(6)) == 4
    assert pool.match_prefix(hashes) == hashes[:4]
    assert pool.dropped_blocks == 2
    assert pool.stats()["host_blocks_dropped"] == 2
    assert pool.store([200], _blocks(1)) == 1
    assert pool.gather([200]) is not None


def test_pool_duplicate_hashes_one_row():
    pool = HostKvPool(8)
    assert pool.store([5, 5, 5], _blocks(3)) == 1
    assert pool.resident == 1


def test_pool_abort_returns_capacity():
    pool = HostKvPool(2)
    hids, rows = pool.reserve([1, 2], _blocks(2))
    assert len(hids) == 2
    pool.abort(hids)
    assert pool.store([3, 4], _blocks(2)) == 2  # capacity intact


def test_pool_keeps_the_int8_cache_structure():
    """An int8 cache's (data, scale) batch comes back as a QuantKvCache,
    whether gathered into new tensors or into given ones."""
    gen = torch.Generator().manual_seed(0)
    data = torch.randint(-127, 128, (3, 2, 2, 8, 4), generator=gen, dtype=torch.int8)
    scale = torch.rand((3, 2, 2, 8, 128), generator=gen)
    pool = HostKvPool(4)
    assert pool.store([1, 2, 3], QuantKvCache(data, scale)) == 3
    got = pool.gather([3, 1])
    assert isinstance(got, QuantKvCache)
    assert torch.equal(got.data, data[[2, 0]]) and torch.equal(got.scale, scale[[2, 0]])
    out = [torch.empty((2,) + shape, dtype=dt) for shape, dt in pool.part_specs()]
    into = pool.gather([2, 3], out=out)
    assert into.data is out[0] and torch.equal(out[1], scale[1:])
    assert pool.stats()["host_blocks_restored"] == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_agrees_with_the_jax_pool(seed):
    """One random sequence of stores, touches, matches and gathers on both
    pools: the same results, contents and stats after every operation."""
    rng = np.random.default_rng(seed)
    port, ref = HostKvPool(6), JaxHostKvPool(6)
    for step in range(40):
        op = rng.integers(0, 4)
        hashes = [int(h) for h in rng.integers(0, 12, size=rng.integers(1, 5))]
        if op == 0:
            data = _blocks(len(hashes), shape=(2, 3), seed=step)
            assert port.store(hashes, data) == ref.store(hashes, data)
        elif op == 1:
            port.touch(hashes)
            ref.touch(hashes)
        elif op == 2:
            assert port.match_prefix(hashes) == ref.match_prefix(hashes)
        else:
            resident = [h for h in hashes if h in ref]
            assert [h for h in hashes if h in port] == resident
            if resident:
                np.testing.assert_array_equal(_np(port.gather(resident)), ref.gather(resident))
        assert port.stats() == ref.stats()


# --------------------------------------------------------- engine offload ----


def _churn(collect, core, rng, vocab, n=4):
    for i in range(n):
        collect(core, list(rng.randint(1, vocab, size=24)), 2, request_id=f"churn{i}")


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_evicted_prefix_restored_from_host(models, cache_dtype):
    """The money path: fill the tiny device pool, churn the prompt out to
    the host, serve it again — restored from the host bit for bit, and
    every stream the JAX engine's under the same tiers."""
    jmodel, jparams, model = models
    vocab = model.config.vocab_size
    prompt = list(np.random.RandomState(7).randint(1, vocab, size=24))  # 3 full blocks

    core = EngineCore(model, EngineConfig(**TIERS, cache_dtype=cache_dtype), device="cpu")
    got1, _, req1 = collect_greedy(core, prompt, 6, request_id="a")
    before = core.gather_blocks_np(req1.block_ids[:2])  # the prompt's first two blocks
    rng = np.random.RandomState(8)
    _churn(collect_greedy, core, rng, vocab)
    core.flush_host_offload()  # stores land on the kv-offload thread
    assert core.host_pool.stored_blocks > 0, "eviction should have offloaded"
    assert core.prefix_hit_tokens(req1.seq.sequence_hashes(), len(prompt)) == 0

    got2, _, req2 = collect_greedy(core, prompt, 6, request_id="b")
    assert req2.cached_tokens >= 16, "host restore should shorten prefill"
    assert core.host_pool.restored_blocks >= 2
    after = core.gather_blocks_np(req2.block_ids[:2])
    for a, b in zip(before if cache_dtype else (before,), after if cache_dtype else (after,)):
        assert torch.equal(a, b)
    stats = core.metrics()
    assert stats["host_blocks_restored"] >= req2.cached_tokens // 8
    core.close()

    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**TIERS, cache_dtype=cache_dtype))
    ref1, _, _ = jax_collect_greedy(jcore, prompt, 6, request_id="a")
    _churn(jax_collect_greedy, jcore, np.random.RandomState(8), vocab)
    jcore.flush_host_offload()
    ref2, _, jreq2 = jax_collect_greedy(jcore, prompt, 6, request_id="b")
    jcore.close()
    assert (got1, got2) == (ref1, ref2)
    assert got2 == got1
    assert req2.cached_tokens == jreq2.cached_tokens
    assert set(stats) <= set(jcore.metrics())


def test_offload_disabled_by_default(models):
    _, _, model = models
    cfg = EngineConfig(max_batch_size=2, max_model_len=64, block_size=8, num_blocks=8)
    core = EngineCore(model, cfg, device="cpu")
    assert core.host_pool is None and core.block_manager.offload_sink is None
    prompt = list(np.random.RandomState(3).randint(1, 128, size=16))
    collect_greedy(core, prompt, 4)
    assert "host_blocks_resident" not in core.metrics()


def test_host_tier_needs_prefix_reuse(models, caplog):
    _, _, model = models
    core = EngineCore(model, EngineConfig(**TIERS, enable_prefix_reuse=False), device="cpu")
    assert core.host_pool is None and core._offload_thread is None
    assert "num_host_blocks=32 ignored" in caplog.text


def test_offload_block_budget_falls_back_to_sync(models):
    """With the async-offload budget forced to one block, eviction bursts
    exceed it at once and stores take the synchronous path — nothing is
    lost and restores still work (the budget bounds pinned device memory,
    never correctness)."""
    _, _, model = models
    rng = np.random.RandomState(11)
    prompt = list(rng.randint(1, 128, size=24))
    core = EngineCore(model, EngineConfig(**TIERS, offload_inflight_blocks=1), device="cpu")
    got1, _, _ = collect_greedy(core, prompt, 6, request_id="a")
    _churn(collect_greedy, core, rng, 128)
    core.flush_host_offload()
    assert core.host_pool.stored_blocks > 0
    assert core._offload_inflight_blocks == 0  # budget fully retired
    got2, _, req2 = collect_greedy(core, prompt, 6, request_id="b")
    assert req2.cached_tokens > 0 and got2 == got1
    core.close()


def test_engine_close_stops_offload_thread(models):
    _, _, model = models
    core = EngineCore(model, EngineConfig(**TIERS), device="cpu")
    t = core._offload_thread
    assert t.is_alive()
    core.close()
    assert not t.is_alive()
    core.close()  # idempotent
    # post-close evictions store inline, nothing hangs
    rng = np.random.RandomState(3)
    _churn(collect_greedy, core, rng, 128)
    core.flush_host_offload()
    assert core.host_pool.stored_blocks > 0


def test_queued_batch_holds_its_snapshot_until_stored(models):
    """A queued offload batch keeps its on-device snapshot referenced until
    the kv-offload thread has copied and stored it — on the card the
    snapshot's memory must not return to the allocator while the copy may
    still read it — and lets it go afterwards."""
    _, _, model = models
    core = EngineCore(model, EngineConfig(**TIERS), device="cpu")
    _, _, req = collect_greedy(core, list(range(1, 25)), 2, request_id="a")
    snaps = []
    real = core._snapshot

    def recording(block_ids):
        out = real(block_ids)
        snaps.append(weakref.ref(out))
        return out

    core._snapshot = recording
    try:
        hashes = req.seq.sequence_hashes()
        pending = [(core.block_manager.lookup(h), h) for h in hashes
                   if core.block_manager.lookup(h) is not None]
        hashes = [h for _, h in pending]
        with core._stage_lock:  # the store stalls at its copy
            core._pending_offload.extend(pending)
            core._drain_offload()
            gc.collect()
            assert len(snaps) == 1 and snaps[0]() is not None
            assert core._offload_inflight_blocks == len(pending)
            assert not any(h in core.host_pool for h in hashes)
        core._offload_q.join()
        gc.collect()
        assert snaps[0]() is None
        assert core._offload_inflight_blocks == 0
        assert all(h in core.host_pool for h in hashes)
    finally:
        del core._snapshot
        core.close()


# ----------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli") / "hf"
    make_tiny_hf_checkpoint(d)
    return d


def test_cli_takes_the_tier_flags(hf_dir, tmp_path):
    """``run`` takes the JAX CLI's four tier flags, with its defaults, and
    wires them into the engine."""
    names = ("num_host_blocks", "kv_persist_dir", "kv_persist_max_bytes", "kv_persist_ttl")
    ours = cli.parse_args(["run", "in=http", "out=echo"])
    ref = jax_cli._parser().parse_args(["run", "in=http", "out=echo"])
    assert [getattr(ours, n) for n in names] == [getattr(ref, n) for n in names]
    engine, _ = cli.build_local_engine(cli.parse_args([
        "run", "in=http", "out=gpu", "--device", "cpu", "--model-path", str(hf_dir),
        "--max-model-len", "64", "--num-blocks", "16", "--num-host-blocks", "24",
        "--kv-persist-dir", str(tmp_path / "kv"), "--kv-persist-max-bytes", "1000000",
        "--kv-persist-ttl", "60"]))
    try:
        c = engine.core.config
        assert (c.num_host_blocks, c.kv_persist_dir, c.kv_persist_max_bytes,
                c.kv_persist_ttl_s) == (24, str(tmp_path / "kv"), 1000000, 60.0)
        assert engine.core.host_pool.num_blocks == 24
        assert engine.core.persist_store.max_bytes == 1000000
    finally:
        engine.shutdown()
    assert engine.core._offload_thread is None  # shutdown closed the core
