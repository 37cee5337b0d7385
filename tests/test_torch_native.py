"""The port's host helpers (C++ built by g++ inside the port), against the
JAX package's.

* The counterparts of ``tests/test_native.py``: the prefix index, the block
  gather/scatter (round trip, the threaded path, last-write-wins, bounds),
  the event queue (overflow, an oversized event) and the default indexer.
* One seeded stream of stores, removes and worker deaths through the port's
  native index, the JAX package's native index and both packages' Python
  ``KvIndexer``: the same scores.
* The block copies on torch CPU tensors of float32, bfloat16, float16 and
  an int8 cache's data and scale parts, across the threaded threshold, into
  a given ``out``, and on pools that are not contiguous.
* The port publisher draining a native queue sends the JAX publisher's wire
  events; the port's ``HostKvPool`` moves its rows by the native copies and
  holds what the JAX pool holds.
* The library: built under a hash of its sources inside the port, and a
  failed build raises.
"""

import asyncio
import json
import random

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu import native as jax_native
from dynamo_tpu.llm.kv.events import KvRemovedEvent as JaxKvRemovedEvent
from dynamo_tpu.llm.kv.events import KvStoredEvent as JaxKvStoredEvent
from dynamo_tpu.llm.kv.host_pool import HostKvPool as JaxHostKvPool
from dynamo_tpu.llm.kv_router.indexer import KvIndexer as JaxKvIndexer
from dynamo_tpu.llm.kv_router.publisher import KvEventPublisher as JaxKvEventPublisher
from dynamo_tpu_torch import native
from dynamo_tpu_torch.llm.kv.events import KvRemovedEvent, KvStoredEvent
from dynamo_tpu_torch.llm.kv.host_pool import HostKvPool
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache


# ------------------------------------------------ tests/test_native.py's cases


def test_native_index_basic():
    ix = native.NativeKvIndex()
    ix.store(1, [10, 20, 30])
    ix.store(2, [10, 20])
    assert ix.find_matches([10, 20, 30, 40]) == {1: 3, 2: 2}
    assert ix.num_blocks == 3 and ix.num_workers == 2 and ix.worker_blocks(1) == 3
    ix.remove(1, [30])
    assert ix.find_matches([10, 20, 30]) == {1: 2, 2: 2}
    ix.remove_worker(2)
    assert ix.find_matches([10, 20]) == {1: 2} and ix.worker_blocks(2) == 0
    ix.clear()
    assert ix.num_blocks == 0


def test_native_index_matches_python_on_random_stream():
    """The same random event stream through both of the port's indexes."""
    rng = random.Random(7)
    py = KvIndexer(use_native=False)
    nat = KvIndexer(use_native=True)
    assert nat.is_native and not py.is_native

    hashes = [rng.getrandbits(64) for _ in range(200)]
    workers = [1, 2, 3, 7]
    for step in range(500):
        w = rng.choice(workers)
        if rng.random() < 0.6:
            start = rng.randrange(0, len(hashes) - 8)
            ev = KvStoredEvent(block_hashes=hashes[start:start + rng.randrange(1, 8)])
        else:
            ev = KvRemovedEvent(block_hashes=rng.sample(hashes, rng.randrange(1, 6)))
        py.apply_event(w, ev, event_id=step)
        nat.apply_event(w, ev, event_id=step)
        if step % 100 == 99:
            dead = rng.choice(workers)
            py.remove_worker(dead)
            nat.remove_worker(dead)

    assert py.num_blocks == nat.num_blocks and py.workers() == nat.workers()
    assert all(py.worker_blocks(w) == nat.worker_blocks(w) for w in workers)
    for _ in range(50):
        start = rng.randrange(0, len(hashes) - 16)
        query = hashes[start:start + 16]
        assert py.find_matches(query).scores == nat.find_matches(query).scores


def test_blocks_gather_scatter_roundtrip():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((64, 2, 4, 16, 8)).astype(np.float32)
    ids = [5, 0, 63, 17, 17, 2]
    got = native.blocks_gather(pool, ids)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, pool[ids])

    dst = np.zeros_like(pool)
    native.blocks_scatter(dst, ids, got)
    np.testing.assert_array_equal(dst[ids], pool[ids])
    untouched = sorted(set(range(64)) - set(ids))
    assert not dst[untouched].any()


def test_blocks_gather_large_parallel():
    # cross the 4 MiB parallel threshold to take the threaded path
    pool = np.arange(512 * 8192, dtype=np.float32).reshape(512, 8192)
    ids = np.random.default_rng(1).permutation(512)[:300]
    got = native.blocks_gather(pool, ids, threads=4)
    np.testing.assert_array_equal(got, pool[ids])


def test_event_queue_roundtrip_and_overflow():
    q = native.NativeEventQueue(capacity=3)
    assert q.publish(native.EVENT_STORED, 0, [1, 2, 3])
    assert q.publish(native.EVENT_REMOVED, 0, [2])
    assert q.publish(native.EVENT_STORED, 99, [7])
    assert not q.publish(native.EVENT_STORED, 0, [8])  # full -> dropped
    assert q.dropped == 1

    assert q.drain() == [
        (native.EVENT_STORED, 0, [1, 2, 3]),
        (native.EVENT_REMOVED, 0, [2]),
        (native.EVENT_STORED, 99, [7]),
    ]
    assert q.drain() == []
    assert q.publish(native.EVENT_STORED, 0, [9])  # drained -> room again


def test_event_queue_oversized_event_dropped_not_wedged():
    q = native.NativeEventQueue(capacity=8)
    q.publish(native.EVENT_STORED, 0, list(range(10)))  # > hashes_cap below
    q.publish(native.EVENT_STORED, 0, [1])
    assert q.drain(max_events=8, hashes_cap=4) == [(native.EVENT_STORED, 0, [1])]
    assert q.dropped == 1


def test_blocks_scatter_duplicate_ids_last_write_wins():
    pool = np.zeros((4, 8), dtype=np.float32)
    src = np.stack([np.full(8, 1.0), np.full(8, 2.0), np.full(8, 3.0)]).astype(np.float32)
    native.blocks_scatter(pool, [2, 1, 2], src)
    assert pool[2][0] == 3.0  # the last occurrence wins, as numpy's does
    assert pool[1][0] == 2.0


def test_blocks_native_bounds_checked():
    pool = np.zeros((4, 8), dtype=np.float32)
    with pytest.raises(IndexError):
        native.blocks_gather(pool, [0, 4])
    with pytest.raises(IndexError):
        native.blocks_scatter(pool, [-1], np.zeros((1, 8), dtype=np.float32))
    with pytest.raises(ValueError):
        native.blocks_scatter(pool, [0, 1], np.zeros((1, 8), dtype=np.float32))


def test_kv_indexer_auto_uses_native():
    ix = KvIndexer()
    assert ix.is_native
    ix.apply_event(4, KvStoredEvent(block_hashes=[11, 22]), event_id=0)
    ix.apply_event(4, KvStoredEvent(block_hashes=[5], tier="persist"), event_id=1)
    assert ix.find_matches([11, 22, 33]).scores == {4: 2}
    assert ix.workers() == [4] and ix.resident_keys == 3
    ix.apply_event(5, KvRemovedEvent(block_hashes=[11]), event_id=0)
    assert ix.workers() == [4]  # workers() tracks Stored events only
    assert ix._last_event_id == {4: 1, 5: 0}
    ix.remove_worker(4)
    assert ix.workers() == [] and ix.num_blocks == 0 and ix.resident_keys == 0
    assert ix._last_event_id == {5: 0}


# ------------------------------------------- one stream, four indexes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_four_indexes_score_alike(seed):
    """The port's native index, the JAX package's native index and both
    packages' Python indexes, fed one seeded stream of device-tier stores
    and removes, persist-tier stores and worker deaths: equal scores,
    persist scores, block counts and worker lists throughout."""
    rng = np.random.default_rng(seed)
    indexes = [(KvIndexer(use_native=True), KvStoredEvent, KvRemovedEvent),
               (KvIndexer(use_native=False), KvStoredEvent, KvRemovedEvent),
               (JaxKvIndexer(use_native=True), JaxKvStoredEvent, JaxKvRemovedEvent),
               (JaxKvIndexer(use_native=False), JaxKvStoredEvent, JaxKvRemovedEvent)]
    assert [ix.is_native for ix, _, _ in indexes] == [True, False, True, False]
    # chains of hashes, as a worker's prefixes are: a store is a chain's head
    chains = [[int(h) for h in rng.integers(1, 2**63, 24, dtype=np.int64)] for _ in range(6)]
    workers = [1, 2, 3, 9]
    scored = persisted = 0
    for step in range(400):
        w = int(rng.choice(workers))
        chain = chains[rng.integers(len(chains))]
        r = rng.random()
        if r < 0.55:
            kind, hashes, tier = "stored", chain[:rng.integers(1, 25)], "device"
        elif r < 0.65:
            kind, hashes, tier = "stored", chain[:rng.integers(1, 25)], "persist"
        elif r < 0.97:
            kind, hashes, tier = "removed", chain[rng.integers(0, 24):][:3], "device"
        else:
            kind, hashes, tier = "dead", [], "device"
        for ix, stored, removed in indexes:
            if kind == "dead":
                ix.remove_worker(w)
            elif kind == "stored":
                ix.apply_event(w, stored(block_hashes=hashes, tier=tier), event_id=step)
            else:
                ix.apply_event(w, removed(block_hashes=hashes, tier=tier), event_id=step)
        if step % 20 == 19:
            query = chains[rng.integers(len(chains))][:rng.integers(1, 25)]
            got = [ix.find_matches(query) for ix, _, _ in indexes]
            assert all((m.scores, m.persist_scores) == (got[0].scores, got[0].persist_scores)
                       for m in got), (step, [(m.scores, m.persist_scores) for m in got])
            assert len({ix.num_blocks for ix, _, _ in indexes}) == 1
            assert len({tuple(ix.workers()) for ix, _, _ in indexes}) == 1
            scored += bool(got[0].scores)
            persisted += bool(got[0].persist_scores)
    assert scored >= 5 and persisted >= 1, (scored, persisted)


# ------------------------------------------------ block copies on tensors


def _tensor(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, dtype=dtype)
    return torch.randn(shape, generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8])
@pytest.mark.parametrize("rows", [(64, (2, 2, 8, 16)), (96, (2, 2, 16, 1024))])
def test_block_copies_on_tensors(dtype, rows):
    """Gather and scatter over torch CPU tensors equal index_select and
    index_copy_ bit for bit, below and past the 4 MiB threaded threshold
    (the second geometry moves more than 4 MiB in every dtype), into a new
    tensor and into a given ``out``, counted once each as native copies."""
    n, shape = rows
    pool = _tensor((n,) + shape, dtype, 0)
    ids = torch.randperm(n, generator=torch.Generator().manual_seed(1))[:n // 2 + 5]
    before = dict(native.calls)
    got = native.blocks_gather(pool, ids)
    assert got.dtype == dtype and torch.equal(got, pool.index_select(0, ids))
    out = torch.empty_like(got)
    assert native.blocks_gather(pool, ids.tolist(), threads=3, out=out) is out
    assert torch.equal(out, got)
    dst = torch.zeros_like(pool)
    native.blocks_scatter(dst, ids, got)
    assert torch.equal(dst, torch.zeros_like(pool).index_copy_(0, ids, got))
    assert native.calls == {"gather": before["gather"] + 2, "scatter": before["scatter"] + 1}


def test_block_copies_of_an_int8_cache():
    """Both parts of an int8 cache's blocks (int8 data, f32 scales) round
    trip through the copies with their bits."""
    data = _tensor((40, 2, 2, 16, 256), torch.int8, 2)
    scale = torch.rand((40, 2, 2, 8, 128), generator=torch.Generator().manual_seed(3))
    ids = [39, 0, 7, 7, 12]
    for part in (data, scale):
        got = native.blocks_gather(part, ids)
        assert torch.equal(got, part[ids])
        back = torch.zeros_like(part)
        native.blocks_scatter(back, ids, got)
        assert torch.equal(back[ids], part[ids])


def test_block_copies_checks_on_tensors():
    """Bounds (no negative wrap), shapes and devices are checked; duplicate
    scatter ids are last-write-wins; a pool that is not contiguous takes the
    indexing path (no native copy counted) with the same result."""
    pool = _tensor((8, 4, 16), torch.bfloat16, 4)
    with pytest.raises(IndexError):
        native.blocks_gather(pool, [0, 8])
    with pytest.raises(IndexError):
        native.blocks_gather(pool, torch.tensor([-1]))
    with pytest.raises(IndexError):
        native.blocks_scatter(pool, [8], pool[:1])
    with pytest.raises(ValueError, match="shape mismatch"):
        native.blocks_scatter(pool, [0, 1], pool[:1])
    with pytest.raises(ValueError, match="gather out"):
        native.blocks_gather(pool, [0, 1], out=torch.empty((2, 4, 16)))
    with pytest.raises(ValueError, match="host to host"):
        native.blocks_gather(torch.empty((2, 4), device="meta"), [0])
    dst = torch.zeros_like(pool)
    rows = torch.stack([torch.full((4, 16), v) for v in (1.0, 2.0, 3.0)]).to(torch.bfloat16)
    native.blocks_scatter(dst, [5, 2, 5], rows)
    assert dst[5].eq(3).all() and dst[2].eq(2).all() and not dst[[0, 1, 3, 4, 6, 7]].any()

    strided = _tensor((8, 16, 4), torch.bfloat16, 5).transpose(1, 2)
    before = dict(native.calls)
    assert torch.equal(native.blocks_gather(strided, [3, 1]), strided[[3, 1]])
    target = torch.zeros((8, 16, 4), dtype=torch.bfloat16).transpose(1, 2)
    native.blocks_scatter(target, [6, 0, 6], strided[[1, 2, 3]])
    assert torch.equal(target[6], strided[3]) and torch.equal(target[0], strided[2])
    assert native.calls == before


# ----------------------------------------------------------- publisher


class _Capture:
    """A coordinator that records what is published."""

    def __init__(self):
        self.sent = []

    async def publish(self, subject, payload):
        self.sent.append((subject, json.loads(payload) if isinstance(payload, bytes)
                          else payload))


def _feed(q, mod, rng):
    for _ in range(12):
        kind = mod.EVENT_STORED if rng.random() < 0.6 else mod.EVENT_REMOVED
        parent = int(rng.integers(0, 2**63)) if rng.random() < 0.5 else 0
        assert q.publish(kind, parent, [int(h) for h in rng.integers(1, 2**63, 3)])


@pytest.mark.parametrize("seed", [0, 1])
def test_publisher_drains_a_native_queue_as_jax_does(seed):
    """The same queue contents, and the same sink events between flushes:
    the port publisher sends the JAX publisher's subjects, wire payloads and
    event ids (a root parent of 0 goes out as no parent)."""
    async def go(pub_cls, mod, stored):
        rng = np.random.default_rng(seed)
        coord, q = _Capture(), mod.NativeEventQueue(capacity=64)
        pub = pub_cls(coord, worker_id=5, namespace="ns", native_queue=q)
        _feed(q, mod, rng)
        pub.sink(stored(block_hashes=[1, 2], parent_hash=None))
        first = await pub.flush()
        _feed(q, mod, rng)
        second = await pub.flush()
        return first, second, coord.sent

    port = asyncio.run(go(KvEventPublisher, native, KvStoredEvent))
    ref = asyncio.run(go(JaxKvEventPublisher, jax_native, JaxKvStoredEvent))
    assert port == ref and port[:2] == (13, 12)
    sent = port[2]
    assert [w["event_id"] for _, w in sent] == list(range(25))
    assert {s for s, _ in sent} == {"ns.kv_events.5"}
    stored = [w for _, w in sent if "parent_hash" in w]
    assert stored and all(w["parent_hash"] is None or w["parent_hash"] > 0 for w in stored)
    assert any(w["parent_hash"] is None for w in stored[1:])  # a root from the queue


# ----------------------------------------------------------- host pool


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_host_pool_moves_rows_natively_like_the_jax_pool(kind):
    """One sequence of stores (with evictions and already-resident hashes)
    and gathers on the port pool and the JAX pool, on the same blocks: the
    same bits, and every port store and CPU gather a native copy."""
    rng = np.random.default_rng(0)
    port, ref = HostKvPool(10), JaxHostKvPool(10)

    def blocks(n, step):
        if kind == "int8":
            data = rng.integers(-127, 128, (n, 2, 2, 4, 32), dtype=np.int8)
            scale = rng.random((n, 2, 2, 8, 8), dtype=np.float32)
            return (QuantKvCache(torch.from_numpy(data), torch.from_numpy(scale)),
                    (data, scale))
        x = rng.standard_normal((n, 2, 2, 4, 32)).astype(np.float32)
        if kind == "bfloat16":
            t = torch.from_numpy(x).to(torch.bfloat16)
            return t, t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return torch.from_numpy(x), x

    def bits(parts):
        return [p.view(torch.int16).numpy() if p.dtype == torch.bfloat16
                else (p.view(np.int16) if p.dtype == ml_dtypes.bfloat16 else np.asarray(p))
                for p in parts]

    def parts(b):
        return list(b) if isinstance(b, tuple) else [b]

    for step in range(12):
        hashes = [int(h) for h in rng.choice(30, size=int(rng.integers(1, 6)), replace=False)]
        tb, nb = blocks(len(hashes), step)
        before = native.calls["scatter"]
        n = port.store(hashes, tb)
        assert n == ref.store(hashes, nb)
        assert native.calls["scatter"] - before == (len(parts(tb)) if n else 0)
        resident = [h for h in range(30) if h in ref]
        assert [h for h in range(30) if h in port] == resident
        before = native.calls["gather"]
        got = port.gather(resident)
        assert native.calls["gather"] - before == len(parts(got))
        for a, b in zip(bits(parts(got)), bits(parts(ref.gather(resident)))):
            np.testing.assert_array_equal(a, b)
        out = [torch.empty((len(resident),) + s, dtype=d) for s, d in port.part_specs()]
        for a, b in zip(bits(parts(port.gather(resident, out=out))),
                        bits(parts(ref.gather(resident)))):
            np.testing.assert_array_equal(a, b)
    assert port.stats() == ref.stats()


# ------------------------------------------------------------ the library


def test_library_built_inside_the_port_under_a_source_hash(tmp_path, monkeypatch):
    """The library lands in the port's ``_build`` under a hash of its
    sources and flags; an edited source keys a new library; a source g++
    refuses makes the build raise with the compiler's log."""
    lib = native.build_library()
    pkg = native.SRC.parents[1]
    assert native.SRC == pkg / "csrc" / "host" and lib.parent == pkg / "_build"
    assert lib.name == f"libdynamo_host-{native._source_key()}.so" and lib.exists()
    assert {p.name for p in native._sources()} == {
        "kv_index.cpp", "block_copy.cpp", "event_queue.cpp", "dynamo_native.h"}
    for p in native._sources():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(native, "SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    assert native._source_key() == lib.name[len("libdynamo_host-"):-len(".so")]
    (tmp_path / "block_copy.cpp").write_text("this is not C++\n")
    assert native._source_key() not in lib.name
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*block_copy.cpp"):
        native.build_library()
    assert not list((tmp_path / "_build").glob("*.so"))
