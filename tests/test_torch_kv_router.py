"""The port's KV-aware router, against the JAX package's.

Mirrors ``tests/test_kv_router.py`` (indexer matching and teardown, the
scheduler's cost model, the router end to end with failover, the recorder
round trip) and the persist-tier cases of ``tests/test_kv_persist.py``
(indexer scoring, the scheduler's persist fold).  Across the packages: the
block and sequence hashes, the event wire both ways, recordings replayed
by the other package, and the event and metrics planes — a port
publisher feeding a JAX router over the JAX coordinator and a JAX
publisher feeding a port router over the port's — with the same routing
decisions.  Last, the worker wiring on two port engines: the router sends
a prefix's later requests to the engine that holds it, and after a flush
the index holds each engine's registered blocks.
"""

import asyncio
import random

import numpy as np
import pytest
import torch

from dynamo_tpu import tokens as jax_tokens
from dynamo_tpu.llm.kv import events as jax_events
from dynamo_tpu.llm.kv_router import KvRouter as JaxKvRouter
from dynamo_tpu.llm.kv_router.metrics_aggregator import KvRouterSubscriber as JaxKvRouterSubscriber
from dynamo_tpu.llm.kv_router.publisher import KvEventPublisher as JaxKvEventPublisher
from dynamo_tpu.llm.kv_router.publisher import KvMetricsPublisher as JaxKvMetricsPublisher
from dynamo_tpu.llm.kv_router.recorder import KvRecorder as JaxKvRecorder
from dynamo_tpu.llm.kv_router.recorder import replay_into as jax_replay_into
from dynamo_tpu.llm.kv_router.scheduler import DefaultWorkerSelector as JaxSelector
from dynamo_tpu.runtime.transports.coordinator import CoordinatorClient as JaxCoordinatorClient
from dynamo_tpu.runtime.transports.coordinator import CoordinatorServer as JaxCoordinatorServer
from dynamo_tpu_torch import tokens
from dynamo_tpu_torch.cli import attach_worker_publishers
from dynamo_tpu_torch.llm.kv import events as port_events
from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
from dynamo_tpu_torch.llm.kv.events import (KvRemovedEvent, KvStoredEvent, event_from_wire,
                                            event_to_wire)
from dynamo_tpu_torch.llm.kv_router import (DefaultWorkerSelector, KvIndexer, KvRouter,
                                            KvScheduler, WorkerMetrics)
from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvRouterSubscriber
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, KvMetricsPublisher
from dynamo_tpu_torch.llm.kv_router.recorder import KvRecorder, replay_into
from dynamo_tpu_torch.llm.kv_router.scheduler import AllWorkersBusy
from dynamo_tpu_torch.llm.protocols import BackendInput, SamplingOptions, StopConditions
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import init_params
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer
from dynamo_tpu_torch.tokens import sequence_hashes

BS = 4


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def store(indexer, worker, toks, upto=None):
    h = sequence_hashes(toks, BS)[:upto]
    for i, bh in enumerate(h):
        indexer.apply_event(
            worker, KvStoredEvent(block_hashes=[bh], parent_hash=h[i - 1] if i else None))
    return h


# --------------------------------------------------------- the reference set


def test_indexer_prefix_matching():
    idx = KvIndexer()
    toks = list(range(16))
    h = store(idx, 1, toks)          # worker 1 has all 4 blocks
    store(idx, 2, toks, upto=2)       # worker 2 has the first 2
    assert idx.find_matches(h).scores == {1: 4, 2: 2}
    # a divergent suffix only matches the shared prefix
    other = sequence_hashes(list(range(8)) + [99, 98, 97, 96, 1, 2, 3, 4], BS)
    assert idx.find_matches(other).scores == {1: 2, 2: 2}
    assert idx.find_matches(sequence_hashes([7] * 16, BS)).scores == {}
    assert idx.worker_blocks(1) == 4 and idx.num_blocks == 4


def test_indexer_removal_and_worker_teardown():
    idx = KvIndexer()
    toks = list(range(16))
    h = store(idx, 1, toks)
    store(idx, 2, toks)
    idx.apply_event(1, KvRemovedEvent(block_hashes=[h[3]]))
    assert idx.find_matches(h).scores == {1: 3, 2: 4}
    idx.remove_worker(2)
    assert idx.find_matches(h).scores == {1: 3}
    assert idx.workers() == [1]


def test_indexer_python_path_only():
    """The default and ``use_native=True`` are the C++ index; the Python
    index is reached only by ``use_native=False``, and only it has the
    single-hash probe."""
    assert KvIndexer().is_native and KvIndexer(use_native=True).is_native
    py = KvIndexer(use_native=False)
    assert not py.is_native
    py.apply_event(1, KvStoredEvent(block_hashes=[11]))
    assert py.holders_of(11) == {1}
    with pytest.raises(RuntimeError, match="native index has no probe path"):
        KvIndexer().holders_of(11)


def test_scheduler_prefers_overlap():
    sched = KvScheduler(DefaultWorkerSelector(random.Random(0)), block_size=BS)
    for w in (1, 2):
        sched.update_worker(WorkerMetrics(w, request_active_slots=0, request_total_slots=8,
                                          kv_active_blocks=0, kv_total_blocks=100))
    assert sched.schedule({2: 4}, request_tokens=16) == 2
    ev = sched.drain_hit_events()
    assert ev[0].worker_id == 2 and ev[0].overlap_blocks == 4


def test_scheduler_load_beats_small_overlap():
    sched = KvScheduler(DefaultWorkerSelector(random.Random(0)), block_size=BS)
    sched.update_worker(WorkerMetrics(1, request_active_slots=8, request_total_slots=8,
                                      kv_active_blocks=95, kv_total_blocks=100))
    sched.update_worker(WorkerMetrics(2, request_active_slots=0, request_total_slots=8,
                                      kv_active_blocks=0, kv_total_blocks=100))
    # overlap 1/4 → 2*0.25=0.5 < 1.95 load penalty → worker 2 wins
    assert sched.schedule({1: 1}, request_tokens=16) == 2


def test_scheduler_no_workers():
    with pytest.raises(AllWorkersBusy):
        KvScheduler(block_size=BS).schedule({}, 16)


def test_router_end_to_end_and_failover():
    router = KvRouter(block_size=BS, selector=DefaultWorkerSelector(random.Random(1)))
    toks = list(range(20))
    router.scheduler.update_worker(WorkerMetrics(1, request_total_slots=8, kv_total_blocks=100))
    router.scheduler.update_worker(WorkerMetrics(2, request_total_slots=8, kv_total_blocks=100))
    store(router.indexer, 1, toks)
    d = router.schedule(toks)
    assert (d.worker_id, d.overlap_blocks, d.overlap_tokens) == (1, 5, 20)
    router.remove_worker(1)  # worker 1 dies → cleared everywhere
    d2 = router.schedule(toks)
    assert d2.worker_id == 2 and d2.overlap_blocks == 0


def test_router_engine_yields_one_decision():
    router = KvRouter(block_size=BS, selector=DefaultWorkerSelector(random.Random(1)))
    router.scheduler.update_worker(WorkerMetrics(3, request_total_slots=8, kv_total_blocks=100))
    store(router.indexer, 3, list(range(8)))

    async def go(payload):
        return [d async for d in router.generate(Context(payload))]

    assert run(go({"token_ids": list(range(8))})) == [
        {"worker_id": 3, "overlap_blocks": 2, "overlap_tokens": 8}]
    router.remove_worker(3)
    assert run(go(list(range(8)))) == [{"worker_id": None}]


def test_recorder_replay_roundtrip(tmp_path):
    path = tmp_path / "events.jsonl"
    toks = list(range(16))
    h = sequence_hashes(toks, BS)
    with KvRecorder(path) as rec:
        for i, bh in enumerate(h):
            rec.record(i, 7, KvStoredEvent(block_hashes=[bh], parent_hash=h[i - 1] if i else None))
        rec.record(len(h), 7, KvRemovedEvent(block_hashes=[h[-1]]))
    idx = KvIndexer()
    assert replay_into(path, idx) == 5
    assert idx.find_matches(h).scores == {7: 3}


def test_indexer_persist_tier_scoring():
    idx = KvIndexer(use_native=False)
    idx.apply_event(1, KvStoredEvent(block_hashes=[10, 20], tier="persist"))
    idx.apply_event(2, KvStoredEvent(block_hashes=[10], tier="device"))
    scores = idx.find_matches([10, 20, 30])
    assert scores.scores == {2: 1}          # device tier: worker 2 only
    assert scores.persist_scores == {1: 2}  # persist tier: worker 1 depth 2
    idx.apply_event(1, KvRemovedEvent(block_hashes=[20], tier="persist"))
    assert idx.find_matches([10, 20]).persist_scores == {1: 1}
    idx.remove_worker(1)
    assert idx.find_matches([10, 20]).persist_scores == {}


def test_scheduler_folds_persist_overlap():
    def sched(weight):
        s = KvScheduler(block_size=8, persist_weight=weight)
        for w in (1, 2):
            s.update_worker(WorkerMetrics(worker_id=w, request_total_slots=8, kv_total_blocks=64))
        return s

    # worker 2's persist prefix beats worker 1's shallower device hit
    assert sched(1.0).schedule({1: 1}, request_tokens=64, persist_overlaps={2: 6}) == 2
    # persist_weight=0 disables the fold → the device hit wins again
    assert sched(0.0).schedule({1: 1}, request_tokens=64, persist_overlaps={2: 6}) == 1
    (best, logit, terms), _ = sched(1.0).score_candidates({1: 1}, 64, persist_overlaps={2: 6})
    assert best == 2 and terms["persist"] == pytest.approx(6 / 8) and logit == sum(terms.values())


# ------------------------------------------------------ across the packages


@pytest.mark.parametrize("block_size,salt,n", [(4, 0, 17), (16, 0, 64), (16, 7, 50), (8, 0, 3)])
def test_hashes_equal_jax(block_size, salt, n):
    toks = np.random.default_rng(n).integers(0, 128256, n).tolist()
    assert tokens.block_hashes(toks, block_size) == jax_tokens.block_hashes(toks, block_size)
    assert tokens.sequence_hashes(toks, block_size, salt) == \
        jax_tokens.sequence_hashes(toks, block_size, salt)
    seq = tokens.TokenBlockSequence(toks, block_size, salt=salt)
    assert seq.sequence_hashes() == tokens.sequence_hashes(toks, block_size, salt)


WIRE_EVENTS = [
    ("stored", dict(block_hashes=[1, 2], parent_hash=None)),
    ("stored", dict(block_hashes=[3], parent_hash=2, token_blocks=[[5, 6, 7, 8]])),
    ("stored", dict(block_hashes=[4, 5], parent_hash=3, tier="persist")),
    ("removed", dict(block_hashes=[9])),
    ("removed", dict(block_hashes=[9, 10], tier="persist")),
]


@pytest.mark.parametrize("kind,fields", WIRE_EVENTS)
def test_event_wire_equals_jax_both_ways(kind, fields):
    port_cls = KvStoredEvent if kind == "stored" else KvRemovedEvent
    jax_cls = jax_events.KvStoredEvent if kind == "stored" else jax_events.KvRemovedEvent
    wire = event_to_wire(11, 4, port_cls(**fields))
    assert wire == jax_events.event_to_wire(11, 4, jax_cls(**fields))
    eid, wid, back = jax_events.event_from_wire(dict(wire, extra="ignored"))
    assert (eid, wid, vars(back)) == (11, 4, vars(jax_cls(**fields)))
    eid, wid, back = event_from_wire(jax_events.event_to_wire(11, 4, jax_cls(**fields)))
    assert (eid, wid, vars(back)) == (11, 4, vars(port_cls(**fields)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recording_replays_in_the_other_package(tmp_path, writer):
    path = tmp_path / "events.jsonl"
    h = sequence_hashes(list(range(16)), BS)
    rec_cls, ev_mod = (KvRecorder, None) if writer == "port" else (JaxKvRecorder, jax_events)
    stored = ev_mod.KvStoredEvent if ev_mod else KvStoredEvent
    removed = ev_mod.KvRemovedEvent if ev_mod else KvRemovedEvent
    with rec_cls(path) as rec:
        rec.record(0, 7, stored(block_hashes=h, parent_hash=None))
        rec.record(1, 7, removed(block_hashes=[h[-1]]))
        rec.record(2, 8, stored(block_hashes=h[:2], tier="persist"))
    if writer == "port":
        idx = JaxKvRouter(block_size=BS).indexer
        assert jax_replay_into(path, idx) == 3
    else:
        idx = KvIndexer()
        assert replay_into(path, idx) == 3
    m = idx.find_matches(h)
    assert (m.scores, m.persist_scores) == ({7: 3}, {8: 2})


TRAFFIC = [list(range(0, 32)), list(range(100, 132)), list(range(0, 24)) + [7] * 8,
           list(range(100, 128)) + [9] * 4, list(range(300, 332))]


async def _pubsub_decisions(server_cls, pub_client_cls, sub_client_cls, publisher_cls,
                            metrics_cls, router_cls, subscriber_cls, selector_cls, event_mod):
    """Two workers publish events and metrics; a router subscribed over the
    coordinator routes TRAFFIC.  Returns the decisions."""
    srv = await server_cls(port=0).start()
    pub = await pub_client_cls(srv.url).connect()
    sub = await sub_client_cls(srv.url).connect()
    router = router_cls(block_size=BS, selector=selector_cls(random.Random(3)))
    subscriber = await subscriber_cls(router, sub, namespace="rt").start()
    try:
        load = {1: {"request_active_slots": 1, "request_total_slots": 8, "kv_active_blocks": 4,
                    "kv_total_blocks": 64},
                2: {"request_active_slots": 0, "request_total_slots": 8, "kv_active_blocks": 2,
                    "kv_total_blocks": 64}}
        pubs = {w: publisher_cls(pub, w, namespace="rt") for w in (1, 2)}
        for w in (1, 2):
            await metrics_cls(pub, w, lambda w=w: load[w], namespace="rt").publish_once()
        h0, h1 = sequence_hashes(TRAFFIC[0], BS), sequence_hashes(TRAFFIC[1], BS)
        pubs[1].sink(event_mod.KvStoredEvent(block_hashes=h0, parent_hash=None))
        pubs[2].sink(event_mod.KvStoredEvent(block_hashes=h1[:5], parent_hash=None))
        pubs[2].sink(event_mod.KvStoredEvent(block_hashes=h0[:8], tier="persist"))
        pubs[1].sink(event_mod.KvRemovedEvent(block_hashes=h0[2:]))
        for p in pubs.values():
            await p.flush()
        for _ in range(200):
            if len(router.scheduler.workers()) == 2 and router.indexer.num_blocks == 7:
                break
            await asyncio.sleep(0.01)
        out = []
        for toks in TRAFFIC:
            d = router.schedule(toks)
            out.append((d.worker_id, d.overlap_blocks, d.persist_blocks))
        return out
    finally:
        await subscriber.stop()
        await pub.close()
        await sub.close()
        await srv.stop()


def test_publishers_feed_the_other_package_router():
    """A port publisher → the JAX router over the JAX coordinator, and a JAX
    publisher → the port router over the port's coordinator: the same
    decisions, and the ones the events imply."""
    port_to_jax = run(_pubsub_decisions(
        JaxCoordinatorServer, CoordinatorClient, JaxCoordinatorClient, KvEventPublisher,
        KvMetricsPublisher, JaxKvRouter, JaxKvRouterSubscriber, JaxSelector,
        port_events))
    jax_to_port = run(_pubsub_decisions(
        CoordinatorServer, JaxCoordinatorClient, CoordinatorClient, JaxKvEventPublisher,
        JaxKvMetricsPublisher, KvRouter, KvRouterSubscriber, DefaultWorkerSelector, jax_events))
    assert port_to_jax == jax_to_port
    # prompt 0: worker 2's 8 persist blocks beat worker 1's 2 device blocks
    assert port_to_jax[0] == (2, 0, 8)
    assert port_to_jax[1] == (2, 5, 0)  # worker 2 holds prompt 1's first 5 blocks
    assert port_to_jax[2] == (2, 0, 6)  # 6 of prompt 0's blocks, on disk
    assert port_to_jax[4] == (1, 0, 0)  # no overlap: the less loaded worker


# ---------------------------------------------------------- worker wiring


class _Runtime:
    """The duck-typed runtime ``attach_worker_publishers`` takes."""

    def __init__(self, coordinator, instance_id):
        self.coordinator = coordinator
        self.instance_id = instance_id
        self._stops = []

    def on_shutdown(self, fn):
        self._stops.append(fn)

    async def shutdown(self):
        for fn in reversed(self._stops):
            await fn()


def _registered(core) -> int:
    return len(core.block_manager._table)


def test_worker_wiring_routes_prefixes_to_their_engine():
    cfg = ModelConfig.tiny()
    model = LlamaModel.from_state(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                                   device="cpu"))
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(1, cfg.vocab_size, 32).tolist() for _ in range(2)]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        clients = [await CoordinatorClient(srv.url).connect() for _ in range(3)]
        ecfg = EngineConfig(max_batch_size=2, max_model_len=64, block_size=BS, num_blocks=128)
        engines = {w: AsyncLLMEngine(EngineCore(model, ecfg, device="cpu")).start()
                   for w in (1, 2)}
        runtimes = {w: _Runtime(clients[i], w) for i, w in enumerate((1, 2))}
        for w in (1, 2):
            attach_worker_publishers(runtimes[w], engines[w], "wire")
        router = KvRouter(block_size=BS, selector=DefaultWorkerSelector(random.Random(0)))
        subscriber = await KvRouterSubscriber(router, clients[2], namespace="wire").start()
        decisions = []
        try:
            for _ in range(200):
                if len(router.scheduler.workers()) == 2:
                    break
                await asyncio.sleep(0.01)
            for i in range(6):
                toks = prefixes[i % 2] + rng.integers(1, cfg.vocab_size, 8).tolist()
                d = router.schedule(toks)
                decisions.append((d.worker_id, d.overlap_blocks))
                ctx = Context(BackendInput(token_ids=toks, sampling=SamplingOptions(
                    temperature=0.0), stops=StopConditions(max_tokens=2)), id=f"r{i}")
                outs = await engines[d.worker_id].generate_all(ctx)
                assert outs[-1].cached_tokens >= (32 if i >= 2 else 0)
                await asyncio.sleep(0.2)  # the event flush (50 ms) lands at the router
            await asyncio.sleep(0.2)
            for w in (1, 2):
                assert router.indexer.worker_blocks(w) == _registered(engines[w].core)
        finally:
            await subscriber.stop()
            for w in (1, 2):
                await runtimes[w].shutdown()
                engines[w].shutdown()
            for c in clients:
                await c.close()
            await srv.stop()
        return decisions

    decisions = run(go())
    first = {0: decisions[0][0], 1: decisions[1][0]}
    for i, (wid, overlap) in enumerate(decisions[2:], start=2):
        assert wid == first[i % 2] and overlap >= 8, decisions
