"""The port's sharded router control plane against the JAX package's.

Every case runs on the same seeded inputs in both packages and holds the
port to JAX with exact equality (all of it is integer and structural
state):

* partitioning: ``shard_of``, ``split_hashes``, ``split_event``,
  ``membership_generation`` and ``ShardMap`` on seeded hashes and replica
  sets;
* ``ShardedKvIndexer.find_matches`` equal to JAX's and to the singleton
  index, on a shared-prefix fleet and on ``MockWorker`` event streams;
* the gather, its generation fence, the index handoff, the deadline that
  degrades a gather without blocking it, and the counters (and their
  ``/metrics`` family, line for line);
* the wire frames, byte for byte;
* replicas on a real coordinator: membership, warm handoff on a join, a
  replica's death, and a mixed membership of JAX and port replicas that
  reach one generation, import each other's handoff frames and serve each
  other's schedulers the same decision.
"""

import asyncio
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest

import dynamo_tpu.components.mock_worker as jax_mock
import dynamo_tpu.engine.counters as jax_counters
import dynamo_tpu.llm.http.metrics as jax_http_metrics
import dynamo_tpu.llm.kv.events as jax_events
import dynamo_tpu.llm.kv_router.indexer as jax_indexer
import dynamo_tpu.llm.kv_router.publisher as jax_publisher
import dynamo_tpu.llm.kv_router.scheduler as jax_scheduler
import dynamo_tpu.llm.kv_router.shards as jax_shards
import dynamo_tpu.llm.kv_router.shards.wire as jax_wire
import dynamo_tpu.runtime.transports.coordinator as jax_coord
import dynamo_tpu.tokens as jax_tokens
import dynamo_tpu_torch.components.mock_worker as mock
import dynamo_tpu_torch.engine.counters as counters
import dynamo_tpu_torch.llm.http.metrics as http_metrics
import dynamo_tpu_torch.llm.kv.events as events
import dynamo_tpu_torch.llm.kv_router.indexer as indexer
import dynamo_tpu_torch.llm.kv_router.publisher as publisher
import dynamo_tpu_torch.llm.kv_router.scheduler as scheduler
import dynamo_tpu_torch.llm.kv_router.shards as shards
import dynamo_tpu_torch.llm.kv_router.shards.wire as wire
import dynamo_tpu_torch.runtime.transports.coordinator as coord
import dynamo_tpu_torch.tokens as tokens
from dynamo_tpu_torch.obs.metric_names import SHARD_PREFIX


def _pkg(sh, wi, ev, ix, sc, ctr, tok, mk, pub, co, hm):
    return SimpleNamespace(sh=sh, wire=wi, ev=ev, ix=ix, sched=sc, counters=ctr.kv_shard_counters,
                           tok=tok, mock=mk, pub=pub, coord=co, http=hm)


JAX = _pkg(jax_shards, jax_wire, jax_events, jax_indexer, jax_scheduler, jax_counters,
           jax_tokens, jax_mock, jax_publisher, jax_coord, jax_http_metrics)
PORT = _pkg(shards, wire, events, indexer, scheduler, counters, tokens, mock, publisher, coord,
            http_metrics)
BLOCK = 16


@pytest.fixture(autouse=True)
def _clean_counters():
    """The shard counters are process-global in both packages."""
    JAX.counters.reset()
    PORT.counters.reset()
    yield
    JAX.counters.reset()
    PORT.counters.reset()


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def seq(p, toks):
    return p.tok.sequence_hashes([int(t) for t in toks], BLOCK)


def _seeded_tokens(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 50_000, size=n)]


def _feed(p, indexers, worker_id, ev):
    for ix in indexers:
        ix.apply_event(worker_id, ev)


def _populate(p, indexers):
    """The JAX tests' shared-prefix fleet on seeded tokens: w1 holds all 8
    blocks, w2 the first 4 (and the whole prefix on its persist tier), w3
    diverges after 2, then w1 drops its two tail blocks."""
    base = _seeded_tokens(0, 128)
    _feed(p, indexers, 1, p.ev.KvStoredEvent(block_hashes=seq(p, base)))
    _feed(p, indexers, 2, p.ev.KvStoredEvent(block_hashes=seq(p, base[:64])))
    _feed(p, indexers, 2, p.ev.KvStoredEvent(block_hashes=seq(p, base),
                                             tier=p.ev.TIER_PERSIST))
    fork = base[:32] + _seeded_tokens(1, 96)
    _feed(p, indexers, 3, p.ev.KvStoredEvent(block_hashes=seq(p, fork)))
    _feed(p, indexers, 1, p.ev.KvRemovedEvent(block_hashes=seq(p, base)[6:]))
    return base, fork


def _queries(p, base, fork):
    return [seq(p, q) for q in (base, base[:48], fork, _seeded_tokens(2, 64))]


def _scores(ov):
    return (dict(ov.scores), dict(ov.persist_scores))


def _reply(r):
    return None if r is None else dataclasses.astuple(r)


# ----------------------------------------------------------- partitioning ----


@pytest.mark.parametrize("n", [1, 2, 4, 7, 8])
def test_shard_of_and_split_hashes_equal_jax(n):
    hashes = seq(PORT, _seeded_tokens(3, 16 * 40))
    assert hashes == seq(JAX, _seeded_tokens(3, 16 * 40))
    owners = [shards.shard_of(h, n) for h in hashes]
    assert owners == [jax_shards.shard_of(h, n) for h in hashes]
    assert set(owners) <= set(range(n)) and (n == 1 or len(set(owners)) > 1)
    parts = shards.split_hashes(hashes, n)
    assert parts == jax_shards.split_hashes(hashes, n)
    assert sorted(h for hs in parts.values() for h in hs) == sorted(hashes)
    for s, hs in parts.items():
        assert hs == [h for h in hashes if shards.shard_of(h, n) == s]


def test_split_event_equal_jax():
    toks = _seeded_tokens(4, 96)
    blocks = [toks[i * BLOCK:(i + 1) * BLOCK] for i in range(6)]

    def split(p):
        hashes = seq(p, toks)
        stored = p.ev.KvStoredEvent(block_hashes=list(hashes), parent_hash=None,
                                    token_blocks=blocks, tier=p.ev.TIER_PERSIST)
        removed = p.ev.KvRemovedEvent(block_hashes=list(hashes))
        out = {}
        for name, ev in (("stored", stored), ("removed", removed)):
            for n in (1, 4):
                out[name, n] = {s: p.ev.event_to_wire(0, 9, sub)
                                for s, sub in p.sh.split_event(ev, n).items()}
        assert p.sh.split_event(stored, 1) == {0: stored}
        return hashes, out

    hashes, got = split(PORT)
    assert got == split(JAX)[1]
    by_hash = dict(zip(hashes, blocks))
    for s, sub in got["stored", 4].items():
        assert sub["kind"] == "stored" and sub["tier"] == "persist" and sub["parent_hash"] is None
        assert sub["token_blocks"] == [by_hash[h] for h in sub["block_hashes"]]
    assert sorted(h for sub in got["removed", 4].values() for h in sub["block_hashes"]) \
        == sorted(hashes)


@pytest.mark.parametrize("replicas,n", [
    (["r1"], 4), (["r1", "r2"], 4), (["r2", "r1", "r3"], 8), (["r1", "r2"], 8),
    ([f"router-{i}" for i in range(5)], 16),
], ids=["one", "two", "three", "two-n8", "five-n16"])
def test_membership_generation_and_shard_map_equal_jax(replicas, n):
    gen = shards.membership_generation(replicas, n)
    assert gen == jax_shards.membership_generation(replicas, n)
    assert isinstance(gen, int) and gen == shards.membership_generation(sorted(replicas), n)
    m, jm = shards.ShardMap.from_replicas(replicas, n), jax_shards.ShardMap.from_replicas(replicas, n)
    assert (m.n_shards, m.generation, m.owners) == (jm.n_shards, jm.generation, jm.owners)
    joined = m.rebind(replicas + ["late"])
    jjoined = jm.rebind(replicas + ["late"])
    assert (joined.generation, joined.owners) == (jjoined.generation, jjoined.owners)
    moved = m.moved_shards(joined)
    assert moved == jm.moved_shards(jjoined)
    # a join only pulls shards onto the joiner and never reshuffles all
    assert all(joined.owner(s) == "late" for s in moved) and len(moved) < n
    assert [m.shards_of(r) for r in replicas] == [jm.shards_of(r) for r in replicas]
    # ABA: the prior composition resurrects its generation and owners, and
    # two histories that reach one membership agree
    back = joined.rebind(replicas)
    assert (back.generation, back.owners) == (m.generation, m.owners)
    via_join = shards.ShardMap.from_replicas(replicas[:1], n).rebind(replicas)
    assert (via_join.generation, via_join.owners) == (m.generation, m.owners)


# ------------------------------------------------------------ equivalence ----


def _fleet(p, n_shards):
    singleton = p.ix.KvIndexer(use_native=False)
    sharded = p.sh.ShardedKvIndexer(n_shards)
    base, fork = _populate(p, [singleton, sharded])
    return singleton, sharded, base, fork


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_sharded_matches_singleton_and_jax(n_shards):
    single, sharded, base, fork = _fleet(PORT, n_shards)
    _, jsharded, _, _ = _fleet(JAX, n_shards)
    for q in _queries(PORT, base, fork):
        got = _scores(sharded.find_matches(q))
        assert got == _scores(single.find_matches(q)) == _scores(jsharded.find_matches(q))
    assert sharded.workers() == single.workers() == jsharded.workers()
    assert sharded.num_blocks == single.num_blocks == jsharded.num_blocks
    assert sharded.resident_keys == jsharded.resident_keys
    assert sharded.shard_sizes() == jsharded.shard_sizes()
    assert PORT.counters.index_blocks == JAX.counters.index_blocks
    assert PORT.counters.resident_keys == JAX.counters.resident_keys


def _mock_stream(p, worker_id, seed, ticks):
    """The events a MockWorker's simulated engine steps emit (no coordinator)."""
    w = p.mock.MockWorker(None, worker_id=worker_id, total_blocks=24, seed=seed)
    out = []
    w.events.sink = out.append
    for _ in range(ticks):
        w._tick()
    return out, w._snapshot()


def test_sharded_matches_on_mock_worker_streams():
    def build(p):
        single = p.ix.KvIndexer(use_native=False)
        sharded = p.sh.ShardedKvIndexer(4)
        wires, snaps = [], []
        for wid, seed in ((11, 5), (12, 6), (13, None)):
            evs, snap = _mock_stream(p, wid, seed, 40)
            snaps.append(snap)
            for i, ev in enumerate(evs):
                wires.append(p.ev.event_to_wire(i, wid, ev))
                single.apply_event(wid, ev)
                sharded.apply_event(wid, ev, event_id=i)
        return single, sharded, wires, snaps

    single, sharded, wires, snaps = build(PORT)
    jsingle, jsharded, jwires, jsnaps = build(JAX)
    assert wires == jwires and snaps == jsnaps
    assert {w["kind"] for w in wires} == {"stored", "removed"}
    # every stored prefix the stream published, and a miss
    queries = [w["block_hashes"] for w in wires if w["kind"] == "stored"] + [[1, 2, 3]]
    for q in queries:
        got = _scores(sharded.find_matches(q))
        assert got == _scores(single.find_matches(q)) == _scores(jsharded.find_matches(q))
    assert sharded.num_blocks == single.num_blocks == jsingle.num_blocks > 0


def test_gather_fence_and_handoff_equal_jax():
    def go(p):
        _, sharded, base, _ = _fleet(p, 4)
        query = seq(p, base)
        replies = {s: p.sh.probe_shard(sharded.shard(s), s, 4, query, 7) for s in range(4)}
        full, partial = p.sh.gather_overlaps(query, 4, replies, 7)
        assert not partial and _scores(full) == _scores(sharded.find_matches(query))
        stale = p.sh.shard_of(query[0], 4)
        fenced_replies = dict(replies)
        fenced_replies[stale] = p.sh.probe_shard(sharded.shard(stale), stale, 4, query, 6)
        fenced, fpartial = p.sh.gather_overlaps(query, 4, fenced_replies, 7)
        missing = dict(replies)
        missing[p.sh.shard_of(query[3], 4)] = None
        cut, mpartial = p.sh.gather_overlaps(query, 4, missing, 7)
        exports = [sharded.export_shard(s) for s in range(4)]
        return ({s: _reply(r) for s, r in replies.items()}, _scores(full), _scores(fenced),
                fpartial, _scores(cut), mpartial, exports, query)

    got, want = go(PORT), go(JAX)
    assert got == want
    _, full, fenced, fpartial, cut, mpartial, exports, query = got
    assert fpartial and mpartial
    # fencing and a missing shard only under-count, never invent
    for part in (fenced, cut):
        for tier in (0, 1):
            assert all(part[tier].get(w, 0) <= c for w, c in full[tier].items())
    assert fenced[0] == {}, "the shard owning position 0 was fenced"
    # a handoff snapshot of either package installs in the other
    for src, dst_pkg in ((JAX, PORT), (PORT, JAX)):
        dst = dst_pkg.sh.ShardedKvIndexer(4)
        for s, (device, persist) in enumerate(exports):
            dst.import_shard(s, device, persist)
        assert _scores(dst.find_matches(query)) == full


# ------------------------------------------------------------------- wire ----


BIG = (1 << 64) - 5  # a 64-bit hash near the top: must stay an int


@pytest.mark.parametrize("frame", ["announce", "scatter", "reply", "handoff"])
def test_wire_frames_byte_equal(frame):
    hashes = seq(PORT, _seeded_tokens(7, 64)) + [BIG]
    holders = {0: frozenset({3, 1}), 4: frozenset({2})}
    persist = {1: frozenset({2})}

    def enc(p):
        if frame == "announce":
            return p.wire.encode_shard_announce("r-2", [5, 1, 3], 123)
        if frame == "scatter":
            return p.wire.encode_scatter_request("c:1:9", 3, hashes, BIG, "ns.inbox.c.3")
        if frame == "reply":
            return p.wire.encode_scatter_reply("c:1:9", p.sh.ShardReply(3, BIG, holders, persist))
        return p.wire.encode_shard_handoff(3, BIG, "r-1", {BIG: [2, 1], hashes[0]: [4]},
                                           {hashes[1]: [7]})

    def dec(p, payload):
        fn = {"announce": p.wire.decode_shard_announce, "scatter": p.wire.decode_scatter_request,
              "reply": p.wire.decode_scatter_reply, "handoff": p.wire.decode_shard_handoff}[frame]
        out = fn(payload)
        return (out[0], _reply(out[1])) if frame == "reply" else out

    data = enc(PORT)
    assert data == enc(JAX)
    assert dec(PORT, data) == dec(JAX, data)
    assert BIG not in (3, 123) and str(BIG).encode() in data or frame == "announce"
    if frame == "scatter":
        assert dec(PORT, data)[2][-1] == BIG and isinstance(dec(PORT, data)[3], int)
    with pytest.raises(ValueError):
        other = "scatter" if frame != "scatter" else "reply"
        {"announce": wire.decode_shard_announce, "scatter": wire.decode_scatter_request,
         "reply": wire.decode_scatter_reply, "handoff": wire.decode_shard_handoff}[other](data)
    for name in ("announce", "scatter", "handoff"):
        subj = getattr(wire, f"shard_{name}_subject")
        jsubj = getattr(jax_wire, f"shard_{name}_subject")
        args = [("ns",)] if name == "announce" else [("ns",), ("ns", 3), ("ns", "")]
        assert [subj(*a) for a in args] == [jsubj(*a) for a in args]


# --------------------------------------------- deadline-degraded gather ----


def _fleet_scheduler(p):
    sched = p.sched.KvScheduler()
    for wid in (1, 2, 3):
        sched.update_worker(p.sched.WorkerMetrics(
            worker_id=wid, request_active_slots=wid - 1, request_total_slots=8,
            kv_active_blocks=10 * wid, kv_total_blocks=128))
    return sched


def _deadline_case(p):
    _, sharded, base, _ = _fleet(p, 4)
    query = seq(p, base)
    fast = [p.sh.LocalShardClient(s, 4, sharded.shard(s)) for s in range(4)]
    full_gate = p.sh.ScatterGatherScheduler(_fleet_scheduler(p), fast, 4, deadline_s=5.0)
    full, partial = run(full_gate.overlaps(query))
    assert not partial and full.scores
    slow_shard = p.sh.shard_of(query[0], 4)
    slow = [p.sh.LocalShardClient(s, 4, sharded.shard(s),
                                  delay_s=0.5 if s == slow_shard else 0.0) for s in range(4)]
    gate = p.sh.ScatterGatherScheduler(_fleet_scheduler(p), slow, 4, deadline_s=0.02)
    t0 = time.perf_counter()
    degraded, partial = run(gate.overlaps(query))
    elapsed = time.perf_counter() - t0
    assert partial and elapsed < 0.45, "the gather cuts the stalled shard at its deadline"
    wid = run(gate.schedule(query, len(base)))
    cands = run(full_gate.score_candidates(query, len(base)))
    ctr = p.counters
    return (_scores(full), _scores(degraded), wid, cands, ctr.gather_partial_total,
            ctr.scatters_total, ctr.last_fan_out, ctr.gather_partial_frac)


def test_deadline_miss_degrades_scores_never_blocks():
    got, want = _deadline_case(PORT), _deadline_case(JAX)
    assert got == want
    full, degraded, wid, _, partial_total, scatters, fan_out, frac = got
    assert all(c <= full[0].get(w, 0) for w, c in degraded[0].items())
    assert wid in (1, 2, 3)
    assert (partial_total, scatters, fan_out) == (2, 4, 4) and frac == 0.5


def test_replica_own_generation_wins_over_request():
    def go(p):
        _, sharded, base, _ = _fleet(p, 4)
        query = seq(p, base)
        lagging = p.sh.shard_of(query[0], 4)
        clients = [p.sh.LocalShardClient(s, 4, sharded.shard(s),
                                         generation_fn=(lambda: 1) if s == lagging else None)
                   for s in range(4)]
        gate = p.sh.ScatterGatherScheduler(_fleet_scheduler(p), clients, 4, deadline_s=5.0,
                                           generation=2)
        scores, partial = run(gate.overlaps(query))
        gate.set_generation(1)
        # at the lagging replica's generation the others echo the request's,
        # so the gather is whole again
        other, opartial = run(gate.overlaps(query))
        return _scores(scores), partial, _scores(other), opartial

    got = go(PORT)
    assert got == go(JAX)
    assert got[1] and got[0] == ({}, {})
    assert not got[3] and got[2][0]


# ------------------------------------------------------------- counters ----


def _shard_family(text):
    return [line for line in text.splitlines()
            if line.startswith(SHARD_PREFIX) or line.startswith(f"# TYPE {SHARD_PREFIX}")]


def test_shard_counters_and_metrics_family_equal_jax():
    def go(p):
        _, sharded, base, _ = _fleet(p, 2)
        sharded.find_matches(seq(p, base))
        ctr = p.counters
        assert (ctr.scatters_total, ctr.last_fan_out) == (1, 2)
        assert sum(ctr.fanout_bucket_counts) >= 1
        sizes = sharded.shard_sizes()
        assert ctr.index_blocks == {s: b for s, (b, _) in enumerate(sizes)}
        ctr.set_generation(99)
        ctr.record_partial_gather()
        # the fan-out time is the host's: fix it so the renders compare
        ctr.record_scatter(0.3, fan_out=3)
        ctr.fanout_ms_sum = 1.25
        ctr.fanout_bucket_counts = list(range(len(ctr.FANOUT_BUCKETS_MS)))
        family = _shard_family(p.http.Metrics().render())
        state = (sizes, ctr.generation, ctr.gather_partial_frac, ctr.FANOUT_BUCKETS_MS)
        ctr.reset()
        assert ctr.gather_partial_frac == 0.0 and ctr.index_blocks == {}
        return family, state

    got, want = go(PORT), go(JAX)
    assert got == want
    family = got[0]
    # four scalars, the histogram (its buckets, +Inf, sum, count), and two
    # per-shard gauges over two shards
    n_buckets = len(counters.KvShardCounters.FANOUT_BUCKETS_MS)
    assert len(family) == 4 * 2 + (1 + n_buckets + 3) + 2 * (1 + 2)


# ------------------------------------------------ replicas on a coordinator ----


async def _wait_for(cond, timeout=5.0):
    async def poll():
        while not cond():
            await asyncio.sleep(0.01)

    await asyncio.wait_for(poll(), timeout)


class _Fleet:
    """Replicas of one package or both on one coordinator, each replica on a
    connection of its own (its death is its connection closing), plus the
    scheduler's connection and a worker's that publishes KV events."""

    def __init__(self, srv, ns, n_shards):
        self.srv, self.ns, self.n_shards = srv, ns, n_shards
        self.replicas, self.conns, self.clients = {}, [], []

    async def conn(self, p):
        c = await p.coord.CoordinatorClient(self.srv.url).connect()
        self.conns.append(c)
        return c

    async def add(self, p, rid):
        c = await self.conn(p)
        r = p.sh.ShardReplica(c, rid, self.n_shards, namespace=self.ns, lease_ttl_s=5.0)
        await r.subscribe_events(p.pub.events_subject(self.ns))
        await r.start()
        self.replicas[rid] = (p, r, c)
        return r

    async def gate(self, p, client_id, deadline_s=0.5):
        c = await self.conn(p)
        clients = [await p.sh.PubSubShardClient(c, self.ns, s, client_id).start()
                   for s in range(self.n_shards)]
        self.clients += clients
        sched = _fleet_scheduler(p)
        return p.sh.ScatterGatherScheduler(sched, clients, self.n_shards, deadline_s=deadline_s)

    def generations(self):
        return {rid: r.map.generation for rid, (_, r, _) in self.replicas.items()}

    async def settle(self, live):
        """Every live replica at the membership's generation and subscribed
        to the scatter subjects of exactly the shards it owns."""
        want = shards.membership_generation(sorted(live), self.n_shards)

        def done(rid):
            r = self.replicas[rid][1]
            return (r.map.generation == want and not r._bg_tasks
                    and set(r._subs) == set(r.map.shards_of(rid)))

        await _wait_for(lambda: all(done(r) for r in live))
        return want

    async def warm(self, joiner, rid, owners_before):
        """The joiner's owned ranges equal their previous owners' exports:
        the handoff frames have landed."""
        mine = joiner.map.shards_of(rid)
        await _wait_for(lambda: all(
            joiner.index.export_shard(s)
            == self.replicas[owners_before[s]][1].index.export_shard(s) for s in mine))
        return {s: owners_before[s] for s in mine}

    async def kill(self, rid):
        """Death without a stop: the connection closes, which revokes the
        replica's lease on the coordinator at once, and no handoff ships."""
        p, r, c = self.replicas.pop(rid)
        await c.close()
        for t in list(r._bg_tasks):
            t.cancel()
        await asyncio.gather(*r._bg_tasks, return_exceptions=True)

    async def close(self):
        for cl in self.clients:
            await cl.stop()
        for _, r, _ in self.replicas.values():
            await r.stop()
        for c in self.conns:
            await c.close()


async def _publish_fleet(p, worker, ns):
    """The shared-prefix fleet as worker KV events on the event plane."""
    sent = []

    class _Sink:
        def apply_event(self, wid, ev):
            sent.append((wid, ev))

    base, fork = _populate(p, [_Sink()])
    for i, (wid, ev) in enumerate(sent):
        await worker.publish(p.pub.events_subject(ns, wid), p.ev.event_to_wire(i, wid, ev))
    return base, fork, len(sent)


def _lifecycle(p):
    async def go():
        srv = await PORT.coord.CoordinatorServer(port=0).start()
        fleet = _Fleet(srv, "t", 8)
        out = {}
        try:
            for rid in ("ra", "rb", "rc"):
                await fleet.add(p, rid)
            gen3 = await fleet.settle(["ra", "rb", "rc"])
            gate = await fleet.gate(p, "sched")
            gate.set_generation(gen3)
            worker = await fleet.conn(p)
            base, fork, n_events = await _publish_fleet(p, worker, "t")
            single = p.ix.KvIndexer(use_native=False)
            _populate(p, [single])
            await _wait_for(lambda: all(r.index.num_blocks == single.num_blocks
                                        for _, r, _ in fleet.replicas.values()))
            queries = _queries(p, base, fork)
            out["full"] = []
            for q in queries:
                ov, partial = await gate.overlaps(q)
                assert not partial and _scores(ov) == _scores(single.find_matches(q))
                out["full"].append(_scores(ov))
            # a join: old owners ship the moved shards, the joiner imports them
            owners_before = dict(fleet.replicas["ra"][1].map.owners)
            rd = await fleet.add(p, "rd")
            gen4 = await fleet.settle(["ra", "rb", "rc", "rd"])
            # the joiner's fresh index knows nothing of the fleet until the
            # handoff frames land: a warm handoff fills its owned ranges
            moved = sorted(await fleet.warm(rd, "rd", owners_before))
            assert moved and all(owners_before[s] != "rd" for s in moved)
            gate.set_generation(gen4)
            ov, partial = await gate.overlaps(queries[0])
            assert not partial and _scores(ov) == out["full"][0]
            out["join"] = (moved, gen4 != gen3)
            # a death: ra's ranges go cold on their new owners, the gather
            # misses them until the fence moves, and never blocks
            await fleet.kill("ra")
            gen_dead = await fleet.settle(["rb", "rc", "rd"])
            t0 = time.perf_counter()
            stale, spartial = await gate.overlaps(queries[0])
            waited = time.perf_counter() - t0
            assert spartial and waited < 2.0
            gate.set_generation(gen_dead)
            after, apartial = await gate.overlaps(queries[0])
            for tier in (0, 1):
                assert all(c <= out["full"][0][tier].get(w, 0)
                           for w, c in _scores(after)[tier].items())
            wid = await gate.schedule(queries[0], 128)
            out["death"] = (_scores(stale), _scores(after), apartial, wid, n_events)
            out["generations"] = (gen3, gen4, gen_dead)
            out["partials"] = p.counters.gather_partial_total >= 1
        finally:
            await fleet.close()
            await srv.stop()
        return out

    return run(go())


def test_replica_lifecycle_equal_jax():
    got = _lifecycle(PORT)
    assert got == _lifecycle(JAX)
    assert got["partials"] and got["join"][1]
    assert got["generations"][2] == shards.membership_generation(["rb", "rc", "rd"], 8)


def test_mixed_membership_across_packages():
    """JAX and port replicas on one coordinator reach one generation, import
    each other's handoff frames, and each package's scheduler gathers the
    same decision from the other's replicas."""
    async def go():
        srv = await PORT.coord.CoordinatorServer(port=0).start()
        fleet = _Fleet(srv, "mix", 16)
        try:
            await fleet.add(JAX, "jx-1")
            await fleet.add(PORT, "pt-1")
            live = ["jx-1", "pt-1"]
            gens = [await fleet.settle(live)]
            worker = await fleet.conn(PORT)
            base, fork, _ = await _publish_fleet(PORT, worker, "mix")
            single = PORT.ix.KvIndexer(use_native=False)
            _populate(PORT, [single])
            await _wait_for(lambda: all(r.index.num_blocks == single.num_blocks
                                        for _, r, _ in fleet.replicas.values()))
            # joiners of both packages: each takes its shards by handoff
            # frames, some of them the other package's
            handoffs = []
            for p, rid in ((PORT, "pt-2"), (JAX, "jx-2")):
                owners_before = dict(fleet.replicas["pt-1"][1].map.owners)
                joiner = await fleet.add(p, rid)
                live.append(rid)
                gens.append(await fleet.settle(live))
                assert len(set(fleet.generations().values())) == 1
                handoffs += [(src[:2], rid[:2])
                             for src in (await fleet.warm(joiner, rid, owners_before)).values()]
            assert gens[-1] == jax_shards.membership_generation(live, 16)
            assert len(set(gens)) == 3
            port_gate = await fleet.gate(PORT, "port-sched")
            jax_gate = await fleet.gate(JAX, "jax-sched")
            decisions = []
            for g in (port_gate, jax_gate):
                g.set_generation(gens[-1])
                row = []
                for q in _queries(PORT, base, fork):
                    ov, partial = await g.overlaps(q)
                    assert not partial and _scores(ov) == _scores(single.find_matches(q))
                    row.append((_scores(ov), await g.schedule(q, len(q) * BLOCK)))
                decisions.append(row)
            return handoffs, decisions
        finally:
            await fleet.close()
            await srv.stop()

    handoffs, (port_row, jax_row) = run(go())
    assert port_row == jax_row
    # handoff frames crossed the packages both ways
    assert {("pt", "jx"), ("jx", "pt")} <= set(handoffs), handoffs
