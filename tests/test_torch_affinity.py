"""The port's consistent-hash ring and session affinity against the JAX
package's.

* Ring placements: the same members and keys land on the same nodes in
  both packages, through adds and removes, and the ring keeps its
  uniformity and minimal-movement properties.
* Affinity decisions: the JAX package's restart scenario (32 sessions
  over three frontends, one frontend restarting) gives the same owner,
  locality, source and redirect for every resolve in both packages.
* The coordinator-backed persist index: a holder one package records is
  the holder the other reads.
* HTTP: a session owned by a peer gets a 307 to the owner's URL with
  ``x-affinity-owner`` / ``x-affinity-source``; a local one is served with
  those headers and recorded as served.
"""

import asyncio

import pytest
from aiohttp import ClientSession

from dynamo_tpu.llm.http.affinity import CoordAffinityIndex as JaxCoordAffinityIndex
from dynamo_tpu.llm.http.affinity import LocalAffinityIndex as JaxLocalAffinityIndex
from dynamo_tpu.llm.http.affinity import SessionAffinity as JaxSessionAffinity
from dynamo_tpu.runtime.transports.coordinator import CoordinatorClient as JaxCoordinatorClient
from dynamo_tpu.utils.chash import HashRing as JaxHashRing
from dynamo_tpu_torch.llm.http.affinity import (CoordAffinityIndex, LocalAffinityIndex,
                                                SessionAffinity)
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer
from dynamo_tpu_torch.utils.chash import HashRing


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


KEYS = [f"key-{k}" for k in range(3000)] + ["", "sess/ü", "a" * 300]


@pytest.mark.parametrize("members,vnodes", [
    (["solo"], 64),
    ([f"fe-{i}" for i in range(3)], 64),
    ([f"node-{i}" for i in range(16)], 64),
    (["alpha", "beta", "gamma", "delta"], 7),
], ids=["one", "three", "sixteen", "vnodes7"])
def test_ring_placements_equal_jax(members, vnodes):
    ring, jring = HashRing(members, vnodes=vnodes), JaxHashRing(members, vnodes=vnodes)
    assert ring._points == jring._points and ring._owners == jring._owners
    assert [ring.lookup(k) for k in KEYS] == [jring.lookup(k) for k in KEYS]
    for r in (ring, jring):
        r.add("late")
        r.remove(members[0])
    assert [ring.lookup(k) for k in KEYS] == [jring.lookup(k) for k in KEYS]
    assert ring.nodes() == jring.nodes() and len(ring) == len(jring)


def test_ring_movement_and_uniformity():
    ring = HashRing(f"n{i}" for i in range(8))
    before = {k: ring.lookup(k) for k in KEYS}
    ring.add("n8")
    moved = [k for k in KEYS if ring.lookup(k) != before[k]]
    assert moved and all(ring.lookup(k) == "n8" for k in moved)
    assert len(moved) / len(KEYS) < 2 / 9
    ring.remove("n8")
    assert {k: ring.lookup(k) for k in KEYS} == before
    counts = {}
    for k in KEYS:
        counts[ring.lookup(k)] = counts.get(ring.lookup(k), 0) + 1
    assert max(counts.values()) / (len(KEYS) / 8) < 1.35
    empty = HashRing()
    assert empty.lookup("x") is None
    with pytest.raises(ValueError):
        HashRing(vnodes=0)


async def _restart_scenario(affinity_cls, index_cls) -> list:
    """The JAX package's affinity scenario: every resolve's decision."""
    index = index_cls()
    fids = ["fe-0", "fe-1", "fe-2"]
    urls = {f: f"http://{f}:8000" for f in fids}
    fes = {f: affinity_cls(f, urls, persist_index=index) for f in fids}
    decisions = []

    async def resolve(fe, s):
        d = await fes[fe].resolve(s)
        decisions.append((fe, s, d.owner, d.is_local, d.source, d.redirect_url))
        return d

    sessions = [f"sess-{i}" for i in range(32)]
    warm = {}
    for s in sessions:
        owner = fes["fe-0"].ring.lookup(s)
        d = await resolve(owner, s)
        assert d.is_local and d.source == "ring"
        await fes[owner].note_served(s)
        warm[s] = owner
    for f in ("fe-0", "fe-1"):
        fes[f].remove_frontend("fe-2")
    displaced = [s for s in sessions if warm[s] == "fe-2"]
    assert displaced
    for s in displaced:
        stand_in = fes["fe-0"].ring.lookup(s)
        await resolve(stand_in, s)
        await fes[stand_in].note_served(s)
        warm[s] = stand_in
    for f in ("fe-0", "fe-1"):
        fes[f].add_frontend("fe-2", urls["fe-2"])
    fes["fe-2"] = affinity_cls("fe-2", urls, persist_index=index)
    for s in sessions:
        resolver = next(f for f in fids if f != warm[s] and (f != "fe-2" or s not in displaced))
        d = await resolve(resolver, s)
        assert d.owner == warm[s]
        if s in displaced:
            assert d.source == "persist" and not d.is_local
    return decisions


def test_affinity_decisions_equal_jax():
    port = run(_restart_scenario(SessionAffinity, LocalAffinityIndex))
    assert port == run(_restart_scenario(JaxSessionAffinity, JaxLocalAffinityIndex))
    assert {d[4] for d in port} == {"ring", "persist"}
    assert SessionAffinity.digest("sess-3") == JaxSessionAffinity.digest("sess-3")


def test_coordinator_index_read_across_packages():
    """Records under the same digest key: each package reads the holder the
    other noted, through one coordinator."""
    members = ["fe-port", "fe-jax", "fe-other"]
    ring = HashRing(members)
    # a session the ring gives to a third frontend, whose warm holder is
    # recorded elsewhere
    sess = next(k for k in (f"s{i}" for i in range(100)) if ring.lookup(k) == "fe-other")

    async def go():
        srv = await CoordinatorServer(port=0).start()
        c = await CoordinatorClient(srv.url).connect()
        jc = await JaxCoordinatorClient(srv.url).connect()
        try:
            port, jax_ = CoordAffinityIndex(c), JaxCoordAffinityIndex(jc)
            d1, d2 = SessionAffinity.digest(sess), SessionAffinity.digest("s2")
            await port.note(d1, "fe-port")
            await jax_.note(d2, "fe-jax")
            got = (await jax_.lookup(d1), await port.lookup(d2), await port.lookup(12345))
            d = await JaxSessionAffinity("fe-jax", members, persist_index=jax_).resolve(sess)
            pd = await SessionAffinity("fe-jax", members, persist_index=port).resolve(sess)
            return got, (d.owner, d.source, d.is_local), (pd.owner, pd.source, pd.is_local)
        finally:
            await c.close()
            await jc.close()
            await srv.stop()

    got, jax_decision, port_decision = run(go())
    assert got == ("fe-port", "fe-jax", None)
    # the recorded warm holder wins over the ring's cold answer, in both
    assert port_decision == jax_decision == ("fe-port", "persist", False)


def test_http_redirects_to_owner_and_labels_local(tmp_path):
    from dynamo_tpu_torch.llm.engines import EchoEngineCore, build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService, ModelManager
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "hello": 1, "world": 2}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(tmp_path / "tokenizer.json"))
    card = ModelDeploymentCard(name="m", tokenizer_path=str(tmp_path / "tokenizer.json"))
    fids = {"fe-a": "http://fe-a:1", "fe-b": "http://fe-b:2"}
    index = LocalAffinityIndex()
    affinity = SessionAffinity("fe-a", fids, persist_index=index, redirect=True)
    local = next(s for s in (f"s{i}" for i in range(100)) if affinity.ring.lookup(s) == "fe-a")
    remote = next(s for s in (f"s{i}" for i in range(100)) if affinity.ring.lookup(s) == "fe-b")

    async def go():
        manager = ModelManager()
        manager.add_model("m", build_serving_pipeline(EchoEngineCore(), card), card)
        svc = HttpService(manager, port=0, affinity=affinity)
        await svc.start()
        url = f"http://127.0.0.1:{svc.port}/v1/completions"
        body = {"model": "m", "prompt": "hello world", "max_tokens": 2}
        try:
            async with ClientSession() as s:
                r = await s.post(url, json=body, headers={"x-session-id": remote},
                                 allow_redirects=False)
                redirect = (r.status, r.headers.get("Location"),
                            r.headers.get("x-affinity-owner"), r.headers.get("x-affinity-source"))
                r = await s.post(url, json=dict(body, session_id=local))
                served = (r.status, r.headers.get("x-affinity-owner"),
                          r.headers.get("x-affinity-source"))
                r = await s.post(url, json=dict(body, stream=True),
                                 headers={"x-session-id": local})
                await r.read()
                streamed = (r.status, r.headers.get("x-affinity-owner"))
                r = await s.post(url, json=body)
                plain = (r.status, r.headers.get("x-affinity-owner"))
            return redirect, served, streamed, plain, await index.lookup(
                SessionAffinity.digest(local)), await index.lookup(SessionAffinity.digest(remote))
        finally:
            await svc.stop()

    redirect, served, streamed, plain, noted_local, noted_remote = run(go())
    assert redirect == (307, "http://fe-b:2", "fe-b", "ring")
    assert served == (200, "fe-a", "ring") and streamed == (200, "fe-a")
    assert plain == (200, None)
    assert noted_local == "fe-a" and noted_remote is None
