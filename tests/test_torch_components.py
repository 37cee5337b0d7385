"""The port's standalone components against the JAX package's.

* ``PrometheusMetricsCollector``: the same worker metrics and hit-rate
  events render the same text, byte for byte.
* ``MetricsService``: fed over one coordinator by mock workers of both
  packages and a KV router's hit-rate events, the port's and the JAX
  package's services serve the same ``/metrics`` body, which lists every
  worker's gauges as published.
* ``MockWorker``: the same worker id and seed publish the same events and
  metrics in both packages.
* ``ApiStore``: the same request sequence gets the same statuses and JSON
  bodies from both packages' stores (timestamps excluded; the manifests
  differ only by the renderer's translations, and the port's store refuses
  a ``tpu:`` spec that the JAX store accepts).
* The port's store serves both packages' clients: ``package
  push|pull|list`` and ``serve --package`` from both CLIs.
"""

import asyncio
import copy
import dataclasses
import json
import signal
import subprocess
import sys

import numpy as np
import pytest
from aiohttp import ClientSession

import dynamo_tpu.components.api_store as jax_api_store
import dynamo_tpu.components.metrics as jax_metrics
import dynamo_tpu.components.mock_worker as jax_mock
import dynamo_tpu.llm.kv_router.scheduler as jax_scheduler
import dynamo_tpu.runtime.transports.coordinator as jax_coord
import dynamo_tpu_torch.components.api_store as api_store
import dynamo_tpu_torch.components.metrics as metrics
import dynamo_tpu_torch.components.mock_worker as mock
import dynamo_tpu_torch.deploy.renderer as renderer
import dynamo_tpu_torch.llm.kv_router.scheduler as scheduler
import dynamo_tpu_torch.runtime.transports.coordinator as coord
from dynamo_tpu_torch import native
from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvRouterSubscriber
from dynamo_tpu_torch.llm.kv_router.router import KvRouter
from dynamo_tpu_torch.obs.metric_names import RouterMetric as RM
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_sdk import PKG, REPO, _child_env, _cli, _write_graph_tree


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _wait_for(cond, timeout=5.0):
    async def poll():
        while not cond():
            await asyncio.sleep(0.02)

    await asyncio.wait_for(poll(), timeout)


# ---------------------------------------------------------------- collector


def _collector_feed(coll_cls, metrics_cls, seed):
    rng = np.random.RandomState(seed)
    c = coll_cls()
    for _ in range(40):
        wid = int(rng.randint(1, 6))
        if rng.rand() < 0.6:
            c.on_worker_metrics(metrics_cls(
                worker_id=wid, request_active_slots=int(rng.randint(0, 9)),
                request_total_slots=8, kv_active_blocks=int(rng.randint(0, 400)),
                kv_total_blocks=int(rng.randint(1, 400)),
                num_requests_waiting=int(rng.randint(0, 5))))
        else:
            isl = int(rng.randint(0, 12))
            c.on_hit_rate_event(wid, isl_blocks=isl, overlap_blocks=int(rng.randint(0, isl + 1)))
    before = c.render()
    c.remove_worker(int(rng.randint(1, 6)))
    return before, c.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collector_render_byte_equal(seed):
    got = _collector_feed(metrics.PrometheusMetricsCollector, scheduler.WorkerMetrics, seed)
    assert got == _collector_feed(jax_metrics.PrometheusMetricsCollector,
                                  jax_scheduler.WorkerMetrics, seed)
    c = metrics.PrometheusMetricsCollector()
    c.on_worker_metrics(scheduler.WorkerMetrics(worker_id=3, kv_active_blocks=10,
                                                kv_total_blocks=40))
    c.on_hit_rate_event(3, isl_blocks=8, overlap_blocks=6)
    c.on_hit_rate_event(3, isl_blocks=8, overlap_blocks=2)
    out = c.render()
    assert f'{RM.KV_CACHE_USAGE}{{worker="3"}} 0.250000' in out
    assert f'{RM.ROUTING_DECISIONS_TOTAL}{{worker="3"}} 2' in out
    assert f'{RM.KV_HIT_RATE_PERCENT}{{worker="3"}} 50.000' in out


def test_mock_worker_streams_equal_jax():
    def stream(mod, wid, seed):
        w = mod.MockWorker(None, worker_id=wid, total_blocks=32, seed=seed)
        events = []
        w.events.sink = lambda ev: events.append((type(ev).__name__, ev.block_hashes))
        snaps = []
        for _ in range(30):
            w._tick()
            snaps.append(w._snapshot())
        return events, snaps

    for wid, seed in ((1, None), (7, 3)):
        got = stream(mock, wid, seed)
        assert got == stream(jax_mock, wid, seed)
        assert {k for k, _ in got[0]} == {"KvStoredEvent", "KvRemovedEvent"}


# ----------------------------------------------------------- metrics service


DECISIONS = 5


@pytest.fixture(scope="module")
def host_library():
    """The router's native index needs the host library: build (or load) it
    here, not on the event loop of the test that makes the router."""
    native.load()


def _metrics_bodies(hit_delay_s: float = 0.0):
    """Both packages' ``MetricsService`` fed over one coordinator by a port
    and a JAX mock worker and a port KV router's hit-rate events
    (``DECISIONS`` routing decisions); returns each service's ``/metrics``
    (status, body), the port collector's blocks per worker and each worker's
    last published metrics.  With ``hit_delay_s`` the port service takes its
    k-th hit-rate event k times that late."""
    async def go():
        srv = await coord.CoordinatorServer(port=0).start()
        conns = []

        async def conn(mod):
            c = await mod.CoordinatorClient(srv.url).connect()
            conns.append(c)
            return c

        try:
            port_svc = metrics.MetricsService(await conn(coord), namespace="t", port=0)
            if hit_delay_s:
                on_hit, late = port_svc._on_hit_rate, []

                def delayed(subject, payload):
                    late.append(payload)
                    asyncio.get_running_loop().call_later(hit_delay_s * len(late), on_hit,
                                                          subject, payload)

                port_svc._on_hit_rate = delayed
            port_svc = await port_svc.start()
            jax_svc = await jax_metrics.MetricsService(await conn(jax_coord), namespace="t",
                                                       port=0).start()
            router = KvRouter(block_size=16)
            sub = await KvRouterSubscriber(router, await conn(coord), namespace="t",
                                           hit_rate_flush_s=0.05).start()
            w1 = await mock.MockWorker(await conn(coord), worker_id=1, namespace="t",
                                       interval_s=0.05).start()
            w2 = await jax_mock.MockWorker(await conn(jax_coord), worker_id=2, namespace="t",
                                           interval_s=0.05).start()

            def decisions(svc):
                return sum(s.decisions for s in svc.collector.hits.values())

            try:
                await _wait_for(lambda: {1, 2} <= set(router.scheduler.workers()))
                await _wait_for(lambda: router.indexer.num_blocks > 0)
                for _ in range(DECISIONS):
                    router.schedule([1] * 32)
                # every decision's hit-rate event reached both collectors
                # before the subscriber that publishes them stops
                await _wait_for(lambda: decisions(port_svc) == decisions(jax_svc) == DECISIONS)
            finally:
                await w1.stop()
                await w2.stop()
                await sub.stop()
            # a worker's metrics publisher stops without a last publish, and
            # its engine may have ticked since the one before: each worker
            # publishes its final state once more, so what it last published
            # is what it holds
            for w in (w1, w2):
                await w.metrics.publish_once()
            # both workers' last metrics, as each published them: wait until
            # both collectors hold them, and hold the same for each worker,
            # and the same hit-rate counts, of all the decisions
            last = {1: w1.metrics.snapshot(), 2: w2.metrics.snapshot()}

            def published(m):  # what a worker sent, not when it arrived
                return {k: v for k, v in dataclasses.asdict(m).items() if k != "updated_at"}

            def hits(svc):
                return {w: dataclasses.astuple(s) for w, s in svc.collector.hits.items()}

            def settled():
                held = [svc.collector.workers for svc in (port_svc, jax_svc)]
                return all(
                    w in held[0] and w in held[1]
                    and published(held[0][w]) == published(held[1][w])
                    and (held[0][w].kv_active_blocks, held[0][w].kv_total_blocks)
                    == (m.kv_active_blocks, m.kv_total_blocks)
                    for w, m in last.items()
                ) and hits(port_svc) == hits(jax_svc) and decisions(port_svc) == DECISIONS

            await _wait_for(settled)
            bodies = []
            async with ClientSession() as s:
                for svc in (port_svc, jax_svc):
                    r = await s.get(f"http://127.0.0.1:{svc.port}/metrics")
                    bodies.append((r.status, await r.text()))
            seen = {w: (m.kv_active_blocks, m.kv_total_blocks)
                    for w, m in port_svc.collector.workers.items()}
            await port_svc.stop()
            await jax_svc.stop()
            return bodies, seen, last
        finally:
            for c in conns:
                await c.close()
            await srv.stop()

    return run(go())


def _check_bodies(port_body, jax_body, seen, last):
    assert port_body == jax_body and port_body[0] == 200
    text = port_body[1]
    for wid in (1, 2):
        assert f'{RM.KV_BLOCKS_ACTIVE}{{worker="{wid}"}} {seen[wid][0]}' in text
        assert f'{RM.KV_BLOCKS_TOTAL}{{worker="{wid}"}} {seen[wid][1]}' in text
    assert seen[1] == (last[1].kv_active_blocks, last[1].kv_total_blocks)
    assert RM.ROUTING_DECISIONS_TOTAL in text and RM.KV_HIT_RATE_PERCENT in text
    total = sum(int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith(RM.ROUTING_DECISIONS_TOTAL + "{"))
    assert total == DECISIONS


def test_metrics_service_fed_by_mock_workers_of_both_packages(host_library):
    (port_body, jax_body), seen, last = _metrics_bodies()
    _check_bodies(port_body, jax_body, seen, last)


def test_metrics_service_bodies_equal_with_late_hit_events(host_library):
    """One collector takes its hit-rate events late, one after another: the
    bodies are read only once both hold every decision's event, so they
    are still equal."""
    (port_body, jax_body), seen, last = _metrics_bodies(hit_delay_s=0.2)
    _check_bodies(port_body, jax_body, seen, last)


# ----------------------------------------------------------------- api-store


GRAPH_SPEC = {
    "name": "g1",
    "image": "dynamo-tpu:latest",
    "services": {"decode": {
        "command": ["dynamo-tpu", "run", "in=dyn://d.w.generate", "out=tpu"],
        "replicas": 2}},
}
TPU_SPEC = copy.deepcopy(GRAPH_SPEC)
TPU_SPEC["services"]["decode"]["tpu"] = {"type": "v5e", "topology": "2x2", "chips": 4}


def _strip(body):
    """A JSON body with its timestamps taken out."""
    if isinstance(body, list):
        return [_strip(b) for b in body]
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k != "created_at"}
    return body


def _port_manifests(objs):
    """The JAX store's manifests under the renderer's command translation."""
    objs = copy.deepcopy(objs)
    for o in objs:
        if o["kind"] == "Deployment":
            c = o["spec"]["template"]["spec"]["containers"][0]
            if c["name"] in ("coordinator", "frontend", "metrics"):
                c["command"] = renderer.CLI + c["command"][1:]
    return objs


def _store_session(mod, archive):
    async def go():
        store = await mod.ApiStore(db_path=":memory:", port=0).start()
        base = f"http://127.0.0.1:{store.port}/api/v1"
        out = []
        try:
            async with ClientSession() as s:
                async def call(method, path, **kw):
                    r = await getattr(s, method)(f"{base}{path}", **kw)
                    ctype = r.headers.get("Content-Type", "")
                    body = (_strip(await r.json()) if "json" in ctype
                            else (await r.read()) if "gzip" in ctype else None)
                    out.append((method, path, r.status, body,
                                r.headers.get("X-Package-Version")))

                await call("post", "/graphs", json={"name": "demo", "spec": GRAPH_SPEC})
                await call("post", "/graphs", json={"name": "demo", "spec": GRAPH_SPEC,
                                                    "labels": {"env": "prod"}})
                await call("post", "/graphs", json={"name": "demo2",
                                                    "spec": json.dumps(GRAPH_SPEC)})
                await call("get", "/graphs")
                await call("get", "/graphs/demo")
                await call("get", "/graphs/demo/2")
                await call("get", "/graphs/demo/1/manifests")
                await call("post", "/graphs", json={"name": "bad", "spec": {"nope": 1}})
                await call("post", "/graphs", json={"spec": GRAPH_SPEC})
                await call("delete", "/graphs/demo/1")
                await call("get", "/graphs/demo/1")
                await call("get", "/graphs/nope")
                await call("post", "/packages", data=archive)
                await call("post", "/packages", data=archive)
                await call("post", "/packages", data=b"not a tarball")
                await call("get", "/packages")
                await call("get", "/packages/hello")
                await call("get", "/packages/hello/latest")
                await call("get", "/packages/hello/x")
                await call("get", "/packages/hello/1/archive")
                await call("delete", "/packages/hello/latest")
                await call("delete", "/packages/hello/1")
                await call("get", "/packages/hello/1/archive")
                await call("post", "/graphs", json={"name": "tpu", "spec": TPU_SPEC})
        finally:
            await store.stop()
        return out

    return run(go())


def test_api_store_bodies_equal_jax(tmp_path):
    from dynamo_tpu_torch.deploy.packaging import build_package

    pkg = tmp_path / "hello.tgz"
    build_package(_write_graph_tree(tmp_path / "tree"), "graphs.hello:Frontend", "hello", pkg)
    archive = pkg.read_bytes()
    got, want = _store_session(api_store, archive), _store_session(jax_api_store, archive)
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        if g[1].endswith("/manifests"):
            w = w[:3] + (_port_manifests(w[3]),) + w[4:]
        assert g == w, g[:2]
    statuses = [g[2] for g in got]
    assert statuses == [201, 201, 201, 200, 200, 200, 200, 422, 400, 200, 404, 404,
                        201, 201, 422, 200, 200, 200, 400, 200, 400, 200, 404, 422]
    assert got[19][3] == archive and got[19][4] == "1"
    # the port's store renders for the GPU: a tpu: spec does not render
    assert want[-1][2] == 201 and "tpu: block" not in str(got[-1])


# ------------------------------------------------- CLIs against the store


async def _jax_cli(*args, timeout=60):
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu", *args, cwd=str(REPO), env=_child_env(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = await asyncio.wait_for(proc.communicate(), timeout)
    return proc.returncode, out.decode(), err.decode()


def test_package_clis_and_serve_package_against_the_port_store(tmp_path):
    """``package build|push|list|pull`` from the port's CLI and ``package
    push|list|pull`` from the JAX package's, all against the port's
    api-store, then the port's ``serve --package hello`` pulls, unpacks and
    serves the archive; SIGTERM stops it with exit 0."""
    src = _write_graph_tree(tmp_path / "tree")
    pkg = tmp_path / "hello.tgz"
    cache = tmp_path / "cache"

    async def go():
        store = await api_store.ApiStore(db_path=str(tmp_path / "graphs.db"), port=0).start()
        url = f"http://127.0.0.1:{store.port}"
        srv = await coord.CoordinatorServer(port=0).start()
        try:
            built = await _cli("package", "build", str(src), "--entry", "graphs.hello:Frontend",
                               "--name", "hello", "-o", str(pkg))
            pushed = await asyncio.gather(
                _cli("package", "push", str(pkg), "--api-store", url),
                _jax_cli("package", "push", str(pkg), "--api-store", url))
            listed = await asyncio.gather(_cli("package", "list", "--api-store", url),
                                          _jax_cli("package", "list", "--api-store", url))
            pulled = await asyncio.gather(
                _cli("package", "pull", "hello:1", "--api-store", url, "-o",
                     str(tmp_path / "port-pull")),
                _jax_cli("package", "pull", "hello:2", "--api-store", url, "-o",
                         str(tmp_path / "jax-pull")))
            serve = await asyncio.create_subprocess_exec(
                sys.executable, "-m", PKG, "serve", "--package", "hello", "--api-store", url,
                "--package-cache", str(cache), "--coordinator", srv.url, cwd=str(REPO),
                env=_child_env(REPO), stderr=subprocess.PIPE)
            try:
                rt = await DistributedRuntime.connect(
                    RuntimeConfig(coordinator_url=srv.url, lease_ttl_s=2.0))
                client = await rt.namespace("pkg").component("frontend").endpoint(
                    "generate").client()
                await client.wait_for_instances(1, timeout=30)
                words = [w async for w in client.generate(Context("a-b"))]
                await client.close()
                await rt.shutdown()
            finally:
                serve.send_signal(signal.SIGTERM)
                _, err = await asyncio.wait_for(serve.communicate(), 30)
        finally:
            await srv.stop()
            await store.stop()
        return built, pushed, listed, pulled, words, serve.returncode, err.decode()

    built, pushed, listed, pulled, words, rc, err = run(go())
    assert built[0] == 0, built[2][-2000:]
    assert all(p[0] == 0 for p in pushed + listed + pulled), [p[2][-800:] for p in pushed]
    assert sorted(json.loads(p[1])["version"] for p in pushed) == [1, 2]
    assert [json.loads(x[1])[0]["latest_version"] for x in listed] == [2, 2]
    assert json.loads(pulled[0][1]) == {"name": "hello", "entry": "graphs.hello:Frontend",
                                        "src": str(tmp_path / "port-pull" / "hello-1" / "src")}
    assert json.loads(pulled[1][1])["src"] == str(tmp_path / "jax-pull" / "hello-2" / "src")
    for d in ("port-pull/hello-1", "jax-pull/hello-2"):
        assert (tmp_path / d / "src" / "graphs" / "hello.py").read_text() \
            == (src / "graphs" / "hello.py").read_text()
    assert words == ["A!", "B!"]
    assert rc == 0, err[-3000:]
    assert 'worker exit codes {"Backend:0": 0, "Frontend:0": 0}' in err


def test_jax_serve_package_from_the_port_store(tmp_path):
    """The JAX package's ``package build|push`` and ``serve --package`` against
    the port's api-store: its supervisor pulls the JAX graph's archive from
    the port's store and serves it, and the port's runtime calls it."""
    from tests.test_api_store import _write_graph_tree as _jax_graph_tree

    src = _jax_graph_tree(tmp_path / "tree")
    pkg = tmp_path / "hello.tgz"

    async def go():
        store = await api_store.ApiStore(db_path=":memory:", port=0).start()
        url = f"http://127.0.0.1:{store.port}"
        srv = await coord.CoordinatorServer(port=0).start()
        try:
            built = await _jax_cli("package", "build", str(src), "--entry",
                                   "graphs.hello:Frontend", "--name", "hello", "-o", str(pkg))
            pushed = await _jax_cli("package", "push", str(pkg), "--api-store", url)
            serve = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "dynamo_tpu", "serve", "--package", "hello",
                "--api-store", url, "--package-cache", str(tmp_path / "cache"),
                "--coordinator", srv.url, cwd=str(REPO), env=_child_env(REPO),
                stderr=subprocess.PIPE)
            try:
                rt = await DistributedRuntime.connect(
                    RuntimeConfig(coordinator_url=srv.url, lease_ttl_s=2.0))
                client = await rt.namespace("pkg").component("frontend").endpoint(
                    "generate").client()
                await client.wait_for_instances(1, timeout=30)
                words = [w async for w in client.generate(Context("a-b"))]
                await client.close()
                await rt.shutdown()
            finally:
                # the JAX command has no SIGTERM handler; ctrl-c runs its
                # supervisor's stop, which ends the workers (and closes their
                # end of the pipe)
                serve.send_signal(signal.SIGINT)
                _, err = await asyncio.wait_for(serve.communicate(), 30)
        finally:
            await srv.stop()
            await store.stop()
        return built, pushed, words, serve.returncode, err.decode()

    built, pushed, words, rc, err = run(go())
    assert built[0] == 0 and pushed[0] == 0, (built[2][-1500:], pushed[2][-1500:])
    assert json.loads(pushed[1]) == {"name": "hello", "version": 1}
    assert words == ["A!", "B!"], err[-3000:]
    assert "serving package hello" in err
