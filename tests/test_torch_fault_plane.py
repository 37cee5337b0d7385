"""The port's fault plane against the JAX package's.

* The JAX package's fault-plane tests, on the port: mid-stream migration
  with the emitted tokens re-seeded, the per-request opt-out and the
  exhausted budget, connect retry, suspect-aware picks, the health
  monitor feeding a KV scheduler, graceful drain and its gauge, the fault
  families on ``/metrics``, and an HTTP stream that survives its worker's
  death; the injector's frame drop and sever, coordinator stall and
  seeded op choice; a short seeded soak.
* Each scenario that both packages run is run by both, on the same
  inputs, and the results are held equal.
* Across the packages: the port's MigratingClient over JAX workers, and
  the JAX one over port workers.
* A tiny f32 engine cut at its n-th item frame (``sever_after``) migrates
  to the other worker: the stream equals JAX's migrated stream and the
  unbroken stream, token for token, and the cut worker's engine ends
  holding no block.
"""

import asyncio
import json
import threading
import time
import types

import jax
import numpy as np
import pytest
from aiohttp import ClientSession

import dynamo_tpu.fault as jax_fault
import dynamo_tpu_torch.fault as port_fault
from dynamo_tpu.engine import AsyncLLMEngine as JaxAsyncLLMEngine
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.fault.counters import counters as jax_counters
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.runtime import serde as jax_serde
from dynamo_tpu.runtime.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxDistributedRuntime
from dynamo_tpu.runtime.engine import AsyncEngine as JaxAsyncEngine
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.transports.coordinator import CoordinatorServer as JaxCoordinatorServer
from dynamo_tpu.runtime.transports.tcp import EndpointTcpServer as JaxEndpointTcpServer
from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
from dynamo_tpu_torch.fault import FaultInjector, HealthMonitor, MigratingClient
from dynamo_tpu_torch.fault.counters import counters
from dynamo_tpu_torch.fault.injector import CRASH_OPS
from dynamo_tpu_torch.fault.migration import MigrationExhausted
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler, WorkerMetrics
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.obs.metric_names import FaultMetric as FM
from dynamo_tpu_torch.runtime import serde
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import Client, DistributedRuntime, Endpoint
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer
from dynamo_tpu_torch.runtime.transports.tcp import EndpointDisconnected, EndpointTcpServer

serde.register_llm_types()
jax_serde.register_llm_types()


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@pytest.fixture(autouse=True)
def _reset_fault_counters():
    counters.reset()
    jax_counters.reset()
    yield
    counters.reset()
    jax_counters.reset()


def _counting_engine(base):
    class CountingEngine(base):
        """Decode stand-in with real re-seed semantics: token i continues
        the prompt arithmetically (prompt[-1]+1, +2, ...), so a migrated
        request yields the right sequence only if the re-seeded prompt
        carries the tokens the dead worker already emitted."""

        def __init__(self, pkg, delay_s: float = 0.02):
            self.pkg = pkg
            self.delay_s = delay_s

        def generate(self, request):
            return self._run(request)

        async def _run(self, request):
            inp = request.data
            last = inp.token_ids[-1]
            n = inp.stops.max_tokens or 4
            for i in range(1, n + 1):
                if request.is_stopped:
                    yield self.pkg.LLMEngineOutput(finish_reason=self.pkg.FinishReason.CANCELLED)
                    return
                await asyncio.sleep(self.delay_s)
                yield self.pkg.LLMEngineOutput(
                    token_ids=[last + i],
                    finish_reason=self.pkg.FinishReason.LENGTH if i == n else None)

    return CountingEngine


# each package's fault plane, runtime and types, by name
SIDES = {
    "port": types.SimpleNamespace(
        fault=port_fault, counters=counters, runtime=DistributedRuntime, config=RuntimeConfig,
        coordinator=CoordinatorServer, tcp_server=EndpointTcpServer, ctx=Context,
        pkg=protocols, engine=_counting_engine(AsyncEngine)),
    "jax": types.SimpleNamespace(
        fault=jax_fault, counters=jax_counters, runtime=JaxDistributedRuntime,
        config=JaxRuntimeConfig, coordinator=JaxCoordinatorServer,
        tcp_server=JaxEndpointTcpServer, ctx=JaxContext, pkg=jax_protocols,
        engine=_counting_engine(JaxAsyncEngine)),
}


def _input(pkg, seed: int, max_tokens: int):
    return pkg.BackendInput(token_ids=[seed], stops=pkg.StopConditions(max_tokens=max_tokens))


def _busy_runtime(runtimes):
    """The runtime whose TCP server is currently serving a stream."""
    for rt in runtimes:
        srv = rt._tcp_server
        if srv is not None and any(n > 0 for n in srv._inflight.values()):
            return rt
    return None


async def _workers(side, url, n=2, engine=None, delay_s=0.02):
    """``n`` runtimes of ``side`` each serving a CountingEngine (or
    ``engine(i)``) at dyn://dyn.backend.generate."""
    out = []
    for i in range(n):
        rt = await side.runtime.connect(side.config(coordinator_url=url, lease_ttl_s=5.0))
        await rt.namespace("dyn").component("backend").endpoint("generate").serve(
            engine(i) if engine else side.engine(side.pkg, delay_s))
        out.append(rt)
    return out


async def _client(side, url, n=2):
    fe = await side.runtime.connect(side.config(coordinator_url=url, lease_ttl_s=5.0))
    client = await fe.namespace("dyn").component("backend").endpoint("generate").client()
    await client.wait_for_instances(n)
    return fe, client


async def _close(client, *runtimes):
    await client.close()
    for rt in runtimes:
        await rt.shutdown()


# ------------------------------------------------------------- migration ----


def _migrate_on_kill(side_name: str):
    """Kill the serving worker's request plane after the second token: the
    tokens seen, the request's annotations and the process counter."""
    side = SIDES[side_name]

    async def go():
        srv = await side.coordinator(port=0).start()
        injector = side.fault.FaultInjector()
        try:
            workers = await _workers(side, srv.url)
            fe, client = await _client(side, srv.url)
            mig = side.fault.MigratingClient(client, backoff_s=0.01)
            ctx = side.ctx(_input(side.pkg, 100, 8))
            got, killed = [], False
            async for out in mig.generate(ctx):
                got.extend(out.token_ids)
                if len(got) == 2 and not killed:
                    killed = True
                    await injector.kill_tcp_server(_busy_runtime(workers))
            await _close(client, *workers, fe)
            return got, dict(ctx.annotations), side.counters.migrations_total
        finally:
            await srv.stop()

    return run(go())


def test_migration_mid_stream_kill_completes_sequence_as_jax():
    """The stream migrates to the survivor with the emitted tokens
    re-seeded: the whole sequence, one hop, counted, as in JAX."""
    port = _migrate_on_kill("port")
    assert port == _migrate_on_kill("jax")
    got, ann, total = port
    assert got == list(range(101, 109))
    assert ann["migrations"] == 1 and total == 1


def test_migration_opt_out_and_exhaustion():
    """migration_limit=0 surfaces the disconnect instead of migrating; with
    every worker dead the budget exhausts with a typed error."""
    side = SIDES["port"]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        injector = FaultInjector()
        try:
            w1, w2 = await _workers(side, srv.url)
            fe, client = await _client(side, srv.url)
            ctx = Context(_input(protocols, 10, 8))
            ctx.annotations["migration_limit"] = 0
            with pytest.raises(ConnectionError):
                got = []
                async for out in MigratingClient(client, backoff_s=0.01).generate(ctx):
                    got.extend(out.token_ids)
                    if len(got) == 2:
                        await injector.kill_tcp_server(_busy_runtime([w1, w2]))
            assert counters.migrations_total == 0

            ctx2 = Context(_input(protocols, 10, 8))
            with pytest.raises(MigrationExhausted):
                got = []
                async for out in MigratingClient(client, migration_limit=2, connect_retries=1,
                                                 backoff_s=0.01).generate(ctx2):
                    got.extend(out.token_ids)
                    if len(got) == 1:
                        await injector.kill_tcp_server(w1)
                        await injector.kill_tcp_server(w2)
            await _close(client, w1, w2, fe)
        finally:
            await srv.stop()

    run(go())


def test_connect_retry_with_backoff():
    """A dial failure before any token burns connect retries with jittered
    backoff, not migration budget, and succeeds once the plane is back."""
    side = SIDES["port"]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        injector = FaultInjector()
        try:
            (w1,) = await _workers(side, srv.url, n=1, delay_s=0.0)
            port = w1._tcp_server.port
            fe, client = await _client(side, srv.url, n=1)
            await injector.kill_tcp_server(w1)  # the discovery key survives

            async def revive():
                await asyncio.sleep(0.15)
                # same port, fresh plane: a fast in-place restart
                w1._tcp_server = None
                srv2 = await EndpointTcpServer(port=port).start()
                srv2.register(w1.namespace("dyn").component("backend").endpoint(
                    "generate").subject(w1.instance_id), side.engine(protocols, 0.0))
                w1._tcp_server = srv2

            reviver = asyncio.ensure_future(revive())
            ctx = Context(_input(protocols, 5, 3))
            mig = MigratingClient(client, connect_retries=20, backoff_s=0.02)
            got = [t async for o in mig.generate(ctx) for t in o.token_ids]
            await reviver
            assert got == [6, 7, 8]
            assert ctx.annotations.get("migrations") is None  # no hop burned
            await _close(client, fe, w1)
        finally:
            await srv.stop()

    run(go())


def test_round_robin_starts_at_first_and_survives_churn():
    client = Client(Endpoint(DistributedRuntime(), "ns", "c", "e"))
    for iid in (1, 2, 3):
        client._add({"instance_id": iid, "host": "h", "port": 1, "subject": f"s{iid}"})
    assert [client.pick_round_robin() for _ in range(4)] == [1, 2, 3, 1]
    client._instances.pop(2)
    assert [client.pick_round_robin() for _ in range(3)] == [3, 1, 3]
    client._add({"instance_id": 2, "host": "h", "port": 1, "subject": "s2"})
    assert [client.pick_round_robin() for _ in range(3)] == [1, 2, 3]


@pytest.mark.parametrize("client_side", ["port", "jax"])
def test_migrating_client_over_the_other_package(client_side):
    """One package's MigratingClient over the other's workers, through the
    workers' coordinator: the whole sequence after a kill, one hop."""
    worker_side = "jax" if client_side == "port" else "port"
    ws, cs = SIDES[worker_side], SIDES[client_side]

    async def go():
        srv = await ws.coordinator(port=0).start()
        injector = ws.fault.FaultInjector()
        try:
            workers = await _workers(ws, srv.url)
            fe, client = await _client(cs, srv.url)
            ctx = cs.ctx(_input(cs.pkg, 40, 6))
            got, killed = [], False
            async for out in cs.fault.MigratingClient(client, backoff_s=0.01).generate(ctx):
                got.extend(out.token_ids)
                if len(got) == 3 and not killed:
                    killed = True
                    await injector.kill_tcp_server(_busy_runtime(workers))
            await _close(client, *workers, fe)
            return got, ctx.annotations.get("migrations"), cs.counters.migrations_total
        finally:
            await srv.stop()

    assert run(go()) == (list(range(41, 47)), 1, 1)


# ---------------------------------------------------------- health plane ----


def test_health_monitor_suspects_recovers_and_feeds_the_scheduler():
    """A worker whose request plane dies turns suspect within
    fail_threshold probes and stops being picked, by the client and by a
    KV scheduler fed through on_suspect/on_recover; a revived plane clears
    the suspicion; the gauge reads the live suspect set."""
    side = SIDES["port"]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        injector = FaultInjector()
        try:
            w1, w2 = await _workers(side, srv.url)
            fe, client = await _client(side, srv.url)
            sched = KvScheduler(block_size=16)
            for rt in (w1, w2):
                sched.update_worker(WorkerMetrics(worker_id=rt.instance_id, kv_active_blocks=0))
            mon = HealthMonitor(client, interval_s=0.05, timeout_s=0.3, fail_threshold=2,
                                on_suspect=sched.mark_suspect, on_recover=sched.clear_suspect)
            client.health = mon
            port = w1._tcp_server.port
            await mon.probe_once()
            assert mon.suspect_ids() == set()
            # w1 holds the whole prefix: normally an easy win
            assert sched.schedule({w1.instance_id: 4}, request_tokens=64) == w1.instance_id

            await injector.kill_tcp_server(w1)
            await mon.probe_once()
            assert mon.suspect_ids() == set()  # one failure is not enough
            await mon.probe_once()
            assert mon.suspect_ids() == {w1.instance_id}
            assert sched.suspects() == {w1.instance_id}
            assert sched.schedule({w1.instance_id: 4}, request_tokens=64) == w2.instance_id
            assert counters.suspect_instances() == 0  # not started: no source
            await mon.start()
            assert counters.suspect_instances() == 1
            for _ in range(20):
                assert client.pick_random() == w2.instance_id
                assert client.pick_round_robin() == w2.instance_id

            w1._tcp_server = None
            srv2 = await EndpointTcpServer(port=port).start()
            srv2.register(w1.namespace("dyn").component("backend").endpoint("generate").subject(
                w1.instance_id), side.engine(protocols))
            w1._tcp_server = srv2
            await mon.probe_once()
            assert mon.suspect_ids() == set() and sched.suspects() == set()
            await mon.stop()
            assert counters.suspect_instances() == 0
            await _close(client, w1, w2, fe)
        finally:
            await srv.stop()

    run(go())


def test_health_monitor_marks_within_threshold_times_interval():
    """Started, the monitor turns a killed worker suspect within
    fail_threshold x interval_s plus one probe timeout (and a second of
    scheduling slack), far inside the 5 s lease that discovery would wait
    out."""
    side = SIDES["port"]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        injector = FaultInjector()
        try:
            w1, w2 = await _workers(side, srv.url)
            fe, client = await _client(side, srv.url)
            mon = HealthMonitor(client, interval_s=0.1, timeout_s=0.2, fail_threshold=2)
            client.health = mon
            await mon.start()
            await asyncio.sleep(0.15)
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            await injector.kill_tcp_server(w2)
            while w2.instance_id not in mon.suspect_ids():
                assert loop.time() - t0 < 2.0
                await asyncio.sleep(0.01)
            seconds = loop.time() - t0
            await mon.stop()
            await _close(client, w1, w2, fe)
            return seconds
        finally:
            await srv.stop()

    assert run(go()) <= 2 * 0.1 + 0.2 + 1.0


# ------------------------------------------------------------------ drain ----


def test_endpoint_drain_finishes_inflight_then_deregisters():
    """Drain: the discovery key first, the live stream completes, then the
    subject deregisters; the drains-in-progress gauge is up meanwhile."""
    side = SIDES["port"]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        try:
            w1, w2 = await _workers(side, srv.url)
            fe, client = await _client(side, srv.url)
            ep1 = w1.namespace("dyn").component("backend").endpoint("generate")
            got = []

            async def consume():
                async for o in client.direct(Context(_input(protocols, 50, 10)), w1.instance_id):
                    got.extend(o.token_ids)

            stream = asyncio.ensure_future(consume())
            await asyncio.sleep(0.05)
            assert counters.drains_in_progress == 0
            drain = asyncio.ensure_future(ep1.drain(timeout=5.0))
            await asyncio.sleep(0.02)
            assert counters.drains_in_progress == 1
            assert await drain is True
            await stream
            assert got == list(range(51, 61))
            assert counters.drains_in_progress == 0
            await client._wait_until(lambda: client.instance_ids() == [w2.instance_id], 5.0)
            out = [t async for o in client.generate(Context(_input(protocols, 7, 2)))
                   for t in o.token_ids]
            assert out == [8, 9]
            assert await ep1.drain(timeout=0.1) is True
            assert w1._tcp_server.inflight(ep1.subject(w1.instance_id)) == 0
            await _close(client, w1, w2, fe)
        finally:
            await srv.stop()

    run(go())


def test_drain_role_flip_zero_failed_inflight():
    """Drain one worker under six live streams and bring up a replacement:
    no request fails or is truncated, and none needed a migration."""
    side = SIDES["port"]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        try:
            w1, w2 = await _workers(side, srv.url)
            fe, client = await _client(side, srv.url)
            mig = MigratingClient(client, backoff_s=0.01)

            async def one(seed):
                toks = [t async for o in mig.generate(Context(_input(protocols, seed, 10)))
                        for t in o.token_ids]
                assert toks == list(range(seed + 1, seed + 11)), toks
                return len(toks)

            inflight = [asyncio.ensure_future(one(100 * k)) for k in range(1, 7)]
            await asyncio.sleep(0.04)
            ep1 = w1.namespace("dyn").component("backend").endpoint("generate")
            assert await ep1.drain(timeout=10.0) is True
            await w1.shutdown()
            (w3,) = await _workers(side, srv.url, n=1)
            assert await asyncio.gather(*inflight) == [10] * 6
            assert counters.migrations_total == 0
            await _close(client, w2, w3, fe)
        finally:
            await srv.stop()

    run(go())


# ------------------------------------------------------------ metrics plane ----


def test_fault_counters_scrape():
    from dynamo_tpu_torch.llm.http import HttpService

    async def go():
        counters.migrations_total = 7
        counters.drains_in_progress = 2
        counters.register_suspect_source(lambda: {1, 2, 3})
        svc = HttpService(port=0)
        await svc.start()
        try:
            async with ClientSession() as s:
                text = await (await s.get(f"http://127.0.0.1:{svc.port}/metrics")).text()
        finally:
            await svc.stop()
        return text

    text = run(go())
    assert f"{FM.MIGRATIONS_TOTAL} 7" in text
    assert f"{FM.DRAINS_IN_PROGRESS} 2" in text
    assert f"{FM.SUSPECT_INSTANCES} 3" in text
    assert f"# TYPE {FM.MIGRATIONS_TOTAL} counter" in text
    assert f"# TYPE {FM.SUSPECT_INSTANCES} gauge" in text


# ----------------------------------------------------------------- injector ----


def test_injector_drop_and_sever_frames():
    from dynamo_tpu_torch.runtime.echo import EchoEngine
    from dynamo_tpu_torch.runtime.transports.tcp import EndpointTcpClient

    async def go():
        injector = FaultInjector()
        srv = await EndpointTcpServer().start()
        srv.register("s", EchoEngine())
        client = await EndpointTcpClient("127.0.0.1", srv.port, "s").connect()
        dropped = injector.drop_frames(srv, ftype="item", nth=2)
        assert [x async for x in client.generate(Context([1, 2, 3]))] == [1, 3]
        assert dropped() == 1
        injector.clear(srv)
        assert [x async for x in client.generate(Context([1, 2]))] == [1, 2]
        injector.sever_after(srv, 2)
        got = []
        with pytest.raises(EndpointDisconnected):
            async for x in client.generate(Context([1, 2, 3])):
                got.append(x)
        assert got == [1]
        injector.release_all()
        assert srv.fault_hook is None
        await srv.stop()
        await client.close()

    run(go())


def test_injector_stall_coordinator_until_release():
    async def go():
        srv = await CoordinatorServer(port=0).start()
        c = await CoordinatorClient(srv.url).connect()
        try:
            injector = FaultInjector()
            await c.kv_put("k", 1)
            release = injector.stall_coordinator(srv)
            pending = asyncio.ensure_future(c.kv_get("k"))
            await asyncio.sleep(0.1)
            assert not pending.done()
            release()
            assert await asyncio.wait_for(pending, 5) == 1
            injector.release_all()  # a released stall is not released twice
        finally:
            await c.close()
            await srv.stop()

    run(go())


def test_choose_op_seeded_as_jax():
    """The same seed picks the same ops as the JAX injector."""
    assert CRASH_OPS == jax_fault.injector.CRASH_OPS
    for seed in (0, 7, 0xfa17):
        a, b = FaultInjector(seed=seed), jax_fault.FaultInjector(seed=seed)
        for ops in (None, ("kill", "stall"), ("sever", "drop", "bogus")):
            assert [a.choose_op(ops) for _ in range(20)] == [b.choose_op(ops) for _ in range(20)]
    with pytest.raises(ValueError):
        FaultInjector().choose_op(("bogus",))


def test_short_seeded_soak():
    """A seeded storm of worker kills, in-place revivals and a coordinator
    stall under streaming traffic through the MigratingClient: every
    request completes with its exact sequence, and the plane migrated."""
    side = SIDES["port"]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        injector = FaultInjector(seed=0xfa17)
        rng = injector.rng
        workers = await _workers(side, srv.url, n=3, delay_s=0.02)
        fe, client = await _client(side, srv.url, n=3)
        mig = MigratingClient(client, migration_limit=8, connect_retries=8, backoff_s=0.02,
                              rng=__import__("random").Random(1))
        failures = []

        async def one(seed):
            try:
                toks = [t async for o in mig.generate(Context(_input(protocols, seed, 12)))
                        for t in o.token_ids]
            except Exception as e:  # noqa: BLE001 - recorded, asserted below
                failures.append((seed, repr(e)))
                return
            if toks != list(range(seed + 1, seed + 13)):
                failures.append((seed, toks))

        async def chaos():
            for _ in range(4):
                await asyncio.sleep(0.06)
                victim = workers[rng.randrange(len(workers))]
                if victim._tcp_server is None:
                    continue
                port = victim._tcp_server.port
                subject = victim.namespace("dyn").component("backend").endpoint(
                    "generate").subject(victim.instance_id)
                await injector.kill_tcp_server(victim)
                victim._tcp_server = None
                if injector.choose_op(("kill", "stall")) == "stall":
                    release = injector.stall_coordinator(srv)
                    await asyncio.sleep(0.1)
                    release()
                await asyncio.sleep(0.03)
                revived = await EndpointTcpServer(port=port).start()
                revived.register(subject, side.engine(protocols, 0.02))
                victim._tcp_server = revived

        try:
            await asyncio.gather(chaos(), *(one(1000 * k) for k in range(1, 17)))
            assert failures == [], failures[:5]
            assert counters.migrations_total > 0
        finally:
            injector.release_all()
            await _close(client, fe, *workers)
            await srv.stop()

    run(go())


# ------------------------------------------------------------ acceptance ----


WORDS = [f"w{i}" for i in range(40)]


@pytest.fixture(scope="module")
def tokenizer_file(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for w in WORDS:
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return str(path)


def test_http_completion_survives_worker_kill(tokenizer_file):
    """An HTTP streaming completion whose worker dies mid-generation ends
    with the whole sequence and the ``x-migrated 1`` comment; a unary
    answer carries the ``x-migrated`` header; with ``x-migration-limit: 0``
    the same kill ends the stream in an error and nothing migrates."""
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService, ModelManager
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    side = SIDES["port"]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        injector = FaultInjector()
        workers = await _workers(side, srv.url)
        fe, client = await _client(side, srv.url)
        card = ModelDeploymentCard(name="tiny", tokenizer_path=tokenizer_file, context_length=64)
        manager = ModelManager()
        manager.add_model("tiny", build_serving_pipeline(
            MigratingClient(client, backoff_s=0.01), card), card)
        http = HttpService(manager, port=0)
        await http.start()
        url = f"http://127.0.0.1:{http.port}/v1/completions"
        body = {"model": "tiny", "prompt": "w5", "max_tokens": 8, "temperature": 0}

        async def streamed(s, headers=None):
            r = await s.post(url, json=dict(body, stream=True), headers=headers)
            assert r.status == 200
            texts, comments, finishes, killed = [], [], [], False
            async for raw in r.content:
                line = raw.decode().strip()
                if line.startswith(": "):
                    comments.append(line)
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                choice = json.loads(line[6:])["choices"][0]
                texts.append(choice["text"])
                finishes.append(choice["finish_reason"])
                if len(texts) == 2 and not killed:
                    killed = True
                    victim = _busy_runtime(workers)
                    port = victim._tcp_server.port
                    await injector.kill_tcp_server(victim)
                    # revive in place so the next request has two workers
                    victim._tcp_server = await EndpointTcpServer(port=port).start()
                    victim._tcp_server.register(victim.namespace("dyn").component(
                        "backend").endpoint("generate").subject(victim.instance_id),
                        side.engine(protocols))
            return "".join(texts).split(), comments, finishes

        try:
            async with ClientSession() as s:
                words, comments, _ = await streamed(s)
                # "w5" is id 8 (3 specials + 5); the engine continues 9..16
                assert words == [f"w{i}" for i in range(6, 14)]
                assert any("x-migrated 1" in c for c in comments)
                assert counters.migrations_total == 1

                words, comments, finishes = await streamed(s, {"x-migration-limit": "0"})
                assert len(words) < 8 and finishes[-1] == "error"
                assert not comments and counters.migrations_total == 1

                r = await s.post(url, json=body)
                assert r.status == 200 and "x-migrated" not in r.headers
        finally:
            await http.stop()
            await _close(client, *workers, fe)
            await srv.stop()

    run(go())


# ---------------------------------------------- a real engine, cut mid-stream ----


BASE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64,
            prefill_buckets=[16, 32, 64, 128])
PROMPT = [5, 17, 33, 2, 90, 41, 7, 11, 64, 3]
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def tiny_models():
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    model = LlamaModel.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                                       device="cpu"))
    return model, jmodel, jparams


def _greedy(pkg):
    return pkg.BackendInput(token_ids=list(PROMPT), sampling=pkg.SamplingOptions(temperature=0),
                            stops=pkg.StopConditions(max_tokens=MAX_TOKENS, ignore_eos=True))


@pytest.mark.parametrize("n_items", [2, 6])
def test_engine_stream_cut_at_nth_item_migrates_as_jax(tiny_models, n_items):
    """Two workers, each its own engine on one tiny f32 model; the first
    worker's transport is cut as its ``n_items``-th item frame goes out.
    The migrated stream equals JAX's migrated stream and the unbroken
    stream; the survivor re-prefilled prompt + emitted tokens; the cut
    worker's engine stopped early: its request ends cancelled at most one
    token past the cut (the engine is held there until an abort reaches
    its core, at most HOLD_S), and it holds no block."""
    model, jmodel, jparams = tiny_models

    def engines(name):
        if name == "port":
            return [AsyncLLMEngine(EngineCore(model, EngineConfig(**BASE), eos_token_ids=[],
                                              device="cpu")).start() for _ in range(2)]
        return [JaxAsyncLLMEngine(JaxEngineCore(jmodel, jparams, JaxEngineConfig(**BASE),
                                                eos_token_ids=[])).start() for _ in range(2)]

    def migrated(name):
        side = SIDES[name]
        engs = engines(name)

        async def go():
            srv = await side.coordinator(port=0).start()
            try:
                workers = await _workers(side, srv.url, engine=lambda i: engs[i])
                fe, client = await _client(side, srv.url)
                first = min(client.instance_ids())
                cut = next(w for w in workers if w.instance_id == first)
                if name == "port":
                    _hold_past_cut(engs[workers.index(cut)].core, n_items, cut_reqs)
                side.fault.FaultInjector().sever_after(cut, n_items)
                # the first pick is the cut worker, then whoever is left
                mig = side.fault.MigratingClient(
                    client, backoff_s=0.01, pick=lambda exclude: min(
                        set(client.instance_ids()) - exclude))
                ctx = side.ctx(_greedy(side.pkg))
                toks = [t async for o in mig.generate(ctx) for t in o.token_ids]
                await _close(client, *workers, fe)
                return toks, ctx.annotations.get("migrations"), workers.index(cut)
            finally:
                await srv.stop()

        cut_reqs: list = []
        try:
            toks, hops, cut_idx = run(go())
            held = prefills = None
            if name == "port":
                cut_core, survivor = engs[cut_idx].core, engs[1 - cut_idx].core
                # step boundaries until the cut request has finished
                deadline = time.monotonic() + 2 * HOLD_S
                run(engs[cut_idx].run_on_engine(lambda: None))
                while (any(r.finish_reason is None for r in cut_reqs)
                       and time.monotonic() < deadline):
                    run(engs[cut_idx].run_on_engine(lambda: None))
                held = cut_core.block_manager.active_blocks
                pc = survivor.prefill_counters
                prefills = (pc.dispatches_total, pc.tokens_total)
                assert [r.finish_reason for r in cut_reqs] == [protocols.FinishReason.CANCELLED]
                assert n_items <= cut_reqs[0].generated <= n_items + 1
            return toks, hops, held, prefills
        finally:
            for e in engs:
                e.shutdown()

    unbroken = run(_direct(engines("jax")))
    port_toks, port_hops, held, prefills = migrated("port")
    jax_toks, jax_hops, _, _ = migrated("jax")
    assert port_toks == jax_toks == unbroken
    assert len(port_toks) == MAX_TOKENS and port_hops == jax_hops == 1
    assert held == 0
    # the survivor's one prefill: the prompt and the tokens the cut worker
    # delivered (n_items - 1 items of one token each)
    assert prefills == (1, len(PROMPT) + n_items - 1)


class _StubCore:
    """Takes a request and emits ``outs`` at once, setting no
    ``finish_reason`` (the engine thread sets it just after emitting the
    final output); records aborts."""

    def __init__(self, outs):
        self.outs, self.aborts = outs, []

    def submit(self, req):
        for out in self.outs:
            req.emit(out)

    def abort(self, request_id):
        self.aborts.append(request_id)


@pytest.mark.parametrize("case", ["finished", "killed"])
def test_async_engine_aborts_only_an_unfinished_stream(case):
    """The engine generator aborts its request in the core when the stream
    ends unfinished, a killed context included (a TCP server that lost its
    peer kills the context, then cancels the task), and not after it has
    yielded the final output (an abort landing after the finish would
    cancel the next request of that id)."""
    tok = protocols.LLMEngineOutput(token_ids=[7])
    fin = protocols.LLMEngineOutput(token_ids=[8], finish_reason=protocols.FinishReason.LENGTH)
    core = _StubCore([tok, fin] if case == "finished" else [tok])
    engine = AsyncLLMEngine(core)
    ctx = Context(_greedy(protocols), id="r1")

    async def go():
        got = []

        async def consume():
            async for out in engine.generate(ctx):
                got.append(out.token_ids)

        task = asyncio.ensure_future(consume())
        if case == "finished":
            await task
            return got
        while not got:
            await asyncio.sleep(0)
        ctx.kill()
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return got

    got = run(go())
    assert got == ([[7], [8]] if case == "finished" else [[7]])
    assert core.aborts == ([] if case == "finished" else ["r1"])


HOLD_S = 5.0


def _hold_past_cut(core, n_items, reqs):
    """Hold ``core``'s engine thread as it emits token ``n_items + 1`` (one
    past the frame that is cut) until ``core.abort`` is called, at most
    HOLD_S; the submitted requests are appended to ``reqs``.  An engine
    whose stream is cut but never aborted runs on to max_tokens after the
    hold."""
    aborted = threading.Event()
    real_abort, real_submit = core.abort, core.submit

    def abort(request_id):
        real_abort(request_id)
        aborted.set()

    def submit(req):
        emit, sent = req.emit, [0]

        def held_emit(out):
            sent[0] += len(out.token_ids)
            if sent[0] == n_items + 1:
                aborted.wait(HOLD_S)
            emit(out)

        req.emit = held_emit
        reqs.append(req)
        real_submit(req)

    core.abort, core.submit = abort, submit


async def _direct(engs):
    try:
        return [t async for o in engs[0].generate(JaxContext(_greedy(jax_protocols)))
                for t in o.token_ids]
    finally:
        for e in engs:
            e.shutdown()
