"""The port's planner policy, loop and actuators against the JAX package's.

* The pure policy: the JAX tests' scripted trace (a prefill surge, then a
  decode-heavy phase that flips a prefill worker to decode) and its
  stale-metrics hold, plus seeded ``MetricsSnapshot`` sequences; every
  ``Plan`` and ``PolicyState`` equal to JAX's, the role-flip machine
  included.
* The live loop: registrations, a prefill queue and published
  ForwardPassMetrics on a real coordinator give both packages' loops the
  same snapshots and plans, and ``LogActuator`` and ``PrewarmActuator``
  receive them.
* ``SupervisorActuator`` over the port's ``ServeSupervisor`` with fake
  worker processes realises a flip as one pool down and the other up.
"""

import asyncio
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

import dynamo_tpu.llm.kv.persist as jax_persist
import dynamo_tpu.llm.kv_router.publisher as jax_publisher
import dynamo_tpu.planner as jax_planner
import dynamo_tpu.runtime.transports.coordinator as jax_coord
import dynamo_tpu_torch.llm.kv.persist as persist
import dynamo_tpu_torch.llm.kv_router.publisher as publisher
import dynamo_tpu_torch.planner as planner
import dynamo_tpu_torch.runtime.transports.coordinator as coord

JAX = SimpleNamespace(pl=jax_planner, pub=jax_publisher, coord=jax_coord, persist=jax_persist)
PORT = SimpleNamespace(pl=planner, pub=publisher, coord=coord, persist=persist)


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _plain(x):
    return dataclasses.asdict(x)


def _s(p, usage, wid=0):
    """A worker sample with slot usage ``usage`` (KV idle)."""
    return p.pl.WorkerSample(worker_id=wid, request_active_slots=int(usage * 10),
                             request_total_slots=10)


def _sim_cfg(p):
    return p.pl.PlannerConfig(
        prefill_min=1, prefill_max=4, decode_min=1, decode_max=6,
        queue_target_per_replica=4, decode_target_usage=0.5,
        flip_high=0.85, flip_low=0.25, flip_patience=2, flip_cooldown=3,
        decode_heavy_osl_ratio=2.0)


def _trace(p):
    """The JAX tests' scripted load trace and its expected plans."""
    pl, s = p.pl, lambda u, w=0: _s(p, u, w)
    snap, pool = pl.MetricsSnapshot, pl.PoolSnapshot
    return [
        (snap(tick=0, prefill=pool(replicas=1, registered=1, samples=(s(0.9),), queue_depth=12),
              decode=pool(replicas=2, registered=2, samples=(s(0.5, 1), s(0.5, 2))),
              isl_mean=2000.0, osl_mean=100.0), (3, 2, None, 0.5)),
        (snap(tick=1, prefill=pool(replicas=3, registered=3,
                                   samples=(s(0.7), s(0.7, 1), s(0.7, 2)), queue_depth=10),
              decode=pool(replicas=2, registered=2, samples=(s(0.5, 1), s(0.5, 2))),
              isl_mean=2000.0, osl_mean=100.0), (3, 2, None, 0.5)),
        (snap(tick=2, prefill=pool(replicas=3, registered=3,
                                   samples=(s(0.1), s(0.1, 1), s(0.1, 2)), queue_depth=0),
              decode=pool(replicas=2, registered=2, samples=(s(0.9, 1), s(0.9, 2))),
              isl_mean=1000.0, osl_mean=3000.0), (2, 4, None, 0.9)),
        (snap(tick=3, prefill=pool(replicas=2, registered=2, samples=(s(0.1), s(0.1, 1)),
                                   queue_depth=0),
              decode=pool(replicas=4, registered=4, samples=tuple(s(0.9, i) for i in range(4))),
              isl_mean=1000.0, osl_mean=3000.0), (1, 6, "prefill_to_decode", 0.9)),
        (snap(tick=4, prefill=pool(replicas=1, registered=1, samples=(s(0.1),), queue_depth=0),
              decode=pool(replicas=6, registered=6, samples=tuple(s(0.5, i) for i in range(6))),
              isl_mean=1000.0, osl_mean=3000.0), (1, 6, None, 0.5)),
        (snap(tick=5, prefill=pool(replicas=1, registered=1, samples=(s(0.1),), queue_depth=0),
              decode=pool(replicas=6, registered=6, samples=tuple(s(0.9, i) for i in range(6))),
              isl_mean=1000.0, osl_mean=3000.0), (1, 6, None, 0.9)),
    ]


def _run_trace(p, cfg, trace):
    state, out = p.pl.PolicyState(), []
    for snap in trace:
        state, decided = p.pl.plan(cfg, state, snap)
        out.append((_plain(decided), _plain(state)))
    return out


def test_policy_simulation_trace_equal_jax():
    got = _run_trace(PORT, _sim_cfg(PORT), [t[0] for t in _trace(PORT)])
    assert got == _run_trace(JAX, _sim_cfg(JAX), [t[0] for t in _trace(JAX)])
    for (decided, _), (_, (pf, dc, flip, usage)) in zip(got, _trace(PORT)):
        assert (decided["prefill_replicas"], decided["decode_replicas"], decided["flip"]) \
            == (pf, dc, flip), decided["reason"]
        assert abs(decided["decode_usage"] - usage) < 1e-9
    assert got[-1][1]["cooldown"] == 1


def test_policy_stale_metrics_hold_equal_jax():
    def go(p):
        t = p.pl.decode_replica_target
        out = [t(current=6, registered=6, usages=[0.1, 0.1], target_usage=0.5, lo=1, hi=8),
               t(current=6, registered=6, usages=[], target_usage=0.5, lo=1, hi=4),
               t(current=6, registered=6, usages=[0.1] * 6, target_usage=0.5, lo=1, hi=8)]
        state, decided = p.pl.plan(_sim_cfg(p), p.pl.PolicyState(), p.pl.MetricsSnapshot(
            tick=6,
            prefill=p.pl.PoolSnapshot(replicas=1, registered=1, samples=(_s(p, 0.1),)),
            decode=p.pl.PoolSnapshot(replicas=6, registered=6,
                                     samples=tuple(_s(p, 0.9, i) for i in range(3)))))
        return out, _plain(decided), _plain(state)

    got = go(PORT)
    assert got == go(JAX)
    (hold, shrunk, full), decided, _ = got
    assert hold == (6, None) and shrunk == (4, None) and full[0] == 2
    assert (decided["prefill_replicas"], decided["decode_replicas"], decided["decode_usage"]) \
        == (1, 6, None)


def _seeded_snapshots(p, seed, ticks):
    """A random walk of pools, queue depths, usages (some workers silent) and
    traffic mixes, drawn with numpy from ``seed``, in four phases: mixed
    load, a prefill surge, a hot decode pool under a decode-heavy mix, and
    a deep prefill queue over an idle decode pool."""
    rng = np.random.RandomState(seed)
    pf_rep, dc_rep, snaps = 2, 2, []
    for tick in range(ticks):
        phase = (tick // 6) % 4

        def samples(n, mode):
            k = n - int(rng.rand() < 0.15)  # now and then a silent worker
            hi_slots, hi_kv = {"hot": (8, 100), "cool": (2, 25)}.get(mode, (8, 100))
            return tuple(p.pl.WorkerSample(
                worker_id=i,
                request_active_slots=8 if mode == "hot" else int(rng.randint(0, hi_slots + 1)),
                request_total_slots=8, kv_active_blocks=int(rng.randint(0, hi_kv)),
                kv_total_blocks=100, num_requests_waiting=int(rng.randint(0, 4)))
                for i in range(max(k, 0)))
        pf_reg, dc_reg = int(rng.randint(1, 5)), int(rng.randint(1, 7))
        depth = int(rng.randint(0, 30)) if phase in (0, 1) else (
            int(rng.randint(10, 40)) if phase == 3 else 0)
        snaps.append(p.pl.MetricsSnapshot(
            tick=tick,
            prefill=p.pl.PoolSnapshot(replicas=pf_rep, registered=pf_reg,
                                      samples=samples(pf_reg, "mixed") if phase != 2 else (),
                                      queue_depth=depth),
            decode=p.pl.PoolSnapshot(replicas=dc_rep, registered=dc_reg,
                                     samples=samples(dc_reg, {2: "hot", 3: "cool"}.get(
                                         phase, "mixed"))),
            isl_mean=float(rng.randint(100, 4000)),
            osl_mean=float(rng.randint(100, 4000)) * (3 if phase == 2 else 1)))
        pf_rep, dc_rep = int(rng.randint(1, 5)), int(rng.randint(1, 7))
    return snaps


def _cfg(p, patience, cooldown):
    return p.pl.PlannerConfig(prefill_min=1, prefill_max=5, decode_min=1, decode_max=7,
                              queue_target_per_replica=3, decode_target_usage=0.6,
                              flip_high=0.8, flip_low=0.3, flip_patience=patience,
                              flip_cooldown=cooldown, decode_heavy_osl_ratio=1.5)


@pytest.mark.parametrize("seed,patience,cooldown", [(0, 1, 2), (1, 2, 3), (2, 1, 0), (3, 3, 5)])
def test_seeded_snapshot_sequences_equal_jax(seed, patience, cooldown):
    got = _run_trace(PORT, _cfg(PORT, patience, cooldown), _seeded_snapshots(PORT, seed, 72))
    want = _run_trace(JAX, _cfg(JAX, patience, cooldown), _seeded_snapshots(JAX, seed, 72))
    assert got == want
    # the walk reaches the role-flip machine, holds and both scale directions
    flips = {d["flip"] for d, _ in got} - {None}
    assert flips == {"prefill_to_decode", "decode_to_prefill"}
    assert any(d["decode_usage"] is None for d, _ in got)
    # the stateful wrapper threads the same states
    pol = planner.PlannerPolicy(_cfg(PORT, patience, cooldown))
    assert [_plain(pol.plan(sn)) for sn in _seeded_snapshots(PORT, seed, 72)] \
        == [d for d, _ in got]
    pol.reset()
    assert pol.state == planner.PolicyState()


def test_levelling_functions_equal_jax():
    rng = np.random.RandomState(9)
    for _ in range(300):
        cur, want = int(rng.randint(0, 10)), int(rng.randint(0, 10))
        depth, per, lo = int(rng.randint(0, 50)), int(rng.randint(0, 6)), int(rng.randint(0, 3))
        hi = lo + int(rng.randint(0, 8))
        assert planner.step_replicas(cur, want) == jax_planner.step_replicas(cur, want)
        assert planner.prefill_replica_target(depth, cur, per, lo, hi) \
            == jax_planner.prefill_replica_target(depth, cur, per, lo, hi)
        usages = [float(u) for u in rng.rand(int(rng.randint(0, 5)))]
        reg, target = int(rng.randint(0, 5)), float(rng.rand())
        assert planner.decode_replica_target(cur, reg, usages, target, lo, hi) \
            == jax_planner.decode_replica_target(cur, reg, usages, target, lo, hi)
    assert sorted(planner.__all__) == sorted(jax_planner.__all__)
    assert planner.PrewarmActuator is persist.PrewarmActuator


# --------------------------------------------------------------- live loop


def _register(worker, ns, component, lease):
    return worker.kv_put(f"{ns}/components/{component}/endpoints/generate/{lease:x}",
                         {"instance_id": lease}, lease_id=lease)


def _live_loop(p):
    """The JAX tests' live-loop case: one tick over registrations, a queue
    and a published ForwardPassMetrics, then a second with fresher load."""
    async def go():
        srv = await PORT.coord.CoordinatorServer(port=0).start()
        c = await p.coord.CoordinatorClient(srv.url).connect()
        worker = await p.coord.CoordinatorClient(srv.url).connect()
        try:
            pf = await worker.lease_create(ttl=30.0)
            dc = await worker.lease_create(ttl=30.0)
            dc2 = await worker.lease_create(ttl=30.0)
            await _register(worker, "t", "prefill", pf)
            for lease in (dc, dc2):
                await _register(worker, "t", "decode", lease)
            for _ in range(9):
                await worker.queue_push("t_prefill_queue", {"req": 1})
            log_act = p.pl.LogActuator()
            prewarm = p.pl.PrewarmActuator(c, "t")
            loop = await p.pl.PlannerLoop(
                c, namespace="t",
                config=p.pl.PlannerConfig(prefill_max=4, decode_max=4,
                                          queue_target_per_replica=4, decode_target_usage=0.5),
                actuators=(log_act, prewarm)).attach()
            await worker.publish(p.pub.metrics_subject("t", dc), {
                "worker_id": dc, "request_active_slots": 9, "request_total_slots": 10,
                "kv_active_blocks": 0, "kv_total_blocks": 1, "num_requests_waiting": 3})
            await asyncio.sleep(0.05)
            first = await loop.tick_once()  # one of two decode workers reports: hold
            await worker.publish(p.pub.metrics_subject("t", dc2), {
                "worker_id": dc2, "request_active_slots": 7, "request_total_slots": 10,
                "kv_active_blocks": 30, "kv_total_blocks": 40, "num_requests_waiting": 0})
            await asyncio.sleep(0.05)
            snap = await loop.snapshot()
            second = await loop.tick_once()
            hint = await worker.kv_get(p.persist.prewarm_key("t"))
            await loop.stop()
            # lease ids are the coordinator's own: name the workers by role
            snap = _plain(snap)
            names = {pf: "pf", dc: "dc", dc2: "dc2"}
            for sample in snap["decode"]["samples"]:
                sample["worker_id"] = names[sample["worker_id"]]
            return ([_plain(x) for x in log_act.plans], [_plain(first), _plain(second)],
                    snap, hint, loop.tick, prewarm.epoch)
        finally:
            await worker.close()
            await c.close()
            await srv.stop()

    return run(go())


def test_planner_loop_plans_from_live_plane_equal_jax():
    got = _live_loop(PORT)
    assert got == _live_loop(JAX)
    logged, (first, second), snap, hint, ticks, epoch = got
    assert logged == [first, second] and ticks == 2
    # queue 9 / 4 a replica -> 3 prefill; decode held (1 of 2 reporting)
    assert (first["prefill_replicas"], first["decode_replicas"]) == (3, 2)
    assert first["prefill_queue_depth"] == 9 and first["decode_usage"] is None
    # both report: usage mean(0.9, 0.75) = 0.825 -> ceil(2 * 0.825 / 0.5) = 4
    assert snap["prefill"]["replicas"] == 3
    assert [x["worker_id"] for x in snap["decode"]["samples"]] == ["dc", "dc2"]
    assert second["decode_replicas"] == 4 and abs(second["decode_usage"] - 0.825) < 1e-9
    # the scale-up after the first plan published the pre-warm hint
    assert epoch == 1 and hint["decode_replicas"] == 4 and hint["tick"] == 1


# ----------------------------------------------------- supervisor actuation


class _FakeProc:
    def __init__(self):
        self.terminated = False

    def terminate(self):
        self.terminated = True

    def wait(self, timeout=None):
        return 0

    def poll(self):
        return 0 if self.terminated else None


def test_supervisor_scale_and_actuator(monkeypatch):
    """The JAX tests' fake-process case on the port's supervisor: scale()
    spawns missing indices and stops extras highest-first, and the actuator
    realises a flip as one pool down and the other up, the shrinking pool
    first."""
    from dynamo_tpu_torch.sdk.serving import ServeSupervisor

    class _Svc:
        def __init__(self, name):
            self.name, self.workers, self.resources = name, 1, {}

    class _Entry:
        def closure(self, graph=None):
            return [_Svc("prefill"), _Svc("decode")]

    sup = ServeSupervisor("mod:Entry")
    monkeypatch.setattr(sup, "_load_entry", lambda: _Entry())
    events = []

    def fake_spawn(svc, idx, env_extra):
        key = f"{svc.name}:{idx}"
        events.append(("up", key))
        sup._envs[key] = dict(env_extra)
        sup.procs[key] = _FakeProc()

    orig_stop = sup._stop_worker

    async def stop_worker(key):
        events.append(("down", key))
        await orig_stop(key)

    monkeypatch.setattr(sup, "_spawn", fake_spawn)
    monkeypatch.setattr(sup, "_stop_worker", stop_worker)

    async def go():
        assert await sup.scale("prefill", 2) == 2
        assert await sup.scale("decode", 2) == 2
        act = planner.SupervisorActuator(sup, "prefill", "decode")
        await act.apply(planner.Plan(tick=1, prefill_replicas=1, decode_replicas=3,
                                     flip="prefill_to_decode"))
        flip = events[4:]
        await act.apply(planner.Plan(tick=2, prefill_replicas=2, decode_replicas=2,
                                     flip="decode_to_prefill"))
        return flip, events[4 + len(flip):]

    p2d, d2p = run(go())
    assert events[:4] == [("up", "prefill:0"), ("up", "prefill:1"), ("up", "decode:0"),
                          ("up", "decode:1")]
    assert p2d == [("down", "prefill:1"), ("up", "decode:2")]
    # the other flip scales decode (now shrinking) first: the actuator's order
    assert d2p == [("down", "decode:2"), ("up", "prefill:1")]
    assert sorted(sup.procs) == ["decode:0", "decode:1", "prefill:0", "prefill:1"]


def test_disagg_planner_config_equal_jax():
    """The port's ``disagg_planner.yaml`` in both packages' SDK configs: the
    same services (GpuWorker for TpuWorker, gpu for tpu resources) and the
    same admission block, which both packages' admission configs parse
    alike."""
    from pathlib import Path

    import dynamo_tpu.sdk as jsdk
    import dynamo_tpu_torch
    import dynamo_tpu_torch.sdk as tsdk
    from dynamo_tpu.planner import AdmissionConfig as JaxAdmissionConfig
    from dynamo_tpu_torch.planner import AdmissionConfig

    repo = Path(dynamo_tpu_torch.__file__).resolve().parent.parent
    port_cfg = Path(dynamo_tpu_torch.__file__).parent / "examples/llm/configs/disagg_planner.yaml"
    jax_cfg = repo / "examples/llm/configs/disagg_planner.yaml"
    port, port_in_jax = tsdk.ServiceConfig.from_yaml(port_cfg), jsdk.ServiceConfig.from_yaml(
        port_cfg)
    jax_ = jsdk.ServiceConfig.from_yaml(jax_cfg)
    rename = {"TpuWorker": "GpuWorker"}
    assert sorted(port.data) == sorted(rename.get(k, k) for k in jax_.data)
    for name in jax_.data:
        if name == "Common":
            continue
        want = json.loads(json.dumps(jax_.for_service(name)).replace('"tpu"', '"gpu"'))
        got = port.for_service(rename.get(name, name))
        assert got == want == port_in_jax.for_service(rename.get(name, name)), name
    adm = port.for_service("Frontend")["admission"]
    assert adm == jax_.for_service("Frontend")["admission"]
    parsed, jparsed = AdmissionConfig.from_dict(adm), JaxAdmissionConfig.from_dict(adm)
    assert dataclasses.asdict(parsed) == dataclasses.asdict(jparsed)
    assert sorted(parsed.priorities) == ["high", "low", "normal"]
