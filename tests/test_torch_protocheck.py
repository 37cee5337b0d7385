"""The port's protocol plane (``analysis/protocheck.py``) against its own
manifest and against the JAX package's plane.

The mirror of ``tests/test_protocheck.py`` over the port's control plane:
the gate (zero non-accepted findings from the pinned-seed exploration
against the port's ``analysis/proto_manifest.json``), determinism, the WAL
crash matrix, the replay-token round trip, each of the eight bug mutants
caught and replayed, PR002/PR004/PR005 on doctored input, manifest
stability and the ``lint --proto`` exit codes.  Then the port held to the
JAX package: per scenario, both planes run the first pinned seed and must
agree on the invariant registry, the outcome, the violations, the channel
transcripts, the crash census and the schedule trace; every JAX golden
fixture replays to the same outcome in both planes; the port's own golden
fixtures (``tests/lint_fixtures/proto_torch/``) replay to their recorded
outcomes.  Last, the control-plane repairs the plane was used for: a queue
item delivered in the loop turn its pull times out is not lost (C3), six
concurrent streamed KV sessions on one transfer server all land under
seeded schedules, and an engine operation queued after shutdown raises.

Every full sweep runs in a module-scoped fixture (set-up, not a test's
call); the CLI tests reuse that sweep through ``explore_scenario``.
"""

import argparse
import asyncio
import concurrent.futures
import io
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import dynamo_tpu_torch
from dynamo_tpu.analysis import protocheck as jax_protocheck
from dynamo_tpu_torch import cli as port_cli
from dynamo_tpu_torch.analysis import cli as lint_cli
from dynamo_tpu_torch.analysis import protocheck
from dynamo_tpu_torch.analysis.detloop import (DetLoop, MemNet, make_scheduler,
                                               run_deterministic)
from dynamo_tpu_torch.analysis.protocheck import (
    DEFAULT_PROTO_MANIFEST_PATH,
    PROTO_RULES,
    SCENARIOS,
    ProtoFinding,
    ProtoManifest,
    ScenarioReport,
    affected_scenarios,
    check_proto,
    decode_token,
    encode_token,
    explore_scenario,
    first_violation,
    replay_token,
    run_one,
    run_proto,
)
from dynamo_tpu_torch.engine.async_engine import AsyncLLMEngine
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.llm.kv.stream import KvStreamSession
from dynamo_tpu_torch.llm.kv.transfer import KvTransferClient, KvTransferServer
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorServer, _QueueItem

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(dynamo_tpu_torch.__file__).resolve().parent
JAX_FIXTURES = Path(__file__).parent / "lint_fixtures" / "proto"
FIXTURES = Path(__file__).parent / "lint_fixtures" / "proto_torch"

# each scenario's bug mutant and the invariant it must trip
MUTANTS = {
    "reorder-truncate": ("coord.wal", {"kv_acked_durable", "queue_acked_durable",
                                       "blob_acked_durable", "wal_version_head"}),
    "stranded-pull": ("coord.queue", {"queue_no_lost"}),
    "blind-reput": ("coord.reconnect", {"exactly_one_owner"}),
    "no-synth-deletes": ("router.index", {"router_index_matches"}),
    "racy-drain": ("tcp.drain", {"drain_zero_inflight"}),
    "eager-known": ("kv.persist", {"persist_converges"}),
    "notify-early": ("kv.stream", {"stream_notify_ordered"}),
    "stale-generation": ("router.shard", {"shard_no_stale_overcount"}),
}


# ------------------------------------------------------------- the gate ----


@pytest.fixture(scope="module")
def reports():
    """The pinned-seed exploration of every scenario: the sweep
    ``lint --proto`` runs at budget 1."""
    t0 = time.perf_counter()
    reps = [explore_scenario(sc) for sc in SCENARIOS.values()]
    return reps, time.perf_counter() - t0


@pytest.fixture
def cached_sweep(reports, monkeypatch):
    """``run_proto`` over the module's sweep instead of a fresh one (the
    exploration's determinism is pinned on its own below)."""
    by_name = {rep.scenario: rep for rep in reports[0]}
    monkeypatch.setattr(protocheck, "explore_scenario",
                        lambda sc, **kw: by_name[sc.name])


def test_proto_gate_zero_nonaccepted_findings(reports):
    """THE protocol-plane gate: every explored schedule and crash point of
    the port's coordinator, queue, drain, persist, stream and shard
    protocols is clean against the port's committed manifest.  A PR001 or
    PR003 finding embeds a replay token; for accepted drift re-snapshot
    with ``python -m <the port> lint --proto --update-baseline``."""
    reps, _ = reports
    manifest = ProtoManifest.load(DEFAULT_PROTO_MANIFEST_PATH)
    assert manifest.scenarios, "proto manifest missing or empty"
    fresh = manifest.filter(check_proto(reps, manifest))
    assert not fresh, "non-accepted protocol-plane findings:\n  " + "\n  ".join(
        f.render() for f in fresh)


def test_proto_gate_is_fast(reports):
    _, elapsed = reports
    assert elapsed <= 60.0, f"proto exploration took {elapsed:.1f}s"


def test_manifest_accepted_entries_justified_and_live(reports):
    from manifest_hygiene import assert_manifest_hygiene

    reps, _ = reports
    manifest = ProtoManifest.load(DEFAULT_PROTO_MANIFEST_PATH)
    assert_manifest_hygiene(manifest, check_proto(reps, manifest), entity_field="scenario")


def test_exploration_is_deterministic(reports):
    reps, _ = reports
    assert all(rep.deterministic for rep in reps)


def test_wal_crash_matrix_covered_and_clean(reports):
    """Kills at WAL appends (all three disk modes), fsyncs, every
    compaction boundary and frame sends, and the port's recovery held
    every durability invariant."""
    reps, _ = reports
    rep = next(r for r in reps if r.scenario == "coord.wal")
    assert first_violation(rep) is None
    crashed = {r.crash.label for r in rep.results if r.crash is not None}
    for label in ("wal.append.kv", "wal.append.qpush", "wal.fsync.qpush",
                  "wal.compact.write", "wal.compact.rename",
                  "wal.compact.done", "frame.send.reply"):
        assert label in crashed, f"no crash injected at {label}"
    assert {r.crash.mode for r in rep.results if r.crash is not None} == {"proc", "power", "torn"}


# ------------------------------------------------------- determinism -------


def test_same_seed_byte_identical_traces():
    sc = SCENARIOS["coord.queue"]
    a, b = run_one(sc, 7), run_one(sc, 7)
    assert json.dumps(a.trace) == json.dumps(b.trace)
    assert a.choices == b.choices
    assert a.token == b.token


def test_different_seeds_explore_different_schedules():
    sc = SCENARIOS["tcp.drain"]
    assert len({json.dumps(run_one(sc, s).trace) for s in range(4)}) > 1


# ------------------------------------------------------ replay tokens ------


def test_replay_token_roundtrip():
    payload = {"scenario": "coord.wal", "seed": 3, "bug": "x",
               "crash": {"kind": "crash", "label": "wal.append.kv",
                         "occurrence": 1, "mode": "torn", "conn": 0,
                         "after_frames": 0, "direction": "s2c"},
               "choices": [0, 2, 1, 5]}
    token = encode_token(payload)
    assert token.startswith("dtp1.") and "=" not in token
    assert decode_token(token) == payload
    # the two packages' tokens are one format
    assert jax_protocheck.decode_token(token) == payload
    assert decode_token(jax_protocheck.encode_token(payload)) == payload
    with pytest.raises(ValueError):
        decode_token("nope." + token)


def test_replay_reproduces_clean_run():
    orig = run_one(SCENARIOS["coord.reconnect"], 1)
    again = replay_token(orig.token)
    assert again.trace == orig.trace
    assert again.violations == orig.violations


# ------------------------------------------------- the bug-catch proof -----


def _first_violation_of(bug: str):
    """The run ``first_violation(explore_scenario(sc, bug=bug))`` would
    return, found in the sweep's own order (seeds, then the crash matrix
    of the base run) but stopping there: the rest of the matrix costs
    filesystem time and changes nothing."""
    sc = SCENARIOS[MUTANTS[bug][0]]
    base = None
    for i in range(sc.seeds):
        r = run_one(sc, i, bug=bug)
        if r.violations or r.outcome != "ok":
            return r
        base = base or r
    for plan in (sc.plans(base, 1) if sc.plans is not None else []):
        r = run_one(sc, 0, crash=plan, bug=bug)
        if r.violations or r.outcome != "ok":
            return r
    return None


@pytest.mark.parametrize("bug", sorted(MUTANTS))
def test_mutant_is_caught_and_replays(bug):
    """Each deliberately broken protocol (subclassing the port's server,
    client, TCP server, replicator or shard replica) trips its invariant,
    and the finding's replay token reproduces the run exactly."""
    bad = _first_violation_of(bug)
    assert bad is not None, f"{bug} went undetected"
    assert {v for v, _ in bad.violations} & MUTANTS[bug][1], bad.violations
    again = replay_token(bad.token)
    assert again.violations == bad.violations
    assert again.trace == bad.trace


# -------------------------------------------------- golden fixtures --------


def _off_thread(fn, *args):
    """``fn(*args)`` on a thread of its own.  A JAX-plane run that stops
    mid-flight (a replay-mismatch) closes its stranded coroutines after
    its loop stopped, and a finally block there that spawns a task would
    put it on this thread's default event loop; a worker thread has none,
    so the spawn dies with the coroutine instead of leaking."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(fn, *args).result()


def _fixtures(folder: Path) -> list[Path]:
    return sorted(folder.glob("*.json"))


def test_fixture_inventory():
    """One passing and one violating golden schedule per scenario, in
    each package's folder."""
    for folder in (FIXTURES, JAX_FIXTURES):
        names = {p.name for p in _fixtures(folder)}
        for scen in SCENARIOS:
            stem = scen.replace(".", "_")
            assert {f"{stem}_pass.json", f"{stem}_violate.json"} <= names, (folder, scen)


@pytest.mark.parametrize("path", _fixtures(FIXTURES), ids=lambda p: p.stem)
def test_golden_fixture_replays(path):
    """Each of the port's committed replay tokens reproduces its recorded
    outcome and violation set against today's port."""
    doc = json.loads(path.read_text())
    r = replay_token(doc["token"])
    assert r.outcome == doc["expect"]["outcome"], doc["name"]
    assert sorted({v for v, _ in r.violations}) == doc["expect"]["violations"], doc["name"]


@pytest.mark.parametrize("path", _fixtures(JAX_FIXTURES), ids=lambda p: p.stem)
def test_jax_golden_fixture_replays_alike_in_both_planes(path):
    """Each JAX golden token replays through the port's plane exactly as
    through the JAX plane: the same outcome, violation set and error (the
    step at which a choice list stops fitting included).  The JAX choice
    lists were recorded under Python 3.11's ``asyncio.wait_for`` (one task
    more per bounded call), so under 3.12 both planes report the same
    replay-mismatch; the port's fixtures above take their place."""
    token = json.loads(path.read_text())["token"]
    mine, theirs = replay_token(token), _off_thread(jax_protocheck.replay_token, token)
    assert mine.outcome == theirs.outcome
    assert mine.violations == theirs.violations
    assert mine.error == theirs.error
    assert mine.trace == theirs.trace


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax_plane_at_first_pinned_seed(name):
    """Both planes run the scenario's first pinned seed on their own
    control plane: the invariant registries, outcomes, violations, channel
    transcripts, crash census and schedule traces are the same."""
    mine = run_one(SCENARIOS[name], 0)
    theirs = _off_thread(jax_protocheck.run_one, jax_protocheck.SCENARIOS[name], 0)
    assert SCENARIOS[name].invariants == jax_protocheck.SCENARIOS[name].invariants
    assert (mine.outcome, mine.violations) == (theirs.outcome, theirs.violations)
    assert mine.channels == theirs.channels
    assert mine.census == theirs.census
    assert mine.trace == theirs.trace


# ---------------------------------------------------- rules & manifest -----


def test_rule_registry_documented():
    assert PROTO_RULES == jax_protocheck.PROTO_RULES
    assert set(PROTO_RULES) == {"PR001", "PR002", "PR003", "PR004", "PR005"}
    assert list(SCENARIOS) == list(jax_protocheck.SCENARIOS)


def test_nondeterminism_raises_pr002():
    rep = ScenarioReport("coord.queue", [run_one(SCENARIOS["coord.queue"], 0)],
                         deterministic=False)
    findings = check_proto([rep], ProtoManifest(), drift=False)
    assert ("coord.queue", "PR002", "determinism") in {f.accept_key for f in findings}


def test_state_machine_drift_raises_pr004(reports):
    reps, _ = reports
    manifest = ProtoManifest.load(DEFAULT_PROTO_MANIFEST_PATH)
    doctored = ProtoManifest(json.loads(json.dumps(manifest.scenarios)), [], {})
    chans = doctored.scenarios["coord.wal"]["channels"]
    ch = next(iter(chans))
    removed = chans[ch]["edges"].pop()
    chans[ch]["edges"].append("ghost>edge")
    keys = {f.key for f in check_proto(reps, doctored)
            if f.rule == "PR004" and f.scenario == "coord.wal"}
    assert f"{ch}+{removed}" in keys
    assert f"{ch}-ghost>edge" in keys


def test_crash_census_drift_raises_pr005(reports):
    reps, _ = reports
    manifest = ProtoManifest.load(DEFAULT_PROTO_MANIFEST_PATH)
    doctored = ProtoManifest(json.loads(json.dumps(manifest.scenarios)), [], {})
    doctored.scenarios["coord.wal"]["crash_points"]["wal.append.ghost"] = 1
    assert ("coord.wal", "PR005", "-wal.append.ghost") in {
        f.accept_key for f in check_proto(reps, doctored)}


def test_accepted_entry_budget_is_a_multiset():
    m = ProtoManifest(accepted=[{"scenario": "s", "rule": "PR001", "key": "inv",
                                 "justification": "known"}])
    fresh = m.filter([ProtoFinding("s", "PR001", "inv", "a"),
                      ProtoFinding("s", "PR001", "inv", "b")])
    assert len(fresh) == 1


def test_update_baseline_carries_justifications(tmp_path):
    prev = ProtoManifest(accepted=[{"scenario": "s", "rule": "PR001", "key": "inv",
                                    "detail": "old", "justification": "because physics"}])
    nxt = ProtoManifest.from_facts({"s": {}}, [ProtoFinding("s", "PR001", "inv", "new")], prev)
    assert nxt.accepted[0]["justification"] == "because physics"
    nxt2 = ProtoManifest.from_facts({"s": {}}, [ProtoFinding("s", "PR001", "other", "x")], prev)
    assert nxt2.accepted[0]["justification"] == "TODO: justify"
    path = tmp_path / "m.json"
    nxt.save(path)
    assert ProtoManifest.load(path).accepted == nxt.accepted


def test_manifest_json_is_stable(tmp_path):
    """The committed manifest re-saves to the same bytes."""
    m = ProtoManifest.load(DEFAULT_PROTO_MANIFEST_PATH)
    path = tmp_path / "again.json"
    m.save(path)
    assert path.read_text() == DEFAULT_PROTO_MANIFEST_PATH.read_text()


# -------------------------------------------------------- CLI surface ------


def _args(**kw):
    base = dict(proto=True, changed=False, manifest=None, fmt="text",
                update_baseline=False, root=str(ROOT), replay=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_run_proto_exit_codes(cached_sweep, tmp_path):
    """Clean committed manifest: 0; a doctored one (ghost crash point): 1
    with the PR005 finding rendered."""
    out = io.StringIO()
    assert run_proto(_args(), out) == 0
    assert "0 protocol findings" in out.getvalue()
    doctored = ProtoManifest.load(DEFAULT_PROTO_MANIFEST_PATH)
    doctored.scenarios["coord.wal"]["crash_points"]["wal.append.ghost"] = 1
    mpath = tmp_path / "doctored.json"
    doctored.save(mpath)
    out = io.StringIO()
    assert run_proto(_args(manifest=str(mpath)), out) == 1
    assert "PR005" in out.getvalue()


def test_run_proto_json_output(cached_sweep):
    """JSON output: no finding, every scenario, stable-sorted (the same
    bytes twice; the sweep under it is pinned by the determinism tests)."""
    outs = []
    for _ in range(2):
        out = io.StringIO()
        assert run_proto(_args(fmt="json"), out) == 0
        outs.append(out.getvalue())
    doc = json.loads(outs[0])
    assert doc["findings"] == []
    assert sorted(doc["scenarios"]) == sorted(SCENARIOS)
    assert doc["runs"] > 50
    assert outs[0] == outs[1]


def test_changed_maps_dirty_files_to_scenarios(monkeypatch):
    """``lint --proto --changed`` maps the port's dirty protocol files to
    the scenarios that execute them, and the JAX package's to none."""
    for dirty, want in (
        (PKG / "llm" / "kv" / "persist.py", ["kv.persist"]),
        (PKG / "runtime" / "transports" / "tcp.py", ["tcp.drain"]),
        (PKG / "llm" / "kv" / "stream.py", ["kv.stream"]),
        (PKG / "analysis" / "detloop.py", list(SCENARIOS)),
        (ROOT / "dynamo_tpu" / "llm" / "kv" / "persist.py", []),
    ):
        monkeypatch.setattr(lint_cli, "_git_changed_paths", lambda root, d=dirty: [d])
        assert affected_scenarios(ROOT) == want, dirty


def test_update_baseline_refuses_partial_runs(monkeypatch, tmp_path):
    """A --changed subset or a non-default budget never rewrites the
    manifest, and is refused before any sweep."""
    mpath = tmp_path / "m.json"
    ProtoManifest.load(DEFAULT_PROTO_MANIFEST_PATH).save(mpath)
    before = mpath.read_text()
    monkeypatch.setattr(protocheck, "explore_scenario", None)  # a sweep would raise
    monkeypatch.setenv("DTPROTO_BUDGET", "2")
    out = io.StringIO()
    assert run_proto(_args(update_baseline=True, manifest=str(mpath)), out) == 2
    assert "refusing" in out.getvalue()
    monkeypatch.delenv("DTPROTO_BUDGET")
    monkeypatch.setattr(lint_cli, "_git_changed_paths",
                        lambda root: [PKG / "llm" / "kv" / "persist.py"])
    out = io.StringIO()
    assert run_proto(_args(update_baseline=True, changed=True, manifest=str(mpath)), out) == 2
    assert mpath.read_text() == before


def test_lint_command_exit_codes(capsys):
    """The port's ``lint``: ``--proto --replay`` exits 0 on a clean token
    and 1 on a violating one; every plane the port does not have exits 2
    naming the plane."""
    for kind, code in (("pass", 0), ("violate", 1)):
        token = json.loads((FIXTURES / f"tcp_drain_{kind}.json").read_text())["token"]
        with pytest.raises(SystemExit) as e:
            port_cli.main(["lint", "--proto", "--replay", token, "--format", "json"])
        assert e.value.code == code
        doc = json.loads(capsys.readouterr().out)
        assert doc["scenario"] == "tcp.drain" and doc["outcome"] == "ok"
    for flags, plane in ((["--wire"], "wire plane"), (["--trace"], "compile plane"),
                         (["--all"], "every plane"), (["--metrics"], "metrics plane")):
        with pytest.raises(SystemExit) as e:
            port_cli.main(["lint", *flags])
        assert e.value.code == 2
        assert plane in capsys.readouterr().err


# ------------------------------------------------ the plane's repairs ------


def test_queue_pull_keeps_an_item_delivered_as_its_timeout_fires():
    """C3: a push delivered to a waiting pull in the loop turn the pull's
    timeout fires.  ``wait_for`` cancels the puller after the waiter
    already holds the item; the item must come back to the puller, not
    vanish (a lost remote-prefill message leaves its decode request
    waiting forever).  The loop is stalled past the timeout, then the
    delivery is queued ahead of the expired timer."""

    async def main():
        srv = CoordinatorServer()
        loop = asyncio.get_running_loop()
        take = asyncio.ensure_future(srv._queue_take("q", 0.05))
        await asyncio.sleep(0)  # the pull parks its waiter
        item = _QueueItem(7, b"job", {"queue": "q"})

        def stall_then_deliver():
            time.sleep(0.1)
            loop.call_soon(srv._queue_deliver, "q", item)

        loop.call_soon(stall_then_deliver)
        got = await asyncio.wait_for(take, 5.0)
        return item, got, list(srv._queues["q"])

    item, got, left = asyncio.run(main())
    assert got is item and left == []


def _detloop_run(seed: int, main_fn):
    loop = DetLoop(make_scheduler(seed))
    try:
        return run_deterministic(loop, main_fn(loop))
    finally:
        loop.close()


@pytest.mark.parametrize("seed", range(8))
def test_queue_delivery_racing_a_pull_timeout_is_never_lost(seed):
    """The same race explored: the pull's timeout and the push are due at
    the same virtual instant, and each seed orders the two timers, the
    pusher's step and the puller's wake-up its own way.  Whatever the
    order, the item is the puller's or still queued, never gone."""

    async def main(loop):
        srv = CoordinatorServer()
        item = _QueueItem(3, b"job", {"queue": "q"})

        async def push():
            await asyncio.sleep(1.0)
            srv._queue_deliver("q", item)

        pusher = asyncio.ensure_future(push())
        got = await srv._queue_take("q", 1.0)
        await pusher
        return item, got, list(srv._queues["q"])

    item, got, left = _detloop_run(seed, main)
    assert (got is item and left == []) or (got is None and left == [item])


@pytest.mark.parametrize("seed", range(8))
def test_six_concurrent_stream_sessions_land_under_seeded_schedules(seed):
    """Six streamed KV sessions at once against one transfer server (the
    decode side of a concurrent streamed disaggregated run), each three
    chunks of a 2-layer cache over its own connection, the server's sink
    taking a step boundary per apply.  Under every seed all six sessions
    end, each applies exactly its whole cache once, every notify follows
    its apply, and no session is left open."""
    rng = np.random.default_rng(11)
    caches = [[torch.from_numpy(rng.standard_normal((2, 2, 3)).astype(np.float32))
               for _ in range(3)] for _ in range(6)]

    async def main(loop):
        net = MemNet(loop)
        ops = []

        async def sink(ids, arr, rid):
            await asyncio.sleep(0.01)  # the decode engine's step boundary
            ops.append(("apply", rid, [int(b) for b in ids], arr.clone()))

        async def notify(rid, first_token, error):
            ops.append(("notify", rid, first_token, error))

        srv = KvTransferServer(write_sink=sink, notify_cb=notify, host="mem", net=net)
        await srv.start()

        async def one(i):
            cli = await KvTransferClient.connect(f"tcp://mem:{srv.port}", net=net,
                                                 force_tcp=True)
            try:
                sess = KvStreamSession(cli, f"r{i}", num_layers=2, session_id=f"s-r{i}")
                await sess.begin()
                for c, chunk in enumerate(caches[i]):
                    await sess.write_chunk([10 * i + 2 * c, 10 * i + 2 * c + 1], chunk,
                                           compute_live=c < 2)
                await sess.end()
                await cli.notify(f"r{i}", 7)
            finally:
                await cli.close()

        await asyncio.wait_for(asyncio.gather(*(one(i) for i in range(6))), 120.0)
        open_sessions = dict(srv.assembler._sessions)
        await srv.stop()
        return ops, open_sessions

    ops, open_sessions = _detloop_run(seed, main)
    assert open_sessions == {}
    for i in range(6):
        rid = f"r{i}"
        applies = [k for k, o in enumerate(ops) if o[0] == "apply" and o[1] == rid]
        notifies = [k for k, o in enumerate(ops) if o[0] == "notify" and o[1] == rid]
        assert len(applies) == 1 and len(notifies) == 1, (rid, ops)
        _, _, ids, arr = ops[applies[0]]
        assert ids == [10 * i + j for j in range(6)]
        assert torch.equal(arr, torch.cat(caches[i], dim=1))
        assert applies[0] < notifies[0]


class _IdleCore:
    """The engine-thread surface ``AsyncLLMEngine`` drives, with no model:
    every step is idle."""

    device = torch.device("cpu")
    run_on_step = EngineCore.run_on_step
    fail_pending_ops = EngineCore.fail_pending_ops
    _process_ops = EngineCore._process_ops

    def __init__(self):
        import queue

        self._ops = queue.SimpleQueue()

    def step(self):
        self._process_ops()
        return False


def test_run_on_engine_raises_once_the_engine_has_stopped():
    """An operation queued for a step boundary that will never come (the
    engine shut down) raises instead of leaving its awaiter waiting
    forever; one queued before the shutdown is failed by the stopping
    thread, one queued after by the caller."""
    engine = AsyncLLMEngine(_IdleCore()).start()
    assert asyncio.run(engine.run_on_engine(lambda: 41 + 1)) == 42
    engine.shutdown()
    with pytest.raises(RuntimeError, match="engine stopped"):
        asyncio.run(asyncio.wait_for(engine.run_on_engine(lambda: 1), 5.0))

    core = _IdleCore()
    stuck = AsyncLLMEngine(core)
    stuck._thread = threading.Thread(target=stuck._run)  # started below, after the put
    fut = core.run_on_step(lambda: 1)
    stuck._shutdown = True
    stuck._thread.start()
    stuck._thread.join(5)
    with pytest.raises(RuntimeError, match="engine stopped"):
        fut.result(timeout=5)
