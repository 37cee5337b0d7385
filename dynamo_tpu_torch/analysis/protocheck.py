"""Protocol plane (dtproto) — deterministic-schedule model checking and
systematic crash-point exploration of the control-plane protocols.

The counterpart of the JAX package's ``analysis/protocheck.py`` over the
port's control plane: the same eight scenarios, invariants, crash matrices,
bug mutants and replay tokens, each scenario driving the port's classes.
The port's committed snapshot is its own ``analysis/proto_manifest.json``.

This plane executes the REAL protocol code — ``CoordinatorServer`` /
``CoordinatorClient``, the endpoint TCP transport, the persist
replicator, the layer-wise KV stream and the shard replicas — under
``analysis/detloop.DetLoop``: a seeded scheduler owns
every interleaving, time is virtual, and the network is an in-memory
shim speaking the real ``framing.py`` bytes.  Two exploration axes:

* **schedules** — each scenario runs under a range of seeds; even seeds
  use uniform random scheduling, odd seeds a PCT-style priority
  scheduler with seeded inversion points;
* **crash points** — the coordinator's ``crash_hook`` seam fires at
  every WAL append/fsync/compact boundary and frame send; the explorer
  kills the process at each (label, occurrence) with ``proc`` (flushed
  file survives), ``power`` (truncate to the last fsync) and ``torn``
  (half the unsynced tail) disk semantics, then drives recovery.

Every run checks a registry of executable invariants (WAL replay
idempotence, acked-durable, no lost/duplicated queue message, drain
returns only at zero in-flight, router index == server truth at
quiescence, reconnect never double-applies).  A failing run prints a
compact replay token — ``dtp1.`` + base64(zlib(json)) of the scenario,
seed, crash plan and full choice list — that re-executes the exact
interleaving.

Facts (per-channel op state machines, crash-point census, invariant
registry) snapshot to the committed ``analysis/proto_manifest.json``
with the same accepted-entries contract as the other planes: every
accepted finding carries a one-line justification, and
``--update-baseline`` (with ``--proto``) re-snapshots carrying
justifications over by (scenario, rule, key).

Budget: ``DTPROTO_BUDGET`` multiplies seeds and crash occurrences
(nightly CI runs 100x), ``DTPROTO_SEED_BASE`` shifts the seed range for
fresh exploration.  Under non-default budget/seeds the drift rules
PR004/PR005 are skipped — new schedules legitimately discover new
edges; only invariant violations and non-quiescence are failures there.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import shutil
import tempfile
import zlib
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

import asyncio

from dynamo_tpu_torch.analysis.detloop import (
    DeadlockError,
    DetLoop,
    HorizonExceeded,
    MemNet,
    ReplayMismatch,
    SimulatedCrash,
    make_scheduler,
)
from dynamo_tpu_torch.runtime.transports.coordinator import (
    CoordinatorClient,
    CoordinatorServer,
)
from dynamo_tpu_torch.runtime.transports.protocol import CoordOp
from dynamo_tpu_torch.runtime.transports.tcp import (
    EndpointTcpClient,
    EndpointTcpServer,
)

__all__ = [
    "DEFAULT_PROTO_MANIFEST_PATH",
    "PROTO_RULES",
    "SCENARIOS",
    "CrashPlan",
    "RunResult",
    "ScenarioReport",
    "ProtoFinding",
    "ProtoManifest",
    "encode_token",
    "decode_token",
    "run_one",
    "replay_token",
    "explore_scenario",
    "facts_from",
    "check_proto",
    "affected_scenarios",
    "run_proto",
]

DEFAULT_PROTO_MANIFEST_PATH = Path(__file__).parent / "proto_manifest.json"

_MANIFEST_NOTE = (
    "Committed protocol-plane snapshot of the PyTorch port "
    "(python -m dynamo_tpu_torch lint --proto): "
    "per-scenario channel state machines, crash-point census and "
    "invariant registry from the pinned-seed exploration.  Regenerate "
    "with --proto --update-baseline; every accepted entry needs a real "
    "justification."
)

PROTO_RULES = {
    "PR001": "protocol invariant violated in an explored schedule",
    "PR002": "same-seed schedule replay diverged (nondeterminism)",
    "PR003": "scenario failed to quiesce (deadlock/horizon/replay error)",
    "PR004": "protocol state machine drifted from the committed manifest",
    "PR005": "crash-point census drifted from the committed manifest",
}

# drift rules are resolved by re-snapshotting, not by justification
_DRIFT_RULES = ("PR004", "PR005")

_TOKEN_PREFIX = "dtp1."

# the package whose files ``--changed`` maps to scenarios
_PKG = "dynamo_tpu_torch"

_DEL = object()   # recorded kv op value meaning "delete"
_ABSENT = "<absent>"


# ---------------------------------------------------------------- findings


@dataclass(frozen=True, order=True)
class ProtoFinding:
    """One protocol-plane finding.  ``(scenario, rule, key)`` is the
    stable acceptance key — replay tokens live in ``detail`` only, so an
    accepted entry survives schedule-budget changes."""

    scenario: str
    rule: str
    key: str
    detail: str

    @property
    def accept_key(self) -> tuple[str, str, str]:
        return (self.scenario, self.rule, self.key)

    def render(self) -> str:
        return f"{self.scenario}: {self.rule}[{self.key}] {self.detail}"

    def to_json(self) -> dict:
        return {
            "scenario": self.scenario,
            "rule": self.rule,
            "key": self.key,
            "detail": self.detail,
        }


# ---------------------------------------------------------------- manifest


class ProtoManifest:
    """Committed protocol-plane snapshot + accepted (justified) findings.

    Same contract as the other planes: ``accepted`` entries carry a
    one-line justification and are matched as a (scenario, rule, key)
    multiset; ``--update-baseline`` (with ``--proto``) re-snapshots the
    scenario facts and carries justifications over where the key still
    matches."""

    def __init__(self, scenarios: Optional[dict] = None,
                 accepted: Optional[list[dict]] = None,
                 header: Optional[dict] = None):
        self.scenarios: dict = scenarios or {}
        self.accepted: list[dict] = accepted or []
        self.header: dict = header or {}

    @classmethod
    def load(cls, path: Path) -> "ProtoManifest":
        if not Path(path).is_file():
            return cls()
        data = json.loads(Path(path).read_text())
        return cls(dict(data.get("scenarios", {})),
                   list(data.get("accepted", [])),
                   dict(data.get("header", {})))

    def save(self, path: Path) -> None:
        doc = {
            "version": 1,
            "header": self.header or {"note": _MANIFEST_NOTE},
            "scenarios": self.scenarios,
            "accepted": sorted(
                self.accepted,
                key=lambda e: (e["scenario"], e["rule"], e["key"]),
            ),
        }
        Path(path).write_text(
            json.dumps(doc, indent=2, sort_keys=True) + "\n"
        )

    def _counts(self) -> dict[tuple[str, str, str], int]:
        counts: dict[tuple[str, str, str], int] = {}
        for e in self.accepted:
            key = (e["scenario"], e["rule"], e["key"])
            counts[key] = counts.get(key, 0) + 1
        return counts

    def filter(self, findings: list[ProtoFinding]) -> list[ProtoFinding]:
        """Findings NOT covered by an accepted entry (stable-sorted)."""
        budget = self._counts()
        fresh: list[ProtoFinding] = []
        for f in sorted(findings):
            if budget.get(f.accept_key, 0) > 0:
                budget[f.accept_key] -= 1
            else:
                fresh.append(f)
        return fresh

    @classmethod
    def from_facts(cls, facts: dict, findings: list[ProtoFinding],
                   previous: "ProtoManifest") -> "ProtoManifest":
        just: dict[tuple[str, str, str], list[str]] = {}
        for e in previous.accepted:
            key = (e["scenario"], e["rule"], e["key"])
            just.setdefault(key, []).append(e.get("justification", ""))
        accepted = []
        for f in sorted(findings):
            carried = just.get(f.accept_key)
            accepted.append({
                "scenario": f.scenario,
                "rule": f.rule,
                "key": f.key,
                "detail": f.detail,
                "justification": (
                    carried.pop(0) if carried else "TODO: justify"
                ),
            })
        return cls(facts, accepted, previous.header or None)


# ------------------------------------------------------------ replay token


def encode_token(payload: dict) -> str:
    raw = json.dumps(payload, sort_keys=True,
                     separators=(",", ":")).encode()
    return _TOKEN_PREFIX + base64.urlsafe_b64encode(
        zlib.compress(raw, 9)).decode().rstrip("=")


def decode_token(token: str) -> dict:
    if not token.startswith(_TOKEN_PREFIX):
        raise ValueError(f"not a dtproto replay token: {token[:16]!r}")
    body = token[len(_TOKEN_PREFIX):]
    body += "=" * (-len(body) % 4)
    return json.loads(zlib.decompress(base64.urlsafe_b64decode(body)))


# -------------------------------------------------------------- crash plan


@dataclass(frozen=True)
class CrashPlan:
    """One injected fault: ``crash`` kills the coordinator process at a
    (label, occurrence) with the given disk mode; ``sever`` cuts one
    connection at its k-th complete frame in one direction (the shared
    fault vocabulary's ops, driven deterministically)."""

    kind: str = "crash"       # "crash" | "sever"
    label: str = ""           # crash-hook label
    occurrence: int = 0
    mode: str = "proc"        # "proc" | "power" | "torn"
    conn: int = 0             # sever: connection ordinal
    after_frames: int = 0     # sever: trigger frame count
    direction: str = "s2c"

    @classmethod
    def from_json(cls, d: Optional[dict]) -> Optional["CrashPlan"]:
        return cls(**d) if d else None


# ----------------------------------------------------------------- harness


class Harness:
    """Per-run state shared between a scenario and the checker:
    the loop/net pair, crash-plan machinery, expectation bookkeeping and
    the violation list the invariants write into."""

    def __init__(self, loop: DetLoop, net: MemNet, root: Path, *,
                 bug: Optional[str] = None,
                 crash: Optional[CrashPlan] = None):
        self.loop = loop
        self.net = net
        self.root = root
        self.data_dir = root / "coord"
        self.bug = bug
        self.fault = crash          # any injected plan, crash or sever
        self.crash = crash if crash and crash.kind == "crash" else None
        if crash and crash.kind == "sever":
            net.sever_conn_after(crash.conn, crash.after_frames,
                                 crash.direction)
        self.crash_fired = False
        self.crash_census: dict[str, int] = {}
        self.violations: list[tuple[str, str]] = []
        self.servers: list[CoordinatorServer] = []
        self.clients: list[CoordinatorClient] = []
        self.coord_port = 0
        self._synced: dict[Path, int] = {}   # wal path -> fsynced offset
        # scenario scratch
        self.kv_ops: dict[str, list[tuple[str, Any]]] = {}
        self.queue_pushes: list[tuple[bytes, str]] = []
        self.queue_acks: list[tuple[bytes, str]] = []
        self.blob_expect: Optional[tuple[str, str]] = None
        self.leased_keys: set[str] = set()
        self.notes: dict[str, Any] = {}

    # ------------------------------------------------------------ invariants
    def check(self, invariant: str, cond: bool, msg: str = "") -> None:
        if not cond:
            self.violations.append((invariant, msg or invariant))

    # ---------------------------------------------------------- bug variants
    def pick(self, kind: str, default):
        impl = _BUG_IMPLS.get(self.bug or "", {}).get(kind)
        return impl if impl is not None else default

    # ------------------------------------------------------------ crash hook
    def hook_for(self, srv: CoordinatorServer) -> Callable[[str], None]:
        def hook(label: str) -> None:
            n = self.crash_census.get(label, 0)
            self.crash_census[label] = n + 1
            path = (srv._data_dir / "wal.jsonl"
                    if srv._data_dir is not None else None)
            if path is not None:
                # track the durable frontier for power/torn modeling
                if label.startswith("wal.fsync.") or \
                        label == "wal.compact.done":
                    try:
                        self._synced[path] = path.stat().st_size
                    except OSError:
                        pass
            plan = self.crash
            if (plan is not None and not self.crash_fired
                    and label == plan.label and n == plan.occurrence):
                self.crash_fired = True
                self._die(srv, label, n, plan.mode)
        return hook

    def _die(self, srv: CoordinatorServer, label: str, occ: int,
             mode: str) -> None:
        """Instant process death at a crash point.  Freezes the WAL
        first (a dead process writes nothing — post-crash finally blocks
        must not append revocation records), applies the disk mode's
        lost-tail semantics, then severs the network and unwinds the
        current stack with SimulatedCrash."""
        wal = getattr(srv, "_wal", None)
        if wal is not None:
            try:
                wal.flush()
                wal.close()
            except (OSError, ValueError):
                pass
            srv._wal = None
        path = (srv._data_dir / "wal.jsonl"
                if srv._data_dir is not None else None)
        if (mode in ("power", "torn") and path is not None
                and path.exists() and label.startswith("wal.append.")):
            # power loss: the OS page cache died with the machine — only
            # bytes up to the last fsync survive; "torn" keeps half the
            # unsynced tail, cutting the last record mid-line
            size = path.stat().st_size
            synced = min(self._synced.get(path, 0), size)
            keep = synced if mode == "power" else \
                synced + (size - synced + 1) // 2
            with path.open("rb+") as f:
                f.truncate(keep)
        server = getattr(srv, "_server", None)
        if server is not None and getattr(server, "port", None) is not None:
            self.net.kill_server(server.port)
            srv._server = None
        if srv._expiry_task is not None:
            srv._expiry_task.cancel()
        for t in list(srv._bg_tasks):
            t.cancel()
        for t in srv._conn_tasks.values():
            if t is not None:
                t.cancel()
        raise SimulatedCrash(f"{label}#{occ} [{mode}]")

    def kill_current(self, srv: CoordinatorServer) -> None:
        """Scenario-scripted process kill (proc semantics: flushed bytes
        survive) — the scripted-restart half of every durability run."""
        wal = getattr(srv, "_wal", None)
        if wal is not None:
            try:
                wal.flush()
                wal.close()
            except (OSError, ValueError):
                pass
            srv._wal = None
        server = getattr(srv, "_server", None)
        if server is not None and getattr(server, "port", None) is not None:
            self.net.kill_server(server.port)
            srv._server = None
        if srv._expiry_task is not None:
            srv._expiry_task.cancel()
        for t in list(srv._bg_tasks):
            t.cancel()
        for t in srv._conn_tasks.values():
            if t is not None:
                t.cancel()

    # --------------------------------------------------------------- helpers
    async def start_coordinator(self, *, durable: bool = True,
                                port: int = 0):
        cls = self.pick("server", CoordinatorServer)
        srv = cls(port=port,
                  data_dir=str(self.data_dir) if durable else None,
                  net=self.net)
        srv.crash_hook = self.hook_for(srv)
        self.servers.append(srv)
        if durable:
            path = self.data_dir / "wal.jsonl"
            if path.exists():
                # whatever survived a previous incarnation is durable
                self._synced[path] = path.stat().st_size
        try:
            await srv.start()
        except SimulatedCrash:
            return srv, False
        self.coord_port = srv.port
        self.net.name_port(srv.port, "coord")
        return srv, True

    async def client(self, *, reconnect: bool = True) -> CoordinatorClient:
        cls = self.pick("client", CoordinatorClient)
        c = cls(f"tcp://mem:{self.coord_port}", reconnect=reconnect,
                net=self.net)
        await c.connect()
        self.clients.append(c)
        return c

    async def op(self, fn, *args, timeout: float = 60.0, **kw):
        """Run one client call with a virtual-time bound; a call the
        crash ate comes back ("lost", exc) — maybe-applied."""
        try:
            return "ok", await asyncio.wait_for(fn(*args, **kw), timeout)
        except (ConnectionError, OSError, RuntimeError,
                asyncio.TimeoutError) as e:
            return "lost", e

    async def teardown(self) -> None:
        for c in self.clients:
            try:
                await asyncio.wait_for(c.close(), 10.0)
            except (asyncio.TimeoutError, ConnectionError, OSError,
                    RuntimeError):
                pass
        for srv in self.servers:
            try:
                await asyncio.wait_for(srv.stop(), 10.0)
            except (asyncio.TimeoutError, ConnectionError, OSError,
                    RuntimeError):
                pass

    # ------------------------------------------------ expectation bookkeeping
    def record_kv(self, key: str, status: str, value: Any) -> None:
        self.kv_ops.setdefault(key, []).append((status, value))

    @staticmethod
    def _canon(value: Any) -> str:
        if value is _DEL:
            return _ABSENT
        return json.dumps(value, sort_keys=True, default=repr)

    def kv_allowed(self, key: str, *, weak: bool) -> set[str]:
        """Final values consistent with the op log: the server applies
        in order, a lost op may or may not have applied, so the final
        value is the last op of some superset of the acked set — any
        value at or after the last acked index.  ``weak`` (power/torn
        crashes: only fsynced records are promised) relaxes to "some
        op's value or absent" (prefix consistency, no corruption)."""
        ops = self.kv_ops.get(key, [])
        vals = [self._canon(v) for _s, v in ops]
        acked = [i for i, (s, _v) in enumerate(ops) if s == "ok"]
        if weak or not acked:
            return {_ABSENT, *vals}
        last = acked[-1]
        return set(vals[last:])


# ------------------------------------------------------------ bug variants
#
# Deliberately-broken protocol implementations, used for the violating
# golden fixtures and the gate's "the checker actually catches bugs"
# proof.  Each reintroduces a bug class the real code handles (two of
# them — stranded-pull and racy-drain — are the pre-fix versions of real
# bugs this plane found).


class _ReorderedTruncateServer(CoordinatorServer):
    """WAL compaction bug: truncates wal.jsonl IN PLACE before writing
    the replacement (instead of tmp+fsync+rename).  A crash inside the
    window loses every durable record."""

    def _recover(self) -> None:
        path = self._data_dir / "wal.jsonl"
        self._data_dir.mkdir(parents=True, exist_ok=True)
        data = path.read_bytes() if path.exists() else b""
        path.write_bytes(b"")          # the reordered truncate
        if self.crash_hook is not None:
            self.crash_hook("bug.compact.truncate")
        path.write_bytes(data)
        super()._recover()


class _StrandedPullServer(CoordinatorServer):
    """Pre-fix QUEUE_PULL: registers the delivery into _pending_acks
    without checking the puller's connection is still alive.  A consumer
    severed during a long pull strands the item forever — the conn-drop
    redelivery sweep already ran."""

    async def _dispatch(self, conn_id, writer, h, payload):
        if h.get("op") != CoordOp.QUEUE_PULL:
            return await super()._dispatch(conn_id, writer, h, payload)
        rid = h.get("id")

        async def _pull(queue=h["queue"],
                        timeout=h.get("timeout_ms", 0) / 1e3, rid=rid):
            item = await self._queue_take(queue, timeout)
            if item is None:
                await self._send(conn_id, writer,
                                 {"id": rid, "ok": False, "empty": True})
                return
            item.header["conn_id"] = conn_id
            self._pending_acks[(queue, item.msg_id)] = item
            await self._send(
                conn_id, writer,
                {"id": rid, "ok": True, "msg_id": item.msg_id}, item.payload)

        self._spawn(_pull())


class _BlindReputClient(CoordinatorClient):
    """Reconnect-heal bug: re-puts every leased key unconditionally
    (ignores the create-exclusive flag), clobbering a rival that
    legitimately claimed the key during the outage."""

    async def _reregister(self) -> None:
        self._leased_kv = {
            k: (v, lh, False) for k, (v, lh, _c) in self._leased_kv.items()
        }
        await super()._reregister()


class _NoSynthDeleteClient(CoordinatorClient):
    """Watch-heal bug: forgets the pre-outage known-key set, so keys
    that vanished while the client was down never get a synthesized
    delete — the router index keeps dead workers forever."""

    async def _reregister(self) -> None:
        for handle in self._watch_keys:
            self._watch_keys[handle] = set()
        await super()._reregister()


class _RacyDrainTcpServer(EndpointTcpServer):
    """Pre-fix wait_idle: trusts the idle event's wake without
    re-reading the live count — a request admitted between set() and the
    waiter's resumption makes drain report idle with a live stream."""

    async def wait_idle(self, subject: str, timeout: float = 30.0) -> bool:
        if self._inflight.get(subject, 0) <= 0:
            return True
        ev = self._idle_events.setdefault(subject, asyncio.Event())
        ev.clear()
        if self._inflight.get(subject, 0) <= 0:
            return True
        try:
            await asyncio.wait_for(ev.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return self._inflight.get(subject, 0) <= 0


def _make_eager_known_replicator():
    from dynamo_tpu_torch.llm.kv.persist import PersistReplicator

    class _EagerKnownReplicator(PersistReplicator):
        """Publish bug: marks a stem _known before the blob/index
        round-trip lands.  A coordinator crash mid-publish makes the
        replicator skip the stem forever — replicas never converge."""

        async def publish_once(self) -> int:
            n = 0
            for stem, path, hashes, _size in self.store.export_files():
                if stem in self._known:
                    continue
                if await self.coord.kv_get(self._kv_key(stem)) is not None:
                    self._known.add(stem)
                    continue
                data = await asyncio.to_thread(path.read_bytes)
                self._known.add(stem)   # the bug: marked before the upload
                info = await self.coord.blob_put(self._blob_key(stem), data)
                await self.coord.kv_put(self._kv_key(stem), {
                    "stem": stem, "hashes": hashes, "size": len(data),
                    "sha256": info["sha256"],
                })
                n += 1
            return n

    return _EagerKnownReplicator


def _make_stale_gen_replica():
    from dynamo_tpu_torch.llm.kv_router.shards.lifecycle import ShardReplica
    from dynamo_tpu_torch.llm.kv_router.shards.scatter import probe_shard
    from dynamo_tpu_torch.llm.kv_router.shards.wire import (
        decode_scatter_request,
        encode_scatter_reply,
    )

    class _StaleGenShardReplica(ShardReplica):
        """Fence bug: echoes the REQUEST's generation in scatter replies
        instead of the replica's own map generation.  A replica that
        missed a membership change (partition, slow watch) forges
        currency, and its pre-handoff holder data merges into gathers it
        no longer has any right to answer."""

        def _on_scatter(self, subject: str, payload: bytes) -> None:
            try:
                request_id, shard_id, seq_hashes, gen, reply_subject = (
                    decode_scatter_request(payload))
            except Exception:
                return
            reply = probe_shard(self.index.shard(shard_id), shard_id,
                                self.index.n_shards, seq_hashes, gen)
            self._spawn(self.coord.publish(
                reply_subject, encode_scatter_reply(request_id, reply)))

    return _StaleGenShardReplica


_BUG_IMPLS: dict[str, dict[str, Any]] = {
    "reorder-truncate": {"server": _ReorderedTruncateServer},
    "stranded-pull": {"server": _StrandedPullServer},
    "blind-reput": {"client": _BlindReputClient},
    "no-synth-deletes": {"client": _NoSynthDeleteClient},
    "racy-drain": {"tcp_server": _RacyDrainTcpServer},
    "eager-known": {"replicator": _make_eager_known_replicator},
    # kv.stream producer bug: notify the decode worker as soon as the
    # session opens, before a single layer frame lands — the exact
    # notify-races-KV hazard the stream_end ordering contract forbids
    "notify-early": {"stream_notify_early": True},
    # router.shard fence bug: a scatter reply that forges the gather's
    # generation — the resurrected stale-shard-after-handoff class
    "stale-generation": {"shard_replica": _make_stale_gen_replica},
}


# ---------------------------------------------------------------- scenarios


async def _wal_ops(h: Harness, c: CoordinatorClient) -> None:
    async def put(key, val):
        st, _ = await h.op(c.kv_put, key, val)
        h.record_kv(key, st, val)

    await put("cfg/a", 1)
    await put("cfg/b", {"x": 2})
    await put("cfg/a", 3)
    st, _ = await h.op(c.kv_delete, "cfg/b")
    h.record_kv("cfg/b", st, _DEL)
    for p in (b"job-1", b"job-2"):
        st, _ = await h.op(c.queue_push, "work", p)
        h.queue_pushes.append((p, st))
    st, r = await h.op(c.queue_pull, "work", timeout_s=1.0)
    if st == "ok" and r is not None:
        mid, payload = r
        st2, _ = await h.op(c.queue_ack, "work", mid)
        h.queue_acks.append((bytes(payload), st2))
    st, _ = await h.op(c.blob_put, "ckpt/w", b"0123456789" * 40)
    h.blob_expect = ("ckpt/w", st)
    stl, lease = await h.op(c.lease_create, 5.0, True)
    if stl == "ok":
        st, _ = await h.op(c.kv_put, "inst/w0", {"port": 1}, lease)
        h.leased_keys.add("inst/w0")


async def _run_coord_wal(h: Harness) -> None:
    srv, ok = await h.start_coordinator(durable=True)
    c = None
    if ok:
        c = await h.client()
        await _wal_ops(h, c)
    # scripted restart: every run exercises recovery, and under a crash
    # plan the recovery compaction itself is in the crash matrix
    h.kill_current(srv)
    ok2 = False
    for _ in range(2):
        srv2, ok2 = await h.start_coordinator(durable=True,
                                              port=h.coord_port)
        if ok2:
            break
    h.check("recovery_restarts", ok2,
            "coordinator failed to restart after crash")
    if ok2 and c is not None:
        # a call racing the client's discovery of the dropped conn can
        # legitimately fail (maybe-applied); liveness only demands that
        # a RETRIED call eventually lands on the recovered server
        pre_fired = h.crash_fired
        st = "lost"
        for _attempt in range(3):
            st, _ = await h.op(c.kv_put, "post/recovery", "alive")
            if st == "ok":
                break
            await asyncio.sleep(2.0)
        h.record_kv("post/recovery", st, "alive")
        # a crash plan that fires in THIS epoch killed the recovered
        # server out from under the probe — durability checks still
        # apply, liveness legitimately can't
        late_crash = h.crash_fired and not pre_fired
        h.check("post_recovery_liveness", st == "ok" or late_crash,
                f"put after recovery did not complete: {st}")
    await h.teardown()


def _offline_state(h: Harness) -> dict:
    """Replay the on-disk WAL in a fresh process model (no event loop —
    ``_recover`` is synchronous) and snapshot the recovered state."""
    srv = CoordinatorServer(data_dir=str(h.data_dir))
    srv._recover()
    state = {
        "kv": dict(srv._kv),
        "queues": {
            q: sorted((it.msg_id, it.payload.decode("latin1"))
                      for it in dq)
            for q, dq in srv._queues.items() if dq
        },
        "blobs": {name: rec.get("sha256")
                  for name, rec in srv._blobs.items()},
        "kv_lease": dict(srv._kv_lease),
    }
    if srv._wal is not None:
        srv._wal.close()
        srv._wal = None
    return state


def _post_coord_wal(h: Harness) -> None:
    path = h.data_dir / "wal.jsonl"
    if not path.exists():
        h.check("wal_version_head", False, "wal.jsonl missing after run")
        return
    s1 = _offline_state(h)
    try:
        first = path.read_text().splitlines()[0]
        head_ok = json.loads(first).get("t") == "ver"
    except (IndexError, json.JSONDecodeError):
        head_ok = False
    h.check("wal_version_head", head_ok,
            "compacted WAL does not start with a version record")
    s2 = _offline_state(h)
    h.check("wal_replay_idempotent", s1 == s2,
            "recovering twice from the same WAL produced different state")
    # acked-durable: proc crashes keep flushed bytes; power/torn only
    # promise the fsynced prefix, so kv/blob checks weaken to prefix
    # consistency there (queue records are fsynced — always strong)
    weak = h.crash is not None and h.crash.mode in ("power", "torn")
    for key in h.kv_ops:
        observed = (_ABSENT if key not in s1["kv"]
                    else Harness._canon(s1["kv"][key]))
        allowed = h.kv_allowed(key, weak=weak)
        h.check("kv_acked_durable", observed in allowed,
                f"{key} recovered as {observed}, allowed {sorted(allowed)}")
    counts: dict[str, int] = {}
    for items in s1["queues"].values():
        for _mid, p in items:
            counts[p] = counts.get(p, 0) + 1
    acked_ok = {p for p, st in h.queue_acks if st == "ok"}
    ack_tried = {p for p, _st in h.queue_acks}
    for p, st in h.queue_pushes:
        key = p.decode("latin1")
        n = counts.get(key, 0)
        if p in acked_ok:
            h.check("queue_acked_consumed", n == 0,
                    f"acked message {key} redelivered after recovery")
        elif st == "ok" and p not in ack_tried:
            h.check("queue_acked_durable", n == 1,
                    f"acked push {key} appears {n} times after recovery")
        else:
            h.check("queue_no_duplicates", n <= 1,
                    f"message {key} duplicated ({n}x) after recovery")
    if h.blob_expect is not None and not weak:
        name, st = h.blob_expect
        if st == "ok":
            h.check("blob_acked_durable", name in s1["blobs"],
                    f"acked blob {name} missing after recovery")
    for k in h.leased_keys:
        h.check("leased_keys_ephemeral",
                k not in s1["kv"] and k not in s1["kv_lease"],
                f"lease-bound key {k} survived a restart")


async def _run_coord_reconnect(h: Harness) -> None:
    srv, ok = await h.start_coordinator(durable=False)
    if not ok:
        await h.teardown()
        return
    a = await h.client()
    stl, la = await h.op(a.lease_create, 3.0, True)
    sta, _ = await h.op(a.kv_create, "slot/leader", "A", la)
    stw, _ = await h.op(a.watch, "slot/", lambda e, k, v: None)
    # restart; a rival claims the slot while A's reconnect races it
    h.kill_current(srv)
    srv2, ok2 = await h.start_coordinator(durable=False,
                                          port=h.coord_port)
    h.check("recovery_restarts", ok2, "restart failed")
    createdb = None
    b = None
    if ok2:
        b = await h.client()
        stlb, lb = await h.op(b.lease_create, 3.0, True)
        stb, createdb = await h.op(b.kv_create, "slot/leader", "B", lb)
        if stb != "ok":
            createdb = None
    await asyncio.sleep(8.0)   # heals land, loser's unused leases expire
    if ok2 and b is not None:
        stv, val = await h.op(b.kv_get, "slot/leader")
        if stv == "ok" and createdb is not None:
            # B won the create -> A must cede; B lost it -> A re-claimed
            want = "B" if createdb else "A"
            h.check("exactly_one_owner", val == want,
                    f"slot/leader={val!r} but rival create returned "
                    f"{createdb} (expected {want!r})")
        # reconnect must not double-register: A holds exactly one watch
        n_watches = len(srv2._watches)
        h.check("reregister_idempotent", n_watches <= 1,
                f"{n_watches} live watches after one client's heal")
        for k, lid in srv2._kv_lease.items():
            h.check("no_orphan_lease_keys", lid in srv2._leases,
                    f"key {k} bound to dead lease {lid}")
    await h.teardown()


async def _run_coord_queue(h: Harness) -> None:
    srv, ok = await h.start_coordinator(durable=False)
    if not ok:
        await h.teardown()
        return
    prod = await h.client()
    cons = await h.client()
    pushed = [f"task-{i}".encode() for i in range(4)]
    got: set[bytes] = set()
    unacked: set[bytes] = set()   # deliveries whose ack was lost

    async def take(r) -> None:
        mid, payload = r
        p = bytes(payload)
        got.add(p)
        try:
            await cons.queue_ack("jobs", mid)
            unacked.discard(p)
        except (ConnectionError, OSError, RuntimeError):
            unacked.add(p)   # at-least-once: redelivery is legal

    async def consume() -> None:
        # park a long-poll pull in the server BEFORE anything is pushed,
        # then touch the connection again (ping) so a frame-triggered
        # sever can kill the conn while the pull waits in the queue —
        # the stranded-delivery window the conn-drop sweep must cover
        first = asyncio.ensure_future(cons.queue_pull("jobs",
                                                      timeout_s=30.0))
        await asyncio.sleep(0.05)
        try:
            await cons.ping()
        except (ConnectionError, OSError, RuntimeError):
            pass
        try:
            r = await asyncio.wait_for(first, 35.0)
            if r is not None:
                await take(r)
        except (ConnectionError, OSError, RuntimeError,
                asyncio.TimeoutError):
            pass
        misses = 0
        while len(got) < len(pushed) and misses < 6:
            try:
                r = await cons.queue_pull("jobs", timeout_s=1.0)
            except (ConnectionError, OSError, RuntimeError):
                await asyncio.sleep(0.3)
                continue
            if r is None:
                misses += 1
                continue
            await take(r)
        # sweep redelivered copies of lost acks so a clean protocol
        # quiesces to an empty queue
        for _ in range(4):
            try:
                r = await cons.queue_pull("jobs", timeout_s=0.5)
            except (ConnectionError, OSError, RuntimeError):
                break
            if r is None:
                break
            await take(r)

    t = asyncio.ensure_future(consume())
    await asyncio.sleep(0.2)   # let the long poll park first
    for p in pushed:
        await h.op(prod.queue_push, "jobs", p)
    try:
        await asyncio.wait_for(t, 120.0)
        h.check("consumer_terminates", True)
    except asyncio.TimeoutError:
        t.cancel()
        h.check("consumer_terminates", False,
                "consumer loop did not finish within its budget")
    await asyncio.sleep(2.0)
    h.check("queue_no_lost", got == set(pushed),
            f"pushed {sorted(p.decode() for p in pushed)} but consumed "
            f"{sorted(p.decode() for p in got)}")
    stranded = [bytes(it.payload)
                for it in srv._pending_acks.values()]
    stranded += [bytes(it.payload)
                 for dq in srv._queues.values() for it in dq]
    # a delivery whose ack the fault ate may legally sit requeued at
    # quiescence; anything else stranded is a lost-delivery bug
    orphans = [p for p in stranded if p not in unacked]
    h.check("queue_drained", not orphans,
            f"{len(orphans)} item(s) stranded at quiescence: "
            f"{sorted(p.decode() for p in orphans)}")
    await h.teardown()


async def _run_router_index(h: Harness) -> None:
    srv, ok = await h.start_coordinator(durable=False)
    if not ok:
        await h.teardown()
        return
    router = await h.client()
    index: dict[str, Any] = {}

    def on_event(event: str, key: str, value: Any) -> None:
        if event == "put":
            index[key] = value
        else:
            index.pop(key, None)

    await h.op(router.watch, "inst/", on_event)
    workers = []
    for i in (1, 2):
        w = await h.client()
        stl, lw = await h.op(w.lease_create, 5.0, True)
        await h.op(w.kv_put, f"inst/{i}", {"port": 9000 + i}, lw)
        workers.append(w)
    await asyncio.sleep(1.0)
    # restart storm: the coordinator dies; worker 2 dies during the
    # outage and never comes back
    h.kill_current(srv)
    try:
        await asyncio.wait_for(workers[1].close(), 10.0)
    except (asyncio.TimeoutError, ConnectionError, OSError):
        pass
    srv2, ok2 = await h.start_coordinator(durable=False,
                                          port=h.coord_port)
    h.check("recovery_restarts", ok2, "restart failed")
    await asyncio.sleep(10.0)   # reconnect heals + lease expiry settle
    if ok2:
        truth = {k: v for k, v in srv2._kv.items()
                 if k.startswith("inst/")}
        h.check("router_index_matches", index == truth,
                f"router index {sorted(index)} != server truth "
                f"{sorted(truth)} at quiescence")
        h.check("router_converges", "inst/1" in index,
                "surviving worker missing from the healed index")
    await h.teardown()


class _SlowEngine:
    """Tiny AsyncEngine: yields its items across scheduling points
    (zero-length sleeps), so in-flight requests overlap the drain window
    and the interleaving is entirely the scheduler's choice."""

    def __init__(self, items: int = 2, delay: float = 0.0):
        self.items = items
        self.delay = delay

    async def generate(self, ctx):
        for i in range(self.items):
            await asyncio.sleep(self.delay)
            yield {"i": i}


async def _run_tcp_drain(h: Harness) -> None:
    from dynamo_tpu_torch.runtime.engine import Context

    cls = h.pick("tcp_server", EndpointTcpServer)
    tsrv = cls(net=h.net)
    await tsrv.start()
    h.net.name_port(tsrv.port, "endpoint")
    tsrv.register("gen", _SlowEngine())
    clients = [EndpointTcpClient("mem", tsrv.port, "gen", net=h.net)
               for _ in range(2)]

    async def pump(cli, n: int) -> None:
        # back-to-back requests on one conn: the next request frame is
        # already in the server's read buffer when the previous stream
        # ends, so admissions race the idle-event wake
        for i in range(n):
            async for _item in cli.generate(Context({"i": i})):
                pass

    async def drainer() -> None:
        # everything runs at virtual t=0 (zero-length sleeps), so join
        # mid-traffic by spinning scheduling points, not by sleeping;
        # sample the drain repeatedly — every idle transition during the
        # burst is a chance for a racy wait_idle to vouch for a live one
        rounds = 0
        while not h.notes.get("traffic_done") and rounds < 12:
            rounds += 1
            for _ in range(200):
                if (tsrv._inflight.get("gen", 0) > 0
                        or h.notes.get("traffic_done")):
                    break
                await asyncio.sleep(0)
            if h.notes.get("traffic_done"):
                break
            okd = await tsrv.wait_idle("gen", timeout=120.0)
            # no await between wait_idle's return and this read: the
            # count IS the one the return value vouched for
            live = tsrv._inflight.get("gen", 0)
            h.check("drain_zero_inflight", not okd or live <= 0,
                    f"wait_idle returned True with {live} stream(s) "
                    "live")
        h.notes["drain_done"] = True

    async def traffic() -> None:
        await asyncio.gather(pump(clients[0], 4), pump(clients[1], 4))
        h.notes["traffic_done"] = True

    await asyncio.gather(traffic(), drainer())
    h.check("drain_terminates", h.notes.get("drain_done", False),
            "wait_idle never returned")
    for cli in clients:
        try:
            await asyncio.wait_for(cli.close(), 10.0)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
    await tsrv.stop()
    await h.teardown()


async def _run_kv_persist(h: Harness) -> None:
    import torch

    from dynamo_tpu_torch.llm.kv.persist import (
        PersistentKvStore,
        PersistReplicator,
    )

    srv, ok = await h.start_coordinator(durable=True)
    if not ok:
        srv, ok = await h.start_coordinator(durable=True)
        if not ok:
            await h.teardown()
            return
    c_a = await h.client()
    c_b = await h.client()
    store_a = PersistentKvStore(h.root / "nodeA", "gen1")
    await asyncio.to_thread(
        store_a.spill, [101, 102],
        torch.arange(8, dtype=torch.float32).reshape(2, 4))
    await asyncio.to_thread(
        store_a.spill, [103, 104],
        torch.arange(8, 16, dtype=torch.float32).reshape(2, 4))
    repl_cls = h.pick("replicator", None)
    repl_cls = repl_cls() if callable(repl_cls) and repl_cls is not None \
        else PersistReplicator
    ra = repl_cls(c_a, store_a, namespace="ns")
    await h.op(ra.publish_once)
    if h.crash_fired:
        ok2 = False
        for _ in range(2):
            srv2, ok2 = await h.start_coordinator(durable=True,
                                                  port=h.coord_port)
            if ok2:
                break
        h.check("recovery_restarts", ok2, "restart after crash failed")
        await h.op(ra.publish_once)   # heal: republish what the crash ate
    store_b = PersistentKvStore(h.root / "nodeB", "gen1")
    rb = PersistReplicator(c_b, store_b, namespace="ns")
    await h.op(rb.pull_once)
    h.check("persist_converges",
            set(store_b._files) == set(store_a._files),
            f"replica B has {sorted(store_b._files)}, "
            f"A has {sorted(store_a._files)}")
    h.check("persist_no_duplicate_blocks",
            store_b.resident_blocks == len(set(store_b.resident_hashes())),
            "replica B indexed a block twice")
    h.check("persist_sha_verified", store_b.invalid_files == 0,
            f"{store_b.invalid_files} corrupt file(s) imported")
    store_a.close()
    store_b.close()
    await h.teardown()


async def _run_kv_stream(h: Harness) -> None:
    """Streamed layer-wise KV handoff (llm/kv/stream.py) under the sever
    matrix: a two-chunk/two-layer session on conn 1, with the prefill
    worker's fallback ladder (reconnect + whole-cache push + notify) on
    any stream failure, plus a deliberately torn completion every run.
    Invariant: the decode side either applies a sha-verified COMPLETE
    cache or nothing — and notify never precedes the applied KV."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.llm.kv.stream import KvStreamSession
    from dynamo_tpu_torch.llm.kv.transfer import KvTransferClient, KvTransferServer

    ops: list[tuple] = []

    async def sink(ids, arr, rid) -> None:
        ops.append(("apply", rid, [int(b) for b in ids],
                    torch.as_tensor(arr).clone()))

    async def notify(rid, first_token, error) -> None:
        ops.append(("notify", rid, int(first_token), error))

    srv = KvTransferServer(write_sink=sink, notify_cb=notify,
                           host="mem", net=h.net)
    await srv.start()
    h.net.name_port(srv.port, "kvxfer")
    url = f"tcp://mem:{srv.port}"

    rng = np.random.default_rng(7)
    chunks = [torch.from_numpy(rng.standard_normal((2, 2, 3)).astype(np.float32))
              for _ in range(2)]           # 2 chunks of [L=2, n=2, 3]
    full = torch.cat(chunks, dim=1)        # [L=2, n=4, 3]
    spans = [[0, 1], [2, 3]]

    async def close_quiet(cli) -> None:
        try:
            await asyncio.wait_for(cli.close(), 10.0)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass

    notify_early = h.pick("stream_notify_early", False)

    async def streamed() -> bool:
        cli = await KvTransferClient.connect(url, net=h.net,
                                             force_tcp=True)
        try:
            sess = KvStreamSession(cli, "r1", num_layers=2,
                                   session_id="s-r1")
            await sess.begin()
            if notify_early:
                await cli.notify("r1", 7)
            for ids, arr in zip(spans, chunks):
                await sess.write_chunk(ids, arr, compute_live=True)
            await sess.end()
            if not notify_early:
                await cli.notify("r1", 7)
            return True
        except (ConnectionError, RuntimeError, OSError,
                asyncio.TimeoutError):
            return False
        finally:
            await close_quiet(cli)

    if not await streamed():
        # fallback ladder, exactly as llm/workers.py runs it: fresh
        # connection (the severed one is dead), whole-cache push, notify
        cli = await KvTransferClient.connect(url, net=h.net,
                                             force_tcp=True)
        try:
            await cli.write_blocks([0, 1, 2, 3], full, request_id="r1")
            await cli.notify("r1", 7)
        finally:
            await close_quiet(cli)

    # deliberately torn completion, every run: right frames, wrong sha —
    # the END must be rejected and NOTHING applied for r2
    torn_rejected = False
    cli2 = await KvTransferClient.connect(url, net=h.net, force_tcp=True)
    try:
        sess2 = KvStreamSession(cli2, "r2", num_layers=2,
                                session_id="s-r2")
        await sess2.begin()
        await sess2.write_chunk(spans[0], chunks[0], compute_live=False)
        try:
            await cli2.stream_end(
                {"session": "s-r2", "frames": 2, "sha": "0" * 64})
        except RuntimeError:
            torn_rejected = True
    finally:
        await close_quiet(cli2)

    applies = [o for o in ops if o[0] == "apply" and o[1] == "r1"]
    h.check("stream_no_partial_admit",
            all(o[2] == [0, 1, 2, 3] and torch.equal(o[3], full)
                for o in applies),
            "decode admitted partial or wrong KV")
    h.check("stream_delivered", len(applies) >= 1,
            "no complete cache ever applied (stream AND fallback lost)")
    first_apply = next((i for i, o in enumerate(ops)
                        if o[0] == "apply" and o[1] == "r1"), None)
    notifies = [i for i, o in enumerate(ops)
                if o[0] == "notify" and o[1] == "r1"]
    h.check("stream_notify_ordered",
            bool(notifies) and first_apply is not None
            and first_apply < notifies[0],
            "notify raced ahead of the applied KV")
    h.check("stream_torn_is_miss",
            torn_rejected and not any(
                o[0] == "apply" and o[1] == "r2" for o in ops),
            "torn completion frame was admitted")
    await srv.stop()
    await h.teardown()


async def _run_router_shard(h: Harness) -> None:
    """Sharded control plane (llm/kv_router/shards) under membership
    churn on the real coordinator pub/sub plane: two replicas host a
    4-shard partition fed from the live KV event stream; a third joins
    (index handoff with generation fence), then one replica is
    half-partitioned (serves scatters, sees neither events nor
    membership) and declared dead.  Safety: a gather never merges a
    reply whose generation it did not ask for, so scores never exceed
    the singleton truth index — the stale-generation bug variant breaks
    exactly this.  Liveness: a gather with missing shards still
    completes, degraded."""
    from dynamo_tpu_torch.llm.kv.events import (
        KvRemovedEvent,
        KvStoredEvent,
        event_to_wire,
    )
    from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
    from dynamo_tpu_torch.llm.kv_router.shards import (
        PubSubShardClient,
        ShardReplica,
        gather_overlaps,
        shard_of,
    )
    from dynamo_tpu_torch.tokens import sequence_hashes

    replica_cls = h.pick("shard_replica", None)
    replica_cls = replica_cls() if callable(replica_cls) \
        and replica_cls is not None else ShardReplica

    srv, ok = await h.start_coordinator(durable=False)
    if not ok:
        await h.teardown()
        return
    n_shards = 4
    clean = h.fault is None
    ev_subject = "ns.kv_events.w"
    net_errs = (ConnectionError, OSError, RuntimeError,
                asyncio.TimeoutError)

    async def up(replica: "ShardReplica") -> bool:
        try:
            await replica.start()
            await replica.subscribe_events(ev_subject)
            return True
        except net_errs:
            return False

    ca, cb, cg = await h.client(), await h.client(), await h.client()
    ra = replica_cls(ca, "ra", n_shards, namespace="ns")
    rb = replica_cls(cb, "rb", n_shards, namespace="ns")
    ra_ok, rb_ok = await up(ra), await up(rb)
    await asyncio.sleep(1.0)
    if clean:
        h.check("shard_replicas_start", ra_ok and rb_ok,
                "replica registration failed on a fault-free run")
        h.check("shard_maps_converge",
                ra.map.generation == rb.map.generation
                and ra.map.owners == rb.map.owners,
                f"maps diverge: ra gen {ra.map.generation} owners "
                f"{ra.map.owners} vs rb gen {rb.map.generation} owners "
                f"{rb.map.owners}")

    # worker KV events on the live plane: w1 and w2 share a 3-block
    # prefix, w1 continues for 3 more blocks; truth is a singleton
    # KvIndexer fed the same logical events directly
    truth = KvIndexer(use_native=False)
    seq1 = sequence_hashes(list(range(1, 97)), 16)               # 6 blocks
    seq2 = sequence_hashes(
        list(range(1, 49)) + list(range(1000, 1048)), 16)        # 3+3 blocks
    eid = 0
    for wid, hashes in ((1, seq1), (2, seq2)):
        ev = KvStoredEvent(block_hashes=list(hashes))
        truth.apply_event(wid, ev)
        eid += 1
        st, _ = await h.op(cg.publish, ev_subject,
                           event_to_wire(eid, wid, ev))
    await asyncio.sleep(1.0)

    query = list(seq1)
    probes = []
    for s in range(n_shards):
        cli = PubSubShardClient(cg, "ns", s, "g")
        try:
            await cli.start()
        except net_errs:
            pass          # probes through a dead inbox just time out
        probes.append(cli)

    async def scatter(generation: int) -> dict:
        async def one(cli):
            try:
                return await asyncio.wait_for(
                    cli.probe(query, generation), 5.0)
            except net_errs:
                return None
        results = await asyncio.gather(*(one(c) for c in probes))
        return dict(enumerate(results))

    def overcount(scores, ref) -> str:
        bad = [(w, s, ref.scores.get(w, 0))
               for w, s in scores.scores.items()
               if s > ref.scores.get(w, 0)]
        bad += [(w, s, ref.persist_scores.get(w, 0))
                for w, s in scores.persist_scores.items()
                if s > ref.persist_scores.get(w, 0)]
        return ", ".join(f"w{w}: {s} > truth {t}" for w, s, t in bad)

    tr = truth.find_matches(query)
    gen1 = ra.map.generation
    scores1, partial1 = gather_overlaps(query, n_shards,
                                        await scatter(gen1), gen1)
    if clean:
        h.check("shard_gather_matches_truth",
                not partial1 and scores1.scores == tr.scores
                and scores1.persist_scores == tr.persist_scores,
                f"clean gather {scores1.scores} (partial={partial1}) != "
                f"singleton truth {tr.scores}")

    # third replica joins: the ranges it inherits predate its event
    # subscription, so every byte it serves for them arrived via the
    # handoff frames its join triggered
    cc = await h.client()
    rc = replica_cls(cc, "rc", n_shards, namespace="ns")
    rc_ok = await up(rc)
    await asyncio.sleep(2.0)
    gen2 = ra.map.generation
    if clean:
        h.check("shard_maps_converge",
                rc_ok and ra.map.owners == rb.map.owners == rc.map.owners
                and ra.map.generation == rb.map.generation
                == rc.map.generation,
                "maps did not reconverge after a join")
        scores2, partial2 = gather_overlaps(query, n_shards,
                                            await scatter(gen2), gen2)
        h.check("shard_handoff_delivers",
                not partial2 and scores2.scores == tr.scores,
                f"post-join gather {scores2.scores} (partial={partial2}) "
                f"!= truth {tr.scores} — moved ranges lost in handoff")

    # half-partition the replica owning the query's 4th position: its
    # scatter subscriptions stay live (it still answers probes) but it
    # sees neither further events nor the membership change that
    # declares it dead — the stale-shard-after-handoff surface
    by_id = {"ra": ra, "rb": rb, "rc": rc}
    victim = by_id.get(
        ra.map.owner(shard_of(query[3], n_shards))) or rb
    if victim._ev_sub is not None:
        await h.op(victim.coord.unsubscribe, victim._ev_sub)
        victim._ev_sub = None
    if victim._watch_id is not None:
        await h.op(victim.coord.unwatch, victim._watch_id)
        victim._watch_id = None
    if victim._lease is not None:
        await h.op(victim.coord.lease_revoke, victim._lease)
        victim._lease = None
    await asyncio.sleep(2.0)
    survivors = [r for r in (ra, rb, rc) if r is not victim]
    gen3 = survivors[0].map.generation
    if clean:
        h.check("shard_rebind_after_death", gen3 != gen2,
                "membership delete did not rebind the survivors")

    # the dead replica's blocks age out of the workers: w1 evicts its
    # tail — the removal reaches the survivors but NOT the partitioned
    # victim, whose frozen index now overstates w1
    rm = KvRemovedEvent(block_hashes=list(seq1[3:]))
    truth.apply_event(1, rm)
    eid += 1
    await h.op(cg.publish, ev_subject, event_to_wire(eid, 1, rm))
    await asyncio.sleep(1.0)
    tr3 = truth.find_matches(query)
    scores3, _partial3 = gather_overlaps(query, n_shards,
                                         await scatter(gen3), gen3)
    if clean:
        # the victim still answers its old shards with its old
        # generation; the fence must keep that data out of the merge
        h.check("shard_no_stale_overcount",
                not overcount(scores3, tr3),
                f"stale shard data merged past the fence: "
                f"{overcount(scores3, tr3)}")

    # total outage: with every replica stopped, the scatter times out
    # shard by shard and the gather still completes, fully degraded
    for r in (ra, rb, rc):
        try:
            await asyncio.wait_for(r.stop(), 10.0)
        except net_errs:
            pass
    scores4, partial4 = gather_overlaps(query, n_shards,
                                        await scatter(gen3), gen3)
    h.check("shard_gather_completes_degraded",
            partial4 and not overcount(scores4, tr3),
            f"all-shards-down gather: partial={partial4}, "
            f"scores={scores4.scores}")
    for cli in probes:
        try:
            await asyncio.wait_for(cli.stop(), 10.0)
        except net_errs:
            pass
    await h.teardown()


# ----------------------------------------------------------- crash matrices


def _occurrences(label: str, count: int, budget: int) -> list[int]:
    if label.startswith(("wal.compact.", "bug.")):
        # first AND last firing: the last compaction runs against the
        # populated recovery WAL — the interesting window
        return sorted({0, count - 1})
    return list(range(min(count, budget)))


def _wal_plans(base: "RunResult", budget: int) -> list[CrashPlan]:
    plans: list[CrashPlan] = []
    for label in sorted(base.census):
        count = base.census[label]
        if label.startswith(("wal.", "bug.")):
            modes = (("proc", "power", "torn")
                     if label.startswith("wal.append.") else ("proc",))
            for occ in _occurrences(label, count, budget):
                for mode in modes:
                    plans.append(CrashPlan("crash", label, occ, mode))
        elif label == "frame.send.reply":
            for occ in range(min(count, budget)):
                plans.append(CrashPlan("crash", label, occ, "proc"))
    return plans


def _queue_plans(base: "RunResult", budget: int) -> list[CrashPlan]:
    # sever the CONSUMER's transport at each of its first k complete
    # frames, both directions (conn 2: clients dial in order, producer
    # first) — the s2c cut at the ping reply kills the conn while the
    # long-poll pull is parked in the server
    plans = []
    for direction in ("s2c", "c2s"):
        frames = base.frame_counts.get(f"coord/2/{direction}", 0)
        cap = min(frames, 3 * budget)
        plans.extend(
            CrashPlan(kind="sever", conn=2, after_frames=k + 1,
                      direction=direction)
            for k in range(cap))
    return plans


def _stream_plans(base: "RunResult", budget: int) -> list[CrashPlan]:
    # sever the streaming connection (conn 1: the producer dials first)
    # at every complete frame, both directions — each c2s cut lands at a
    # different layer-frame boundary of the session, each s2c cut drops
    # a different ack/reply, so the matrix covers "torn at layer k" for
    # every k plus "END applied but ack lost"
    plans: list[CrashPlan] = []
    for direction in ("s2c", "c2s"):
        frames = base.frame_counts.get(f"kvxfer/1/{direction}", 0)
        cap = min(frames, 6 * budget)
        plans.extend(
            CrashPlan(kind="sever", conn=1, after_frames=k + 1,
                      direction=direction)
            for k in range(cap))
    return plans


def _shard_plans(base: "RunResult", budget: int) -> list[CrashPlan]:
    # sever a replica's conn (2: clients dial ra, rb, gatherer, rc) and
    # the gatherer's (3) at spread frame offsets, both directions —
    # replica death lands mid-scatter, mid-handoff and mid-membership
    # depending on the offset; the gatherer cut exercises partial
    # gathers and probe-publish failures
    plans: list[CrashPlan] = []
    for conn in (2, 3):
        for direction in ("s2c", "c2s"):
            frames = base.frame_counts.get(f"coord/{conn}/{direction}", 0)
            if not frames:
                continue
            cap = min(frames, 3 * budget)
            cuts = sorted({max(1, (k + 1) * frames // (cap + 1))
                           for k in range(cap)})
            plans.extend(
                CrashPlan(kind="sever", conn=conn, after_frames=n,
                          direction=direction)
                for n in cuts)
    return plans


def _persist_plans(base: "RunResult", budget: int) -> list[CrashPlan]:
    plans: list[CrashPlan] = []
    for label in sorted(base.census):
        if label in ("wal.append.blob", "wal.append.kv",
                     "frame.send.reply"):
            for occ in range(min(base.census[label], budget)):
                plans.append(CrashPlan("crash", label, occ, "proc"))
    return plans


@dataclass(frozen=True)
class Scenario:
    name: str
    run: Callable
    invariants: tuple[str, ...]
    touches: tuple[str, ...]
    post_check: Optional[Callable] = None
    plans: Optional[Callable] = None
    seeds: int = 3


SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in [
        Scenario(
            name="coord.wal",
            run=_run_coord_wal,
            post_check=_post_coord_wal,
            plans=_wal_plans,
            seeds=3,
            invariants=(
                "recovery_restarts", "post_recovery_liveness",
                "wal_replay_idempotent", "wal_version_head",
                "kv_acked_durable", "queue_acked_durable",
                "queue_acked_consumed", "queue_no_duplicates",
                "blob_acked_durable", "leased_keys_ephemeral",
            ),
            touches=("dynamo_tpu_torch/runtime/transports/coordinator",
                     "dynamo_tpu_torch/runtime/transports/framing",
                     "dynamo_tpu_torch/runtime/transports/protocol",
                     "dynamo_tpu_torch/runtime/transports/net"),
        ),
        Scenario(
            name="coord.reconnect",
            run=_run_coord_reconnect,
            seeds=4,
            invariants=("recovery_restarts", "exactly_one_owner",
                        "reregister_idempotent", "no_orphan_lease_keys"),
            touches=("dynamo_tpu_torch/runtime/transports/coordinator",
                     "dynamo_tpu_torch/runtime/transports/protocol"),
        ),
        Scenario(
            name="coord.queue",
            run=_run_coord_queue,
            plans=_queue_plans,
            seeds=3,
            invariants=("queue_no_lost", "queue_drained",
                        "consumer_terminates"),
            touches=("dynamo_tpu_torch/runtime/transports/coordinator",
                     "dynamo_tpu_torch/runtime/transports/protocol",
                     "dynamo_tpu_torch/fault/"),
        ),
        Scenario(
            name="router.index",
            run=_run_router_index,
            seeds=2,
            invariants=("recovery_restarts", "router_index_matches",
                        "router_converges"),
            touches=("dynamo_tpu_torch/runtime/transports/coordinator",
                     "dynamo_tpu_torch/runtime/distributed"),
        ),
        Scenario(
            name="tcp.drain",
            run=_run_tcp_drain,
            seeds=6,
            invariants=("drain_zero_inflight", "drain_terminates"),
            touches=("dynamo_tpu_torch/runtime/transports/tcp",
                     "dynamo_tpu_torch/runtime/distributed",
                     "dynamo_tpu_torch/fault/"),
        ),
        Scenario(
            name="kv.persist",
            run=_run_kv_persist,
            plans=_persist_plans,
            seeds=2,
            invariants=("recovery_restarts", "persist_converges",
                        "persist_no_duplicate_blocks",
                        "persist_sha_verified"),
            touches=("dynamo_tpu_torch/llm/kv/persist",
                     "dynamo_tpu_torch/runtime/transports/coordinator"),
        ),
        Scenario(
            name="kv.stream",
            run=_run_kv_stream,
            plans=_stream_plans,
            seeds=3,
            invariants=("stream_no_partial_admit", "stream_delivered",
                        "stream_torn_is_miss", "stream_notify_ordered"),
            touches=("dynamo_tpu_torch/llm/kv/stream",
                     "dynamo_tpu_torch/llm/kv/transfer",
                     "dynamo_tpu_torch/runtime/transports/framing",
                     "dynamo_tpu_torch/runtime/transports/protocol"),
        ),
        Scenario(
            name="router.shard",
            run=_run_router_shard,
            plans=_shard_plans,
            seeds=3,
            invariants=("shard_replicas_start", "shard_maps_converge",
                        "shard_gather_matches_truth",
                        "shard_handoff_delivers",
                        "shard_rebind_after_death",
                        "shard_no_stale_overcount",
                        "shard_gather_completes_degraded"),
            touches=("dynamo_tpu_torch/llm/kv_router/shards",
                     "dynamo_tpu_torch/llm/kv_router/indexer",
                     "dynamo_tpu_torch/utils/chash",
                     "dynamo_tpu_torch/runtime/transports/coordinator"),
        ),
    ]
}


# ------------------------------------------------------------------ runner


@dataclass
class RunResult:
    scenario: str
    seed: int
    crash: Optional[CrashPlan]
    bug: Optional[str]
    outcome: str = "ok"
    error: str = ""
    violations: list = field(default_factory=list)
    trace: list = field(default_factory=list)
    choices: list = field(default_factory=list)
    census: dict = field(default_factory=dict)
    channels: dict = field(default_factory=dict)
    frame_counts: dict = field(default_factory=dict)
    token: str = ""


def _op_of(header: dict) -> str:
    return header.get("op") or header.get("type") or "reply"


def run_one(scenario: Scenario, seed: int, *,
            crash: Optional[CrashPlan] = None, bug: Optional[str] = None,
            forced: Optional[list[int]] = None) -> RunResult:
    """One deterministic execution of a scenario: seeded schedule,
    optional crash/sever plan, optional bug variant, optional forced
    choice list (replay)."""
    tmp = Path(tempfile.mkdtemp(prefix="dtproto-"))
    loop = DetLoop(make_scheduler(seed), forced_choices=forced)
    net = MemNet(loop)
    h = Harness(loop, net, tmp, bug=bug, crash=crash)
    outcome, err = "ok", ""
    # modeled deaths routinely fail background tasks; keep the noise out
    # of stderr (the loop collects exception contexts instead)
    loggers = [logging.getLogger("dynamo_tpu_torch"),
               logging.getLogger("dynamo_tpu_torch.fault")]
    saved_levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.CRITICAL)
    try:
        try:
            from dynamo_tpu_torch.analysis.detloop import run_deterministic

            run_deterministic(loop, scenario.run(h))
        except DeadlockError as e:
            outcome, err = "deadlock", str(e)
        except HorizonExceeded as e:
            outcome, err = "horizon", str(e)
        except ReplayMismatch as e:
            outcome, err = "replay-mismatch", str(e)
        except SimulatedCrash as e:
            # a crash unwound into the scenario coroutine itself (death during a
            # scripted start the scenario chose not to retry) — the
            # post-run recovery checks still judge the disk state
            err = str(e)
        finally:
            loop.close()
        if scenario.post_check is not None:
            scenario.post_check(h)
    finally:
        for lg, lvl in zip(loggers, saved_levels):
            lg.setLevel(lvl)
        shutil.rmtree(tmp, ignore_errors=True)
    channels = {}
    for (svc, direction), headers in net.channel_frames().items():
        channels[f"{svc}:{direction}"] = [_op_of(hd) for hd in headers]
    frame_counts = {
        f"{net.port_names.get(port, f'port{port}')}/{conn}/{direction}":
            ctr.count
        for (port, conn, direction), ctr in sorted(net._counters.items())
    }
    payload: dict[str, Any] = {"scenario": scenario.name, "seed": seed,
                               "choices": list(loop.choices)}
    if bug:
        payload["bug"] = bug
    if crash:
        payload["crash"] = asdict(crash)
    return RunResult(
        scenario=scenario.name, seed=seed, crash=crash, bug=bug,
        outcome=outcome, error=err, violations=list(h.violations),
        trace=list(loop.trace), choices=list(loop.choices),
        census=dict(h.crash_census), channels=channels,
        frame_counts=frame_counts, token=encode_token(payload),
    )


def replay_token(token: str) -> RunResult:
    """Re-execute the exact interleaving a replay token encodes."""
    payload = decode_token(token)
    scenario = SCENARIOS[payload["scenario"]]
    return run_one(
        scenario, payload["seed"],
        crash=CrashPlan.from_json(payload.get("crash")),
        bug=payload.get("bug"),
        forced=list(payload.get("choices", [])),
    )


# -------------------------------------------------------------- exploration


@dataclass
class ScenarioReport:
    scenario: str
    results: list[RunResult]
    deterministic: bool = True


def explore_scenario(scenario: Scenario, *, seed_base: int = 0,
                     budget: int = 1,
                     bug: Optional[str] = None) -> ScenarioReport:
    """Seed sweep + determinism self-check + crash/sever matrix."""
    results = [run_one(scenario, seed_base + i, bug=bug)
               for i in range(max(1, scenario.seeds * budget))]
    base = results[0]
    twin = run_one(scenario, seed_base, bug=bug)
    deterministic = twin.trace == base.trace
    if scenario.plans is not None:
        for plan in scenario.plans(base, budget):
            results.append(
                run_one(scenario, seed_base, crash=plan, bug=bug))
    return ScenarioReport(scenario.name, results, deterministic)


def first_violation(report: ScenarioReport) -> Optional[RunResult]:
    for r in report.results:
        if r.violations or r.outcome != "ok":
            return r
    return None


def facts_from(reports: list[ScenarioReport]) -> dict:
    """Discovered protocol facts: per-channel op state machines (states
    + transition edges, unioned over every pinned run so crash-recovery
    edges are included), the crash-point census of the base run, and
    the invariant registry."""
    scenarios: dict[str, dict] = {}
    for rep in reports:
        chans: dict[str, dict[str, set]] = {}
        for r in rep.results:
            for ch, ops in r.channels.items():
                d = chans.setdefault(ch, {"states": set(), "edges": set()})
                d["states"].update(ops)
                d["edges"].update(
                    f"{a}>{b}" for a, b in zip(ops, ops[1:]))
        base = rep.results[0]
        scenarios[rep.scenario] = {
            "channels": {
                ch: {"states": sorted(d["states"]),
                     "edges": sorted(d["edges"])}
                for ch, d in sorted(chans.items())
            },
            "crash_points": dict(sorted(base.census.items())),
            "invariants": sorted(
                SCENARIOS[rep.scenario].invariants),
        }
    return scenarios


def check_proto(reports: list[ScenarioReport], manifest: ProtoManifest,
                *, drift: bool = True) -> list[ProtoFinding]:
    findings: list[ProtoFinding] = []
    for rep in reports:
        seen: set[tuple[str, str]] = set()
        for r in rep.results:
            if r.outcome != "ok" and ("PR003", r.outcome) not in seen:
                seen.add(("PR003", r.outcome))
                findings.append(ProtoFinding(
                    rep.scenario, "PR003", r.outcome,
                    f"{r.error or r.outcome} [replay {r.token}]"))
            for inv, msg in r.violations:
                if ("PR001", inv) in seen:
                    continue
                seen.add(("PR001", inv))
                findings.append(ProtoFinding(
                    rep.scenario, "PR001", inv,
                    f"{msg} [replay {r.token}]"))
        if not rep.deterministic:
            findings.append(ProtoFinding(
                rep.scenario, "PR002", "determinism",
                "two runs with the same seed produced different "
                "schedule traces"))
    if not drift:
        return findings
    observed = facts_from(reports)
    for name, facts in sorted(observed.items()):
        committed = manifest.scenarios.get(name)
        if committed is None:
            findings.append(ProtoFinding(
                name, "PR004", "+scenario",
                "scenario absent from the committed proto manifest "
                "(run --proto --update-baseline)"))
            continue
        com_ch = committed.get("channels", {})
        for ch, d in facts["channels"].items():
            want = com_ch.get(ch, {"states": [], "edges": []})
            for edge in sorted(set(d["edges"]) - set(want["edges"])):
                findings.append(ProtoFinding(
                    name, "PR004", f"{ch}+{edge}",
                    f"new transition {edge} on {ch} not in the "
                    "committed state machine"))
            for edge in sorted(set(want["edges"]) - set(d["edges"])):
                findings.append(ProtoFinding(
                    name, "PR004", f"{ch}-{edge}",
                    f"committed transition {edge} on {ch} no longer "
                    "reachable"))
        for ch in sorted(set(com_ch) - set(facts["channels"])):
            findings.append(ProtoFinding(
                name, "PR004", f"{ch}-channel",
                f"committed channel {ch} no longer observed"))
        com_labels = set(committed.get("crash_points", {}))
        obs_labels = set(facts["crash_points"])
        for lbl in sorted(obs_labels - com_labels):
            findings.append(ProtoFinding(
                name, "PR005", f"+{lbl}",
                f"new crash point {lbl} not in the committed census"))
        for lbl in sorted(com_labels - obs_labels):
            findings.append(ProtoFinding(
                name, "PR005", f"-{lbl}",
                f"committed crash point {lbl} no longer fires"))
    return findings


# --------------------------------------------------------------- CLI entry


def _budget_env() -> tuple[int, int, bool]:
    budget = max(1, int(os.environ.get("DTPROTO_BUDGET", "1") or 1))
    seed_base = int(os.environ.get("DTPROTO_SEED_BASE", "0") or 0)
    pinned = budget == 1 and seed_base == 0
    return budget, seed_base, pinned


def affected_scenarios(root: Path) -> list[str]:
    """Scenarios whose protocol code is git-dirty (``--changed``)."""
    from dynamo_tpu_torch.analysis.cli import _git_changed_paths

    dirty = [str(p) for p in _git_changed_paths(root)]
    if any(f"{_PKG}/analysis/protocheck" in d or f"{_PKG}/analysis/detloop" in d
           for d in dirty):
        return list(SCENARIOS)
    names = []
    for name, sc in SCENARIOS.items():
        if any(frag in d for d in dirty for frag in sc.touches):
            names.append(name)
    return names


def run_proto(args, out) -> int:
    """``python -m dynamo_tpu_torch lint --proto``: text or stable JSON, exit 1 on any
    non-accepted finding, ``--update-baseline`` re-snapshots the proto
    manifest (carrying justifications by key), ``--replay TOKEN``
    re-executes one recorded interleaving instead of sweeping."""
    token = getattr(args, "replay", None)
    if token:
        res = replay_token(token)
        if getattr(args, "fmt", "text") == "json":
            doc = {"scenario": res.scenario, "seed": res.seed,
                   "bug": res.bug, "outcome": res.outcome,
                   "error": res.error,
                   "violations": [list(v) for v in res.violations],
                   "steps": len(res.trace)}
            if res.crash:
                doc["crash"] = asdict(res.crash)
            print(json.dumps(doc, indent=2, sort_keys=True), file=out)
        else:
            head = f"{res.scenario} seed={res.seed}"
            if res.bug:
                head += f" bug={res.bug}"
            if res.crash:
                head += (f" crash={res.crash.kind}:{res.crash.label}"
                         f"#{res.crash.occurrence}")
            print(f"{head}: outcome={res.outcome}, "
                  f"{len(res.trace)} scheduled steps", file=out)
            for inv, msg in res.violations:
                print(f"  violated: {inv} - {msg}", file=out)
            if res.error:
                print(f"  error: {res.error}", file=out)
        return 1 if (res.violations or res.outcome != "ok") else 0
    manifest_path = Path(
        getattr(args, "manifest", None) or DEFAULT_PROTO_MANIFEST_PATH)
    manifest = ProtoManifest.load(manifest_path)
    budget, seed_base, pinned = _budget_env()
    root = Path(getattr(args, "root", None)
                or Path(__file__).resolve().parents[2])
    names = list(SCENARIOS)
    subset = False
    if getattr(args, "changed", False):
        names = affected_scenarios(root)
        subset = len(names) < len(SCENARIOS)
    if getattr(args, "update_baseline", False) and (subset or not pinned):
        # refused before the sweep: a partial view would drop scenarios
        # or edges from the committed manifest
        print("refusing to update the proto manifest from a partial "
              "or non-default-budget run", file=out)
        return 2
    if not names:
        print("0 protocol scenarios affected by changed files", file=out)
        return 0
    reports = [
        explore_scenario(SCENARIOS[n], seed_base=seed_base, budget=budget)
        for n in names
    ]
    facts = facts_from(reports)
    # drift rules only judge the pinned full sweep: fresh seeds or a
    # bigger budget legitimately discover new edges, and a --changed
    # subset can't see every committed scenario
    drift = pinned and not subset
    findings = check_proto(reports, manifest, drift=drift)
    n_runs = sum(len(rep.results) for rep in reports) + len(reports)

    if getattr(args, "update_baseline", False):
        keep = [f for f in findings if f.rule not in _DRIFT_RULES]
        ProtoManifest.from_facts(facts, keep, manifest).save(manifest_path)
        print(
            f"proto manifest updated: {len(facts)} scenario"
            f"{'' if len(facts) == 1 else 's'}, {len(keep)} accepted "
            f"finding{'' if len(keep) == 1 else 's'} -> {manifest_path}",
            file=out,
        )
        return 0

    fresh = manifest.filter(findings)
    n_accepted = len(findings) - len(fresh)
    if getattr(args, "fmt", "text") == "json":
        doc = {
            "findings": [f.to_json() for f in fresh],
            "accepted": n_accepted,
            "total": len(findings),
            "scenarios": sorted(names),
            "runs": n_runs,
        }
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for f in fresh:
            print(f.render(), file=out)
        print(
            f"{len(fresh)} protocol finding"
            f"{'s' if len(fresh) != 1 else ''} ({n_accepted} accepted) "
            f"over {len(names)} scenario{'s' if len(names) != 1 else ''},"
            f" {n_runs} deterministic runs",
            file=out,
        )
    return 1 if fresh else 0
