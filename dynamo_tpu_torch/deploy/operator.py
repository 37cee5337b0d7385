"""Operator-lite: a watch/reconcile loop over DynamoTpuDeployment specs.

A copy of ``dynamo_tpu/deploy/operator.py`` over the port's renderer and
planner policy: the same reconcile actions, status phases and autoscale
decisions, under the same CRD group, plural and annotations, so a cluster
managed by either package's operator is read the same way.

Reference parity: deploy/dynamo/operator (DynamoDeployment CRD +
controller reconcilers, api/v1alpha1/dynamodeployment_types.go:31).  The
full reference operator is ~10k lines of kubebuilder Go; this is the same
control loop in its lean shape:

  desired  = render_manifests(spec)   for every registered spec
  actual   = cluster.list(owner=operator)
  apply    = creates + updates (spec hash changed) ; prune = deletes

The cluster side is pluggable: :class:`KubectlCluster` shells out to
``kubectl`` (real clusters), :class:`MemoryCluster` applies to an
in-memory object store (tests, dry runs).  Specs arrive via
:meth:`Operator.set_spec` / :meth:`delete_spec`, or from a watched
directory of YAML files (the CRD-watch stand-in), and the loop levels
actual state toward desired on every tick — create, scale, and delete all
fall out of the same diff.

With a coordinator connection the operator goes beyond the reference's
controller: per-deployment ``status`` phases are derived from LIVE worker
registrations (the dyn:// endpoint each service's command names —
Pending/Degraded/Ready, Unknown when unobservable), and services with an
``autoscale`` block scale on one of two signals, BOTH delegated to the
shared planner policy (planner/policy.py — the Planner's decision
kernel; the sdk supervisor
actuates the same functions locally):

  * ``signal: queue`` (default) — remote-prefill queue depth: replicas
    level toward ceil(depth / target_per_replica)
    (planner.policy.prefill_replica_target).
  * ``signal: decode`` — decode-side saturation from the live metrics
    plane ({ns}.kv_metrics.*, the same ForwardPassMetrics the KV router
    schedules on): per-worker max(slot usage, KV-block usage) averaged
    over the REPORTING workers, levelled toward ``target_usage``
    (default 0.7) with the HPA formula ceil(reporting × usage / target);
    reporting < registered holds current replicas
    (planner.policy.decode_replica_target).

Both clamp to [min, max]; levelling is planner.policy.step_replicas —
scale up immediately, down one step per tick.
"""

from __future__ import annotations

import asyncio
import copy
import hashlib
import json
import logging
import re
import subprocess
import time
from pathlib import Path
from typing import Optional, Protocol

import yaml

from dynamo_tpu_torch.deploy.renderer import DeploymentSpec, ServiceSpec, render_manifests
from dynamo_tpu_torch.planner import policy as planner_policy

log = logging.getLogger("dynamo_tpu_torch.operator")

__all__ = ["Operator", "MemoryCluster", "KubectlCluster", "obj_key"]

_DYN_RX = re.compile(r"dyn://([\w-]+)\.([\w-]+)\.([\w-]+)")


def _dyn_target(svc: ServiceSpec) -> Optional[tuple[str, str, str]]:
    """(namespace, component, endpoint) a worker service registers under,
    parsed from the dyn:// URL in its command — the link between the k8s
    object and the live coordinator registration."""
    for arg in svc.command:
        m = _DYN_RX.search(arg)
        if m:
            return m.group(1), m.group(2), m.group(3)
    return None

OWNER_ANNOTATION = "dynamo-tpu.dev/owned-by"
HASH_ANNOTATION = "dynamo-tpu.dev/spec-hash"


def obj_key(obj: dict) -> tuple[str, str, str]:
    """(kind, namespace, name) identity of a manifest."""
    md = obj.get("metadata", {})
    return (obj.get("kind", ""), md.get("namespace", "default"), md.get("name", ""))


def _hash(obj: dict) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()[:16]


class Cluster(Protocol):
    def apply(self, obj: dict) -> None: ...
    def delete(self, kind: str, namespace: str, name: str) -> None: ...
    def list_owned(self, owner: str) -> list[dict]: ...


class MemoryCluster:
    """In-memory object store with kubectl-apply semantics — the test
    double for reconcile logic (and a dry-run target)."""

    def __init__(self):
        self.objects: dict[tuple[str, str, str], dict] = {}
        self.ops: list[tuple[str, tuple[str, str, str]]] = []  # audit trail

    def apply(self, obj: dict) -> None:
        key = obj_key(obj)
        self.ops.append(("apply", key))
        self.objects[key] = obj

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self.ops.append(("delete", (kind, namespace, name)))
        self.objects.pop((kind, namespace, name), None)

    def list_owned(self, owner: str) -> list[dict]:
        return [
            o for o in self.objects.values()
            if o.get("metadata", {}).get("annotations", {}).get(OWNER_ANNOTATION)
            == owner
        ]


def _run_kubectl(base: list[str], args: list[str],
                 stdin: Optional[str] = None) -> str:
    """Shared kubectl subprocess wrapper (cluster + CR source)."""
    proc = subprocess.run(
        base + args, input=stdin, capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"kubectl {' '.join(args)}: {proc.stderr.strip()}")
    return proc.stdout


class KubectlCluster:
    """Real-cluster backend via kubectl (no k8s client dependency)."""

    def __init__(self, kubectl: str = "kubectl", context: Optional[str] = None):
        self.base = [kubectl] + (["--context", context] if context else [])

    def _run(self, args: list[str], stdin: Optional[str] = None) -> str:
        return _run_kubectl(self.base, args, stdin)

    def apply(self, obj: dict) -> None:
        self._run(["apply", "-f", "-"], stdin=yaml.safe_dump(obj))

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._run(["delete", kind, name, "-n", namespace, "--ignore-not-found"])

    def list_owned(self, owner: str) -> list[dict]:
        out = self._run([
            "get", "deployments,services,configmaps", "--all-namespaces",
            "-o", "json",
        ])
        items = json.loads(out).get("items", [])
        return [
            o for o in items
            if o.get("metadata", {}).get("annotations", {}).get(OWNER_ANNOTATION)
            == owner
        ]


CRD_GROUP = "dynamo-tpu.dev"
CRD_PLURAL = "dynamotpudeployments"


def spec_from_cr(obj: dict) -> DeploymentSpec:
    """A DynamoTpuDeployment custom resource → DeploymentSpec (name and
    namespace come from metadata, like the reference CRD)."""
    md = obj.get("metadata", {})
    d = dict(obj.get("spec") or {})
    d.setdefault("name", md.get("name"))
    d.setdefault("namespace", md.get("namespace", "default"))
    return DeploymentSpec.from_dict(d)


class KubectlCrSource:
    """Custom-resource spec source over kubectl (no k8s client dep):
    lists DynamoTpuDeployment objects each tick and writes ``.status``
    back through the status subresource — the reference operator's
    CRD-watch + status-conditions surface (dynamodeployment_types.go:31)
    in poll form."""

    def __init__(self, kubectl: str = "kubectl", context: Optional[str] = None,
                 read_only: bool = False):
        self.base = [kubectl] + (["--context", context] if context else [])
        # dry runs must never write to live CRs
        self.read_only = read_only

    def _run(self, args: list[str], stdin: Optional[str] = None) -> str:
        return _run_kubectl(self.base, args, stdin)

    def list(self) -> list[dict]:
        out = self._run(["get", f"{CRD_PLURAL}.{CRD_GROUP}",
                         "--all-namespaces", "-o", "json"])
        return json.loads(out).get("items", [])

    def patch_status(self, namespace: str, name: str, status: dict) -> None:
        if self.read_only:
            log.info("dry-run: would patch %s/%s status to %s",
                     namespace, name, status)
            return
        self._run([
            "patch", f"{CRD_PLURAL}.{CRD_GROUP}", name, "-n", namespace,
            "--subresource=status", "--type=merge", "-p",
            json.dumps({"status": status}),
        ])


class Operator:
    """The reconcile loop.  One operator instance owns every object it
    created (tracked via an owner annotation), so pruning is safe even
    across restarts — actual state is re-listed from the cluster, never
    remembered."""

    def __init__(self, cluster: Cluster, owner: str = "dynamo-tpu-operator",
                 interval_s: float = 2.0, watch_dir: Optional[str] = None,
                 coordinator=None, cr_source=None):
        self.cluster = cluster
        self.owner = owner
        self.interval_s = interval_s
        self.watch_dir = watch_dir  # rescanned every tick when set
        # optional CoordinatorClient (duck-typed: kv_get_prefix +
        # queue_len): with it the operator reports TRUTHFUL per-deployment
        # phases from live worker registrations and runs queue-depth
        # autoscaling; without it phases are "Unknown" for worker-bearing
        # deployments (the honest answer — it cannot see them)
        self.coordinator = coordinator
        # optional custom-resource source (duck-typed: list() +
        # patch_status()): specs come from DynamoTpuDeployment CRs and
        # the computed status writes back through the status subresource
        self.cr_source = cr_source
        # (deployment name) -> (namespace, cr name) for status patches
        self._cr_ident: dict[str, tuple[str, str]] = {}
        self._pushed_status: dict[str, dict] = {}  # last status per CR
        self.specs: dict[str, DeploymentSpec] = {}
        self.status: dict[str, dict] = {}
        # (deployment, service) -> live registered instance count, filled
        # by observe(); None until the first successful observation
        self.live: Optional[dict[tuple[str, str], int]] = None
        self.queue_depth: dict[tuple[str, str], int] = {}
        # decode-saturation signal: last ForwardPassMetrics per namespace
        # per worker id (fed by a lazy {ns}.kv_metrics.* subscription) and
        # the usage number each decode-autoscaled service last levelled on
        self._metrics: dict[str, dict[int, dict]] = {}
        self._metric_subs: dict[str, int] = {}
        self.decode_usage: dict[tuple[str, str], float] = {}
        # autoscale bookkeeping: the operator's current replica decision
        # and the SPEC FILE's declared replicas per autoscaled service.
        # load_dir re-parses files every tick — without re-applying the
        # decision, each reparse would clobber the scaled value back to
        # the file's (and the resulting perpetual "spec changed" would
        # hot-spin the loop).
        self._scale: dict[tuple[str, str], int] = {}
        self._declared: dict[tuple[str, str], int] = {}
        # last successfully parsed spec name per watched file: a torn read
        # must keep its previous spec, not delete it (see load_dir)
        self._file_spec: dict[str, str] = {}
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._stop = False

    # ------------------------------------------------------------ spec admin
    def _adopt_spec(self, spec: DeploymentSpec) -> None:
        """Install a freshly parsed spec, re-applying any standing
        autoscale decision over the file's declared replicas (clamped to
        the file's current [min, max])."""
        for svc in spec.services:
            if not svc.autoscale:
                continue
            key = (spec.name, svc.name)
            self._declared[key] = svc.replicas
            if key in self._scale:
                lo = int(svc.autoscale.get("min", 1))
                hi = int(svc.autoscale.get("max", max(svc.replicas, lo)))
                svc.replicas = min(hi, max(lo, self._scale[key]))
        self.specs[spec.name] = spec

    def set_spec(self, spec: DeploymentSpec) -> None:
        """Create or update a deployment (CRD upsert analogue)."""
        self._adopt_spec(spec)
        self._wake.set()

    def delete_spec(self, name: str) -> None:
        self.specs.pop(name, None)
        self._wake.set()

    def load_dir(self, path: str | Path) -> None:
        """Sync specs from a directory of YAML files (CRD-watch stand-in):
        files present become specs; specs whose file vanished are deleted.

        A file that fails to PARSE keeps its previous spec: non-atomic
        writers (editors, CI) produce transient torn reads, and treating
        those as deletions would tear down a healthy deployment's objects
        for one reconcile tick and recreate them the next (full pod churn).
        """
        files = sorted(Path(path).glob("*.yaml"))
        before = dict(self.specs)
        seen = set()
        for f in files:
            key = str(f)
            try:
                spec = DeploymentSpec.from_yaml(f)
            except Exception:
                log.exception("bad spec file %s skipped (keeping previous "
                              "spec if any)", f)
                # the file is still present: whatever it last parsed to
                # stays live until it parses again
                prev = self._file_spec.get(key)
                if prev is not None:
                    seen.add(prev)
                continue
            seen.add(spec.name)
            self._file_spec[key] = spec.name
            self._adopt_spec(spec)
        self._file_spec = {
            k: v for k, v in self._file_spec.items() if Path(k).exists()
        }
        for name in [n for n in self.specs if n not in seen]:
            del self.specs[name]
        # wake only on actual change: run() calls load_dir every tick when
        # watch_dir is set, and an unconditional set() would make the
        # interval wait return instantly — a 100%-CPU reconcile hot-spin
        if self.specs != before:
            self._wake.set()

    def load_crs(self) -> None:
        """Sync specs from the custom-resource source (CRD watch in poll
        form): present CRs become specs (autoscale decisions re-applied,
        like load_dir), vanished ones are deleted.  Torn-read rules match
        load_dir at BOTH granularities: an unlistable source keeps every
        current spec, and a CR that transiently fails to PARSE keeps its
        previous spec (tearing down a live deployment's objects over one
        bad read would churn every pod).  Only CR-owned specs are pruned
        — directory-loaded / set_spec specs are never touched."""
        try:
            items = self.cr_source.list()
        except Exception:
            log.exception("CR list failed; keeping current specs")
            return
        before = dict(self.specs)
        seen = set()
        idents: dict[str, tuple[str, str, str]] = {}
        by_ident = {v[:2]: k for k, v in self._cr_ident.items()}
        claimed_ns: dict[str, str] = {}
        for obj in items:
            md = obj.get("metadata", {})
            # uid in the ident: a deleted-and-recreated CR (same ns/name,
            # fresh uid) must invalidate the pushed-status cache — the new
            # object's .status starts empty and needs a write even when
            # the computed status is unchanged
            ident = (md.get("namespace", "default"), md.get("name", ""),
                     str(md.get("uid", "")))
            try:
                spec = spec_from_cr(obj)
            except Exception:
                log.exception("bad DynamoTpuDeployment %s/%s skipped "
                              "(keeping previous spec if any)", *ident[:2])
                prev = by_ident.get(ident[:2])
                if prev is not None:
                    seen.add(prev)
                    idents[prev] = ident
                continue
            if spec.name in claimed_ns and claimed_ns[spec.name] != ident[0]:
                # deployment names must be unique across namespaces (the
                # rendered objects are named from spec.name); a silent
                # last-writer-wins would deploy one and starve the other
                log.error(
                    "DynamoTpuDeployment name collision: %r exists in both "
                    "namespace %s and %s; skipping %s/%s",
                    spec.name, claimed_ns[spec.name], ident[0], *ident[:2],
                )
                continue
            if spec.name in self.specs and spec.name not in self._cr_ident:
                # the name belongs to a dir/set_spec deployment: adopting
                # the CR would hijack it now and tear it down on CR delete
                log.error(
                    "DynamoTpuDeployment %s/%s collides with a non-CR "
                    "deployment spec %r; skipping the CR", *ident[:2],
                    spec.name,
                )
                continue
            claimed_ns[spec.name] = ident[0]
            seen.add(spec.name)
            idents[spec.name] = ident
            self._adopt_spec(spec)
        # prune only specs the CR source OWNS (previously mapped to a CR)
        for name in [n for n in self._cr_ident
                     if n not in seen and n in self.specs]:
            del self.specs[name]
        # pushed-status cache follows CR identity: vanished or recreated
        # (uid change) CRs must be re-pushed from scratch
        for name in list(self._pushed_status):
            if idents.get(name) != self._cr_ident.get(name):
                self._pushed_status.pop(name, None)
        self._cr_ident = idents
        if self.specs != before:
            self._wake.set()

    def push_status(self) -> None:
        """Write each CR's computed status through the status subresource
        (reference parity: status conditions on the CRD).  No-op patches
        are skipped — a steady cluster costs zero apiserver writes per
        tick; a failed patch clears the cache entry so it retries.  The
        merge patch explicitly nulls keys the previous push set that the
        new status dropped (JSON merge-patch otherwise leaves them stale
        on the CR forever); a ``live: None`` (coordinator unobservable)
        likewise merge-deletes the field on the CR."""
        if self.cr_source is None:
            return

        def with_deletes(new, old):
            out = dict(new)
            for k, ov in (old or {}).items():
                if k not in out:
                    out[k] = None  # merge-patch delete of a dropped key
                elif isinstance(ov, dict) and isinstance(out[k], dict):
                    out[k] = with_deletes(out[k], ov)
            return out

        for name, ident in self._cr_ident.items():
            ns, cr_name = ident[0], ident[1]
            st = self.status.get(name)
            if st is None or self._pushed_status.get(name) == st:
                continue
            try:
                self.cr_source.patch_status(
                    ns, cr_name, with_deletes(st, self._pushed_status.get(name))
                )
                self._pushed_status[name] = copy.deepcopy(st)
            except Exception:
                self._pushed_status.pop(name, None)
                log.exception("status patch for %s/%s failed", ns, cr_name)

    # ------------------------------------------------------------ observation
    async def _ensure_metrics_sub(self, ns: str) -> None:
        """Lazily subscribe to a namespace's ForwardPassMetrics subject
        the first time a decode-autoscaled service names it.  The
        coordinator duck needs ``subscribe`` for this signal (the real
        client has it); without it the signal degrades to hold."""
        if ns in self._metric_subs or not hasattr(self.coordinator, "subscribe"):
            return
        from dynamo_tpu_torch.llm.kv_router.publisher import metrics_subject

        store = self._metrics.setdefault(ns, {})

        def on_metrics(subject: str, payload: bytes) -> None:
            try:
                d = json.loads(payload)
                d["_rx"] = time.monotonic()
                store[int(d["worker_id"])] = d
            except Exception:
                log.exception("bad kv_metrics payload on %s", subject)

        self._metric_subs[ns] = await self.coordinator.subscribe(
            metrics_subject(ns), on_metrics
        )

    def _decode_want(self, ns: str, insts: dict, svc: ServiceSpec,
                     auto: dict, lo: int, hi: int):
        """(want, usage) from decode-side saturation, delegated to the
        SHARED planner policy (planner/policy.py decode_replica_target —
        the same formula the planner loop and supervisor actuate on).
        Per registered worker, max(active-slot usage, KV-block usage)
        from its latest fresh ForwardPassMetrics feeds the HPA formula
        ceil(reporting × usage / target).  The policy holds current
        replicas whenever the reporting count falls short of the
        REGISTERED count — no metrics at all, or some workers silent
        (stale publisher, startup lag): scaling on a fresh-only subset
        would shrink the product and act on absence of evidence
        [min, max] edits still apply on hold."""
        target = float(auto.get("target_usage", 0.7))
        stale = float(auto.get("stale_after_s", 15.0))
        now = time.monotonic()
        ids = []
        for k in insts:
            try:
                ids.append(int(k.rsplit("/", 1)[-1], 16))
            except ValueError:
                continue
        store = self._metrics.get(ns, {})
        usages = []
        for wid in ids:
            m = store.get(wid)
            if not m or now - m.get("_rx", 0.0) > stale:
                continue
            usages.append(planner_policy.WorkerSample(
                worker_id=wid,
                request_active_slots=m.get("request_active_slots", 0),
                request_total_slots=m.get("request_total_slots", 1),
                kv_active_blocks=m.get("kv_active_blocks", 0),
                kv_total_blocks=m.get("kv_total_blocks", 1),
            ).usage)
        return planner_policy.decode_replica_target(
            svc.replicas, len(ids), usages, target, lo, hi)

    async def observe(self) -> None:
        """Refresh live worker counts and autoscale signals from the
        coordinator, and level autoscaled services' replicas toward the
        signal's target within [min, max] — queue depth for prefill
        (``signal: queue``, the default), slot/KV saturation for decode
        (``signal: decode``).

        Scale-up jumps straight to the target (queued work is latency);
        scale-down steps one replica per tick (cheap hysteresis — a
        transiently empty queue must not flap the pool).  Changing
        ``svc.replicas`` changes the rendered Deployment's hash, so the
        next reconcile applies the scale exactly like any spec edit."""
        if self.coordinator is None:
            return
        live: dict[tuple[str, str], int] = {}
        depths: dict[tuple[str, str], int] = {}
        usages: dict[tuple[str, str], float] = {}
        scale: dict[tuple[str, str], int] = {}
        decode_ns: set[str] = set()
        for dep, spec in list(self.specs.items()):
            for svc in spec.services:
                target = _dyn_target(svc)
                if target is None:
                    continue
                ns, comp, ep = target
                prefix = f"{ns}/components/{comp}/endpoints/{ep}/"
                insts = await self.coordinator.kv_get_prefix(prefix)
                live[(dep, svc.name)] = len(insts)
                auto = svc.autoscale
                if not auto:
                    continue
                key = (dep, svc.name)
                lo = int(auto.get("min", 1))
                # default cap = the spec FILE's declared replicas — never
                # the live (possibly scaled-down) value, which would
                # ratchet the ceiling downward and pin scale-up
                hi = int(auto.get(
                    "max", max(self._declared.get(key, svc.replicas), lo)
                ))
                if str(auto.get("signal", "queue")) == "decode":
                    decode_ns.add(ns)
                    await self._ensure_metrics_sub(ns)
                    want, usage = self._decode_want(ns, insts, svc, auto,
                                                    lo, hi)
                    if usage is not None:
                        usages[key] = round(usage, 3)
                    detail = f"usage={usage and round(usage, 3)}"
                else:
                    queue = auto.get("queue") or f"{ns}_prefill_queue"
                    depth = await self.coordinator.queue_len(queue)
                    depths[key] = depth
                    want = planner_policy.prefill_replica_target(
                        depth, svc.replicas,
                        int(auto.get("target_per_replica", 4)), lo, hi)
                    detail = f"queue={depth}"
                new = planner_policy.step_replicas(svc.replicas, want)
                if new != svc.replicas:
                    log.info("autoscale %s/%s: %s -> replicas %d -> %d",
                             dep, svc.name, detail, svc.replicas, new)
                    svc.replicas = new
                scale[key] = svc.replicas
        # fresh maps each pass: deleted deployments / removed autoscale
        # blocks must not leave stale depths or decisions behind.  The
        # metrics plumbing follows the same rule: subscriptions for
        # namespaces no decode-autoscaled service names any more are
        # dropped, and departed workers' stored metrics are evicted once
        # well past any plausible staleness window.
        for ns in [n for n in self._metric_subs if n not in decode_ns]:
            sub = self._metric_subs.pop(ns)
            self._metrics.pop(ns, None)
            if hasattr(self.coordinator, "unsubscribe"):
                try:
                    await self.coordinator.unsubscribe(sub)
                except Exception:
                    log.warning("unsubscribe %s failed", ns, exc_info=True)
        now = time.monotonic()
        for store in self._metrics.values():
            for wid in [w for w, m in store.items()
                        if now - m.get("_rx", 0.0) > 120.0]:
                del store[wid]
        self.live = live
        self.queue_depth = depths
        self.decode_usage = usages
        self._scale = scale
        self._declared = {
            k: v for k, v in self._declared.items() if k in scale
        }

    def _phase(self, spec: DeploymentSpec) -> str:
        """Truthful per-deployment phase from live registrations:
        Ready (every worker service fully registered), Degraded (some),
        Pending (none yet), Unknown (no coordinator to ask).  A
        deployment with no dyn:// worker services has nothing to verify
        beyond object application — Ready."""
        workers = [s for s in spec.services if _dyn_target(s) is not None]
        if not workers:
            return "Ready"
        if self.live is None:
            return "Unknown"
        counts = [self.live.get((spec.name, s.name), 0) for s in workers]
        if all(c >= s.replicas for c, s in zip(counts, workers)):
            return "Ready"
        return "Pending" if sum(counts) == 0 else "Degraded"

    # ------------------------------------------------------------- reconcile
    def desired_objects(self) -> dict[tuple[str, str, str], dict]:
        out: dict[tuple[str, str, str], dict] = {}
        for spec in self.specs.values():
            for obj in render_manifests(spec):
                ann = obj.setdefault("metadata", {}).setdefault("annotations", {})
                ann[OWNER_ANNOTATION] = self.owner
                ann[HASH_ANNOTATION] = _hash(obj)
                out[obj_key(obj)] = obj
        return out

    def reconcile_once(self) -> dict:
        """One level pass: apply creates/changes, prune orphans.  Returns a
        summary {created, updated, deleted, unchanged} and updates
        per-deployment status."""
        desired = self.desired_objects()
        actual = {obj_key(o): o for o in self.cluster.list_owned(self.owner)}
        created = updated = unchanged = 0
        for key, obj in desired.items():
            cur = actual.get(key)
            if cur is None:
                self.cluster.apply(obj)
                created += 1
            elif (
                cur.get("metadata", {}).get("annotations", {}).get(HASH_ANNOTATION)
                != obj["metadata"]["annotations"][HASH_ANNOTATION]
            ):
                self.cluster.apply(obj)
                updated += 1
            else:
                unchanged += 1
        deleted = 0
        for key in [k for k in actual if k not in desired]:
            kind, ns, name = key
            self.cluster.delete(kind, ns, name)
            deleted += 1
        summary = {
            "created": created, "updated": updated,
            "deleted": deleted, "unchanged": unchanged,
        }
        # status per deployment by the rendered instance label (exact —
        # substring matching would double-count "llm" vs "llm-router")
        counts: dict[str, int] = {}
        for o in desired.values():
            inst = o["metadata"].get("labels", {}).get("app.kubernetes.io/instance")
            if inst:
                counts[inst] = counts.get(inst, 0) + 1
        for name, spec in self.specs.items():
            st: dict = {
                "objects": counts.get(name, 0), "phase": self._phase(spec),
            }
            workers = {
                s.name: {
                    "want": s.replicas,
                    "live": (self.live or {}).get((name, s.name)),
                }
                for s in spec.services if _dyn_target(s) is not None
            }
            if workers:
                st["workers"] = workers
            qd = {s: d for (n, s), d in self.queue_depth.items() if n == name}
            if qd:
                st["queue_depth"] = qd
            du = {s: u for (n, s), u in self.decode_usage.items() if n == name}
            if du:
                st["decode_usage"] = du
            self.status[name] = st
        return summary

    # ------------------------------------------------------------------ loop
    async def run(self) -> None:
        """Leveling loop: reconcile on spec changes and every interval
        (drift repair), until stop()."""
        while not self._stop:
            try:
                if self.watch_dir is not None:
                    self.load_dir(self.watch_dir)
                if self.cr_source is not None:
                    self.load_crs()
                try:
                    await self.observe()
                except Exception:
                    # a coordinator outage must NOT halt k8s reconcile:
                    # degrade to Unknown phases and keep levelling objects
                    log.warning("observe failed (coordinator unreachable?); "
                                "phases Unknown this tick", exc_info=True)
                    self.live = None
                self.reconcile_once()
                self.push_status()
            except Exception:
                log.exception("reconcile failed; retrying next tick")
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=self.interval_s)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()

    def start(self) -> "Operator":
        self._task = asyncio.ensure_future(self.run())
        return self

    async def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._task is not None:
            await self._task
