"""Compile-plane analysis (dttrace) for the port: the signature census, the
in-place cache audit, upcasts and the footprint on the H100.

The counterpart of ``dynamo_tpu/analysis/tracecheck.py``, with its rules,
manifest contract and entry names, read for eager PyTorch on the card.  The
JAX plane proves that the hot loop compiles once per declared bucket; eager
PyTorch compiles nothing, but a CUDA graph of a dispatch (ROADMAP A1) is
captured once per dispatch signature, so the declared matrix is the set of
graphs A1 would need and a dispatch outside it a capture miss.  The entry
points are the perf plane's (``analysis/perfcheck.py::build_perf_registry``:
one list, read by the perf, trace and shard planes), each with its axes and a
``build`` of one signature on meta operands.  Per entry point:

- **the signature census** (TR001-TR003): the declared matrix of dispatch
  signatures (prefill buckets x prefix-block buckets, burst lengths, spec
  table slices, ragged token and row buckets), enumerated twice.  A
  signature's key hashes its bound operands (shape and dtype of every
  tensor, the cache's included, and every static); an object keyed by
  identity makes the two enumerations differ (TR003), an axis or operand
  change moves the matrix hash (TR002).
- **the in-place audit** (TR004, TR005): each representative runs once on
  ``torch.device("meta")`` through the perf plane's walk, on the card's
  route (kernel wrappers stood in), under a dispatch mode that follows the
  storage of every cache leaf the step takes.  Each leaf must be written in
  place (a mutating op on its storage, and no allocation of a tensor of its
  full shape and dtype: JAX's donated-but-copied buffer) and touched (read
  or written, by an op or a kernel: JAX's dead donation).
- **upcasts** (TR006): casts from bf16, f16 or int8 to f32 of at least a
  hidden size's worth of elements on the card's route (plain versions
  walked beside their kernels are not the route and do not count), keyed by
  source dtype and rank with their count, as JAX keys them, with the
  functions that cast as a fact for the justification.
- **the footprint** (TR007): params + KV pool + the walk's peak of live
  temporaries (storages the walk allocated, freed as they die; in-place
  cache writes and views allocate nothing), against 0.95 of the H100's
  memory (``obs/topology.py``).  :func:`footprint` prices an
  ``EngineConfig``'s dispatches the same way (``chip_smoke.py``'s ``trace``
  line sets it beside the card's ``max_memory_allocated``).

The runtime counterpart: :func:`record_dispatches` wraps the step functions
(``engine/core.py``) and the draft proposer while a run lasts and records
each dispatch's signature label and operand structure;
:func:`undeclared_dispatches` holds them against the matrix of the run's
``EngineConfig``.  The port's legacy prefill pads its chunk to a block
multiple and passes its exact cached prefix (eager PyTorch runs any shape),
so its signature is the bucket class its chunk and prefix fall in (a graph
of that bucket would serve it padded), as the JAX engine's bucketed dispatch
is.

Facts commit to ``analysis/trace_manifest.json`` under the metrics plane's
manifest contract: exit 1 on a non-accepted finding or drift,
``--update-baseline`` re-snapshots and carries justifications by
(entry point, rule, key).
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect
import itertools
import json
import sys
import threading
from collections import Counter
from pathlib import Path
from typing import Callable, Optional

from dynamo_tpu_torch.analysis.metcheck import MetricFinding as TraceFinding
from dynamo_tpu_torch.analysis.metcheck import MetricsManifest as TraceManifest
from dynamo_tpu_torch.analysis.perfcheck import _FREE, Call, PerfEntry, build_perf_registry, walk
from dynamo_tpu_torch.obs import topology

__all__ = [
    "DEFAULT_TRACE_MANIFEST_PATH",
    "HBM_BUDGET_FRACTION",
    "TRACE_RULES",
    "TraceFinding",
    "TraceManifest",
    "check_trace_facts",
    "collect_trace_facts",
    "declared_signatures",
    "enumerate_signatures",
    "footprint",
    "hbm_budget",
    "record_dispatches",
    "run_trace",
    "signature_key",
    "undeclared_dispatches",
]

DEFAULT_TRACE_MANIFEST_PATH = Path(__file__).parent / "trace_manifest.json"

# the share of the card's memory a deployment may plan for: the rest is the
# allocator's, cuBLAS's workspaces and the collectives'
HBM_BUDGET_FRACTION = 0.95

TRACE_RULES = {
    "TR001": ("entrypoint-drift", "registered entry point set changed vs the manifest"),
    "TR002": ("signature-drift", "declared dispatch-signature matrix changed vs the manifest"),
    "TR003": ("unstable-trace-key",
              "rebuilding the signature matrix yields different keys (an object keyed by "
              "identity in a dispatch)"),
    "TR004": ("donated-not-aliased",
              "a cache leaf the step takes is not written in place, or a full copy of it is "
              "allocated"),
    "TR005": ("dead-donation", "a cache leaf the step takes is never read or written"),
    "TR006": ("f32-upcast", "widening cast to f32 on a bf16/f16/int8 hot path"),
    "TR007": ("hbm-over-budget",
              "params + KV pool + peak live temporaries exceed the card's memory budget"),
}

_MANIFEST_NOTE = (
    "CPU-derived facts of the port's entry points (the perf plane's registry): the "
    "signature matrix is enumerated on meta operands, and each representative runs once "
    "on torch.device('meta') on the card's route (kernel wrappers stood in by the perf "
    "plane's walk).  A signature is what a CUDA graph capture would key on; the "
    "in-place audit follows the cache leaves' storages; the footprint counts the walk's "
    "live temporaries (the allocator's rounding and cuBLAS workspaces are not seen), "
    "against 0.95 of the H100's 80 GB.  chip_smoke.py's `trace` line sets the footprint "
    "of its default run beside torch.cuda.max_memory_allocated()."
)


def hbm_budget() -> int:
    return int(topology.TOPOLOGIES[topology.DEFAULT_TOPOLOGY]["hbm_bytes"] * HBM_BUDGET_FRACTION)


def _trace_header() -> dict:
    return {"note": _MANIFEST_NOTE,
            "hbm_budget": {"card": topology.DEFAULT_TOPOLOGY, "bytes": hbm_budget()}}


# ------------------------------------------------------------- signatures ----


def _tensors_of(x) -> list:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors_of(v)]
    return []


def _leaf_key(v, structure: bool = False):
    """A hashable key of one operand: a tensor's shape (its rank only for
    ``structure``) and dtype, a sequence's items, a scalar's value; any
    other object its repr, which names its identity (TR003)."""
    import torch

    if isinstance(v, torch.Tensor):
        dt = str(v.dtype).replace("torch.", "")
        return ("T", v.dim() if structure else tuple(v.shape), dt)
    if isinstance(v, (tuple, list)):
        return tuple(_leaf_key(x, structure) for x in v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return repr(v)


# the operands a signature never keys on: the model (its weights are the
# entry's) and the generator (a replay draws from the same one)
_UNKEYED = ("self", "model")
# statics the label buckets (the legacy prefill passes its exact prefix)
_BUCKETED = ("prefix_blocks",)


def _bound(fn: Callable, args: tuple, kwargs: dict) -> dict:
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    return dict(bound.arguments)


def _keyed(fn: Callable, bound: dict, cache, structure: bool) -> tuple:
    items = []
    for name, v in bound.items():
        if name in _UNKEYED or (structure and name in _BUCKETED):
            continue
        items.append((name, "generator" if name == "generator" else _leaf_key(v, structure)))
    if cache is not None and "cache" not in bound:
        items.append(("cache", _leaf_key(cache, structure)))
    return (fn.__name__, tuple(items))


def signature_key(call: Call) -> str:
    """The stable short hash of one dispatch: its function and every bound
    operand but the model and the generator (shape and dtype of tensors,
    statics by value), the cache it writes included."""
    payload = _keyed(call.fn, _bound(call.fn, call.args, call.kwargs), call.cache, False)
    return hashlib.sha256(repr(payload).encode()).hexdigest()[:16]


def enumerate_signatures(entry: PerfEntry, base=None) -> dict[str, str]:
    """{label: key} over the entry's declared matrix (combinations that
    cannot occur skipped), each built on ``base`` (the entry's setup)."""
    out: dict[str, str] = {}
    names = sorted(entry.axes)
    for combo in itertools.product(*(entry.axes[n] for n in names)):
        d = entry.build(**dict(zip(names, combo)))
        if d is not None:
            out[d.label] = signature_key(d.make(base))
    return out


def _matrix_hash(signatures: dict[str, str]) -> str:
    return hashlib.sha256(repr(tuple(sorted(signatures.items()))).encode()).hexdigest()[:16]


# --------------------------------------------------------------- the walk ----


def _sid(t) -> int:
    return t.untyped_storage()._cdata


def _port_frame() -> str:
    """module.function of the innermost frame of the port's serving code."""
    pkg = __name__.split(".")[0]
    frame = sys._getframe(1)
    while frame is not None:
        f = frame.f_code.co_filename.replace("\\", "/")
        if f"/{pkg}/" in f and "/analysis/" not in f:
            mod = f.rsplit(f"/{pkg}/", 1)[1][:-3].replace("/", ".")
            return f"{mod}.{frame.f_code.co_name}"
        frame = frame.f_back
    return "?"


class _TraceObserver:
    """What one walk of a dispatch shows: each cache leaf's writes, reads
    and full copies, the upcasts on the card's route and the peak of live
    temporaries."""

    def __init__(self, cache, min_elems: int):
        from torch.multiprocessing.reductions import StorageWeakRef

        self._ref = StorageWeakRef
        self.leaves = _tensors_of(cache)
        self.ids = {_sid(t): i for i, t in enumerate(self.leaves)}
        self.written = [0] * len(self.leaves)
        self.read = [0] * len(self.leaves)
        self.copied = [0] * len(self.leaves)
        self.min_elems = min_elems
        self.upcasts: Counter = Counter()
        self.sites: dict[str, set] = {}
        self.live: dict[int, tuple] = {}
        self.peak = 0

    def _leaf(self, t) -> Optional[int]:
        return self.ids.get(_sid(t))

    def op(self, func, args, kwargs, out, depth: int) -> None:
        if depth != 1:
            return  # a plain version walked beside its kernel: not the route
        name = func.overloadpacket.__name__
        kwargs = kwargs or {}
        ins = _tensors_of(list(args)) + _tensors_of(list(kwargs.values()))
        outs = _tensors_of(out)
        if name not in _FREE:
            writes = set()
            for i, a in enumerate(func._schema.arguments):
                info = a.alias_info
                if info is not None and info.is_write:
                    v = args[i] if i < len(args) else kwargs.get(a.name)
                    for t in _tensors_of(v):
                        leaf = self._leaf(t)
                        if leaf is not None:
                            writes.add(leaf)
            for leaf in writes:
                self.written[leaf] += 1
            for t in ins:
                leaf = self._leaf(t)
                if leaf is not None and leaf not in writes:
                    self.read[leaf] += 1
        in_ids = {_sid(t) for t in ins}
        for o in outs:
            if _sid(o) in in_ids:
                continue  # in place, or a view
            for i, leaf in enumerate(self.leaves):
                if tuple(o.shape) == tuple(leaf.shape) and o.dtype == leaf.dtype:
                    self.copied[i] += 1
            sid = _sid(o)
            if sid not in self.live or self.live[sid][0].expired():
                self.live[sid] = (self._ref(o.untyped_storage()), o.untyped_storage().nbytes())
        if name in ("_to_copy", "copy_") and ins and outs:
            src, dst = ins[-1] if name == "copy_" else ins[0], outs[0]
            sdt = str(src.dtype).replace("torch.", "")
            if sdt in ("bfloat16", "float16", "int8") and str(dst.dtype) == "torch.float32" \
                    and dst.numel() >= self.min_elems:
                key = f"{sdt}->f32[r{dst.dim()}]"
                self.upcasts[key] += 1
                self.sites.setdefault(key, set()).add(_port_frame())
        self._prune()

    def kernel(self, name: str, operands: dict, depth: int) -> None:
        if depth != 1:
            return
        for v in operands.values():
            for t in _tensors_of(v):
                leaf = self._leaf(t)
                if leaf is not None:
                    self.read[leaf] += 1

    def _prune(self) -> None:
        total = 0
        for sid in list(self.live):
            ref, n = self.live[sid]
            if ref.expired():
                del self.live[sid]
            else:
                total += n
        self.peak = max(self.peak, total)


def _traced(out) -> str:
    leaves = _tensors_of(out if isinstance(out, (tuple, list)) else [out])
    return f"{len(leaves)} outputs, {sum(t.numel() * t.element_size() for t in leaves)} bytes"


def _walk_call(call: Call, min_elems: int) -> tuple[object, _TraceObserver]:
    obs = _TraceObserver(call.cache, min_elems)
    out, _ = walk(call, observers=(obs,), plain=False)
    return out, obs


def _nbytes_all(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _footprint(model, cache, calls: dict) -> dict:
    """TR007's figures: ``model``'s params and the KV pool ``cache``, and the
    peak of live temporaries of each of ``calls`` ({label: Call} on them)."""
    # upcasts are not counted here (no cast is that large)
    peaks = {label: _walk_call(call, float("inf"))[1].peak for label, call in calls.items()}
    params = _nbytes_all(model.parameters())
    kv = _nbytes_all(_tensors_of(cache))
    return {"params_bytes": params, "kv_bytes": kv, "peak_temp_bytes": peaks,
            "total_bytes": params + kv + max(peaks.values()), "budget_bytes": hbm_budget()}


def _footprint_facts(entry: PerfEntry) -> dict:
    """TR007's figures of a forward entry at its representatives (a
    prefill's too: on the card's route the kernels stream their scores, as
    they do on the card)."""
    model, cache = entry.setup()
    calls = {}
    for values in entry.representatives:
        d = entry.build(**values)
        calls[d.label] = d.make((model, cache))
    f = _footprint(model, cache, calls)
    return dict(f, headroom_bytes=f["budget_bytes"] - f["total_bytes"])


def _entry_facts(entry: PerfEntry) -> dict:
    base = entry.setup() if entry.setup is not None else None
    signatures = enumerate_signatures(entry, base)
    stable = _matrix_hash(enumerate_signatures(entry, base)) == _matrix_hash(signatures)
    traced, upcasts, sites, donation = {}, Counter(), {}, None
    for i, values in enumerate(entry.representatives):
        d = entry.build(**values)
        call = d.make()
        out, obs = _walk_call(call, entry.upcast_min_elems)
        traced[d.label] = _traced(out)
        if i == 0:
            upcasts = obs.upcasts
            sites = obs.sites
            if call.cache is not None:
                donation = {
                    "donated_leaves": len(obs.leaves),
                    "written_in_place": sum(1 for n in obs.written if n),
                    "copied_leaves": [f"leaf{j}" for j, n in enumerate(obs.copied) if n],
                    "dead_leaves": [f"leaf{j}" for j in range(len(obs.leaves))
                                    if not obs.written[j] and not obs.read[j]],
                    "signature": d.label,
                }
    return {
        "axes": {k: list(v) for k, v in sorted(entry.axes.items())},
        "n_signatures": len(signatures),
        "signature_hash": _matrix_hash(signatures),
        "stable": stable,
        "traced": traced,
        "donation": donation,
        "upcasts": dict(sorted(upcasts.items())),
        "upcast_sites": {k: sorted(v) for k, v in sorted(sites.items())},
        "hbm": _footprint_facts(entry) if entry.footprint else None,
    }


def collect_trace_facts(registry: Optional[list[PerfEntry]] = None) -> dict:
    """The fact snapshot of every registered entry point with a matrix."""
    registry = registry if registry is not None else build_perf_registry()
    return {e.name: _entry_facts(e) for e in registry if e.build is not None}


# ------------------------------------------------------------------ check ----


def check_trace_facts(facts: dict, manifest: TraceManifest) -> list[TraceFinding]:
    """Drift (TR001-TR003: fix the code or re-snapshot) plus the intrinsic
    findings (TR004-TR007: accepted only with a justification)."""
    findings: list[TraceFinding] = []
    known = manifest.entrypoints
    for name in sorted(set(facts) - set(known)):
        findings.append(TraceFinding(
            name, "TR001", "added",
            "entry point not in the committed manifest: audit it and re-snapshot "
            "(`lint --trace --update-baseline`)"))
    for name in sorted(set(known) - set(facts)):
        findings.append(TraceFinding(
            name, "TR001", "removed",
            "manifest entry point no longer registered: re-snapshot if the removal is intended"))
    for name, f in sorted(facts.items()):
        committed = known.get(name)
        if committed is not None and f["signature_hash"] != committed.get("signature_hash"):
            old_axes, new_axes = committed.get("axes"), f["axes"]
            detail = (f"axes {old_axes} -> {new_axes}" if old_axes != new_axes else
                      f"{committed.get('n_signatures')} -> {f['n_signatures']} signatures (same "
                      "axes: an operand's shape or dtype, or a static, changed)")
            findings.append(TraceFinding(
                name, "TR002", "matrix",
                f"declared dispatch-signature matrix drifted from the manifest: {detail}: the "
                "set of graphs a capture needs changed; verify the bucketing, then re-snapshot"))
        for ul, count in f["upcasts"].items():
            old = (committed or {}).get("upcasts", {}).get(ul)
            drift = f" (manifest had {old})" if old not in (None, count) else ""
            findings.append(TraceFinding(
                name, "TR006", f"{ul}x{count}",
                f"{count} widening cast(s) {ul} on the card's route{drift} "
                f"({', '.join(f['upcast_sites'].get(ul, []))}): accept with a justification only "
                "if the accumulation is by design"))
        if not f["stable"]:
            findings.append(TraceFinding(
                name, "TR003", "unstable",
                "signature matrix hashes differently across two enumerations: a dispatch operand "
                "or static is keyed by identity, so no two dispatches would share a graph"))
        don = f.get("donation")
        if don is not None:
            missing = don["donated_leaves"] - don["written_in_place"]
            if missing > 0 or don["copied_leaves"]:
                findings.append(TraceFinding(
                    name, "TR004", f"unaliased={max(missing, len(don['copied_leaves']))}",
                    f"{missing} of {don['donated_leaves']} cache leaves not written in place, "
                    f"full copies of {don['copied_leaves'] or 'none'} allocated (sig "
                    f"{don['signature']}): the step rebuilds its cache, a whole HBM pass a step: "
                    "the walked complement of source rule DT103"))
            for leaf in don["dead_leaves"]:
                findings.append(TraceFinding(
                    name, "TR005", leaf,
                    f"cache {leaf} is never read or written by the step: drop it from the step's "
                    "operands or wire it through"))
        hbm = f.get("hbm")
        if hbm is not None and hbm["total_bytes"] > hbm["budget_bytes"]:
            findings.append(TraceFinding(
                name, "TR007", "total",
                f"footprint {hbm['total_bytes']:,} B (params {hbm['params_bytes']:,} + KV "
                f"{hbm['kv_bytes']:,} + peak temporaries) exceeds the card's budget "
                f"{hbm['budget_bytes']:,} B"))
    return sorted(findings)


# ----------------------------------------------------- an engine's matrix ----


def _engine_registry(model_cfg, engine_cfg) -> list[PerfEntry]:
    from dynamo_tpu_torch.analysis.perfcheck import _engine_entries

    return _engine_entries("run", model_cfg, engine_cfg)


def _base_name(entry_name: str) -> str:
    return entry_name.split("[", 1)[0]


def declared_signatures(model_cfg, engine_cfg) -> dict[str, dict[str, tuple]]:
    """{entry base name: {label: operand structure}} of the matrix an
    engine of ``model_cfg`` under ``engine_cfg`` declares (its step
    functions, by the census's entry names)."""
    out = {}
    for e in _engine_registry(model_cfg, engine_cfg):
        base = e.setup()
        names = sorted(e.axes)
        table = {}
        for combo in itertools.product(*(e.axes[n] for n in names)):
            d = e.build(**dict(zip(names, combo)))
            if d is not None:
                call = d.make(base)
                table[d.label] = _keyed(call.fn, _bound(call.fn, call.args, call.kwargs),
                                        call.cache, True)
        out[_base_name(e.name)] = table
    return out


def _pb_bucket(pb, cfg) -> int:
    pb = int(pb or 0)
    return min(0 if pb == 0 else 1 << (pb - 1).bit_length(), cfg.max_blocks_per_seq)


def _ragged_label(a: dict, cfg) -> str:
    return (f"t={a['tokens'].shape[1]},r={a['block_tables'].shape[0]},"
            f"pb={_pb_bucket(a['prefix_blocks'], cfg)}")


# step function -> (entry base name, label of a dispatch's bound operands)
_LABELS = {
    "unified_step": ("engine.step", lambda a, cfg: (
        f"s={cfg.bucket_for(a['tokens'].shape[1])},pb={_pb_bucket(a['prefix_blocks'], cfg)}")),
    "multi_decode_step": ("engine.decode_multi", lambda a, cfg: f"k={a['num_steps']}"),
    "spec_verify_step": ("engine.spec_verify",
                         lambda a, cfg: f"m_used={a['block_tables'].shape[1]}"),
    "ragged_prefill_step": ("engine.prefill_ragged", _ragged_label),
    "unified_token_step": ("engine.unified", _ragged_label),
    "unified_burst_step": ("engine.unified_burst",
                           lambda a, cfg: f"{_ragged_label(a, cfg)},k={a['num_steps']}"),
    "_impl": ("engine.draft_propose", lambda a, cfg: (
        f"u={a['tokens'].shape[1]},m={a['block_tables'].shape[1]},k={a['k']}")),
}


class DispatchLog:
    """The dispatches a run made: per entry base name, a Counter of (label,
    operand structure)."""

    def __init__(self, engine_cfg):
        self.cfg = engine_cfg
        self.seen: dict[str, Counter] = {}
        self._lock = threading.Lock()

    def record(self, fn: Callable, args: tuple, kwargs: dict, cache) -> None:
        entry, label_of = _LABELS[fn.__name__]
        bound = _bound(fn, args, kwargs)
        item = (label_of(bound, self.cfg), _keyed(fn, bound, cache, True))
        with self._lock:
            self.seen.setdefault(entry, Counter())[item] += 1

    def labels(self) -> dict[str, set]:
        return {e: {label for label, _ in c} for e, c in sorted(self.seen.items())}

    def total(self) -> int:
        return sum(sum(c.values()) for c in self.seen.values())


@contextlib.contextmanager
def record_dispatches(engine_cfg):
    """While the block runs, every dispatch of the engine's step functions
    (``engine/core.py``, called by their module names) and of the draft
    proposer is recorded into the yielded :class:`DispatchLog` (on any
    thread: an ``AsyncLLMEngine``'s too) before it runs."""
    import functools

    from dynamo_tpu_torch.engine import core as ec
    from dynamo_tpu_torch.engine.draft import DraftProposer

    log = DispatchLog(engine_cfg)
    saved = {}
    for name in _LABELS:
        fn = getattr(ec, name, None)
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, **kwargs):
            log.record(_fn, args, kwargs, args[1] if len(args) > 1 else kwargs.get("cache"))
            return _fn(*args, **kwargs)

        saved[name] = fn
        setattr(ec, name, functools.wraps(fn)(wrapped))
    impl = DraftProposer._impl

    @functools.wraps(impl)
    def draft_impl(self, *args, **kwargs):
        log.record(impl.__get__(self), args, kwargs, self.cache)
        return impl(self, *args, **kwargs)

    DraftProposer._impl = draft_impl
    try:
        yield log
    finally:
        DraftProposer._impl = impl
        for name, fn in saved.items():
            setattr(ec, name, fn)


def undeclared_dispatches(log: DispatchLog, model_cfg) -> list[tuple[str, str]]:
    """(entry, label) of every recorded dispatch whose label is not in the
    engine's declared matrix or whose operand structure is not the declared
    signature's (another operand's rank or dtype, a static, penalties or a
    grammar the declared signature has not)."""
    declared = declared_signatures(model_cfg, log.cfg)
    out = []
    for entry, seen in sorted(log.seen.items()):
        table = declared.get(entry, {})
        for label, structure in sorted(seen, key=repr):
            if table.get(label) != structure:
                out.append((entry, label))
    return out


def footprint(model_cfg, engine_cfg) -> dict:
    """TR007's figures for an engine of ``model_cfg`` under ``engine_cfg``:
    its params and KV pool, and the peak of live temporaries over its
    default path's dispatches (the longest legacy prefill from nothing
    cached, and the longest decode burst at every slot), walked on meta
    operands on the card's route."""
    from dynamo_tpu_torch.analysis.perfcheck import _engine_entries

    entries = {_base_name(e.name): e for e in _engine_entries("run", model_cfg, engine_cfg)}
    model, cache = entries["engine.step"].setup()
    burst = max(entries["engine.decode_multi"].axes["num_steps"])
    calls = {}
    for entry, values in (("engine.step", dict(s_bucket=engine_cfg.prefill_buckets[-1],
                                               prefix_blocks=0)),
                          ("engine.decode_multi", dict(num_steps=burst))):
        d = entries[entry].build(**values)
        calls[f"{entry}[{d.label}]"] = d.make((model, cache))
    return _footprint(model, cache, calls)


# -------------------------------------------------------------------- CLI ----


def run_trace(args, out) -> int:
    """``python -m dynamo_tpu_torch lint --trace``: text or stable JSON, exit 1
    on any non-accepted finding; ``--update-baseline`` re-snapshots the
    manifest (carrying justifications by key)."""
    manifest_path = Path(getattr(args, "manifest", None) or DEFAULT_TRACE_MANIFEST_PATH)
    manifest = TraceManifest.load(manifest_path)
    facts = collect_trace_facts()
    findings = check_trace_facts(facts, manifest)
    if getattr(args, "update_baseline", False):
        # drift (TR001-TR003) is resolved by the snapshot itself; intrinsic
        # findings become accepted entries
        intrinsic = [f for f in findings if f.rule in ("TR004", "TR005", "TR006", "TR007")]
        m = TraceManifest.from_facts(facts, intrinsic, manifest)
        m.header = _trace_header()
        m.save(manifest_path)
        print(f"trace manifest updated: {len(facts)} entrypoints, {len(intrinsic)} accepted "
              f"finding{'' if len(intrinsic) == 1 else 's'} -> {manifest_path}", file=out)
        return 0
    fresh = manifest.filter(findings)
    n_accepted = len(findings) - len(fresh)
    if getattr(args, "fmt", "text") == "json":
        doc = {"findings": [f.to_json() for f in fresh], "accepted": n_accepted,
               "total": len(findings), "entrypoints": sorted(facts)}
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for f in fresh:
            print(f.render(), file=out)
        print(f"{len(fresh)} trace finding{'s' if len(fresh) != 1 else ''} ({n_accepted} accepted) "
              f"over {len(facts)} entrypoints", file=out)
    return 1 if fresh else 0
