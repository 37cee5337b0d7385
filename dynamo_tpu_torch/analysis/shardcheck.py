"""Sharding-plane analysis (dtshard) for the port: what each rank of the mesh
holds and which collectives it issues.

The counterpart of ``dynamo_tpu/analysis/shardcheck.py``, with its rules,
manifest contract and leaf names, read for the port's mesh: one process per
rank (``utils/mesh.py``), where JAX compiles one GSPMD program.  Everything
here is meta-tensor work on the CPU, through the perf plane's walk
(``analysis/perfcheck.py``: ``walk``, ``RecordingMesh``).  The rigs are
JAX's, under the audit mesh (data=1, model=4): tiny-llama, tiny-llama-int8
(the same bf16 params over an int8 cache), tiny-mla and, in place of JAX's
llama3b-v5e, ``llama3-8b-h100`` (the perf plane's full-width forward, its
KV pool at ``LLAMA3_8B_SHAPES``).

- **the placement census** (SH001, SH003, SH004): every param and cache
  leaf under JAX's name, with its spec (``partition_specs`` /
  ``cache_spec`` pruned by ``models/quant.py::prune_specs``), its global
  bytes, its bytes per chip as JAX's spec math gives them (global over the
  product of the mesh axes the spec names), whether the model axis
  replicates it, and ``bytes_per_rank``: what one rank's process really
  allocates (the largest over the ranks of a meta model built on a
  ``RecordingMesh`` of that rank, its cache from its own
  ``init_kv_cache``).  The two differ where the port's shard rule is not an
  even split: a tp above Hk gives each rank a whole kv head, and an int8
  rank re-pads its scales to a whole tile.  A model the port refuses at the
  audit tp (tiny-mla's 2 heads over 4 ranks) has no per-rank figures.
  SH003 holds the per-rank total (the spec math where there is none)
  against 0.95 of the H100's memory; SH004 flags a drifted spec table.
- **the collective census** (SH002): the port has no GSPMD to insert
  collectives, so the census is what rank 0 issues in one decode turn,
  walked on its meta model through a ``RecordingMesh``: the dispatch's
  operand broadcast (``engine/core.py::EngineCore._fwd``), then the
  forward and the logits (op x axis x count x payload bytes).  The TP
  layout needs two all-reduces a layer and the logits' gather; anything
  beyond is a finding, accepted only with a justification.
- **the in-place write per rank** (SH005): every rank's cache leaves are
  written in place in a walked decode turn (the trace plane's observer,
  ``analysis/tracecheck.py``), with the per-rank shape their spec gives
  (the kv-head-major axis by :func:`~dynamo_tpu_torch.models.llama.kv_head_range`,
  as the port splits it), the int8 scale tiles included.

Facts commit to ``analysis/shard_manifest.json``: exit 1 on a non-accepted
finding or drift, ``--update-baseline`` re-snapshots and carries
justifications by (entry, rule, key).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import pickle
from pathlib import Path
from typing import Optional

from dynamo_tpu_torch.analysis.metcheck import MetricFinding as ShardFinding
from dynamo_tpu_torch.analysis.metcheck import MetricsManifest as ShardManifest
from dynamo_tpu_torch.analysis.perfcheck import (LLAMA3_8B_SHAPES, META, RecordingMesh,
                                                 _facts, llama3_8b_config, tiny_deepseek_config,
                                                 tiny_model_config, walk)
from dynamo_tpu_torch.analysis.tracecheck import _TraceObserver, _tensors_of, hbm_budget
from dynamo_tpu_torch.obs.topology import AXIS_MODEL

__all__ = [
    "AUDIT_MESH_SHAPE",
    "DEFAULT_SHARD_MANIFEST_PATH",
    "SHARD_RULES",
    "ShardFinding",
    "ShardManifest",
    "census_at",
    "check_shard_facts",
    "collect_shard_facts",
    "collective_census",
    "counted_collectives",
    "gathered_resident_bytes",
    "leaf_per_chip_bytes",
    "placement_census",
    "rank_resident_bytes",
    "run_shard",
]

DEFAULT_SHARD_MANIFEST_PATH = Path(__file__).parent / "shard_manifest.json"

# (data, model): one host's four cards tensor-parallel, the smallest mesh
# where every TP split and every replication cost shows
AUDIT_MESH_SHAPE = (1, 4)

SHARD_RULES = {
    "SH001": ("large-array-replicated",
              "param/KV leaf above the size floor is replicated across the model axis (a full "
              "copy on every rank)"),
    "SH002": ("unexpected-collective",
              "a collective rank 0 issues in a decode turn beyond the TP layout's two "
              "all-reduces a layer and the logits' gather"),
    "SH003": ("per-rank-hbm-over-budget",
              "params + KV pool a rank holds exceed the card's memory budget"),
    "SH004": ("placement-drift", "placement spec table changed vs the committed shard manifest"),
    "SH005": ("cache-slice-not-in-place",
              "a rank's cache leaf is not written in place, or its shape is not what its spec "
              "gives"),
}

# SH001 floors: absolute (real deployments) or a share of the rig's total
# per chip (so the tiny rigs show the findings their full-size
# counterparts would)
SH001_MIN_BYTES = 1 << 20
SH001_MIN_FRACTION = 0.05

_MANIFEST_NOTE = (
    "CPU-derived placement facts under the (data=1, model=4) audit mesh: the census is "
    "the port's spec tables (partition_specs, cache_spec, prune_specs) in JAX's spec "
    "math, beside each leaf's bytes_per_rank, what a rank's process allocates (meta "
    "models built on a RecordingMesh rank).  The collective census is rank 0's decode "
    "turn walked on meta tensors: the operand broadcast of EngineCore._fwd, then the "
    "forward and the logits through the recording mesh.  chip_smoke.py's `shard` line "
    "sets the census at (1, 2) beside the mesh phase's ranks on the card."
)


def _shard_header() -> dict:
    from dynamo_tpu_torch.utils.mesh import MESH_AXES

    return {"note": _MANIFEST_NOTE, "audit_mesh": dict(zip(MESH_AXES, AUDIT_MESH_SHAPE)),
            "hbm_budget": {"card": "h100", "bytes": hbm_budget()}}


# ----------------------------------------------------------- spec math ----


def _axis_names(spec) -> list[str]:
    out = []
    for e in tuple(spec):
        if e is not None:
            out.extend(e if isinstance(e, tuple) else (e,))
    return out


def leaf_per_chip_bytes(spec, nbytes: int, mesh_shape: dict) -> int:
    """Bytes of one leaf per chip in JAX's spec math: its global bytes over
    the product of the mesh-axis sizes its pruned spec names."""
    div = 1
    for name in _axis_names(spec):
        div *= int(mesh_shape.get(name, 1))
    return -(-int(nbytes) // div)


def _spec_str(spec) -> str:
    return "P(" + ", ".join(repr(e) for e in tuple(spec)) + ")"


def _param_name(name: str) -> str:
    """JAX's leaf name of a parameter: ``layers.wq`` -> ``params['layers']['wq']``."""
    return "params" + "".join(f"[{part!r}]" for part in name.split("."))


def _cache_leaves(cache) -> dict:
    """JAX's leaf names of a cache: ``cache``, or ``cache.data`` and
    ``cache.scale`` of an int8 one."""
    if isinstance(cache, tuple):
        return {f"cache.{field}": t for field, t in zip(cache._fields, cache)}
    return {"cache": cache}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# ------------------------------------------------------------------ rigs ----


def _model(kind: str, cfg, mesh=None, quantized: bool = False):
    if kind == "mla":
        from dynamo_tpu_torch.models.deepseek import DeepseekModel

        return DeepseekModel(cfg, device=META, mesh=mesh)
    from dynamo_tpu_torch.models.llama import LlamaModel

    return LlamaModel(cfg, device=META, quantized=quantized, mesh=mesh)


def _rigs() -> list[dict]:
    """JAX's rigs (its shardcheck.py ``_model_rigs``), Llama-3-8B on the H100
    in place of its llama3b-v5e."""
    tiny = tiny_model_config()
    big = LLAMA3_8B_SHAPES
    return [
        dict(tag="tiny-llama", kind="llama", cfg=tiny, blocks=64, bs=8, cache_dtype=None),
        dict(tag="tiny-llama-int8", kind="llama", cfg=tiny, blocks=64, bs=8, cache_dtype="int8"),
        dict(tag="tiny-mla", kind="mla", cfg=tiny_deepseek_config(), blocks=16, bs=8,
             cache_dtype=None),
        dict(tag="llama3-8b-h100", kind="llama", cfg=llama3_8b_config(),
             blocks=big["num_blocks"], bs=big["block_size"], cache_dtype=None,
             budget=hbm_budget()),
    ]


def _rank_mesh(mesh_shape: tuple, rank: int) -> RecordingMesh:
    from dynamo_tpu_torch.utils.mesh import MESH_AXES

    return RecordingMesh(MESH_AXES, tuple(mesh_shape), rank=rank)


def _rank_models(rig: dict, mesh_shape: tuple):
    """Each rank's meta (model, cache), or the port's refusal of the mesh."""
    out = []
    for r in range(_rank_mesh(mesh_shape, 0).size):
        try:
            m = _model(rig["kind"], rig["cfg"], mesh=_rank_mesh(mesh_shape, r))
        except ValueError as e:
            return str(e)
        out.append((m, m.init_kv_cache(rig["blocks"], rig["bs"], rig["cache_dtype"])))
    return out


def _expected_rank_shape(rig: dict, leaf_name: str, shape: tuple, spec, mesh_shape: tuple,
                         rank: int) -> tuple:
    """A rank's shape of a cache leaf as its spec gives it: an even split of
    every axis the spec names, but the kv-head-major axis of the data, which
    the port splits by whole kv heads (``kv_head_range``)."""
    from dynamo_tpu_torch.models.llama import kv_head_range
    from dynamo_tpu_torch.utils.mesh import AXIS_MODEL

    mesh = _rank_mesh(mesh_shape, rank)
    out = list(shape)
    for i, e in enumerate(tuple(spec)):
        if e is None:
            continue
        k = mesh.axis_size(e)
        if rig["kind"] == "llama" and leaf_name != "cache.scale" and i == len(shape) - 1 \
                and e == AXIS_MODEL:
            cfg = rig["cfg"]
            _, count = kv_head_range(cfg.num_heads, cfg.num_kv_heads, k, mesh.axis_index(e))
            out[i] = count * cfg.head_dim
        else:
            out[i] = shape[i] // k
    return tuple(out)


def placement_census(rig: dict, mesh_shape: tuple = AUDIT_MESH_SHAPE) -> dict:
    """The placement facts of one rig under ``mesh_shape`` (see the module
    docstring), with the ranks' meta models for the probes."""
    from dynamo_tpu_torch.models.quant import align_specs, prune_specs
    from dynamo_tpu_torch.utils.mesh import AXIS_MODEL, MESH_AXES, abstract_mesh

    amesh = abstract_mesh(mesh_shape, MESH_AXES)
    shape_of = dict(zip(MESH_AXES, mesh_shape))
    whole = _model(rig["kind"], rig["cfg"])
    cache = whole.init_kv_cache(rig["blocks"], rig["bs"], rig["cache_dtype"])
    params = dict(whole.named_parameters())
    pshapes = {n: tuple(p.shape) for n, p in params.items()}
    pspecs = prune_specs(pshapes, whole.partition_specs(), amesh)
    if rig["kind"] == "llama":
        pspecs = align_specs(pshapes, pspecs)
    cspec = whole.cache_spec(rig["cache_dtype"] == "int8")
    cleaves = _cache_leaves(cache)
    cspecs = prune_specs({n: tuple(t.shape) for n, t in cleaves.items()},
                         dict(zip(cleaves, cspec if isinstance(cache, tuple) else (cspec,))),
                         amesh)
    ranks = _rank_models(rig, mesh_shape)
    per_rank: dict[str, int] = {}
    if not isinstance(ranks, str):
        for m, c in ranks:
            for n, p in m.named_parameters():
                per_rank[_param_name(n)] = max(per_rank.get(_param_name(n), 0), _nbytes(p))
            for n, t in _cache_leaves(c).items():
                per_rank[n] = max(per_rank.get(n, 0), _nbytes(t))
    model_size = shape_of.get(AXIS_MODEL, 1)
    leaves = {}
    for kind, table, specs, name_of in (("params", params, pspecs, _param_name),
                                        ("cache", cleaves, cspecs, str)):
        for n, t in table.items():
            spec = specs.get(n, (None,) * t.dim())
            name = name_of(n)
            leaves[name] = {
                "shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", ""),
                "spec": _spec_str(spec), "bytes_global": _nbytes(t),
                "bytes_per_chip": leaf_per_chip_bytes(spec, _nbytes(t), shape_of),
                "bytes_per_rank": per_rank.get(name),
                "replicated_model": model_size > 1 and AXIS_MODEL not in _axis_names(spec),
            }

    def total(prefix, key):
        vals = [v[key] for k, v in leaves.items() if k.startswith(prefix)]
        return None if any(x is None for x in vals) else sum(vals)

    payload = tuple(sorted((k, v["spec"], tuple(v["shape"]), v["dtype"])
                           for k, v in leaves.items())) + (tuple(sorted(shape_of.items())),)
    facts = {
        "mesh": shape_of,
        "leaves": leaves,
        "params_bytes_per_chip": total("params", "bytes_per_chip"),
        "cache_bytes_per_chip": total("cache", "bytes_per_chip"),
        "total_bytes_per_chip": total("", "bytes_per_chip"),
        "params_bytes_per_rank": total("params", "bytes_per_rank"),
        "cache_bytes_per_rank": total("cache", "bytes_per_rank"),
        "total_bytes_per_rank": total("", "bytes_per_rank"),
        "replicated_bytes_per_chip": sum(v["bytes_per_chip"] for v in leaves.values()
                                         if v["replicated_model"]),
        "rank_model": "built" if not isinstance(ranks, str) else f"refused: {ranks}",
        "budget_bytes": rig.get("budget"),
        "spec_hash": hashlib.sha256(repr(payload).encode()).hexdigest()[:16],
    }
    return facts, ranks, {**{n: pspecs.get(n) for n in params}, **{
        n: cspecs[n] for n in cleaves}}


# ---------------------------------------------------------------- probes ----


def _decode_turn(model, cache, batch: int, m: int, block_size: int, num_steps: int = 1):
    """Rank 0's decode dispatch at ``batch`` rows: the operand broadcast of
    ``EngineCore._fwd`` (off a mesh: nothing), then ``multi_decode_step``
    (``num_steps`` turns: the forward, the logits, a sample without a
    generator, each later turn's tokens broadcast from rank 0)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.core import EngineCore, multi_decode_step
    from dynamo_tpu_torch.obs.timeline import StepTimeline

    def run():
        mesh = getattr(model, "mesh", None)
        stub = SimpleNamespace(mesh=mesh, timeline=StepTimeline(),
                               _up=lambda a: torch.from_numpy(a).to(META))
        stub._send = lambda op, *payload: EngineCore._send(stub, op, *payload)
        host = (np.zeros(batch, np.int32), np.zeros(batch, np.int32),
                np.zeros((batch, m), np.int32), np.zeros(batch, np.int32),
                np.zeros(batch, np.int32))
        args = EngineCore._fwd(stub, multi_decode_step, host, num_steps=num_steps,
                               block_size=block_size)
        f32 = torch.zeros(batch, dtype=torch.float32, device=META)
        i32 = torch.zeros(batch, dtype=torch.int32, device=META)
        return multi_decode_step(model, cache, *args, None, f32, i32, f32, num_steps=num_steps,
                                 block_size=block_size)
    return run


def collective_census(model, cache, batch: int, m: int, block_size: int,
                      num_steps: int = 1) -> dict:
    """``{"op:axis": {"count", "payload_bytes", "axis_size"}}`` of the
    collectives rank 0 issues in one decode dispatch of ``num_steps`` turns
    of ``model`` (a meta model on a ``RecordingMesh``) over ``cache``."""
    _, costs = walk(_decode_turn(model, cache, batch, m, block_size, num_steps), plain=False)
    return {k: {"count": v["count"], "payload_bytes": v["payload_bytes"],
                "axis_size": v["axis_size"]} for k, v in _facts(costs)["collectives"].items()}


def _probe(rig: dict, ranks, specs: dict, mesh_shape: tuple, batch: int = 2) -> dict:
    """SH002's census on rank 0 and SH005's in-place write on every rank."""
    m = 8
    model0, cache0 = ranks[0]
    census = collective_census(model0, cache0, batch, m, rig["bs"])
    layers = rig["cfg"].num_layers
    expected = {"all_reduce:model": 2 * layers, "all_gather:model": 1}
    whole = _cache_leaves(_model(rig["kind"], rig["cfg"]).init_kv_cache(
        rig["blocks"], rig["bs"], rig["cache_dtype"]))
    slices = []
    for r, (model, cache) in enumerate(ranks):
        obs = _TraceObserver(cache, float("inf"))  # the writes only, no upcast census
        walk(_decode_turn(model, cache, batch, m, rig["bs"]), observers=(obs,), plain=False)
        for i, (name, t) in enumerate(_cache_leaves(cache).items()):
            want = _expected_rank_shape(rig, name, tuple(whole[name].shape), specs[name],
                                        mesh_shape, r)
            slices.append({"rank": r, "leaf": name, "shape": list(t.shape),
                           "spec_shape": list(want), "written_in_place": obs.written[i] > 0,
                           "copied": obs.copied[i] > 0})
    return {"mesh": dict(zip(("data", "model"), mesh_shape)), "batch": batch,
            "collectives": census, "layout_needs": expected, "slices": slices}


def _probe_mesh(rig: dict) -> tuple:
    """The audit mesh, or the largest tp under it the model splits over."""
    tp = AUDIT_MESH_SHAPE[1]
    while tp > 1 and isinstance(_rank_models(rig, (1, tp)), str):
        tp //= 2
    return (1, tp)


# --------------------------------------------------------------- collect ----


def collect_shard_facts() -> dict:
    """The sharding plane's snapshot: a placement census per rig and a decode
    probe per rig the port builds at some tp > 1."""
    facts: dict[str, dict] = {}
    for rig in _rigs():
        tag = rig["tag"]
        placement, ranks, specs = placement_census(rig)
        facts[f"placement[{tag}]"] = placement
        shape = AUDIT_MESH_SHAPE if not isinstance(ranks, str) else _probe_mesh(rig)
        if shape[1] > 1:
            if shape != AUDIT_MESH_SHAPE:
                _, ranks, specs = placement_census(rig, shape)
            family = "deepseek" if rig["kind"] == "mla" else "llama"
            facts[f"probe.{family}.decode[{tag}]"] = _probe(rig, ranks, specs, shape)
    return facts


# ----------------------------------------------------------------- check ----


def check_shard_facts(facts: dict, manifest: ShardManifest) -> list[ShardFinding]:
    """Drift (SH004: fix the specs or re-snapshot) plus the intrinsic
    findings (SH001/SH002/SH003/SH005: accepted only with a justification)."""
    findings: list[ShardFinding] = []
    known = manifest.entrypoints
    for name in sorted(set(facts) - set(known)):
        findings.append(ShardFinding(
            name, "SH004", "added",
            "fact entry not in the committed shard manifest: audit it and re-snapshot "
            "(`lint --shard --update-baseline`)"))
    for name in sorted(set(known) - set(facts)):
        findings.append(ShardFinding(
            name, "SH004", "removed",
            "manifest entry no longer produced: re-snapshot if the removal is intended"))
    for name, f in sorted(facts.items()):
        committed = known.get(name)
        if name.startswith("placement["):
            if committed is not None and f["spec_hash"] != committed.get("spec_hash"):
                findings.append(ShardFinding(
                    name, "SH004", "specs",
                    f"placement spec table drifted from the manifest (hash "
                    f"{committed.get('spec_hash')} -> {f['spec_hash']}): a leaf's split, shape or "
                    "dtype changed; verify the placement, then re-snapshot"))
            floor = max(int(SH001_MIN_FRACTION * f["total_bytes_per_chip"]), 1)
            for lname, leaf in sorted(f["leaves"].items()):
                if not leaf["replicated_model"]:
                    continue
                if leaf["bytes_global"] < SH001_MIN_BYTES and leaf["bytes_per_chip"] < floor:
                    continue
                findings.append(ShardFinding(
                    name, "SH001", lname,
                    f"{lname} {leaf['shape']} {leaf['dtype']} ({leaf['bytes_global']:,} B) is "
                    f"replicated across the model axis: every rank holds a full copy (spec "
                    f"{leaf['spec']}); shard it or accept with a justification"))
            budget = f.get("budget_bytes")
            held = f["total_bytes_per_rank"]
            held = f["total_bytes_per_chip"] if held is None else held
            if budget and held > budget:
                findings.append(ShardFinding(
                    name, "SH003", "total",
                    f"a rank holds {held:,} B of params and KV pool, over the card's budget "
                    f"{budget:,} B"))
        elif name.startswith("probe."):
            needs = f["layout_needs"]
            for key, c in sorted(f["collectives"].items()):
                extra = c["count"] - needs.get(key, 0)
                if extra > 0:
                    findings.append(ShardFinding(
                        name, "SH002", f"{key}x{extra}",
                        f"{extra} {key} collective(s) a decode turn ({c['payload_bytes']:,} B in "
                        f"{c['count']}) beyond the TP layout's {needs.get(key, 0)}: count-keyed, "
                        "so a new collective re-trips the gate; remove it or justify it"))
            for s in f["slices"]:
                if not s["written_in_place"] or s["copied"] or s["shape"] != s["spec_shape"]:
                    findings.append(ShardFinding(
                        name, "SH005", f"rank{s['rank']}:{s['leaf']}",
                        f"rank {s['rank']}'s {s['leaf']} {s['shape']} (its spec gives "
                        f"{s['spec_shape']}): written in place {s['written_in_place']}, full "
                        f"copy {s['copied']}"))
    return sorted(findings)


# ------------------------------------------------------------------- CLI ----


def run_shard(args, out) -> int:
    """``python -m dynamo_tpu_torch lint --shard``: text or stable JSON, exit 1
    on any non-accepted finding; ``--update-baseline`` re-snapshots the
    manifest (carrying justifications by key)."""
    manifest_path = Path(getattr(args, "manifest", None) or DEFAULT_SHARD_MANIFEST_PATH)
    manifest = ShardManifest.load(manifest_path)
    facts = collect_shard_facts()
    findings = check_shard_facts(facts, manifest)
    if getattr(args, "update_baseline", False):
        intrinsic = [f for f in findings if f.rule != "SH004"]
        m = ShardManifest.from_facts(facts, intrinsic, manifest)
        m.header = _shard_header()
        m.save(manifest_path)
        print(f"shard manifest updated: {len(facts)} entries, {len(intrinsic)} accepted finding"
              f"{'' if len(intrinsic) == 1 else 's'} -> {manifest_path}", file=out)
        return 0
    fresh = manifest.filter(findings)
    n_accepted = len(findings) - len(fresh)
    if getattr(args, "fmt", "text") == "json":
        doc = {"findings": [f.to_json() for f in fresh], "accepted": n_accepted,
               "total": len(findings), "entries": sorted(facts)}
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for f in fresh:
            print(f.render(), file=out)
        print(f"{len(fresh)} shard finding{'s' if len(fresh) != 1 else ''} ({n_accepted} accepted) "
              f"over {len(facts)} entries", file=out)
    return 1 if fresh else 0


def rank_resident_bytes(model, cache) -> dict:
    """A rank's resident bytes: its params and its cache (what the census's
    ``bytes_per_rank`` totals count)."""
    return {"params": sum(_nbytes(p) for p in model.parameters()),
            "cache": sum(_nbytes(t) for t in _tensors_of(cache))}


def gathered_resident_bytes(ctx) -> list:
    """Every rank of a (1, tp) mesh, as a ``engine/follower.py::call_all``
    function: its resident bytes (:func:`rank_resident_bytes` of its model
    and cache), gathered in rank order, what :func:`census_at`'s ``ranks``
    predicts."""
    import torch

    from dynamo_tpu_torch.utils.mesh import AXIS_MODEL

    mine = rank_resident_bytes(ctx.model, ctx.cache)
    row = torch.tensor([[float(mine["params"]), float(mine["cache"])]], dtype=torch.float64)
    return [dict(params=int(p), cache=int(c))
            for p, c in ctx.mesh.all_gather(row, AXIS_MODEL, dim=0).tolist()]


def census_at(model_cfg, mesh_shape: tuple, num_blocks: int, block_size: int,
              cache_dtype=None, batch: int = 2, m: Optional[int] = None,
              num_steps: int = 1) -> dict:
    """The census of one Llama config under ``mesh_shape``: each rank's
    resident bytes and rank 0's collectives in one decode dispatch of
    ``num_steps`` turns at ``batch`` rows over an ``m``-block table (what
    ``chip_smoke.py``'s ``shard`` line and the CPU gloo test hold a real
    world to)."""
    rig = dict(tag="run", kind="llama", cfg=model_cfg, blocks=num_blocks, bs=block_size,
               cache_dtype=cache_dtype)
    ranks = _rank_models(rig, mesh_shape)
    if isinstance(ranks, str):
        raise ValueError(ranks)
    m = m or 8
    return {"ranks": [rank_resident_bytes(mo, c) for mo, c in ranks],
            "collectives": collective_census(ranks[0][0], ranks[0][1], batch, m, block_size,
                                             num_steps)}


# a real mesh's collectives, keyed as the census keys them: (axis of a call,
# bytes it moves)
_MESH_OPS = {
    "all_reduce": lambda a, k: (a[1] if len(a) > 1 else k.get("axis", AXIS_MODEL),
                                _nbytes(a[0])),
    "all_gather": lambda a, k: (a[1] if len(a) > 1 else k.get("axis", AXIS_MODEL),
                                _nbytes(a[0])),
    "broadcast": lambda a, k: ("world", _nbytes(a[0])),
    "broadcast_object": lambda a, k: ("world", len(pickle.dumps(a[0] if a else k.get("obj")))),
}


@contextlib.contextmanager
def counted_collectives(mesh):
    """While the block runs, every collective this rank's ``mesh``
    (``utils/mesh.Mesh``) issues is counted into the yielded
    ``{"op:axis": {"count", "payload_bytes"}}``: what the census predicts,
    read on a real world."""
    counts: dict = {}

    def wrap(name, how):
        orig = getattr(mesh, name)

        def call(*args, **kwargs):
            axis, nbytes = how(args, kwargs)
            e = counts.setdefault(f"{name}:{axis}", {"count": 0, "payload_bytes": 0})
            e["count"] += 1
            e["payload_bytes"] += nbytes
            return orig(*args, **kwargs)

        object.__setattr__(mesh, name, call)  # the mesh is a frozen dataclass

    for name, how in _MESH_OPS.items():
        wrap(name, how)
    try:
        yield counts
    finally:
        for name in _MESH_OPS:
            object.__delattr__(mesh, name)
