"""Kernel-plane static analysis (dtkern): the audit of the port's CUDA kernels.

The counterpart of ``dynamo_tpu/analysis/kerncheck.py``, with its rule ids,
its manifest and ``--update-baseline`` contract, its replay tokens and its
fuzz mode, read for the H100.  It audits every kernel registered in
``ops/kernels/registry.py`` across that registry's geometry matrix, on the
CPU: the plans come from the wrappers' ``plan`` functions and
``csrc/launch_geometry.cuh`` (read as text), the canaries run the kernels'
plain versions.  The card's half, the kernels themselves over the same run
cases with the same poison, is ``chip_smoke.py``'s ``kern`` phase.

- **KN001, over budget**: a plan's dynamic shared memory exceeds the 227 KB
  one block may opt into, its threads exceed 1,024, or fewer than one of
  its blocks fits an SM (228 KB of shared memory, 1 KB reserved a block,
  2,048 threads).
- **KN002, out of bounds**: a grid past CUDA's limits, or a block's walk
  leaving its operand: a block-table slot past the row's own table, a tile
  past M or N or an uncovered one, a grouped work item outside its expert's
  rows (``grouped_matmul.tile_schedule``), a ragged span past T.
- **KN003, output race**: an output element that more than one block
  writes, other than through a declared reduction (B5's split-K tickets,
  decode's split-K combine, which the facts list under ``reductions``).
- **KN004, padding leak**: the plain versions over the run cases with
  NaN-poisoned padding lanes, cache blocks past each row's length and
  unreferenced blocks, int8 scales and unrouted experts, against an
  independent oracle (the serving ops' plain paths, numpy): a NaN in a live
  lane, a live lane off the oracle beyond the case's tolerance, or a
  padding or zero-length row that is not exactly 0 (ROADMAP rule 4).
- **KN005, drift**: plan (grid, threads, shared memory), ``work_cost`` and
  ``plan_cost`` per (kernel, geometry) against the committed manifest.
- **KN006, census**: each registered kernel needs its wrapper, its plain
  version, its launch counter and a ``chip_smoke.py`` probe, and every
  wrapper of ``ops/kernels.wrappers()`` must be registered; a kernel with a
  float16 body (its ``dtypes``) also needs its ``launches_fp16`` counter
  and a float16 run case.  The two-kernel split (B1 and B3 separate, the
  unified kernel a placeholder) is a permanent finding whose accepted
  entry is its pin, as in the JAX plane.

Facts commit to ``analysis/kern_manifest.json`` under the manifest contract
the metrics plane keeps (``metcheck.MetricsManifest``).  ``DTKERN_BUDGET`` /
``DTKERN_SEED_BASE`` add seeded random ragged geometries to the KN004
canaries (never to the manifest); a failing one prints a ``dtk1.`` token
that ``lint --kern --replay`` re-runs.

Caveats (also in the manifest header): the CPU checks the plans' geometry
and the plain versions' semantics, not the kernels' code; a walk (KN002,
KN003) is the plan's coverage in Python, what the launch asks of the
kernel, and the kernels are held to their plain versions on the card.
"""

from __future__ import annotations

import base64
import json
import math
import os
import zlib
from pathlib import Path

from dynamo_tpu_torch.analysis.metcheck import MetricFinding as KernFinding
from dynamo_tpu_torch.analysis.metcheck import MetricsManifest as KernManifest

__all__ = [
    "DEFAULT_KERN_MANIFEST_PATH",
    "KERN_RULES",
    "KernFinding",
    "KernManifest",
    "canary_failed",
    "check_kern_facts",
    "collect_kern_facts",
    "decode_token",
    "encode_token",
    "run_kern",
    "walk_facts",
]

DEFAULT_KERN_MANIFEST_PATH = Path(__file__).parent / "kern_manifest.json"
CENSUS = "(kern-census)"

_TOKEN_PREFIX = "dtk1."

KERN_RULES = {
    "KN001": ("over-budget",
              "a plan's shared memory, threads or blocks per SM are past what "
              "one H100 SM gives a block"),
    "KN002": ("out-of-bounds",
              "a grid past CUDA's limits, or a block's walk leaves its operand "
              "or leaves part of the output unwritten"),
    "KN003": ("output-race",
              "an output element written by more than one block outside a "
              "declared reduction"),
    "KN004": ("padding-leak",
              "a NaN canary in padding lanes / dead cache slots / unrouted "
              "experts reached a live lane, a live lane is off the oracle, or a "
              "padding or zero-length row is not exactly 0"),
    "KN005": ("kernel-drift",
              "plan, shared memory, grid, work or plan cost drifted vs the "
              "committed kern manifest (re-snapshot deliberately with "
              "--update-baseline)"),
    "KN006": ("census-drift",
              "kernel census out of sync: the two-kernel decode/ragged split, "
              "or a kernel without its wrapper, plain version, counter or "
              "chip_smoke.py probe"),
}

_MANIFEST_NOTE = (
    "CPU-derived facts of the port's CUDA kernels over the registry geometry "
    "matrix (ops/kernels/registry.py): plans from the wrappers' plan "
    "functions and csrc/launch_geometry.cuh, budgets against one H100 SM, "
    "walks (KN002/KN003) modelling each plan's coverage in Python, and KN004 "
    "canaries running the kernels' PLAIN versions on the CPU with NaN-poisoned "
    "padding against the serving ops' plain paths; the kernels themselves "
    "are held to their plain versions over the same run cases on the card "
    "by chip_smoke.py's kern phase.  Serving-scale geometries are spec-only "
    "(plan and pricing).  The accepted two-kernel-split entry pins the "
    "unified ragged kernel (arxiv 2604.15464) as unwritten: landing it "
    "re-trips KN006."
)


def _kern_header() -> dict:
    from dynamo_tpu_torch.obs.topology import CONSTANTS_VERSION
    from dynamo_tpu_torch.ops.kernels.registry import H100_SMS, LIMITS

    return {"note": _MANIFEST_NOTE,
            "card": {"name": "H100 SXM", "sms": H100_SMS, **LIMITS},
            "constants_version": CONSTANTS_VERSION}


# ------------------------------------------------------------ replay token


def encode_token(payload: dict) -> str:
    raw = json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
    return _TOKEN_PREFIX + base64.urlsafe_b64encode(zlib.compress(raw, 9)).decode().rstrip("=")


def decode_token(token: str) -> dict:
    if not token.startswith(_TOKEN_PREFIX):
        raise ValueError(f"not a dtkern replay token: {token[:16]!r}")
    body = token[len(_TOKEN_PREFIX):]
    body += "=" * (-len(body) % 4)
    return json.loads(zlib.decompress(base64.urlsafe_b64decode(body)))


def _budget_env() -> tuple[int, int, bool]:
    """(budget, seed_base, pinned): the pinned default (budget 1, seed base
    0) audits exactly the committed matrix; a larger budget or another seed
    base adds fuzz geometries that never enter the manifest."""
    budget = max(1, int(os.environ.get("DTKERN_BUDGET", "1") or 1))
    seed_base = int(os.environ.get("DTKERN_SEED_BASE", "0") or 0)
    return budget, seed_base, budget == 1 and seed_base == 0


# ------------------------------------------------------------------ walks


def _cover(starts, width: int, total: int) -> list[int]:
    """How many of the ranges [s, s + width) clipped to [0, total) hold
    each of the ``total`` positions."""
    hits = [0] * total
    for s in starts:
        for i in range(max(0, s), min(total, s + width)):
            hits[i] += 1
    return hits


def _coverage_findings(label: str, hits: list[int], oob: list, races: list) -> None:
    if any(h == 0 for h in hits):
        oob.append({"operand": label, "uncovered": hits.index(0)})
    if any(h > 1 for h in hits):
        races.append({"operand": label, "index": next(i for i, h in enumerate(hits) if h > 1),
                      "writers": max(hits)})


def _grid_findings(grid, oob: list) -> None:
    from dynamo_tpu_torch.ops.kernels.registry import LIMITS

    x, y, z = (list(grid) + [1, 1])[:3]
    if not 1 <= x <= LIMITS["grid_x"] or not (1 <= y <= LIMITS["grid_yz"] and 1 <= z <= LIMITS["grid_yz"]):
        oob.append({"operand": "grid", "grid": [x, y, z]})


def _table_findings(starts_or_lens, m: int, bs: int, oob: list) -> None:
    """A row reading ``n`` context slots walks table slots [0, ceil(n / Bs)),
    which must lie in its own table of ``m`` blocks."""
    for r, n in enumerate(starts_or_lens):
        if -(-n // bs) > m:
            oob.append({"operand": "block_tables", "row": r, "slot": -(-n // bs) - 1, "table": m})


def _decode_walk(p, g, oob, races, red) -> None:
    s, groups = g["s"], g["h"] // g["hk"]
    _coverage_findings("q_rows", _cover([p.rows * i for i in range(p.row_groups)], p.rows, s * groups),
                       oob, races)
    _coverage_findings("context", _cover([p.chunk * c for c in range(p.n_chunks)], p.chunk,
                                         g["m"] * g["bs"]), oob, races)
    _table_findings(g["lens"], g["m"], g["bs"], oob)
    if any(-(-n // p.chunk) > 1 for n in g["lens"]):
        red.append("split-K combine (tickets)")


def _prefill_walk(p, g, oob, races, red) -> None:
    tiles = p.grid[2]
    _coverage_findings("tokens", _cover([p.tq * (tiles - 1 - z) for z in range(tiles)], p.tq, g["s"]),
                       oob, races)
    _table_findings(g["starts"], g["m"], g["bs"], oob)
    if p.tq * p.group > 128:
        oob.append({"operand": "rows", "rows": p.tq * p.group})


def _ragged_walk(p, g, oob, races, red) -> None:
    t = g["t"]
    starts, lens, offs = g["starts"], g["lens"], g["offs"]
    decode = [r for r, (st, n) in enumerate(zip(starts, lens)) if n - st == 1]
    owner = [-1] * t
    for r, (st, n, off) in enumerate(zip(starts, lens, offs)):
        f = n - st
        if f > 0 and (off < 0 or off + f > t):
            oob.append({"operand": "span", "row": r, "span": [off, off + f], "tokens": t})
            continue
        for i in range(off, off + max(f, 0)):
            if owner[i] != -1:
                races.append({"operand": "tokens", "index": i, "rows": [owner[i], r]})
            owner[i] = r
    # span blocks write every token of their tile but decode rows', which
    # the rows' own decode-row blocks write instead: one writer a token
    hits = _cover([p.tq * y for y in range(p.span_blocks)], p.tq, t)
    if p.decode_blocks < len(starts) and decode:
        oob.append({"operand": "decode_blocks", "blocks": p.decode_blocks, "rows": len(starts)})
    _coverage_findings("tokens", hits, oob, races)
    _table_findings(starts, g["m"], g["bs"], oob)


def _matmul_walk(p, g, oob, races, red) -> None:
    m, k, n = g["m"], g["k"], g["n"]
    _coverage_findings("n", _cover([p.bn * i for i in range(p.grid[0])], p.bn, n), oob, races)
    _coverage_findings("m", _cover([p.bm * i for i in range(p.grid[1])], p.bm, m), oob, races)
    depth = p.k_steps * p.bk
    _coverage_findings("k", _cover([depth * z for z in range(p.splits)], depth, k), oob, races)
    if p.splits > 1:
        red.append("split-K tickets")


def _grouped_walk(p, g, oob, races, red) -> None:
    from dynamo_tpu_torch.ops.kernels.grouped_matmul import tile_schedule
    from dynamo_tpu_torch.ops.kernels.registry import _counts

    counts = _counts(g)
    bounds = [0]
    for c in counts:
        bounds.append(bounds[-1] + c)
    n = g["n"]
    writes: dict[tuple[int, int], int] = {}
    for items in tile_schedule(counts, p.rows, p.grid_n, p.blocks, p.channels):
        for e, row0, rows, ch0 in items:
            if row0 < bounds[e] or row0 + rows > bounds[e + 1] or not 0 <= ch0 < n:
                oob.append({"operand": "rows", "expert": e, "rows": [row0, row0 + rows],
                            "group": [bounds[e], bounds[e + 1]], "channel": ch0})
                continue
            key = (row0, ch0)
            writes[key] = writes.get(key, 0) + 1
    tiles = [(row0, ch) for e in range(len(counts)) for row0 in range(bounds[e], bounds[e + 1], p.rows)
             for ch in range(0, n, p.channels)]
    hits = [writes.get(key, 0) for key in tiles]
    _coverage_findings("tiles", hits, oob, races)


_WALKS = {"paged_decode": _decode_walk, "paged_prefill": _prefill_walk, "ragged": _ragged_walk,
          "int8_matmul": _matmul_walk, "grouped": _grouped_walk}


def walk_facts(kernel: str, geometry: dict, plans: list) -> dict:
    """KN002/KN003 facts: the plan's grid against CUDA's limits, and its
    coverage of the operands and the output, modelled in Python."""
    oob: list = []
    races: list = []
    red: list = []
    calls = geometry.get("calls", [geometry])
    walk = next(fn for prefix, fn in _WALKS.items() if kernel.startswith(prefix))
    for g, p in zip(calls, plans):
        _grid_findings(p.grid if hasattr(p, "grid") else (p.blocks,), oob)
        walk(p, g, oob, races, red)
    return {"oob": oob[:8], "races": races[:8], "reductions": sorted(set(red))}


# ------------------------------------------------------------- canaries


def _canary_facts(case: dict) -> dict:
    """KN004: the wrapper's plain version on the clean inputs against the
    oracle's live lanes (and exact zeros), then on the NaN-poisoned ones,
    whose live lanes must stay finite and on the oracle, and whose padding
    and zero-length rows must stay exactly 0."""
    import numpy as np

    from dynamo_tpu_torch.ops.kernels import registry

    inp = registry.build(case)
    ref, live, zero = registry.oracle(case, inp)
    out = registry.run(case, inp).float().numpy()
    pout = registry.run(case, registry.poison(case, inp)).float().numpy()
    err = float(np.abs(out - ref)[live].max()) if live.any() else 0.0
    nonfinite = int((~np.isfinite(pout[live])).sum())
    perr = (float(np.abs(pout - ref)[live].max()) if live.any() and not nonfinite
            else math.inf if nonfinite else 0.0)
    zero_ok = bool((out[zero] == 0).all() and (pout[zero] == 0).all()) if zero.any() else True
    return {
        "ran": True,
        "atol": float(case["atol"]),
        "max_abs_err": round(err, 9),
        "poisoned_max_abs_err": round(perr, 9) if math.isfinite(perr) else "inf",
        "nonfinite_live": nonfinite,
        "zero_rows_ok": zero_ok,
        "live_lanes": int(live.sum()),
        "zero_lanes": int(zero.sum()),
    }


def canary_failed(canary: dict) -> bool:
    if not canary.get("ran"):
        return False
    perr = canary["poisoned_max_abs_err"]
    perr = math.inf if perr == "inf" else float(perr)
    return (canary["nonfinite_live"] > 0 or canary["max_abs_err"] > canary["atol"]
            or perr > canary["atol"] or not canary["zero_rows_ok"])


# -------------------------------------------------------------- collect


def _case_facts(case: dict) -> dict:
    from dynamo_tpu_torch.ops.kernels import registry

    g = case["geometry"]
    calls = g.get("calls", [g])
    plans = [registry.plan_of(case["kernel"], c) for c in calls]
    facts = [registry.plan_facts(p) for p in plans]
    return {
        "kernel": case["kernel"],
        "geometry": case["name"],
        "mode": case["mode"],
        "plan": facts[0] if len(facts) == 1 else facts,
        "budget": {
            "smem": max(f["smem"] for f in facts),
            "threads": max(f["threads"] for f in facts),
            "blocks_per_sm": min(f["blocks_per_sm"] for f in facts),
        },
        "walk": walk_facts(case["kernel"], g, plans),
        "canary": _canary_facts(case) if case["mode"] == "run" else {"ran": False},
        "work": registry.work_cost(case["kernel"], g),
        "plan_cost": registry.plan_cost(case["kernel"], g),
    }


def _smoke_functions(root: Path) -> set[str]:
    import ast

    path = root / "chip_smoke.py"
    if not path.is_file():
        return set()
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def _census_facts(root: Path) -> dict:
    import importlib

    from dynamo_tpu_torch.ops.kernels import registry, wrappers

    geoms: dict[str, list] = {}
    run_cases, fp16_runs = set(), set()
    for case in registry.audit_cases():
        geoms.setdefault(case["kernel"], []).append(case["name"])
        if case["mode"] == "run":
            run_cases.add(case["kernel"])
            if case.get("dtype") == "float16":
                fp16_runs.add(case["kernel"])
    probes = _smoke_functions(root)
    kernels = {}
    for name, meta in sorted(registry.KERNELS.items()):
        if meta["placeholder"]:
            kernels[name] = {"module": None, "placeholder": True, "wrapper": False, "plain": False,
                             "counter": False, "probed": False, "geometries": []}
            continue
        mod = importlib.import_module(meta["module"])
        fn = getattr(mod, meta["wrapper"], None)
        kernels[name] = {
            "id": meta["id"],
            "module": meta["module"].split(".", 1)[1],
            "placeholder": False,
            "wrapper": callable(fn),
            "plain": callable(getattr(mod, meta["plain"], None)),
            "counter": isinstance(getattr(fn, meta["counter"], None), int),
            "probed": meta["probe"] in probes and name in run_cases,
            "geometries": sorted(geoms.get(name, [])),
            "dtypes": list(meta["dtypes"]),
        }
        if "float16" in meta["dtypes"]:
            kernels[name].update(counter_fp16=isinstance(getattr(fn, "launches_fp16", None), int),
                                 probed_fp16=meta["probe"] in probes and name in fp16_runs)
    return {"kernels": kernels, "split": dict(registry.SPLIT),
            "unregistered": sorted(fn.__name__ for fn in wrappers().values()
                                   if fn.__name__ not in registry.KERNELS)}


def _entry(case: dict) -> str:
    return f"cuda.{case['kernel']}[{case['name']}]"


def collect_kern_facts(budget: int = 1, seed_base: int = 0, root: Path | None = None) -> dict:
    """The kernel-plane snapshot: one entry per (kernel, geometry) of the
    registry matrix plus the census; ``budget > 1`` or a nonzero seed base
    adds seeded fuzz geometries (canary-only, never in the manifest)."""
    from dynamo_tpu_torch.ops.kernels.registry import audit_cases, fuzz_case

    root = root or Path(__file__).resolve().parents[2]
    cases = list(audit_cases())
    if budget > 1 or seed_base:
        cases += [fuzz_case(seed_base + i) for i in range(budget)]
    facts = {_entry(c): _case_facts(c) for c in cases}
    facts[CENSUS] = _census_facts(root)
    return facts


# ---------------------------------------------------------------- check


def _is_fuzz(name: str) -> bool:
    return "[fuzz[" in name


def _check_census(census: dict) -> list[KernFinding]:
    findings = []
    split = census.get("split", {})
    kernels = census.get("kernels", {})
    unified = split.get("unified")
    unified_real = bool(unified and not kernels.get(unified, {}).get("placeholder", True))
    if split.get("decode") and split.get("ragged_prefill") and not unified_real:
        findings.append(KernFinding(
            CENSUS, "KN006", "two-kernel-split",
            f"decode ({split['decode']}) and ragged prefill ({split['ragged_prefill']}) are "
            "separate kernels and the unified ragged kernel is a placeholder: the Ragged Paged "
            "Attention design (arxiv 2604.15464) is one kernel for both; this acceptance is the "
            "pin, and landing it re-trips",
        ))
    for kname, meta in sorted(kernels.items()):
        if meta.get("placeholder"):
            continue
        parts = ("wrapper", "plain", "counter", "probed")
        if "float16" in meta.get("dtypes", ()):
            parts += ("counter_fp16", "probed_fp16")
        for part in parts:
            if not meta.get(part):
                findings.append(KernFinding(
                    CENSUS, "KN006", f"{part}:{kname}",
                    f"registered kernel {kname} has no {part.rstrip('d')}: each kernel needs its "
                    "wrapper, its plain version, its launch counter and a chip_smoke.py probe "
                    "holding it to the plain version on the card",
                ))
    for name in census.get("unregistered", []):
        findings.append(KernFinding(
            CENSUS, "KN006", f"unregistered:{name}",
            f"kernel wrapper {name} is not in the registry's KERNELS: no plane audits it",
        ))
    return findings


def check_kern_facts(facts: dict, manifest: KernManifest, drift: bool = True) -> list[KernFinding]:
    """Findings = drift vs the committed manifest (KN005) + intrinsic
    defects (KN001-KN004, KN006).  Fuzz entries are canary-only."""
    from dynamo_tpu_torch.ops.kernels.registry import LIMITS

    findings: list[KernFinding] = []
    known = manifest.entrypoints
    if drift:
        for name in sorted(set(facts) - set(known)):
            if not _is_fuzz(name):
                findings.append(KernFinding(
                    name, "KN005", "added",
                    "fact entry not in the committed kern manifest: audit it and re-snapshot "
                    "(`lint --kern --update-baseline`)"))
        for name in sorted(set(known) - set(facts)):
            findings.append(KernFinding(
                name, "KN005", "removed",
                "manifest entry no longer produced: re-snapshot if the removal is intended"))
    for name, f in sorted(facts.items()):
        if name == CENSUS:
            findings.extend(_check_census(f))
            continue
        b = f["budget"]
        if (b["smem"] > LIMITS["smem_per_block"] or b["threads"] > LIMITS["threads_per_block"]
                or b["blocks_per_sm"] < 1):
            findings.append(KernFinding(
                name, "KN001", "budget",
                f"a block takes {b['smem']:,} B of shared memory (limit "
                f"{LIMITS['smem_per_block']:,}) and {b['threads']} threads (limit "
                f"{LIMITS['threads_per_block']}); {b['blocks_per_sm']} fit an SM"))
        for o in f["walk"]["oob"]:
            findings.append(KernFinding(
                name, "KN002", str(o.get("operand")),
                f"the plan's walk leaves its operand or the output: {json.dumps(o, sort_keys=True)}"))
        for r in f["walk"]["races"]:
            findings.append(KernFinding(
                name, "KN003", str(r.get("operand")),
                f"more than one block writes the same output outside a declared reduction: "
                f"{json.dumps(r, sort_keys=True)}"))
        if canary_failed(f["canary"]):
            c = f["canary"]
            findings.append(KernFinding(
                name, "KN004", "padding-leak",
                f"NaN canary reached live lanes ({c['nonfinite_live']} nonfinite) or live lanes "
                f"diverge from the oracle (clean err {c['max_abs_err']}, poisoned err "
                f"{c['poisoned_max_abs_err']}, atol {c['atol']}, zero rows "
                f"{'ok' if c['zero_rows_ok'] else 'VIOLATED'})"))
        committed = known.get(name)
        if not drift or committed is None or _is_fuzz(name):
            continue
        for key, what in (("work", "work cost"), ("plan_cost", "plan cost"), ("plan", "plan")):
            if f[key] != committed.get(key):
                findings.append(KernFinding(
                    name, "KN005", key,
                    f"{what} drifted: {json.dumps(committed.get(key), sort_keys=True)} -> "
                    f"{json.dumps(f[key], sort_keys=True)}; verify, then re-snapshot"))
    return sorted(findings)


# ------------------------------------------------------------------ CLI

# paths whose changes can move kernel-plane facts (for ``--changed``)
_TOUCHES = (
    "dynamo_tpu_torch/ops/kernels/",
    "dynamo_tpu_torch/csrc/",
    "dynamo_tpu_torch/ops/kv_quant.py",
    "dynamo_tpu_torch/ops/paged_attention.py",
    "dynamo_tpu_torch/analysis/kerncheck.py",
    "dynamo_tpu_torch/analysis/kern_manifest.json",
    "chip_smoke.py",
)


def _kern_affected(root: Path) -> bool:
    from dynamo_tpu_torch.analysis.cli import _git_changed_paths

    dirty = [str(p) for p in _git_changed_paths(root, suffixes=(".py", ".json", ".cu", ".cuh"))]
    return any(frag in d for d in dirty for frag in _TOUCHES)


def _replay(token: str, fmt: str, out) -> int:
    """Re-run one fuzz geometry from its replay token (KN004 only)."""
    from dynamo_tpu_torch.ops.kernels.registry import fuzz_case

    seed = int(decode_token(token)["seed"])
    case = fuzz_case(seed)
    canary = _canary_facts(case)
    failed = canary_failed(canary)
    if fmt == "json":
        print(json.dumps({"geometry": case["name"], "seed": seed, "canary": canary, "failed": failed},
                         indent=2, sort_keys=True), file=out)
    else:
        print(f"{case['name']}: clean err {canary['max_abs_err']} / poisoned err "
              f"{canary['poisoned_max_abs_err']} (atol {canary['atol']}), "
              f"{canary['nonfinite_live']} nonfinite live lanes -> "
              f"{'PADDING LEAK' if failed else 'clean'}", file=out)
    return 1 if failed else 0


def _fuzz_tokens(fresh: list[KernFinding], facts: dict) -> dict:
    tokens = {}
    for f in fresh:
        if _is_fuzz(f.entrypoint):
            seed = int(facts[f.entrypoint]["geometry"].split("ragged-")[1].rstrip("]"))
            tokens[f.entrypoint] = encode_token({"seed": seed})
    return tokens


def run_kern(args, out) -> int:
    """``python -m dynamo_tpu_torch lint --kern``: audit the registry
    matrix against the committed kern manifest, exit 1 on any non-accepted
    finding.  ``--update-baseline`` re-snapshots (pinned runs only);
    ``--replay dtk1.TOKEN`` re-runs one fuzz geometry."""
    token = getattr(args, "replay", None)
    if token:
        if not token.startswith(_TOKEN_PREFIX):
            print(f"not a dtkern replay token: {token[:16]!r} (expected {_TOKEN_PREFIX}...)", file=out)
            return 2
        return _replay(token, getattr(args, "fmt", "text"), out)

    manifest_path = Path(getattr(args, "manifest", None) or DEFAULT_KERN_MANIFEST_PATH)
    manifest = KernManifest.load(manifest_path)
    budget, seed_base, pinned = _budget_env()
    root = Path(getattr(args, "root", None) or Path(__file__).resolve().parents[2])
    if getattr(args, "changed", False) and not _kern_affected(root):
        print("kernel plane unaffected by changed files", file=out)
        return 0
    facts = collect_kern_facts(budget=budget, seed_base=seed_base)
    findings = check_kern_facts(facts, manifest, drift=pinned)

    if getattr(args, "update_baseline", False):
        if not pinned:
            print("refusing to update the kern manifest from a non-default-budget/seed fuzz run",
                  file=out)
            return 2
        intrinsic = [f for f in findings if f.rule != "KN005"]
        m = KernManifest.from_facts(facts, intrinsic, manifest)
        m.header = _kern_header()
        m.save(manifest_path)
        print(f"kern manifest updated: {len(facts)} entries, {len(intrinsic)} accepted finding"
              f"{'' if len(intrinsic) == 1 else 's'} -> {manifest_path}", file=out)
        return 0

    fresh = manifest.filter(findings)
    n_accepted = len(findings) - len(fresh)
    n_fuzz = sum(1 for name in facts if _is_fuzz(name))
    tokens = _fuzz_tokens(fresh, facts)
    if getattr(args, "fmt", "text") == "json":
        doc = {"findings": [f.to_json() for f in fresh], "accepted": n_accepted,
               "total": len(findings), "entries": sorted(facts),
               "fuzz": {"budget": budget, "seed_base": seed_base, "replay_tokens": tokens}}
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for f in fresh:
            print(f.render(), file=out)
        for name, tok in sorted(tokens.items()):
            print(f"  replay: python -m dynamo_tpu_torch lint --kern --replay {tok}", file=out)
        print(f"{len(fresh)} kern finding{'s' if len(fresh) != 1 else ''} ({n_accepted} accepted) "
              f"over {len(facts)} entries" + (f" incl. {n_fuzz} fuzz geometries" if n_fuzz else ""),
              file=out)
    return 1 if fresh else 0
