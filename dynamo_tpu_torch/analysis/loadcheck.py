"""Scale-simulation plane (dtload): the capacity-manifest gate.

The counterpart of the JAX package's ``analysis/loadcheck.py``, with its
rules, thresholds, replay tokens and manifest format.
``python -m dynamo_tpu_torch lint --load`` runs the port's macro-simulation
sweep (``dynamo_tpu_torch/load``) — the REAL KvIndexer/KvScheduler,
admission controller and planner policy on a seeded DetLoop, workers
simulated from the card's committed serving figures
(``load/card_latency.json``) — and diffs the resulting capacity surface
against the port's committed ``analysis/load_manifest.json``:

    LD001  capacity regression: a (cell, level)'s p99 TTFT grew past
           1.3x the committed value, its shed rate rose by more than
           5 points, or its completions fell below 80% of committed
    LD002  SLA knee drift: the lowest load level that breaches the
           cell's TTFT SLA (or sheds > 1%) moved DOWN — the system
           saturates earlier than the committed surface says
    LD003  nondeterminism: two runs of the same cell with the same
           seed produced different canonical bytes (never acceptable
           by justification — fix the leak)
    LD004  scenario census drift: the cell grid, load levels, or a
           cell's event census changed shape vs the manifest
    LD005  shard scaling violated: a sharded-router cell (wNrK, K>1)
           fails to knee strictly later than its singleton twin (wNr1),
           or fails to sustain >= 2x the singleton's offered load
           before its knee — the structural claim of the sharded
           control plane (never acceptable by justification)

Same contract as the protocol plane: accepted findings carry a
one-line justification and match as a (scenario, rule, key) multiset;
``--update-baseline`` re-snapshots facts and carries justifications;
drift rules (LD001/LD002/LD004) only judge the pinned default sweep —
DTLOAD_BUDGET/DTLOAD_SEED_BASE/DTLOAD_TARGET/DTLOAD_SCALE overrides
explore more seeds or other operating points without drift noise
(LD003 still applies: determinism must hold at every seed; LD005, like
LD003, can never be baked into the baseline).

Every LD001/LD002 finding carries a ``dtl1.`` replay token; ``lint
--load --replay TOKEN`` re-runs exactly that cell and prints its
metrics, so a nightly regression reproduces locally in one command.  The
token format is the JAX plane's: a JAX token replays here (at the port's
latency model).
"""

from __future__ import annotations

import base64
import json
import os
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

__all__ = [
    "LOAD_RULES",
    "LoadFinding",
    "LoadManifest",
    "encode_token",
    "decode_token",
    "check_load",
    "run_load",
    "DEFAULT_LOAD_MANIFEST_PATH",
]

DEFAULT_LOAD_MANIFEST_PATH = Path(__file__).parent / "load_manifest.json"

_MANIFEST_NOTE = (
    "Committed capacity surface (python -m dynamo_tpu_torch lint --load): "
    "per-cell latency/shed/routing metrics at each offered-load level from "
    "the pinned-seed macro-simulation of the port's control plane at "
    "virtual time, workers priced from load/card_latency.json.  Regenerate "
    "with --load --update-baseline; every accepted entry needs a real "
    "justification."
)

LOAD_RULES = {
    "LD001": "capacity regression vs the committed surface (p99 TTFT, "
             "shed rate, or completions)",
    "LD002": "SLA knee moved to a lower offered-load level",
    "LD003": "same-seed twin runs diverged (nondeterminism)",
    "LD004": "cell grid / level / census drifted from the manifest",
    "LD005": "sharded-router cell fails its scaling claim vs the "
             "singleton twin (knee not later, or < 2x sustained load)",
}

# drift rules are resolved by re-snapshotting, not by justification
_DRIFT_RULES = ("LD001", "LD002", "LD004")

_TOKEN_PREFIX = "dtl1."

# LD001 thresholds: generous enough that scheduler-seed jitter inside
# one pinned run never trips them, tight enough that doubling a stage's
# latency or halving capacity always does
_P99_RATIO = 1.3
_P99_FLOOR_MS = 5.0
_SHED_DELTA = 0.05
_COMPLETED_RATIO = 0.8


# ---------------------------------------------------------------- findings


@dataclass(frozen=True, order=True)
class LoadFinding:
    """One load-plane finding.  ``(scenario, rule, key)`` is the stable
    acceptance key — scenario is the cell name ("family/topology");
    replay tokens live in ``detail`` only."""

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


class LoadManifest:
    """Committed capacity surface + accepted (justified) findings."""

    def __init__(self, cells: Optional[dict] = None,
                 accepted: Optional[list[dict]] = None,
                 header: Optional[dict] = None,
                 params: Optional[dict] = None):
        self.cells: dict = cells or {}
        self.accepted: list[dict] = accepted or []
        self.header: dict = header or {}
        self.params: dict = params or {}

    @classmethod
    def load(cls, path: Path) -> "LoadManifest":
        if not Path(path).is_file():
            return cls()
        data = json.loads(Path(path).read_text())
        return cls(dict(data.get("cells", {})),
                   list(data.get("accepted", [])),
                   dict(data.get("header", {})),
                   dict(data.get("params", {})))

    def save(self, path: Path) -> None:
        doc = {
            "version": 1,
            "header": self.header or {"note": _MANIFEST_NOTE},
            "params": self.params,
            "cells": self.cells,
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

    def filter(self, findings: list[LoadFinding]) -> list[LoadFinding]:
        """Findings NOT covered by an accepted entry (stable-sorted)."""
        budget = self._counts()
        fresh: list[LoadFinding] = []
        for f in sorted(findings):
            if budget.get(f.accept_key, 0) > 0:
                budget[f.accept_key] -= 1
            else:
                fresh.append(f)
        return fresh

    @classmethod
    def from_facts(cls, facts: dict, findings: list[LoadFinding],
                   previous: "LoadManifest") -> "LoadManifest":
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
        return cls(facts["cells"], accepted, previous.header or None,
                   facts.get("params", {}))


# ------------------------------------------------------------ replay token


def encode_token(payload: dict) -> str:
    raw = json.dumps(payload, sort_keys=True,
                     separators=(",", ":")).encode()
    return _TOKEN_PREFIX + base64.urlsafe_b64encode(
        zlib.compress(raw, 9)).decode().rstrip("=")


def decode_token(token: str) -> dict:
    if not token.startswith(_TOKEN_PREFIX):
        raise ValueError(f"not a dtload replay token: {token[:16]!r}")
    body = token[len(_TOKEN_PREFIX):]
    body += "=" * (-len(body) % 4)
    return json.loads(zlib.decompress(base64.urlsafe_b64decode(body)))


def _cell_token(cell: str, level: float, seed: int, target: int) -> str:
    family, topology = cell.split("/", 1)
    return encode_token({"family": family, "topology": topology,
                         "level": level, "seed": seed, "target": target})


# ------------------------------------------------------------------ checks


def _knee_rank(knee) -> float:
    return float("inf") if knee is None else float(knee)


def _sustained_rps(cell_obs: dict) -> float:
    """Highest offered load the cell held BEFORE its SLA knee (or over
    the whole grid when it never kneed)."""
    knee = _knee_rank(cell_obs.get("knee_level"))
    held = [m.get("offered_rps", 0.0)
            for lvl, m in cell_obs.get("levels", {}).items()
            if float(lvl) < knee]
    return max(held, default=0.0)


def _shard_scaling(facts: dict) -> list[LoadFinding]:
    """LD005: every sharded-router cell must beat its singleton twin —
    the load manifest is the committed proof of ROADMAP item 1."""
    findings: list[LoadFinding] = []
    cells = facts["cells"]
    for cell in sorted(cells):
        family, topo = cell.split("/", 1)
        base, _, k = topo.rpartition("r")
        if not base or not k.isdigit() or int(k) <= 1:
            continue
        singleton = f"{family}/{base}r1"
        if singleton not in cells:
            continue
        obs, ref = cells[cell], cells[singleton]
        if _knee_rank(obs.get("knee_level")) <= \
                _knee_rank(ref.get("knee_level")):
            findings.append(LoadFinding(
                cell, "LD005", "knee",
                f"knee at level {obs.get('knee_level')} is not strictly "
                f"later than the singleton twin's "
                f"({ref.get('knee_level')})"))
        held, ref_held = _sustained_rps(obs), _sustained_rps(ref)
        if held < 2.0 * ref_held:
            findings.append(LoadFinding(
                cell, "LD005", "sustained",
                f"sustains {held:.2f} rps before the knee vs singleton "
                f"{ref_held:.2f} rps — below the 2x scaling claim"))
    return findings


def check_load(facts: dict, manifest: LoadManifest, *,
               drift: bool = True, seed_base: int = 0) -> list[LoadFinding]:
    """Diff an observed sweep against the committed surface."""
    findings: list[LoadFinding] = []
    target = int(facts.get("params", {}).get("target_requests", 0))
    for cell, obs in sorted(facts["cells"].items()):
        if not obs.get("twin_match", True):
            findings.append(LoadFinding(
                cell, "LD003", "determinism",
                "two runs of this cell with the same seed produced "
                "different canonical bytes"))
    if not drift:
        return findings
    # the scaling claim is a property of the pinned surface itself, not
    # a diff against the manifest — judged whenever drift rules are
    findings.extend(_shard_scaling(facts))
    com_cells = manifest.cells
    for cell in sorted(set(facts["cells"]) - set(com_cells)):
        findings.append(LoadFinding(
            cell, "LD004", "+cell",
            "cell absent from the committed load manifest "
            "(run --load --update-baseline)"))
    for cell in sorted(set(com_cells) - set(facts["cells"])):
        findings.append(LoadFinding(
            cell, "LD004", "-cell",
            "committed cell no longer swept"))
    for cell, obs in sorted(facts["cells"].items()):
        com = com_cells.get(cell)
        if com is None:
            continue
        obs_levels, com_levels = obs["levels"], com.get("levels", {})
        for lvl in sorted(set(obs_levels) - set(com_levels), key=float):
            findings.append(LoadFinding(
                cell, "LD004", f"+level:{lvl}",
                f"level {lvl} not in the committed surface"))
        for lvl in sorted(set(com_levels) - set(obs_levels), key=float):
            findings.append(LoadFinding(
                cell, "LD004", f"-level:{lvl}",
                f"committed level {lvl} no longer swept"))
        obs_census = set(obs.get("census", {}))
        com_census = set(com.get("census", {}))
        for k in sorted(obs_census - com_census):
            findings.append(LoadFinding(
                cell, "LD004", f"+census:{k}",
                f"new event kind {k!r} in the cell's census"))
        for k in sorted(com_census - obs_census):
            findings.append(LoadFinding(
                cell, "LD004", f"-census:{k}",
                f"committed event kind {k!r} no longer occurs"))
        for lvl in sorted(set(obs_levels) & set(com_levels), key=float):
            o, c = obs_levels[lvl], com_levels[lvl]
            token = _cell_token(cell, float(lvl), seed_base, target)
            old_p99 = c.get("ttft_p99_ms", 0.0)
            new_p99 = o.get("ttft_p99_ms", 0.0)
            if (new_p99 > _P99_RATIO * max(old_p99, _P99_FLOOR_MS)):
                findings.append(LoadFinding(
                    cell, "LD001", f"p99:{lvl}",
                    f"p99 TTFT {new_p99:.1f}ms vs committed "
                    f"{old_p99:.1f}ms at level {lvl} "
                    f"[replay {token}]"))
            old_shed = c.get("shed_rate", 0.0)
            new_shed = o.get("shed_rate", 0.0)
            if new_shed - old_shed > _SHED_DELTA:
                findings.append(LoadFinding(
                    cell, "LD001", f"shed:{lvl}",
                    f"shed rate {new_shed:.3f} vs committed "
                    f"{old_shed:.3f} at level {lvl} "
                    f"[replay {token}]"))
            old_done = c.get("completed", 0)
            if old_done and o.get("completed", 0) < \
                    _COMPLETED_RATIO * old_done:
                findings.append(LoadFinding(
                    cell, "LD001", f"completed:{lvl}",
                    f"completed {o.get('completed', 0)} vs committed "
                    f"{old_done} at level {lvl} [replay {token}]"))
        obs_knee = _knee_rank(obs.get("knee_level"))
        com_knee = _knee_rank(com.get("knee_level"))
        if obs_knee < com_knee:
            token = _cell_token(cell, obs.get("knee_level"), seed_base,
                                target)
            findings.append(LoadFinding(
                cell, "LD002", "knee",
                f"SLA knee moved down: level {obs.get('knee_level')} "
                f"now breaches (committed: {com.get('knee_level')}) "
                f"[replay {token}]"))
    return findings


# --------------------------------------------------------------- CLI entry


def _budget_env() -> tuple[int, int, bool]:
    budget = max(1, int(os.environ.get("DTLOAD_BUDGET", "1") or 1))
    seed_base = int(os.environ.get("DTLOAD_SEED_BASE", "0") or 0)
    pinned = (budget == 1 and seed_base == 0
              and not os.environ.get("DTLOAD_TARGET")
              and not os.environ.get("DTLOAD_SCALE"))
    return budget, seed_base, pinned


_TOUCHES = (
    "dynamo_tpu_torch/load/", "dynamo_tpu_torch/analysis/loadcheck",
    "dynamo_tpu_torch/analysis/detloop",
    "dynamo_tpu_torch/load/card_latency.json",
    "dynamo_tpu_torch/llm/kv_router/", "dynamo_tpu_torch/llm/kv/",
    "dynamo_tpu_torch/planner/", "dynamo_tpu_torch/obs/costs",
    "dynamo_tpu_torch/obs/topology", "dynamo_tpu_torch/tokens",
    "dynamo_tpu_torch/utils/chash",
)


def _load_affected(root: Path) -> bool:
    """The sweep exercises the whole control plane; ``--changed`` only
    decides whether to run it at all (cells aren't file-subsettable)."""
    from dynamo_tpu_torch.analysis.cli import _git_changed_paths

    dirty = [str(p) for p in _git_changed_paths(root, suffixes=(".py", ".json"))]
    return any(frag in d for d in dirty for frag in _TOUCHES)


def _replay(token: str, fmt: str, out) -> int:
    from dynamo_tpu_torch.load.sim import canonical_bytes, run_cell

    p = decode_token(token)
    res = run_cell(p["family"], p["topology"], seed=int(p["seed"]),
                   level=float(p["level"]),
                   target_requests=int(p["target"]))
    if fmt == "json":
        doc = {"cell": f"{p['family']}/{p['topology']}",
               "level": p["level"], "seed": p["seed"],
               "metrics": res["metrics"], "census": res["census"]}
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        m = res["metrics"]
        print(f"{p['family']}/{p['topology']} level={p['level']} "
              f"seed={p['seed']}: {m['requests']} requests, "
              f"{m['completed']} completed, shed={m['shed_rate']}, "
              f"p99 TTFT {m['ttft_p99_ms']}ms "
              f"(sla {m['sla_ttft_ms']}ms)", file=out)
        print(f"  canonical: {len(canonical_bytes(res))} bytes", file=out)
    return 0


def run_load(args, out) -> int:
    """``python -m dynamo_tpu_torch lint --load``: sweep the capacity grid, diff it
    against the committed surface, exit 1 on any non-accepted finding.
    ``--update-baseline`` re-snapshots the manifest (carrying
    justifications by key); ``--replay TOKEN`` re-runs one cell."""
    token = getattr(args, "replay", None)
    if token:
        if not token.startswith(_TOKEN_PREFIX):
            print(f"not a dtload replay token: {token[:16]!r} "
                  f"(expected {_TOKEN_PREFIX}...)", file=out)
            return 2
        return _replay(token, getattr(args, "fmt", "text"), out)

    from dynamo_tpu_torch.load.sim import CELLS, sweep

    manifest_path = Path(
        getattr(args, "manifest", None) or DEFAULT_LOAD_MANIFEST_PATH)
    manifest = LoadManifest.load(manifest_path)
    budget, seed_base, pinned = _budget_env()
    if getattr(args, "update_baseline", False) and not pinned:
        # refused before the sweep: a non-pinned surface is never a
        # reference point, so sweeping it first would only cost time
        print("refusing to update the load manifest from a "
              "non-default-budget/seed/target/scale run", file=out)
        return 2
    root = Path(getattr(args, "root", None)
                or Path(__file__).resolve().parents[2])
    if getattr(args, "changed", False) and not _load_affected(root):
        print("load plane unaffected by changed files", file=out)
        return 0
    facts = sweep(budget=budget, seed_base=seed_base)
    # drift rules only judge the pinned default operating point: extra
    # seeds or a different target/scale legitimately move the surface
    findings = check_load(facts, manifest, drift=pinned,
                          seed_base=seed_base)
    # per-cell level grids may differ (sharded-router cells sweep a
    # wider ladder), so count from the observed facts
    n_runs = sum(len(c.get("levels", {})) + 2 * budget - 1
                 for c in facts["cells"].values())

    if getattr(args, "update_baseline", False):
        # LD003/LD005 are never baked into the baseline: neither a
        # nondeterministic surface nor one that fails the sharding
        # claim can be a reference point
        keep = [f for f in findings
                if f.rule not in _DRIFT_RULES
                and f.rule not in ("LD003", "LD005")]
        ld3 = [f for f in findings if f.rule in ("LD003", "LD005")]
        LoadManifest.from_facts(facts, keep, manifest).save(manifest_path)
        print(
            f"load manifest updated: {len(facts['cells'])} cell"
            f"{'' if len(facts['cells']) == 1 else 's'}, {len(keep)} "
            f"accepted finding{'' if len(keep) == 1 else 's'} -> "
            f"{manifest_path}",
            file=out,
        )
        if ld3:
            for f in ld3:
                print(f.render(), file=out)
            print(f"{len(ld3)} determinism/scaling finding"
                  f"{'' if len(ld3) == 1 else 's'} NOT accepted — fix "
                  "the regression", file=out)
            return 1
        return 0

    fresh = manifest.filter(findings)
    n_accepted = len(findings) - len(fresh)
    if getattr(args, "fmt", "text") == "json":
        doc = {
            "findings": [f.to_json() for f in fresh],
            "accepted": n_accepted,
            "total": len(findings),
            "cells": sorted(f"{fam}/{topo}" for fam, topo in CELLS),
            "runs": n_runs,
        }
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for f in fresh:
            print(f.render(), file=out)
        print(
            f"{len(fresh)} load finding"
            f"{'s' if len(fresh) != 1 else ''} ({n_accepted} accepted) "
            f"over {len(facts['cells'])} cells, {n_runs} deterministic "
            "runs",
            file=out,
        )
    return 1 if fresh else 0
