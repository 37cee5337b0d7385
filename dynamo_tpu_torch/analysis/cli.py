"""``python -m dynamo_tpu_torch lint``: the front end of the port's
analysis planes.

The counterpart of the JAX package's ``analysis/cli.py``, with the JAX
command's flags and exit codes.  A bare ``lint [paths]`` runs the
per-file source rules over the port's package (DT001-DT004,
``rules_async.py``, and DT101-DT105, ``rules_torch.py``), ``--project``
adds the interprocedural rules (DT005-DT009, ``project.py``), both
against the port's ``analysis/baseline.json``: text output for humans,
``--format json`` (stable-sorted) for CI diffing, exit 1 on any
non-baselined finding, 2 on an unknown rule.  ``--update-baseline``
rewrites the baseline from the current findings, carrying existing
justifications over where the (path, rule, content) key still matches.
The other planes run each against its own committed manifest: ``--trace``
the compile plane (``tracecheck.py``), ``--wire`` the wire plane
(``wirecheck.py``), ``--perf`` the perf plane (``perfcheck.py``),
``--shard`` the sharding plane (``shardcheck.py``), ``--proto`` the
protocol plane (``protocheck.py``), ``--load`` the scale-simulation plane
(``loadcheck.py``), ``--kern`` the kernel plane (``kerncheck.py``) and
``--metrics`` the metrics plane (``metcheck.py``).  ``--all`` runs the ten
passes in that order (source and project first) in one process and exits
with the largest of their codes; on a clean tree each prints its summary
line ("0 findings (N baselined)", "0 trace findings (N accepted) over N
entrypoints", ...) and the command exits 0.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

from dynamo_tpu_torch.analysis.core import (
    DEFAULT_BASELINE_PATH,
    Baseline,
    all_rules,
    lint_paths,
)

__all__ = ["configure_parser", "run_lint", "run_all", "main"]

def configure_parser(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to lint (default: the dynamo_tpu_torch "
                        "package)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   dest="fmt")
    p.add_argument("--project", action="store_true",
                   help="also run the interprocedural pass (DT005-DT009: "
                        "cross-module call-graph rules) on top of the "
                        "per-file rules")
    p.add_argument("--proto", action="store_true",
                   help="run the protocol-plane pass instead (PR001-PR005: "
                        "deterministic-schedule model checking + crash-point "
                        "exploration of the coordinator/queue/drain/persist/"
                        "stream/shard protocols) against the committed proto "
                        "manifest")
    p.add_argument("--load", action="store_true",
                   help="run the scale-simulation pass instead (LD001-LD005: "
                        "macro-simulated capacity sweep of the real control "
                        "plane at virtual time, workers priced from the card's "
                        "serving figures — p99 TTFT / shed / knee per "
                        "topology x load level) against the committed load "
                        "manifest")
    p.add_argument("--wire", action="store_true",
                   help="run the wire-plane pass instead (WR001-WR007: "
                        "extracted cross-process message contracts, "
                        "producer/consumer drift) against the committed "
                        "wire manifest")
    p.add_argument("--metrics", action="store_true",
                   help="run the metrics-plane pass instead (MT001-MT005: "
                        "static producer->renderer->scraper audit of the "
                        "/metrics surface: dead telemetry, stale scrape "
                        "keys, label cardinality, type misuse, census "
                        "drift) against the committed metrics manifest")
    p.add_argument("--kern", action="store_true",
                   help="run the kernel-plane pass instead (KN001-KN006: launch budgets, "
                        "plan walks, NaN-poisoned padding oracles of the plain versions, "
                        "work and plan costs, the kernel census) against the committed "
                        "kern manifest")
    p.add_argument("--perf", action="store_true",
                   help="run the perf-plane pass instead (PF001-PF004: the H100 roofline "
                        "of every step function, priced on meta tensors, and its "
                        "collective census) against the committed perf manifest")
    p.add_argument("--trace", action="store_true",
                   help="run the compile-plane pass instead (TR001-TR007: the dispatch-"
                        "signature census a CUDA graph capture keys on, the in-place cache "
                        "audit, f32 upcasts, the footprint against the card's memory) against "
                        "the committed trace manifest")
    p.add_argument("--shard", action="store_true",
                   help="run the sharding-plane pass instead (SH001-SH005: what each rank of "
                        "the (1, 4) audit mesh holds, rank 0's collectives a decode turn, each "
                        "rank's in-place cache write) against the committed shard manifest")
    p.add_argument("--all", action="store_true",
                   help="run all ten passes (per-file + project, trace, wire, perf, shard, "
                        "proto, load, kern, metrics) in one process; exit with the largest of "
                        "their codes")
    p.add_argument("--replay", default=None, metavar="TOKEN",
                   help="with --proto, --load or --kern: re-execute one recorded run "
                        "from a dtp1. interleaving token, a dtl1. cell token or a "
                        "dtk1. fuzz geometry token instead of sweeping; exit 1 if a "
                        "replayed dtp1. run still violates or a dtk1. geometry leaks")
    p.add_argument("--changed", action="store_true",
                   help="restrict the per-file pass to git-dirty files (the "
                        "project pass stays whole-program); with --proto, the "
                        "scenarios whose protocol code is dirty; with --load, "
                        "--metrics or --kern, skip the pass unless its inputs are dirty")
    p.add_argument("--manifest", default=None, metavar="PATH",
                   help="manifest file (default: the plane's committed "
                        "analysis/<plane>_manifest.json; single-plane modes only)")
    p.add_argument("--select", default=None, metavar="DT001,DT005",
                   help="comma-separated rule codes to run (default: all)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline file (default: the committed "
                        "analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline (or, with a plane's flag, its manifest; "
                        "--metrics also rewrites docs/torch_observability.md's table; --all "
                        "every one) from current findings, carrying justifications over by key")
    p.add_argument("--root", default=None,
                   help="paths in output are relative to this directory "
                        "(default: the checkout holding this package for a "
                        "bare lint, else cwd); the repository for --changed")
    return p


def _git_changed_paths(root: Path, suffixes: tuple[str, ...] = (".py",)) -> list[Path]:
    """Files git reports dirty (staged, unstaged, untracked) whose names
    end in one of ``suffixes``."""
    import subprocess

    try:
        res = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=root, capture_output=True, text=True, timeout=15,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    if res.returncode != 0:
        return []
    paths = []
    for line in res.stdout.splitlines():
        frag = line[3:].split(" -> ")[-1].strip().strip('"')
        if frag.endswith(suffixes):
            p = root / frag
            if p.is_file():
                paths.append(p)
    return paths


def run_lint(args: argparse.Namespace, out=None) -> int:
    out = out if out is not None else sys.stdout
    if getattr(args, "all", False):
        return run_all(args, out)
    # one plane a run, picked in the JAX command's order
    for flag in PLANES:
        if getattr(args, flag, False):
            return _plane(flag)(args, out)
    paths = [Path(p) for p in (getattr(args, "paths", None) or [])]
    if getattr(args, "root", None):
        root = Path(args.root)
    elif not paths:
        # bare lint from any cwd: paths repo-root-relative so they match
        # the committed baseline
        root = Path(__file__).resolve().parents[2]
    else:
        root = Path.cwd()
    if not paths:
        paths = [Path(__file__).resolve().parents[1]]  # the package
    select = args.select.split(",") if getattr(args, "select", None) else None
    use_project = getattr(args, "project", False)
    file_select = select
    project_only = False
    if select and use_project:
        # project codes live in their own registry; route the split
        from dynamo_tpu_torch.analysis.project import _PROJECT_REGISTRY

        file_select = [
            c for c in select if c.strip().upper() not in _PROJECT_REGISTRY
        ]
        project_only = not file_select
    try:
        rules = [] if project_only else all_rules(file_select or None)
    except ValueError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2

    file_paths = paths
    if getattr(args, "changed", False):
        # pre-commit mode: per-file rules only touch git-dirty files; the
        # project pass below stays whole-program (its rules are
        # cross-module, a partial view would miss real drift)
        file_paths = _git_changed_paths(root)
    findings = lint_paths(file_paths, rules, root=root)
    if use_project:
        from dynamo_tpu_torch.analysis.project import lint_project, project_rules

        prules = project_rules(select)
        if prules:
            findings = sorted(
                findings + lint_project(paths, prules, root=root)
            )

    baseline_path = Path(args.baseline) if getattr(args, "baseline", None) else (
        DEFAULT_BASELINE_PATH
    )
    baseline = (
        Baseline() if getattr(args, "no_baseline", False)
        else Baseline.load(baseline_path)
    )

    if getattr(args, "update_baseline", False):
        Baseline.from_findings(findings, baseline).save(baseline_path)
        print(
            f"baseline updated: {len(findings)} entr"
            f"{'y' if len(findings) == 1 else 'ies'} -> {baseline_path}",
            file=out,
        )
        return 0

    fresh = baseline.filter(findings)
    n_baselined = len(findings) - len(fresh)

    if args.fmt == "json":
        doc = {
            "findings": [f.to_json() for f in fresh],  # already sorted
            "baselined": n_baselined,
            "total": len(findings),
        }
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for f in fresh:
            print(f.render(), file=out)
        summary = (
            f"{len(fresh)} finding{'s' if len(fresh) != 1 else ''}"
            f" ({n_baselined} baselined)"
        )
        print(summary, file=out)
    return 1 if fresh else 0


# the plane flags, in the JAX command's order (its ``run_all``'s)
PLANES = ("trace", "wire", "perf", "shard", "proto", "load", "kern", "metrics")


def _plane(flag: str):
    """The ``run_<plane>(args, out)`` of a plane flag, imported on use."""
    import importlib

    module = {"trace": "tracecheck", "wire": "wirecheck", "perf": "perfcheck",
              "shard": "shardcheck", "proto": "protocheck", "load": "loadcheck",
              "kern": "kerncheck", "metrics": "metcheck"}[flag]
    return getattr(importlib.import_module(f"{__package__}.{module}"), f"run_{flag}")


def run_all(args: argparse.Namespace, out=None) -> int:
    """All ten passes in one process, in the JAX command's order: per-file +
    project rules, then the compile plane, the wire plane, the perf plane,
    the sharding plane, the protocol plane, the scale simulation, the
    kernel plane and the metrics plane.  The exit code is the largest of
    theirs; ``--update-baseline`` rewrites every committed baseline."""
    out = out if out is not None else sys.stdout
    sub = argparse.Namespace(**vars(args))
    sub.all = False
    sub.project = True
    sub.manifest = None  # each plane's own; one --manifest would be ambiguous
    sub.replay = None
    for flag in PLANES:
        setattr(sub, flag, False)
    codes = [run_lint(sub, out)]
    codes += [_plane(flag)(sub, out) for flag in PLANES]
    return max(codes)


def main(argv: Optional[list[str]] = None) -> int:
    p = configure_parser(argparse.ArgumentParser(prog="python -m dynamo_tpu_torch lint"))
    return run_lint(p.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
