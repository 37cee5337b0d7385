"""``python -m dynamo_tpu_torch lint``: the front end of the port's
analysis planes.

The counterpart of the JAX package's ``analysis/cli.py``, with the JAX
command's flags and exit codes.  A bare ``lint [paths]`` runs the
per-file source rules (DT001-DT004, ``rules_async.py``) over the port's
package, ``--project`` adds the interprocedural rules (DT005-DT009,
``project.py``), both against the port's ``analysis/baseline.json``:
text output for humans, ``--format json`` (stable-sorted) for CI
diffing, exit 1 on any non-baselined finding, 2 on an unknown rule.
``--update-baseline`` rewrites the baseline from the current findings,
carrying existing justifications over where the (path, rule, content)
key still matches.  ``--proto`` runs the protocol plane
(``protocheck.py``) and ``--load`` the scale-simulation plane
(``loadcheck.py``), each against its own committed manifest.  The JAX
command's other plane flags exit 2, naming the plane as not ported.
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

__all__ = ["configure_parser", "run_lint", "main"]

# the JAX command's plane flags the port has no plane for, and why each
# exits 2
_UNPORTED = {
    "trace": "the compile plane is not a port target (it reads jaxprs and HLO)",
    "wire": "the wire plane is not yet ported to this package",
    "perf": "the perf plane is not a port target (it prices jaxprs against TPU numbers)",
    "shard": "the sharding plane is not a port target (it reads GSPMD placements)",
    "kern": "the kernel plane is not a port target (it audits pallas_call sites)",
    "metrics": "the metrics plane is not yet ported to this package",
    "all": "every plane at once is refused: the JAX command's --all also runs the "
           "trace, shard, kern and perf planes, which are not port targets, and "
           "the metrics plane is not yet ported",
}


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
    for flag, why in _UNPORTED.items():
        p.add_argument(f"--{flag}", action="store_true", help=f"{why} (exits 2)")
    p.add_argument("--replay", default=None, metavar="TOKEN",
                   help="with --proto or --load: re-execute one recorded run "
                        "from a dtp1. interleaving token or a dtl1. cell token "
                        "instead of sweeping; exit 1 if a replayed dtp1. run "
                        "still violates")
    p.add_argument("--changed", action="store_true",
                   help="restrict the per-file pass to git-dirty files (the "
                        "project pass stays whole-program); with --proto, the "
                        "scenarios whose protocol code is dirty; with --load, "
                        "skip the sweep unless control-plane code is dirty")
    p.add_argument("--manifest", default=None, metavar="PATH",
                   help="manifest file (default: the committed "
                        "analysis/proto_manifest.json or load_manifest.json)")
    p.add_argument("--select", default=None, metavar="DT001,DT005",
                   help="comma-separated rule codes to run (default: all)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline file (default: the committed "
                        "analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline (or, with --proto/--load, the "
                        "manifest) from current findings, carrying "
                        "justifications over by key")
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
    asked = [why for flag, why in _UNPORTED.items() if getattr(args, flag, False)]
    if asked:
        print(f"lint: {asked[0]}", file=sys.stderr)
        return 2
    if getattr(args, "proto", False):
        from dynamo_tpu_torch.analysis.protocheck import run_proto

        return run_proto(args, out)
    if getattr(args, "load", False):
        from dynamo_tpu_torch.analysis.loadcheck import run_load

        return run_load(args, out)
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


def main(argv: Optional[list[str]] = None) -> int:
    p = configure_parser(argparse.ArgumentParser(prog="python -m dynamo_tpu_torch lint"))
    return run_lint(p.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
