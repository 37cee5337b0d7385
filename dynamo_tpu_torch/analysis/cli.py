"""``python -m dynamo_tpu_torch lint``: the front end of the port's
analysis planes.

The counterpart of the JAX package's ``analysis/cli.py``, with the JAX
command's flags and exit codes.  The port has one plane so far, the
protocol plane (``--proto``, ``analysis/protocheck.py``): 0 when every
finding is accepted in the committed manifest, 1 on a fresh finding (or a
replayed run that still violates), 2 on a refused request.  Every other
plane's flag, and a bare ``lint`` (the source planes), exits 2 naming the
plane as not yet ported.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

__all__ = ["configure_parser", "run_lint", "main"]

# the JAX command's plane flags the port has no plane for yet, and the
# plane each names
_UNPORTED = {
    "project": "the interprocedural source plane",
    "trace": "the compile plane",
    "wire": "the wire plane",
    "perf": "the perf plane",
    "shard": "the sharding plane",
    "load": "the scale-simulation plane",
    "kern": "the kernel plane",
    "metrics": "the metrics plane",
    "all": "every plane at once",
}


def configure_parser(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--format", choices=["text", "json"], default="text",
                   dest="fmt")
    p.add_argument("--proto", action="store_true",
                   help="run the protocol-plane pass (PR001-PR005: "
                        "deterministic-schedule model checking + crash-point "
                        "exploration of the coordinator/queue/drain/persist/"
                        "stream/shard protocols) against the committed proto "
                        "manifest")
    for flag, plane in _UNPORTED.items():
        p.add_argument(f"--{flag}", action="store_true",
                       help=f"{plane}: not yet ported (exits 2)")
    p.add_argument("--replay", default=None, metavar="TOKEN",
                   help="with --proto: re-execute one recorded run from a "
                        "dtp1. interleaving token instead of sweeping; exit 1 "
                        "if it still violates")
    p.add_argument("--changed", action="store_true",
                   help="with --proto: explore only the scenarios whose "
                        "protocol code git reports dirty")
    p.add_argument("--manifest", default=None, metavar="PATH",
                   help="manifest file (default: the committed "
                        "analysis/proto_manifest.json)")
    p.add_argument("--update-baseline", action="store_true",
                   help="with --proto: re-snapshot the manifest from the "
                        "pinned full sweep (carries justifications over by "
                        "key)")
    p.add_argument("--root", default=None,
                   help="repository root for --changed (default: the "
                        "checkout holding this package)")
    return p


def _git_changed_paths(root: Path) -> list[Path]:
    """Python files git reports dirty (staged, unstaged, untracked)."""
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
        if frag.endswith(".py"):
            p = root / frag
            if p.is_file():
                paths.append(p)
    return paths


def run_lint(args: argparse.Namespace, out=None) -> int:
    out = out if out is not None else sys.stdout
    if getattr(args, "proto", False):
        from dynamo_tpu_torch.analysis.protocheck import run_proto

        return run_proto(args, out)
    asked = [plane for flag, plane in _UNPORTED.items() if getattr(args, flag, False)]
    plane = asked[0] if asked else "the source planes (per-file and project rules)"
    print(f"lint: {plane} is not yet ported to this package; "
          "--proto is the one ported plane", file=sys.stderr)
    return 2


def main(argv: Optional[list[str]] = None) -> int:
    p = configure_parser(argparse.ArgumentParser(prog="python -m dynamo_tpu_torch lint"))
    return run_lint(p.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
