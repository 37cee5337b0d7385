"""``lint --all``: the port's ten passes in one process, in the JAX command's
order (per-file + project, trace, wire, perf, shard, proto, load, kern,
metrics), with the largest of their exit codes.

The whole command runs once for the module, as a subprocess on the tree
(each plane has its own file of tests; here the gate is that all of them
are clean together); the wiring is held with stand-in passes.
"""

import argparse
import io
import subprocess
import sys
from pathlib import Path

import pytest

import dynamo_tpu_torch
from dynamo_tpu_torch.analysis import cli
from dynamo_tpu_torch.analysis.cli import configure_parser, run_all

ROOT = Path(dynamo_tpu_torch.__file__).resolve().parent.parent
# each pass's summary line on a clean tree, in the order they run
SUMMARIES = ["findings", "trace findings", "wire findings", "perf findings", "shard findings",
             "protocol findings", "load findings", "kern findings", "metrics findings"]


@pytest.fixture(scope="module")
def lint_all():
    return subprocess.run([sys.executable, "-m", dynamo_tpu_torch.__name__, "lint", "--all"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)


def test_lint_all_exits_0_on_the_tree(lint_all):
    assert lint_all.returncode == 0, lint_all.stdout[-3000:] + lint_all.stderr[-3000:]
    lines = [line for line in lint_all.stdout.splitlines() if line.startswith("0 ")]
    assert len(lines) == len(SUMMARIES), lint_all.stdout
    for line, kind in zip(lines, SUMMARIES):
        assert line.startswith(f"0 {kind} ("), (line, kind)
    assert lines[0].endswith("baselined)")
    assert all("accepted)" in line for line in lines[1:])


def test_run_all_order_and_exit_code(monkeypatch):
    """The passes run in JAX's order with --project on and each plane's own
    manifest; the exit code is the largest of theirs."""
    calls = []

    def stand_in(name, rc):
        def run(args, out):
            calls.append((name, args.project, args.manifest, args.all))
            return rc
        return run

    import dynamo_tpu_torch.analysis.kerncheck as kerncheck
    import dynamo_tpu_torch.analysis.loadcheck as loadcheck
    import dynamo_tpu_torch.analysis.metcheck as metcheck
    import dynamo_tpu_torch.analysis.perfcheck as perfcheck
    import dynamo_tpu_torch.analysis.protocheck as protocheck
    import dynamo_tpu_torch.analysis.shardcheck as shardcheck
    import dynamo_tpu_torch.analysis.tracecheck as tracecheck
    import dynamo_tpu_torch.analysis.wirecheck as wirecheck

    codes = {"trace": 0, "wire": 0, "perf": 1, "shard": 0, "proto": 0, "load": 2, "kern": 0,
             "metrics": 0}
    for mod, name in ((tracecheck, "trace"), (wirecheck, "wire"), (perfcheck, "perf"),
                      (shardcheck, "shard"), (protocheck, "proto"), (loadcheck, "load"),
                      (kerncheck, "kern"), (metcheck, "metrics")):
        monkeypatch.setattr(mod, f"run_{name}", stand_in(name, codes[name]))
    monkeypatch.setattr(cli, "run_lint", stand_in("source", 0))
    args = configure_parser(argparse.ArgumentParser()).parse_args(
        ["--all", "--manifest", "x.json"])
    assert run_all(args, io.StringIO()) == 2
    assert [c[0] for c in calls] == ["source", "trace", "wire", "perf", "shard", "proto", "load",
                                     "kern", "metrics"]
    assert all(c[1:] == (True, None, False) for c in calls)
