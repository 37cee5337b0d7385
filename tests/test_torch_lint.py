"""The port's source planes (``analysis/core.py``, ``rules_async.py``,
``project.py``) held to the JAX package's, and the port's own gate.

Each DT001-DT009 fixture under ``tests/lint_fixtures/`` (the JAX suite's,
reused) gives the same findings in both planes, per-file and project pass
together; over the port's package the two planes find the same things
(the JAX plane with ``--select DT001..DT009``).  Then the gate: the port's
``lint`` and ``lint --project`` find nothing outside the port's committed
``analysis/baseline.json``, and every entry there is justified and live.
Last, noqa, the baseline round trip, the JSON output, ``--select`` of an
unknown rule (exit 2) and the command's exit codes.  The port's own
DT101-DT105 (``rules_torch.py``) are held in ``test_torch_rules_torch.py``.
"""

import argparse
import io
import json
from pathlib import Path

import pytest

import dynamo_tpu_torch
from dynamo_tpu.analysis import core as jax_core
from dynamo_tpu.analysis import project as jax_project
from dynamo_tpu_torch import cli as port_cli
from dynamo_tpu_torch.analysis import (
    DEFAULT_BASELINE_PATH,
    Baseline,
    all_rules,
    lint_file,
    lint_paths,
    lint_project,
    project_rules,
)
from dynamo_tpu_torch.analysis import core
from dynamo_tpu_torch.analysis.cli import configure_parser, run_lint

PKG = Path(dynamo_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FIXTURES = Path(__file__).parent / "lint_fixtures"
FILE_RULES = ["DT001", "DT002", "DT003", "DT004"]
PROJECT_RULES = ["DT005", "DT006", "DT007", "DT008", "DT009"]
TORCH_RULES = ["DT101", "DT102", "DT103", "DT104", "DT105"]


def _jax_findings(paths):
    """The JAX plane's per-file + project findings over ``paths``, limited
    to the rules the port has."""
    found = jax_core.lint_paths(paths, jax_core.all_rules(FILE_RULES), root=ROOT)
    found += jax_project.lint_project(paths, jax_project.project_rules(PROJECT_RULES), root=ROOT)
    return [f.to_json() for f in sorted(found)]


def _port_findings(paths):
    """The port's per-file + project findings of the rules JAX's plane
    shares (the port's DT101-DT105 read PyTorch, JAX's read JAX)."""
    found = lint_paths(paths, all_rules(FILE_RULES), root=ROOT) + lint_project(paths, root=ROOT)
    return [f.to_json() for f in sorted(found)]


def _key(d):
    return (d["path"], d["line"], d["col"], d["rule"])


# ------------------------------------------------------ parity on fixtures


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("code", FILE_RULES + PROJECT_RULES)
def test_fixture_findings_match_jax(code, kind):
    path = FIXTURES / f"{code.lower()}_{kind}.py"
    ours = _port_findings([path])
    assert ours == _jax_findings([path])
    if kind == "bad":
        assert ours and {f["rule"] for f in ours} == {code}
    else:
        assert ours == []


def test_rule_registries():
    """DT001-DT004 per file and DT005-DT009 over the project: the JAX
    rules' codes, summaries and names.  DT101-DT105 are the port's own
    reading of JAX's codes (``rules_torch.py``), registered per file too."""
    ours = {r.code: (r.name, r.summary) for r in all_rules(FILE_RULES)}
    ref = {r.code: (r.name, r.summary) for r in jax_core.all_rules(FILE_RULES)}
    assert ours == ref
    assert sorted(r.code for r in all_rules()) == FILE_RULES + TORCH_RULES
    ours = {r.code: (r.name, r.summary) for r in project_rules()}
    ref = {r.code: (r.name, r.summary) for r in jax_project.project_rules()}
    assert ours == ref and sorted(ours) == PROJECT_RULES
    for code in ("DT106", "DT199"):
        with pytest.raises(ValueError, match="unknown rule"):
            all_rules([code])


def test_package_findings_match_jax():
    """Over the port's package the two planes find the same things, the
    name-resolution false positive at ``runtime/pipeline.py`` included."""
    ours = _port_findings([PKG])
    assert ours == _jax_findings([PKG])
    shared = [e for e in Baseline.load(DEFAULT_BASELINE_PATH).entries
              if e["rule"] not in TORCH_RULES]
    assert len(ours) == len(shared)
    assert {f["rule"] for f in ours} <= set(FILE_RULES + PROJECT_RULES)


# ------------------------------------------------------------------ the gate


def test_port_has_zero_nonbaselined_findings():
    """The port's tier-1 source gate: ``lint`` and ``lint --project`` over
    the package are clean modulo the committed baseline.  Fix a finding,
    ``# dt: noqa[DTxxx]`` it with a reason, or baseline it with a
    justification (``lint --project --update-baseline``)."""
    baseline = Baseline.load(DEFAULT_BASELINE_PATH)
    for findings in (lint_paths([PKG], all_rules(), root=ROOT),
                     lint_project([PKG], project_rules(), root=ROOT)):
        fresh = baseline.filter(findings)
        assert not fresh, "\n".join(f.render() for f in fresh)


def test_baseline_entries_are_justified_and_live():
    baseline = Baseline.load(DEFAULT_BASELINE_PATH)
    assert baseline.entries
    for e in baseline.entries:
        assert e["path"].startswith(PKG.name + "/"), e  # repo-root-relative
        assert e.get("justification", "").strip() not in ("", "TODO: justify"), e
    findings = lint_paths([PKG], all_rules(), root=ROOT) + lint_project([PKG], root=ROOT)
    keys = [f.baseline_key for f in findings]
    stale = [e for e in baseline.entries
             if (e["path"], e["rule"], e.get("content", "")) not in keys]
    assert not stale, stale
    assert len(baseline.filter(findings)) == 0
    assert len(findings) == len(baseline.entries)


def test_baseline_carries_jax_justifications():
    """Where the JAX baseline holds the same rule at the same call in the
    same module, the port's entries carry its justifications (a multiset
    per key, as the baseline matches)."""

    def by_key(entries):
        out: dict = {}
        for e in entries:
            key = (e["path"].split("/", 1)[1], e["rule"], e["content"])
            out.setdefault(key, []).append(e["justification"])
        return {k: sorted(v) for k, v in out.items()}

    ref = by_key(json.loads(jax_core.DEFAULT_BASELINE_PATH.read_text())["entries"])
    ours = by_key(Baseline.load(DEFAULT_BASELINE_PATH).entries)
    shared = set(ours) & set(ref)
    assert len(shared) >= 10
    for key in shared:
        assert ours[key] == ref[key], key


# ----------------------------------------------------------------------- noqa


@pytest.mark.parametrize("comment,want", [("  # dt: noqa[DT003]", set()),
                                          ("  # dt: noqa", set()),
                                          ("  # dt: noqa[DT001]", {"DT003"}),
                                          ("", {"DT003"})])
def test_noqa(tmp_path, comment, want):
    f = tmp_path / "m.py"
    f.write_text(f"import time\nasync def go():\n    time.sleep(1){comment}\n")
    assert {x.rule for x in lint_file(f, all_rules())} == want
    assert lint_file(f, all_rules()) == [
        core.Finding(**x.__dict__) for x in jax_core.lint_file(f, jax_core.all_rules(FILE_RULES))]


def test_project_noqa_and_select(tmp_path):
    f = tmp_path / "m.py"
    src = (FIXTURES / "dt009_bad.py").read_text()
    f.write_text(src)
    assert {x.rule for x in lint_project([f], root=tmp_path)} == {"DT009"}
    assert lint_project([f], project_rules(["DT005"]), root=tmp_path) == []
    lines = src.splitlines()
    hit = lint_project([f], root=tmp_path)[0].line
    lines[hit - 1] += "  # dt: noqa[DT009]"
    f.write_text("\n".join(lines) + "\n")
    assert [x for x in lint_project([f], root=tmp_path) if x.line == hit] == []


# ------------------------------------------------------------------------ CLI


def _args(**kw) -> argparse.Namespace:
    base = dict(paths=None, fmt="text", select=None, baseline=None, no_baseline=False,
                update_baseline=False, root=None, project=False, changed=False)
    base.update(kw)
    return argparse.Namespace(**base)


BAD_SRC = "import asyncio\nasync def go():\n    asyncio.ensure_future(asyncio.sleep(0))\n"
FIXED_SRC = "import asyncio\nasync def go():\n    await asyncio.ensure_future(asyncio.sleep(0))\n"


def test_baseline_roundtrip(tmp_path):
    """A finding exits 1; baselined it exits 0; justifications survive an
    update; a line shift keeps the match; the fix prunes the entry."""
    mod = tmp_path / "m.py"
    mod.write_text(BAD_SRC)
    bl = tmp_path / "baseline.json"
    args = _args(paths=[str(mod)], baseline=str(bl), root=str(tmp_path))
    update = _args(paths=[str(mod)], baseline=str(bl), root=str(tmp_path),
                   update_baseline=True)
    assert run_lint(args, out=io.StringIO()) == 1
    assert run_lint(update, out=io.StringIO()) == 0
    assert run_lint(args, out=io.StringIO()) == 0
    data = json.loads(bl.read_text())
    data["entries"][0]["justification"] = "kept: demo entry"
    bl.write_text(json.dumps(data))
    assert run_lint(update, out=io.StringIO()) == 0
    assert json.loads(bl.read_text())["entries"][0]["justification"] == "kept: demo entry"
    mod.write_text("import os\n" + BAD_SRC)
    assert run_lint(args, out=io.StringIO()) == 0
    assert run_lint(_args(paths=[str(mod)], baseline=str(bl), root=str(tmp_path),
                          no_baseline=True), out=io.StringIO()) == 1
    mod.write_text(FIXED_SRC)
    assert run_lint(update, out=io.StringIO()) == 0
    assert json.loads(bl.read_text())["entries"] == []


def test_json_output_is_stable_and_equal_to_jax():
    """The fixtures as one tree, project pass on, no baseline: the same
    stable-sorted document from both planes' commands."""
    from dynamo_tpu.analysis.cli import run_lint as jax_run_lint

    outs = []
    for _ in range(2):
        out = io.StringIO()
        assert run_lint(_args(paths=[str(FIXTURES)], fmt="json", no_baseline=True,
                              project=True, root=str(ROOT),
                              select=",".join(FILE_RULES + PROJECT_RULES)), out=out) == 1
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    doc = json.loads(outs[0])
    keys = [_key(f) for f in doc["findings"]]
    assert keys == sorted(keys) and doc["total"] == len(keys)
    ref = io.StringIO()
    jax_run_lint(_args(paths=[str(FIXTURES)], fmt="json", no_baseline=True, project=True,
                       root=str(ROOT), select=",".join(FILE_RULES + PROJECT_RULES)), out=ref)
    assert json.loads(ref.getvalue()) == doc


def test_select_routes_project_codes():
    bad = FIXTURES / "dt008_bad.py"
    out = io.StringIO()
    assert run_lint(_args(paths=[str(bad)], project=True, no_baseline=True, root=str(ROOT)),
                    out=out) == 1
    assert "DT008" in out.getvalue()
    assert run_lint(_args(paths=[str(bad)], no_baseline=True, root=str(ROOT)),
                    out=io.StringIO()) == 0
    out = io.StringIO()
    assert run_lint(_args(paths=[str(FIXTURES)], project=True, select="DT008",
                          no_baseline=True, root=str(ROOT)), out=out) == 1
    assert "DT008" in out.getvalue() and "DT001" not in out.getvalue()


def test_lint_command_exit_codes(capsys):
    """``python -m <the port> lint``: 0 bare and with ``--project`` against
    the committed baseline, 1 on a fresh finding, 2 for an unknown rule.
    ``--select DT101`` is a port rule now, and no plane flag is refused."""
    for flags, summary in (([], "0 findings (8 baselined)"),
                           (["--project"], "0 findings (25 baselined)")):
        with pytest.raises(SystemExit) as e:
            port_cli.main(["lint", *flags])
        assert e.value.code == 0
        assert capsys.readouterr().out.strip().splitlines()[-1] == summary
    with pytest.raises(SystemExit) as e:
        port_cli.main(["lint", "--no-baseline", str(FIXTURES / "dt003_bad.py")])
    assert e.value.code == 1
    assert "DT003" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        port_cli.main(["lint", "--select", "DT199"])
    assert e.value.code == 2
    assert "unknown rule" in capsys.readouterr().err
    help_text = configure_parser(argparse.ArgumentParser()).format_help()
    for flag in ("--trace", "--shard", "--all"):
        assert flag in help_text


def test_syntax_error_is_a_finding(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("def broken(:\n")
    assert {f.rule for f in lint_file(mod, all_rules())} == {"DT000"}
    assert {f.rule for f in lint_project([mod], root=tmp_path)} == set()
