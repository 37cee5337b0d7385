"""The port's hot-path source rules (``analysis/rules_torch.py``, DT101-DT105),
the counterpart of the JAX package's ``rules_jax.py``.

Each rule has a fixture under ``tests/lint_fixtures/torch_rules/engine/`` (an
``engine/`` directory, so DT102's hot-path scope covers it) that trips it and
exits 1, and a clean twin that exits 0.  The package starts at zero findings
outside the committed baseline, and each DT1xx baseline entry names why its
site is not what the rule guards against.
"""

import io
from pathlib import Path

import pytest

import dynamo_tpu_torch
from dynamo_tpu_torch.analysis import DEFAULT_BASELINE_PATH, Baseline, all_rules, lint_paths
from dynamo_tpu_torch.analysis.cli import configure_parser, run_lint

PKG = Path(dynamo_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FIXTURES = Path(__file__).parent / "lint_fixtures" / "torch_rules" / "engine"
CODES = ["DT101", "DT102", "DT103", "DT104", "DT105"]
# how many findings each bad fixture holds: every shape the rule names
BAD_COUNTS = {"DT101": 3, "DT102": 4, "DT103": 3, "DT104": 2, "DT105": 4}


def _lint(path, *flags):
    import argparse

    out = io.StringIO()
    args = configure_parser(argparse.ArgumentParser()).parse_args(
        ["--no-baseline", "--root", str(ROOT), *flags, str(path)])
    return run_lint(args, out=out), out.getvalue()


@pytest.mark.parametrize("code", CODES)
def test_bad_fixture_exits_1(code):
    rc, text = _lint(FIXTURES / f"{code.lower()}_bad.py")
    assert rc == 1
    found = [line for line in text.splitlines() if f": {code} " in line]
    assert len(found) == BAD_COUNTS[code], text
    assert all(f": {c} " not in text for c in CODES if c != code), text


@pytest.mark.parametrize("code", CODES)
def test_good_fixture_exits_0(code):
    rc, text = _lint(FIXTURES / f"{code.lower()}_good.py")
    assert rc == 0 and text.strip() == "0 findings (0 baselined)", text


def test_select_runs_one_rule():
    rc, text = _lint(FIXTURES, "--select", "DT103")
    assert rc == 1
    rules = {line.split(": ")[1].split()[0] for line in text.splitlines()[:-1]}
    assert rules == {"DT103"}


def test_hot_path_scope():
    """DT102 reads only ``engine/`` and ``models/``: the same loop elsewhere
    is not the hot path."""
    src = (FIXTURES / "dt102_bad.py").read_text()
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for sub, want in (("engine", 4), ("models", 4), ("llm", 0)):
            d = Path(tmp) / sub
            d.mkdir()
            f = d / "m.py"
            f.write_text(src)
            found = lint_paths([f], all_rules(["DT102"]), root=Path(tmp))
            assert len(found) == want, (sub, found)


def test_package_dt1xx_findings_are_baselined_and_justified():
    """The port's tree: zero DT1xx findings outside the baseline, and every
    DT1xx entry justified (a host array read in a loop, a timing harness's
    per-measurement graph)."""
    found = lint_paths([PKG], all_rules(CODES), root=ROOT)
    base = Baseline.load(DEFAULT_BASELINE_PATH)
    assert base.filter(found) == []
    entries = [e for e in base.entries if e["rule"] in CODES]
    assert len(entries) == len(found) == 2
    for e in entries:
        assert e["justification"].strip() not in ("", "TODO: justify"), e
    assert {(e["path"].split("/", 1)[1], e["rule"]) for e in entries} == {
        ("engine/spec.py", "DT102"), ("tools/cuda_timing.py", "DT101")}


def test_kernel_wrappers_launch_clean():
    """The wrappers in ``ops/kernels/`` launch their library symbols with
    planned geometry: DT105 finds nothing there, and a library symbol
    named anywhere else in the package would be a finding."""
    kernels = PKG / "ops" / "kernels"
    assert lint_paths([kernels], all_rules(["DT105"]), root=ROOT) == []
    calls = [p for p in PKG.rglob("*.py") if ".library().dynamo_" in p.read_text()
             or "lib.dynamo_" in p.read_text()]
    assert calls and all(p.is_relative_to(kernels) for p in calls), calls
