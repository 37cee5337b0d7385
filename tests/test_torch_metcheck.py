"""The port's metrics plane (``analysis/metcheck.py``) held to the JAX
package's, and the port's own gate.

Every MT fixture under ``tests/lint_fixtures/`` (the JAX suite's, reused)
gives both planes the same census and findings.  Over the two trees the
port's census is the JAX census restricted to the names the port renders,
and the port's ``obs/metric_names.SCHEMA`` holds exactly those names with
the JAX entries.  Then the port's gate against its committed manifest,
SCHEMA and its own docs table (``docs/torch_observability.md``), the
module-path rule, and the command's contract.

A metric name is never spelled here: the JAX plane reads every string
under ``tests/`` that starts with its prefix as a scrape, so names are
built from ``METRIC_PREFIX`` or taken from the registries.
"""

import argparse
import copy
import io
import json
import shutil
from pathlib import Path

import pytest

import dynamo_tpu_torch
from dynamo_tpu.analysis import metcheck as jax_met
from dynamo_tpu.analysis.tracecheck import Manifest as JaxManifest
from dynamo_tpu.obs.metric_names import SCHEMA as JAX_SCHEMA
from dynamo_tpu_torch import cli as port_cli
from dynamo_tpu_torch.analysis import metcheck as met
from dynamo_tpu_torch.analysis.cli import run_lint
from dynamo_tpu_torch.analysis.metcheck import (
    DEFAULT_METRICS_MANIFEST_PATH,
    DOCS_BEGIN,
    DOCS_END,
    DOCS_PATH,
    MET_RULES,
    METRIC_PREFIX,
    MetricFinding,
    MetricsManifest,
    census_snapshot,
    check_metric_facts,
    collect_metric_facts,
    render_docs_table,
    run_metrics,
)
from dynamo_tpu_torch.obs import metric_names
from dynamo_tpu_torch.obs.metric_names import SCHEMA
from dynamo_tpu_torch.obs.metric_names import EngineMetric as EM

PKG = Path(dynamo_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FIXTURES = Path(__file__).parent / "lint_fixtures"
MT_FIXTURES = sorted(p.name for p in FIXTURES.glob("mt00*.py"))

# Metrics the JAX package renders and the port does not: none.  The perf
# plane's predicted step latency comes from each package's own committed
# perf manifest (the port's priced on the H100, analysis/perfcheck.py).
NOT_RENDERED: set = set()


def _widget(suffix: str) -> str:
    return METRIC_PREFIX + "widget_" + suffix


def _registry(schema=SCHEMA):
    return {name: (typ, list(labels)) for name, (typ, labels) in schema.items()}


def _rows(findings):
    return sorted((f.entrypoint, f.rule, f.key, f.message) for f in findings)


def _fixture_findings(plane, manifest_cls, path):
    facts, intrinsic = plane.collect_metric_facts([path], root=FIXTURES)
    manifest = manifest_cls(entrypoints=plane.census_snapshot(facts))
    return facts, plane.check_metric_facts(facts, manifest, intrinsic)


@pytest.fixture(scope="module")
def real():
    """Both planes' facts over their own trees (the JAX one takes ~6 s)."""
    facts, intrinsic = collect_metric_facts()
    jfacts, _ = jax_met.collect_metric_facts()
    docs_text = (ROOT / DOCS_PATH).read_text()
    return facts, intrinsic, docs_text, jfacts


def _real_findings(real, manifest):
    facts, intrinsic, docs_text, _ = real
    return check_metric_facts(facts, manifest, intrinsic, registry=_registry(),
                              docs_text=docs_text)


# ------------------------------------------------------------ parity ----


@pytest.mark.parametrize("fixture", MT_FIXTURES)
def test_fixture_findings_match_jax(fixture):
    """Each MT fixture: the same census and consumers, and the same
    findings against a self-snapshot manifest, in both planes."""
    facts, mine = _fixture_findings(met, MetricsManifest, FIXTURES / fixture)
    jfacts, theirs = _fixture_findings(jax_met, JaxManifest, FIXTURES / fixture)
    assert facts == jfacts
    assert _rows(mine) == _rows(theirs)
    rule = "MT" + fixture[2:5]
    if fixture.endswith("_bad.py"):
        assert rule in {f.rule for f in mine}, [f.render() for f in mine]
    elif fixture.endswith("_good.py"):
        assert rule not in {f.rule for f in mine}, [f.render() for f in mine]


def _drift_findings(plane, manifest_cls, **kw):
    base, base_intr = plane.collect_metric_facts([FIXTURES / "mt005_base.py"], root=FIXTURES)
    drift, _ = plane.collect_metric_facts([FIXTURES / "mt005_drift.py"], root=FIXTURES)
    manifest = manifest_cls(entrypoints=plane.census_snapshot(base))
    clean = plane.check_metric_facts(base, manifest, base_intr)
    return clean, plane.check_metric_facts(drift, manifest, [], **kw)


def test_mt005_drift_pair_matches_jax():
    """Added, removed, retyped and relabeled: the same four drifts."""
    clean, mine = _drift_findings(met, MetricsManifest)
    jclean, theirs = _drift_findings(jax_met, JaxManifest)
    assert clean == [] and jclean == []
    assert _rows(mine) == _rows(theirs)
    assert [(f.entrypoint, f.key) for f in mine] == [
        (_widget("new_total"), "added"), (_widget("old_total"), "removed"),
        (_widget("ops_total"), "labels"), (_widget("ops_total"), "type")]


def test_mt005_registry_and_docs_cross_checks_match_jax():
    """The registry keys (missing, unrendered, retyped, relabeled) and the
    docs keys (markers, stale table) fire as in the JAX plane; the docs
    findings name the port's own file."""
    drifted = {_widget("ops_total"): ("gauge", ["kind"]),
               _widget("ghost_total"): ("counter", [])}
    cases = [dict(registry=drifted), dict(docs_text="prose with no markers"),
             dict(docs_text=f"{DOCS_BEGIN}\n| metric | type | labels |\n{DOCS_END}")]
    for kw in cases:
        facts, _ = collect_metric_facts([FIXTURES / "mt005_base.py"], root=FIXTURES)
        jfacts, _ = jax_met.collect_metric_facts([FIXTURES / "mt005_base.py"], root=FIXTURES)
        mine = check_metric_facts(facts, MetricsManifest(entrypoints=census_snapshot(facts)),
                                  [], **kw)
        theirs = jax_met.check_metric_facts(
            jfacts, JaxManifest(entrypoints=jax_met.census_snapshot(jfacts)), [], **kw)
        assert sorted((f.rule, f.key) for f in mine) == sorted((f.rule, f.key) for f in theirs)
        assert mine and all(f.rule == "MT005" for f in mine)
        if "docs_text" in kw:
            assert {f.entrypoint for f in mine} == {DOCS_PATH.as_posix()}
    good = f"prose\n{DOCS_BEGIN}\n{render_docs_table(facts['metrics'])}{DOCS_END}\n"
    assert render_docs_table(facts["metrics"]) == jax_met.render_docs_table(jfacts["metrics"])
    assert not check_metric_facts(facts, MetricsManifest(entrypoints=census_snapshot(facts)),
                                  [], docs_text=good)


def test_rule_table_matches_jax():
    assert MET_RULES == jax_met.MET_RULES
    assert METRIC_PREFIX == jax_met.METRIC_PREFIX


def test_census_is_jax_census_on_the_names_the_port_renders(real):
    """Every name the port renders is one the JAX package renders, with
    the same type and labels; the JAX names the port does not render are
    the recorded differences."""
    facts, _, _, jfacts = real
    assert set(jfacts["metrics"]) - set(facts["metrics"]) == NOT_RENDERED
    assert set(facts["metrics"]) <= set(jfacts["metrics"])
    for name, info in facts["metrics"].items():
        theirs = jfacts["metrics"][name]
        assert (info["type"], info["labels"]) == (theirs["type"], theirs["labels"]), name


def test_schema_is_the_census_with_jax_entries(real):
    facts, *_ = real
    assert set(SCHEMA) == set(facts["metrics"])
    for name, entry in SCHEMA.items():
        assert entry == JAX_SCHEMA[name], name


def test_consumers_and_engine_keys_resolve(real):
    """The port's tests and chip_smoke.py scrape only rendered names, and
    read only keys the port's ``EngineCore.metrics()`` sets (its
    ``**(self.host_pool.stats() ...)`` folds included)."""
    facts, *_ = real
    assert facts["consumers"] and set(facts["consumers"]) <= set(facts["metrics"])
    engine = facts["engine"]
    assert {"host_blocks_stored", "persist_hits"} <= set(engine["keys"])
    assert engine["consumers"] and set(engine["consumers"]) <= set(engine["keys"])


def test_renamed_counter_is_caught_at_the_scrape_site(real):
    """Drop a rendered counter from the census and MT002 names the port
    test that scrapes it."""
    facts, *_ = real
    broken = copy.deepcopy(facts)
    del broken["metrics"][EM.PREFILL_DISPATCHES_TOTAL]
    hits = [f for f in check_metric_facts(broken, MetricsManifest(), [], drift=False)
            if f.rule == "MT002" and f.entrypoint == EM.PREFILL_DISPATCHES_TOTAL]
    assert any(f.key.startswith("tests/test_torch_") for f in hits), [f.key for f in hits]


def test_module_path_literal_is_not_a_scrape(tmp_path):
    """The port's package name as a module or file path is not a scrape in
    the port's plane (the JAX plane reads it as one); a metric name that
    merely starts with the package name still is."""
    pkg = dynamo_tpu_torch.__name__
    mod = tmp_path / "paths.py"
    mod.write_text(
        f"MOD = {pkg + '.engine.core'!r}\n"
        f"CMD = ['python3', '-m', {pkg!r}, 'lint']\n"
        f"LOG = {'python3 -m ' + pkg + ' run in=http'!r}\n"
        f"FILE = {pkg + '/ops/kernels'!r}\n"
        f"SCRAPED = {pkg + '_widget_total'!r}\n")
    facts, _ = collect_metric_facts([mod], root=tmp_path)
    jfacts, _ = jax_met.collect_metric_facts([mod], root=tmp_path)
    assert sorted(facts["consumers"]) == [pkg + "_widget_total"]
    assert pkg in jfacts["consumers"]


# -------------------------------------------------------------- gate ----


def test_metrics_gate_zero_nonaccepted_findings(real):
    """The port's gate: the census, every scrape and engine-dict read is
    clean against the committed manifest, SCHEMA and the port's docs
    table.  After a deliberate change re-snapshot with ``lint --metrics
    --update-baseline`` and justify any new accepted entry."""
    manifest = MetricsManifest.load(DEFAULT_METRICS_MANIFEST_PATH)
    assert len(manifest.entrypoints) == len(SCHEMA)
    fresh = manifest.filter(_real_findings(real, manifest))
    assert not fresh, "\n".join(f.render() for f in fresh)


def test_manifest_entries_justified_live_and_jax(real):
    """The one accepted entry (the shard fan-out histogram in ms) is JAX's,
    with JAX's justification, and still matches a finding."""
    from manifest_hygiene import assert_manifest_hygiene

    manifest = MetricsManifest.load(DEFAULT_METRICS_MANIFEST_PATH)
    assert_manifest_hygiene(manifest, _real_findings(real, manifest), entity_field="entrypoint")
    jmanifest = JaxManifest.load(jax_met.DEFAULT_METRICS_MANIFEST_PATH)
    assert sorted(map(json.dumps, manifest.accepted)) == sorted(
        map(json.dumps, jmanifest.accepted))
    assert manifest.entrypoints == {n: e for n, e in jmanifest.entrypoints.items()
                                    if n not in NOT_RENDERED}
    assert "hbm_budget" not in manifest.header


# ------------------------------------------------ update + CLI contract ----


def _args(**kw):
    base = dict(paths=None, fmt="text", select=None, baseline=None, no_baseline=False,
                update_baseline=False, root=None, project=False, wire=False, metrics=True,
                manifest=None, changed=False)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture()
def widget_root(tmp_path, monkeypatch):
    """A scan root holding the MT001 bad fixture inside a package directory
    named as the port's, a docs/torch_observability.md with the markers,
    and a decoy docs/observability.md; SCHEMA pinned to the widget."""
    (tmp_path / PKG.name).mkdir()
    shutil.copy(FIXTURES / "mt001_bad.py", tmp_path / PKG.name / "mt001_bad.py")
    (tmp_path / "docs").mkdir()
    (tmp_path / DOCS_PATH).write_text(f"head\n{DOCS_BEGIN}\n{DOCS_END}\ntail\n")
    (tmp_path / "docs" / "observability.md").write_text(f"{DOCS_BEGIN}\nJAX's\n{DOCS_END}\n")
    monkeypatch.setattr(metric_names, "SCHEMA",
                        {_widget("dispatches_total"): ("counter", ())})
    return tmp_path


def test_update_roundtrip_writes_only_the_port_docs(widget_root):
    """finding -> exit 1 -> --update-baseline accepts it (TODO) and
    regenerates the port's docs table, leaving the JAX docs file alone ->
    justify -> exit 0 -> a second update carries the justification."""
    mpath = widget_root / "manifest.json"
    decoy = (widget_root / "docs" / "observability.md").read_text()

    def args(**kw):
        return _args(root=str(widget_root), manifest=str(mpath), **kw)

    assert run_metrics(args(), out=io.StringIO()) == 1
    assert run_metrics(args(update_baseline=True), out=io.StringIO()) == 0
    doc = json.loads(mpath.read_text())
    assert _widget("dispatches_total") in doc["entrypoints"]
    assert [(e["rule"], e["justification"]) for e in doc["accepted"]] == [
        ("MT001", "TODO: justify")]
    docs = (widget_root / DOCS_PATH).read_text()
    assert docs.startswith("head\n") and docs.endswith("tail\n")
    assert f"`{_widget('dispatches_total')}` | counter" in docs
    assert (widget_root / "docs" / "observability.md").read_text() == decoy
    doc["accepted"][0]["justification"] = "kept: debug-only family"
    mpath.write_text(json.dumps(doc))
    assert run_metrics(args(), out=io.StringIO()) == 0
    assert run_metrics(args(update_baseline=True), out=io.StringIO()) == 0
    doc = json.loads(mpath.read_text())
    assert [e["justification"] for e in doc["accepted"]] == ["kept: debug-only family"]


def test_docs_table_drift_is_caught_in_the_port_file(widget_root):
    """A hand edit of the port's generated table fails the gate (MT005
    docs-table on docs/torch_observability.md); the JAX docs file is not
    read."""
    mpath = widget_root / "manifest.json"
    assert run_metrics(_args(root=str(widget_root), manifest=str(mpath), update_baseline=True),
                       out=io.StringIO()) == 0
    doc = json.loads(mpath.read_text())
    doc["accepted"][0]["justification"] = "kept"
    mpath.write_text(json.dumps(doc))
    (widget_root / "docs" / "observability.md").write_text("no markers at all\n")
    assert run_metrics(_args(root=str(widget_root), manifest=str(mpath)),
                       out=io.StringIO()) == 0
    path = widget_root / DOCS_PATH
    path.write_text(path.read_text().replace("counter", "gauge"))
    out = io.StringIO()
    assert run_metrics(_args(root=str(widget_root), manifest=str(mpath), fmt="json"), out=out) == 1
    found = json.loads(out.getvalue())["findings"]
    assert [(f["entrypoint"], f["rule"], f["key"]) for f in found] == [
        (DOCS_PATH.as_posix(), "MT005", "docs-table")]


def test_json_output_stable_sorted(widget_root):
    outs = []
    for _ in range(2):
        out = io.StringIO()
        run_metrics(_args(root=str(widget_root), fmt="json",
                          manifest=str(widget_root / "m.json")), out=out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    doc = json.loads(outs[0])
    assert {"findings", "accepted", "total", "metrics"} <= set(doc)
    assert doc["findings"] == sorted(doc["findings"],
                                     key=lambda f: (f["entrypoint"], f["rule"], f["key"]))


def test_changed_skip_when_plane_untouched(widget_root, monkeypatch):
    monkeypatch.setattr(met, "_metrics_affected", lambda root: False)
    out = io.StringIO()
    assert run_metrics(_args(root=str(widget_root), changed=True,
                             manifest=str(widget_root / "m.json")), out=out) == 0
    assert "unaffected" in out.getvalue()


def test_manifest_filter_is_a_multiset():
    f = MetricFinding(_widget("ops_total"), "MT001", "k", "d")
    m = MetricsManifest(accepted=[{"entrypoint": _widget("ops_total"), "rule": "MT001",
                                   "key": "k"}])
    assert m.filter([f]) == [] and m.filter([f, f]) == [f]


def test_lint_metrics_on_the_port_tree(capsys):
    """``python -m <the port> lint --metrics`` exits 0 on the port's tree."""
    with pytest.raises(SystemExit) as e:
        port_cli.main(["lint", "--metrics"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        f"0 metrics findings (1 accepted) over {len(SCHEMA)} metrics")


def test_lint_metrics_exit_codes(widget_root, capsys, monkeypatch):
    """``lint --metrics``: 1 on the widget root's MT001 finding; beside
    another plane's flag the JAX command's precedence runs one plane
    (``--trace`` before ``--metrics``)."""
    out = io.StringIO()
    assert run_lint(_args(root=str(widget_root), manifest=str(widget_root / "m.json")),
                    out=out) == 1
    assert "MT001" in out.getvalue()
    from dynamo_tpu_torch.analysis import tracecheck

    monkeypatch.setattr(tracecheck, "run_trace", lambda args, out: print("trace ran", file=out))
    with pytest.raises(SystemExit) as e:
        port_cli.main(["lint", "--metrics", "--trace"])
    assert not e.value.code
    assert capsys.readouterr().out.strip() == "trace ran"
