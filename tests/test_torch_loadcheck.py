"""The port's load gate (``analysis/loadcheck.py``): its committed surface,
its rules held to the JAX plane's, its replay tokens and its CLI.

The gate: the pinned sweep at the card's committed figures gives zero
findings against the port's ``analysis/load_manifest.json``, which
accepts nothing, and whose ``params`` are the card file's figures.  The
rules: on the same facts and manifest, the port's ``check_load`` gives
JAX's findings (clean and regressed fixture facts, LD003 without drift,
LD005 on crafted sharded-router facts, the port's own surface).  A JAX
``dtl1.`` token replays here; ``--update-baseline`` refuses a non-pinned
run and carries justifications; a doubled decode step trips LD001; the
JSON output is stable and the exit codes are 0, 1 and 2.

The pinned sweep runs once in a module fixture (set-up, not a test's
call); the CLI tests reuse it by patching ``load.sim.sweep``.
"""

import argparse
import io
import json
from pathlib import Path

import pytest

import dynamo_tpu_torch
from dynamo_tpu.analysis import loadcheck as jax_loadcheck
from dynamo_tpu_torch import cli as port_cli
from dynamo_tpu_torch.analysis import cli as lint_cli
from dynamo_tpu_torch.analysis import loadcheck
from dynamo_tpu_torch.analysis.loadcheck import (
    DEFAULT_LOAD_MANIFEST_PATH,
    LOAD_RULES,
    LoadFinding,
    LoadManifest,
    check_load,
    decode_token,
    encode_token,
    run_load,
)
from dynamo_tpu_torch.load import sim
from dynamo_tpu_torch.load.workers import LatencyModel
from tests.manifest_hygiene import assert_manifest_hygiene

PKG = Path(dynamo_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FIXTURES = Path(__file__).parent / "lint_fixtures"
CARD = json.loads((PKG / "load" / "card_latency.json").read_text())


def _fixture(name):
    return json.loads((FIXTURES / name).read_text())


@pytest.fixture(scope="module")
def swept():
    """The pinned sweep ``python -m <the port> lint --load`` runs."""
    return sim.sweep(budget=1, seed_base=0)


@pytest.fixture
def reuse_sweep(monkeypatch, swept):
    """``run_load`` over the module's sweep instead of a fresh one."""
    calls = []

    def fake(*, budget=1, seed_base=0, **kw):
        calls.append((budget, seed_base))
        return json.loads(json.dumps(swept))

    monkeypatch.setattr(sim, "sweep", fake)
    return calls


def _args(**kw):
    base = dict(replay=None, manifest=None, root=None, changed=False,
                update_baseline=False, fmt="text", load=True)
    base.update(kw)
    return argparse.Namespace(**base)


# ------------------------------------------------------------------ the gate


def test_load_gate_zero_nonaccepted_findings(swept):
    """The tier-1 load gate: the port's capacity surface at the card's
    figures equals the committed one.  If this fails, reproduce the cell
    with the finding's replay token and fix the regression, or, for an
    intended change of the operating point (new card figures),
    re-snapshot with ``lint --load --update-baseline``."""
    manifest = LoadManifest.load(DEFAULT_LOAD_MANIFEST_PATH)
    findings = check_load(swept, manifest, drift=True)
    assert not manifest.filter(findings), "\n".join(f.render() for f in findings)
    assert manifest.accepted == []  # JAX's manifest accepts nothing either
    assert_manifest_hygiene(manifest, findings, entity_field="scenario")
    assert sorted(manifest.cells) == sorted(f"{f}/{t}" for f, t in sim.CELLS)
    for name, cell in swept["cells"].items():
        assert cell["twin_match"], name
        want = {"0.5", "1", "2", "4", "8"} if "r" in name.split("/")[1] else {"0.5", "1", "2"}
        assert set(cell["levels"]) == want, name


def test_manifest_params_are_the_card_figures():
    """The committed surface was swept at the committed card figures, and
    that file names the card and its power limit."""
    params = LoadManifest.load(DEFAULT_LOAD_MANIFEST_PATH).params
    for k in ("prefill_ms_per_token", "decode_ms_per_step", "router_ms_per_decision",
              "kv_bytes_per_block", "scale"):
        assert params[k] == CARD[k], k
    assert params["target_requests"] == 160
    assert "H100" in CARD["card"] and CARD["card"].endswith(" W")


# -------------------------------------------------- the rules, held to JAX's


def _shard_cell(knee, offered):
    levels = {str(lvl): {"offered_rps": rps, "ttft_p99_ms": 50.0, "shed_rate": 0.0,
                         "completed": 100, "sla_ttft_ms": 280.0}
              for lvl, rps in offered.items()}
    return {"levels": levels, "census": {}, "twin_match": True, "knee_level": knee}


_LADDER = {0.5: 1.3, 1.0: 2.6, 2.0: 5.2, 4.0: 10.5, 8.0: 21.0}


def _shard_facts(r4_knee, r4_levels):
    return {"cells": {"agentic/w16r1": _shard_cell(2.0, {k: v for k, v in _LADDER.items()
                                                          if k <= 2}),
                      "agentic/w16r4": _shard_cell(r4_knee, r4_levels)},
            "params": {"target_requests": 100, "levels": sorted(_LADDER)}}


def _case(name, swept):
    """(facts, manifest cells, drift) of one comparison case."""
    base = _fixture("ld_baseline_facts.json")
    regressed = _fixture("ld_regressed_facts.json")
    committed = LoadManifest.load(DEFAULT_LOAD_MANIFEST_PATH).cells
    if name == "clean":
        return base, base["cells"], True
    if name == "regressed":
        return regressed, base["cells"], True
    if name == "ld003_without_drift":
        return regressed, base["cells"], False
    if name == "ld005_holds":
        facts = _shard_facts(8.0, _LADDER)
        return facts, facts["cells"], True
    if name == "ld005_trips":
        facts = _shard_facts(2.0, {k: v for k, v in _LADDER.items() if k <= 2})
        return facts, facts["cells"], True
    if name == "cell_set_drift":
        return ({"cells": {"steady/w4": base["cells"]["steady/w4"],
                           "new/w2": {"levels": {}, "census": {}, "twin_match": True,
                                      "knee_level": None}},
                 "params": base["params"]}, base["cells"], True)
    if name == "port_surface":
        return swept, committed, True
    if name == "port_surface_vs_fixture":
        return swept, base["cells"], True
    raise KeyError(name)


@pytest.mark.parametrize("case", ["clean", "regressed", "ld003_without_drift", "ld005_holds",
                                  "ld005_trips", "cell_set_drift", "port_surface",
                                  "port_surface_vs_fixture"])
def test_check_load_matches_jax(case, swept):
    facts, cells, drift = _case(case, swept)
    ours = check_load(facts, LoadManifest(cells=cells), drift=drift, seed_base=3)
    ref = jax_loadcheck.check_load(facts, jax_loadcheck.LoadManifest(cells=cells),
                                   drift=drift, seed_base=3)
    assert [f.to_json() for f in ours] == [f.to_json() for f in ref]
    rules = {f.rule for f in ours}
    want = {"clean": set(), "regressed": {"LD001", "LD002", "LD003", "LD004"},
            "ld003_without_drift": {"LD003"}, "ld005_holds": set(), "ld005_trips": {"LD005"},
            "cell_set_drift": {"LD004"}, "port_surface": set()}
    if case in want:
        assert rules == want[case]
    if case == "ld005_trips":
        assert {f.key for f in ours} == {"knee", "sustained"}


def test_rule_registry_matches_jax():
    assert LOAD_RULES == jax_loadcheck.LOAD_RULES
    assert set(LOAD_RULES) == {"LD001", "LD002", "LD003", "LD004", "LD005"}


def test_doubled_decode_step_trips_ld001(swept):
    """A capacity regression the gate must catch: the card's decode step
    doubled moves p99 TTFT past the committed surface, and LD001 carries
    a replay token."""
    base = LatencyModel.from_card()
    slow = LatencyModel(prefill_ms_per_token=base.prefill_ms_per_token,
                        decode_ms_per_step=2 * base.decode_ms_per_step,
                        router_ms_per_decision=base.router_ms_per_decision,
                        kv_bytes_per_block=base.kv_bytes_per_block)
    facts = sim.sweep(lat=slow, cells=(("steady", "w4"), ("agentic", "w4")))
    ld001 = [f for f in check_load(facts, LoadManifest(cells=swept["cells"]), drift=True)
             if f.rule == "LD001"]
    assert ld001, "a doubled decode step must trip LD001"
    assert any("replay dtl1." in f.detail for f in ld001)


# ------------------------------------------------------------- replay tokens


def test_jax_token_replays_in_the_port(capsys):
    """One token format: a JAX token decodes to the same payload here and
    ``--replay`` re-runs its cell (at the port's latency model); a port
    token decodes in JAX; a foreign token is refused with 2."""
    payload = {"family": "steady", "topology": "w1", "level": 0.5, "seed": 0,
               "target": 30}
    token = jax_loadcheck.encode_token(payload)
    assert token == encode_token(payload)
    assert decode_token(token) == payload
    assert jax_loadcheck.decode_token(encode_token(payload)) == payload
    with pytest.raises(ValueError):
        decode_token("dtp1.notmine")
    out = io.StringIO()
    assert run_load(_args(replay=token), out) == 0
    assert "steady/w1 level=0.5 seed=0" in out.getvalue()
    res = sim.run_cell("steady", "w1", seed=0, level=0.5, target_requests=30)
    assert f"p99 TTFT {res['metrics']['ttft_p99_ms']}ms" in out.getvalue()
    out = io.StringIO()
    assert run_load(_args(replay=token, fmt="json"), out) == 0
    doc = json.loads(out.getvalue())
    assert doc["cell"] == "steady/w1" and doc["metrics"] == res["metrics"]
    out = io.StringIO()
    assert run_load(_args(replay="dtp1.abc"), out) == 2
    assert "not a dtload replay token" in out.getvalue()


# ------------------------------------------------------------------ manifest


def test_update_baseline_refuses_non_pinned(monkeypatch, tmp_path, reuse_sweep):
    """A non-pinned run never rewrites the manifest, and is refused before
    any sweep."""
    for env, value in (("DTLOAD_BUDGET", "3"), ("DTLOAD_SCALE", "2"), ("DTLOAD_TARGET", "30"),
                       ("DTLOAD_SEED_BASE", "4")):
        monkeypatch.setenv(env, value)
        out = io.StringIO()
        assert run_load(_args(update_baseline=True, manifest=str(tmp_path / "m.json")),
                        out) == 2
        assert "refusing" in out.getvalue()
        monkeypatch.delenv(env)
    assert not (tmp_path / "m.json").exists() and reuse_sweep == []


def test_update_baseline_carries_justifications(tmp_path, reuse_sweep):
    prev = LoadManifest(accepted=[{
        "scenario": "a/w1", "rule": "LD001", "key": "p99:1",
        "detail": "old", "justification": "known jitter"}])
    facts = {"cells": {"a/w1": {"levels": {}, "census": {}, "twin_match": True,
                                "knee_level": None}}, "params": {}}
    m = LoadManifest.from_facts(facts, [LoadFinding("a/w1", "LD001", "p99:1", "new")], prev)
    assert m.accepted[0]["justification"] == "known jitter"
    assert m.accepted[0]["detail"] == "new"
    path = tmp_path / "m.json"
    m.save(path)
    assert LoadManifest.load(path).accepted == m.accepted
    # the CLI's re-snapshot of the committed surface is the committed file
    out = io.StringIO()
    copy = tmp_path / "load_manifest.json"
    assert run_load(_args(update_baseline=True, manifest=str(copy)), out) == 0
    assert "13 cells, 0 accepted findings" in out.getvalue()
    assert copy.read_text() == DEFAULT_LOAD_MANIFEST_PATH.read_text()


def test_accepted_entry_budget_is_a_multiset():
    f1 = LoadFinding("a/w1", "LD001", "p99:1", "x")
    f2 = LoadFinding("a/w1", "LD001", "p99:1", "y")
    m = LoadManifest(accepted=[{"scenario": "a/w1", "rule": "LD001", "key": "p99:1",
                                "justification": "ok"}])
    assert m.filter([f1, f2]) == [f2]


def test_manifest_json_is_stable(tmp_path):
    p = tmp_path / "m.json"
    LoadManifest.load(DEFAULT_LOAD_MANIFEST_PATH).save(p)
    assert p.read_text() == DEFAULT_LOAD_MANIFEST_PATH.read_text()
    LoadManifest.load(p).save(p)
    assert p.read_text() == DEFAULT_LOAD_MANIFEST_PATH.read_text()


# ----------------------------------------------------------------------- CLI


def test_run_load_json_output_and_exit_codes(tmp_path, reuse_sweep):
    """0 on the committed surface (text and a stable JSON document), 1
    against a manifest whose surface is better than what is swept, 2 on a
    refused request."""
    outs = []
    for _ in range(2):
        out = io.StringIO()
        assert run_load(_args(fmt="json"), out) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    doc = json.loads(outs[0])
    assert doc == {"findings": [], "accepted": 0, "total": 0,
                   "cells": sorted(f"{f}/{t}" for f, t in sim.CELLS), "runs": 58}
    out = io.StringIO()
    assert run_load(_args(), out) == 0
    assert out.getvalue().strip().splitlines()[-1] == (
        "0 load findings (0 accepted) over 13 cells, 58 deterministic runs")
    better = json.loads(DEFAULT_LOAD_MANIFEST_PATH.read_text())
    better["cells"]["agentic/w4"]["levels"]["1"]["ttft_p99_ms"] = 1.0
    better["cells"]["agentic/w4"]["knee_level"] = None
    path = tmp_path / "better.json"
    path.write_text(json.dumps(better))
    out = io.StringIO()
    assert run_load(_args(manifest=str(path), fmt="json"), out) == 1
    keys = {(f["scenario"], f["rule"], f["key"]) for f in json.loads(out.getvalue())["findings"]}
    assert keys == {("agentic/w4", "LD001", "p99:1"), ("agentic/w4", "LD002", "knee")}


def test_changed_runs_the_sweep_only_for_control_plane_files(monkeypatch, reuse_sweep):
    """``--changed`` skips the sweep unless a file the sweep executes, or
    the card file, is dirty; the JAX package's files never count."""
    for dirty, runs in ((PKG / "llm" / "kv_router" / "scheduler.py", True),
                        (PKG / "load" / "card_latency.json", True),
                        (PKG / "models" / "llama.py", False),
                        (ROOT / "dynamo_tpu" / "llm" / "kv_router" / "scheduler.py", False)):
        monkeypatch.setattr(lint_cli, "_git_changed_paths",
                            lambda root, suffixes=(".py",), d=dirty:
                            [d] if str(d).endswith(suffixes) else [])
        before = len(reuse_sweep)
        out = io.StringIO()
        assert run_load(_args(changed=True), out) == 0
        assert (len(reuse_sweep) > before) == runs, dirty
        if not runs:
            assert "unaffected" in out.getvalue()


def test_lint_load_command(capsys):
    """The whole command through the port's CLI, once, unpatched."""
    with pytest.raises(SystemExit) as e:
        port_cli.main(["lint", "--load"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        "0 load findings (0 accepted) over 13 cells, 58 deterministic runs")
    assert loadcheck.DEFAULT_LOAD_MANIFEST_PATH == PKG / "analysis" / "load_manifest.json"
