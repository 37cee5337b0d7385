"""The port's wire plane (``analysis/wirecheck.py``) held to the JAX
package's, and the port's own gate.

Every WR fixture under ``tests/lint_fixtures/`` (the JAX suite's, reused)
gives both planes the same channel facts and the same findings.  Over the
two packages' wire modules the planes extract the same fourteen channels,
under each package's module names, with equal facts and schema hashes.
Then the gate: ``lint --wire`` finds nothing outside the port's committed
``analysis/wire_manifest.json``, whose accepted entries carry the JAX
manifest's justifications.  Last, the update round trip, the JSON output
and the command's exit codes.
"""

import argparse
import io
import json
from pathlib import Path

import pytest

import dynamo_tpu
import dynamo_tpu_torch
from dynamo_tpu.analysis import wirecheck as jax_wire
from dynamo_tpu_torch import cli as port_cli
from dynamo_tpu_torch.analysis.cli import run_lint
from dynamo_tpu_torch.analysis.wirecheck import (
    DEFAULT_WIRE_MANIFEST_PATH,
    WIRE_RULES,
    WIRE_SCOPE_DIRS,
    WireFinding,
    WireManifest,
    check_wire,
    collect_wire_facts,
    run_wire,
)

PKG = Path(dynamo_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FIXTURES = Path(__file__).parent / "lint_fixtures"
WR_FIXTURES = (sorted(p.name for p in FIXTURES.glob("wr00*_*.py"))
               + ["wr007_base/proto.py", "wr007_drift/proto.py", "trace_envelope.py"])

# Channels the port's plane extracts that the JAX plane has no twin of.
# None: the port-only surfaces that speak over the wire yield no channel.
# The serving graphs' ``status`` endpoint returns its dict through the
# endpoint's generic JSON payload, which no literal producer/consumer pair
# meets, and the mesh followers' operations are tuples that
# ``torch.distributed`` pickles, not JSON dicts.
PORT_ONLY_CHANNELS: dict = {}
PORT_ONLY_SURFACES = ("examples/llm/components", "engine/follower.py", "sdk")


def _to_port(name: str) -> str:
    return name.replace(f"module:{dynamo_tpu.__name__}.", f"module:{dynamo_tpu_torch.__name__}.")


def _keys(findings):
    return sorted((f.message, f.rule, f.key) for f in findings)


@pytest.fixture(scope="module")
def real():
    """Both planes' facts and intrinsic findings over their own packages."""
    return collect_wire_facts(), jax_wire.collect_wire_facts()


# ------------------------------------------------------------ parity ----


@pytest.mark.parametrize("fixture", WR_FIXTURES)
def test_fixture_findings_match_jax(fixture):
    """Each WR fixture (the WR007 pair's two sides under their own roots):
    the same channel facts and, against a self-snapshot manifest, the same
    findings (channel, rule, key) in both planes."""
    path = FIXTURES / fixture
    facts, intrinsic = collect_wire_facts([path], root=path.parent)
    jfacts, jintrinsic = jax_wire.collect_wire_facts([path], root=path.parent)
    assert facts == jfacts
    mine = check_wire(facts, WireManifest(messages=facts), intrinsic)
    theirs = jax_wire.check_wire(jfacts, jax_wire.WireManifest(messages=jfacts), jintrinsic)
    assert _keys(mine) == _keys(theirs)
    rule = "WR" + fixture[2:5]
    if fixture.endswith("_bad.py"):
        assert rule in {f.rule for f in mine}, [f.render() for f in mine]
    elif fixture.endswith("_good.py"):
        assert rule not in {f.rule for f in mine}, [f.render() for f in mine]


def test_wr007_drift_pair_matches_jax():
    """The same module under two fixture roots: a manifest snapshotted
    from the base side flags only schema drift on the drift side, in both
    planes, with equal hashes."""
    sides = {}
    for plane in (collect_wire_facts, jax_wire.collect_wire_facts):
        sides[plane] = [plane([FIXTURES / side / "proto.py"], root=FIXTURES / side)[0]
                        for side in ("wr007_base", "wr007_drift")]
    (base, drift), (jbase, jdrift) = sides.values()
    assert (base, drift) == (jbase, jdrift)
    manifest = WireManifest(messages=base)
    assert not check_wire(base, manifest, [])
    assert [(f.rule, f.key) for f in check_wire(drift, manifest, [])] == [
        ("WR007", "schema-drift")]


def test_rule_table_matches_jax():
    """The same seven rules; WR005 speaks of torch where JAX's speaks of jax."""
    assert sorted(WIRE_RULES) == sorted(jax_wire.WIRE_RULES) == [f"WR00{i}" for i in range(1, 8)]
    assert "torch" in WIRE_RULES["WR005"][1] and "jax" not in WIRE_RULES["WR005"][1]
    assert WIRE_SCOPE_DIRS == jax_wire.WIRE_SCOPE_DIRS


def test_wr005_flags_a_torch_value(tmp_path):
    """The port's WR005 counterpart: a torch scalar or tensor flowing into
    ``json.dumps`` is flagged as a numpy value is."""
    mod = tmp_path / "send.py"
    mod.write_text("import json\nimport torch\n\n\ndef send(sock, t):\n"
                   "    sock.send(json.dumps({\"kind\": \"x\", \"n\": torch.sum(t)}).encode())\n")
    _, intrinsic = collect_wire_facts([mod], root=tmp_path)
    hits = [f for f in intrinsic if f.rule == "WR005"]
    assert [f.key for f in hits] == ["send:n"]
    assert "torch.sum() value (numpy/torch scalar or tensor)" in hits[0].detail


def test_channels_match_jax(real):
    """The port's channels are JAX's fourteen under the port's module
    names, with equal facts (field census, discriminator domains, version
    tags, schema hash, producer and consumer counts), plus the listed
    port-only channels (none)."""
    (facts, _), (jfacts, _) = real
    assert len(jfacts) == 14
    mapped = {_to_port(name): f for name, f in jfacts.items()}
    assert set(facts) == set(mapped) | set(PORT_ONLY_CHANNELS)
    for name, f in mapped.items():
        assert facts[name] == f, name


def test_port_only_surfaces_add_no_channel(real):
    """Widening the scan to the port-only surfaces that speak over a wire
    (the serving graphs' status endpoint, the mesh followers, the SDK)
    extracts no further channel."""
    (facts, _), _ = real
    wide, _ = collect_wire_facts([PKG / d for d in WIRE_SCOPE_DIRS]
                                 + [PKG / s for s in PORT_ONLY_SURFACES], root=ROOT)
    assert set(wide) == set(facts)


def test_intrinsic_findings_match_jax(real):
    (_, intrinsic), (_, jintrinsic) = real
    assert _keys(intrinsic) == sorted((_to_port(m), r, k) for m, r, k in _keys(jintrinsic))


# -------------------------------------------------------------- gate ----


def test_wire_gate_zero_nonaccepted_findings(real):
    """The port's gate: every extracted contract is clean against the
    committed manifest.  After a deliberate change, re-snapshot with
    ``lint --wire --update-baseline`` and justify any new accepted entry."""
    (facts, intrinsic), _ = real
    manifest = WireManifest.load(DEFAULT_WIRE_MANIFEST_PATH)
    assert len(manifest.messages) == 14
    fresh = manifest.filter(check_wire(facts, manifest, intrinsic))
    assert not fresh, "\n".join(f.render() for f in fresh)


def test_manifest_carries_jax_justifications(real):
    """The six accepted WR001 entries are JAX's, each with JAX's
    justification, and each still matches a finding."""
    from manifest_hygiene import assert_manifest_hygiene

    (facts, intrinsic), _ = real
    manifest = WireManifest.load(DEFAULT_WIRE_MANIFEST_PATH)
    jmanifest = jax_wire.WireManifest.load(jax_wire.DEFAULT_WIRE_MANIFEST_PATH)
    assert_manifest_hygiene(manifest, check_wire(facts, manifest, intrinsic),
                            entity_field="message")
    assert sorted((e["message"], e["rule"], e["key"], e["justification"])
                  for e in manifest.accepted) == sorted(
        (_to_port(e["message"]), e["rule"], e["key"], e["justification"])
        for e in jmanifest.accepted)
    assert {e["rule"] for e in manifest.accepted} == {"WR001"}
    mapped = {_to_port(n): m["schema"] for n, m in jmanifest.messages.items()}
    assert {n: m["schema"] for n, m in manifest.messages.items()} == mapped


# ------------------------------------------------ update + CLI contract ----


def _args(**kw):
    base = dict(paths=None, fmt="text", select=None, baseline=None, no_baseline=False,
                update_baseline=False, root=None, project=False, wire=True, manifest=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_update_roundtrip_carries_justifications(tmp_path):
    """finding -> exit 1 -> --update-baseline accepts it (TODO) -> justify
    -> exit 0 -> a second update carries the justification by key."""
    mpath = tmp_path / "manifest.json"

    def args(**kw):
        return _args(paths=[str(FIXTURES / "wr001_bad.py")], root=str(FIXTURES),
                     manifest=str(mpath), **kw)

    assert run_wire(args(), out=io.StringIO()) == 1
    assert run_wire(args(update_baseline=True), out=io.StringIO()) == 0
    doc = json.loads(mpath.read_text())
    assert "module:wr001_bad/kind" in doc["messages"]
    assert [e["justification"] for e in doc["accepted"]] == ["TODO: justify"]
    doc["accepted"][0]["justification"] = "kept: debug metadata"
    mpath.write_text(json.dumps(doc))
    assert run_wire(args(), out=io.StringIO()) == 0
    assert run_wire(args(update_baseline=True), out=io.StringIO()) == 0
    doc = json.loads(mpath.read_text())
    assert [e["justification"] for e in doc["accepted"]] == ["kept: debug metadata"]


def test_json_output_stable_and_equal_to_jax(tmp_path):
    """``--format json`` is stable, sorted, and the JAX plane's document."""
    docs = []
    for plane in (run_wire, run_wire, jax_wire.run_wire):
        out = io.StringIO()
        plane(_args(paths=[str(FIXTURES / "wr003_bad.py")], root=str(FIXTURES), fmt="json",
                    manifest=str(tmp_path / "m.json")), out=out)
        docs.append(out.getvalue())
    assert docs[0] == docs[1] == docs[2]
    doc = json.loads(docs[0])
    assert doc["findings"] and doc["findings"] == sorted(
        doc["findings"], key=lambda f: (f["message"], f["rule"], f["key"]))


def test_manifest_filter_is_a_multiset():
    f = WireFinding("m", "WR001", "k", "d")
    m = WireManifest(accepted=[{"message": "m", "rule": "WR001", "key": "k"}])
    assert m.filter([f]) == [] and m.filter([f, f]) == [f]


def test_lint_wire_exit_codes(tmp_path, capsys, monkeypatch):
    """``lint --wire``: 0 on the port's tree (14 channels, 6 accepted), 1
    on a bad fixture with the JAX plane's finding; beside another plane's
    flag the JAX command's precedence runs one plane (``--trace`` first)."""
    with pytest.raises(SystemExit) as e:
        port_cli.main(["lint", "--wire"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        "0 wire findings (6 accepted) over 14 message types")
    out = io.StringIO()
    assert run_lint(_args(paths=[str(FIXTURES / "wr002_bad.py")], root=str(FIXTURES),
                          manifest=str(tmp_path / "m.json")), out=out) == 1
    assert "WR002" in out.getvalue()
    from dynamo_tpu_torch.analysis import tracecheck

    monkeypatch.setattr(tracecheck, "run_trace", lambda args, out: print("trace ran", file=out))
    with pytest.raises(SystemExit) as e:
        port_cli.main(["lint", "--wire", "--trace"])
    assert not e.value.code
    assert capsys.readouterr().out.strip() == "trace ran"
