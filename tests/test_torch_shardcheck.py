"""The port's sharding plane (dtshard, ``lint --shard``): what each rank of the
(1, 4) audit mesh holds, rank 0's collectives a decode turn and each rank's
in-place cache write.

Against the JAX package: the placement census of the three tiny rigs equals
JAX's committed ``shard_manifest.json`` leaf for leaf (shape, dtype, spec
string, global bytes, bytes per chip in JAX's spec math, model-axis
replication) and in its spec hash.  It is read from the JSON: JAX's own
``shardcheck`` cannot build its audit mesh under the installed jax.  Then
the gate against the port's committed manifest, the port's own per-rank
figures where its shard rule is not JAX's even split, and each rule
SH001-SH005 tripped (exit 1).  The plane's facts are collected once for
the module.
"""

from __future__ import annotations

import argparse
import io
import json
from pathlib import Path

import pytest

import dynamo_tpu
from dynamo_tpu_torch.analysis import shardcheck as sc
from dynamo_tpu_torch.analysis.shardcheck import (DEFAULT_SHARD_MANIFEST_PATH, ShardManifest,
                                                  check_shard_facts, collect_shard_facts,
                                                  run_shard)

JAX_MANIFEST = Path(dynamo_tpu.__file__).parent / "analysis" / "shard_manifest.json"
TINY = ["tiny-llama", "tiny-llama-int8", "tiny-mla"]
FIELDS = ("shape", "dtype", "spec", "bytes_global", "bytes_per_chip", "replicated_model")


@pytest.fixture(scope="module")
def facts():
    return collect_shard_facts()


def _args(**kw):
    base = dict(paths=None, fmt="text", select=None, baseline=None, no_baseline=False,
                update_baseline=False, root=None, project=False, proto=False, load=False,
                wire=False, metrics=False, trace=False, shard=True, kern=False, perf=False,
                all=False, manifest=None, replay=None, changed=False)
    base.update(kw)
    return argparse.Namespace(**base)


# ---------------------------------------------------------- JAX's census ----


@pytest.mark.parametrize("tag", TINY)
def test_placement_census_equals_jax(tag, facts):
    ref = json.loads(JAX_MANIFEST.read_text())["entrypoints"][f"placement[{tag}]"]
    ours = facts[f"placement[{tag}]"]
    assert sorted(ours["leaves"]) == sorted(ref["leaves"])
    for name, leaf in ref["leaves"].items():
        assert {k: ours["leaves"][name][k] for k in FIELDS} == {k: leaf[k] for k in FIELDS}, name
    for key in ("mesh", "spec_hash", "params_bytes_per_chip", "cache_bytes_per_chip",
                "total_bytes_per_chip", "replicated_bytes_per_chip"):
        assert ours[key] == ref[key], key


def test_accepted_replication_is_jaxs(facts):
    """The leaves the model axis replicates that JAX accepts are the port's
    SH001 findings at the tiny rigs (the embeddings, the int8 scale pool at
    Hk = 2, the MLA latent cache), and no more."""
    ref = json.loads(JAX_MANIFEST.read_text())["accepted"]
    jax_sh001 = {(a["entrypoint"], a["key"]) for a in ref if a["rule"] == "SH001"
                 and "v5e" not in a["entrypoint"]}
    ours = {(f.entrypoint, f.key) for f in check_shard_facts(facts, ShardManifest())
            if f.rule == "SH001" and "h100" not in f.entrypoint}
    assert ours == jax_sh001


def test_per_rank_figures_where_the_port_splits_by_whole_heads(facts):
    """At tp = 4 over Hk = 2 kv heads a rank holds one whole kv head (its
    wk/wv columns and cache lanes twice JAX's even split), and an int8 rank
    re-pads its scales to a whole tile; Llama-3-8B splits evenly.  Tiny MLA's
    2 heads do not split over 4 ranks: the port refuses that mesh, so its
    probe runs at tp = 2."""
    tiny = facts["placement[tiny-llama]"]["leaves"]
    assert tiny["cache"]["bytes_per_rank"] == 2 * tiny["cache"]["bytes_per_chip"]
    assert tiny["params['layers']['wk']"]["bytes_per_rank"] == 1024
    q8 = facts["placement[tiny-llama-int8]"]["leaves"]
    assert q8["cache.scale"]["bytes_per_rank"] == q8["cache.scale"]["bytes_global"]
    big = facts["placement[llama3-8b-h100]"]
    assert big["total_bytes_per_rank"] == big["total_bytes_per_chip"] == 5_340_405_760
    assert big["budget_bytes"] == int(0.95 * 80e9)
    mla = facts["placement[tiny-mla]"]
    assert mla["rank_model"].startswith("refused") and mla["total_bytes_per_rank"] is None
    assert facts["probe.deepseek.decode[tiny-mla]"]["mesh"] == {"data": 1, "model": 2}


def test_decode_probes_need_only_the_tp_layout_and_the_broadcast(facts):
    for name, f in facts.items():
        if not name.startswith("probe."):
            continue
        coll = f["collectives"]
        assert {k: c["count"] for k, c in coll.items()} == dict(
            f["layout_needs"], **{"broadcast_object:world": 1}), name
        assert all(s["written_in_place"] and not s["copied"] and s["shape"] == s["spec_shape"]
                   for s in f["slices"]), name


# ---------------------------------------------------------------- the gate ----


def test_shard_gate_zero_nonaccepted_findings(facts):
    manifest = ShardManifest.load(DEFAULT_SHARD_MANIFEST_PATH)
    fresh = manifest.filter(check_shard_facts(facts, manifest))
    assert not fresh, "\n".join(f.render() for f in fresh)


def test_manifest_accepted_entries_justified_and_live(facts):
    manifest = ShardManifest.load(DEFAULT_SHARD_MANIFEST_PATH)
    live = {f.accept_key for f in check_shard_facts(facts, manifest)}
    assert manifest.accepted
    for e in manifest.accepted:
        assert e["justification"].strip() not in ("", "TODO: justify"), e
        assert (e["entrypoint"], e["rule"], e["key"]) in live, e
    assert manifest.header["audit_mesh"] == {"data": 1, "model": 4}


# ------------------------------------------------------ the rules, tripped ----


_RIGS = sc._rigs


def _tiny_rig(**kw):
    return [dict(_RIGS()[0], **kw)]


def _run(monkeypatch, tmp_path, rigs, snapshot=None):
    """run_shard over ``rigs`` against a manifest snapshotted from
    ``snapshot`` (rigs) or empty: (exit code, text)."""
    mpath = tmp_path / "shard_manifest.json"
    if snapshot is not None:
        monkeypatch.setattr(sc, "_rigs", lambda: snapshot)
        assert run_shard(_args(manifest=str(mpath), update_baseline=True), io.StringIO()) == 0
    monkeypatch.setattr(sc, "_rigs", lambda: rigs)
    out = io.StringIO()
    return run_shard(_args(manifest=str(mpath)), out), out.getvalue()


def test_clean_snapshot_exits_0(monkeypatch, tmp_path):
    rc, text = _run(monkeypatch, tmp_path, _tiny_rig(), snapshot=_tiny_rig())
    assert rc == 0 and text.strip() == "0 shard findings (2 accepted) over 2 entries"


def test_sh001_replicated_leaf(monkeypatch, tmp_path):
    rc, text = _run(monkeypatch, tmp_path, _tiny_rig(), snapshot=_tiny_rig(cache_dtype="int8"))
    assert rc == 1 and "placement[tiny-llama]: SH001[params['embed']]" in text


def test_sh002_collective_beyond_the_layout(monkeypatch, tmp_path):
    from dynamo_tpu_torch.models.llama import LlamaModel

    plain = LlamaModel.compute_logits

    def twice(self, hidden):
        out = plain(self, hidden)
        if self.mesh is not None:
            self.mesh.all_gather(out, "model", dim=-1)
        return out

    mpath = tmp_path / "shard_manifest.json"
    monkeypatch.setattr(sc, "_rigs", _tiny_rig)
    assert run_shard(_args(manifest=str(mpath), update_baseline=True), io.StringIO()) == 0
    monkeypatch.setattr(LlamaModel, "compute_logits", twice)
    out = io.StringIO()
    assert run_shard(_args(manifest=str(mpath)), out) == 1
    assert "probe.llama.decode[tiny-llama]: SH002[all_gather:modelx1]" in out.getvalue()


def test_sh003_over_the_card(monkeypatch, tmp_path):
    rc, text = _run(monkeypatch, tmp_path, _tiny_rig(budget=1000), snapshot=_tiny_rig())
    assert rc == 1 and "placement[tiny-llama]: SH003[total]" in text


def test_sh004_spec_drift(monkeypatch, tmp_path):
    from dynamo_tpu_torch.models import llama

    mpath = tmp_path / "shard_manifest.json"
    monkeypatch.setattr(sc, "_rigs", _tiny_rig)
    assert run_shard(_args(manifest=str(mpath), update_baseline=True), io.StringIO()) == 0
    specs = llama.partition_specs

    def lm_head_whole(cfg):
        out = specs(cfg)
        out.pop("lm_head")
        return out

    monkeypatch.setattr(llama, "partition_specs", lm_head_whole)
    out = io.StringIO()
    assert run_shard(_args(manifest=str(mpath)), out) == 1
    assert "placement[tiny-llama]: SH004[specs]" in out.getvalue()


def test_sh005_cache_slice_not_written(monkeypatch, tmp_path):
    from dynamo_tpu_torch.models import llama

    mpath = tmp_path / "shard_manifest.json"
    monkeypatch.setattr(sc, "_rigs", _tiny_rig)
    assert run_shard(_args(manifest=str(mpath), update_baseline=True), io.StringIO()) == 0
    monkeypatch.setattr(llama, "write_kv_cache_layer", lambda *a, **k: None)
    out = io.StringIO()
    assert run_shard(_args(manifest=str(mpath)), out) == 1
    text = out.getvalue()
    assert all(f"SH005[rank{r}:cache]" in text for r in range(4))


def test_json_output_is_stable(monkeypatch, tmp_path):
    monkeypatch.setattr(sc, "_rigs", _tiny_rig)
    outs = []
    for _ in range(2):
        out = io.StringIO()
        assert run_shard(_args(manifest=str(tmp_path / "none.json"), fmt="json"), out) == 1
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    doc = json.loads(outs[0])
    assert doc["entries"] == ["placement[tiny-llama]", "probe.llama.decode[tiny-llama]"]
    assert {f["rule"] for f in doc["findings"]} == {"SH001", "SH002", "SH004"}
