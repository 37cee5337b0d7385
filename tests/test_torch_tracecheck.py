"""The port's compile plane (dttrace, ``lint --trace``): the dispatch-signature
census, the in-place cache audit, upcasts and the footprint.

Against the JAX package: the port's census of the 17 entry points both
packages register equals JAX's committed ``trace_manifest.json`` in axes and
signature counts (JAX's ``llama3b-v5e`` forward is the port's
``llama3-8b-h100``), and a seeded port engine at the config of JAX's
``test_seeded_run_compiles_once_per_bucket`` dispatches the signature set JAX
compiles there (two legacy prefill buckets, one burst), with nothing new in
an identical second run.  Then the gate against the port's committed
manifest, and each rule TR001-TR007 tripped by a small registry of its own
(exit 1).  The plane's facts are collected once for the module.
"""

from __future__ import annotations

import argparse
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import dynamo_tpu
from dynamo_tpu_torch.analysis import tracecheck as tc
from dynamo_tpu_torch.analysis.perfcheck import (Call, Dispatch, PerfEntry, llama3_8b_config,
                                                 tiny_engine_config)
from dynamo_tpu_torch.analysis.tracecheck import (DEFAULT_TRACE_MANIFEST_PATH, TraceManifest,
                                                  check_trace_facts, collect_trace_facts,
                                                  footprint, hbm_budget, record_dispatches,
                                                  run_trace, undeclared_dispatches)

JAX_MANIFEST = Path(dynamo_tpu.__file__).parent / "analysis" / "trace_manifest.json"
RENAMED = {"models.llama.forward[llama3b-v5e]": "models.llama.forward[llama3-8b-h100]"}
META = "meta"


@pytest.fixture(scope="module")
def facts():
    return collect_trace_facts()


@pytest.fixture(scope="module")
def footprint_8b():
    """TR007's figures for Llama-3-8B under ``chip_smoke.py``'s default-path
    config (8 slots, 2,048 tokens, 16-token blocks, 8-turn bursts)."""
    return footprint(llama3_8b_config(), tiny_engine_config(
        max_batch_size=8, max_model_len=2048, block_size=16, decode_steps=8, num_blocks=512,
        prefill_buckets=[]))


def _jax_entries() -> dict:
    return json.loads(JAX_MANIFEST.read_text())["entrypoints"]


# --------------------------------------------------------- JAX's census ----


def test_entry_set_is_jax_and_the_perf_extras(facts):
    """One registry for the perf and trace planes: JAX's 17 trace entries
    (renamed where the rig is the card's) and JAX's two perf extras."""
    shared = {RENAMED.get(n, n) for n in _jax_entries()}
    assert len(shared) == 17
    assert set(facts) == shared | {"ops.ring_attention[sp4]",
                                   "roofline.mlp_reference[llama3-8b-h100]"}


@pytest.mark.parametrize("name", sorted(json.loads(JAX_MANIFEST.read_text())["entrypoints"]))
def test_signature_census_equals_jax(name, facts):
    ref = _jax_entries()[name]
    ours = facts[RENAMED.get(name, name)]
    assert ours["axes"] == ref["axes"]
    assert ours["n_signatures"] == ref["n_signatures"]
    assert ours["stable"] and ref["stable"]
    assert set(ours["traced"]) >= set(ref["traced"])
    if ref["donation"] is not None:  # the port audits its forwards' writes too
        assert ours["donation"]["donated_leaves"] == ref["donation"]["donated_leaves"]


def _runtime_model():
    """The config of JAX's runtime census test, f32, seeded weights."""
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = ModelConfig(vocab_size=16, hidden_size=16, intermediate_size=32, num_layers=1,
                      num_heads=2, num_kv_heads=1, head_dim=8, max_position_embeddings=128,
                      dtype="float32")
    model = LlamaModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return cfg, model


def _drive(core, prompts, tag, max_tokens=4):
    from dynamo_tpu_torch.engine.request import EngineRequest
    from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions

    outs = []
    for i, p in enumerate(prompts):
        core.submit(EngineRequest(request_id=f"{tag}{i}", prompt=[int(x) for x in p],
                                  sampling=SamplingOptions(temperature=0.0),
                                  stops=StopConditions(max_tokens=max_tokens), emit=outs.append))
    for _ in range(64):
        if not core.step():
            break
    return outs


def test_seeded_run_dispatches_jax_signature_set():
    """JAX's ``test_seeded_run_compiles_once_per_bucket`` on the port: a
    10- and a 20-token prompt take the legacy prefill's two buckets (16 and
    32; the port pads the second to 24 tokens, in the 32 bucket), the decode
    hot loop its one declared burst, every dispatch in the declared matrix;
    an identical second run dispatches no new signature."""
    from dynamo_tpu_torch.engine import EngineConfig, EngineCore

    cfg, model = _runtime_model()
    ecfg = EngineConfig(max_batch_size=2, max_model_len=64, block_size=8, num_blocks=32,
                        prefill_buckets=[16, 32, 64], seed=0, enable_prefix_reuse=False)
    core = EngineCore(model, ecfg, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 16, size=10), rng.randint(1, 16, size=20)]
    try:
        with record_dispatches(ecfg) as first:
            _drive(core, prompts, "a")
        with record_dispatches(ecfg) as second:
            _drive(core, prompts, "b")
    finally:
        core.close()
    assert first.labels() == {"engine.step": {"s=16,pb=0", "s=32,pb=0"},
                              "engine.decode_multi": {"k=1"}}
    assert undeclared_dispatches(first, cfg) == []
    for entry, seen in second.seen.items():
        assert set(seen) <= set(first.seen[entry]), entry
    assert second.total() == first.total()


def test_undeclared_dispatch_is_caught():
    """A dispatch with an operand the declared signature has not (penalty
    buffers) or outside the matrix is undeclared."""
    from dynamo_tpu_torch.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.request import EngineRequest
    from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions

    cfg, model = _runtime_model()
    ecfg = EngineConfig(max_batch_size=2, max_model_len=64, block_size=8, num_blocks=32,
                        prefill_buckets=[16, 32, 64], seed=0)
    core = EngineCore(model, ecfg, device="cpu")
    try:
        with record_dispatches(ecfg) as log:
            core.submit(EngineRequest(
                request_id="p", prompt=list(range(1, 12)),
                sampling=SamplingOptions(temperature=0.0, frequency_penalty=0.5),
                stops=StopConditions(max_tokens=3), emit=lambda o: None))
            for _ in range(16):
                if not core.step():
                    break
    finally:
        core.close()
    assert ("engine.decode_multi", "k=1") in undeclared_dispatches(log, cfg)


def test_recording_restores_the_engine():
    from dynamo_tpu_torch.engine import core as ec
    from dynamo_tpu_torch.engine.draft import DraftProposer

    before = (ec.unified_step, ec.multi_decode_step, DraftProposer._impl)
    with record_dispatches(tiny_engine_config()):
        assert ec.unified_step is not before[0]
    assert (ec.unified_step, ec.multi_decode_step, DraftProposer._impl) == before


# ---------------------------------------------------------------- the gate ----


def test_trace_gate_zero_nonaccepted_findings(facts):
    manifest = TraceManifest.load(DEFAULT_TRACE_MANIFEST_PATH)
    fresh = manifest.filter(check_trace_facts(facts, manifest))
    assert not fresh, "\n".join(f.render() for f in fresh)


def test_manifest_accepted_entries_justified_and_live(facts):
    manifest = TraceManifest.load(DEFAULT_TRACE_MANIFEST_PATH)
    live = {f.accept_key for f in check_trace_facts(facts, manifest)}
    assert manifest.accepted
    for e in manifest.accepted:
        assert e["justification"].strip() not in ("", "TODO: justify"), e
        assert (e["entrypoint"], e["rule"], e["key"]) in live, e
    assert manifest.header["hbm_budget"]["bytes"] == hbm_budget() == int(0.95 * 80e9)


def test_every_step_writes_its_cache_in_place(facts):
    """TR004/TR005 hold everywhere without acceptance: every step function,
    the forwards and the scatter write each cache leaf (two for int8) in
    place and allocate no copy of it."""
    steps = {n: f["donation"] for n, f in facts.items() if f["donation"] is not None}
    assert len(steps) == 15  # 11 step functions, 3 forwards, the scatter
    for name, don in steps.items():
        want = 2 if "int8" in name else 1
        assert don["donated_leaves"] == don["written_in_place"] == want, name
        assert don["copied_leaves"] == [] and don["dead_leaves"] == [], name


def test_footprint_of_llama3_8b_on_the_card(facts, footprint_8b):
    """TR007's figures: Llama-3-8B's bf16 weights, the perf rig's KV pool and
    the walk's peak of live temporaries, well under 0.95 x 80 GB."""
    hbm = facts["models.llama.forward[llama3-8b-h100]"]["hbm"]
    assert hbm["params_bytes"] == 16_060_522_496
    assert hbm["kv_bytes"] == 32 * 1024 * 2 * 16 * 8 * 128 * 2
    peaks = hbm["peak_temp_bytes"]
    assert 0 < peaks["decode"] < peaks["prefill"] < 1 << 30
    assert hbm["total_bytes"] < hbm["budget_bytes"]
    f = footprint_8b
    assert f["params_bytes"] == hbm["params_bytes"]
    assert f["kv_bytes"] == hbm["kv_bytes"] // 2
    assert set(f["peak_temp_bytes"]) == {"engine.step[s=2048,pb=0]",
                                         "engine.decode_multi[k=8]"}
    assert f["total_bytes"] == f["params_bytes"] + f["kv_bytes"] + max(
        f["peak_temp_bytes"].values())


# ------------------------------------------------------ the rules, tripped ----


class _Weights(torch.nn.Module):
    def __init__(self, nbytes: int):
        super().__init__()
        self.w = torch.nn.Parameter(torch.empty(nbytes // 2, dtype=torch.bfloat16, device=META),
                                    requires_grad=False)


def _in_place(cache, rows):
    cache[:rows.shape[0]].copy_(rows)
    return rows.sum()


def _rebuilt(cache, rows):
    return torch.cat([rows, cache[rows.shape[0]:]])


def _untouched(cache, rows):
    return rows * 2


def _upcast(cache, rows):
    cache[:rows.shape[0]].copy_(rows)
    return rows.float().sum()


def _entry(name, fn, axes=None, statics=None, footprint_bytes=0):
    """A one-step registry entry over a [64, 32] bf16 cache."""
    axes = axes or {"n": [4, 8]}

    def setup():
        return _Weights(footprint_bytes or 2), torch.zeros((64, 32), dtype=torch.bfloat16,
                                                           device=META)

    def build(n):
        def make(base=None):
            _, cache = base or setup()
            rows = torch.zeros((n, 32), dtype=torch.bfloat16, device=META)
            return Call(fn, (cache, rows), dict(statics or {}), cache)
        return Dispatch(f"n={n}", make)

    return PerfEntry(name, axes=axes, build=build, representatives=[dict(n=axes["n"][-1])],
                     setup=setup, upcast_min_elems=32, footprint=bool(footprint_bytes))


def _args(**kw):
    base = dict(paths=None, fmt="text", select=None, baseline=None, no_baseline=False,
                update_baseline=False, root=None, project=False, proto=False, load=False,
                wire=False, metrics=False, trace=True, shard=False, kern=False, perf=False,
                all=False, manifest=None, replay=None, changed=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _run(monkeypatch, tmp_path, registry, snapshot=None):
    """run_trace over ``registry`` against a manifest snapshotted from
    ``snapshot`` (a clean registry) or empty: (exit code, text)."""
    mpath = tmp_path / "trace_manifest.json"
    if snapshot is not None:
        monkeypatch.setattr(tc, "build_perf_registry", lambda: snapshot)
        assert run_trace(_args(manifest=str(mpath), update_baseline=True), io.StringIO()) == 0
    monkeypatch.setattr(tc, "build_perf_registry", lambda: registry)
    out = io.StringIO()
    return run_trace(_args(manifest=str(mpath)), out), out.getvalue()


def test_clean_registry_exits_0(monkeypatch, tmp_path):
    reg = [_entry("fake.step[a]", _in_place)]
    rc, text = _run(monkeypatch, tmp_path, reg, snapshot=reg)
    assert rc == 0 and text.strip() == "0 trace findings (0 accepted) over 1 entrypoints"


def test_tr001_added_entry(monkeypatch, tmp_path):
    rc, text = _run(monkeypatch, tmp_path, [_entry("fake.step[a]", _in_place),
                                            _entry("fake.step[b]", _in_place)],
                    snapshot=[_entry("fake.step[a]", _in_place)])
    assert rc == 1 and "fake.step[b]: TR001[added]" in text


def test_tr002_matrix_drift(monkeypatch, tmp_path):
    rc, text = _run(monkeypatch, tmp_path, [_entry("fake.step[a]", _in_place, {"n": [4, 8, 16]})],
                    snapshot=[_entry("fake.step[a]", _in_place)])
    assert rc == 1 and "TR002[matrix]" in text and "axes" in text


def test_tr003_identity_keyed_static(monkeypatch, tmp_path):
    """A static keyed by identity (a fresh options object per dispatch):
    no two enumerations agree, so no two dispatches would share a graph."""
    class Options:
        pass

    def step(cache, rows, options=None):
        return _in_place(cache, rows)

    clean = _entry("fake.step[a]", step)

    def build(n):
        d = clean.build(n)

        def make(base=None):
            c = d.make(base)
            return Call(c.fn, c.args, {"options": Options()}, c.cache)
        return Dispatch(d.label, make)

    entry = PerfEntry("fake.step[a]", axes=clean.axes, build=build,
                      representatives=clean.representatives, setup=clean.setup,
                      upcast_min_elems=32)
    rc, text = _run(monkeypatch, tmp_path, [entry], snapshot=[clean])
    assert rc == 1 and "fake.step[a]: TR003[unstable]" in text


def test_tr004_cache_rebuilt(monkeypatch, tmp_path):
    rc, text = _run(monkeypatch, tmp_path, [_entry("fake.step[a]", _rebuilt)],
                    snapshot=[_entry("fake.step[a]", _rebuilt)])
    assert rc == 0  # accepted by the snapshot, as every intrinsic finding is
    rc, text = _run(monkeypatch, tmp_path, [_entry("fake.step[a]", _rebuilt)],
                    snapshot=[_entry("fake.step[a]", _in_place)])
    assert rc == 1 and "TR004[unaliased=1]" in text and "leaf0" in text


def test_tr005_cache_untouched(monkeypatch, tmp_path):
    rc, text = _run(monkeypatch, tmp_path, [_entry("fake.step[a]", _untouched)],
                    snapshot=[_entry("fake.step[a]", _in_place)])
    assert rc == 1 and "TR005[leaf0]" in text


def test_tr006_upcast(monkeypatch, tmp_path):
    rc, text = _run(monkeypatch, tmp_path, [_entry("fake.step[a]", _upcast)],
                    snapshot=[_entry("fake.step[a]", _in_place)])
    assert rc == 1 and "TR006[bfloat16->f32[r2]x1]" in text


def test_tr007_over_the_card(monkeypatch, tmp_path):
    big = _entry("fake.forward[a]", _in_place, footprint_bytes=80 * 10**9)
    rc, text = _run(monkeypatch, tmp_path, [big],
                    snapshot=[_entry("fake.forward[a]", _in_place, footprint_bytes=2 * 10**9)])
    assert rc == 1 and "TR007[total]" in text


def test_json_output_is_stable(monkeypatch, tmp_path):
    reg = [_entry("fake.step[a]", _upcast)]
    monkeypatch.setattr(tc, "build_perf_registry", lambda: reg)
    outs = []
    for _ in range(2):
        out = io.StringIO()
        assert run_trace(_args(manifest=str(tmp_path / "none.json"), fmt="json"), out) == 1
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    doc = json.loads(outs[0])
    assert doc["entrypoints"] == ["fake.step[a]"] and doc["accepted"] == 0
    assert {f["rule"] for f in doc["findings"]} == {"TR001", "TR006"}
