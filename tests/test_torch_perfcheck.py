"""The port's perf plane (dtperf, ``lint --perf``): the H100 roofline of every
step function.

The JAX plane's tests (``tests/test_perfcheck.py``) where they have a
counterpart: the tier-1 gate against the port's committed perf manifest,
the op walk against hand-computed oracles (matmul, attention, loops,
branches, elementwise, scatters, collectives), the roofline bound
classifier, the PF001-PF004 rules on JAX's own committed
``lint_fixtures/pf_*_facts.json`` pair, the manifest contract (update with
justification carry, stable JSON, the constants re-trip, the count-keyed
PF002) and the ``/metrics`` rows.  Then the parity: at every entry point
the two packages share at the tiny configs, the port's matrix-product
FLOPs equal the dot FLOPs of JAX's ``estimate_callable`` walk (its dots
without batch dimensions: the projections and the lm_head; the attention
products are kernel rows here and XLA fallbacks there), and the walk's
kernel rows are the registry's work cost.
"""

from __future__ import annotations

import argparse
import io
import json
from pathlib import Path

import pytest
import torch

from dynamo_tpu_torch.analysis import perfcheck as pc
from dynamo_tpu_torch.analysis.perfcheck import (
    DEFAULT_PERF_MANIFEST_PATH,
    LATENCY_REL_TOL,
    TRANSCENDENTAL_WEIGHT,
    PerfEntry,
    PerfManifest,
    RecordingMesh,
    build_perf_registry,
    check_perf_facts,
    collect_perf_facts,
    estimate_callable,
    manifest_predictions,
    run_perf,
)
from dynamo_tpu_torch.obs import topology
from dynamo_tpu_torch.obs.metric_names import PerfMetric as PM
from dynamo_tpu_torch.ops.kernels import registry

FIXTURES = Path(__file__).parent / "lint_fixtures"
META = "meta"


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=META)


def _est(fn, *args):
    return estimate_callable(fn, *args)


def _header(**kw):
    return {"constants_version": topology.CONSTANTS_VERSION, **kw}


def _load_facts(name):
    return json.loads((FIXTURES / name).read_text())


# ------------------------------------------------------------- the gate ----


@pytest.fixture(scope="module")
def real_facts():
    return collect_perf_facts()


def test_perf_gate_zero_nonaccepted_findings(real_facts):
    """THE perf-plane gate: every registered entry point is clean against
    the committed perf manifest.  Fix the hot-path regression, or
    re-snapshot with ``lint --perf --update-baseline`` and justify."""
    manifest = PerfManifest.load(DEFAULT_PERF_MANIFEST_PATH)
    assert manifest.entrypoints, "perf manifest missing or empty"
    fresh = manifest.filter(check_perf_facts(real_facts, manifest))
    assert not fresh, "non-accepted perf-plane findings:\n  " + "\n  ".join(f.render() for f in fresh)


def test_manifest_accepted_entries_justified_and_live(real_facts):
    from manifest_hygiene import assert_manifest_hygiene

    manifest = PerfManifest.load(DEFAULT_PERF_MANIFEST_PATH)
    assert_manifest_hygiene(manifest, check_perf_facts(real_facts, manifest))


def test_manifest_header_pins_constants_and_caveats():
    h = json.loads(DEFAULT_PERF_MANIFEST_PATH.read_text())["header"]
    assert h["constants_version"] == topology.CONSTANTS_VERSION
    assert h["constants_version"].startswith("h100-")
    assert h["topology"] == topology.DEFAULT_TOPOLOGY and h["collective_link"] == "nvlink"
    assert h["tolerances"] == {"latency_rel": 0.05, "intensity_rel": 0.10, "bytes_rel": 0.05}
    assert "CPU-derived" in h["note"] and "predicted-vs-measured" in h["note"]
    assert "fusion assumption" in h["note"]


def test_registry_covers_engine_impls_and_perf_extras(real_facts):
    """JAX's 19 entries under the port's names (Llama-3-8B in place of
    llama3b-v5e): every step function of ``STEP_FNS`` but the SP prefill,
    the draft proposer, the forwards, the ops, ring attention's census over
    four ranks, and a compute-bound MLP row."""
    from dynamo_tpu.analysis import perfcheck as jpc

    jax_names = set(json.loads(jpc.DEFAULT_MANIFEST_PATH.read_text())["entrypoints"])
    assert set(real_facts) == {n.replace("llama3b-v5e", "llama3-8b-h100") for n in jax_names}
    ring = real_facts["ops.ring_attention[sp4]"]["signatures"]["s=128"]
    (ckey, c), = ring["collectives"].items()
    assert ckey == "ppermute:sp" and c["axis_size"] == 4 and c["count"] == 9 and c["cost_us"] > 0
    assert ring["matmul_flops"] == 0 and ring["flops"] > 0  # its products are batched
    mlp = real_facts["roofline.mlp_reference[llama3-8b-h100]"]["signatures"]["t=8192"]
    assert mlp["predicted"]["bound"] == "compute"
    fwd = real_facts["models.llama.forward[llama3-8b-h100]"]["signatures"]
    assert fwd["decode"]["kernels"]["paged_decode_attention"]["calls"] == 32
    assert fwd["prefill"]["kernels"]["paged_prefill_attention"]["calls"] == 32


def test_every_priced_signature_is_sane(real_facts):
    for name, f in real_facts.items():
        for label, est in f["signatures"].items():
            where = f"{name}:{label}"
            assert est["bytes"] > 0 and est["flops"] >= 0, where
            assert est["flops"] == sum(est["flops_by_dtype"].values()), where
            p = est["predicted"]
            assert 0 < p["total_ms"] < 1e5, where
            assert p["bound"] == ("compute" if p["compute_ms"] >= p["memory_ms"] else "bandwidth"), where


# ---------------------------------------------------------- the op walk ----


def test_matmul_flops_and_bytes_exact():
    """f32 [4, 8] @ [8, 16]: 2·64·8 = 1,024 FLOPs, (32 + 128 + 64)·4 = 896 B."""
    est = _est(lambda: _t(4, 8) @ _t(8, 16))
    assert est["flops"] == 1024 and est["matmul_flops"] == 1024
    assert est["flops_by_dtype"] == {"float32": 1024}
    assert est["bytes"] == 896 + 4 * (32 + 128)  # the two zeros() factories write their outputs
    assert _est(lambda a, b: a @ b, _t(4, 8), _t(8, 16))["bytes"] == 896


def test_matmul_dtype_awareness():
    f32 = _est(lambda a, b: a @ b, _t(64, 64), _t(64, 64))
    bf16 = _est(lambda a, b: a @ b, _t(64, 64, dtype=torch.bfloat16), _t(64, 64, dtype=torch.bfloat16))
    assert list(bf16["flops_by_dtype"]) == ["bfloat16"]
    assert bf16["flops"] == f32["flops"] == 2 * 64 ** 3
    assert bf16["bytes"] == f32["bytes"] // 2
    int8 = _est(lambda a, b: torch._int_mm(a, b), _t(32, 64, dtype=torch.int8), _t(64, 32, dtype=torch.int8))
    assert int8["flops_by_dtype"] == {"int8": 2 * 32 * 32 * 64}
    topo = topology.TOPOLOGIES[topology.DEFAULT_TOPOLOGY]["peak_flops"]
    assert topo["int8"] > topo["bfloat16"] > topo["float32"]


def test_attention_flops_floor():
    s, d = 16, 8

    def attn(q, k, v):
        return torch.softmax(q @ k.T / d ** 0.5, dim=-1) @ v

    est = _est(attn, _t(s, d), _t(s, d), _t(s, d))
    floor = 2 * s * s * d * 2
    assert floor <= est["flops"] <= floor + 4 * TRANSCENDENTAL_WEIGHT * s * s


def test_loop_multiplies_by_trip_count():
    """Eager code runs every iteration: four products cost four times one
    (JAX's ``scan`` multiplies by its length)."""
    def loop(c, n):
        for _ in range(n):
            c = c @ c
        return c

    one, four = _est(loop, _t(8, 8), 1), _est(loop, _t(8, 8), 4)
    assert four["flops"] == 4 * one["flops"]


def test_python_branch_prices_the_branch_taken():
    """A branch on a shape runs one side, and only that side is priced
    (JAX's ``cond`` takes the dearer branch, since it cannot know)."""
    def f(x):
        return (x @ x).sum() if x.shape[0] > 8 else x.sum()

    big, small = _est(f, _t(16, 16)), _est(f, _t(4, 4))
    assert big["flops"] >= 2 * 16 ** 3 and small["flops"] == 16


def test_free_and_transcendental_primitives():
    assert _est(lambda x: x.reshape(4, 16)[None].transpose(1, 2), _t(8, 8))["flops"] == 0
    add = _est(lambda x, y: x + y, _t(32), _t(32))
    exp = _est(torch.exp, _t(32))
    assert add["flops"] == 32 and exp["flops"] == 32 * TRANSCENDENTAL_WEIGHT
    assert add["bytes"] == 32 * 4  # the fusion assumption: output bytes only


def test_scatter_priced_by_updates_not_operand():
    """An index-add charges its indices and updates, read and written, and
    a FLOP per update: never the pool it writes into."""
    n, k = 1024, 8

    def f(pool, idx, upd):
        return pool.index_add_(0, idx, upd)

    est = _est(f, _t(n), _t(k, dtype=torch.int64), _t(k))
    assert est["flops"] == k
    assert est["bytes"] == 2 * (k * 8 + k * 4)
    put = _est(lambda pool, idx, upd: pool.index_put_((idx,), upd), _t(n), _t(k, dtype=torch.int64), _t(k))
    assert put["bytes"] == 2 * (k * 8 + k * 4) and put["bytes"] < n * 4


def test_recording_mesh_census_and_cost():
    """A collective through the recording mesh is a census entry with the
    axis size and an NVLink ring cost; one rank costs nothing."""
    mesh = RecordingMesh(("dp",), (4,))
    est = _est(lambda x: mesh.all_reduce(x, "dp"), _t(64))
    (ckey, c), = est["collectives"].items()
    assert ckey == "all_reduce:dp" and c["axis_size"] == 4 and c["count"] == 1 and c["cost_us"] > 0
    assert est["predicted"]["collective_ms"] > 0
    assert topology.collective_cost_s("all_reduce", 1, 1 << 20) == 0.0
    assert topology.collective_cost_s("all_reduce", 4, 1 << 24) > topology.collective_cost_s(
        "all_reduce", 4, 1 << 20)


def test_roofline_bound_classification():
    mm = _est(lambda a, b: a @ b, _t(2048, 2048, dtype=torch.bfloat16), _t(2048, 2048, dtype=torch.bfloat16))
    assert mm["predicted"]["bound"] == "compute"
    assert mm["predicted"]["total_ms"] == mm["predicted"]["compute_ms"]
    ew = _est(lambda x, y: x + y, _t(1 << 20), _t(1 << 20))
    assert ew["predicted"]["bound"] == "bandwidth"
    assert ew["predicted"]["total_ms"] == ew["predicted"]["memory_ms"]


# ----------------------------------------- the rules (JAX's fixture pair) ----


def test_fixture_baseline_is_clean():
    base = _load_facts("pf_baseline_facts.json")
    assert check_perf_facts(base, PerfManifest(entrypoints=base, header=_header())) == []


def test_fixture_regression_fires_pf001_pf002_pf003_pf004():
    base, bad = _load_facts("pf_baseline_facts.json"), _load_facts("pf_regressed_facts.json")
    findings = check_perf_facts(bad, PerfManifest(entrypoints=base, header=_header()))
    by_rule: dict[str, list] = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    assert {"PF001", "PF002", "PF003", "PF004"} <= set(by_rule)
    assert (by_rule["PF001"][0].entrypoint, by_rule["PF001"][0].key) == ("fix.decode[tiny]", "k=1")
    assert by_rule["PF002"][0].key == "k=1:psum:dpx2"
    assert by_rule["PF003"][0].entrypoint == "fix.mlp[tiny]"
    assert by_rule["PF004"][0].entrypoint == "fix.decode[tiny]"


def test_small_drift_within_tolerance_is_clean():
    base = _load_facts("pf_baseline_facts.json")
    wob = json.loads(json.dumps(base))
    sig = wob["fix.decode[tiny]"]["signatures"]["k=1"]
    sig["predicted"]["total_ms"] *= 1 + LATENCY_REL_TOL * 0.5
    sig["bytes"] = int(sig["bytes"] * 1.02)
    assert check_perf_facts(wob, PerfManifest(entrypoints=base, header=_header())) == []


def test_added_and_removed_entrypoints():
    base = _load_facts("pf_baseline_facts.json")
    manifest = PerfManifest(entrypoints=base, header=_header())
    f1 = check_perf_facts({"fix.decode[tiny]": base["fix.decode[tiny]"]}, manifest)
    assert any(f.rule == "PF001" and f.key == "removed" and f.entrypoint == "fix.mlp[tiny]" for f in f1)
    f2 = check_perf_facts(dict(base, **{"fix.new[tiny]": base["fix.decode[tiny]"]}), manifest)
    assert any(f.rule == "PF001" and f.key == "added" and f.entrypoint == "fix.new[tiny]" for f in f2)


def test_constants_version_mismatch_retrips_pf001():
    """JAX's committed TPU constants version against the port's H100 one
    is itself the mismatch; an empty manifest is exempt."""
    from dynamo_tpu.obs import topology as jtopo

    base = _load_facts("pf_baseline_facts.json")
    stale = PerfManifest(entrypoints=base, header=_header(constants_version=jtopo.CONSTANTS_VERSION))
    assert any(f.rule == "PF001" and f.key == "constants" for f in check_perf_facts(base, stale))
    assert not check_perf_facts({}, PerfManifest())


def test_pf002_acceptance_is_count_keyed():
    bad = _load_facts("pf_regressed_facts.json")
    manifest = PerfManifest(entrypoints=bad, header=_header(), accepted=[{
        "entrypoint": "fix.decode[tiny]", "rule": "PF002", "key": "k=1:psum:dpx2",
        "justification": "by design"}])
    assert not manifest.filter(check_perf_facts(bad, manifest))
    mutated = json.loads(json.dumps(bad))
    mutated["fix.decode[tiny]"]["signatures"]["k=1"]["collectives"]["psum:dp"]["count"] = 3
    fresh = manifest.filter(check_perf_facts(mutated, manifest))
    assert any(f.rule == "PF002" and f.key.endswith("x3") for f in fresh)


# ----------------------------------------------- the manifest and the CLI ----


def _args(**kw):
    base = dict(paths=None, fmt="text", select=None, baseline=None, no_baseline=False,
                update_baseline=False, root=None, project=False, proto=False, load=False, wire=False,
                metrics=False, trace=False, shard=False, kern=False, perf=True, all=False,
                manifest=None, replay=None, changed=False)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture()
def fake_registry(monkeypatch):
    """run_perf over one entry point: a product whose result is all-reduced
    over a 2-rank axis through the recording mesh."""
    mesh = RecordingMesh(("dp",), (2,))

    def run():
        mesh.all_reduce(_t(8, 16) @ _t(16, 8), "dp")

    entry = PerfEntry("fake.psum_mm", {"n=8": run})
    monkeypatch.setattr(pc, "build_perf_registry", lambda: [entry])
    return entry


def test_update_roundtrip_carries_justifications(tmp_path, fake_registry):
    mpath = tmp_path / "manifest.json"
    args = _args(manifest=str(mpath))
    assert run_perf(args, out=io.StringIO()) == 1  # PF001 added + PF002
    assert run_perf(_args(manifest=str(mpath), update_baseline=True), out=io.StringIO()) == 0
    doc = json.loads(mpath.read_text())
    assert doc["header"]["constants_version"] == topology.CONSTANTS_VERSION
    assert "fake.psum_mm" in doc["entrypoints"]
    assert [(e["rule"], e["justification"]) for e in doc["accepted"]] == [("PF002", "TODO: justify")]
    doc["accepted"][0]["justification"] = "kept: dp-reduced matmul"
    mpath.write_text(json.dumps(doc))
    assert run_perf(args, out=io.StringIO()) == 0
    assert run_perf(_args(manifest=str(mpath), update_baseline=True), out=io.StringIO()) == 0
    assert [e["justification"] for e in json.loads(mpath.read_text())["accepted"]] == [
        "kept: dp-reduced matmul"]


def test_json_output_stable_sorted(tmp_path, fake_registry):
    outs = []
    for _ in range(2):
        out = io.StringIO()
        assert run_perf(_args(manifest=str(tmp_path / "m.json"), fmt="json"), out=out) == 1
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    doc = json.loads(outs[0])
    keys = [(f["entrypoint"], f["rule"], f["key"]) for f in doc["findings"]]
    assert keys == sorted(keys) and doc["total"] == len(doc["findings"]) + doc["accepted"]


def test_cli_routes_perf_flag(tmp_path, fake_registry):
    from dynamo_tpu_torch.analysis.cli import run_lint

    out = io.StringIO()
    assert run_lint(_args(manifest=str(tmp_path / "m.json")), out=out) == 1
    assert "PF00" in out.getvalue()


def test_manifest_predictions_rows():
    rows = manifest_predictions(DEFAULT_PERF_MANIFEST_PATH)
    by_key = {(r["entrypoint"], r["config"], r["signature"]): r for r in rows}
    assert by_key[("roofline.mlp_reference", "llama3-8b-h100", "t=8192")]["bound"] == "compute"
    assert {("models.llama.forward", "llama3-8b-h100", s) for s in ("decode", "prefill")} <= set(by_key)
    assert all(r["predicted_ms"] > 0 and r["bound"] in ("compute", "bandwidth") for r in rows)


def test_metrics_render_exports_predicted_step_ms():
    """``/metrics`` renders the committed manifest's rows under JAX's name,
    type and labels, without an engine and without pricing anything."""
    from dynamo_tpu_torch.llm.http.metrics import Metrics

    text = Metrics().render()
    assert f"# TYPE {PM.PREDICTED_STEP_MS} gauge" in text
    rows = [line for line in text.splitlines() if line.startswith(PM.PREDICTED_STEP_MS + "{")]
    assert len(rows) == len(manifest_predictions())
    assert any('config="llama3-8b-h100"' in r and 'entrypoint="models.llama.forward"' in r for r in rows)
    assert all('signature="' in r and 'bound="' in r for r in rows)


# ------------------------------------------------------------ parity, card ----


def _jax_plain_dot_flops(ep) -> dict:
    """{signature label: FLOPs of the dot_generals without batch dimensions}
    of a JAX perf entry, walked as JAX's ``_walk`` walks (scan lengths
    multiply, both cond branches' dots count: none differ here)."""
    import jax

    from dynamo_tpu.analysis import perfcheck as jpc

    def walk(jaxpr, mult):
        total = 0.0
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                _, (lb, _) = eqn.params["dimension_numbers"]
                if not lb:
                    total += jpc._dot_flops(eqn)[1] * mult
                continue
            length = eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1
            for sub in jpc._subjaxprs(eqn):
                total += walk(sub, mult * length)
        return total

    fn = ep.raw_fn if ep.raw_fn is not None else ep.jit_fn
    out = {}
    for rep in ep.representatives:
        sig = ep.build(**rep)
        closed = jax.make_jaxpr(lambda *a: fn(*a, **sig.statics))(*sig.args)
        out[sig.label] = int(walk(closed.jaxpr, 1))
    return out


# the entry points both packages price at the tiny configs (JAX's ring
# attention entry needs a jax with AbstractMesh; its products, like the
# port's, are batched einsums: see the ring test above)
_SHARED = sorted(n for n in json.loads(DEFAULT_PERF_MANIFEST_PATH.read_text())["entrypoints"]
                 if "llama3-8b-h100" not in n and "ring_attention" not in n)


@pytest.fixture(scope="module")
def jax_registry():
    from dynamo_tpu.analysis import perfcheck as jpc

    return {ep.name: ep for ep in jpc.build_perf_registry()}


@pytest.mark.parametrize("name", _SHARED)
def test_matmul_flops_equal_jax_dot_flops(name, jax_registry):
    """At every entry point the packages share at the tiny configs (the
    step functions, the tiny forwards, the ops, ring attention), the port's
    FLOPs of unbatched matrix products equal JAX's dot FLOPs without batch
    dimensions, signature by signature."""
    entry = next(e for e in build_perf_registry() if e.name == name)
    port = {label: estimate_callable(thunk)["matmul_flops"] for label, thunk in entry.signatures.items()}
    assert port == _jax_plain_dot_flops(jax_registry[name])


def test_kernel_rows_are_the_registry_work_cost():
    """A kernel call in the walk is a ``kernels`` row priced at its static
    geometry (every row at its full table), in the step's totals; a plain
    version that reads nothing on the host is walked beside it, the ragged
    one (it reads its row table) never."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    b, s, h, hk, d, m, bs = 4, 1, 4, 2, 64, 16, 8
    est = _est(lambda: pa.paged_attention_layer(
        _t(b, s, h, d, dtype=torch.bfloat16), _t(2, 64, 2, bs, hk * d, dtype=torch.bfloat16), 0,
        _t(b, m, dtype=torch.int32), _t(b, dtype=torch.int32), _t(b, s, dtype=torch.int32)))
    want = registry.work_cost("paged_decode_attention", dict(b=b, s=s, h=h, hk=hk, d=d, m=m,
                                                               lens=[m * bs] * b))
    row = est["kernels"]["paged_decode_attention"]
    assert row == {"calls": 1, "flops": want["flops"], "hbm_bytes": want["hbm_bytes"],
                   "transcendentals": want["transcendentals"]}
    assert est["plain"]["paged_decode_attention"]["flops"] > 0
    t = 64
    est = _est(lambda: pa.ragged_prefill_attention(
        _t(1, t, h, d, dtype=torch.bfloat16), _t(1, t, hk, d, dtype=torch.bfloat16),
        _t(1, t, hk, d, dtype=torch.bfloat16), _t(2, 64, 2, bs, hk * d, dtype=torch.bfloat16), 0,
        _t(2, m, dtype=torch.int32), _t(2, dtype=torch.int32), _t(2, dtype=torch.int32),
        _t(2, dtype=torch.int32), _t(1, t, dtype=torch.int32), 2))
    assert est["kernels"]["ragged_paged_prefill_attention"]["calls"] == 1
    assert est["plain"] == {"ragged_paged_prefill_attention": None}


def test_walk_leaves_nothing_patched():
    """After a walk the wrappers are the wrappers again and a meta tensor
    is not on the card."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    before = pa.paged_decode_attention
    _est(lambda: _t(2, 2) @ _t(2, 2))
    assert pa.paged_decode_attention is before
    assert pa.paged_decode_attention is registry.wrapper_fn("paged_decode_attention")
    assert not _t(1).is_cuda
