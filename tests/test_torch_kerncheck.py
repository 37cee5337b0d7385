"""The port's kernel plane (dtkern, ``lint --kern``) and its kernel registry.

The JAX plane's tests (``tests/test_kerncheck.py``) where they have a
counterpart on the H100: the tier-1 gate (zero non-accepted findings against
the port's committed kern manifest), the KN001-KN006 rules on the committed
``lint_fixtures/kern_torch/`` fixture pair, the adversarial canary matrix
(every run case ran clean), the two-kernel-split pin, manifest coverage,
replay tokens and the manifest / CLI contract.  Then what only the port
has: the plain versions held to JAX's Pallas kernels in interpret mode at
JAX's own audit geometries with the same NaN poison, the registry's
``work_cost`` reproducing every bound PERF.md §6 prints (the H100 runs'
readings), the plan walks catching the defects KN002 and KN003 name, and
the census matching ``ops/kernels.wrappers()``.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import dynamo_tpu_torch
from dynamo_tpu_torch.analysis import kerncheck as kc
from dynamo_tpu_torch.analysis.kerncheck import (
    DEFAULT_KERN_MANIFEST_PATH,
    KernManifest,
    canary_failed,
    check_kern_facts,
    collect_kern_facts,
    decode_token,
    encode_token,
    run_kern,
    walk_facts,
)
from dynamo_tpu_torch.obs import topology
from dynamo_tpu_torch.ops.kernels import registry, wrappers

PKG = Path(dynamo_tpu_torch.__file__).resolve().parent
FIXTURES = Path(__file__).parent / "lint_fixtures" / "kern_torch"


def _load_facts(name):
    return json.loads((FIXTURES / name).read_text())


# ------------------------------------------------------------- the gate ----


@pytest.fixture(scope="module")
def real_facts():
    return collect_kern_facts()


def test_kern_gate_zero_nonaccepted_findings(real_facts):
    """THE kernel-plane gate: budgets, walks, canaries, costs and the census
    are clean against the committed kern manifest.  Fix the regression, or
    re-snapshot with ``lint --kern --update-baseline`` and justify."""
    manifest = KernManifest.load(DEFAULT_KERN_MANIFEST_PATH)
    assert manifest.entrypoints, "kern manifest missing or empty"
    fresh = manifest.filter(check_kern_facts(real_facts, manifest))
    assert not fresh, "non-accepted kernel-plane findings:\n  " + "\n  ".join(f.render() for f in fresh)


def test_manifest_accepted_entries_justified_and_live(real_facts):
    from manifest_hygiene import assert_manifest_hygiene

    manifest = KernManifest.load(DEFAULT_KERN_MANIFEST_PATH)
    assert_manifest_hygiene(manifest, check_kern_facts(real_facts, manifest))


def test_manifest_header_records_budget_and_caveat():
    """The header pins the H100 limits KN001 holds plans to and the
    topology's constants version, and no VMEM figure; the note records that
    the CPU runs the plain versions and the card the kernels."""
    h = json.loads(DEFAULT_KERN_MANIFEST_PATH.read_text())["header"]
    assert h["card"]["sms"] == registry.H100_SMS
    assert {k: h["card"][k] for k in registry.LIMITS} == registry.LIMITS
    assert h["constants_version"] == topology.CONSTANTS_VERSION
    assert h["constants_version"].startswith("h100-")
    assert "vmem" not in json.dumps(h).lower()
    assert "PLAIN" in h["note"] and "kern phase" in h["note"] and "2604.15464" in h["note"]


def test_manifest_covers_every_registry_geometry(real_facts):
    """Every (kernel, geometry) case of the matrix has a fact and a
    committed entry, and every registered kernel has a run case."""
    manifest = KernManifest.load(DEFAULT_KERN_MANIFEST_PATH)
    names = {f"cuda.{c['kernel']}[{c['name']}]" for c in registry.audit_cases()}
    assert names <= set(real_facts)
    assert names | {kc.CENSUS} == set(manifest.entrypoints)
    run = {c["kernel"] for c in registry.audit_cases() if c["mode"] == "run"}
    assert run == {k for k, m in registry.KERNELS.items() if not m["placeholder"]}


def test_full_adversarial_matrix_canaries_ran_and_clean(real_facts):
    """KN004 ran on every run case (decode bf16 / int8 / multi-query / the
    verify's S = 5 and 8, prefill bf16 / int8, ragged bf16 / int8, the
    W8A16 product, the grouped launches at T = 8 and 1,504, and the nine
    float16 twins of ``registry.FP16_TWINS``), clean, with its padding and
    zero-length lanes exactly 0; spec cases skip it."""
    ran = []
    for name, f in real_facts.items():
        if name == kc.CENSUS:
            continue
        if f["mode"] == "run":
            assert f["canary"]["ran"] and not canary_failed(f["canary"]), name
            ran.append(name)
        else:
            assert f["mode"] == "spec" and not f["canary"]["ran"], name
    assert len(ran) == 16 + len(registry.FP16_TWINS), ran
    zeros = sum(real_facts[n]["canary"]["zero_lanes"] for n in ran)
    assert zeros > 0


def test_two_kernel_split_pin_retrips_if_unaccepted(real_facts):
    """Stripping the accepted two-kernel-split entry re-trips KN006: the
    premise that decode and ragged prefill are two kernels cannot rot."""
    manifest = KernManifest.load(DEFAULT_KERN_MANIFEST_PATH)
    pins = [e for e in manifest.accepted
            if e["entrypoint"] == kc.CENSUS and e["rule"] == "KN006" and e["key"] == "two-kernel-split"]
    assert pins and "2604.15464" in pins[0]["justification"]
    stripped = KernManifest(manifest.entrypoints, [e for e in manifest.accepted if e not in pins],
                            manifest.header)
    fresh = stripped.filter(check_kern_facts(real_facts, stripped))
    assert any(f.rule == "KN006" and f.key == "two-kernel-split" for f in fresh)


# ---------------------------------------------- the rules (fixture pair) ----


def test_fixture_baseline_is_clean():
    base = _load_facts("baseline_facts.json")
    assert check_kern_facts(base, KernManifest(entrypoints=base)) == []


def test_fixture_regression_fires_every_rule():
    """The regressed fixture (shared memory past a block's limit, a table
    slot past the row's table, two rows writing one token, a NaN canary in
    live lanes, plan / work / plan cost drift, an added and a removed
    geometry, a placeholder unified kernel, an unprobed kernel and an
    unregistered wrapper) fails every KN rule."""
    base = _load_facts("baseline_facts.json")
    findings = check_kern_facts(_load_facts("regressed_facts.json"), KernManifest(entrypoints=base))
    by_rule: dict[str, set] = {}
    for f in findings:
        by_rule.setdefault(f.rule, set()).add((f.entrypoint, f.key))
    fix = "cuda.fix_decode[fix]"
    assert by_rule == {
        "KN001": {(fix, "budget")},
        "KN002": {(fix, "block_tables")},
        "KN003": {(fix, "tokens")},
        "KN004": {(fix, "padding-leak")},
        "KN005": {(fix, "plan"), (fix, "plan_cost"), (fix, "work"),
                  ("cuda.fix_decode[new]", "added"), ("cuda.fix_decode[old]", "removed")},
        "KN006": {(kc.CENSUS, "two-kernel-split"), (kc.CENSUS, "probed:fix_decode"),
                  (kc.CENSUS, "unregistered:stray_kernel")},
    }


def test_fuzz_entries_never_drift():
    base = _load_facts("baseline_facts.json")
    grown = dict(base)
    grown["cuda.fix_decode[fuzz[ragged-7]]"] = json.loads(json.dumps(base["cuda.fix_decode[fix]"]))
    assert check_kern_facts(grown, KernManifest(entrypoints=base)) == []


# ----------------------------------------------- the manifest and the CLI ----


def _args(**kw):
    base = dict(paths=None, fmt="text", select=None, baseline=None, no_baseline=False,
                update_baseline=False, root=None, project=False, proto=False, load=False, wire=False,
                metrics=False, trace=False, shard=False, perf=False, kern=True, all=False,
                manifest=None, replay=None, changed=False)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture()
def fixture_facts(monkeypatch):
    """run_kern on the fixture facts (no real collection), pinned env."""
    monkeypatch.delenv("DTKERN_BUDGET", raising=False)
    monkeypatch.delenv("DTKERN_SEED_BASE", raising=False)
    base = _load_facts("baseline_facts.json")
    monkeypatch.setattr(kc, "collect_kern_facts", lambda budget=1, seed_base=0: base)
    return base


def test_update_roundtrip_carries_justifications(tmp_path, fixture_facts, monkeypatch):
    """finding -> exit 1 -> --update-baseline accepts the intrinsic findings
    (TODO) -> justify -> a second update carries the justification by key;
    the header pins the H100's limits."""
    mpath = tmp_path / "manifest.json"
    assert run_kern(_args(manifest=str(mpath)), out=io.StringIO()) == 1
    assert run_kern(_args(manifest=str(mpath), update_baseline=True), out=io.StringIO()) == 0
    doc = json.loads(mpath.read_text())
    assert doc["header"]["card"]["smem_per_block"] == registry.LIMITS["smem_per_block"]
    assert set(doc["entrypoints"]) == set(fixture_facts) and doc["accepted"] == []
    assert run_kern(_args(manifest=str(mpath)), out=io.StringIO()) == 0

    bad = _load_facts("regressed_facts.json")
    monkeypatch.setattr(kc, "collect_kern_facts", lambda budget=1, seed_base=0: bad)
    assert run_kern(_args(manifest=str(mpath), update_baseline=True), out=io.StringIO()) == 0
    doc = json.loads(mpath.read_text())
    assert doc["accepted"] and all(e["justification"] == "TODO: justify" for e in doc["accepted"])
    assert {e["rule"] for e in doc["accepted"]} == {"KN001", "KN002", "KN003", "KN004", "KN006"}
    doc["accepted"][0]["justification"] = "kept: fixture rig"
    mpath.write_text(json.dumps(doc))
    assert run_kern(_args(manifest=str(mpath), update_baseline=True), out=io.StringIO()) == 0
    assert "kept: fixture rig" in [e["justification"]
                                   for e in json.loads(mpath.read_text())["accepted"]]


def test_update_refused_on_fuzz_run(tmp_path, fixture_facts, monkeypatch):
    monkeypatch.setenv("DTKERN_BUDGET", "4")
    assert run_kern(_args(manifest=str(tmp_path / "m.json"), update_baseline=True),
                    out=io.StringIO()) == 2


def test_json_output_stable_sorted(tmp_path, fixture_facts):
    outs = []
    for _ in range(2):
        out = io.StringIO()
        assert run_kern(_args(manifest=str(tmp_path / "m.json"), fmt="json"), out=out) == 1
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    doc = json.loads(outs[0])
    keys = [(f["entrypoint"], f["rule"], f["key"]) for f in doc["findings"]]
    assert keys == sorted(keys)
    assert doc["total"] == len(doc["findings"]) + doc["accepted"]
    assert doc["fuzz"] == {"budget": 1, "seed_base": 0, "replay_tokens": {}}


def test_committed_manifest_is_save_stable(tmp_path):
    m = KernManifest.load(DEFAULT_KERN_MANIFEST_PATH)
    m.save(tmp_path / "again.json")
    assert (tmp_path / "again.json").read_text() == DEFAULT_KERN_MANIFEST_PATH.read_text()


def test_replay_token_roundtrip_and_prefix_guard(fixture_facts):
    tok = encode_token({"seed": 7})
    assert tok.startswith("dtk1.") and decode_token(tok) == {"seed": 7}
    out = io.StringIO()
    assert run_kern(_args(replay="dtl1.notkern"), out=out) == 2
    assert "not a dtkern replay token" in out.getvalue()
    out = io.StringIO()
    assert run_kern(_args(replay=tok, fmt="json"), out=out) == 0
    doc = json.loads(out.getvalue())
    assert doc["geometry"] == "fuzz[ragged-7]" and not doc["failed"]


def test_changed_skips_when_no_kernel_input_touched(tmp_path, fixture_facts, monkeypatch):
    from dynamo_tpu_torch.analysis import cli

    calls = []
    monkeypatch.setattr(kc, "collect_kern_facts",
                        lambda budget=1, seed_base=0: calls.append(1) or fixture_facts)
    monkeypatch.setattr(cli, "_git_changed_paths", lambda root, suffixes=(): [Path("README.md")])
    out = io.StringIO()
    assert run_kern(_args(manifest=str(tmp_path / "m.json"), changed=True), out=out) == 0
    assert not calls and "unaffected" in out.getvalue()
    monkeypatch.setattr(cli, "_git_changed_paths",
                        lambda root, suffixes=(): [Path(PKG.name, "ops", "kernels", "registry.py")])
    assert run_kern(_args(manifest=str(tmp_path / "m.json"), changed=True), out=io.StringIO()) == 1
    assert calls


def test_cli_routes_kern_flag(tmp_path, fixture_facts):
    from dynamo_tpu_torch.analysis.cli import run_lint

    out = io.StringIO()
    assert run_lint(_args(manifest=str(tmp_path / "m.json")), out=out) == 1
    assert "KN005" in out.getvalue()


# ------------------------------------------------ parity with JAX's kernels ----

_JAX_INTERPRET = ("decode-bf16", "decode-int8", "decode-mq-unaligned", "prefill-bf16", "ragged-bf16",
                  "ragged-int8", "int8-matmul")


def _port_inputs(jinp: dict, pcase: dict, d: int):
    """JAX's case inputs as the port's wrapper takes them; the port case at
    JAX's head dim."""
    from dynamo_tpu_torch.ops.kv_quant import QuantKvCache

    def t(x):
        return torch.as_tensor(np.array(x))

    if pcase["kernel"] == "int8_matmul":
        return pcase, {"x": t(np.asarray(jinp["x"], np.float32)).to(torch.bfloat16), "wq": t(jinp["wq"]),
                       "scale": t(jinp["scale"])}
    case = dict(pcase, geometry=dict(pcase["geometry"], d=d))
    cache = jinp["cache"]
    cache = QuantKvCache(t(cache.data), t(cache.scale)) if hasattr(cache, "scale") else t(cache)
    inp = {"q": t(jinp["q"]), "cache": cache, "block_tables": t(jinp["bt"]),
           "layer": int(jinp["layer"]), "seq_lens": t(jinp["lens"])}
    if pcase["kernel"].startswith("paged_decode"):
        inp["q0_pos"] = t(jinp["q0"])
    else:
        inp.update(k_new=t(jinp["k"]), v_new=t(jinp["v"]))
        if pcase["kernel"].startswith("paged_prefill"):
            inp["start"] = t(jinp["starts"])
        else:
            inp.update(starts=t(jinp["starts"]), row_offsets=t(jinp["roffs"]))
    return case, inp


@pytest.mark.parametrize("name", _JAX_INTERPRET)
def test_plain_versions_hold_jax_kernels_in_interpret_mode(name):
    """At JAX's audit geometry (its D = 16 and its seeds), poisoned alike
    (JAX poisons its inputs, the port's ``registry.poison`` the same lanes),
    the port's plain version holds JAX's Pallas kernel in interpret mode:
    live lanes within 2e-4 (the W8A16 product, whose outputs both round to
    bf16, within one bf16 step), no NaN in a live lane, and the port's
    padding and zero-length lanes exactly 0."""
    from dynamo_tpu.ops.pallas import registry as jreg

    jcase = next(c for c in jreg.audit_cases() if c["name"] == name)
    pcase = next(c for c in registry.audit_cases() if c["name"] == name)
    assert jcase["mode"] == "interpret" and pcase["mode"] == "run"
    jinp = jcase["build"]()
    jout = np.asarray(jcase["run"](jinp, poisoned=True), np.float32)
    case, inp = _port_inputs(jinp, pcase, jreg._D)
    pout = registry.run(case, registry.poison(case, inp)).float().numpy()
    live, zero = registry.lanes(case, pout.shape)
    assert pout.shape == jout.shape
    assert np.isfinite(pout[live]).all()
    diff = np.abs(pout - jout)[live]
    if name == "int8-matmul":
        assert (diff <= 2.0 ** -7 * np.abs(jout[live])).all(), diff.max()
    else:
        assert diff.max() <= 2e-4, diff.max()
    assert (pout[zero] == 0).all()


def test_registry_row_geometry_is_jax_but_the_head_dim():
    """The run cases keep JAX's row sets, lengths and seeds; only D moves
    to 64, the least head dim the CUDA kernels take."""
    from dynamo_tpu.ops.pallas import registry as jreg

    assert registry.RAGGED_ROWS == jreg._RAGGED_ROWS
    assert (registry._L, registry._BS, registry._HK, registry._H, registry._M) == (
        jreg._L, jreg._BS, jreg._HK, jreg._H, jreg._M)
    assert registry._D == 64 and jreg._D == 16
    names = [c["name"] for c in registry.audit_cases()]
    assert [c["name"] for c in jreg.audit_cases()] == [n for n in names if n in {
        c["name"] for c in jreg.audit_cases()}]


# -------------------------------------------- the bounds PERF.md prints ----

# each serving shape's bound as the H100 runs computed it from the hand
# counts chip_smoke.py carried before the registry (the kernels line of an
# NVIDIA H100 80GB HBM3 run at 700 W): bound_ms, bound_by, PERF.md's
# printed four decimals
PERF_MD_BOUNDS = {
    "decode-serving": (0.0047660513432835816, "bytes", "0.0048"),
    "decode-serving-s5": (0.004922555223880597, "bytes", "0.0049"),
    "decode-serving-s8": (0.005039933134328358, "bytes", "0.0050"),
    "prefill-serving": (0.01864943174924166, "operations", "0.0186"),
    "ragged-serving": (0.010472904606673408, "operations", "0.0105"),
    "decode-int8-serving": (0.002476437014925373, "bytes", "0.0025"),
    "decode-int8-serving-s5": (0.0026329408955223883, "bytes", "0.0026"),
    "decode-int8-serving-s8": (0.0027503188059701494, "bytes", "0.0028"),
    "prefill-int8-serving": (0.007033192315470172, "operations", "0.0070"),
    "ragged-int8-serving": (0.011024493751263902, "operations", "0.0110"),
    "matmul-serving-m8": (0.06554822686567163, "bytes", "0.0655"),
    "matmul-serving-m1504": (None, "operations", "0.6634"),
    "matmul-serving-m40": (0.0671132656716418, "bytes", "0.0671"),
    "moe-serving-t8": (0.1580787008955224, "bytes", "0.1581"),
    "moe-serving-t1504": (0.42126932059701494, "bytes", "0.4213"),
    "moe-v2lite-serving-t8": (0.15523595462686565, "bytes", "0.1552"),
    "moe-v2lite-serving-t1504": (0.38639340895522384, "bytes", "0.3864"),
    "moe-int8-serving-t8": (0.07661476298507462, "bytes", "0.0766"),
    "moe-int8-serving-t1504": (0.2415246137313433, "bytes", "0.2415"),
}


@pytest.mark.parametrize("name", sorted(PERF_MD_BOUNDS))
def test_work_cost_reproduces_perf_md_bounds(name):
    """The registry's work cost at each serving shape gives the bound
    PERF.md §6 prints, to its four decimals and to the run's own float
    (the hand counts agreed with the registry)."""
    case = next(c for c in registry.audit_cases() if c["name"] == name)
    got = registry.bound(registry.work_cost(case["kernel"], case["geometry"]))
    exact, by, printed = PERF_MD_BOUNDS[name]
    assert f"{got['bound_ms']:.4f}" == printed and got["bound_by"] == by
    if exact is not None:
        assert got["bound_ms"] == pytest.approx(exact, rel=1e-12)


def test_costs_are_jax_shaped_and_plans_compute_more():
    """Both cost functions return JAX's ``_cost_dict`` keys; a plan never
    computes fewer operations than the work needs (its tiles compute
    masked keys, never skip live ones), and where it re-streams (B2's query
    tiles over the prefix, B5's x tiles over N) it moves more bytes."""
    for case in registry.audit_cases():
        work = registry.work_cost(case["kernel"], case["geometry"])
        plan = registry.plan_cost(case["kernel"], case["geometry"])
        for cost in (work, plan):
            assert set(cost) == {"hbm_bytes", "flops", "transcendentals", "intensity"}
            assert cost["intensity"] == round(cost["flops"] / cost["hbm_bytes"], 4)
        assert plan["flops"] >= work["flops"], case["name"]
    for name in ("prefill-int8-serving", "matmul-serving-m8"):
        case = next(c for c in registry.audit_cases() if c["name"] == name)
        assert (registry.plan_cost(case["kernel"], case["geometry"])["hbm_bytes"]
                > registry.work_cost(case["kernel"], case["geometry"])["hbm_bytes"])


# --------------------------------------------------------- walks, census ----


def _defect(kind: str):
    """(kernel, geometry, plan) whose walk must find a defect."""
    from dynamo_tpu_torch.ops.kernels import decode_attention as dec
    from dynamo_tpu_torch.ops.kernels import int8_matmul as mm

    if kind == "table":  # a row longer than its table
        g = dict(b=1, s=1, h=4, hk=2, d=64, m=2, bs=8, lens=[40])
        return "paged_decode_attention", g, dec.plan(1, 1, 4, 2, 64, 2, 8, registry.H100_SMS, False)
    if kind == "tile":  # one N tile short of covering N
        g = dict(m=8, k=256, n=1024)
        p = mm.plan(8, 1024, 256, registry.H100_SMS)
        return "int8_matmul", g, dataclasses.replace(p, grid=(p.grid[0] - 1, *p.grid[1:]))
    if kind == "grid":  # past the 65,535 blocks of grid y
        g = dict(b=1, s=1, h=4, hk=2, d=64, m=1, bs=8, lens=[8])
        p = dec.plan(1, 1, 4, 2, 64, 1, 8, registry.H100_SMS, False)
        return "paged_decode_attention", g, dataclasses.replace(p, grid=(1, 70000, 1))
    # two rows' spans over one token
    from dynamo_tpu_torch.ops.kernels import ragged_prefill_attention as rag

    g = dict(t=16, h=4, hk=2, d=64, m=4, bs=8, starts=[0, 0], lens=[10, 10], offs=[0, 4])
    return "ragged_paged_prefill_attention", g, rag.plan(16, 2, 4, 2, 64)


@pytest.mark.parametrize("kind,rule", [("table", "oob"), ("tile", "oob"), ("grid", "oob"),
                                       ("overlap", "races")])
def test_walk_catches_defect(kind, rule):
    kernel, g, plan = _defect(kind)
    facts = walk_facts(kernel, g, [plan])
    assert facts[rule], facts


def test_walk_declares_the_split_k_reductions():
    """Decode's split-K combine and B5's split-K tickets are declared
    reductions, not races, wherever the plans split."""
    dec = next(c for c in registry.audit_cases() if c["name"] == "decode-serving")
    mm = next(c for c in registry.audit_cases() if c["name"] == "matmul-serving-m8")
    for case, red in ((dec, "split-K combine (tickets)"), (mm, "split-K tickets")):
        calls = case["geometry"].get("calls", [case["geometry"]])
        walk = walk_facts(case["kernel"], case["geometry"],
                          [registry.plan_of(case["kernel"], g) for g in calls])
        assert walk["reductions"] == [red] and not walk["races"] and not walk["oob"]


def test_census_is_the_wrappers():
    """Every wrapper of ``ops/kernels.wrappers()`` is registered under its
    function name with its plain version and counter; the JAX registry's
    placeholder stays one."""
    names = {fn.__name__ for fn in wrappers().values()}
    real = {k for k, m in registry.KERNELS.items() if not m["placeholder"]}
    assert names == real
    for name in real:
        assert registry.wrapper_fn(name).__name__ == name
        assert callable(registry.plain_fn(name))
        assert isinstance(registry.wrapper_fn(name).launches, int)
    assert registry.KERNELS["unified_ragged_attention"]["module"] is None


def test_poison_reaches_only_dead_lanes():
    """The poisoned decode cache keeps every slot a row's context holds and
    NaNs the rest, unreferenced blocks whole."""
    case = next(c for c in registry.audit_cases() if c["name"] == "decode-bf16")
    inp = registry.build(case)
    cache = registry.poison(case, inp)["cache"]
    g = case["geometry"]
    bt = inp["block_tables"]
    held = 0
    for r, n in enumerate(g["lens"]):
        for ti in range(g["m"]):
            keep = max(0, min(g["bs"], n - ti * g["bs"]))
            blk = int(bt[r, ti])
            assert torch.equal(cache[:, blk, :, :keep], inp["cache"][:, blk, :, :keep])
            assert torch.isnan(cache[:, blk, :, keep:]).all()
            held += keep
    assert torch.isnan(cache[:, 0]).all()  # block 0 is no row's
    assert held == sum(g["lens"])


# ---------------------------------------------------- the float16 bodies ----


def test_fp16_twins_take_their_bf16_plan_and_cost(real_facts):
    """Each float16 run case is its bf16 twin's geometry and seed in
    float16: the same launch plan, work cost and plan cost (both types are
    2 bytes and the tensor cores' rates are the same), canaried at its own
    tolerance in float16 on the CPU."""
    cases = {c["name"]: c for c in registry.audit_cases()}
    twins = [c for c in cases.values() if c.get("dtype") == "float16"]
    assert sorted(registry.fp16_twin(cases[n], 0)["name"] for n in registry.FP16_TWINS) == \
        sorted(c["name"] for c in twins)
    for name in registry.FP16_TWINS:
        bf, hf = cases[name], registry.fp16_twin(cases[name], 0)
        fb = real_facts[f"cuda.{bf['kernel']}[{bf['name']}]"]
        fh = real_facts[f"cuda.{hf['kernel']}[{hf['name']}]"]
        for key in ("plan", "work", "plan_cost", "walk"):
            assert fh[key] == fb[key], (name, key)
        assert fh["canary"]["ran"] and fh["canary"]["atol"] in registry.FP16_ATOL.values()
    inp = registry.build(next(c for c in twins if c["kernel"] == "paged_prefill_attention"))
    assert {inp[k].dtype for k in ("q", "k_new", "v_new", "cache")} == {torch.float16}
    inp = registry.build(next(c for c in twins if c["kernel"] == "int8_matmul"))
    assert inp["x"].dtype == torch.float16


def test_fp16_census_needs_counter_and_run_case(real_facts):
    """Every kernel with a float16 body has its ``launches_fp16`` counter
    and a float16 run case; the grouped kernels have none, so a dense
    model's route takes bf16 and fp16 and a mixture of experts' bf16 only
    (``route_dtypes``, which the engine's refusal reads).  Dropping either
    from the census re-trips KN006."""
    census = real_facts[kc.CENSUS]
    assert registry.route_dtypes() == ("bfloat16", "float16")
    assert registry.route_dtypes(moe=True) == ("bfloat16",)
    for name, meta in registry.KERNELS.items():
        if meta["placeholder"]:
            continue
        facts = census["kernels"][name]
        if name.startswith("grouped"):
            assert facts["dtypes"] == ["bfloat16"] and "counter_fp16" not in facts
            continue
        assert facts["dtypes"] == ["bfloat16", "float16"]
        assert facts["counter_fp16"] and facts["probed_fp16"], name
        assert isinstance(registry.wrapper_fn(name).launches_fp16, int)
    for part in ("counter_fp16", "probed_fp16"):
        broken = json.loads(json.dumps(census))
        broken["kernels"]["int8_matmul"][part] = False
        keys = {f.key for f in kc._check_census(broken)}
        assert f"{part}:int8_matmul" in keys
