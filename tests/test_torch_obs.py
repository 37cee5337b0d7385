"""The port's step timeline, roofline, trace export and profile hook against
the JAX package's.

* The timeline alone: the phase sum accounts for the step wall and idle
  steps are not banked (the JAX package's own timeline tests, on the port's
  copy).
* The same requests through the JAX ``EngineCore`` and the port's on the
  default, unified, lookahead and n-gram speculative paths: the same number
  of steps and busy steps, the same phases marked in each busy step, and
  the same dispatch kinds with the same counts (counts, not times).
* Two port engines stepping in two threads each count only their own steps.
* ``chrome_trace`` of the same span records is the JAX package's document.
* The perf model's prediction for a prefill and a decode kind is the bound
  formula worked by hand from the tiny model's shapes.
* A profile window on the CPU writes a Chrome trace under ``steps-NNNNNN/``.
* ``/debug/traces/{id}`` answers one request's Chrome JSON (one trace id,
  ``engine.step`` spans with their phases) and 404 for an unknown id; the
  ``trace`` command prints the same body.
* ``run --trace --profile-dir --profile-steps`` sets what the JAX CLI sets.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dynamo_tpu_torch
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.obs import export as jax_export
from dynamo_tpu.obs import tracing as jax_tracing
from dynamo_tpu.obs.timeline import step_timeline as jax_step_timeline
from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.obs import export, tracing
from dynamo_tpu_torch.obs.perfmodel import PerfModel, model_shapes
from dynamo_tpu_torch.obs.timeline import PHASES, StepTimeline, step_timeline
from dynamo_tpu_torch.obs.topology import TOPOLOGIES
from tests.conftest import make_tiny_hf_checkpoint

REPO = Path(__file__).resolve().parent.parent
PKG = dynamo_tpu_torch.__name__
BASE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64,
            prefill_buckets=[16, 32, 64, 128])
PATHS = {
    "default": dict(decode_steps=4),
    "unified": dict(decode_steps=4, prefill_chunk_tokens=16, prefill_token_budget=64,
                    unified_token_dispatch=True),
    "lookahead": dict(decode_steps=4, prefill_chunk_tokens=16, prefill_token_budget=64,
                      lookahead_dispatch=True),
    "spec": dict(decode_steps=4, spec_tokens=4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model) of the same f32 tiny model."""
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A tiny HF checkpoint of the tiny model's shapes and vocabulary (its
    tokenizer and card serve the front door; its weights load in the CLIs)."""
    d = tmp_path_factory.mktemp("obs") / "tiny"
    make_tiny_hf_checkpoint(d, vocab_size=256, hidden_size=64, intermediate_size=128,
                            num_attention_heads=4, num_key_value_heads=2)
    return d


def _specs():
    """(id, prompt, max_tokens): prompts with repeats, so n-gram lookup
    proposes from the first turn, and one with a random tail."""
    rng = np.random.default_rng(3)
    seg = rng.integers(3, 250, 8).tolist()
    return [("rep", seg * 3 + [7], 14), ("other", rng.integers(3, 250, 5).tolist() * 4, 12),
            ("late", seg * 2 + rng.integers(3, 250, 30).tolist(), 10),
            ("short", seg[:5] * 2, 16)]


def _serve(core, request_cls, proto, specs, head=2, stagger=3, steps=2000):
    """Submit ``head`` requests, step ``stagger`` times, submit the rest,
    then step to idle; returns {id: tokens}."""
    outs = {rid: [] for rid, *_ in specs}
    reqs = [request_cls(request_id=rid, prompt=list(prompt),
                        sampling=proto.SamplingOptions(temperature=0.0),
                        stops=proto.StopConditions(max_tokens=n, ignore_eos=True),
                        emit=outs[rid].append) for rid, prompt, n in specs]
    for r in reqs[:head]:
        core.submit(r)
    for _ in range(stagger):
        core.step()
    for r in reqs[head:]:
        core.submit(r)
    for _ in range(steps):
        if not core.step():
            break
    return {rid: [t for o in v for t in o.token_ids] for rid, v in outs.items()}


def _shape(timeline) -> dict:
    """What two engines' timelines must share on the same requests: step
    counts, the phases of each busy step, and the dispatch kinds' counts."""
    snap = timeline.snapshot()
    busy = snap["busy_steps_total"]
    # reset() keeps the ring of recent steps: this run's are the last ones
    return dict(steps=snap["steps_total"], busy=busy,
                phases=[sorted(r["phases"]) for r in list(timeline.recent)[-busy:]],
                kinds={k: v["count"] for k, v in snap["dispatch_kinds"].items()})


@pytest.fixture(scope="module")
def jax_timelines(tiny):
    """The JAX engine's run of each path and the shape of its (process
    global) timeline, made once in the module's set-up."""
    jmodel, jparams, _ = tiny
    out = {}
    for path, kw in PATHS.items():
        jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**BASE, **kw), eos_token_ids=[])
        try:
            jax_step_timeline.reset()
            streams = _serve(jcore, JaxEngineRequest, jax_protocols, _specs())
            out[path] = (streams, _shape(jax_step_timeline))
        finally:
            jcore.close()
    return out


# ------------------------------------------------------------ the timeline


def test_timeline_phase_sum_accounts_wall():
    tl = StepTimeline()
    t_start = time.perf_counter()
    tl.begin()
    time.sleep(0.002)
    tl.mark("admission")
    time.sleep(0.001)
    tl.mark("host_build")
    time.sleep(0.003)
    tl.mark("dispatch")
    time.sleep(0.002)
    tl.mark("readback")
    time.sleep(0.001)
    tl.end()  # residue -> host_post
    wall_ub = time.perf_counter() - t_start

    snap = tl.snapshot()
    assert snap["steps_total"] == 1 and snap["busy_steps_total"] == 1
    wall = snap["wall_seconds_total"]
    assert 0.009 <= wall <= wall_ub
    assert sum(snap["phases"].values()) >= 0.95 * wall
    assert snap["phases"]["host_post"] > 0  # residue attribution
    gap_ms = (wall - snap["phases"]["dispatch"] - snap["phases"]["readback"]) * 1e3
    assert snap["host_gap_ms_per_turn"] == pytest.approx(gap_ms, rel=1e-6)
    assert set(snap["phases"]) == set(PHASES)


def test_timeline_idle_steps_excluded():
    tl = StepTimeline()
    tl.begin()
    tl.mark("host_ops")
    tl.end()  # no upload/dispatch/readback -> idle poll
    snap = tl.snapshot()
    assert snap["steps_total"] == 1
    assert snap["busy_steps_total"] == 0
    assert snap["wall_seconds_total"] == 0.0
    tl.mark("dispatch")  # a mark outside begin/end is a no-op
    assert tl.snapshot() == snap


# ----------------------------------------------------- engines against JAX


@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_timeline_matches_jax(tiny, jax_timelines, path):
    ref_streams, ref = jax_timelines[path]
    core = EngineCore(tiny[2], EngineConfig(**BASE, **PATHS[path]), eos_token_ids=[],
                      device="cpu")
    before = step_timeline.snapshot()
    streams = _serve(core, EngineRequest, protocols, _specs())
    assert streams == ref_streams
    got = _shape(core.timeline)
    assert got == ref
    assert got["busy"] == core.steps == sum(got["kinds"].values())
    # the engine wrote its own timeline, not the module-level one
    assert step_timeline.snapshot() == before
    m = core.metrics()
    assert m["host_gap_ms_per_turn"] == core.timeline.host_gap_ms_per_turn > 0
    assert m["device_gets_total"] == core.steps
    want = {"default": {"step", "decode_multi"}, "unified": {"unified"},
            "lookahead": {"unified_burst"}, "spec": {"spec_verify"}}[path]
    assert want <= set(got["kinds"])


def test_two_engines_keep_their_own_timelines(tiny):
    """Two engines stepping at once in two threads: each timeline counts
    exactly its own engine's steps and dispatches."""
    cores = [EngineCore(tiny[2], EngineConfig(**BASE, **PATHS["default"]), eos_token_ids=[],
                        device="cpu") for _ in range(2)]
    specs = [_specs(), _specs()[:2]]
    start = threading.Barrier(2)

    def drive(core, sp):
        start.wait()
        _serve(core, EngineRequest, protocols, sp)

    threads = [threading.Thread(target=drive, args=(c, sp)) for c, sp in zip(cores, specs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    solo = EngineCore(tiny[2], EngineConfig(**BASE, **PATHS["default"]), eos_token_ids=[],
                      device="cpu")
    _serve(solo, EngineRequest, protocols, specs[1])
    for core in cores + [solo]:
        snap = core.timeline.snapshot()
        assert snap["busy_steps_total"] == core.steps
        assert sum(v["count"] for v in snap["dispatch_kinds"].values()) == core.steps
    assert cores[0].steps > cores[1].steps
    assert _shape(cores[1].timeline) == _shape(solo.timeline)


# ------------------------------------------------------------------ export


def test_chrome_trace_equals_jax(monkeypatch):
    monkeypatch.setattr(tracing, "EPOCH_NS", 1_700_000_000_000_000_000)
    monkeypatch.setattr(jax_tracing, "EPOCH_NS", 1_700_000_000_000_000_000)
    spans = [
        {"name": "http.request", "trace": "t1", "span": "s1", "parent": None, "ts": 1000,
         "dur": 5_000_000, "proc": "frontend", "attrs": {"endpoint": "completions"}},
        {"name": "engine.step", "trace": "t1", "span": "s2", "parent": "s1", "ts": 2000,
         "dur": 1_000_000, "proc": "worker",
         "attrs": {"phases_ms": {"dispatch": 0.5, "host_post": 0.1},
                   "dispatch_kinds": ["decode_multi"], "measured_dispatch_ms": 0.5,
                   "predicted_dispatch_ms": 0.01}},
        {"name": "engine.step", "trace": "t1", "span": "s3", "parent": "s1", "ts": 3000,
         "dur": 2_000_000, "proc": "worker",
         "attrs": {"phases_ms": {}, "measured_dispatch_ms": 0.2}},
        {"name": "tcp.call.x", "trace": "t2", "span": "s4", "parent": None, "ts": 4000,
         "dur": 10, "proc": "frontend"},
    ]
    doc = export.chrome_trace(spans)
    assert doc == jax_export.chrome_trace(spans)
    assert [e["ph"] for e in doc["traceEvents"]].count("C") == 2


# ----------------------------------------------------------------- pricing


def test_predicted_ms_is_the_bound_by_hand(tiny):
    """One prompt of 20 tokens, then one 4-step decode burst: each kind's
    prediction is max(FLOPs / f32 peak, bytes / HBM rate) of its work."""
    model = tiny[2]
    core = EngineCore(model, EngineConfig(**BASE, decode_steps=4), eos_token_ids=[],
                      device="cpu")
    n = 20
    _serve(core, EngineRequest, protocols, [("a", list(range(3, 3 + n)), 5)])
    c = model.config
    h, d, hk, i, L, v = (c.hidden_size, c.head_dim, c.num_kv_heads, c.intermediate_size,
                         c.num_layers, c.vocab_size)
    body = L * (h * c.num_heads * d + 2 * h * hk * d + c.num_heads * d * h + 3 * h * i)
    head = h * v
    weight_bytes = 4 * (body + head + 2 * L * h + h)  # f32 matrices and norms
    kv_per_token = L * 2 * hk * d * 4
    topo = TOPOLOGIES["h100"]

    def bound(tokens, sampled, pairs, kv_tokens, steps):
        flops = 2 * (tokens * body + sampled * head) + 4 * c.num_heads * d * pairs * L
        nbytes = steps * weight_bytes + kv_per_token * (kv_tokens + tokens)
        return 1e3 * max(flops / topo["peak_flops"]["float32"], nbytes / topo["hbm_bw"])

    prefill = bound(n, 1, n * (n + 1) // 2, 0, 1)
    # the burst starts with the prompt and the first token in the context
    pairs = sum(n + 1 + k for k in range(4))
    decode = bound(4, 4, pairs, pairs - 4, 4)
    assert core.perf_model.predicted_ms("step") == pytest.approx(prefill, rel=1e-12)
    assert core.perf_model.predicted_ms("decode_multi") == pytest.approx(decode, rel=1e-12)
    rows = {r["kind"]: r for r in core.perf_model.reconcile(core.timeline)}
    assert rows["step"]["dispatches"] == 1 and rows["decode_multi"]["dispatches"] == 1
    assert rows["step"]["predicted_ms"] == core.perf_model.predicted_ms("step")
    assert rows["step"]["measured_ms"] > 0 and rows["step"]["error_ratio"] > 0
    shapes = model_shapes(model, kv_per_token)
    assert (shapes.body_params, shapes.head_params, shapes.weight_bytes) == (
        body, head, weight_bytes)
    # a kind is priced at its first offer only
    pm = PerfModel()
    pm.offer("step", shapes, tokens=1, sampled=1, pairs=1, kv_tokens=0)
    first = pm.predicted_ms("step")
    pm.offer("step", shapes, tokens=100, sampled=1, pairs=5050, kv_tokens=0)
    assert pm.predicted_ms("step") == first and not pm.wants("step")


def test_cost_priors_come_from_topology():
    """The transfer-cost table's cold-edge priors are the topology's, with
    the rates the port priced before the table existed; a collective is
    free on one card, priced at the NVLink datasheet rate across the cards
    of a host, and refused on a link without a rate (gloo's host buffers)."""
    from dynamo_tpu_torch.obs import topology
    from dynamo_tpu_torch.obs.costs import TransferCostTable

    rates = {"ici": (3.35e12 / 2, 10e-6), "dcn": (3.125e9, 50e-6), "persist": (1e9, 1e-3)}
    t = TransferCostTable()
    for path, (bw, lat) in rates.items():
        want = lat + (1 << 20) / (bw * 0.6)
        assert topology.prior_cost_s(path, 1 << 20) == pytest.approx(want, rel=1e-12)
        assert t.cost_s("a", "b", path, 1 << 20) == pytest.approx(want, rel=1e-12)
        assert topology.path_prior_bw(path) == pytest.approx(bw * 0.6, rel=1e-12)
    assert t.cost_s("a", "b", "???", 1 << 20) == topology.prior_cost_s("persist", 1 << 20)
    assert topology.TOPOLOGIES["h100"]["hbm_bw"] == 3.35e12
    assert topology.TOPOLOGIES["h100"]["peak_flops"]["bfloat16"] == 989e12
    assert topology.collective_cost_s("psum", 1, 1 << 30) == 0.0
    assert topology.TOPOLOGIES["h100"]["nvlink_bw"] == 450e9
    # ring all-reduce over 2 cards: 2(n-1)/n of the payload, 2(n-1) hops
    assert topology.collective_cost_s("psum", 2, 1 << 30) == pytest.approx(
        (1 << 30) / 450e9 + 2 * 2e-6, rel=1e-12)
    assert topology.collective_cost_s("all_gather", 4, 1 << 20, link="dcn") == pytest.approx(
        0.75 * (1 << 20) / 3.125e9 + 3 * 50e-6, rel=1e-12)
    with pytest.raises(NotImplementedError, match="gloo"):
        topology.collective_cost_s("psum", 2, 1 << 30, link="gloo")


# ----------------------------------------------------------------- profile


def test_profile_window_writes_a_chrome_trace(tiny, tmp_path):
    core = EngineCore(tiny[2], EngineConfig(**BASE, decode_steps=2, profile_dir=str(tmp_path),
                                            profile_steps=3), eos_token_ids=[], device="cpu")
    _serve(core, EngineRequest, protocols, [("a", list(range(3, 20)), 12)])
    assert core.steps > 3
    [window] = list(tmp_path.iterdir())
    assert window.name == "steps-000000"
    doc = json.loads((window / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
    # closed after profile_steps dispatches; close() leaves it closed
    assert core._profiler is None and core._profile_done
    core.close()
    assert list(tmp_path.iterdir()) == [window]


# -------------------------------------------------------------- front door


@pytest.fixture()
def traced():
    was = tracing.enabled()
    tracing.enable(True)
    tracing.collector.reset()
    yield
    tracing.enable(was)
    tracing.collector.reset()


def test_debug_traces_and_trace_command(tiny, tiny_dir, traced):
    """A completion traced at the front door: /debug/traces answers its
    Chrome JSON under the caller's id (one trace id, the engine's steps with
    their phases), 404 for an unknown id, and the ``trace`` command prints
    the same body."""
    from aiohttp import ClientSession

    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    card = ModelDeploymentCard.from_hf_dir(tiny_dir, name="tiny")
    engine = AsyncLLMEngine(EngineCore(tiny[2], EngineConfig(**BASE, decode_steps=4),
                                       eos_token_ids=[], device="cpu")).start()

    async def go():
        svc = HttpService(port=0, core=engine.core)
        svc.manager.add_model("tiny", build_serving_pipeline(engine, card), card)
        await svc.start()
        base = f"http://127.0.0.1:{svc.port}"
        try:
            async with ClientSession() as s:
                body = {"model": "tiny", "prompt": "hello world w3 w5", "max_tokens": 6,
                        "temperature": 0}
                async with s.post(f"{base}/v1/completions", json=body,
                                  headers={"x-request-id": "req-obs-1"}) as r:
                    assert r.status == 200 and r.headers["x-request-id"] == "req-obs-1"
                    await r.json()
                # a step boundary after the answer: the last step's span is in
                await engine.run_on_engine(lambda: None)
                async with s.get(f"{base}/debug/traces/req-obs-1") as r:
                    assert r.status == 200
                    doc = await r.json()
                async with s.get(f"{base}/debug/traces/nope") as r:
                    missing = (r.status, await r.json())
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", PKG, "trace", "req-obs-1", "--url", base, cwd=str(REPO),
                env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)
            out, err = await asyncio.wait_for(proc.communicate(), 60)
            assert proc.returncode == 0, err.decode()
            return doc, missing, json.loads(out)
        finally:
            await svc.stop()

    try:
        doc, missing, fetched = asyncio.run(go())
    finally:
        engine.shutdown()
    assert missing == (404, {"error": "no trace recorded for 'nope' (is DYNAMO_TRACE=1 set?)"})
    assert fetched == doc
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len({e["args"]["trace_id"] for e in spans}) == 1
    names = {e["name"] for e in spans}
    assert {"http.request", "engine.generate", "engine.step"} <= names
    steps = [e for e in spans if e["name"] == "engine.step"]
    assert all(set(e["args"]["phases_ms"]) <= set(PHASES) for e in steps)
    assert all("predicted_dispatch_ms" in e["args"] for e in steps)


def test_run_flags_set_what_the_jax_cli_sets(tiny_dir, tmp_path, monkeypatch):
    """``run --trace --profile-dir D --profile-steps 4``: the same parsed
    flags, and the same EngineConfig fields, in both CLIs."""
    import dynamo_tpu.cli as jax_cli
    import dynamo_tpu.engine as jax_engine
    import dynamo_tpu_torch.engine as port_engine
    from dynamo_tpu_torch import cli

    flags = ["--model-path", str(tiny_dir), "--trace", "--profile-dir",
             str(tmp_path / "prof"), "--profile-steps", "4"]
    seen = {}

    class Stop(Exception):
        pass

    def capture(tag):
        def core(*args, **kw):
            seen[tag] = next(a for a in args if hasattr(a, "profile_dir"))
            raise Stop
        return core

    monkeypatch.setattr(jax_engine, "EngineCore", capture("jax"))
    monkeypatch.setattr(port_engine, "EngineCore", capture("port"))
    jargs = jax_cli._parser().parse_args(["run", "in=http", "out=tpu", *flags])
    jargs.inp, jargs.out = "http", "tpu"
    args = cli.parse_args(["run", "in=http", "out=gpu", "--device", "cpu", *flags])
    for name in ("trace", "profile_dir", "profile_steps"):
        assert getattr(args, name) == getattr(jargs, name)
    with pytest.raises(Stop):
        jax_cli._build_local_engine(jargs)
    with pytest.raises(Stop):
        cli.build_local_engine(args)
    for name in ("profile_dir", "profile_steps"):
        assert getattr(seen["port"], name) == getattr(seen["jax"], name)
    assert seen["port"].profile_dir == str(tmp_path / "prof")
    assert seen["port"].profile_steps == 4
