"""More than one device: the port's rank mesh against the JAX package's
meshed engine, on the CPU.

One real gloo world of two processes for the module (``torch_mesh_world``:
this process is rank 0, the other a shard follower started through the
port's own entry point and rendezvous), laid out as the (data, model) mesh
(1, 2) or (2, 1).  The JAX side runs in this process on the 8 forced CPU
devices ``tests/conftest.py`` sets up, with ``EngineCore(mesh=build_mesh(
shape))``.  Every model is the JAX package's random init carried over
(f32), written once as a full state file each rank cuts its slice from.

* tensor-parallel logits of tiny Llama (dense, MoE, a tp that does not
  divide Hk) and absorbed DeepSeek within 1e-4 of JAX's unsharded logits;
* greedy streams token-identical to JAX's meshed ``EngineCore`` on both
  meshes: dense Llama on the default and the unified paths, int8 weights,
  int8 cache, MoE and absorbed DeepSeek;
* the counterparts of ``test_multihost.py`` (``spec_from_env``; the
  two-process sharded engine, f32 and int8, with the follower replaying
  every dispatch), ``test_grammar_engine.py::test_json_mode_under_tp_mesh``,
  ``test_kv_quant.py::test_engine_int8_cache_sharded_mesh`` and
  ``test_disagg.py::test_disagg_sharded_decode_matches_local``;
* ``run --tp 2 --device cpu in=batch:`` answers as ``--tp 1`` does, and
  ``run --tp 2 in=http`` exits non-zero once its follower dies;
* NCCL asked for two ranks on one card raises, naming the card.
"""

import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

import dynamo_tpu_torch
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.deepseek import DeepseekConfig as JaxDeepseekConfig
from dynamo_tpu.models.deepseek import DeepseekModel as JaxDeepseekModel
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.utils.mesh import MESH_AXES as JAX_MESH_AXES
from dynamo_tpu.utils.mesh import build_mesh as jax_build_mesh
from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.follower import broadcast_model
from dynamo_tpu_torch.engine.grammar import INIT_STATE, JsonGrammar
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols as port_protocols
from dynamo_tpu_torch.llm.protocols import (BackendInput, FinishReason, SamplingOptions,
                                            StopConditions)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import deepseek_params_from_jax, params_from_jax
from dynamo_tpu_torch.models.deepseek import DeepseekConfig
from dynamo_tpu_torch.runtime.multihost import MultiHostSpec, spec_from_env
from tests.torch_mesh_world import World, handled_steps, logits_case

PKG = dynamo_tpu_torch.__name__
BASE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64)
LOGIT_ATOL = 1e-4
EOS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers share
    the machine's cores (the followers run with OMP_NUM_THREADS=1 too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    w = World(2, (1, 2))
    yield w
    w.close()


def _llama(**kw):
    """(JAX model, JAX params, port config, the port's full state) of one
    f32 config, optionally int8 (``quantize``)."""
    quant = kw.pop("quantize", False)
    kw = {**dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                 num_heads=4, num_kv_heads=2, max_position_embeddings=256, dtype="float32"),
          **kw}
    jmodel = JaxLlamaModel(JaxModelConfig(**kw))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    if quant:
        jparams = jmodel.quantize_params(jparams)
    cfg = ModelConfig(**kw)
    state = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jmodel, jparams, cfg, state


DS_KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=16, intermediate_size=64,
             moe_intermediate_size=32, n_routed_experts=4, num_experts_per_tok=2,
             n_shared_experts=1, first_k_dense_replace=1, max_position_embeddings=512,
             dtype="float32")


def _deepseek():
    jmodel = JaxDeepseekModel(JaxDeepseekConfig(**DS_KW))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = DeepseekConfig(**DS_KW)
    state = deepseek_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jmodel, jparams, cfg, state


MODELS = {
    "dense": lambda: _llama(),
    "int8w": lambda: _llama(quantize=True),
    "moe": lambda: _llama(num_experts=4, num_experts_per_tok=2, intermediate_size=64),
    "hk1": lambda: _llama(num_kv_heads=1),
    "deepseek": _deepseek,
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Each model of MODELS built once: (JAX model, JAX params, the port's
    model spec for ``broadcast_model``)."""
    root = tmp_path_factory.mktemp("mesh_models")
    out = {}
    for name, make in MODELS.items():
        jmodel, jparams, cfg, state = make()
        path = root / f"{name}.safetensors"
        save_file({k: v.contiguous() for k, v in state.items()}, str(path))
        family = "deepseek" if name == "deepseek" else "llama"
        out[name] = (jmodel, jparams, {"kind": "state", "family": family,
                                       "config": dataclasses.asdict(cfg), "path": str(path)})
    return out


def _port_model(world, models, name, shape):
    return broadcast_model(models[name][2], world.layout(shape), "cpu")


REQUESTS = [("a", list(range(3, 40)), 10), ("b", [5, 6, 7], 8), ("c", list(range(60, 80)), 6)]


def _jax_streams(models, name, shape, requests=REQUESTS, **kw):
    jmodel, jparams, _ = models[name]
    core = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**{**BASE, **kw}),
                         mesh=jax_build_mesh(shape, JAX_MESH_AXES), eos_token_ids=[])
    outs = {rid: [] for rid, _, _ in requests}
    for rid, prompt, n in requests:
        core.submit(JaxEngineRequest(
            request_id=rid, prompt=prompt, sampling=jax_protocols.SamplingOptions(temperature=0.0),
            stops=jax_protocols.StopConditions(max_tokens=n, ignore_eos=True),
            emit=lambda o, r=rid: outs[r].extend(o.token_ids)))
    for _ in range(500):
        if not core.step():
            break
    return outs


def _port_streams(model, requests=REQUESTS, **kw):
    core = EngineCore(model, EngineConfig(**{**BASE, **kw}), eos_token_ids=[], device="cpu")
    outs = {rid: [] for rid, _, _ in requests}
    for rid, prompt, n in requests:
        core.submit(EngineRequest(
            request_id=rid, prompt=prompt, sampling=SamplingOptions(temperature=0.0),
            stops=StopConditions(max_tokens=n, ignore_eos=True),
            emit=lambda o, r=rid: outs[r].extend(o.token_ids)))
    for _ in range(500):
        if not core.step():
            break
    core.close()
    return outs, core


# ------------------------------------------------------------------ logits
@pytest.mark.parametrize("name", ["dense", "moe", "hk1", "deepseek"])
def test_tp_logits_match_jax(world, models, name):
    """The sharded forward's logits (all-reduced ``wo``/``w_down``,
    all-gathered vocab) against the JAX model's unsharded ones."""
    import jax.numpy as jnp

    model = _port_model(world, models, name, (1, 2))
    rng = np.random.default_rng(0)
    b, s, bs = 2, 12, 8
    vocab = model.config.vocab_size
    tokens = rng.integers(1, vocab, (b, s)).astype(np.int64)
    positions = np.broadcast_to(np.arange(s), (b, s)).astype(np.int64)
    got = world.call(logits_case, tokens, positions, 8, bs, model=model)
    jmodel, jparams, _ = models[name]
    nb = -(-s // bs)
    cache = jmodel.init_kv_cache(num_blocks=8, block_size=bs)
    bt = jnp.arange(b * nb, dtype=jnp.int32).reshape(b, nb)
    slot = np.asarray(bt)[:, positions[0] // bs] * bs + positions % bs
    hidden, _ = jmodel.forward(jparams, jnp.asarray(tokens, jnp.int32),
                               jnp.asarray(positions, jnp.int32), cache, bt,
                               jnp.full((b,), s, jnp.int32), jnp.asarray(slot, jnp.int32))
    want = np.asarray(jmodel.compute_logits(jparams, hidden))
    assert got.shape == want.shape == (b, s, vocab)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


# ----------------------------------------------------------------- streams
STREAM_CASES = {
    "dense": ("dense", {}),
    "dense-unified": ("dense", dict(prefill_token_budget=32, unified_token_dispatch=True,
                                    decode_steps=4)),
    "int8w": ("int8w", dict(decode_steps=4)),
    "int8cache": ("dense", dict(cache_dtype="int8", decode_steps=4)),
    "moe": ("moe", dict(decode_steps=4)),
    "deepseek": ("deepseek", dict(decode_steps=4)),
}


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["tp2", "dp2"])
@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_greedy_streams_match_jax_mesh(world, models, case, shape):
    name, kw = STREAM_CASES[case]
    model = _port_model(world, models, name, shape)
    got, _ = _port_streams(model, **kw)
    assert got == _jax_streams(models, name, shape, **kw)
    assert all(len(got[rid]) == n for rid, _, n in REQUESTS)


def test_tp_that_does_not_divide_hk(world, models):
    """One kv head over tp=2: each rank keeps the head its query heads read
    (``models/llama.py::kv_head_range``), and its cache holds that head."""
    model = _port_model(world, models, "hk1", (1, 2))
    assert model.heads == (2, 1) and model.kv_heads() == (0, 1)
    got, core = _port_streams(model, decode_steps=4)
    assert core.cache.shape[-1] == model.config.head_dim
    assert got == _jax_streams(models, "hk1", (1, 2), decode_steps=4)


# --------------------------------------------------- test_multihost.py
def test_spec_from_env(monkeypatch):
    monkeypatch.setenv("DYN_MH_NPROCS", "4")
    monkeypatch.setenv("DYN_MH_RANK", "2")
    monkeypatch.setenv("DYN_MH_COORDINATOR", "tcp://10.0.0.1:4222")
    monkeypatch.setenv("DYN_MH_BACKEND", "gloo")
    spec = spec_from_env()
    assert spec.num_processes == 4 and spec.process_id == 2
    assert spec.coordinator_url == "tcp://10.0.0.1:4222" and spec.backend == "gloo"
    assert spec.is_multihost
    assert not MultiHostSpec().is_multihost


@pytest.mark.parametrize("name", ["dense", "int8w"], ids=["bf16", "int8"])
def test_two_process_sharded_engine(world, models, name):
    """The JAX test's engine (a 6-token greedy continuation, decode bursts of
    2): rank 0's tokens are the JAX meshed engine's, the follower replayed
    every dispatch rank 0 ran, and rank 0's timeline holds its collective
    waits as a phase."""
    req = [("mh", [3, 1, 4, 1, 5, 9, 2, 6], 6)]
    kw = dict(max_batch_size=2, max_model_len=64, block_size=16, num_blocks=16, decode_steps=2)
    model = _port_model(world, models, name, (1, 2))
    before = world.call(handled_steps, model=model)
    got, core = _port_streams(model, req, **kw)
    after = world.call(handled_steps, model=model)
    assert got == _jax_streams(models, name, (1, 2), req, **kw)
    assert len(got["mh"]) == 6
    assert after[1] - before[1] == core.steps > 0
    # rank 0's waits in collectives are a timeline phase of their own
    from dynamo_tpu_torch.obs.timeline import COLLECTIVE

    assert core.timeline.snapshot()["phases"][COLLECTIVE] > 0


# --------------------------------------------------------- the other pins
def test_json_mode_under_tp_mesh(world, tmp_path):
    """Grammar masking composes with tensor parallelism (gathered logits,
    whole tables on rank 0): greedy streams equal JAX's meshed engine, and a
    sampled one is valid JSON or a valid prefix of it."""
    from dynamo_tpu.engine.grammar import JsonGrammar as JaxJsonGrammar

    jmodel, jparams, cfg, state = _llama(vocab_size=512)
    path = tmp_path / "g.safetensors"
    save_file({k: v.contiguous() for k, v in state.items()}, str(path))
    model = broadcast_model({"kind": "state", "family": "llama",
                             "config": dataclasses.asdict(cfg), "path": str(path)},
                            world.layout((1, 2)), "cpu")
    toks: list = [None] * 512
    for b in range(256):
        toks[3 + b] = bytes([b])
    for i, t in {300: b'{"', 301: b'":', 302: b'"}', 303: b'true'}.items():
        toks[i] = t
    grammar = JsonGrammar.from_token_bytes(toks, eos_ids=[EOS])
    ecfg = dict(max_batch_size=2, max_model_len=128, block_size=8, num_blocks=64,
                prefill_buckets=[16, 32, 64, 128], decode_steps=4)
    core = EngineCore(model, EngineConfig(**ecfg), eos_token_ids=[EOS], device="cpu",
                      grammar=grammar)
    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**ecfg),
                          mesh=jax_build_mesh((1, 2), JAX_MESH_AXES), eos_token_ids=[EOS],
                          grammar=JaxJsonGrammar.from_token_bytes(toks, eos_ids=[EOS]))

    def one(c, req_cls, proto, rid, temperature):
        outs = []
        c.submit(req_cls(request_id=rid, prompt=[5, 6, 7, 8],
                         sampling=proto.SamplingOptions(temperature=temperature, json_mode=True),
                         stops=proto.StopConditions(max_tokens=40), emit=outs.append))
        for _ in range(200):
            if not c.step():
                break
        return [t for o in outs for t in o.token_ids], outs[-1].finish_reason

    greedy = one(core, EngineRequest, port_protocols, "g", 0.0)
    jgreedy = one(jcore, JaxEngineRequest, jax_protocols, "g", 0.0)
    assert greedy[0] == jgreedy[0]
    for rid in ("s0", "s1"):
        ids, reason = one(core, EngineRequest, port_protocols, rid, 1.0)
        if reason is FinishReason.EOS:
            json.loads(b"".join(toks[i] for i in ids if i != EOS and toks[i]).decode(
                "utf-8", errors="replace"))
        else:
            s, d, st = INIT_STATE, 0, 0
            for t in ids:
                assert grammar.tables.valid_mask(s, d, st)[t]
                s, d, st = grammar.tables.advance(s, d, st, t)
    core.close()


def test_engine_int8_cache_sharded_mesh(world, models):
    """An int8 cache over tp=2: each rank holds its kv heads' codes and a
    scale pool tiled for them, and the engine decodes 8 tokens."""
    from dynamo_tpu_torch.ops.kv_quant import is_quant, scale_tile

    model = _port_model(world, models, "dense", (1, 2))
    req = [("shq", [3, 4, 5, 6], 8)]
    got, core = _port_streams(model, req, cache_dtype="int8", max_batch_size=2,
                              max_model_len=64, block_size=8, num_blocks=32)
    assert is_quant(core.cache)
    assert core.cache.data.shape[-1] == model.config.head_dim  # one of the two kv heads
    assert core.cache.scale.shape[-2:] == scale_tile(1, 8)
    assert sum(len(v) for v in got.values()) == 8


def test_disagg_sharded_decode_matches_local(world, models, monkeypatch):
    """A TP-sharded decode engine behind the disagg stack (coordinator,
    router, transfer over TCP): the transfer-in scatter gives each rank its
    kv heads of the staged host blocks, and decode reproduces the local
    greedy tokens of an unsharded engine."""
    from dynamo_tpu_torch.llm.disagg_router import DisaggregatedRouter, DisaggRouterConf
    from dynamo_tpu_torch.llm.workers import DecodeWorker, PrefillWorker
    from dynamo_tpu_torch.models.llama import LlamaModel
    from dynamo_tpu_torch.models.loader import model_from_spec
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.transports.coordinator import (CoordinatorClient,
                                                                 CoordinatorServer)

    monkeypatch.setenv("DYN_KV_TRANSFER_FORCE_TCP", "1")
    sharded = _port_model(world, models, "dense", (1, 2))
    local = model_from_spec(models["dense"][2], "cpu")
    assert isinstance(local, LlamaModel) and local.mesh is None
    prompt = np.random.default_rng(11).integers(1, 128, size=28).tolist()

    def engine(model):
        return AsyncLLMEngine(EngineCore(model, EngineConfig(**BASE), device="cpu")).start()

    async def drain(e):
        ctx = Context(BackendInput(token_ids=list(prompt),
                                   sampling=SamplingOptions(temperature=0.0),
                                   stops=StopConditions(max_tokens=8)))
        return [t for o in await e.generate_all(ctx) for t in o.token_ids]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        dec, pre, ref = engine(sharded), engine(local), engine(local)
        try:
            c_dec = await CoordinatorClient(srv.url).connect()
            c_pre = await CoordinatorClient(srv.url).connect()
            worker = DecodeWorker(dec, coordinator=c_dec, namespace="shard",
                                  router=DisaggregatedRouter(
                                      DisaggRouterConf(max_local_prefill_length=0),
                                      namespace="shard"))
            await worker.start()
            prefill = PrefillWorker(pre, c_pre, "shard")
            task = asyncio.ensure_future(prefill.run())
            expected = await drain(ref)
            got = await drain(worker)
            prefill.request_stop()
            await task
            await worker.stop()
            await c_dec.close()
            await c_pre.close()
            return expected, got, prefill.handled
        finally:
            for e in (dec, pre, ref):
                e.shutdown()
            await srv.stop()

    expected, got, handled = asyncio.new_event_loop().run_until_complete(go())
    assert got == expected and len(got) == 8
    assert handled == 1


# -------------------------------------------------------------------- run
CLI_ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _run_cli(args, cwd, timeout=120):
    return subprocess.run([sys.executable, "-m", PKG, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout, env=CLI_ENV)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.conftest import make_tiny_hf_checkpoint

    d = tmp_path_factory.mktemp("mesh_cli") / "hf"
    make_tiny_hf_checkpoint(d)
    return d


def _batch_run(ckpt, batch: Path):
    """``run in=batch:`` on the tiny checkpoint: (argv, the answers' reader)."""
    base = ["run", f"in=batch:{batch}", "out=gpu", "--device", "cpu", "--model-path",
            str(ckpt), "--dtype", "float32", "--max-tokens", "6", "--max-model-len", "128",
            "--num-blocks", "32"]

    def answers():
        return [json.loads(ln)["text"]
                for ln in batch.with_suffix(".out.jsonl").read_text().splitlines()]

    return base, answers


@pytest.fixture(scope="module")
def tp1_answers(ckpt, tmp_path_factory):
    """The one-rank answers of the batch the ``run`` cases serve."""
    batch = tmp_path_factory.mktemp("mesh_batch") / "b.jsonl"
    batch.write_text('{"text": "hello world w1 w2"}\n{"text": "w3 w4 w5"}\n')
    base, answers = _batch_run(ckpt, batch)
    r = _run_cli(base + ["--tp", "1"], cwd=Path(__file__).resolve().parent.parent)
    assert r.returncode == 0, r.stderr[-3000:]
    return answers()


@pytest.mark.parametrize("layout", ["tp2", "nnodes2"])
def test_run_tp2_batch_matches_tp1(ckpt, tmp_path, tp1_answers, layout):
    """``run --tp 2 --device cpu in=batch:`` starts its follower, answers
    the batch as ``--tp 1`` does, and stops the follower with exit 0.  With
    ``--nnodes 2`` two ``run`` processes (``--node-rank`` 0 and 1, a rank
    each) join through a coordinator's rendezvous instead, and node 1 only
    follows."""
    from tests.torch_mesh_world import Coordinator

    repo = Path(__file__).resolve().parent.parent
    batch = tmp_path / "b.jsonl"
    batch.write_text('{"text": "hello world w1 w2"}\n{"text": "w3 w4 w5"}\n')
    base, answers = _batch_run(ckpt, batch)
    if layout == "tp2":
        r = _run_cli(base + ["--tp", "2"], cwd=repo)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "1 followers started here" in r.stderr
    else:
        coord = Coordinator()
        try:
            nodes = ["--tp", "2", "--nnodes", "2", "--coordinator", coord.url]
            follower = subprocess.Popen(
                [sys.executable, "-m", PKG, *base, *nodes, "--node-rank", "1"], cwd=repo,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=CLI_ENV)
            r = _run_cli(base + nodes + ["--node-rank", "0"], cwd=repo)
            err = follower.communicate(timeout=60)[1]
        finally:
            coord.stop()
        assert r.returncode == 0, r.stderr[-3000:]
        assert follower.returncode == 0, err[-3000:]
        assert "0 followers started here" in r.stderr and "rank 1 of a" in err
    assert answers() == tp1_answers and all(tp1_answers)


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_run_exits_nonzero_when_a_follower_dies(ckpt):
    """``run --tp 2 in=http``: kill the follower, and the next request's
    dispatch raises on rank 0, the request fails, and ``run`` exits
    non-zero (no rank goes on alone)."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", PKG, "run", "in=http", "out=gpu", "--device", "cpu",
         "--model-path", str(ckpt), "--dtype", "float32", "--tp", "2", "--http-port",
         str(port), "--max-model-len", "128", "--num-blocks", "32"],
        cwd=Path(__file__).resolve().parent.parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=CLI_ENV)
    url = f"http://127.0.0.1:{port}/v1/completions"
    body = json.dumps({"model": "hf", "prompt": [5, 6, 7], "max_tokens": 4,
                       "temperature": 0}).encode()

    def post():
        req = urllib.request.Request(url, data=body, headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            return json.loads(r.read())["choices"][0]["finish_reason"]

    try:
        for _ in range(150):
            try:
                assert post() == "length"
                break
            except OSError:
                time.sleep(0.1)
        else:
            pytest.fail("run never served")
        kids = [k for t in Path(f"/proc/{proc.pid}/task").iterdir()
                for k in (t / "children").read_text().split()]
        assert len(kids) == 1, kids
        os.kill(int(kids[0]), signal.SIGKILL)
        proc_dead = Path(f"/proc/{kids[0]}")
        for _ in range(100):
            if not proc_dead.exists() or "Z" in (proc_dead / "stat").read_text().split()[2]:
                break
            time.sleep(0.05)
        assert post() == "error"  # the dispatch's collective raised on rank 0
        rc = proc.wait(timeout=30)
        assert rc != 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """The bootstrap's check before NCCL is asked: two ranks of the world on
    one card raise, naming the card (gloo is only chosen by name)."""
    from dynamo_tpu_torch.runtime import multihost

    class Props:
        name, uuid = "NVIDIA H100 80GB HBM3", "GPU-0000"

    class Store(dict):
        def set(self, k, v):
            self[k] = v.encode()

        def get(self, k):
            return dict.__getitem__(self, k)

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    store = Store()
    store.set("device/0", f"{__import__('socket').gethostname()}/GPU-0000")
    with pytest.raises(RuntimeError, match=r"share cuda:0 \(NVIDIA H100.*GPU-0000.*gloo"):
        multihost._check_devices(store, MultiHostSpec(num_processes=2, process_id=1),
                                 torch.device("cuda", 0))
    assert multihost._backend(MultiHostSpec(num_processes=2), torch.device("cpu")) == "gloo"
    assert multihost._backend(MultiHostSpec(num_processes=2, backend="gloo"),
                              torch.device("cuda", 0)) == "gloo"
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        multihost._backend(MultiHostSpec(num_processes=2, backend="nccl"), torch.device("cpu"))


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_sharded_blocks_scatter_then_gather_whole(world, models, cache):
    """Whole handed-off blocks (host tensors, as the wire unpacks them:
    bf16 included, which numpy cannot hold) scattered onto a tp=2 cache
    give each rank its kv head (and a scale tile re-padded to it); a gather
    for a handoff out assembles the whole blocks again, every kv head and
    valid scale row in place."""
    from dynamo_tpu_torch.models.loader import model_from_spec
    from dynamo_tpu_torch.ops.kv_quant import scale_tile

    spec = dict(models["dense"][2])
    spec["config"] = dict(spec["config"], dtype="bfloat16")
    model = broadcast_model(spec, world.layout((1, 2)), "cpu")
    quant = cache == "int8"
    core = EngineCore(model, EngineConfig(**BASE, cache_dtype="int8" if quant else None),
                      device="cpu")
    gen = torch.Generator().manual_seed(3)
    cfg, ids = model.config, [5, 9, 2]
    shape = (cfg.num_layers, len(ids), 2, BASE["block_size"], cfg.num_kv_heads * cfg.head_dim)
    if quant:
        hp, sp = scale_tile(cfg.num_kv_heads, BASE["block_size"])
        blocks = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8),
                  torch.rand(shape[:3] + (hp, sp), generator=gen) + 0.5)
    else:
        blocks = (torch.randn(shape, generator=gen).to(torch.bfloat16),)
    core.scatter_external(ids, blocks if quant else blocks[0])
    local = core.cache.data if quant else core.cache
    assert local.shape[-1] == cfg.head_dim  # rank 0 holds kv head 0 alone
    assert torch.equal(local[:, ids], blocks[0][..., :cfg.head_dim])
    back = core.gather_blocks_np(ids)
    back = back if isinstance(back, tuple) else (back,)
    assert torch.equal(back[0], blocks[0])
    if quant:
        hk, bs = cfg.num_kv_heads, BASE["block_size"]
        assert torch.equal(back[1][..., :hk, :bs], blocks[1][..., :hk, :bs])
    # the router's transfer size counts every kv head, as one card's cache does
    one_card = EngineCore(model_from_spec(spec, "cpu"),
                          EngineConfig(**BASE, cache_dtype="int8" if quant else None), device="cpu")
    assert core.kv_bytes_per_block() == one_card.kv_bytes_per_block()
    core.close()


@pytest.mark.parametrize("fmt", ["hf", "hf-int8", "native-int8"])
def test_every_loader_cuts_this_ranks_slice(ckpt, tmp_path, fmt):
    """Each rank of a tp=2 mesh loads exactly its slice of what one card
    loads (an int8 weight quantised whole, then cut: a row-split weight's
    scales stay whole).  No collective runs, so the two ranks are two
    ``Mesh`` views with no world behind them."""
    from dynamo_tpu_torch.cli import load_any_checkpoint
    from dynamo_tpu_torch.models.checkpoint import save_checkpoint
    from dynamo_tpu_torch.models.llama import shard_plan
    from dynamo_tpu_torch.models.quant import shard_state
    from dynamo_tpu_torch.utils.mesh import MESH_AXES, Mesh

    path, quantize = str(ckpt), fmt != "hf"
    if fmt == "native-int8":
        whole, _ = load_any_checkpoint(str(ckpt), "float32", "cpu", True)
        path, quantize = str(tmp_path / "native"), False
        save_checkpoint(path, whole.config, whole.state_dict(), quantized=True)
    whole, _ = load_any_checkpoint(path, "float32", "cpu", quantize)
    full = whole.state_dict()
    for rank in (0, 1):
        mesh = Mesh(MESH_AXES, (1, 2), rank=rank)
        part, _ = load_any_checkpoint(path, "float32", "cpu", quantize, mesh=mesh)
        specs, blocks = shard_plan(whole.config, "embed_scale" in full, mesh)
        want = shard_state(full, specs, mesh, blocks)
        got = part.state_dict()
        assert set(got) == set(want) and part.mesh is mesh
        for name, t in want.items():
            assert torch.equal(got[name], t), (fmt, rank, name)
        if "layers.wo_scale" in got:  # row-split: the whole per-channel scales
            assert torch.equal(got["layers.wo_scale"], full["layers.wo_scale"])
