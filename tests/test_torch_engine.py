"""The PyTorch EngineCore and AsyncLLMEngine against the JAX EngineCore.

Both engines serve the same tiny f32 model (the JAX package's random init of
``ModelConfig.tiny()``, carried into the port by ``params_from_jax``) under
the same EngineConfig, on the CPU.  Greedy token streams, finish reasons
and prefix-cache hit lengths must be identical: concurrent requests,
chunked prefill, multi-step decode bursts, a prefix-reuse hit, and the eos,
stop-token, max_tokens and model-length finishes.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.runtime.engine import Context

BASE = dict(max_batch_size=4, max_model_len=96, block_size=8, num_blocks=48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))


def _prompts(seed, lens, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 256, shared).tolist()
    return [head + rng.integers(1, 256, n - shared).tolist() for n in lens]


def _run(core, request_cls, proto, specs):
    """Submit every (request id, prompt, stop kwargs) at once and step the
    core until idle; returns {id: (tokens, finish reason, cached tokens)}."""
    outs = {}
    for rid, prompt, stops in specs:
        outs[rid] = []
        core.submit(request_cls(
            request_id=rid, prompt=list(prompt),
            sampling=proto.SamplingOptions(temperature=0.0),
            stops=proto.StopConditions(**stops), emit=outs[rid].append))
    for _ in range(1000):
        if not core.has_work():
            break
        core.step()
    return {rid: ([t for o in v for t in o.token_ids], v[-1].finish_reason.value,
                  v[-1].cached_tokens) for rid, v in outs.items()}


def _both(models, specs, eos=None, **cfg_kw):
    jmodel, jparams, model = models
    kw = {**BASE, **cfg_kw}
    ref = _run(JaxEngineCore(jmodel, jparams, JaxEngineConfig(**kw), eos_token_ids=eos),
               JaxEngineRequest, jax_protocols, specs)
    out = _run(EngineCore(model, EngineConfig(**kw), eos_token_ids=eos, device="cpu"),
               EngineRequest, protocols, specs)
    return ref, out


@pytest.mark.parametrize("decode_steps,chunk", [(1, 0), (4, 16)])
def test_concurrent_greedy_streams_match_jax(models, decode_steps, chunk):
    prompts = _prompts(0, [5, 27, 40])
    specs = [(f"r{i}", p, dict(max_tokens=n)) for i, (p, n) in enumerate(zip(prompts, [9, 14, 6]))]
    ref, out = _both(models, specs, decode_steps=decode_steps, prefill_chunk_tokens=chunk)
    assert out == ref
    assert all(reason == "length" for _, reason, _ in out.values())


def test_prefix_reuse_hit_matches_jax(models):
    first, second = _prompts(1, [30, 37], shared=24)
    ref, out = _both(models, [("a", first, dict(max_tokens=4))], decode_steps=2)
    assert out == ref
    # the same engines serve the second request after the first finished
    jmodel, jparams, model = models
    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**BASE, decode_steps=2))
    core = EngineCore(model, EngineConfig(**BASE, decode_steps=2), device="cpu")
    for spec in ([("a", first, dict(max_tokens=4))], [("b", second, dict(max_tokens=5))]):
        ref = _run(jcore, JaxEngineRequest, jax_protocols, spec)
        out = _run(core, EngineRequest, protocols, spec)
        assert out == ref
    assert out["b"][2] == 24  # three 8-token blocks came from the cache


def test_finish_reasons_match_jax(models):
    a, b, c, d = _prompts(2, [12, 20, 9, 80])
    # the eos id is a token the model emits mid-stream
    probe, _ = _both(models, [("p", a, dict(max_tokens=8))])
    eos = probe["p"][0][3]
    stop = probe["p"][0][3]
    specs = [("eos", a, dict(max_tokens=8)),
             ("ignore", a, dict(max_tokens=8, ignore_eos=True)),
             ("stop", a, dict(max_tokens=8, stop_token_ids=[stop], ignore_eos=True)),
             ("max", b, dict(max_tokens=3)),
             ("len", d, dict(max_tokens=50)),
             ("c", c, dict(max_tokens=6))]
    ref, out = _both(models, specs, eos=[eos], decode_steps=4)
    assert out == ref
    reasons = {rid: r for rid, (_, r, _) in out.items()}
    assert reasons["eos"] == "eos" and reasons["stop"] == "stop"
    assert reasons["ignore"] == "length" and len(out["ignore"][0]) == 8
    assert reasons["max"] == "length" and len(out["max"][0]) == 3
    assert reasons["len"] == "length" and len(out["len"][0]) == BASE["max_model_len"] - 80


def test_block_exhaustion_matches_jax(models):
    # 12 blocks of 8 tokens for two 40-token prompts: decode growth runs
    # out of blocks mid-burst, and rows stop at their block limit
    specs = [(f"r{i}", p, dict(max_tokens=60)) for i, p in enumerate(_prompts(4, [40, 41]))]
    ref, out = _both(models, specs, decode_steps=4, num_blocks=12)
    assert out == ref
    assert all(reason == "length" and len(toks) < 60 for toks, reason, _ in out.values())


def test_async_engine_streams_match_jax(models):
    jmodel, jparams, model = models
    prompts = _prompts(3, [7, 33, 18])
    specs = [(f"r{i}", p, dict(max_tokens=7)) for i, p in enumerate(prompts)]
    ref = _run(JaxEngineCore(jmodel, jparams, JaxEngineConfig(**BASE, decode_steps=3)),
               JaxEngineRequest, jax_protocols, specs)
    engine = AsyncLLMEngine(
        EngineCore(model, EngineConfig(**BASE, decode_steps=3), device="cpu")).start()

    async def one(rid, prompt, stops):
        ctx = Context(protocols.BackendInput(
            token_ids=prompt, sampling=protocols.SamplingOptions(temperature=0.0),
            stops=protocols.StopConditions(**stops)), id=rid)
        outs = [o async for o in engine.generate(ctx)]
        return rid, ([t for o in outs for t in o.token_ids], outs[-1].finish_reason.value,
                     outs[-1].cached_tokens)

    async def main():
        return dict(await asyncio.gather(*(one(*s) for s in specs)))

    try:
        out = asyncio.run(main())
    finally:
        engine.shutdown()
    assert out == ref
