"""The port's DeepSeek-V2 family against the JAX package's.

Tiny configs as in ``tests/test_deepseek.py`` (3 layers, the first dense,
hidden 64, 4 heads, kv_lora 16, nope 32, rope 16, 8 experts, top 2, 2
shared), f32 on both sides, the same seeded numpy inputs:

* ``DeepseekConfig.from_hf`` equals the JAX package's field for field and
  raises where it raises;
* ``apply_rope_interleaved`` within 1e-6;
* paged forward logits within 2e-4 of the JAX model and of transformers'
  ``DeepseekV2ForCausalLM``, with and without q-LoRA, absorbed and
  expanded cache forms;
* the MoE block, greedy and group-limited routing, within 2e-4 (expert ids
  exact, weights within 1e-6);
* the int8 cache: codes equal to JAX's, scales within 1e-5, logits within
  ``tests/test_deepseek.py``'s int8 tolerance of the JAX int8 forward, and
  the same greedy token as the f32 cache;
* ``EngineCore`` greedy streams token-identical to the JAX engine's with an
  f32 cache, an int8 cache, and ``prefill_token_budget`` (which this family
  serves on the per-request path in both packages), and JSON-mode, choice,
  regex and seeded streams on a 2-layer model identical to the JAX
  engine's;
* ``deepseek_params_from_jax`` carries the JAX init tree over exactly and
  refuses a wrong name or shape; ``deepseek_init_params`` draws the same
  names, shapes and spread.

Transformers models, JAX models and JAX outputs are built in module-scoped
fixtures, so their cost is set-up, not a test's call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models import deepseek as jds
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.models import deepseek as ds
from dynamo_tpu_torch.models.convert import deepseek_init_params, deepseek_params_from_jax

LOGIT_ATOL = 2e-4
ROPE_ATOL = 1e-6
WEIGHT_ATOL = 1e-6
SCALE_ATOL = 1e-5
INT8_ATOL, INT8_RTOL = 0.15, 0.1  # tests/test_deepseek.py's int8-cache bounds
BLOCK = 16
PROMPT = [3, 17, 9, 41, 5, 88, 23, 7, 60, 11]
HF_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
             n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
             routed_scaling_factor=1.5, kv_lora_rank=16, qk_nope_head_dim=32,
             qk_rope_head_dim=16, v_head_dim=32, norm_topk_prob=False, first_k_dense_replace=1,
             moe_layer_freq=1, max_position_embeddings=256, attention_bias=False,
             aux_loss_alpha=0.0)
IMPLS = ("absorbed", "expanded")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _configs(attn_impl="absorbed", **kw):
    """(JAX config, port config): the tiny config in f32."""
    d = {**HF_KW, **kw}
    d["num_layers"] = d.pop("num_hidden_layers")
    d["num_heads"] = d.pop("num_attention_heads")
    fields = {f.name for f in dataclasses.fields(ds.DeepseekConfig)}
    d = {k: v for k, v in d.items() if k in fields}
    return (jds.DeepseekConfig(**d, dtype="float32", attn_impl=attn_impl),
            ds.DeepseekConfig(**d, dtype="float32", attn_impl=attn_impl))


def _perturbed_tree(jcfg, seed):
    """The JAX init tree with every leaf perturbed (unit norm scales would
    hide bugs), as numpy arrays."""
    tree = jax.tree.map(np.asarray, jds.DeepseekModel(jcfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), tree)


def _port(cfg, tree):
    return ds.DeepseekModel.from_state(cfg, deepseek_params_from_jax(tree, cfg, device="cpu"))


def _jax_paged(model, params, prompt, cache_dtype=None):
    """(logits [S, V], cache) of a full-prompt forward over fresh blocks."""
    s = len(prompt)
    nb = -(-s // BLOCK) + 1
    cache = model.init_kv_cache(nb, BLOCK, dtype=cache_dtype)
    pos = jnp.arange(s, dtype=jnp.int32)[None]
    hidden, cache = model.forward(params, jnp.asarray([prompt], jnp.int32), pos, cache,
                                  jnp.arange(nb, dtype=jnp.int32)[None],
                                  jnp.asarray([s], jnp.int32), pos)
    return np.asarray(model.compute_logits(params, hidden))[0], jax.tree.map(np.asarray, cache)


def _port_paged(model, prompt, cache_dtype=None):
    s = len(prompt)
    nb = -(-s // BLOCK) + 1
    cache = model.init_kv_cache(nb, BLOCK, cache_dtype)
    pos = torch.arange(s, dtype=torch.int32)[None]
    hidden, cache = model.forward(torch.tensor([prompt], dtype=torch.int32), pos, cache,
                                  torch.arange(nb, dtype=torch.int32)[None],
                                  torch.tensor([s], dtype=torch.int32), pos.clone())
    return model.compute_logits(hidden[0]).numpy(), cache


# ------------------------------------------------------------------- config
REFUSED = {
    "moe_layer_freq": {"moe_layer_freq": 2},
    "rope_scaling": {"rope_scaling": {"type": "yarn", "factor": 40}},
    "topk_method": {"topk_method": "noaux_tc"},
    "norm_topk_prob": {"norm_topk_prob": True},
    "scoring_func": {"scoring_func": "sigmoid"},
    "attention_bias": {"attention_bias": True},
}


def test_from_hf_equals_jax():
    for kw in ({}, {"q_lora_rank": 24, "topk_method": "group_limited_greedy", "n_group": 4,
                    "topk_group": 2}):
        d = {**HF_KW, **kw}
        port, ref = ds.DeepseekConfig.from_hf(d), jds.DeepseekConfig.from_hf(d)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for prop in ("qk_head_dim", "num_kv_heads", "head_dim"):
            assert getattr(port, prop) == getattr(ref, prop)
    assert ds.DeepseekConfig.from_hf(HF_KW).torch_dtype == torch.bfloat16
    expanded = dataclasses.replace(ds.DeepseekConfig.from_hf(HF_KW), attn_impl="expanded")
    assert (expanded.num_kv_heads, expanded.head_dim) == (4, 48)


@pytest.mark.parametrize("bad", sorted(REFUSED))
def test_from_hf_refuses_what_jax_refuses(bad):
    d = {**HF_KW, **REFUSED[bad]}
    with pytest.raises(NotImplementedError) as ref:
        jds.DeepseekConfig.from_hf(d)
    with pytest.raises(NotImplementedError) as got:
        ds.DeepseekConfig.from_hf(d)
    assert str(got.value) == str(ref.value)


def test_rope_interleaved_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    inv = jds.rope_inv_freq(16, 10000.0)
    ref = jds.apply_rope_interleaved(jnp.asarray(x), jnp.asarray(pos), inv)
    got = ds.apply_rope_interleaved(_t(x), _t(pos), _t(np.asarray(inv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ROPE_ATOL)
    assert ds.apply_rope_interleaved(_t(x).to(torch.bfloat16), _t(pos),
                                     _t(np.asarray(inv))).dtype == torch.bfloat16


# ------------------------------------------------------------------ forward
@pytest.fixture(scope="module")
def hf_models():
    """{q_lora: (transformers model, its logits on PROMPT, JAX params tree
    converted from it by the JAX package)}."""
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    out = {}
    for q_lora in (None, 24):
        torch.manual_seed(0)
        hf_cfg = DeepseekV2Config(**HF_KW, q_lora_rank=q_lora)
        hf = DeepseekV2ForCausalLM(hf_cfg).eval()
        with torch.no_grad():
            want = hf(torch.tensor([PROMPT])).logits[0].numpy()
        jcfg = jds.DeepseekConfig.from_hf(hf_cfg)
        jcfg.dtype = "float32"
        sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
        tree = jax.tree.map(np.asarray, jds.convert_hf_state_dict(sd, jcfg))
        out[q_lora] = (hf_cfg, want, tree)
    return out


@pytest.fixture(scope="module")
def jax_logits(hf_models):
    """{(q_lora, attn_impl): the JAX model's paged logits on PROMPT}."""
    out = {}
    for q_lora, (_, _, tree) in hf_models.items():
        for impl in IMPLS:
            jcfg, _ = _configs(impl, q_lora_rank=q_lora)
            out[q_lora, impl] = _jax_paged(jds.DeepseekModel(jcfg), jax.tree.map(jnp.asarray, tree),
                                           PROMPT)[0]
    return out


@pytest.mark.parametrize("attn_impl", IMPLS)
@pytest.mark.parametrize("q_lora", [None, 24])
def test_forward_matches_jax_and_transformers(hf_models, jax_logits, q_lora, attn_impl):
    hf_cfg, want, tree = hf_models[q_lora]
    cfg = ds.DeepseekConfig.from_hf(hf_cfg)
    cfg.dtype, cfg.attn_impl = "float32", attn_impl
    got, cache = _port_paged(_port(cfg, tree), PROMPT)
    assert cache.shape[-1] == (16 + 16 if attn_impl == "absorbed" else 4 * 48)
    np.testing.assert_allclose(got, jax_logits[q_lora, attn_impl], atol=LOGIT_ATOL)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)


def test_init_kv_cache_forms():
    _, cfg = _configs()
    model = _port(cfg, _perturbed_tree(_configs()[0], 0))
    assert tuple(model.init_kv_cache(5, BLOCK).shape) == (3, 5, 2, BLOCK, 16 + 16)
    q8 = model.init_kv_cache(5, 32, "int8")
    assert q8.data.dtype == torch.int8 and tuple(q8.scale.shape) == (3, 5, 2, 8, 128)
    with pytest.raises(NotImplementedError, match="MLA cache dtype"):
        model.init_kv_cache(5, BLOCK, "bfloat16")
    _, ecfg = _configs("expanded")
    emodel = _port(ecfg, _perturbed_tree(_configs("expanded")[0], 0))
    assert tuple(emodel.init_kv_cache(5, BLOCK).shape) == (3, 5, 2, BLOCK, 4 * 48)
    assert tuple(emodel.init_kv_cache(5, BLOCK, "int8").scale.shape) == (3, 5, 2, 8, 128)


# ---------------------------------------------------------------------- MoE
@pytest.mark.parametrize("routing", ["greedy", "group_limited_greedy"])
def test_moe_block_matches_jax(routing):
    """One MoE layer's block on 11 tokens: the router's expert ids exactly
    and weights within 1e-6, the block within 2e-4.  Group-limited keeps 2
    of 4 groups of 2 experts, so at least 4 experts score above 0 for a
    top 2."""
    kw = dict(topk_method=routing, n_group=4, topk_group=2) if routing != "greedy" else {}
    jcfg, cfg = _configs(**kw)
    tree = _perturbed_tree(jcfg, 2)
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["moe_layers"])
    lp = _port(cfg, tree)._layer("moe_layers", 0)
    x = np.random.default_rng(3).normal(size=(1, 11, 64)).astype(np.float32)
    ref = jds.DeepseekModel(jcfg)._moe_mlp(jlp, jnp.asarray(x))
    np.testing.assert_allclose(ds._moe_mlp(cfg, lp, _t(x)).numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL)
    # the JAX router, step by step (deepseek.py:490-502)
    scores = jax.nn.softmax(jnp.asarray(x[0]) @ jlp["router"], axis=-1)
    if routing != "greedy":
        _, gidx = jax.lax.top_k(scores.reshape(11, 4, 2).max(-1), 2)
        gmask = jnp.zeros((11, 4)).at[jnp.arange(11)[:, None], gidx].set(1.0)
        scores = scores * jnp.repeat(gmask, 2, axis=-1)
    jw, ji = jax.lax.top_k(scores, 2)
    w, i = ds._moe_router(cfg, lp, _t(x[0]))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw) * 1.5, atol=WEIGHT_ATOL)
    logits = ds.router_logits(lp, _t(x[0]))
    np.testing.assert_allclose(ds.router_weights(cfg, logits, i).numpy(), w.numpy(),
                               atol=WEIGHT_ATOL)


# --------------------------------------------------------------------- int8
@pytest.fixture(scope="module")
def int8_refs():
    """{attn_impl: (JAX config, tree, JAX int8 logits and cache, JAX f32
    logits)} on PROMPT."""
    out = {}
    for impl in IMPLS:
        jcfg, _ = _configs(impl)
        tree = _perturbed_tree(jcfg, 1)
        jmodel, params = jds.DeepseekModel(jcfg), jax.tree.map(jnp.asarray, tree)
        out[impl] = (tree, *_jax_paged(jmodel, params, PROMPT, "int8"),
                     _jax_paged(jmodel, params, PROMPT)[0])
    return out


@pytest.mark.parametrize("attn_impl", IMPLS)
def test_int8_cache_matches_jax(int8_refs, attn_impl):
    tree, ref, jcache, ref_f32 = int8_refs[attn_impl]
    got, cache = _port_paged(_port(_configs(attn_impl)[1], tree), PROMPT, "int8")
    np.testing.assert_array_equal(cache.data.numpy(), jcache.data)
    np.testing.assert_allclose(cache.scale.numpy(), jcache.scale, atol=SCALE_ATOL)
    np.testing.assert_allclose(got, ref, atol=INT8_ATOL, rtol=INT8_RTOL)
    assert int(np.argmax(got[-1])) == int(np.argmax(ref_f32[-1]))


# ------------------------------------------------------------------- engine
EOS = 2
BASE = dict(max_batch_size=4, max_model_len=128, num_blocks=48, block_size=BLOCK,
            prefill_buckets=[32, 64, 128], decode_steps=4, prefill_chunk_tokens=32)
ENGINE_CONFIGS = {"f32": {}, "int8": {"cache_dtype": "int8"},
                  "token-budget": {"prefill_token_budget": 64}}
COUNTERS = ("prefill_dispatches_total", "unified_dispatches_total", "lookahead_bursts_total",
            "device_gets_total", "tokens_generated")


def _run(core, request_cls, proto, specs):
    outs = {rid: [] for rid, *_ in specs}
    reqs = [request_cls(request_id=rid, prompt=list(prompt),
                        sampling=proto.SamplingOptions(temperature=0.0),
                        stops=proto.StopConditions(max_tokens=max_tokens),
                        emit=outs[rid].append)
            for rid, prompt, max_tokens in specs]
    for r in reqs[:2]:
        core.submit(r)
    for _ in range(3):
        core.step()
    for r in reqs[2:]:
        core.submit(r)
    for _ in range(1000):
        if not core.step():
            break
    return {rid: ([t for o in v for t in o.token_ids], v[-1].finish_reason.value,
                  [o.cached_tokens for o in v]) for rid, v in outs.items()}


@pytest.fixture(scope="module")
def engine_models():
    jcfg, cfg = _configs()
    tree = _perturbed_tree(jcfg, 4)
    return jds.DeepseekModel(jcfg), jax.tree.map(jnp.asarray, tree), _port(cfg, tree)


@pytest.mark.parametrize("config", sorted(ENGINE_CONFIGS))
def test_engine_streams_match_jax(engine_models, config):
    """Requests arriving while others decode, a 48-token prompt chunked in
    32s, and a shared 32-token prefix, greedy: the same tokens, finish
    reasons, cached-prefix counts and dispatch counters as the JAX engine.
    With a token budget neither engine packs prompts for this family."""
    jmodel, jparams, model = engine_models
    rng = np.random.RandomState(7)
    shared = [int(v) for v in rng.randint(3, 96, size=32)]
    specs = [("long", [int(v) for v in rng.randint(3, 96, size=48)], 6),
             ("a", shared + [5, 9, 11], 9),
             ("short", [int(v) for v in rng.randint(3, 96, size=12)], 10),
             ("b", shared + [7, 7], 8)]
    kw = {**BASE, **ENGINE_CONFIGS[config]}
    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**kw), eos_token_ids=[EOS])
    try:
        core = EngineCore(model, EngineConfig(**kw), eos_token_ids=[EOS], device="cpu")
        ref = _run(jcore, JaxEngineRequest, jax_protocols, specs)
        out = _run(core, EngineRequest, protocols, specs)
        jm = jcore.metrics()
    finally:
        jcore.close()
    assert out == ref
    assert max(out["b"][2]) >= 32  # the shared prefix came from the cache
    pm = core.metrics()
    assert {k: pm[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert pm["unified_dispatches_total"] == 0
    if config == "token-budget":
        # one request per prefill dispatch: "long" (48) and "a" (35) in two
        # chunks of up to 32 each, "short" in one, "b" past its cached prefix in one
        assert pm["prefill_dispatches_total"] == 6


def _grammar_specs():
    """(id, prompt, sampling options, max_tokens): JSON mode greedy and
    seeded, a seeded choice, a greedy regex and a seeded free row."""
    rng = np.random.RandomState(11)
    p = lambda n: [int(v) for v in rng.randint(3, 96, size=n)]  # noqa: E731
    return [("json", p(20), dict(temperature=0.0, json_mode=True), 12),
            ("json_s", p(9), dict(temperature=1.0, seed=5, json_mode=True), 12),
            ("choice", p(14), dict(temperature=1.0, seed=9, guided_choice=["yes", "no"]), 6),
            ("regex", p(6), dict(temperature=0.0, guided_regex=r"[0-9][0-9]?-[a-z]+"), 8),
            ("free", p(11), dict(temperature=0.8, seed=3, top_p=0.9), 10)]


def _grammar_run(core, request_cls, proto, specs):
    outs = {rid: [] for rid, *_ in specs}
    for rid, prompt, sampling, n in specs:
        core.submit(request_cls(request_id=rid, prompt=prompt,
                                sampling=proto.SamplingOptions(**sampling),
                                stops=proto.StopConditions(max_tokens=n), emit=outs[rid].append))
    for _ in range(1000):
        if not core.step():
            break
    return {rid: ([t for o in v for t in o.token_ids], v[-1].finish_reason.value)
            for rid, v in outs.items()}


# ids 3..95 are the printable bytes '!'..'}' (JSON needs no whitespace)
GRAMMAR_TOKENS = [None] * 3 + [bytes([c]) for c in range(33, 126)]


@pytest.fixture(scope="module")
def grammar_refs():
    """A 2-layer model (one dense layer, one MoE layer) and the JAX
    engine's streams of ``_grammar_specs``, made once."""
    from dynamo_tpu.engine.grammar import JsonGrammar as JaxJsonGrammar

    jcfg, cfg = _configs(num_hidden_layers=2)
    tree = _perturbed_tree(jcfg, 6)
    jcore = JaxEngineCore(jds.DeepseekModel(jcfg), jax.tree.map(jnp.asarray, tree),
                          JaxEngineConfig(**BASE), eos_token_ids=[EOS],
                          grammar=JaxJsonGrammar.from_token_bytes(GRAMMAR_TOKENS, [EOS]))
    try:
        ref = _grammar_run(jcore, JaxEngineRequest, jax_protocols, _grammar_specs())
    finally:
        jcore.close()
    return _port(cfg, tree), ref


def test_grammar_and_seeded_streams_match_jax(grammar_refs):
    """DeepSeek's per-request path serves constrained and seeded requests:
    the same tokens and finish reasons as the JAX engine."""
    from dynamo_tpu_torch.engine.grammar import JsonGrammar

    model, ref = grammar_refs
    core = EngineCore(model, EngineConfig(**BASE), eos_token_ids=[EOS], device="cpu",
                      grammar=JsonGrammar.from_token_bytes(GRAMMAR_TOKENS, [EOS]))
    out = _grammar_run(core, EngineRequest, protocols, _grammar_specs())
    assert out == ref
    assert all(reason != "error" for _, reason in out.values())
    if out["choice"][1] == "eos":
        assert b"".join(GRAMMAR_TOKENS[t] for t in out["choice"][0][:-1]) in (b"yes", b"no")


# --------------------------------------------------------------- parameters
def test_params_from_jax_exact_and_checked():
    for kw in ({}, {"q_lora_rank": 24}):
        jcfg, cfg = _configs(**kw)
        tree = jax.tree.map(np.asarray, jds.DeepseekModel(jcfg).init_params(jax.random.PRNGKey(9)))
        state = deepseek_params_from_jax(tree, cfg, device="cpu")
        flat = {k: v for k, v in tree.items() if not isinstance(v, dict)}
        for group in ds.GROUPS:
            flat.update({f"{group}.{k}": v for k, v in tree[group].items()})
        assert set(state) == set(flat) == set(ds.param_shapes(cfg))
        for name, v in flat.items():
            np.testing.assert_array_equal(state[name].numpy(), v)
    bad = dict(tree, moe_layers=dict(tree["moe_layers"], extra=tree["moe_layers"]["router"]))
    with pytest.raises(ValueError, match="do not match"):
        deepseek_params_from_jax(bad, cfg, device="cpu")
    bad = dict(tree, lm_head=tree["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head: shape"):
        deepseek_params_from_jax(bad, cfg, device="cpu")


def test_init_params_match_jax_tree():
    jcfg, cfg = _configs(q_lora_rank=24)
    cfg.dtype = "bfloat16"
    tree = jds.DeepseekModel(jcfg).init_params(jax.random.PRNGKey(0))
    flat = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    for group in ds.GROUPS:
        flat.update({f"{group}.{k}": v for k, v in tree[group].items()})
    gen = torch.Generator()
    gen.manual_seed(0)
    state = deepseek_init_params(cfg, gen, device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: v.shape for k, v in flat.items()}
    assert all(v.dtype == torch.bfloat16 for v in state.values())
    assert all(bool((state[k] == 1).all()) for k in state if k.endswith("norm"))
    for name, fan_in in (("moe_layers.w_down", 32), ("moe_layers.router", 64), ("embed", 64)):
        assert 0.8 < state[name].float().std().item() * np.sqrt(fan_in) < 1.2
    assert isinstance(ds.DeepseekModel.from_state(cfg, state), ds.DeepseekModel)
