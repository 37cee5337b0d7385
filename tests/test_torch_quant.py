"""The port's int8 weight-only serving against the JAX package's.

Seeded numpy inputs (f32) go to both packages:

* ``quantize``, ``take_rows``, ``quantize_params`` and the plain ``matmul``
  against ``dynamo_tpu/models/quant.py``: int8 codes exact, values to 1e-5;
* the W8A16 kernel's plain version (``int8_matmul_ref``) against the
  Pallas kernel ``int8_matmul`` in interpret mode, within that kernel's own
  test tolerance (rtol 5e-2, atol 0.5: the Pallas kernel multiplies in
  bf16), and against the JAX package's XLA path within 1e-4 (both f32), for
  a ``[K, N]`` weight and for the transpose of a per-row ``[N, K]`` one (the
  tied embedding as the lm_head);
* ``params_from_jax`` on a quantised tree (exact), and
  ``init_params(quantized=True)`` against the JAX init's structure;
* the int8 Llama forward (int8 weights and an int8 KV cache, tied and
  untied lm_head): hidden states and logits within 1e-4 (f32 on both
  sides), the cache's scales within 1e-5 and its codes within one step (a
  hidden state 1e-6 away from a rounding boundary may quantise to the
  neighbouring code);
* the engine's greedy streams and ``metrics()`` counters against the JAX
  ``EngineCore`` with ``quantize_params`` weights and ``cache_dtype="int8"``,
  on the default path and with ``prefill_token_budget``, unified and
  lookahead dispatch;
* the int8 kernels' wrappers raise on a ``meta`` tensor and count no
  launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models import quant as jax_quant
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.ops.pallas.int8_matmul import int8_matmul as pallas_int8_matmul
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.models import quant
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import init_params, params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.ops.kernels.decode_attention import paged_decode_attention_q8
from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref
from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention_q8
from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
    ragged_paged_prefill_attention_q8,
)
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache

VALUE_ATOL = 1e-5
HIDDEN_ATOL = 1e-4
EOS = 2
TIED = dict(tie_word_embeddings=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ quant.py
@pytest.mark.parametrize("shape,axes", [((48, 40), (-1,)), ((3, 40, 24), (0, 2)), ((50, 16), (0,))])
def test_quantize_and_dequantize_match_jax(shape, axes):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w[..., 0] = 0.0  # a zero column: the 1e-8 floor for a per-row scale
    ref = jax_quant.quantize(jnp.asarray(w), axes)
    out = quant.quantize(_t(w), axes)
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    assert out.scale.shape == ref.scale.shape
    np.testing.assert_allclose(out.scale.numpy(), np.asarray(ref.scale), rtol=VALUE_ATOL, atol=0)
    np.testing.assert_allclose(quant.dequantize(out, torch.float32).numpy(),
                               np.asarray(jax_quant.dequantize(ref, jnp.float32)), atol=VALUE_ATOL)


def test_take_rows_and_plain_matmul_match_jax():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(50, 16)).astype(np.float32)
    w = rng.normal(size=(16, 24)).astype(np.float32)
    idx = rng.integers(0, 50, size=(2, 5)).astype(np.int32)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    je, jw = jax_quant.quantize(jnp.asarray(emb), (0,)), jax_quant.quantize(jnp.asarray(w))
    te, tw = quant.quantize(_t(emb), (0,)), quant.quantize(_t(w))
    np.testing.assert_allclose(quant.take_rows(te, _t(idx), torch.float32).numpy(),
                               np.asarray(jax_quant.take_rows(je, jnp.asarray(idx), jnp.float32)),
                               atol=VALUE_ATOL)
    np.testing.assert_allclose(quant.matmul(_t(x), tw).numpy(),
                               np.asarray(jax_quant.matmul(jnp.asarray(x), jw)), atol=VALUE_ATOL)
    # the tied lm_head: the per-row embedding transposed, f32 out
    jt = jax_quant.QTensor(je.q.T, je.scale.T)
    ref = jax_quant.matmul(jnp.asarray(x), jt, preferred_element_type=jnp.float32)
    out = quant.matmul(_t(x), te.t(), out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=VALUE_ATOL)


def test_quantize_params_matches_jax():
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(3)))
    ref = jax_quant.quantize_params(params)
    out = quant.quantize_params(jax.tree.map(_t, params))
    flat_ref = {**{k: v for k, v in ref.items() if k != "layers"}, **ref["layers"]}
    flat_out = {**{k: v for k, v in out.items() if k != "layers"}, **out["layers"]}
    assert set(flat_ref) == set(flat_out)
    for name, r in flat_ref.items():
        o = flat_out[name]
        assert isinstance(o, quant.QTensor) == isinstance(r, jax_quant.QTensor), name
        if isinstance(r, jax_quant.QTensor):
            np.testing.assert_array_equal(o.q.numpy(), np.asarray(r.q))
            np.testing.assert_allclose(o.scale.numpy(), np.asarray(r.scale), rtol=VALUE_ATOL)
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


# --------------------------------------------- the W8A16 kernel's plain version
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_int8_matmul_ref_matches_pallas_and_xla(layout):
    rng = np.random.default_rng(4)
    m, k, n = 8, 256, 384
    x = rng.normal(size=(m, k)).astype(np.float32)
    if layout == "kn":  # a projection [K, N], per-column scales
        jq = jax_quant.quantize(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)))
    else:  # the tied lm_head: a per-row [N, K] embedding, transposed
        je = jax_quant.quantize(jnp.asarray(rng.normal(size=(n, k)).astype(np.float32)), (0,))
        jq = jax_quant.QTensor(je.q.T, je.scale.T)
    xla = np.asarray(jax_quant.matmul(jnp.asarray(x), jq, preferred_element_type=jnp.float32))
    pallas = np.asarray(pallas_int8_matmul(jnp.asarray(x), jq.q, jnp.squeeze(jq.scale, axis=-2),
                                           out_dtype=jnp.float32, interpret=True))
    wq = _t(np.asarray(jq.q)) if layout == "kn" else _t(np.asarray(je.q)).t()
    assert wq.is_contiguous() == (layout == "kn")
    scale = _t(np.asarray(jnp.squeeze(jq.scale, axis=-2)))
    out = int8_matmul_ref(_t(x), wq, scale, torch.float32)
    np.testing.assert_allclose(out.numpy(), xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), pallas, rtol=5e-2, atol=0.5)
    # on CPU tensors the wrapper is the plain version: same bits, no launch
    before = int8_matmul.launches
    torch.testing.assert_close(int8_matmul(_t(x), wq, scale, torch.float32), out, rtol=0, atol=0)
    assert int8_matmul.launches == before


# ------------------------------------------------------ parameters and model
def _jax_quant_params(kw=None, seed=0):
    jmodel = JaxLlamaModel(JaxModelConfig.tiny(**(kw or {})))
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    # perturb every leaf: zero biases and unit norm scales would hide bugs
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), tree)
    return jmodel, jax.tree.map(np.asarray, jax_quant.quantize_params(tree))


def test_params_from_jax_carries_quantized_leaves_exactly():
    _, qtree = _jax_quant_params(TIED)
    cfg = ModelConfig.tiny(**TIED)
    state = params_from_jax(qtree, cfg, device="cpu")
    for name, leaf in [("embed", qtree["embed"])] + [
            (f"layers.{k}", v) for k, v in qtree["layers"].items()]:
        if isinstance(leaf, jax_quant.QTensor):
            assert state[name].dtype == torch.int8 and state[name + "_scale"].dtype == torch.float32
            np.testing.assert_array_equal(state[name].numpy(), leaf.q)
            np.testing.assert_array_equal(state[name + "_scale"].numpy(), leaf.scale)
        else:
            np.testing.assert_array_equal(state[name].numpy(), leaf)
    assert LlamaModel.from_state(cfg, state).quantized


@pytest.mark.parametrize("tied", [False, True])
def test_init_params_quantized_matches_jax_structure(tied):
    kw = TIED if tied else {}
    jtree = JaxLlamaModel(JaxModelConfig.tiny(**kw)).init_params(jax.random.PRNGKey(0),
                                                                   quantized=True)
    flat = {**{k: v for k, v in jtree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in jtree["layers"].items()}}
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_params(ModelConfig.tiny(**kw), gen, device="cpu", quantized=True)
    expect = {}
    for name, leaf in flat.items():
        if isinstance(leaf, jax_quant.QTensor):
            expect[name] = (tuple(leaf.q.shape), torch.int8)
            expect[name + "_scale"] = (tuple(leaf.scale.shape), torch.float32)
            np.testing.assert_allclose(state[name + "_scale"].numpy(), np.asarray(leaf.scale),
                                       rtol=VALUE_ATOL)
        else:
            expect[name] = (tuple(leaf.shape), torch.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == expect
    codes = torch.cat([v.flatten().float() for k, v in state.items() if v.dtype == torch.int8])
    assert codes.min() >= -127 and codes.max() <= 127 and 60 < codes.std() < 85


def _dispatches(prompt, bs, m):
    """(tokens, positions, block_tables, seq_lens, slot_idx, prefix_blocks,
    last index) of a prefill of 16 tokens, a prefix-fast-path prefill of
    the next 13 over those cached blocks, and one decode step."""
    bt = np.zeros((1, m), np.int32)
    bt[0, :4] = [3, 6, 1, 4]

    def one(start, toks, pad, prefix_blocks):
        n = len(toks)
        t = np.zeros((1, pad), np.int32)
        t[0, :n] = toks
        pos = np.zeros((1, pad), np.int32)
        pos[0, :n] = np.arange(start, start + n)
        slot = np.full((1, pad), -1, np.int32)
        slot[0, :n] = bt[0, pos[0, :n] // bs] * bs + pos[0, :n] % bs
        return t, pos, bt, np.array([start + n], np.int32), slot, prefix_blocks, n - 1

    return [one(0, prompt[:16], 16, 0), one(16, prompt[16:29], 16, 16 // bs),
            one(29, prompt[29:30], 1, None)]


@pytest.mark.parametrize("tied", [False, True])
def test_int8_forward_matches_jax(tied):
    kw = TIED if tied else {}
    jmodel, qtree = _jax_quant_params(kw)
    cfg = ModelConfig.tiny(**kw)
    model = LlamaModel.from_state(cfg, params_from_jax(qtree, cfg, device="cpu"))
    jparams = jax.tree.map(jnp.asarray, qtree)
    bs, n_blocks, m = 8, 8, 6
    jcache = jmodel.init_kv_cache(n_blocks, bs, "int8")
    cache = model.init_kv_cache(n_blocks, bs, "int8")
    assert isinstance(cache, QuantKvCache) and cache.scale.shape == (2, n_blocks, 2, 8, 128)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 30)
    for t, pos, bt, lens, slot, pb, last in _dispatches(prompt, bs, m):
        jh, jcache = jmodel.forward(jparams, jnp.asarray(t), jnp.asarray(pos), jcache,
                                    jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(slot),
                                    prefix_blocks=pb)
        h, _ = model.forward(_t(t), _t(pos), cache, _t(bt), _t(lens), _t(slot), prefix_blocks=pb)
        n = int(lens[0] - pos[0, 0])
        np.testing.assert_allclose(h.numpy()[:, :n], np.asarray(jh)[:, :n], atol=HIDDEN_ATOL)
        ref = np.asarray(jmodel.compute_logits(jparams, jh[:, last]))
        out = model.compute_logits(h[:, last])
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=HIDDEN_ATOL)
    np.testing.assert_allclose(cache.scale.numpy(), np.asarray(jcache.scale), rtol=VALUE_ATOL)
    codes = cache.data.numpy().astype(np.int32) - np.asarray(jcache.data).astype(np.int32)
    assert np.abs(codes).max() <= 1 and (codes != 0).mean() < 1e-2


# -------------------------------------------------------------------- engine
BASE = dict(max_batch_size=8, max_model_len=128, num_blocks=48, cache_dtype="int8",
            prefill_buckets=[32, 64, 128])
CONFIGS = {
    "default": dict(block_size=16, prefill_chunk_tokens=32, decode_steps=4),
    "token-budget": dict(block_size=32, prefill_chunk_tokens=32, prefill_token_budget=64,
                         unified_token_dispatch=True, lookahead_dispatch=True, decode_steps=8),
}
COUNTERS = ("prefill_dispatches_total", "prefill_batch_occupancy", "prefill_budget_utilization",
            "unified_dispatches_total", "unified_decode_rows", "unified_prefill_tokens",
            "unified_budget_utilization", "lookahead_bursts_total", "lookahead_hits_total",
            "lookahead_mispredicts_total", "lookahead_commits_total", "lookahead_flushes_total",
            "lookahead_dispatch_depth", "device_gets_total", "tokens_generated",
            "kv_active_blocks", "request_active_slots")


def _run(core, request_cls, proto, specs, head, stagger):
    outs = {rid: [] for rid, *_ in specs}
    reqs = [request_cls(request_id=rid, prompt=list(prompt),
                        sampling=proto.SamplingOptions(**sampling),
                        stops=proto.StopConditions(max_tokens=max_tokens),
                        emit=outs[rid].append)
            for rid, prompt, sampling, max_tokens in specs]
    for r in reqs[:head]:
        core.submit(r)
    for _ in range(stagger):
        core.step()
    for r in reqs[head:]:
        core.submit(r)
    for _ in range(1000):
        if not core.step():
            break
    return {rid: ([t for o in v for t in o.token_ids], v[-1].finish_reason.value,
                  [o.cached_tokens for o in v]) for rid, v in outs.items()}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_int8_engine_streams_and_counters_match_jax(config):
    """Requests arriving while others decode, a shared 32-token prefix (a
    prefix-cache hit over int8 blocks), a penalised and a logprobs request,
    all greedy."""
    jmodel, qtree = _jax_quant_params()
    cfg = ModelConfig.tiny()
    model = LlamaModel.from_state(cfg, params_from_jax(qtree, cfg, device="cpu"))
    rng = np.random.RandomState(7)
    shared = [int(x) for x in rng.randint(3, 250, size=32)]
    specs = [
        ("long", [int(x) for x in rng.randint(3, 250, size=45)], dict(temperature=0.0), 6),
        ("a", shared + [5, 9, 11], dict(temperature=0.0), 9),
        ("pen", [int(x) for x in rng.randint(3, 250, size=12)],
         dict(temperature=0.0, frequency_penalty=0.7, presence_penalty=0.3), 10),
        ("lp", [int(x) for x in rng.randint(3, 250, size=10)],
         dict(temperature=0.0, logprobs=True, top_logprobs=3), 6),
        ("b", shared + [7, 7], dict(temperature=0.0), 8),
    ]
    kw = {**BASE, **CONFIGS[config]}
    jcore = JaxEngineCore(jmodel, jax.tree.map(jnp.asarray, qtree), JaxEngineConfig(**kw),
                          eos_token_ids=[EOS])
    core = EngineCore(model, EngineConfig(**kw), eos_token_ids=[EOS], device="cpu")
    assert core.cache_quant and isinstance(core.cache, QuantKvCache)
    ref = _run(jcore, JaxEngineRequest, jax_protocols, specs, head=2, stagger=3)
    out = _run(core, EngineRequest, protocols, specs, head=2, stagger=3)
    assert out == ref
    assert all(reason == "length" for _, reason, _ in out.values())
    assert max(out["b"][2]) >= 32  # the shared prefix came from the cache
    jm, pm = jcore.metrics(), core.metrics()
    assert {k: pm[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    if config == "token-budget":
        assert pm["unified_dispatches_total"] > 0 and pm["lookahead_bursts_total"] > 0


def test_engine_refuses_other_cache_dtypes():
    cfg = ModelConfig.tiny()
    gen = torch.Generator()
    model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cpu", quantized=True))
    with pytest.raises(ValueError, match="cache_dtype"):
        EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8, cache_dtype="fp8"),
                   device="cpu")
    core = EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8, cache_dtype="int8"),
                      device="cpu")
    assert core.cache_quant


# ------------------------------------------------------------------ wrappers
def test_int8_wrappers_raise_off_cuda_and_cpu():
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    b, s, h, hk, d, bs = 2, 4, 8, 2, 128, 32
    cache = QuantKvCache(meta(3, 8, 2, bs, hk * d, dtype=torch.int8),
                         meta(3, 8, 2, 8, 128, dtype=torch.float32))
    ints = meta(b, dtype=torch.int32)
    bt = meta(b, 4, dtype=torch.int32)
    wrappers = (paged_decode_attention_q8, paged_prefill_attention_q8,
                ragged_paged_prefill_attention_q8, int8_matmul)
    before = [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_decode_attention_q8(meta(b, 1, h, d), cache, 1, bt, ints, ints)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_prefill_attention_q8(meta(b, s, h, d), meta(b, s, hk, d), meta(b, s, hk, d), cache,
                                   1, bt, ints, ints)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ragged_paged_prefill_attention_q8(meta(1, 32, h, d), meta(1, 32, hk, d),
                                          meta(1, 32, hk, d), cache, 1, bt, ints, ints, ints)
    with pytest.raises(ValueError, match="cuda or cpu"):
        int8_matmul(meta(8, 64), meta(64, 96, dtype=torch.int8), meta(96, dtype=torch.float32))
    assert [w.launches for w in wrappers] == before
