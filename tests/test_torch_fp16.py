"""float16 serving: the port against the JAX package, and the card's route check.

Seeded numpy inputs go to both packages in float16:

* every kernel module's plain version (the CPU side of the fp16 bodies)
  against the JAX package's Pallas kernel in interpret mode, as
  ``tests/test_pallas_kernels.py`` runs it: B1 and B4a (decode over an fp16
  and an int8 cache) at S = 1 and 4, B2 and B4b (prefill) with and without
  a cached prefix, B3 and B4c (ragged) on a mixed batch of decode rows and
  spans, and B5 (W8A16) for a [K, N] weight and a transposed [N, K] one.
  Both sides compute attention in f32 from fp16 operands and round once to
  fp16: ATOL = 4e-3 is one fp16 ulp at the largest outputs (|out| < 8 over
  the int8 caches, ulp 2^-8), four at |out| < 2, for the two summation
  orders.  B5: the Pallas kernel rounds x to bf16 before the product
  (int8_matmul.py:48); the port's fp16 body and its plain version multiply
  the fp16 x as it is, so the two differ by at most bf16's rounding of x
  (2^-9 relative an element: atol 2^-9 * max sum |x w s|) plus the two
  roundings of the output (rtol 2^-10).  The port is held to the exact
  product (numpy, f64 over the same fp16 x) within its one rounding to
  fp16: rtol 2^-10, atol 2^-10 * max |out| (exact for f32 out but the
  f32 sum's order);
* a 2-layer narrow Llama in float16: ``params_from_jax`` carries the fp16
  parameters exactly, the prefill and decode logits are within
  LOGIT_ATOL = 1e-2 of the JAX model's (fp16 activations rounded at the
  same points in both packages, matmul accumulation order apart: a few fp16
  ulps of the hidden states, carried through the f32 lm_head; |logit| < 4),
  and the engine's greedy streams are token-identical to the JAX
  ``EngineCore`` on the default path, the token-budget path and over an
  int8 cache;
* a native checkpoint stored in float16 loads back in float16, exactly;
* the route check (``engine/core.py::cuda_route_refusal``): on the card an
  fp16 dense model is accepted, a float32 model and an fp16 mixture of
  experts are refused at construction naming the missing kernel, a float
  cache of another dtype than the model's is refused and an int8 cache
  under fp16 accepted; on the CPU everything is accepted.  The wrappers
  have a body for bfloat16 and float16 only (``build.entry``).
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
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.ops import kv_quant as jax_kv_quant
from dynamo_tpu.ops.pallas.decode_attention import paged_decode_attention_mq
from dynamo_tpu.ops.pallas.int8_matmul import int8_matmul as pallas_int8_matmul
from dynamo_tpu.ops.pallas.prefill_attention import paged_prefill_attention as pallas_prefill
from dynamo_tpu.ops.pallas.prefill_attention import ragged_paged_prefill_attention as pallas_ragged
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.core import cuda_route_refusal
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.models.checkpoint import load_checkpoint, save_checkpoint
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.ops import kv_quant
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_q8,
)
from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention,
    paged_prefill_attention_q8,
    prefill_attention_ref,
)
from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
    ragged_paged_prefill_attention,
    ragged_paged_prefill_attention_q8,
    ragged_prefill_attention_ref,
)

ATOL = 4e-3
LOGIT_ATOL = 1e-2
N_LAYERS = 3
EOS = 2
F16 = np.float16


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


def _tables(rng, lens, m, n, bs):
    """Disjoint random block tables [B, m], 0-filled past each row's blocks."""
    perm = rng.permutation(n)
    bt = np.zeros((len(lens), m), np.int32)
    k = 0
    for i, ln in enumerate(lens):
        nb = -(-ln // bs)
        bt[i, :nb] = perm[k:k + nb]
        k += nb
    return bt


def _cache(rng, n, bs, hk, d, quant):
    """A float16 cache [L, N, 2, Bs, Hk*D] as numpy, or (for ``quant``) an
    int8 one: (codes, f32 scales [L, N, 2, Hp, Sp], pad lanes 1.0)."""
    if not quant:
        return rng.normal(size=(N_LAYERS, n, 2, bs, hk * d)).astype(F16)
    data = rng.integers(-127, 128, size=(N_LAYERS, n, 2, bs, hk * d)).astype(np.int8)
    hp, sp = kv_quant.scale_tile(hk, bs)
    scale = np.ones((N_LAYERS, n, 2, hp, sp), np.float32)
    scale[..., :hk, :bs] = (rng.random((N_LAYERS, n, 2, hk, bs)) * 0.05 + 0.01).astype(np.float32)
    return data, scale


def _jc(cache):
    if isinstance(cache, tuple):
        return jax_kv_quant.QuantKvCache(jnp.asarray(cache[0]), jnp.asarray(cache[1]))
    return jnp.asarray(cache)


def _tc(cache):
    if isinstance(cache, tuple):
        return kv_quant.QuantKvCache(_t(cache[0]), _t(cache[1]))
    return _t(cache)


def _wrappers(quant):
    return ((paged_decode_attention_q8, paged_prefill_attention_q8, ragged_paged_prefill_attention_q8)
            if quant else (paged_decode_attention, paged_prefill_attention,
                           ragged_paged_prefill_attention))


def _no_launch(wrapper, args, out, **kw):
    """On CPU tensors the wrapper is the plain version: the same bits, and
    no launch counted, fp16 or other."""
    before = (wrapper.launches, wrapper.launches_fp16)
    torch.testing.assert_close(wrapper(*args, **kw), out, rtol=0, atol=0)
    assert (wrapper.launches, wrapper.launches_fp16) == before


# ------------------------------------------- B1 / B4a: decode, S = 1 and 4
@pytest.mark.parametrize("quant", [False, True], ids=["B1", "B4a"])
@pytest.mark.parametrize("s,cap", [(1, None), (4, 30.0)])
def test_decode_fp16_ref_matches_pallas_interpret(quant, s, cap):
    rng = np.random.default_rng(11)
    b, h, hk, d, n, m, bs = 4, 8, 2, 32, 24, 4, 16
    lens = np.array([0, 1, bs + 3, 4 * bs], np.int32)  # zero-length row, single slot, full table
    bt = _tables(rng, lens, m, n, bs)
    cache = _cache(rng, n, bs, hk, d, quant)
    q = rng.normal(size=(b, s, h, d)).astype(F16)
    q0 = np.maximum(lens - s, 0).astype(np.int32)
    ref = np.asarray(paged_decode_attention_mq(
        jnp.asarray(q), _jc(cache), jnp.int32(1), jnp.asarray(bt), jnp.asarray(lens),
        jnp.asarray(q0), logit_cap=cap, blocks_per_chunk=2, seqs_per_group=2, interpret=True))
    assert ref.dtype == F16
    args = (_t(q), _tc(cache), 1, _t(bt), _t(lens), _t(q0))
    out = decode_attention_ref(*args, logit_cap=cap)
    assert out.dtype == torch.float16 and torch.isfinite(out).all()
    assert (out[0] == 0).all()  # a zero-length row gives exactly 0
    np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32), atol=ATOL)
    _no_launch(_wrappers(quant)[0], args, out, logit_cap=cap)


# ----------------------------------- B2 / B4b: prefill, with and without prefix
@pytest.mark.parametrize("quant", [False, True], ids=["B2", "B4b"])
@pytest.mark.parametrize("prefix_blocks,cap", [(0, None), (2, None), (2, 30.0)])
def test_prefill_fp16_ref_matches_pallas_interpret(quant, prefix_blocks, cap):
    rng = np.random.default_rng(12)
    b, s, h, hk, d, n, bs = 2, 32, 8, 2, 32, 16, 16
    start = np.full(b, prefix_blocks * bs, np.int32)
    fresh = np.array([s, s - 7], np.int32)
    lens = start + fresh
    m = prefix_blocks + 2
    bt = _tables(rng, lens, m, n, bs)
    cache = _cache(rng, n, bs, hk, d, quant)
    q, k_new, v_new = (rng.normal(size=(b, s, x, d)).astype(F16) for x in (h, hk, hk))
    ref = np.asarray(pallas_prefill(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), _jc(cache), jnp.int32(2),
        jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(start), logit_cap=cap, rows_per_chunk=16,
        blocks_per_chunk=2, interpret=True))
    args = (_t(q), _t(k_new), _t(v_new), _tc(cache), 2, _t(bt), _t(lens), _t(start))
    out = prefill_attention_ref(*args, logit_cap=cap)
    assert out.dtype == torch.float16 and torch.isfinite(out).all()
    assert (out[1, fresh[1]:] == 0).all()  # padding query rows give exactly 0
    for i, f in enumerate(fresh):
        np.testing.assert_allclose(out[i, :f].float().numpy(), ref[i, :f].astype(np.float32),
                                   atol=ATOL)
    _no_launch(_wrappers(quant)[1], args, out, logit_cap=cap)


# ------------------------------------------ B3 / B4c: ragged, a mixed batch
def _ragged_layout(rows, bs, m, n, rng, region):
    """Rows [(start, fresh)] packed as the engine does: leading 1-token rows
    take one slot each of a ``region``-slot decode region, the rest
    block-rounded spans after it, then one zero padding row."""
    n_dec = 0
    while region and n_dec < len(rows) and rows[n_dec][1] == 1:
        n_dec += 1
    offs, off = list(range(n_dec)), region
    for _, f in rows[n_dec:]:
        offs.append(off)
        off += -(-f // bs) * bs
    r = len(rows) + 1
    seq_ids = np.full((1, off), -1, np.int32)
    lens, starts, roff = (np.zeros(r, np.int32) for _ in range(3))
    for i, ((st, f), o) in enumerate(zip(rows, offs)):
        seq_ids[0, o:o + f] = i
        lens[i], starts[i], roff[i] = st + f, st, o
    bt = np.zeros((r, m), np.int32)
    bt[:len(rows)] = _tables(rng, lens[:len(rows)], m, n, bs)
    return off, seq_ids, bt, lens, starts, roff


@pytest.mark.parametrize("quant", [False, True], ids=["B3", "B4c"])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_ragged_fp16_ref_matches_pallas_interpret(quant, cap):
    """Decode rows at non-aligned starts ahead of two spans, one over a
    cached prefix, and a zero padding row."""
    rng = np.random.default_rng(13)
    h, hk, d, n, m, bs = 4, 2, 32, 24, 5, 16
    rows = [(bs + 3, 1), (1, 1), (2 * bs - 1, 1), (bs, 20), (0, 9)]
    t, seq_ids, bt, lens, starts, roff = _ragged_layout(rows, bs, m, n, rng, 8)
    live = seq_ids[0] >= 0
    cache = _cache(rng, n, bs, hk, d, quant)
    q, k_new, v_new = (rng.normal(size=(1, t, x, d)).astype(F16) for x in (h, hk, hk))
    ref = np.asarray(pallas_ragged(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), _jc(cache), jnp.int32(1),
        jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(starts), jnp.asarray(roff),
        logit_cap=cap, rows_per_chunk=8, blocks_per_chunk=2, interpret=True))
    args = (_t(q), _t(k_new), _t(v_new), _tc(cache), 1, _t(bt), _t(lens), _t(starts), _t(roff))
    out = ragged_prefill_attention_ref(*args, logit_cap=cap)
    assert out.dtype == torch.float16 and torch.isfinite(out).all()
    assert (out[0][~torch.from_numpy(live)] == 0).all()  # padding tokens give exactly 0
    np.testing.assert_allclose(out.float().numpy()[0][live], ref.astype(np.float32)[0][live],
                               atol=ATOL)
    _no_launch(_wrappers(quant)[2], args, out, logit_cap=cap)


# ----------------------------------------------------------- B5: W8A16
@pytest.mark.parametrize("out_f32", [False, True], ids=["fp16-out", "f32-out"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_int8_matmul_fp16_ref_matches_pallas_interpret(layout, out_f32):
    rng = np.random.default_rng(14)
    m, k, n = 8, 256, 384
    x = rng.normal(size=(m, k)).astype(F16)
    codes = rng.integers(-127, 128, size=(k, n) if layout == "kn" else (n, k)).astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, size=n) / (73.3 * np.sqrt(k))).astype(np.float32)
    w = codes if layout == "kn" else codes.T
    out_dtype = torch.float32 if out_f32 else torch.float16
    pallas = np.asarray(pallas_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                           out_dtype=jnp.float32 if out_f32 else None,
                                           interpret=True))
    assert pallas.dtype == (np.float32 if out_f32 else F16)
    wq = _t(codes) if layout == "kn" else _t(codes).t()
    assert wq.is_contiguous() == (layout == "kn")
    out = int8_matmul_ref(_t(x), wq, _t(scale), out_dtype)
    assert out.dtype == out_dtype
    exact = (x.astype(np.float64) @ w.astype(np.float64)) * scale
    step = 2.0 ** -10
    np.testing.assert_allclose(out.float().numpy(), exact, rtol=step,
                               atol=step * np.abs(exact).max())
    bf16_x = 2.0 ** -9 * (np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64) * scale)).max()
    np.testing.assert_allclose(out.float().numpy(), pallas.astype(np.float32), rtol=step, atol=bf16_x)
    before = (int8_matmul.launches, int8_matmul.launches_fp16)
    torch.testing.assert_close(int8_matmul(_t(x), wq, _t(scale), out_dtype), out, rtol=0, atol=0)
    assert (int8_matmul.launches, int8_matmul.launches_fp16) == before


# ------------------------------------------------- the 2-layer fp16 model
def _jax_fp16(seed=0):
    jcfg = JaxModelConfig.tiny(dtype="float16")
    jmodel = JaxLlamaModel(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    return jmodel, tree


def test_params_from_jax_carries_fp16_exactly():
    _, tree = _jax_fp16()
    cfg = ModelConfig.tiny(dtype="float16")
    state = params_from_jax(tree, cfg, device="cpu")
    flat = {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}
    assert set(state) == set(flat)
    for name, ref in flat.items():
        assert ref.dtype == F16, name
        assert state[name].dtype == torch.float16, name
        np.testing.assert_array_equal(state[name].numpy(), ref)


def _dispatches(prompt, bs, m):
    """A 24-token prefill then two one-token decodes of ``prompt`` over a
    one-row table: (tokens, positions, table, lens, slots, prefix blocks,
    the last live token)."""
    bt = np.arange(m, dtype=np.int32)[None]
    out = []
    pre = 24
    out.append((prompt[None, :pre].astype(np.int32), np.arange(pre, dtype=np.int32)[None], bt,
                np.array([pre], np.int32), np.arange(pre, dtype=np.int32)[None], 0, pre - 1))
    for p in (pre, pre + 1):
        out.append((prompt[None, p:p + 1].astype(np.int32), np.array([[p]], np.int32), bt,
                    np.array([p + 1], np.int32), np.array([[p]], np.int32), 0, 0))
    return out


def test_fp16_forward_logits_match_jax():
    jmodel, tree = _jax_fp16()
    cfg = ModelConfig.tiny(dtype="float16")
    model = LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))
    jparams = jax.tree.map(jnp.asarray, tree)
    bs, n_blocks, m = 8, 8, 6
    jcache = jmodel.init_kv_cache(n_blocks, bs)
    cache = model.init_kv_cache(n_blocks, bs)
    assert cache.dtype == torch.float16
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 30)
    for t, pos, bt, lens, slot, pb, last in _dispatches(prompt, bs, m):
        jh, jcache = jmodel.forward(jparams, jnp.asarray(t), jnp.asarray(pos), jcache,
                                    jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(slot),
                                    prefix_blocks=pb)
        h, cache = model.forward(_t(t), _t(pos), cache, _t(bt), _t(lens), _t(slot), prefix_blocks=pb)
        assert h.dtype == torch.float16
        ref = np.asarray(jmodel.compute_logits(jparams, jh[:, last]))
        out = model.compute_logits(h[:, last])
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL)


BASE = dict(max_batch_size=8, max_model_len=128, num_blocks=48, prefill_buckets=[32, 64, 128])
CONFIGS = {
    "default": dict(block_size=16, prefill_chunk_tokens=32, decode_steps=4),
    "token-budget": dict(block_size=16, prefill_chunk_tokens=32, prefill_token_budget=64,
                         unified_token_dispatch=True, lookahead_dispatch=True, decode_steps=8),
    "int8-cache": dict(block_size=32, prefill_chunk_tokens=32, decode_steps=4, cache_dtype="int8"),
}


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
def test_fp16_engine_streams_match_jax(config):
    """Requests arriving while others decode and a shared 32-token prefix
    (a prefix-cache hit), all greedy, on an fp16 model."""
    jmodel, tree = _jax_fp16()
    cfg = ModelConfig.tiny(dtype="float16")
    model = LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))
    rng = np.random.RandomState(7)
    shared = [int(x) for x in rng.randint(3, 250, size=32)]
    specs = [
        ("long", [int(x) for x in rng.randint(3, 250, size=45)], dict(temperature=0.0), 6),
        ("a", shared + [5, 9, 11], dict(temperature=0.0), 9),
        ("c", [int(x) for x in rng.randint(3, 250, size=12)], dict(temperature=0.0), 10),
        ("b", shared + [7, 7], dict(temperature=0.0), 8),
    ]
    kw = {**BASE, **CONFIGS[config]}
    jcore = JaxEngineCore(jmodel, jax.tree.map(jnp.asarray, tree), JaxEngineConfig(**kw),
                          eos_token_ids=[EOS])
    core = EngineCore(model, EngineConfig(**kw), eos_token_ids=[EOS], device="cpu")
    if config != "int8-cache":
        assert core.cache.dtype == torch.float16
    ref = _run(jcore, JaxEngineRequest, jax_protocols, specs, head=2, stagger=3)
    out = _run(core, EngineRequest, protocols, specs, head=2, stagger=3)
    assert out == ref
    assert max(out["b"][2]) >= 32  # the shared prefix came from the cache


def test_native_fp16_checkpoint_keeps_its_dtype(tmp_path):
    _, tree = _jax_fp16()
    cfg = ModelConfig.tiny(dtype="float16")
    state = params_from_jax(tree, cfg, device="cpu")
    save_checkpoint(tmp_path / "ckpt", cfg, state, quantized=False)
    got_cfg, got, quantized = load_checkpoint(tmp_path / "ckpt", device="cpu")
    assert got_cfg.dtype == "float16" and not quantized
    for name, t in state.items():
        assert got[name].dtype == torch.float16, name
        torch.testing.assert_close(got[name], t, rtol=0, atol=0)


# ------------------------------------------------------ the route check
def _meta_model(**kw):
    return LlamaModel(ModelConfig(**{**vars(ModelConfig.tiny()), **kw}), device="meta")


CUDA = torch.device("cuda", 0)
MOE = dict(num_experts=4, num_experts_per_tok=2)


@pytest.mark.parametrize("kw,cache_dtype,why", [
    (dict(dtype="float16"), None, None),
    (dict(dtype="float16"), "int8", None),
    (dict(dtype="float16"), "float16", None),
    (dict(dtype="bfloat16"), None, None),
    (dict(dtype="bfloat16", **MOE), None, None),
    (dict(dtype="bfloat16", **MOE), "int8", None),
    (dict(dtype="float32"), None, r"model dtype 'float32' on cuda: no kernel takes float32"),
    (dict(dtype="float32"), "int8", r"model dtype 'float32' on cuda: no kernel takes float32"),
    (dict(dtype="float16", **MOE), None,
     r"float16 mixture-of-experts model on cuda: no grouped expert kernel \(E1/E2\)"),
    (dict(dtype="float16", **MOE), "int8",
     r"float16 mixture-of-experts model on cuda: no grouped expert kernel \(E1/E2\)"),
    (dict(dtype="float16"), "bfloat16", r"cache_dtype 'bfloat16' on cuda: no kernel takes"),
    (dict(dtype="float16"), "float32", r"cache_dtype 'float32' on cuda: no kernel takes"),
    (dict(dtype="bfloat16"), "float16", r"cache_dtype 'float16' on cuda: no kernel takes"),
], ids=["fp16", "fp16-int8-cache", "fp16-fp16-cache", "bf16", "bf16-moe", "bf16-moe-int8-cache",
        "fp32", "fp32-int8-cache", "fp16-moe", "fp16-moe-int8-cache", "fp16-bf16-cache",
        "fp16-fp32-cache", "bf16-fp16-cache"])
def test_cuda_route_refusal(kw, cache_dtype, why):
    """On the card the construction check refuses, naming the missing
    kernel, what no kernel on the model's route takes; the CPU serves
    every one of them.  Checked without a card, on the check itself."""
    model = _meta_model(**kw)
    ecfg = EngineConfig(max_model_len=64, num_blocks=8, cache_dtype=cache_dtype)
    EngineCore._check_supported(model, ecfg, "cpu")
    got = cuda_route_refusal(model.config, cache_dtype)
    if why is None:
        assert got is None
        EngineCore._check_supported(model, ecfg, CUDA)
        return
    assert got is not None and "kernel" in got
    with pytest.raises(ValueError, match=why):
        EngineCore._check_supported(model, ecfg, CUDA)


def test_cpu_engine_serves_every_float_dtype():
    """The plain ops serve float32, bfloat16 and float16 models on the CPU,
    and an fp16 model under a float32 cache (the route check is the card's)."""
    for dtype, cache_dtype in (("float32", None), ("bfloat16", None), ("float16", None),
                               ("float16", "float32")):
        cfg = ModelConfig.tiny(dtype=dtype)
        model = LlamaModel.from_state(cfg, params_from_jax(_jax_fp16()[1], cfg, device="cpu"))
        core = EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8, block_size=8,
                                              prefill_buckets=[32, 64], cache_dtype=cache_dtype),
                          eos_token_ids=[EOS], device="cpu")
        outs = []
        core.submit(EngineRequest(request_id="r", prompt=list(range(3, 20)),
                                  sampling=protocols.SamplingOptions(temperature=0.0),
                                  stops=protocols.StopConditions(max_tokens=4), emit=outs.append))
        for _ in range(100):
            if not core.step():
                break
        tokens = [t for o in outs for t in o.token_ids]
        assert len(tokens) == 4 and outs[-1].finish_reason.value == "length", dtype


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, ""), (torch.float16, "_f16")])
def test_entry_points_by_dtype(dtype, suffix):
    for name in ("dynamo_decode_attention", "dynamo_prefill_attention_q8", "dynamo_int8_matmul"):
        assert build.entry(name, dtype) == name + suffix
        assert name + suffix in build._SIGNATURES


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int8])
def test_no_body_for_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        build.entry("dynamo_decode_attention", dtype)


def test_fp16_wrappers_raise_off_cuda_and_cpu():
    """A float16 tensor on neither device raises before any launch, and no
    count moves."""
    meta = lambda *shape, dtype=torch.float16: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    b, s, h, hk, d, bs = 2, 4, 8, 2, 128, 16
    cache = meta(3, 8, 2, bs, hk * d)
    bt = meta(b, 4, dtype=torch.int32)
    lens = meta(b, dtype=torch.int32)
    wrappers = (paged_decode_attention, paged_prefill_attention, int8_matmul)
    before = [(w.launches, w.launches_fp16) for w in wrappers]
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_decode_attention(meta(b, 1, h, d), cache, 1, bt, lens, lens)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_prefill_attention(meta(b, s, h, d), meta(b, s, hk, d), meta(b, s, hk, d), cache, 1,
                                bt, lens, lens)
    with pytest.raises(ValueError, match="cuda or cpu"):
        int8_matmul(meta(8, 64), meta(64, 96, dtype=torch.int8), meta(96, dtype=torch.float32))
    assert [(w.launches, w.launches_fp16) for w in wrappers] == before
