"""The port's mixture-of-experts layers against the JAX package's.

Seeded numpy inputs (f32, tiny MoE configs: 2 layers, hidden 64, 4 or 8
experts) go to both packages:

* ``_moe_router`` with ``norm_topk_prob`` true and false, and with tied
  logits forced by duplicated router columns: expert ids exact (ties keep
  the lower expert first, as ``jax.lax.top_k``), weights within 1e-6;
* ``grouped_expert_dispatch`` / ``_moe_mlp_grouped`` against JAX's grouped
  and dense paths, with empty experts and T = 1, within 1e-5; int8
  experts in the setup of JAX's ``test_moe_grouped_quantized_matches_dense``
  within 1e-4; the port's grouped path against its own dense oracle;
* the grouped kernels' plain versions against a per-row product;
* Mixtral-tiny and Qwen3-MoE-tiny ``LlamaModel.forward`` logits against the
  JAX ``LlamaModel`` (1e-4, as ``test_torch_llama.py``);
* parameter shapes and ``init_params`` against the JAX init's tree,
  quantised and not;
* ``EngineCore`` greedy streams and counters token-identical to the JAX
  ``EngineCore`` on the default and the token-budget paths, with f32 and
  with int8 experts (f32 activations on both sides, as every engine test of
  the port: the two frameworks round bf16 at different places);
* the routing glue and the kernel wrappers' launch path read nothing on
  the host: run with ``Tensor.item``/``tolist`` raising, against a stand-in
  for the CUDA library (the card's kernel cannot run here).
"""

import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.models import quant as jax_quant
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import init_params, params_from_jax
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels import grouped_matmul as gmm

WEIGHT_ATOL = 1e-6
MLP_ATOL = 1e-5
INT8_ATOL = 1e-4
LOGIT_ATOL = 1e-4
EOS = 2
MIXTRAL = dict(num_experts=8, num_experts_per_tok=2)
QWEN3_MOE = dict(num_experts=8, num_experts_per_tok=2, qk_norm=True, head_dim=32,
                 norm_topk_prob=False, intermediate_size=48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _trees(kw, seed=0, quantized=False):
    """(JAX model, numpy params tree perturbed in numpy, port model on it)."""
    jmodel = jax_llama.LlamaModel(JaxModelConfig.tiny(**kw))
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    # perturb every leaf: unit norm scales would hide bugs
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), tree)
    if quantized:
        tree = jax.tree.map(np.asarray, jax_quant.quantize_params(tree))
    cfg = ModelConfig.tiny(**kw)
    return jmodel, tree, llama.LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))


def _layer0(tree, model):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]), model._layer(0)


# ------------------------------------------------------------------- router
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("norm_topk", [True, False])
def test_router_matches_jax(norm_topk, ties):
    """With ``ties`` each token's logits are small integers (token t is the
    unit vector of dimension t, so its logits are row t of the router,
    exactly): most tokens tie across the top-3 boundary."""
    kw = dict(num_experts=8, num_experts_per_tok=3, norm_topk_prob=norm_topk)
    jcfg, cfg = JaxModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    rng = np.random.default_rng(11)
    router = rng.normal(size=(cfg.hidden_size, 8)).astype(np.float32)
    x = rng.normal(size=(9, cfg.hidden_size)).astype(np.float32)
    if ties:
        x = np.eye(cfg.hidden_size, dtype=np.float32)[:9]
        router[:9] = rng.integers(0, 3, size=(9, 8))
        top = -np.sort(-router[:9], axis=1)
        assert (top[:, 2] == top[:, 3]).sum() >= 5  # ties at the boundary
    jw, ji = jax_llama._moe_router(jcfg, {"router": jnp.asarray(router)}, jnp.asarray(x))
    w, i = llama._moe_router(cfg, {"router": _t(router)}, _t(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=WEIGHT_ATOL)


# --------------------------------------------------------------- dispatch
@pytest.mark.parametrize("t", [1, 10])
@pytest.mark.parametrize("norm_topk", [True, False])
def test_grouped_dispatch_matches_jax(norm_topk, t):
    """T = 1 at top 2 of 8 leaves six experts empty; the combine, the sort
    and the grouped products must match JAX's grouped and dense paths."""
    kw = dict(MIXTRAL, norm_topk_prob=norm_topk)
    jmodel, tree, model = _trees(kw, seed=3)
    jlp, lp = _layer0(tree, model)
    x = np.random.default_rng(4).normal(size=(1, t, model.config.hidden_size)).astype(np.float32)
    jcfg, cfg = jmodel.config, model.config
    got = llama._moe_mlp_grouped(cfg, lp, _t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_llama._moe_mlp_grouped(jcfg, jlp, jnp.asarray(x))),
                               atol=MLP_ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_llama._moe_mlp_dense(jcfg, jlp, jnp.asarray(x))),
                               atol=MLP_ATOL)
    np.testing.assert_allclose(llama._moe_mlp_dense(cfg, lp, _t(x)).numpy(), got, atol=MLP_ATOL)
    # the public core on its own, as DeepSeek-MoE will call it
    xf = _t(x[0])
    weights, topi = llama._moe_router(cfg, lp, xf)
    jweights, jtopi = jax_llama._moe_router(jcfg, jlp, jnp.asarray(x[0]))
    core = llama.grouped_expert_dispatch(xf, weights, topi, cfg.num_experts, lp["w_gate"],
                                         lp["w_up"], lp["w_down"], torch.nn.functional.silu)
    jcore = jax_llama.grouped_expert_dispatch(jnp.asarray(x[0]), jweights, jtopi, cfg.num_experts,
                                              jlp["w_gate"], jlp["w_up"], jlp["w_down"],
                                              jax.nn.silu)
    np.testing.assert_allclose(core.numpy(), np.asarray(jcore), atol=MLP_ATOL)


def test_int8_experts_match_jax():
    """JAX's ``test_moe_grouped_quantized_matches_dense`` setup: int8 expert
    stacks from the quantised init, 7 tokens, 4 experts, top 2."""
    kw = dict(num_experts=4, num_experts_per_tok=2)
    jmodel = jax_llama.LlamaModel(JaxModelConfig.tiny(**kw))
    qtree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(5), quantized=True))
    cfg = ModelConfig.tiny(**kw)
    model = llama.LlamaModel.from_state(cfg, params_from_jax(qtree, cfg, device="cpu"))
    assert model.quantized and model.layers["router"].dtype == torch.float32
    assert tuple(model.layers["w_gate_scale"].shape) == (2, 4, 1, cfg.intermediate_size)
    jlp, lp = _layer0(qtree, model)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (1, 7, cfg.hidden_size), jnp.float32))
    got = llama._moe_mlp_grouped(cfg, lp, _t(x)).numpy()
    for ref in (jax_llama._moe_mlp_grouped, jax_llama._moe_mlp_dense):
        np.testing.assert_allclose(got, np.asarray(ref(jmodel.config, jlp, jnp.asarray(x))),
                                   atol=INT8_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_path_matches_dense_oracle(dtype):
    """The port's grouped MLP (plain versions on the CPU) against its dense
    oracle, in f32 and in bf16 (where both round the same intermediates)."""
    _, _, model = _trees(MIXTRAL, seed=8)
    lp = {k: v.to(dtype) for k, v in model._layer(1).items()}
    cfg = ModelConfig.tiny(**MIXTRAL, dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    x = _t(np.random.default_rng(9).normal(size=(2, 6, cfg.hidden_size)).astype(np.float32)).to(dtype)
    got = llama._moe_mlp_grouped(cfg, lp, x).float()
    ref = llama._moe_mlp_dense(cfg, lp, x).float()
    tol = MLP_ATOL if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol)


def _groups(counts):
    offsets = torch.zeros(len(counts) + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(torch.tensor(counts), 0)
    return offsets


@pytest.mark.parametrize("counts", [[3, 0, 5, 0, 1], [0, 0, 9, 0, 0], [1, 1, 1, 1, 1]])
def test_plain_versions_match_a_per_row_product(counts):
    rng = np.random.default_rng(sum(counts))
    e, k, n = len(counts), 16, 24
    r = sum(counts)
    x = _t(rng.normal(size=(r, k)).astype(np.float32))
    w = _t(rng.normal(size=(e, k, n)).astype(np.float32))
    owner = np.repeat(np.arange(e), counts)
    ref = torch.stack([x[i] @ w[owner[i]] for i in range(r)])
    offsets = _groups(counts)
    torch.testing.assert_close(gmm.grouped_matmul_ref(x, w, offsets), ref, rtol=0, atol=1e-5)
    wq = _t(rng.integers(-127, 128, size=(e, k, n)).astype(np.int8))
    scale = _t(rng.uniform(0.5, 1.5, size=(e, 1, n)).astype(np.float32) / 100)
    ref_q = torch.stack([(x[i] @ wq[owner[i]].float()) * scale[owner[i], 0] for i in range(r)])
    torch.testing.assert_close(gmm.grouped_matmul_q8_ref(x, wq, scale, offsets), ref_q,
                               rtol=0, atol=1e-5)
    # the CPU tensors take the plain versions and count no launch
    before = (gmm.grouped_matmul.launches, gmm.grouped_matmul_q8.launches)
    torch.testing.assert_close(gmm.grouped_matmul(x, w, offsets), ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(gmm.grouped_matmul_q8(x, wq, scale, offsets), ref_q, rtol=0, atol=1e-5)
    assert (gmm.grouped_matmul.launches, gmm.grouped_matmul_q8.launches) == before


def test_wrappers_raise_off_cuda_and_cpu():
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    offsets = meta(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gmm.grouped_matmul(meta(8, 16), meta(4, 16, 32), offsets)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gmm.grouped_matmul_q8(meta(8, 16), meta(4, 16, 32, dtype=torch.int8),
                              meta(4, 1, 32, dtype=torch.float32), offsets)


# -------------------------------------------------------------- no host read
_SMS = 132  # an H100 SXM


class _Library:
    """Stands in for the CUDA library: checks the launch it is given and
    writes the product into ``out``, computed from the tensors by device
    operations only (a host read would raise under the test's patches)."""

    def __init__(self):
        self.launches, self.tensors = [], None

    def dynamo_grouped_matmul(self, x, w, scale, offsets, out, r, n, k, e, quant, rows, grid_n,
                              blocks, stream):
        xt, wt, st, ot = self.tensors
        assert (x, w, offsets) == (xt.data_ptr(), wt.data_ptr(), ot.data_ptr())
        assert (rows, grid_n, blocks) == (lambda p: (p.rows, p.grid_n, p.blocks))(
            gmm.plan(r, e, n, k, bool(quant), _SMS))
        row_expert = torch.searchsorted(ot[1:], torch.arange(r, dtype=torch.int32), right=True)
        wf = wt.float() * st if quant else wt.float()
        y = torch.bmm(xt.float()[:, None, :], wf[row_expert])[:, 0].to(torch.bfloat16).contiguous()
        ctypes.memmove(out, y.data_ptr(), y.numel() * y.element_size())
        self.launches.append(bool(quant))
        return 0


@pytest.mark.parametrize("quantized", [False, True])
def test_routing_and_launch_make_no_host_read(monkeypatch, quantized):
    """The MoE MLP's glue (router, stable sort, integer group counts and
    prefix sum, gather, combine) and the wrappers' checks, plan and launch,
    as they run for CUDA tensors, with ``Tensor.item``/``tolist`` raising:
    the group sizes never reach the host.  The card's kernel cannot run
    here, so the wrappers' CUDA branch is driven on CPU tensors against a
    stand-in library."""
    cfg = ModelConfig.tiny(num_experts=8, num_experts_per_tok=2, dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    model = llama.LlamaModel.from_state(cfg, init_params(cfg, gen, device="cpu", quantized=quantized))
    lp = model._layer(0)
    x = torch.randn((1, 5, cfg.hidden_size), generator=gen).to(torch.bfloat16)
    ref = llama._moe_mlp_dense(cfg, lp, x)
    lib = _Library()

    def cuda_branch(quant, wrapper):  # the wrappers' body past the device test
        def call(x, w, *rest):
            scale, offsets = (rest[0] if quant else None), rest[-1]
            gmm._check(x, w, scale, offsets, quant)
            lib.tensors = (x, w, scale, offsets)
            return gmm._launch(x, w, scale, offsets, quant, wrapper)
        return call

    def route(x, w, offsets):  # models/quant.py::grouped_matmul for CUDA tensors
        if isinstance(w, llama.QTensor):
            return gmm.grouped_matmul_q8(x, w.q, w.scale, offsets)
        return gmm.grouped_matmul(x, w, offsets)

    def no_host_read(*_, **__):
        raise AssertionError("a host read of a tensor's values")

    launches = (gmm.grouped_matmul.launches, gmm.grouped_matmul_q8.launches)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "sm_count", lambda index: _SMS)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(gmm, "grouped_matmul", cuda_branch(False, gmm.grouped_matmul))
    monkeypatch.setattr(gmm, "grouped_matmul_q8", cuda_branch(True, gmm.grouped_matmul_q8))
    monkeypatch.setattr(llama, "grouped_matmul", route)
    monkeypatch.setattr(torch.Tensor, "item", no_host_read)
    monkeypatch.setattr(torch.Tensor, "tolist", no_host_read)
    with pytest.raises(AssertionError, match="host read"):
        torch.ones(2).tolist()
    got = llama._moe_mlp_grouped(cfg, lp, x)
    monkeypatch.undo()
    assert lib.launches == [quantized] * 3
    counted = (gmm.grouped_matmul.launches - launches[0], gmm.grouped_matmul_q8.launches - launches[1])
    assert counted == ((0, 3) if quantized else (3, 0))
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=2e-2)


# ------------------------------------------------------------------ forward
def _dispatches(prompt, bs, m):
    """A prefill of 16 tokens, a prefix-fast-path prefill of the next 13
    over those cached blocks, and one decode step, as numpy."""
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


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("family", ["mixtral", "qwen3-moe"])
def test_forward_logits_match_jax(family, quantized):
    kw = MIXTRAL if family == "mixtral" else QWEN3_MOE
    jmodel, tree, model = _trees(kw, seed=1, quantized=quantized)
    jparams = jax.tree.map(jnp.asarray, tree)
    bs, n_blocks, m = 8, 8, 6
    jcache = jmodel.init_kv_cache(n_blocks, bs)
    cache = model.init_kv_cache(n_blocks, bs)
    prompt = np.random.default_rng(2).integers(0, model.config.vocab_size, 30)
    for t, pos, bt, lens, slot, pb, last in _dispatches(prompt, bs, m):
        jh, jcache = jmodel.forward(jparams, jnp.asarray(t), jnp.asarray(pos), jcache,
                                    jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(slot),
                                    prefix_blocks=pb)
        h, _ = model.forward(_t(t), _t(pos), cache, _t(bt), _t(lens), _t(slot), prefix_blocks=pb)
        ref = np.asarray(jmodel.compute_logits(jparams, jh[:, last]))
        np.testing.assert_allclose(model.compute_logits(h[:, last]).numpy(), ref, atol=LOGIT_ATOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=LOGIT_ATOL)


# -------------------------------------------------------------- parameters
@pytest.mark.parametrize("quantized", [False, True])
def test_params_match_jax_init_structure(quantized):
    """``param_shapes``/``init_params`` against the JAX init's tree: the
    router stays dense, an expert stack's scale is [L, E, 1, N]."""
    jtree = jax_llama.LlamaModel(JaxModelConfig.tiny(**QWEN3_MOE)).init_params(
        jax.random.PRNGKey(0), quantized=quantized)
    flat = {**{k: v for k, v in jtree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in jtree["layers"].items()}}
    expect = {}
    for name, leaf in flat.items():
        if isinstance(leaf, jax_quant.QTensor):
            expect[name] = (tuple(leaf.q.shape), torch.int8)
            expect[name + "_scale"] = (tuple(leaf.scale.shape), torch.float32)
        else:
            expect[name] = (tuple(leaf.shape), torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_params(ModelConfig.tiny(**QWEN3_MOE), gen, device="cpu", quantized=quantized)
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == expect
    router = state["layers.router"]
    assert 0.8 < router.std().item() * np.sqrt(router.shape[1]) < 1.2  # N(0, 1 / Dm)


# ------------------------------------------------------------------- engine
BASE = dict(max_batch_size=8, max_model_len=128, num_blocks=48, prefill_buckets=[32, 64, 128])
CONFIGS = {
    "default": dict(block_size=16, prefill_chunk_tokens=32, decode_steps=4),
    "token-budget": dict(block_size=32, prefill_chunk_tokens=32, prefill_token_budget=64,
                         unified_token_dispatch=True, lookahead_dispatch=True, decode_steps=8),
}
COUNTERS = ("prefill_dispatches_total", "unified_dispatches_total", "unified_decode_rows",
            "unified_prefill_tokens", "lookahead_bursts_total", "lookahead_hits_total",
            "lookahead_mispredicts_total", "device_gets_total", "tokens_generated")


def _run(core, request_cls, proto, specs, head, stagger):
    outs = {rid: [] for rid, *_ in specs}
    reqs = [request_cls(request_id=rid, prompt=list(prompt),
                        sampling=proto.SamplingOptions(temperature=0.0),
                        stops=proto.StopConditions(max_tokens=max_tokens),
                        emit=outs[rid].append)
            for rid, prompt, max_tokens in specs]
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


@pytest.fixture(scope="module", params=["f32", "int8"])
def engines(request):
    """(JAX model and params, port model, cache dtype) for a Qwen3-MoE-tiny
    model with f32 or int8 experts (int8: an int8 KV cache too)."""
    quantized = request.param == "int8"
    jmodel, tree, model = _trees(QWEN3_MOE, seed=4, quantized=quantized)
    return jmodel, jax.tree.map(jnp.asarray, tree), model, "int8" if quantized else None


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_streams_match_jax(engines, config):
    """Requests arriving while others decode and a shared 32-token prefix,
    greedy: both engines route every token through the MoE MLP, padding
    rows of the ragged and unified dispatches included."""
    jmodel, jparams, model, cache_dtype = engines
    rng = np.random.RandomState(7)
    shared = [int(v) for v in rng.randint(3, 250, size=32)]
    specs = [("long", [int(v) for v in rng.randint(3, 250, size=45)], 6),
             ("a", shared + [5, 9, 11], 9),
             ("short", [int(v) for v in rng.randint(3, 250, size=12)], 10),
             ("shorter", [int(v) for v in rng.randint(3, 250, size=10)], 6),
             ("b", shared + [7, 7], 8)]
    kw = {**BASE, **CONFIGS[config], "cache_dtype": cache_dtype}
    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**kw), eos_token_ids=[EOS])
    core = EngineCore(model, EngineConfig(**kw), eos_token_ids=[EOS], device="cpu")
    ref = _run(jcore, JaxEngineRequest, jax_protocols, specs, head=2, stagger=3)
    out = _run(core, EngineRequest, protocols, specs, head=2, stagger=3)
    assert out == ref
    assert max(out["b"][2]) >= 32  # the shared prefix came from the cache
    jm, pm = jcore.metrics(), core.metrics()
    assert {k: pm[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    if config == "token-budget":
        assert pm["unified_dispatches_total"] > 0 and pm["lookahead_bursts_total"] > 0
