"""The PyTorch LlamaModel against the JAX LlamaModel on the same weights.

The JAX package's random init (``ModelConfig.tiny()``: 2 layers, hidden 64,
GQA 4/2, f32) is perturbed in numpy so biases and norm scales are not
trivial, carried into the port by ``models/convert.params_from_jax``, and
both models run the same three dispatches over a paged cache: a prefill of
a 16-token prompt head, a prefix-fast-path prefill of the next 13 tokens
over those two cached blocks, and one decode step.

Tolerance: atol 1e-4 on f32 logits of magnitude ~1 (both sides are f32; the
gap is summation order in the matmuls and the softmax), and the same on the
cache the three dispatches wrote.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel

ATOL = 1e-4
BS, N_BLOCKS, M = 8, 8, 6

VARIANTS = {
    "llama": {},
    "llama3-rope-scaling": dict(rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
    "qwen2-bias": dict(attention_bias=True),
    "qwen3-qk-norm": dict(qk_norm=True),
    "gemma2-softcap": dict(
        hidden_activation="gelu_tanh", rmsnorm_unit_offset=True, scale_embeddings=True,
        post_norms=True, query_pre_attn_scalar=24.0, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, tie_word_embeddings=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(jmodel, seed=0):
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    # perturb every leaf: zero biases and unit norm scales would hide bugs
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), tree)


def _dispatches(prompt):
    """(tokens, positions, block_tables, seq_lens, slot_idx, prefix_blocks,
    last index) of the three dispatches, as numpy."""
    bt = np.zeros((1, M), np.int32)
    bt[0, :4] = [3, 6, 1, 4]

    def one(start, toks, pad, prefix_blocks):
        n = len(toks)
        t = np.zeros((1, pad), np.int32)
        t[0, :n] = toks
        pos = np.zeros((1, pad), np.int32)
        pos[0, :n] = np.arange(start, start + n)
        slot = np.full((1, pad), -1, np.int32)
        slot[0, :n] = bt[0, pos[0, :n] // BS] * BS + pos[0, :n] % BS
        lens = np.array([start + n], np.int32)
        return t, pos, bt, lens, slot, prefix_blocks, n - 1

    return [one(0, prompt[:16], 16, 0), one(16, prompt[16:29], 16, 2),
            one(29, prompt[29:30], 1, None)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match_jax(variant):
    kw = dict(VARIANTS[variant])
    jcfg = JaxModelConfig.tiny(**kw)
    jmodel = JaxLlamaModel(jcfg)
    tree = _params(jmodel)
    cfg = ModelConfig.tiny(**kw)
    model = LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))
    jparams = jax.tree.map(jnp.asarray, tree)

    jcache = jmodel.init_kv_cache(N_BLOCKS, BS)
    cache = model.init_kv_cache(N_BLOCKS, BS)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 30)
    for t, pos, bt, lens, slot, pb, last in _dispatches(prompt):
        jh, jcache = jmodel.forward(jparams, jnp.asarray(t), jnp.asarray(pos), jcache,
                                    jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(slot),
                                    prefix_blocks=pb)
        ref = np.asarray(jmodel.compute_logits(jparams, jh[:, last]))
        h, _ = model.forward(torch.from_numpy(t), torch.from_numpy(pos), cache,
                             torch.from_numpy(bt), torch.from_numpy(lens),
                             torch.from_numpy(slot), prefix_blocks=pb)
        out = model.compute_logits(h[:, last])
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=ATOL)


def test_params_from_jax_rejects_a_mismatched_tree():
    jcfg = JaxModelConfig.tiny()
    tree = _params(JaxLlamaModel(jcfg))
    del tree["layers"]["wq"]
    with pytest.raises(ValueError, match="do not match"):
        params_from_jax(tree, ModelConfig.tiny(), device="cpu")
