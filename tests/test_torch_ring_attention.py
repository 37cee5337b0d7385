"""Ring attention and the sequence-parallel prefill of the port, against the
JAX package's, on the CPU: the ten cases of ``tests/test_ring_attention.py``.

Each runs twice, in a real gloo world of 2 and then of 4 processes
(``torch_mesh_world``: this process is rank 0, the others shard followers),
laid out as the mesh (n, 1) with the sequence split over "data".  The JAX
side runs in this process, ``ring_attention`` on ``build_mesh((n, 1))`` of
the 8 forced CPU devices over the same axis.  Outputs are held within atol
2e-4 of JAX's (ring attention, the SP forward's hidden states and fresh KV),
and the engines' greedy streams are token-identical to JAX's meshed
``EngineCore`` with the same ``sp_prefill_threshold``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from safetensors.torch import save_file

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.core import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.deepseek import DeepseekConfig as JaxDeepseekConfig
from dynamo_tpu.models.deepseek import DeepseekModel as JaxDeepseekModel
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from dynamo_tpu.utils.mesh import AXIS_DATA as JAX_AXIS_DATA
from dynamo_tpu.utils.mesh import MESH_AXES as JAX_MESH_AXES
from dynamo_tpu.utils.mesh import build_mesh as jax_build_mesh
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.follower import broadcast_model
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import deepseek_params_from_jax, params_from_jax
from dynamo_tpu_torch.models.deepseek import DeepseekConfig
from dynamo_tpu_torch.ops.ring_attention import ring_attention
from tests.torch_mesh_world import World, ring_case, sp_forward

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers share
    the machine's cores (the followers run with OMP_NUM_THREADS=1 too)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[2, 4], ids=["mesh2x1", "mesh4x1"])
def world(request):
    w = World(request.param, (request.param, 1))
    yield w
    w.close()


def _jmesh(world):
    return jax_build_mesh((world.mesh.size, 1), JAX_MESH_AXES)


def _both(world, q, k, v, q_pos, kv_pos, **kw):
    """(the port's ring attention over the world, JAX's over (n, 1))."""
    got = world.call(ring_case, q, k, v, q_pos, kv_pos, kw)
    want = jax_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(q_pos, jnp.int32), jnp.asarray(kv_pos, jnp.int32),
                              mesh=_jmesh(world), axis=JAX_AXIS_DATA, **kw)
    return got, np.asarray(want)


def test_ring_matches_dense(world):
    rng = np.random.default_rng(0)
    b, s, hq, hk, d = 2, 64, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int64), (b, s)).copy()
    got, want = _both(world, q, k, v, pos, pos)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ring_noncausal_and_padding(world):
    """Non-causal mode, and padded keys masked out by huge positions."""
    rng = np.random.default_rng(1)
    b, s, h, d = 1, 32, 2, 8
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int64), (b, s)).copy()
    got, want = _both(world, q, k, v, pos, pos, causal=False)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    kv_pos = pos.copy()
    kv_pos[:, s // 2:] = 10 ** 6
    got, want = _both(world, q, k, v, pos, kv_pos)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ring_fully_masked_rows_are_zero(world):
    """Queries below every key position give exactly 0, not mean(v)."""
    rng = np.random.default_rng(2)
    b, s, h, d = 1, 16, 2, 8
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    got, want = _both(world, q, k, v, np.zeros((b, s), np.int64), np.full((b, s), 100, np.int64))
    assert np.array_equal(got, np.zeros_like(q)) and np.array_equal(want, np.zeros_like(q))


LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, max_position_embeddings=512, dtype="float32")
DS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, qk_nope_head_dim=16,
          qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=16, intermediate_size=64,
          moe_intermediate_size=32, n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
          first_k_dense_replace=1, max_position_embeddings=512, dtype="float32")


def _model(world, tmp_path, family, seed=0, **kw):
    """(JAX model, JAX params, the port's sharded model on the world)."""
    if family == "deepseek":
        jcfg, cfg = JaxDeepseekConfig(**{**DS, **kw}), DeepseekConfig(**{**DS, **kw})
        jmodel = JaxDeepseekModel(jcfg)
        jparams = jmodel.init_params(jax.random.PRNGKey(seed))
        state = deepseek_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    else:
        jcfg, cfg = JaxModelConfig(**{**LLAMA, **kw}), ModelConfig(**{**LLAMA, **kw})
        jmodel = JaxLlamaModel(jcfg)
        jparams = jmodel.init_params(jax.random.PRNGKey(seed))
        state = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    path = tmp_path / f"{family}.safetensors"
    save_file({k: v.contiguous() for k, v in state.items()}, str(path))
    spec = {"kind": "state", "family": family, "config": dataclasses.asdict(cfg),
            "path": str(path)}
    return jmodel, jparams, broadcast_model(spec, world.mesh, "cpu")


def _sp_vs_jax_paged(world, tmp_path, family, **kw):
    """forward_seq_parallel over the world == JAX's paged serving forward,
    hidden states AND the fresh KV laid out as cache blocks."""
    jmodel, jparams, model = _model(world, tmp_path, family, seed=2 if kw else 0, **kw)
    s, bs = 64, 8
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3 if kw else 1), (1, s), 0, 128))
    positions = np.arange(s, dtype=np.int64)[None, :]
    hidden, kv = world.call(sp_forward, tokens.astype(np.int64), positions, model=model)
    n_blocks = s // bs
    cache = jmodel.init_kv_cache(num_blocks=n_blocks + 1, block_size=bs)
    hidden_p, cache = jmodel.forward(
        jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32), cache,
        jnp.arange(n_blocks, dtype=jnp.int32)[None, :], jnp.asarray([s], jnp.int32),
        jnp.asarray(positions, jnp.int32))
    np.testing.assert_allclose(hidden, np.asarray(hidden_p), atol=ATOL, rtol=0)
    got = kv.reshape(kv.shape[0], 2, n_blocks, bs, -1).transpose(0, 2, 1, 3, 4)
    np.testing.assert_allclose(got, np.asarray(cache)[:, :n_blocks], atol=ATOL, rtol=0)


def test_seq_parallel_prefill_matches_paged(world, tmp_path):
    _sp_vs_jax_paged(world, tmp_path, "llama")


def test_seq_parallel_sliding_window_matches_paged(world, tmp_path):
    """The sliding window rides the ring too."""
    _sp_vs_jax_paged(world, tmp_path, "llama", sliding_window=16)


def test_deepseek_mla_seq_parallel_matches_paged(world, tmp_path):
    """Absorbed MLA: ring attention over the shared latent row."""
    _sp_vs_jax_paged(world, tmp_path, "deepseek")


def _streams(jmodel, jparams, model, world, sp_threshold):
    """(the port's greedy stream and SP prefill count, JAX's) for a
    100-token prompt on the (n, 1) meshes."""
    kw = dict(max_batch_size=2, max_model_len=256, block_size=16, num_blocks=32,
              sp_prefill_threshold=sp_threshold)
    prompt = list(range(1, 101))
    core = EngineCore(model, EngineConfig(**kw), eos_token_ids=[], device="cpu")
    toks = []
    core.submit(EngineRequest(request_id="sp", prompt=prompt,
                              sampling=SamplingOptions(temperature=0.0),
                              stops=StopConditions(max_tokens=6, ignore_eos=True),
                              emit=lambda o: toks.extend(o.token_ids)))
    for _ in range(64):
        if not core.step():
            break
    core.close()
    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**kw), mesh=_jmesh(world),
                          eos_token_ids=[])
    jtoks = []
    jcore.submit(JaxEngineRequest(
        request_id="sp", prompt=prompt, sampling=jax_protocols.SamplingOptions(temperature=0.0),
        stops=jax_protocols.StopConditions(max_tokens=6, ignore_eos=True),
        emit=lambda o: jtoks.extend(o.token_ids)))
    for _ in range(64):
        if not jcore.step():
            break
    return toks, core.sp_prefills, jtoks, jcore.sp_prefills


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_engine_sp_prefill_matches_jax_engine(world, tmp_path, family):
    """A long prompt prefills in ONE dispatch with the sequence split over
    "data" (the KV all-gathered into every data rank's cache), and the greedy
    decode after it equals JAX's meshed SP engine and the plain engine."""
    jmodel, jparams, model = _model(world, tmp_path, family)
    toks, n_sp, jtoks, jn_sp = _streams(jmodel, jparams, model, world, 64)
    plain, n_plain, _, _ = _streams(jmodel, jparams, model, world, 0)
    assert (n_sp, jn_sp, n_plain) == (1, 1, 0)
    assert len(toks) == 6 and toks == jtoks == plain


def test_deepseek_expanded_rejects_sp_at_construction(world, tmp_path):
    """The expanded MLA oracle has no ring path: an SP-configured engine
    fails at construction, before any broadcast."""
    _, _, model = _model(world, tmp_path, "deepseek", attn_impl="expanded")
    assert not model.supports_seq_parallel
    with pytest.raises(ValueError, match="seq-parallel"):
        EngineCore(model, EngineConfig(max_batch_size=2, max_model_len=256, block_size=16,
                                       num_blocks=32, sp_prefill_threshold=64),
                   eos_token_ids=[], device="cpu")


def test_renamed_axis_fails_loudly(world):
    """A mesh without the requested axis raises at the call (on rank 0,
    before any ring step); the canonical axis works."""
    import torch

    q = torch.zeros((1, 16, 4, 8))
    kv = torch.zeros((1, 16, 2, 8))
    pos = torch.arange(16)[None, :]
    with pytest.raises(ValueError, match="not in mesh axes"):
        ring_attention(q, kv, kv, pos, pos, mesh=world.mesh, axis="seq")
    out = world.call(ring_case, q.numpy(), kv.numpy(), kv.numpy(), pos.numpy(), pos.numpy(), {})
    assert out.shape == tuple(q.shape)
