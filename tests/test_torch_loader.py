"""The port's HF checkpoint loader against the JAX package's and transformers.

Tiny Llama checkpoints are written here (``make_tiny_hf_checkpoint``, no
download): one ``model.safetensors``, the same tensors as two shards with a
``model.safetensors.index.json``, a tied-embedding checkpoint, and one with
Phi-3's fused ``qkv_proj`` / ``gate_up_proj``.  The port's state dict must
equal ``params_from_jax`` of the JAX loader's params exactly (f32, so the
comparison has no rounding to hide behind); with ``quantize`` its int8
codes must equal the JAX ``quantize_params`` of those params exactly and
its scales within 1e-6 relative.  The port's logits on a prompt must match
transformers' ``LlamaForCausalLM`` on the same directory within atol 1e-4
(f32 on both sides, different summation order).
"""

import json

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.models import quant as jax_quant
from dynamo_tpu.models.loader import load_model_dir as jax_load_model_dir
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.models.loader import is_deepseek_dir, load_model_dir
from tests.conftest import make_tiny_hf_checkpoint

LOGIT_ATOL = 1e-4
SCALE_RTOL = 1e-6
BS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save(dst, tensors):
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in tensors.items()}, str(dst))


def _copy_meta(src, dst):
    dst.mkdir(parents=True, exist_ok=True)
    for name in ("config.json", "tokenizer.json"):
        (dst / name).write_text((src / name).read_text())


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{kind: (directory, the HF model whose weights it holds)}."""
    root = tmp_path_factory.mktemp("loader")
    single = root / "single"
    hf = make_tiny_hf_checkpoint(single, hidden_size=64, intermediate_size=96, seed=3)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}

    # the same tensors as two shards listed in an index file
    sharded = root / "sharded"
    _copy_meta(single, sharded)
    names = sorted(sd)
    halves = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    weight_map = {}
    for fname, part in halves.items():
        _save(sharded / fname, {k: sd[k] for k in part})
        weight_map.update({k: fname for k in part})
    (sharded / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))

    # tied embeddings: no lm_head in the file
    tied = root / "tied"
    hf_tied = make_tiny_hf_checkpoint(tied, hidden_size=64, intermediate_size=96, seed=4)
    cfg = json.loads((tied / "config.json").read_text())
    cfg["tie_word_embeddings"] = True
    (tied / "config.json").write_text(json.dumps(cfg))
    tied_sd = {k: v for k, v in hf_tied.state_dict().items() if k != "lm_head.weight"}
    _save(tied / "model.safetensors", tied_sd)
    hf_tied.lm_head.weight = hf_tied.model.embed_tokens.weight

    # Phi-3 layout: q/k/v and gate/up fused into one matrix each
    fused = root / "fused"
    _copy_meta(single, fused)
    fsd = dict(sd)
    for i in range(hf.config.num_hidden_layers):
        p = f"model.layers.{i}."
        fsd[p + "self_attn.qkv_proj.weight"] = torch.cat(
            [fsd.pop(p + f"self_attn.{x}_proj.weight") for x in "qkv"])
        fsd[p + "mlp.gate_up_proj.weight"] = torch.cat(
            [fsd.pop(p + f"mlp.{x}_proj.weight") for x in ("gate", "up")])
    _save(fused / "model.safetensors", fsd)
    return {"single": (single, hf), "sharded": (sharded, hf), "tied": (tied, hf_tied),
            "fused": (fused, hf)}


def _jax_state(path, cfg, quantize=False):
    _, params = jax_load_model_dir(path, dtype="float32")
    tree = jax.tree.map(np.asarray, params)
    if quantize:
        return jax_quant.quantize_params(tree)
    return params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("kind", ["single", "sharded", "tied", "fused"])
def test_state_equals_jax_loader(dirs, kind):
    path, _ = dirs[kind]
    cfg, state = load_model_dir(path, dtype="float32", device="cpu")
    ref = _jax_state(path, cfg)
    assert set(state) == set(ref)
    assert ("lm_head" in state) == (kind != "tied")
    for name, r in ref.items():
        assert state[name].dtype == r.dtype, name
        assert torch.equal(state[name], r), name


def test_sharded_and_fused_equal_single(dirs):
    _, single = load_model_dir(dirs["single"][0], dtype="float32", device="cpu")
    for kind in ("sharded", "fused"):
        _, other = load_model_dir(dirs[kind][0], dtype="float32", device="cpu")
        assert all(torch.equal(other[k], v) for k, v in single.items()), kind


@pytest.mark.parametrize("kind", ["single", "tied"])
def test_quantized_load_equals_jax_quantize_params(dirs, kind):
    path, _ = dirs[kind]
    cfg, state = load_model_dir(path, dtype="float32", device="cpu", quantize=True)
    ref = _jax_state(path, cfg, quantize=True)
    flat = {**{k: v for k, v in ref.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in ref["layers"].items()}}
    for name, r in flat.items():
        if isinstance(r, jax_quant.QTensor):
            assert state[name].dtype == torch.int8, name
            np.testing.assert_array_equal(state[name].numpy(), np.asarray(r.q))
            np.testing.assert_allclose(state[name + "_scale"].numpy(), np.asarray(r.scale),
                                       rtol=SCALE_RTOL)
        else:
            np.testing.assert_array_equal(state[name].numpy(), np.asarray(r))
    model = LlamaModel.from_state(cfg, state)
    assert model.quantized


@pytest.mark.parametrize("kind", ["single", "tied"])
def test_logits_match_transformers(dirs, kind):
    path, hf = dirs[kind]
    cfg, state = load_model_dir(path, dtype="float32", device="cpu")
    model = LlamaModel.from_state(cfg, state)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 21)
    n = len(prompt)
    cache = model.init_kv_cache(8, BS)
    bt = torch.tensor([[2, 5, 0, 7]], dtype=torch.int32)
    pos = torch.arange(n)[None]
    slot = (bt[0, pos // BS].long() * BS + pos % BS).to(torch.int32)
    h, _ = model.forward(torch.tensor(prompt[None], dtype=torch.int32), pos.to(torch.int32),
                         cache, bt, torch.tensor([n], dtype=torch.int32), slot, prefix_blocks=0)
    out = model.compute_logits(h[0])
    with torch.no_grad():
        ref = hf.float()(torch.tensor(prompt[None])).logits[0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=LOGIT_ATOL)


def test_deepseek_and_moe_dirs_raise(tmp_path):
    ds = tmp_path / "ds"
    ds.mkdir()
    (ds / "config.json").write_text(json.dumps({"architectures": ["DeepseekV2ForCausalLM"]}))
    assert is_deepseek_dir(ds)
    with pytest.raises(NotImplementedError, match="DeepSeek"):
        load_model_dir(ds, device="cpu")
    moe = tmp_path / "moe"
    moe.mkdir()
    (moe / "config.json").write_text(json.dumps({
        "architectures": ["MixtralForCausalLM"], "vocab_size": 64, "hidden_size": 32,
        "intermediate_size": 64, "num_hidden_layers": 1, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_local_experts": 4}))
    with pytest.raises(NotImplementedError, match="MoE"):
        load_model_dir(moe, device="cpu")
