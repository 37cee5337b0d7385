"""The port's HF checkpoint loader against the JAX package's and transformers.

Tiny Llama checkpoints are written here (``make_tiny_hf_checkpoint``, no
download): one ``model.safetensors``, the same tensors as two shards with a
``model.safetensors.index.json``, a tied-embedding checkpoint, and one with
Phi-3's fused ``qkv_proj`` / ``gate_up_proj``; and two mixture-of-experts
checkpoints made by transformers, Mixtral's naming (``block_sparse_moe``,
``w1``/``w3``/``w2``) and Qwen3-MoE's (``mlp.gate``, ``gate/up/down_proj``,
``norm_topk_prob`` false), whose ``ModelConfig.from_hf_config`` must also
equal the JAX package's; and a tiny DeepSeek-V2 checkpoint made by
transformers, whose ``load_deepseek_dir`` must equal the JAX package's
``load_deepseek_dir`` (f32 and bf16) and whose logits must match
transformers' ``DeepseekV2ForCausalLM``.  The port's state dict must
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
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.loader import load_deepseek_dir as jax_load_deepseek_dir
from dynamo_tpu.models.loader import load_model_dir as jax_load_model_dir
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import deepseek_params_from_jax, params_from_jax
from dynamo_tpu_torch.models.deepseek import DeepseekModel
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.models.loader import is_deepseek_dir, load_deepseek_dir, load_model_dir
from tests.conftest import make_tiny_hf_checkpoint

LOGIT_ATOL = 1e-4
DEEPSEEK_LOGIT_ATOL = 2e-4  # tests/test_deepseek.py's bound against transformers
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
            "fused": (fused, hf), "mixtral": _moe_checkpoint(root / "mixtral", "mixtral", 5),
            "qwen3-moe": _moe_checkpoint(root / "qwen3-moe", "qwen3-moe", 6),
            "deepseek": deepseek_checkpoint(root / "deepseek", 8)}


def _moe_hf(family: str):
    """A tiny transformers config of ``family`` and its config.json dict."""
    from transformers import MixtralConfig, Qwen3MoeConfig

    if family == "mixtral":
        cfg = MixtralConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                            num_local_experts=4, num_experts_per_tok=2,
                            max_position_embeddings=256, tie_word_embeddings=False)
        arch = "MixtralForCausalLM"
    else:
        cfg = Qwen3MoeConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                             moe_intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
                             num_key_value_heads=2, head_dim=16, num_experts=4,
                             num_experts_per_tok=2, norm_topk_prob=False,
                             max_position_embeddings=256, tie_word_embeddings=False)
        arch = "Qwen3MoeForCausalLM"
    d = cfg.to_dict()
    d["architectures"] = [arch]
    for key in ("bos_token_id", "eos_token_id", "pad_token_id"):
        d.pop(key, None)  # no stop token: greedy streams run to their length
    return cfg, d


def _moe_checkpoint(dst, family: str, seed: int):
    """(directory, transformers model) of a tiny MoE checkpoint with a
    word-level tokenizer of its 128 ids."""
    from transformers import MixtralForCausalLM, Qwen3MoeForCausalLM

    dst.mkdir(parents=True)
    cfg, d = _moe_hf(family)
    (dst / "config.json").write_text(json.dumps(d))
    torch.manual_seed(seed)
    hf = (MixtralForCausalLM if family == "mixtral" else Qwen3MoeForCausalLM)(cfg).eval()
    _save(dst / "model.safetensors", hf.state_dict())
    _word_tokenizer(dst, 128)
    return dst, hf


def _word_tokenizer(dst, size: int) -> None:
    """A word-level tokenizer.json: ``w0`` ... and ``[UNK]`` as the last id."""
    from tokenizers import Tokenizer
    from tokenizers import models as tkm
    from tokenizers import pre_tokenizers

    vocab = {f"w{i}": i for i in range(size - 1)}
    vocab["[UNK]"] = size - 1
    tok = Tokenizer(tkm.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(dst / "tokenizer.json"))


# a tiny DeepSeek-V2: tests/test_deepseek.py's widths, with q-LoRA and
# group-limited routing, so every tensor name of the family is in the file
DEEPSEEK_HF = dict(vocab_size=96, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                   num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
                   n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
                   routed_scaling_factor=1.5, kv_lora_rank=16, q_lora_rank=24,
                   qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                   topk_method="group_limited_greedy", n_group=4, topk_group=2,
                   norm_topk_prob=False, first_k_dense_replace=1, moe_layer_freq=1,
                   max_position_embeddings=256, attention_bias=False, aux_loss_alpha=0.0)


def deepseek_checkpoint(dst, seed: int):
    """(directory, transformers model) of a tiny DeepSeek-V2 checkpoint, f32
    safetensors and a word-level tokenizer of its 96 ids, no stop token."""
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    dst.mkdir(parents=True)
    cfg = DeepseekV2Config(**DEEPSEEK_HF)
    d = cfg.to_dict()
    d["architectures"] = ["DeepseekV2ForCausalLM"]
    for key in ("bos_token_id", "eos_token_id", "pad_token_id"):
        d.pop(key, None)  # no stop token: greedy streams run to their length
    (dst / "config.json").write_text(json.dumps(d))
    torch.manual_seed(seed)
    hf = DeepseekV2ForCausalLM(cfg).eval()
    _save(dst / "model.safetensors", hf.state_dict())
    _word_tokenizer(dst, DEEPSEEK_HF["vocab_size"])
    return dst, hf


def _jax_state(path, cfg, quantize=False):
    _, params = jax_load_model_dir(path, dtype="float32")
    tree = jax.tree.map(np.asarray, params)
    if quantize:
        return jax_quant.quantize_params(tree)
    return params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("kind", ["single", "sharded", "tied", "fused", "mixtral", "qwen3-moe"])
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


@pytest.mark.parametrize("kind", ["single", "tied", "mixtral", "qwen3-moe"])
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


@pytest.mark.parametrize("kind", ["single", "tied", "mixtral", "qwen3-moe"])
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
    """A DeepSeek directory is refused by ``load_model_dir`` (the CLI sends
    it to ``load_deepseek_dir``), and one with YaRN ``rope_scaling`` is
    refused by ``load_deepseek_dir`` with the JAX package's error; an MoE
    directory is no longer refused, so one without weights raises only for
    the missing safetensors."""
    ds = tmp_path / "ds"
    ds.mkdir()
    (ds / "config.json").write_text(json.dumps({"architectures": ["DeepseekV2ForCausalLM"]}))
    assert is_deepseek_dir(ds)
    with pytest.raises(ValueError, match="load_deepseek_dir"):
        load_model_dir(ds, device="cpu")
    (ds / "config.json").write_text(json.dumps({
        "architectures": ["DeepseekV2ForCausalLM"], **DEEPSEEK_HF,
        "rope_scaling": {"type": "yarn", "factor": 40, "mscale": 0.707}}))
    with pytest.raises(NotImplementedError, match="rope_scaling") as err:
        load_deepseek_dir(ds, device="cpu")
    with pytest.raises(NotImplementedError) as ref:
        jax_load_deepseek_dir(ds)
    assert str(err.value) == str(ref.value)
    moe = tmp_path / "moe"
    moe.mkdir()
    (moe / "config.json").write_text(json.dumps({
        "architectures": ["MixtralForCausalLM"], "vocab_size": 64, "hidden_size": 32,
        "intermediate_size": 64, "num_hidden_layers": 1, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_local_experts": 4}))
    assert not is_deepseek_dir(moe)
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        load_model_dir(moe, device="cpu")


@pytest.mark.parametrize("family", ["mixtral", "qwen3-moe"])
def test_moe_config_matches_jax(family):
    """``from_hf_config`` on MoE dicts equals the JAX package's, field for
    field: experts, top k, the expert width (Qwen3-MoE's
    ``moe_intermediate_size``), ``norm_topk_prob`` as given and by each
    family's default (Mixtral renormalises, Qwen3-MoE does not), and the
    refusal of a stack with dense layers."""
    import dataclasses

    d = _moe_hf(family)[1]
    for variant in (d, {k: v for k, v in d.items() if k != "norm_topk_prob"}):
        port = dataclasses.asdict(ModelConfig.from_hf_config(variant, dtype="float32"))
        ref = dataclasses.asdict(JaxModelConfig.from_hf_config(variant, dtype="float32"))
        assert port == ref
        assert port["num_experts"] == 4 and port["num_experts_per_tok"] == 2
    assert ModelConfig.from_hf_config(
        {k: v for k, v in d.items() if k != "norm_topk_prob"}).norm_topk_prob == (family == "mixtral")
    if family == "qwen3-moe":
        assert ModelConfig.from_hf_config(d).intermediate_size == 48
        for bad in ({"decoder_sparse_step": 2}, {"mlp_only_layers": [0]}):
            for cls in (ModelConfig, JaxModelConfig):
                with pytest.raises(ValueError, match="non-uniform"):
                    cls.from_hf_config({**d, **bad})


def test_moe_dir_served_through_the_front_door(dirs):
    """``build_local_engine`` on the Qwen3-MoE directory (CPU, f32) behind
    the port's ``HttpService``: a greedy completion of a token-id prompt
    equals transformers' greedy generation on the same checkpoint."""
    import asyncio

    import aiohttp

    from dynamo_tpu_torch.cli import build_local_engine, parse_args
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService

    path, hf = dirs["qwen3-moe"]
    prompt = np.random.default_rng(3).integers(0, 127, 11).tolist()
    with torch.no_grad():
        ref = hf.float().generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False,
                                  eos_token_id=None, pad_token_id=0)[0, len(prompt):].tolist()
    engine, card = build_local_engine(parse_args([
        "run", "in=http", "out=gpu", "--device", "cpu", "--dtype", "float32",
        "--model-path", str(path), "--model-name", "moe", "--max-model-len", "64",
        "--num-blocks", "16", "--max-batch-size", "2"]))

    async def serve():
        svc = HttpService(port=0, core=engine.core)
        svc.manager.add_model("moe", build_serving_pipeline(engine, card), card)
        await svc.start()
        try:
            async with aiohttp.ClientSession() as s:
                async with s.post(f"http://127.0.0.1:{svc.port}/v1/completions", json={
                        "model": "moe", "prompt": prompt, "max_tokens": 6,
                        "temperature": 0}) as r:
                    return r.status, await r.json()
        finally:
            await svc.stop()

    loop = asyncio.new_event_loop()
    try:
        status, body = loop.run_until_complete(serve())
    finally:
        loop.close()
        engine.shutdown()
    assert engine.core.model.config.is_moe
    assert status == 200 and body["choices"][0]["finish_reason"] == "length"
    assert body["choices"][0]["text"].split() == [f"w{t}" for t in ref]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_dir_equals_jax_loader(dirs, dtype):
    """``load_deepseek_dir`` against the JAX package's ``load_deepseek_dir``:
    the same config, and every tensor equal (HF ``[out, in]`` transposed,
    the dense layer and the MoE layers in their groups, experts stacked),
    in f32 and rounded to bf16 alike; the card reads the directory."""
    import dataclasses

    path, _ = dirs["deepseek"]
    cfg, state = load_deepseek_dir(path, dtype=dtype, device="cpu")
    jcfg, params = jax_load_deepseek_dir(path, dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ref = deepseek_params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    assert set(state) == set(ref)
    for name, r in ref.items():
        assert state[name].dtype == r.dtype == cfg.torch_dtype, name
        assert torch.equal(state[name], r), name
    card = ModelDeploymentCard.from_hf_dir(path)
    assert card.context_length == 256 and card.tokenizer_path and card.eos_token_ids == []


def test_deepseek_logits_match_transformers(dirs):
    path, hf = dirs["deepseek"]
    cfg, state = load_deepseek_dir(path, dtype="float32", device="cpu")
    model = DeepseekModel.from_state(cfg, state)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 21)
    n = len(prompt)
    cache = model.init_kv_cache(8, BS)
    bt = torch.tensor([[2, 5, 0, 7]], dtype=torch.int32)
    pos = torch.arange(n)[None]
    slot = (bt[0, pos // BS].long() * BS + pos % BS).to(torch.int32)
    h, _ = model.forward(torch.tensor(prompt[None], dtype=torch.int32), pos.to(torch.int32),
                         cache, bt, torch.tensor([n], dtype=torch.int32), slot)
    with torch.no_grad():
        ref = hf(torch.tensor(prompt[None])).logits[0]
    np.testing.assert_allclose(model.compute_logits(h[0]).numpy(), ref.numpy(),
                               atol=DEEPSEEK_LOGIT_ATOL)
