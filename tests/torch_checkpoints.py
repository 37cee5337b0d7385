"""Tiny on-disk Llama checkpoints for the port's format tests, made from a
seed with numpy (no transformers import): an HF directory (config.json,
one safetensors file, a word-level tokenizer.json) and the same weights
as a GGUF file with its vocabulary."""

import json
from pathlib import Path

import numpy as np

WORDS = [f"w{i}" for i in range(60)]
SPECIALS = ["<unk>", "<s>", "</s>"]


def tiny_config(vocab_size: int = 64, hidden: int = 32, layers: int = 2, heads: int = 4,
                kv_heads: int = 2, intermediate: int = 64) -> dict:
    return {"architectures": ["LlamaForCausalLM"], "vocab_size": vocab_size,
            "hidden_size": hidden, "intermediate_size": intermediate,
            "num_hidden_layers": layers, "num_attention_heads": heads,
            "num_key_value_heads": kv_heads, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
            "max_position_embeddings": 128, "tie_word_embeddings": False,
            "bos_token_id": 1, "eos_token_id": 2}


def tiny_weights(cfg: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """HF-named float32 weights, ``[out, in]`` as HF stores them."""
    rng = np.random.default_rng(seed)
    h, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    dh = h // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * dh

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)

    out = {"model.embed_tokens.weight": w(v, h), "lm_head.weight": w(v, h),
           "model.norm.weight": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
            p + "post_attention_layernorm.weight":
                (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
            p + "self_attn.q_proj.weight": w(h, h), p + "self_attn.k_proj.weight": w(kv, h),
            p + "self_attn.v_proj.weight": w(kv, h), p + "self_attn.o_proj.weight": w(h, h),
            p + "mlp.gate_proj.weight": w(f, h), p + "mlp.up_proj.weight": w(f, h),
            p + "mlp.down_proj.weight": w(h, f)})
    return out


def vocab(cfg: dict) -> list[str]:
    words = SPECIALS + WORDS
    return (words + [f"x{i}" for i in range(cfg["vocab_size"] - len(words))])[:cfg["vocab_size"]]


def write_tokenizer(d: Path, cfg: dict) -> None:
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel(vocab={t: i for i, t in enumerate(vocab(cfg))},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(d / "tokenizer.json"))


def write_hf_dir(d: Path, seed: int = 0, **cfg_kw) -> Path:
    """config.json, model.safetensors and tokenizer.json under ``d``."""
    from safetensors.numpy import save_file

    d.mkdir(parents=True, exist_ok=True)
    cfg = tiny_config(**cfg_kw)
    (d / "config.json").write_text(json.dumps(cfg))
    save_file(tiny_weights(cfg, seed), str(d / "model.safetensors"))
    write_tokenizer(d, cfg)
    return d


GGUF_NAMES = {"input_layernorm.weight": "attn_norm.weight",
              "self_attn.q_proj.weight": "attn_q.weight",
              "self_attn.k_proj.weight": "attn_k.weight",
              "self_attn.v_proj.weight": "attn_v.weight",
              "self_attn.o_proj.weight": "attn_output.weight",
              "post_attention_layernorm.weight": "ffn_norm.weight",
              "mlp.gate_proj.weight": "ffn_gate.weight", "mlp.up_proj.weight": "ffn_up.weight",
              "mlp.down_proj.weight": "ffn_down.weight"}


def gguf_tensors(cfg: dict, weights: dict, permute_qk) -> dict[str, np.ndarray]:
    """The HF weights under llama.cpp's names, Q/K rope-permuted as its
    converter stores them."""
    out = {"token_embd.weight": weights["model.embed_tokens.weight"],
           "output_norm.weight": weights["model.norm.weight"],
           "output.weight": weights["lm_head.weight"]}
    for name, w in weights.items():
        if not name.startswith("model.layers."):
            continue
        _, _, i, rest = name.split(".", 3)
        if rest == "self_attn.q_proj.weight":
            w = permute_qk(w, cfg["num_attention_heads"])
        elif rest == "self_attn.k_proj.weight":
            w = permute_qk(w, cfg["num_key_value_heads"])
        out[f"blk.{i}.{GGUF_NAMES[rest]}"] = w
    return out


def gguf_metadata(cfg: dict) -> dict:
    toks = vocab(cfg)
    return {"general.architecture": "llama", "general.name": "tiny-gguf",
            "llama.block_count": cfg["num_hidden_layers"],
            "llama.embedding_length": cfg["hidden_size"],
            "llama.feed_forward_length": cfg["intermediate_size"],
            "llama.attention.head_count": cfg["num_attention_heads"],
            "llama.attention.head_count_kv": cfg["num_key_value_heads"],
            "llama.rope.freq_base": float(cfg["rope_theta"]),
            "llama.attention.layer_norm_rms_epsilon": float(cfg["rms_norm_eps"]),
            "llama.context_length": cfg["max_position_embeddings"],
            "llama.vocab_size": cfg["vocab_size"],
            "tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.scores": [-float(i) for i in range(len(toks))],
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}
