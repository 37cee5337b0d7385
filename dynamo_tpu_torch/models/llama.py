"""Llama-family decoder in PyTorch, built for paged serving.

The counterpart of ``dynamo_tpu/models/llama.py`` (dense path):
  * one forward serves prefill, chunked prefill and decode — the S new
    tokens of each sequence scatter K/V into the paged cache, in place, then
    attend over their context (ops/paged_attention.py);
  * per-layer weights are stacked on a leading L axis, with the same names
    and layouts as the JAX params tree (``wq`` is ``[L, Dm, H*D]`` and the
    product is ``x @ wq[l]``), so a JAX checkpoint carries over by
    ``models/convert.py::params_from_jax``;
  * bf16 weights and activations, f32 norms, rotary angles and logits;
  * or int8 weight-only serving (``quantized``): every projection, the
    lm_head and the embedding are int8 with per-output-channel f32 scales
    (``models/quant.py``), held as ``<name>`` int8 and ``<name>_scale``
    f32 state-dict entries in the JAX package's shapes, and the KV cache may
    be int8 too (``init_kv_cache(dtype="int8")``).

The large dense projections are ``torch.matmul`` calls (cuBLAS on the card),
as the JAX package leaves them to XLA; int8 projections are the package's
W8A16 kernel and attention is the package's own kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import CHANNEL_AXES, QTensor, matmul, take_rows
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, scale_tile
from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_layer,
    prefill_attention,
    ragged_prefill_attention,
    softcap,
    write_kv_cache_layer,
)

__all__ = ["LlamaModel", "param_shapes", "param_dtypes", "rms_norm", "rope_inv_freq", "apply_rope"]

SCALE = "_scale"  # state-dict suffix of a quantised weight's scale


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    w = weight.float()
    if unit_offset:  # Gemma stores zero-centred scales: multiply by (1 + w)
        w = w + 1.0
    return (norm * w).to(x.dtype)


def rope_inv_freq(head_dim: int, theta: float,
                  rope_scaling: Optional[dict] = None) -> np.ndarray:
    """Rotary inverse frequencies [D/2] in f32, computed in float64, with HF
    rope_scaling applied ("llama3" or "linear")."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) * 2.0 / head_dim))
    if rope_scaling:
        kind = rope_scaling.get("rope_type") or rope_scaling.get("type")
        if kind == "linear":
            inv = inv / float(rope_scaling["factor"])
        elif kind == "llama3":
            factor = float(rope_scaling["factor"])
            low = float(rope_scaling.get("low_freq_factor", 1.0))
            high = float(rope_scaling.get("high_freq_factor", 4.0))
            old_ctx = float(rope_scaling.get("original_max_position_embeddings", 8192))
            wavelen = 2.0 * np.pi / inv
            scaled = inv / factor
            smooth = np.clip((old_ctx / wavelen - low) / (high - low), 0.0, 1.0)
            interp = (1.0 - smooth) * scaled + smooth * inv
            inv = np.where(wavelen > old_ctx / low, scaled,
                           np.where(wavelen < old_ctx / high, inv, interp))
    return np.asarray(inv, np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """HF-Llama rotate-half RoPE.  x: [B,S,H,D], positions: [B,S]."""
    half = x.shape[-1] // 2
    angles = positions.float()[:, :, None] * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]  # [B,S,1,half]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def param_shapes(cfg: ModelConfig, quantized: bool = False) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape: the JAX params tree flattened with
    ``layers.`` before the stacked per-layer names (dense Llama family).

    ``quantized`` adds ``<name>_scale`` beside every int8 weight, in the
    JAX QTensor's scale shape: ``[L, 1, N]`` for a stacked ``[L, K, N]``
    projection, ``[1, V]`` for the lm_head, ``[V, 1]`` for the per-row
    embedding."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")
    dm, hq, hk, dh, f = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.intermediate_size)
    L = cfg.num_layers
    shapes = {
        "embed": (cfg.vocab_size, dm),
        "final_norm": (dm,),
        "layers.attn_norm": (L, dm),
        "layers.wq": (L, dm, hq * dh),
        "layers.wk": (L, dm, hk * dh),
        "layers.wv": (L, dm, hk * dh),
        "layers.wo": (L, hq * dh, dm),
        "layers.mlp_norm": (L, dm),
        "layers.w_gate": (L, dm, f),
        "layers.w_up": (L, dm, f),
        "layers.w_down": (L, f, dm),
    }
    if cfg.post_norms:  # Gemma2 sandwich norms
        shapes["layers.post_attn_norm"] = (L, dm)
        shapes["layers.post_mlp_norm"] = (L, dm)
    if cfg.attention_bias:  # Qwen2-style QKV bias
        shapes["layers.bq"] = (L, hq * dh)
        shapes["layers.bk"] = (L, hk * dh)
        shapes["layers.bv"] = (L, hk * dh)
    if cfg.qk_norm:  # Qwen3 per-head q/k RMSNorm
        shapes["layers.q_norm"] = (L, dh)
        shapes["layers.k_norm"] = (L, dh)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (dm, cfg.vocab_size)
    if quantized:
        for name, shape in list(shapes.items()):
            base = name.split(".", 1)[-1]
            if base in CHANNEL_AXES:
                axes = {a % len(shape) for a in CHANNEL_AXES[base]}
                if name.startswith("layers."):
                    axes.add(0)  # a scale per layer
                shapes[name + SCALE] = tuple(n if i in axes else 1 for i, n in enumerate(shape))
    return shapes


def param_dtypes(cfg: ModelConfig, quantized: bool = False) -> dict[str, torch.dtype]:
    """Each parameter's dtype: the model's, or int8 weights and f32 scales."""
    shapes = param_shapes(cfg, quantized)
    out = {}
    for name in shapes:
        if name.endswith(SCALE):
            out[name] = torch.float32
        elif name + SCALE in shapes:
            out[name] = torch.int8
        else:
            out[name] = cfg.torch_dtype
    return out


class LlamaModel(nn.Module):
    """Dense Llama-family decoder over the paged KV cache.

    Parameters are allocated uninitialised on ``device`` (cuda unless the
    caller names another); fill them with ``load_state_dict`` or build the
    model straight from a state dict with :meth:`from_state`.  With
    ``quantized`` the matmul weights are int8 with f32 scales.
    """

    # forward() accepts the token-budget ragged prefill layout (the engine
    # gates its batched prefill scheduler on this)
    supports_ragged_prefill = True
    # forward() also accepts the unified mixed layout (decode rows leading
    # the flat axis, ``ragged_row_tokens``): the engine gates the unified
    # token-budget scheduler on this
    supports_unified_dispatch = True

    def __init__(self, config: ModelConfig, device=None, quantized: bool = False):
        super().__init__()
        self.config = config
        self.quantized = quantized
        dev = resolve_device(device)
        dtypes = param_dtypes(config, quantized)
        self.layers = nn.ParameterDict()
        for name, shape in param_shapes(config, quantized).items():
            p = nn.Parameter(torch.empty(shape, dtype=dtypes[name], device=dev),
                             requires_grad=False)
            if name.startswith("layers."):
                self.layers[name.split(".", 1)[1]] = p
            else:
                self.register_parameter(name, p)
        # Gemma2 scales scores by query_pre_attn_scalar**-0.5, not head_dim
        self.sm_scale = float((config.query_pre_attn_scalar or config.head_dim) ** -0.5)
        self.register_buffer(
            "inv_freq",
            torch.from_numpy(rope_inv_freq(config.head_dim, config.rope_theta,
                                           config.rope_scaling)).to(dev),
            persistent=False,
        )

    @classmethod
    def from_state(cls, config: ModelConfig, state: dict[str, torch.Tensor]) -> "LlamaModel":
        """A model whose parameters ARE the given tensors (no copy); they
        must all lie on one device, which becomes the model's.  A state with
        ``embed_scale`` is an int8 model."""
        devices = {t.device for t in state.values()}
        if len(devices) != 1:
            raise ValueError(f"state tensors span devices {devices}")
        model = cls(config, device="meta", quantized="embed" + SCALE in state)
        model.load_state_dict(state, assign=True)
        for p in model.parameters():
            p.requires_grad_(False)
        model.inv_freq = torch.from_numpy(
            rope_inv_freq(config.head_dim, config.rope_theta, config.rope_scaling)
        ).to(devices.pop())
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # --------------------------------------------------------------- kv cache
    def init_kv_cache(self, num_blocks: int, block_size: int, dtype=None):
        """One tensor for the whole model: [L, N, 2, Bs, Hk*D], K and V of
        a block adjacent — the layout of the JAX package's cache.

        ``dtype="int8"`` gives a :class:`QuantKvCache`: an int8 payload of
        that layout and a scale pool ``[L, N, 2, Hp, Sp]`` of ones."""
        cfg = self.config
        shape = (cfg.num_layers, num_blocks, 2, block_size, cfg.num_kv_heads * cfg.head_dim)
        if str(dtype) in ("int8", "torch.int8"):
            hp, sp = scale_tile(cfg.num_kv_heads, block_size)
            return QuantKvCache(
                torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.ones((cfg.num_layers, num_blocks, 2, hp, sp), dtype=torch.float32,
                           device=self.device))
        if dtype is not None and str(dtype).replace("torch.", "") != cfg.dtype:
            raise ValueError(f"a KV cache is int8 or the model's dtype {cfg.dtype}, not {dtype}")
        return torch.zeros(shape, dtype=cfg.torch_dtype, device=self.device)

    # ---------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(
        self,
        tokens: torch.Tensor,        # [B, S] int
        positions: torch.Tensor,     # [B, S] int (absolute; padding rows may be 0)
        kv_cache,                    # [L, N, 2, Bs, Hk*D] or a QuantKvCache, updated in place
        block_tables: torch.Tensor,  # [B, M] int32
        seq_lens: torch.Tensor,      # [B] int32 — context length incl. new tokens
        slot_idx: torch.Tensor,      # [B, S] — cache slot per new token, -1 pad
        prefix_blocks: int | None = None,
        ragged: tuple | None = None,
        ragged_row_tokens: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden [B,S,Dm], kv_cache) — the cache is the same tensor,
        written in place.

        ``prefix_blocks`` activates the prefill fast path for S>1: attention
        runs against this chunk's own K/V plus at most ``prefix_blocks``
        cached prefix blocks instead of the whole block table.  Requires the
        S tokens of each row to be contiguous from the block-aligned position
        ``positions[:, 0]`` (how the engine lays out prefill).

        ``ragged = (seq_ids, starts, row_offsets)`` switches that fast path
        to the token-budget ragged form: B is 1 and the S axis packs several
        rows' chunks, each a contiguous block-aligned span.  ``seq_ids``
        [1, S] names each token's row (-1 = padding), ``starts`` and
        ``row_offsets`` [R] give each row's absolute chunk start and flat
        offset, and ``block_tables``/``seq_lens`` are per row ([R, M] / [R]).
        Requires ``prefix_blocks``.

        ``ragged_row_tokens`` marks the unified mixed layout: the first that
        many flat tokens are decode rows, one fresh token each at any
        in-block slot, so the cache write scatters them per row and only the
        block-aligned spans after them take the block write.
        """
        cfg = self.config
        b, s = tokens.shape
        dh, hq = cfg.head_dim, cfg.num_heads
        ragged_prefill = ragged is not None and prefix_blocks is not None and s > 1
        fast_prefill = prefix_blocks is not None and s > 1 and not ragged_prefill
        uo = cfg.rmsnorm_unit_offset
        start = positions[:, 0].contiguous() if fast_prefill else None
        if ragged_prefill:
            seq_ids, seq_starts, row_offsets = ragged

        hidden = take_rows(self._weight("embed"), tokens, cfg.torch_dtype)
        if cfg.scale_embeddings:  # Gemma multiplies by sqrt(hidden_size)
            hidden = hidden * torch.tensor(math.sqrt(cfg.hidden_size), dtype=hidden.dtype)
        for li in range(cfg.num_layers):
            lp = self._layer(li)
            x = rms_norm(hidden, lp["attn_norm"], cfg.rms_norm_eps, uo)
            q, k, v = _qkv_proj(cfg, lp, x, b, s)
            q = apply_rope(q, positions, self.inv_freq)
            k = apply_rope(k, positions, self.inv_freq)
            # both prefill layouts are block-aligned contiguous spans
            write_kv_cache_layer(kv_cache, li, k, v, slot_idx,
                                 block_aligned=fast_prefill or ragged_prefill,
                                 row_tokens=ragged_row_tokens if ragged_prefill else 0)
            if ragged_prefill:
                attn = ragged_prefill_attention(
                    q, k, v, kv_cache, li, block_tables, seq_lens, seq_starts, row_offsets,
                    seq_ids, prefix_blocks, sm_scale=self.sm_scale,
                    logit_cap=cfg.attn_logit_softcap, window=cfg.sliding_window,
                )
            elif fast_prefill:
                attn = prefill_attention(
                    q, k, v, kv_cache, li, block_tables, seq_lens, start, prefix_blocks,
                    sm_scale=self.sm_scale, logit_cap=cfg.attn_logit_softcap,
                    window=cfg.sliding_window,
                )
            else:
                attn = paged_attention_layer(
                    q, kv_cache, li, block_tables, seq_lens, positions,
                    sm_scale=self.sm_scale, logit_cap=cfg.attn_logit_softcap,
                    window=cfg.sliding_window,
                )
            attn_out = matmul(attn.reshape(b, s, hq * dh), lp["wo"])
            if cfg.post_norms:  # Gemma2 sandwich: norm the residual branch
                attn_out = rms_norm(attn_out, lp["post_attn_norm"], cfg.rms_norm_eps, uo)
            hidden = hidden + attn_out

            x = rms_norm(hidden, lp["mlp_norm"], cfg.rms_norm_eps, uo)
            mlp_out = _dense_mlp(cfg, lp, x)
            if cfg.post_norms:
                mlp_out = rms_norm(mlp_out, lp["post_mlp_norm"], cfg.rms_norm_eps, uo)
            hidden = hidden + mlp_out
        hidden = rms_norm(hidden, self.final_norm, cfg.rms_norm_eps, uo)
        return hidden, kv_cache

    def _weight(self, name: str):
        """Top-level parameter ``name`` as a matmul operand: a
        :class:`QTensor` of its codes and scale in an int8 model."""
        p, scale = getattr(self, name), getattr(self, name + SCALE, None)
        return p if scale is None else QTensor(p, scale)

    def _layer(self, li: int) -> dict:
        """Layer ``li``'s parameters by their JAX names; int8 weights as
        QTensors of their codes and scales."""
        lp = {}
        for name, p in self.layers.items():
            scale = self.layers.get(name + SCALE)
            if not name.endswith(SCALE):
                lp[name] = p[li] if scale is None else QTensor(p[li], scale[li])
        return lp

    @torch.no_grad()
    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden [B, Dm] -> logits [B, V] in f32.

        On the card the product runs in the weights' dtype with f32
        accumulation and an f32 result — casting the vocab matrix to f32
        would copy the largest tensor in the model every step.  An int8
        lm_head (or tied int8 embedding, read as its transpose in place) is
        the W8A16 kernel with an f32 output."""
        cfg = self.config
        # a tied embedding's per-row scales become per-column lm_head scales
        w = self._weight("embed").t() if cfg.tie_word_embeddings else self._weight("lm_head")
        if isinstance(w, QTensor):
            logits = matmul(hidden, w, out_dtype=torch.float32)
        elif w.is_cuda and w.dtype != torch.float32:
            logits = torch.mm(hidden.to(w.dtype), w, out_dtype=torch.float32)
        else:
            logits = hidden.to(w.dtype).float() @ w.float()
        cap = cfg.final_logit_softcap
        if cap:  # Gemma2 final logit softcap
            logits = softcap(logits, float(cap))
        return logits


def _qkv_proj(cfg: ModelConfig, lp: dict, x: torch.Tensor, b: int, s: int):
    """QKV projections (+ Qwen2 bias / Qwen3 per-head q-k norms)."""
    dh, hq, hk = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q, k, v = matmul(x, lp["wq"]), matmul(x, lp["wk"]), matmul(x, lp["wv"])
    if cfg.attention_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, s, hk, dh)
    if cfg.qk_norm:  # Qwen3: RMSNorm over head_dim, pre-RoPE
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return q, k, v.reshape(b, s, hk, dh)


def _act(cfg: ModelConfig, gate: torch.Tensor) -> torch.Tensor:
    """Gate activation: SiLU (Llama) or tanh-GELU (Gemma GeGLU)."""
    if cfg.hidden_activation == "gelu_tanh":
        return F.gelu(gate, approximate="tanh")
    return F.silu(gate)


def _dense_mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP: act(x·Wg) * (x·Wu) · Wd."""
    return matmul(_act(cfg, matmul(x, lp["w_gate"])) * matmul(x, lp["w_up"]), lp["w_down"])
