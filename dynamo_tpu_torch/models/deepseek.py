"""DeepSeek-V2 family (MLA + DeepSeekMoE) in PyTorch, built for paged serving.

The counterpart of ``dynamo_tpu/models/deepseek.py``:

* Multi-head Latent Attention projects hidden states through a low-rank
  latent (``kv_a`` → norm → ``kv_b``) and splits queries and keys into a
  no-position part and a small rotary part shared across heads.  RoPE is
  DeepSeek's interleaved form: adjacent element pairs rotate together.
* Two cache forms, as in the JAX package.  ``attn_impl="absorbed"`` (the
  default, the deployment shape) caches ONE latent row per token (c_hat ‖
  roped k_pe, ``kv_lora_rank + qk_rope_head_dim`` wide), stored in both the
  K and V planes of the pool; queries absorb kv_b's K-half into the latent
  space, attention runs with one KV head, and the attended latent expands
  per head through kv_b's V-half.  ``attn_impl="expanded"`` caches per-head
  K/V rows (V padded to ``qk_head_dim``): the oracle.
* The first ``first_k_dense_replace`` layers have a dense SiLU MLP, the rest
  DeepSeekMoE: an f32 softmax router (greedy or group-limited top k, times
  ``routed_scaling_factor``) over the routed experts, which run through
  ``models/llama.py::grouped_expert_dispatch`` (the grouped expert kernel on
  the card), plus always-on shared experts, a dense SiLU MLP.
* Parameters are the JAX params tree flattened: ``embed``, ``final_norm``,
  ``lm_head``, and ``dense_layers.<name>`` / ``moe_layers.<name>`` stacked on
  a leading axis per layer group (:func:`param_shapes`); the product is
  ``x @ w`` with ``w`` ``[in, out]``.

Attention runs on the plain op, ``ops/paged_attention.py::paged_attention``,
over the blocks each row's table names, whatever the device: there is no
MLA kernel in either package.  The JAX package serves this family on plain
XLA ops (``dynamo_tpu/models/deepseek.py:30-32``), because its attention
kernels take lane-friendly head dims only; the absorbed form attends at
width 576 and the expanded one at 192, outside the port's kernels too.
No int8 weights, YaRN ``rope_scaling``, ragged or unified dispatch, or
sequence-parallel prefill: the JAX package has none of these for this
family except the last, which needs more than one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.llama import grouped_expert_dispatch, rms_norm, rope_inv_freq
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, gather_layer_blocks, is_quant, scale_tile
from dynamo_tpu_torch.ops.paged_attention import paged_attention, write_kv_cache_layer

__all__ = ["DeepseekConfig", "DeepseekModel", "apply_rope_interleaved", "param_shapes",
           "router_logits", "router_weights", "limited_groups"]

GROUPS = ("dense_layers", "moe_layers")


@dataclass
class DeepseekConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    kv_lora_rank: int
    q_lora_rank: Optional[int] = None      # None = direct q_proj (V2-Lite)
    intermediate_size: int = 0             # dense-MLP layers
    moe_intermediate_size: int = 0
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0
    routed_scaling_factor: float = 1.0
    topk_method: str = "greedy"            # or "group_limited_greedy"
    n_group: int = 1
    topk_group: int = 1
    first_k_dense_replace: int = 0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    dtype: str = "bfloat16"
    attention_bias: bool = False
    # "absorbed" (the latent cache, one shared KV head) or "expanded"
    # (per-head K/V, the oracle)
    attn_impl: str = "absorbed"

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    # ---- engine-facing surface (duck-typed like ModelConfig) ----
    @property
    def num_kv_heads(self) -> int:
        return 1 if self.attn_impl == "absorbed" else self.num_heads

    @property
    def head_dim(self) -> int:
        if self.attn_impl == "absorbed":
            return self.kv_lora_rank + self.qk_rope_head_dim
        return self.qk_head_dim  # cache row width (V padded up to it)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @classmethod
    def from_hf(cls, cfg) -> "DeepseekConfig":
        """transformers DeepseekV2Config (object or dict) → DeepseekConfig.
        Raises NotImplementedError for what this model would get silently
        wrong, as the JAX package does."""
        g = (lambda k, d=None: cfg.get(k, d)) if isinstance(cfg, dict) \
            else (lambda k, d=None: getattr(cfg, k, d))
        if int(g("moe_layer_freq", 1)) != 1:
            raise NotImplementedError("moe_layer_freq != 1")
        if g("rope_scaling") not in (None, {}):
            raise NotImplementedError(
                "DeepSeek rope_scaling (yarn + mscale softmax correction) is not implemented "
                "yet — loading this checkpoint would produce silently wrong logits at every "
                "position")
        if g("topk_method", "greedy") not in ("greedy", "group_limited_greedy"):
            raise NotImplementedError(
                f"topk_method {g('topk_method')!r} (e.g. V3's noaux_tc) is not implemented")
        if bool(g("norm_topk_prob", False)):
            raise NotImplementedError("norm_topk_prob=True routing")
        if g("scoring_func", "softmax") != "softmax":
            raise NotImplementedError(f"scoring_func {g('scoring_func')!r}")
        if bool(g("attention_bias", False)):
            raise NotImplementedError("attention_bias=True (biases would be silently dropped)")
        return cls(
            vocab_size=g("vocab_size"),
            hidden_size=g("hidden_size"),
            num_layers=g("num_hidden_layers"),
            num_heads=g("num_attention_heads"),
            qk_nope_head_dim=g("qk_nope_head_dim"),
            qk_rope_head_dim=g("qk_rope_head_dim"),
            v_head_dim=g("v_head_dim"),
            kv_lora_rank=g("kv_lora_rank"),
            q_lora_rank=g("q_lora_rank"),
            intermediate_size=g("intermediate_size"),
            moe_intermediate_size=g("moe_intermediate_size", 0) or 0,
            n_routed_experts=g("n_routed_experts", 0) or 0,
            num_experts_per_tok=g("num_experts_per_tok", 0) or 0,
            n_shared_experts=g("n_shared_experts", 0) or 0,
            routed_scaling_factor=float(g("routed_scaling_factor", 1.0)),
            topk_method=g("topk_method", "greedy"),
            n_group=g("n_group", 1) or 1,
            topk_group=g("topk_group", 1) or 1,
            first_k_dense_replace=g("first_k_dense_replace", 0) or 0,
            rms_norm_eps=float(g("rms_norm_eps", 1e-6)),
            rope_theta=float(g("rope_theta", 10000.0)),
            max_position_embeddings=g("max_position_embeddings", 4096),
            attention_bias=bool(g("attention_bias", False)),
        )


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                           inv_freq: torch.Tensor) -> torch.Tensor:
    """DeepSeek rotary: adjacent element pairs (2i, 2i+1) rotate by
    pos·inv_freq[i], in f32, unlike Llama's rotate-half layout.
    x: [B,S,H,Dr], positions: [B,S]."""
    b, s, h, d = x.shape
    angles = positions.float()[:, :, None] * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]  # [B,S,1,d/2]
    sin = torch.sin(angles)[:, :, None, :]
    xr = x.float().reshape(b, s, h, d // 2, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(b, s, h, d).to(x.dtype)


def param_shapes(cfg: DeepseekConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape: the JAX params tree flattened, each
    layer group's tensors stacked on a leading axis of its layer count."""
    dm, h = cfg.hidden_size, cfg.num_heads
    qk, rope, r = cfg.qk_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    ld = cfg.first_k_dense_replace
    lm = cfg.num_layers - ld

    def attn(group: str, n: int) -> dict[str, tuple[int, ...]]:
        p = {"attn_norm": (n, dm), "mlp_norm": (n, dm), "kv_a": (n, dm, r + rope),
             "kv_a_norm": (n, r), "kv_b": (n, r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
             "wo": (n, h * cfg.v_head_dim, dm)}
        if cfg.q_lora_rank is None:
            p["wq"] = (n, dm, h * qk)
        else:
            p.update(q_a=(n, dm, cfg.q_lora_rank), q_a_norm=(n, cfg.q_lora_rank),
                     q_b=(n, cfg.q_lora_rank, h * qk))
        return {f"{group}.{k}": v for k, v in p.items()}

    f, fm, e = cfg.intermediate_size, cfg.moe_intermediate_size, cfg.n_routed_experts
    fs = fm * cfg.n_shared_experts
    return {
        "embed": (cfg.vocab_size, dm),
        **attn("dense_layers", ld),
        "dense_layers.w_gate": (ld, dm, f), "dense_layers.w_up": (ld, dm, f),
        "dense_layers.w_down": (ld, f, dm),
        **attn("moe_layers", lm),
        "moe_layers.router": (lm, dm, e),
        "moe_layers.w_gate": (lm, e, dm, fm), "moe_layers.w_up": (lm, e, dm, fm),
        "moe_layers.w_down": (lm, e, fm, dm),
        "moe_layers.shared_gate": (lm, dm, fs), "moe_layers.shared_up": (lm, dm, fs),
        "moe_layers.shared_down": (lm, fs, dm),
        "final_norm": (dm,),
        "lm_head": (dm, cfg.vocab_size),
    }


class DeepseekModel(nn.Module):
    """DeepSeek-V2 decoder over the paged KV cache, with the engine
    protocol of :class:`~dynamo_tpu_torch.models.llama.LlamaModel`.

    Parameters are allocated uninitialised on ``device`` (cuda unless the
    caller names another); fill them with ``load_state_dict`` or build the
    model straight from a state dict with :meth:`from_state`.
    """

    def __init__(self, config: DeepseekConfig, device=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        for group in GROUPS:
            setattr(self, group, nn.ParameterDict())
        for name, shape in param_shapes(config).items():
            p = nn.Parameter(torch.empty(shape, dtype=config.torch_dtype, device=dev),
                             requires_grad=False)
            group, _, base = name.rpartition(".")
            if group:
                getattr(self, group)[base] = p
            else:
                self.register_parameter(name, p)
        self.sm_scale = float(config.qk_head_dim ** -0.5)
        self.register_buffer("inv_freq", self._inv_freq(dev), persistent=False)

    def _inv_freq(self, device) -> torch.Tensor:
        cfg = self.config
        return torch.from_numpy(rope_inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta)).to(device)

    @classmethod
    def from_state(cls, config: DeepseekConfig, state: dict[str, torch.Tensor]) -> "DeepseekModel":
        """A model whose parameters ARE the given tensors (no copy); they
        must all lie on one device, which becomes the model's."""
        devices = {t.device for t in state.values()}
        if len(devices) != 1:
            raise ValueError(f"state tensors span devices {devices}")
        model = cls(config, device="meta")
        model.load_state_dict(state, assign=True)
        for p in model.parameters():
            p.requires_grad_(False)
        model.inv_freq = model._inv_freq(devices.pop())
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # --------------------------------------------------------------- kv cache
    def init_kv_cache(self, num_blocks: int, block_size: int, dtype=None):
        """One tensor for the whole model, ``[L, N, 2, Bs, Hk*D]``: absorbed,
        one latent row of ``kv_lora_rank + qk_rope_head_dim`` per token
        (Hk = 1), in both planes; expanded, per-head rows of
        ``qk_head_dim`` (V padded up to it).

        ``dtype="int8"`` gives a :class:`QuantKvCache` whose scale pool is
        laid out by ``scale_tile`` (one scale row for the absorbed form's one
        latent head).  Any dtype but int8 and the model's raises."""
        cfg = self.config
        hk = cfg.num_kv_heads
        shape = (cfg.num_layers, num_blocks, 2, block_size, hk * cfg.head_dim)
        if str(dtype) in ("int8", "torch.int8"):
            hp, sp = scale_tile(hk, block_size)
            return QuantKvCache(
                torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.ones((cfg.num_layers, num_blocks, 2, hp, sp), dtype=torch.float32,
                           device=self.device))
        if dtype is not None and str(dtype).replace("torch.", "") != cfg.dtype:
            raise NotImplementedError(f"MLA cache dtype {dtype!r}")
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
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden [B,S,Dm], kv_cache), the cache written in place.
        ``prefix_blocks`` is accepted for the engine: MLA always attends
        over the whole block table."""
        cfg = self.config
        hidden = self.embed[tokens.long()].to(cfg.torch_dtype)
        ld = cfg.first_k_dense_replace
        for li in range(cfg.num_layers):  # the cache's layer index is absolute
            dense = li < ld
            lp = self._layer("dense_layers", li) if dense else self._layer("moe_layers", li - ld)
            hidden = self._attention(lp, li, hidden, positions, kv_cache, block_tables, seq_lens,
                                     slot_idx)
            x = rms_norm(hidden, lp["mlp_norm"], cfg.rms_norm_eps)
            hidden = hidden + (_dense_mlp(lp, x) if dense else _moe_mlp(cfg, lp, x))
        hidden = rms_norm(hidden, self.final_norm, cfg.rms_norm_eps)
        return hidden, kv_cache

    def _layer(self, group: str, i: int) -> dict[str, torch.Tensor]:
        """Layer ``i`` of ``group``'s parameters by their JAX names."""
        return {name: p[i] for name, p in getattr(self, group).items()}

    def _qkv_latent(self, lp, x, positions):
        """Shared front half of both attention forms: per-head queries
        (nope ‖ roped pe) and the per-token latent pieces."""
        cfg = self.config
        b, s, _ = x.shape
        nope = cfg.qk_nope_head_dim
        if cfg.q_lora_rank is None:
            q = x @ lp["wq"]
        else:
            q = rms_norm(x @ lp["q_a"], lp["q_a_norm"], cfg.rms_norm_eps) @ lp["q_b"]
        q = q.reshape(b, s, cfg.num_heads, cfg.qk_head_dim)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        q_pe = apply_rope_interleaved(q_pe, positions, self.inv_freq)

        ckv = x @ lp["kv_a"]  # [B,S, kv_lora + rope]
        c_kv, k_pe = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
        c_hat = rms_norm(c_kv, lp["kv_a_norm"], cfg.rms_norm_eps)
        k_pe = apply_rope_interleaved(k_pe[:, :, None, :], positions, self.inv_freq)
        return q_nope, q_pe, c_hat, k_pe  # k_pe [B,S,1,rope]: shared across heads

    def _attention(self, lp, li, h_in, positions, cache, block_tables, seq_lens, slot_idx):
        if self.config.attn_impl == "absorbed":
            return self._attention_absorbed(lp, li, h_in, positions, cache, block_tables,
                                            seq_lens, slot_idx)
        return self._attention_expanded(lp, li, h_in, positions, cache, block_tables, seq_lens,
                                        slot_idx)

    def _attention_expanded(self, lp, li, h_in, positions, cache, block_tables, seq_lens,
                            slot_idx):
        """Oracle form: per-head K/V as a GQA model caches them (row
        H·qk_head_dim, V padded)."""
        cfg = self.config
        b, s = positions.shape
        nh, nope, vd = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
        x = rms_norm(h_in, lp["attn_norm"], cfg.rms_norm_eps)
        q_nope, q_pe, c_hat, k_pe = self._qkv_latent(lp, x, positions)
        kv = (c_hat @ lp["kv_b"]).reshape(b, s, nh, nope + vd)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        q = torch.cat([q_nope, q_pe], dim=-1)  # [B,S,H,qk_head]
        k = torch.cat([k_nope, k_pe.expand(b, s, nh, cfg.qk_rope_head_dim)], dim=-1)
        v_pad = F.pad(v, (0, cfg.qk_head_dim - vd))  # sliced back after attention
        write_kv_cache_layer(cache, li, k, v_pad, slot_idx)
        attn = self._paged(q, cache, li, block_tables, seq_lens, positions)
        attn = attn[..., :vd].reshape(b, s, nh * vd)
        return h_in + attn @ lp["wo"]

    def _absorbed_qkv(self, lp, h_in, positions):
        """Queries projected into the latent space through kv_b's K-half,
        and the one shared KV row.  Returns (q_lat [B,S,H,r+rope], row
        [B,S,1,r+rope], w_v [r,H,v]).  The absorption identity:
          q_nope[h]·k_nope[h] = q_nope[h]·(Wk[h]ᵀ c_hat) = (Wk[h] q_nope[h])·c_hat."""
        cfg = self.config
        nh, nope, vd, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
        x = rms_norm(h_in, lp["attn_norm"], cfg.rms_norm_eps)
        q_nope, q_pe, c_hat, k_pe = self._qkv_latent(lp, x, positions)
        kv_b = lp["kv_b"].reshape(r, nh, nope + vd)
        w_k, w_v = kv_b[..., :nope], kv_b[..., nope:]   # [r, H, nope], [r, H, vd]
        q_eff = torch.einsum("bshn,rhn->bshr", q_nope, w_k)
        q_lat = torch.cat([q_eff, q_pe], dim=-1)
        row = torch.cat([c_hat[:, :, None, :], k_pe], dim=-1)  # the one KV row; K == V
        return q_lat, row, w_v

    def _absorbed_out(self, lp, h_in, attn, w_v):
        """Expand the attended latents per head through kv_b's V-half and
        project out."""
        cfg = self.config
        b, s = h_in.shape[:2]
        out = torch.einsum("bshr,rhv->bshv", attn[..., :cfg.kv_lora_rank], w_v)
        return h_in + out.reshape(b, s, cfg.num_heads * cfg.v_head_dim) @ lp["wo"]

    def _attention_absorbed(self, lp, li, h_in, positions, cache, block_tables, seq_lens,
                            slot_idx):
        """Absorbed form: attention with ONE shared KV head whose row is the
        cached latent (c_hat ‖ k_pe), written as both K and V."""
        q_lat, row, w_v = self._absorbed_qkv(lp, h_in, positions)
        write_kv_cache_layer(cache, li, row, row, slot_idx)
        attn = self._paged(q_lat, cache, li, block_tables, seq_lens, positions)
        return self._absorbed_out(lp, h_in, attn, w_v)  # attn: attended latents per head

    def _paged(self, q, cache, li, block_tables, seq_lens, positions) -> torch.Tensor:
        """The plain op over the blocks the rows' tables name.  An int8
        cache is dequantised for those blocks only (under local tables),
        not for the layer's whole pool."""
        cfg = self.config
        hk, d = cfg.num_kv_heads, cfg.head_dim
        if is_quant(cache):
            b, m = block_tables.shape
            pool = gather_layer_blocks(cache, li, block_tables, hk).reshape(b * m, 2, -1, hk * d)
            block_tables = torch.arange(b * m, device=q.device, dtype=torch.int32).reshape(b, m)
        else:
            pool = cache[li]
        n, _, bs, _ = pool.shape
        return paged_attention(q, pool[:, 0].reshape(n, bs, hk, d), pool[:, 1].reshape(n, bs, hk, d),
                               block_tables, seq_lens, positions, self.sm_scale)

    @torch.no_grad()
    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden [B, Dm] -> logits [B, V] in f32: on the card a product in
        the weights' dtype with f32 accumulation and result."""
        w = self.lm_head
        if w.is_cuda and w.dtype != torch.float32:
            return torch.mm(hidden.to(w.dtype), w, out_dtype=torch.float32)
        return hidden.to(w.dtype).float() @ w.float()


def _dense_mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]


def router_logits(lp: dict, xf: torch.Tensor) -> torch.Tensor:
    """The router's logits [T, E], in f32 on every device: inputs and
    weights cast before the product, as the JAX package and transformers
    gate, so near-tied experts resolve alike."""
    return xf.float() @ lp["router"].float()


def router_weights(cfg: DeepseekConfig, logits: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The weights of experts ``topi`` [T, k]: their softmax scores over all
    experts, times ``routed_scaling_factor``."""
    return torch.softmax(logits, dim=-1).gather(-1, topi) * cfg.routed_scaling_factor


def _moe_router(cfg: DeepseekConfig, lp: dict, xf: torch.Tensor):
    """Each token's experts and weights: xf [T, Dm] -> (weights [T, k] f32,
    topi [T, k] int64).  Softmax scores; with group-limited routing only the
    ``topk_group`` groups with the highest best expert keep their scores
    (the rest score 0); then the top k, whose weights are their scores times
    ``routed_scaling_factor``.  Both top-k picks are stable descending
    sorts, so ties keep the lower index first, as ``jax.lax.top_k``."""
    logits = router_logits(lp, xf)
    scores = torch.softmax(logits, dim=-1)
    if cfg.topk_method == "group_limited_greedy":
        keep = limited_groups(cfg, scores)
        gmask = torch.zeros((xf.shape[0], cfg.n_group), dtype=scores.dtype, device=scores.device)
        gmask.scatter_(1, keep, 1.0)
        scores = scores * gmask.repeat_interleave(cfg.n_routed_experts // cfg.n_group, dim=-1)
    topi = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    topi = topi[:, :cfg.num_experts_per_tok]
    return scores.gather(-1, topi) * cfg.routed_scaling_factor, topi


def limited_groups(cfg: DeepseekConfig, scores: torch.Tensor) -> torch.Tensor:
    """Group-limited routing's groups: each token's ``topk_group`` groups
    [T, topk_group] with the highest best expert score (``scores`` [T, E]),
    ties to the lower group."""
    best = scores.reshape(scores.shape[0], cfg.n_group, -1).amax(dim=-1)  # [T, G]
    return torch.sort(best, dim=-1, descending=True, stable=True).indices[:, :cfg.topk_group]


def _moe_mlp(cfg: DeepseekConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """DeepSeekMoE: the routed experts through the grouped dispatch, plus
    the shared experts as a dense SiLU MLP."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    weights, topi = _moe_router(cfg, lp, xf)
    routed = grouped_expert_dispatch(xf, weights, topi, cfg.n_routed_experts, lp["w_gate"],
                                     lp["w_up"], lp["w_down"], F.silu)
    shared = (F.silu(xf @ lp["shared_gate"]) * (xf @ lp["shared_up"])) @ lp["shared_down"]
    return (routed + shared).reshape(b, s, d)
