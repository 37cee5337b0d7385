"""Llama-family decoder in PyTorch, built for paged serving.

The counterpart of ``dynamo_tpu/models/llama.py``:
  * one forward serves prefill, chunked prefill and decode — the S new
    tokens of each sequence scatter K/V into the paged cache, in place, then
    attend over their context (ops/paged_attention.py);
  * per-layer weights are stacked on a leading L axis, with the same names
    and layouts as the JAX params tree (``wq`` is ``[L, Dm, H*D]`` and the
    product is ``x @ wq[l]``), so a JAX checkpoint carries over by
    ``models/convert.py::params_from_jax``;
  * weights and activations in the config's dtype (bf16, or fp16, on the
    card; any float dtype on the CPU), f32 norms, rotary angles and logits;
  * or int8 weight-only serving (``quantized``): every projection, the
    lm_head and the embedding are int8 with per-output-channel f32 scales
    (``models/quant.py``), held as ``<name>`` int8 and ``<name>_scale``
    f32 state-dict entries in the JAX package's shapes, and the KV cache may
    be int8 too (``init_kv_cache(dtype="int8")``);
  * mixture-of-experts layers (Mixtral, Qwen3-MoE: ``cfg.is_moe``): a dense
    f32-logit router picks each token's top-k experts, and the experts'
    three projections run as grouped products over the tokens sorted by
    expert (:func:`grouped_expert_dispatch`), bf16 or int8 stacks alike.

The large dense projections are ``torch.matmul`` calls (cuBLAS on the card),
as the JAX package leaves them to XLA; int8 projections are the package's
W8A16 kernel, the experts' products its grouped expert kernel, and
attention its own kernels.

Tensor parallelism (``mesh``, ``utils/mesh.py``): each rank of the mesh's
"model" axis holds the slices :func:`partition_specs` names, the layout of
the JAX package's specs — q/k/v and gate/up split by column (whole heads,
whole F slices), ``wo`` and ``w_down`` by row, the lm_head over the vocab,
MoE experts over F (TP within experts), the embedding, norms and router
whole — and runs the same forward on them: an all-reduce after ``wo`` and
after ``w_down`` (the MoE combine included) sums the row-parallel partial
products, and :meth:`LlamaModel.compute_logits` all-gathers the vocab
shards.  Ranks on the "data" axis hold the same slices.  Each rank's cache
is ``[L, N, 2, Bs, Hk_r*D]`` over its own kv heads (:func:`kv_head_range`:
Hk/tp of them when tp divides Hk; when Hk divides tp, the ONE kv head that
every query head of the rank reads, the same head on tp/Hk ranks; other
splits raise), and its int8 scale pool ``scale_tile(Hk_r, Bs)``.  The JAX
package shards its padded scale tile instead; the values held are the same.
:meth:`LlamaModel.forward_seq_parallel` is the long-prompt prefill with the
sequence split over a mesh axis (``ops/ring_attention.py``).
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
from dynamo_tpu_torch.models.quant import (
    CHANNEL_AXES, QTensor, align_specs, dequantize, grouped_matmul, matmul, prune_specs,
    shard_cutter, stacked_channel_axes, take_rows)
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, resolve_cache_dtype, scale_tile
from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_layer,
    prefill_attention,
    ragged_prefill_attention,
    softcap,
    write_kv_cache_layer,
)
from dynamo_tpu_torch.utils.mesh import AXIS_MODEL, AXIS_SP

__all__ = ["LlamaModel", "param_shapes", "param_dtypes", "rms_norm", "rope_inv_freq", "apply_rope",
           "grouped_expert_dispatch", "router_weights", "partition_specs", "kv_head_range",
           "shard_plan"]

SCALE = "_scale"  # state-dict suffix of a quantised weight's scale
_TP = AXIS_MODEL


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
    ``layers.`` before the stacked per-layer names.  An MoE model has the
    router ``[L, Dm, E]`` and expert stacks ``[L, E, Dm, F]`` (gate, up) and
    ``[L, E, F, Dm]`` (down) in place of the dense MLP.

    ``quantized`` adds ``<name>_scale`` beside every int8 weight, in the
    JAX QTensor's scale shape: ``[L, 1, N]`` for a stacked ``[L, K, N]``
    projection, ``[L, E, 1, N]`` for an expert stack, ``[1, V]`` for the
    lm_head, ``[V, 1]`` for the per-row embedding."""
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
    }
    if cfg.is_moe:
        e = cfg.num_experts
        shapes.update({"layers.router": (L, dm, e), "layers.w_gate": (L, e, dm, f),
                       "layers.w_up": (L, e, dm, f), "layers.w_down": (L, e, f, dm)})
    else:
        shapes.update({"layers.w_gate": (L, dm, f), "layers.w_up": (L, dm, f),
                       "layers.w_down": (L, f, dm)})
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
                # a scale per layer (and expert) and output channel; per row for embed
                axes = CHANNEL_AXES[base] if base == "embed" else stacked_channel_axes(
                    len(shape), CHANNEL_AXES[base])
                axes = {a % len(shape) for a in axes}
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


def partition_specs(cfg: ModelConfig) -> dict[str, tuple]:
    """The split of every parameter over the mesh's "model" axis, by state
    name (the JAX package's ``LlamaModel.partition_specs``): q/k/v and
    gate/up by column, ``wo`` and ``w_down`` by row, MoE experts over F,
    the lm_head over the vocab; the embedding, norms and router whole (no
    entry)."""
    col, row = (None, None, _TP), (None, _TP, None)
    specs = {"layers.wq": col, "layers.wk": col, "layers.wv": col, "layers.wo": row}
    if cfg.attention_bias:
        specs.update({"layers.bq": (None, _TP), "layers.bk": (None, _TP),
                      "layers.bv": (None, _TP)})
    if cfg.is_moe:
        specs.update({"layers.w_gate": (None, None, None, _TP),
                      "layers.w_up": (None, None, None, _TP),
                      "layers.w_down": (None, None, _TP, None)})
    else:
        specs.update({"layers.w_gate": col, "layers.w_up": col, "layers.w_down": row})
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, _TP)
    return specs


def kv_head_range(num_heads: int, num_kv_heads: int, tp: int, rank: int) -> tuple[int, int]:
    """(first, count) of the kv heads model rank ``rank`` of ``tp`` keeps:
    the heads its query heads (``num_heads / tp`` consecutive ones) read.
    Hk/tp heads when tp divides Hk; when Hk divides tp, one head, shared by
    tp/Hk ranks.  Any other split would give a rank a ragged group of query
    heads per kv head, and raises."""
    if num_heads % tp:
        raise ValueError(f"{num_heads} query heads do not split over tp={tp}")
    if num_kv_heads % tp == 0:
        count = num_kv_heads // tp
        return rank * count, count
    if tp % num_kv_heads == 0:
        return rank // (tp // num_kv_heads), 1
    raise ValueError(f"{num_kv_heads} kv heads split over tp={tp} neither evenly nor one "
                     "per rank")


def shard_plan(cfg: ModelConfig, quantized: bool, mesh) -> tuple[dict, dict]:
    """(specs, blocks) of this rank's slice: :func:`partition_specs` pruned
    against the mesh and aligned onto the int8 scales, and the explicit
    kv-head column ranges (:func:`kv_head_range`) when tp does not divide
    Hk."""
    shapes = param_shapes(cfg, quantized)
    specs = align_specs(shapes, prune_specs(shapes, partition_specs(cfg), mesh))
    tp = mesh.axis_size(_TP)
    blocks = {}
    if tp > 1 and cfg.num_kv_heads % tp:
        first, count = kv_head_range(cfg.num_heads, cfg.num_kv_heads, tp, mesh.axis_index(_TP))
        cols = (-1, first * cfg.head_dim, (first + count) * cfg.head_dim)
        for name in ("layers.wk", "layers.wv", "layers.bk", "layers.bv"):
            if name in shapes:
                blocks[name] = cols
    return specs, blocks


class LlamaModel(nn.Module):
    """Llama-family decoder (dense or mixture-of-experts) over the paged KV
    cache.

    Parameters are allocated uninitialised on ``device`` (cuda unless the
    caller names another); fill them with ``load_state_dict`` or build the
    model straight from a state dict with :meth:`from_state`.  With
    ``quantized`` the matmul weights are int8 with f32 scales.  With a
    ``mesh`` of more than one rank the parameters are this rank's slices
    (:func:`shard_plan`) and the forward runs the mesh's collectives.
    """

    # forward() accepts the token-budget ragged prefill layout (the engine
    # gates its batched prefill scheduler on this)
    supports_ragged_prefill = True
    # forward() also accepts the unified mixed layout (decode rows leading
    # the flat axis, ``ragged_row_tokens``): the engine gates the unified
    # token-budget scheduler on this
    supports_unified_dispatch = True

    def __init__(self, config: ModelConfig, device=None, quantized: bool = False, mesh=None):
        super().__init__()
        self.config = config
        self.quantized = quantized
        dev = resolve_device(device)
        dtypes = param_dtypes(config, quantized)
        self.layers = nn.ParameterDict()
        shapes = param_shapes(config, quantized)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        # this rank's query and kv heads, and which row-parallel products
        # (and the lm_head's vocab) are split over "model"
        self.heads = (config.num_heads, config.num_kv_heads)
        self.split = dict.fromkeys(("layers.wo", "layers.w_down", "lm_head"), False)
        if self.mesh is not None:
            specs, blocks = shard_plan(config, quantized, self.mesh)
            tp = self.mesh.axis_size(_TP)
            self.heads = (config.num_heads // tp, kv_head_range(
                config.num_heads, config.num_kv_heads, tp, self.mesh.axis_index(_TP))[1])
            self.split = {n: _TP in specs.get(n, ()) for n in self.split}
            cut = shard_cutter(shapes, specs, self.mesh, blocks)
            shapes = {name: cut(name, shape) for name, shape in shapes.items()}
        for name, shape in shapes.items():
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
    def from_state(cls, config: ModelConfig, state: dict[str, torch.Tensor],
                   mesh=None) -> "LlamaModel":
        """A model whose parameters ARE the given tensors (no copy); they
        must all lie on one device, which becomes the model's.  A state with
        ``embed_scale`` is an int8 model.  On a ``mesh`` the state is this
        rank's slice (``models/quant.py::shard_state``)."""
        devices = {t.device for t in state.values()}
        if len(devices) != 1:
            raise ValueError(f"state tensors span devices {devices}")
        model = cls(config, device="meta", quantized="embed" + SCALE in state, mesh=mesh)
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

    def partition_specs(self) -> dict[str, tuple]:
        return partition_specs(self.config)

    def full_shapes(self) -> dict[str, tuple[int, ...]]:
        """Every parameter's shape in the whole model, by state name (a mesh
        rank holds slices of them)."""
        return param_shapes(self.config, self.quantized)

    def cache_spec(self, quant: bool = False):
        """The cache's split over "model": the trailing axis is
        kv-head-major, so splitting it gives each rank whole kv heads
        (:func:`kv_head_range` says which).  The int8 scale pool splits its
        head axis with them only when Hk is tile-exact (Hk % 8 == 0, so the
        padded head axis holds real heads only), as the JAX package's spec
        does; otherwise every rank re-pads its own heads' scales to a whole
        (8, Sp) tile (``ops/kv_quant.py::scale_tile``), the pool's bytes on
        every rank: replicated."""
        data = (None, None, None, None, _TP)
        if not quant:
            return data
        head = _TP if self.config.num_kv_heads % 8 == 0 else None
        return QuantKvCache(data, (None, None, None, head, None))

    def kv_heads(self, rank: Optional[int] = None) -> tuple[int, int]:
        """(first, count) of the kv heads the cache of model rank ``rank``
        (this rank's when None) holds."""
        if self.mesh is None:
            return 0, self.config.num_kv_heads
        return kv_head_range(self.config.num_heads, self.config.num_kv_heads,
                             self.mesh.axis_size(_TP),
                             self.mesh.axis_index(_TP) if rank is None else rank)

    # --------------------------------------------------------------- kv cache
    def init_kv_cache(self, num_blocks: int, block_size: int, dtype=None):
        """One tensor for the whole model: [L, N, 2, Bs, Hk*D], K and V of
        a block adjacent — the layout of the JAX package's cache (Hk: this
        rank's kv heads on a mesh).

        ``dtype="int8"`` gives a :class:`QuantKvCache`: an int8 payload of
        that layout and a scale pool ``[L, N, 2, Hp, Sp]`` of ones.  Any
        other float dtype (a name or a ``torch.dtype``) is allocated as
        given, as in the JAX package: the cache write casts the fresh K/V
        to it and the plain attention ops read it back in f32."""
        cfg = self.config
        hk = self.heads[1]
        shape = (cfg.num_layers, num_blocks, 2, block_size, hk * cfg.head_dim)
        dt = resolve_cache_dtype(dtype)
        if dt == "int8":
            hp, sp = scale_tile(hk, block_size)
            return QuantKvCache(
                torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.ones((cfg.num_layers, num_blocks, 2, hp, sp), dtype=torch.float32,
                           device=self.device))
        return torch.zeros(shape, dtype=dt or cfg.torch_dtype, device=self.device)

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
            q, k, v = _qkv_proj(cfg, lp, x, b, s, *self.heads)
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
            hidden = self._mlp_block(lp, self._attn_block(lp, hidden, attn, b, s))
        hidden = rms_norm(hidden, self.final_norm, cfg.rms_norm_eps, uo)
        return hidden, kv_cache

    def _reduce(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """Sum a row-parallel product's partials over "model" (when its
        weight is split there)."""
        return self.mesh.all_reduce(x, _TP) if self.split[name] else x

    def _attn_block(self, lp: dict, hidden: torch.Tensor, attn: torch.Tensor, b: int,
                    s: int) -> torch.Tensor:
        """The residual after attention: ``wo`` (summed over the mesh),
        Gemma2's sandwich norm, the residual add."""
        cfg = self.config
        attn_out = self._reduce(matmul(attn.reshape(b, s, -1), lp["wo"]), "layers.wo")
        if cfg.post_norms:  # Gemma2 sandwich: norm the residual branch
            attn_out = rms_norm(attn_out, lp["post_attn_norm"], cfg.rms_norm_eps,
                                cfg.rmsnorm_unit_offset)
        return hidden + attn_out

    def _mlp_block(self, lp: dict, hidden: torch.Tensor) -> torch.Tensor:
        """The residual after the MLP (dense or MoE), summed over the mesh."""
        cfg = self.config
        uo = cfg.rmsnorm_unit_offset
        x = rms_norm(hidden, lp["mlp_norm"], cfg.rms_norm_eps, uo)
        mlp_out = _moe_mlp_grouped(cfg, lp, x) if cfg.is_moe else _dense_mlp(cfg, lp, x)
        mlp_out = self._reduce(mlp_out, "layers.w_down")
        if cfg.post_norms:
            mlp_out = rms_norm(mlp_out, lp["post_mlp_norm"], cfg.rms_norm_eps, uo)
        return hidden + mlp_out

    @torch.no_grad()
    def forward_seq_parallel(self, tokens: torch.Tensor, positions: torch.Tensor,
                             sp_axis: str = AXIS_SP) -> tuple[torch.Tensor, torch.Tensor]:
        """Long-context prefill with ring attention (context parallelism):
        ``tokens``/``positions`` [B, S/n] are this rank's chunk of the
        sequence, split over the mesh's ``sp_axis`` (rank i of the axis holds
        chunk i, positions global); attention runs blockwise while the K/V
        chunks travel around the ring (``ops/ring_attention.py``), and
        "model" splits the heads as in :meth:`forward`.

        Returns (hidden [B, S/n, Dm], kv [L, 2, B, S/n, Hk*D]) for this
        rank's chunk (Hk: its kv heads); the kv is what the engine writes
        into the paged cache after a long prefill."""
        from dynamo_tpu_torch.ops.ring_attention import ring_attention

        if self.mesh is None:
            raise ValueError("forward_seq_parallel needs a mesh of more than one rank")
        cfg = self.config
        b, s = tokens.shape
        hidden = take_rows(self._weight("embed"), tokens, cfg.torch_dtype)
        if cfg.scale_embeddings:
            hidden = hidden * torch.tensor(math.sqrt(cfg.hidden_size), dtype=hidden.dtype)
        uo = cfg.rmsnorm_unit_offset
        kvs = []
        for li in range(cfg.num_layers):
            lp = self._layer(li)
            x = rms_norm(hidden, lp["attn_norm"], cfg.rms_norm_eps, uo)
            q, k, v = _qkv_proj(cfg, lp, x, b, s, *self.heads)
            q = apply_rope(q, positions, self.inv_freq)
            k = apply_rope(k, positions, self.inv_freq)
            attn = ring_attention(q, k, v, positions, positions, mesh=self.mesh, axis=sp_axis,
                                  sm_scale=self.sm_scale, logit_cap=cfg.attn_logit_softcap,
                                  window=cfg.sliding_window)
            hidden = self._mlp_block(lp, self._attn_block(lp, hidden, attn, b, s))
            kvs.append(torch.stack([k.reshape(b, s, -1), v.reshape(b, s, -1)]))
        hidden = rms_norm(hidden, self.final_norm, cfg.rms_norm_eps, uo)
        return hidden, torch.stack(kvs)

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
        if self.split["lm_head"]:  # this rank's vocab columns: gather them all
            logits = self.mesh.all_gather(logits, _TP, dim=-1)
        if cap:  # Gemma2 final logit softcap
            logits = softcap(logits, float(cap))
        return logits


def _qkv_proj(cfg: ModelConfig, lp: dict, x: torch.Tensor, b: int, s: int, hq: int, hk: int):
    """QKV projections (+ Qwen2 bias / Qwen3 per-head q-k norms) into ``hq``
    query and ``hk`` kv heads (this rank's, on a mesh)."""
    dh = cfg.head_dim
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


def _moe_router(cfg: ModelConfig, lp: dict, xf: torch.Tensor):
    """Each token's top-k experts and their weights, for both dispatch
    paths.  xf [T, Dm] -> (weights [T, k] f32, topi [T, k] int64).

    The logits are ``xf @ router`` in the model dtype, then f32.  The top k
    come from a stable descending sort, so tied logits (common in bf16 at
    128 experts) keep the lower expert first, as ``jax.lax.top_k`` does;
    ``torch.topk`` promises no order on ties."""
    logits = (xf @ lp["router"]).float()  # [T, E]
    topi = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    topi = topi[:, :cfg.num_experts_per_tok]
    return router_weights(cfg, logits, topi), topi


def router_weights(cfg: ModelConfig, logits: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The weights of experts ``topi`` [T, k] from router ``logits`` [T, E]
    (f32): a softmax over their logits (``norm_topk_prob``, the top k
    renormalised), or the full softmax taken at them (Qwen3-MoE with
    ``norm_topk_prob`` false)."""
    if cfg.norm_topk_prob:
        return torch.softmax(logits.gather(-1, topi), dim=-1)
    return torch.softmax(logits, dim=-1).gather(-1, topi)


def grouped_expert_dispatch(xf: torch.Tensor, weights: torch.Tensor, topi: torch.Tensor,
                            num_experts: int, w_gate, w_up, w_down, act) -> torch.Tensor:
    """The grouped-MoE core, shared across model families: sort the
    (token, expert) assignments by expert, gather their rows, run each
    projection as ONE grouped product over every expert, then weight, unsort
    and sum each token's k rows.  ``xf`` [T, Dm]; ``weights``/``topi``
    [T, k]; ``w_*`` stacks ``[E, Dm, F]`` / ``[E, F, Dm]``, dense or int8
    QTensors; ``act`` maps the gate.

    Deterministic and free of host syncs: the group sizes are an integer
    ``scatter_add_`` into a fixed [E] buffer and a prefix sum, both on the
    device; the sort is stable; the combine gathers by the inverse
    permutation and sums the k rows of each token (no float scatter-add)."""
    t, d = xf.shape
    k = topi.shape[1]
    flat_e = topi.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)  # ties keep token order, as jnp.argsort
    xs = xf[order // k]  # [T*k, Dm]: each sorted row's source token
    counts = torch.zeros(num_experts, dtype=torch.int32, device=xf.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    offsets = torch.zeros(num_experts + 1, dtype=torch.int32, device=xf.device)
    offsets[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    gate = grouped_matmul(xs, w_gate, offsets)
    up = grouped_matmul(xs, w_up, offsets)
    out = grouped_matmul(act(gate) * up, w_down, offsets)  # [T*k, Dm]
    out = out * weights.reshape(t * k)[order, None].to(out.dtype)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(t * k, device=order.device)
    return out[inverse].reshape(t, k, d).sum(dim=1)


def _moe_mlp_grouped(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """The MoE MLP on the serving path: route, then the grouped dispatch.
    Its intermediates are [T*k, F] and its products cover only the k
    experts each token chose."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    weights, topi = _moe_router(cfg, lp, xf)
    out = grouped_expert_dispatch(xf, weights, topi, cfg.num_experts, lp["w_gate"], lp["w_up"],
                                  lp["w_down"], lambda g: _act(cfg, g))
    return out.reshape(b, s, d)


def _moe_mlp_dense(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense MoE oracle for the tests: every expert computes every token,
    weighted by its router probability (zero off the top k).  It has no
    permutation logic, so it checks the grouped path's; nothing on the
    serving path calls it."""
    b, s, d = x.shape
    weights, topi = _moe_router(cfg, lp, x.reshape(b * s, d))
    onehot = F.one_hot(topi, cfg.num_experts).float()  # [T, k, E]
    probs = torch.einsum("tke,tk->te", onehot, weights)
    xf = x.reshape(b * s, d)
    w_gate, w_up, w_down = (dequantize(lp[n], x.dtype) for n in ("w_gate", "w_up", "w_down"))
    up = torch.einsum("td,edf->tef", xf, w_up)
    gate = torch.einsum("td,edf->tef", xf, w_gate)
    out = torch.einsum("tef,efd->ted", _act(cfg, gate) * up, w_down)
    return torch.einsum("ted,te->td", out, probs.to(out.dtype)).reshape(b, s, d)
