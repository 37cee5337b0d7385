"""Paged attention over block tables — the engine's core op, in PyTorch.

The KV cache is one tensor ``[L, N, 2, Bs, Hk*D]`` for the whole model: a
pool of fixed-size blocks per layer, K and V of a block adjacent.  Each
sequence owns an ordered list of block ids (its *block table*).  A forward
step first scatters the S new tokens' K/V into the cache, in place, then
attends over the sequence's context.

This file holds the plain PyTorch ops, the counterparts of
``dynamo_tpu/ops/paged_attention.py``, and the routing to the CUDA kernels:
on CUDA tensors decode attention (1 <= S <= ``MQ_MAX_S``) goes to
``ops/kernels/decode_attention.py``, prefill attention to
``ops/kernels/prefill_attention.py`` and ragged (token-budget) prefill
attention to ``ops/kernels/ragged_prefill_attention.py``; sliding-window
attention whose span can exceed the window, and every CPU call, take the
plain ops here.

Every op also takes an int8 cache (:class:`~dynamo_tpu_torch.ops.kv_quant.
QuantKvCache`): the write quantises the fresh rows, the plain ops
dequantise the blocks they gather, and on CUDA each op's int8 kernel runs
(``*_q8``), for any block size the bf16 kernels take.  Fresh chunk K/V are
never quantised by attention.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels.decode_attention import (
    paged_decode_attention,
    paged_decode_attention_q8,
)
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention,
    paged_prefill_attention_q8,
)
from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
    ragged_paged_prefill_attention,
    ragged_paged_prefill_attention_q8,
)
from dynamo_tpu_torch.ops.kv_quant import (
    cache_data,
    dequant_layer_slice,
    gather_layer_blocks,
    is_quant,
    quantize_kv_rows,
)

__all__ = [
    "MQ_MAX_S",
    "softcap",
    "write_kv_cache_layer",
    "paged_attention",
    "paged_attention_layer",
    "prefill_attention",
    "ragged_prefill_attention",
]

MQ_MAX_S = 8  # decode kernel: trailing-query count it serves


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style tanh logit softcap (shared by every attention path)."""
    return torch.tanh(x / cap) * cap


def paged_attention_layer(
    q: torch.Tensor,             # [B, S, H, D]
    cache,                       # [L, N, 2, Bs, Hk*D], or a QuantKvCache
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,      # [B] int32
    positions: torch.Tensor,     # [B, S] int32
    sm_scale: float | None = None,
    logit_cap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Attention for layer ``layer`` against the full paged cache.

    On CUDA, 1 <= S <= MQ_MAX_S goes to the decode kernel, which requires
    each row's positions to be contiguous (``positions[:, j] ==
    positions[:, 0] + j``) — true for every engine caller.  ``window``
    (Mistral/Phi3 sliding window) routes to the position-exact plain op only
    when the table's span (M*Bs) can exceed the window; otherwise full
    attention is exact.  Everything else takes the plain op.
    """
    b, s, h, d = q.shape
    quant = is_quant(cache)
    _, n, _, bs, hkd = cache_data(cache).shape
    hk = hkd // d
    windowed = window is not None and block_tables.shape[1] * bs > window
    if q.is_cuda and 1 <= s <= MQ_MAX_S and not windowed:
        kernel = paged_decode_attention_q8 if quant else paged_decode_attention
        return kernel(
            q.contiguous(), cache, layer, block_tables, seq_lens,
            positions[:, 0].contiguous(), sm_scale=sm_scale, logit_cap=logit_cap,
        )
    if quant:
        layer_kv = dequant_layer_slice(cache.data[layer], cache.scale[layer], hk)
    else:
        layer_kv = cache[layer]
    k_cache = layer_kv[:, 0].reshape(n, bs, hk, d)
    v_cache = layer_kv[:, 1].reshape(n, bs, hk, d)
    return paged_attention(
        q, k_cache, v_cache, block_tables, seq_lens, positions, sm_scale,
        logit_cap, window=window if windowed else None,
    )


def prefill_attention(
    q: torch.Tensor,             # [B, S, H, D] — fresh queries (contiguous from `start`)
    k_new: torch.Tensor,         # [B, S, Hk, D] — this chunk's keys
    v_new: torch.Tensor,         # [B, S, Hk, D]
    cache,                       # [L, N, 2, Bs, Hk*D], or a QuantKvCache
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,      # [B] int32 — context length incl. new tokens
    start: torch.Tensor,         # [B] int32 — absolute position of q[:, 0] (block-aligned)
    prefix_blocks: int,          # cache blocks holding the cached prefix
    sm_scale: float | None = None,
    logit_cap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Prefill attention without gathering the sequence's whole block table.

    The chunk's own K/V are passed in; only the cached prefix lives in the
    cache, in its first ``prefix_blocks`` blocks.  Fresh-fresh attention is
    causal by chunk index, fresh-prefix is full; padding tail rows (index >=
    seq_len - start) are masked out of everyone's context.  On CUDA with
    S > 1 the prefill kernel runs, streaming the prefix by its true length
    ``start``.  Returns [B, S, H, D].
    """
    b, s, h, d = q.shape
    hk = k_new.shape[2]
    g = h // hk
    if sm_scale is None:
        sm_scale = d ** -0.5
    bs = cache_data(cache).shape[3]
    windowed = window is not None and prefix_blocks * bs + s > window
    if not windowed:
        window = None
    if q.is_cuda and s > 1 and not windowed:
        kernel = paged_prefill_attention_q8 if is_quant(cache) else paged_prefill_attention
        return kernel(
            q.contiguous(), k_new.contiguous(), v_new.contiguous(), cache, layer,
            block_tables, seq_lens, start, sm_scale=sm_scale, logit_cap=logit_cap,
        )
    qg = q.reshape(b, s, hk, g, d).float()
    start = start.long()
    fresh = (seq_lens.long() - start)[:, None, None]  # valid fresh tokens per row

    sf = torch.einsum("bskgd,btkd->bkgst", qg, k_new.float()) * sm_scale
    if logit_cap is not None:
        sf = softcap(sf, logit_cap)
    i = torch.arange(s, device=q.device)
    allow_f = (i[None, :, None] >= i[None, None, :]) & (i[None, None, :] < fresh)
    if window is not None:
        allow_f = allow_f & ((i[None, :, None] - i[None, None, :]) < window)
    sf = torch.where(allow_f[:, None, None], sf, float("-inf"))

    if prefix_blocks == 0:
        probs = torch.softmax(sf, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v_new.float())
        return out.reshape(b, s, h, d).to(q.dtype)

    t = prefix_blocks * bs
    ctx = gather_layer_blocks(cache, layer, block_tables[:, :prefix_blocks], hk)  # [B, P, 2, Bs, HkD]
    kp = ctx[:, :, 0].reshape(b, t, hk, d)
    vp = ctx[:, :, 1].reshape(b, t, hk, d)
    sp = torch.einsum("bskgd,btkd->bkgst", qg, kp.float()) * sm_scale
    if logit_cap is not None:
        sp = softcap(sp, logit_cap)
    slot = torch.arange(t, device=q.device)
    allow_p = slot[None, None, :] < start[:, None, None]
    if window is not None:
        # prefix slot t IS absolute position t; query i sits at start + i
        q_pos = start[:, None, None] + i[None, :, None]
        allow_p = allow_p & ((q_pos - slot[None, None, :]) < window)
    sp = torch.where(allow_p[:, None, None], sp, float("-inf"))

    probs = torch.softmax(torch.cat([sp, sf], dim=-1), dim=-1)  # [B, Hk, G, S, T+S]
    out = torch.einsum(
        "bkgst,btkd->bskgd", probs[..., :t], vp.float()
    ) + torch.einsum(
        "bkgst,btkd->bskgd", probs[..., t:], v_new.float()
    )
    return out.reshape(b, s, h, d).to(q.dtype)


def ragged_prefill_attention(
    q: torch.Tensor,             # [1, T, H, D] — packed fresh queries (flat token axis)
    k_new: torch.Tensor,         # [1, T, Hk, D] — packed fresh keys
    v_new: torch.Tensor,         # [1, T, Hk, D]
    cache,                       # [L, N, 2, Bs, Hk*D], or a QuantKvCache
    layer: int,
    block_tables: torch.Tensor,  # [R, M] int32 — one table per packed row
    seq_lens: torch.Tensor,      # [R] int32 — context length incl. this chunk
    starts: torch.Tensor,        # [R] int32 — absolute chunk start
    row_offsets: torch.Tensor,   # [R] int32 — flat index of each row's first token
    seq_ids: torch.Tensor,       # [1, T] int32 — owning row per flat token; -1 = pad
    prefix_blocks: int,          # max cached-prefix blocks over rows
    sm_scale: float | None = None,
    logit_cap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Mixed-chunk ragged attention over one flat token axis: several rows'
    prefill spans and 1-token decode rows (whose ``start`` = context - 1 need
    not be block-aligned) packed on [T].  Each token attends its own row's
    cached prefix ``[0, start)`` and its own row's fresh tokens causally by
    flat index, never another row.

    On CUDA with T > 1 the ragged kernel runs (it reads the span table and
    streams each row's prefix by its true ``start``).  Everything else takes
    the position-exact plain op below, the JAX package's oracle: each token
    gathers its row's first ``prefix_blocks`` blocks, masked at ``start``,
    and padding tokens (``seq_ids`` -1) attend only padding.  Returns
    [1, T, H, D]."""
    _, t, h, d = q.shape
    hk = k_new.shape[2]
    g = h // hk
    if sm_scale is None:
        sm_scale = d ** -0.5
    bs = cache_data(cache).shape[3]
    windowed = window is not None and prefix_blocks * bs + t > window
    if not windowed:
        window = None
    if q.is_cuda and t > 1 and not windowed:
        kernel = (ragged_paged_prefill_attention_q8 if is_quant(cache)
                  else ragged_paged_prefill_attention)
        return kernel(
            q.contiguous(), k_new.contiguous(), v_new.contiguous(), cache, layer,
            block_tables, seq_lens, starts, row_offsets, sm_scale=sm_scale,
            logit_cap=logit_cap,
        )
    qg = q[0].reshape(t, hk, g, d).float()
    sid = seq_ids[0].long()                            # [T]
    idx = torch.arange(t, device=q.device)
    allow_f = (sid[:, None] == sid[None, :]) & (idx[None, :] <= idx[:, None])
    if window is not None:
        allow_f = allow_f & ((idx[:, None] - idx[None, :]) < window)
    sf = torch.einsum("skgd,tkd->kgst", qg, k_new[0].float()) * sm_scale
    if logit_cap is not None:
        sf = softcap(sf, logit_cap)
    sf = torch.where(allow_f[None, None], sf, float("-inf"))

    if prefix_blocks == 0:
        probs = torch.softmax(sf, dim=-1)
        out = torch.einsum("kgst,tkd->skgd", probs, v_new[0].float())
        return out.reshape(1, t, h, d).to(q.dtype)

    r_rows = block_tables.shape[0]
    u = prefix_blocks * bs
    ctx = gather_layer_blocks(cache, layer, block_tables[:, :prefix_blocks], hk)  # [R, P, 2, Bs, HkD]
    kp = ctx[:, :, 0].reshape(r_rows, u, hk, d)
    vp = ctx[:, :, 1].reshape(r_rows, u, hk, d)
    rid = sid.clamp(0, r_rows - 1)
    starts = starts.long()
    sp = torch.einsum("skgd,sukd->kgsu", qg, kp[rid].float()) * sm_scale
    if logit_cap is not None:
        sp = softcap(sp, logit_cap)
    slot = torch.arange(u, device=q.device)
    allow_p = (sid[:, None] >= 0) & (slot[None, :] < starts[rid][:, None])
    if window is not None:
        # prefix slot u IS absolute position u; the query sits at its row
        # start plus its offset within the span
        q_pos = starts[rid] + idx - row_offsets.long()[rid]
        allow_p = allow_p & ((q_pos[:, None] - slot[None, :]) < window)
    sp = torch.where(allow_p[None, None], sp, float("-inf"))

    probs = torch.softmax(torch.cat([sp, sf], dim=-1), dim=-1)  # [Hk, G, T, U+T]
    out = torch.einsum(
        "kgsu,sukd->skgd", probs[..., :u], vp[rid].float()
    ) + torch.einsum(
        "kgst,tkd->skgd", probs[..., u:], v_new[0].float()
    )
    return out.reshape(1, t, h, d).to(q.dtype)


def write_kv_cache_layer(
    cache,                   # [L, N, 2, Bs, Hk*D] — the WHOLE paged cache, or a QuantKvCache; in place
    layer: int,
    k_new: torch.Tensor,     # [B, S, Hk, D]
    v_new: torch.Tensor,     # [B, S, Hk, D]
    slot_idx: torch.Tensor,  # [B, S] int32  flat slot = block_id * Bs + offset; -1 = drop
    block_aligned: bool = False,
    row_tokens: int = 0,
):
    """Scatter new K/V rows into the multi-layer cache, in place.

    With ``block_aligned=True`` (the engine's prefill layout guarantees it:
    chunks start block-aligned and rows are contiguous) the scatter works on
    whole blocks: S/Bs block rows instead of S token rows.  Rows with slot -1
    inside a partially valid block keep the existing cache content, so the
    '-1 = drop' contract holds bit for bit.

    ``row_tokens`` splits the S axis of a ``block_aligned`` write: the first
    ``row_tokens`` tokens take the per-row scatter (the unified layout's
    decode rows, one token each at any in-block offset) and only the
    block-aligned remainder takes the block write.  It must be a block
    multiple, so the remainder starts on a span boundary.

    For a :class:`QuantKvCache` the fresh rows are quantised here (one scale
    per row per KV head) and payload and scales scatter with the same base
    indices; only the valid ``[:Hk, :Bs]`` region of a scale tile is
    written, pad lanes keep their bytes.

    Dropped rows never use -1 as an index — it would wrap to the last row.
    They are sent instead to a row of the other half (a V row during the K
    write, a K row during the V write) that the same write never targets,
    and write back that row's current bytes: nothing changes, and no host
    sync is needed to filter them out.
    """
    if block_aligned and 0 < row_tokens < k_new.shape[1]:
        write_kv_cache_layer(cache, layer, k_new[:, :row_tokens], v_new[:, :row_tokens],
                             slot_idx[:, :row_tokens])
        return write_kv_cache_layer(cache, layer, k_new[:, row_tokens:], v_new[:, row_tokens:],
                                    slot_idx[:, row_tokens:], block_aligned=True)
    if block_aligned and row_tokens >= k_new.shape[1]:
        block_aligned = False  # every token is a per-row token
    b, s, hk, d = k_new.shape
    blocks = block_aligned and s > 1 and s % cache_data(cache).shape[3] == 0
    if is_quant(cache):
        kq, ks = quantize_kv_rows(k_new)
        vq, vs = quantize_kv_rows(v_new)
        _write_layer_rows(cache.data, layer, kq.reshape(b, s, hk * d), vq.reshape(b, s, hk * d),
                          slot_idx, blocks)
        _write_layer_scales(cache.scale, layer, ks, vs, slot_idx, blocks, cache.data.shape[3])
        return cache
    _write_layer_rows(cache, layer, k_new.reshape(b, s, hk * d), v_new.reshape(b, s, hk * d),
                      slot_idx, blocks)
    return cache


def _write_layer_rows(cache: torch.Tensor, layer: int, rows_k: torch.Tensor,
                      rows_v: torch.Tensor, slot_idx: torch.Tensor, blocks: bool) -> None:
    """The payload write of :func:`write_kv_cache_layer`: rows [B, S, R]
    into the cache [L, N, 2, Bs, R], by whole blocks when ``blocks``."""
    if not cache.is_contiguous():
        raise ValueError("the cache must be contiguous")
    l, n, _, bs, r = cache.shape
    b, s, _ = rows_k.shape
    rows_k = rows_k.to(cache.dtype)
    rows_v = rows_v.to(cache.dtype)
    slot_idx = slot_idx.long()
    if blocks:
        nb = s // bs
        flat = cache.view(l * n * 2, bs, r)
        first = slot_idx[:, ::bs].reshape(-1)                   # [B*nb] block-leading slot
        live = first >= 0
        base = layer * (n * 2) + first.clamp_min(0) // bs * 2   # K block of (layer, bid)
        valid = (slot_idx >= 0).reshape(b * nb, bs, 1) & live[:, None, None]
        k_tgt = torch.where(live, base, layer * n * 2 + 1)      # dropped: a V block
        flat[k_tgt] = torch.where(valid, rows_k.reshape(b * nb, bs, r), flat[k_tgt])
        v_tgt = torch.where(live, base + 1, layer * n * 2)      # dropped: a K block
        flat[v_tgt] = torch.where(valid, rows_v.reshape(b * nb, bs, r), flat[v_tgt])
        return
    flat = cache.view(l * n * 2 * bs, r)
    idx = slot_idx.reshape(-1)
    valid = idx >= 0
    safe = idx.clamp_min(0)
    # row for (layer, block = idx // bs, kv, offset = idx % bs) in the flat view
    base = layer * (n * 2 * bs) + safe // bs * (2 * bs) + safe % bs
    k_tgt = torch.where(valid, base, layer * n * 2 * bs + bs)   # dropped: a V row
    flat[k_tgt] = torch.where(valid[:, None], rows_k.reshape(-1, r), flat[k_tgt])
    v_tgt = torch.where(valid, base + bs, layer * n * 2 * bs)   # dropped: a K row
    flat[v_tgt] = torch.where(valid[:, None], rows_v.reshape(-1, r), flat[v_tgt])


def _write_layer_scales(scale: torch.Tensor, layer: int, ks: torch.Tensor, vs: torch.Tensor,
                        slot_idx: torch.Tensor, blocks: bool, bs: int) -> None:
    """The scale write of :func:`write_kv_cache_layer`: per-token scales
    [B, S, Hk] into the token-minor pool [L, N, 2, Hp, Sp], index for index
    with the payload write.  The block path rewrites whole tiles (the valid
    region folded into the tile as read); the row path writes
    ``(tile, :Hk, lane)``.  Dropped rows write back what they read from a
    tile of the other half, as in :func:`_write_layer_rows`."""
    if not scale.is_contiguous():
        raise ValueError("the scale pool must be contiguous")
    l, n, _, hp, sp = scale.shape
    b, s, hk = ks.shape
    flat = scale.view(l * n * 2, hp, sp)
    slot_idx = slot_idx.long()
    if blocks:
        nb = s // bs
        first = slot_idx[:, ::bs].reshape(-1)
        live = first >= 0
        base = layer * (n * 2) + first.clamp_min(0) // bs * 2
        valid = (slot_idx >= 0).reshape(b * nb, 1, bs) & live[:, None, None]
        for new, tgt in ((ks, torch.where(live, base, layer * n * 2 + 1)),
                         (vs, torch.where(live, base + 1, layer * n * 2))):
            tiles = flat[tgt]                                   # [B*nb, Hp, Sp], a copy
            fresh = new.to(scale.dtype).reshape(b * nb, bs, hk).transpose(1, 2)
            tiles[:, :hk, :bs] = torch.where(valid, fresh, tiles[:, :hk, :bs])
            flat[tgt] = tiles
        return
    idx = slot_idx.reshape(-1)
    valid = idx >= 0
    safe = idx.clamp_min(0)
    tile = layer * (n * 2) + safe // bs * 2
    lane = (safe % bs)[:, None]
    heads = torch.arange(hk, device=scale.device)[None, :]
    for new, tgt in ((ks, torch.where(valid, tile, layer * n * 2 + 1)),
                     (vs, torch.where(valid, tile + 1, layer * n * 2))):
        at = (tgt[:, None], heads, lane)
        flat[at] = torch.where(valid[:, None], new.to(scale.dtype).reshape(-1, hk), flat[at])


def paged_attention(
    q: torch.Tensor,             # [B, S, H, D]
    k_cache: torch.Tensor,       # [N, Bs, Hk, D]
    v_cache: torch.Tensor,       # [N, Bs, Hk, D]
    block_tables: torch.Tensor,  # [B, M] int32 (entries past the sequence end may be any valid id)
    seq_lens: torch.Tensor,      # [B] int32 — context length including the new tokens
    positions: torch.Tensor,     # [B, S] int32 — absolute position of each query token
    sm_scale: float | None = None,
    logit_cap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Attention of S new tokens against their sequence's paged context.

    Causal by absolute position: query at position p sees cache slots 0..p
    (the new tokens' K/V must already be in the cache).  ``window`` adds
    sliding-window masking: slot j additionally needs p - j < window.
    Returns [B, S, H, D].
    """
    b, s, h, d = q.shape
    _, bs, hk, _ = k_cache.shape
    m = block_tables.shape[1]
    t = m * bs
    g = h // hk
    if sm_scale is None:
        sm_scale = d ** -0.5
    bt = block_tables.long()
    k_ctx = k_cache[bt].reshape(b, t, hk, d)
    v_ctx = v_cache[bt].reshape(b, t, hk, d)

    qg = q.reshape(b, s, hk, g, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_ctx.float()) * sm_scale
    if logit_cap is not None:
        scores = softcap(scores, logit_cap)

    # slot j visible iff j <= position(query) and j < seq_len
    slot = torch.arange(t, device=q.device)
    pos = positions.long()
    lens = seq_lens.long().clamp_min(1)  # keep padded rows numerically sane
    visible = (slot[None, None, :] <= pos[:, :, None]) & (slot[None, None, :] < lens[:, None, None])
    if window is not None:
        visible = visible & ((pos[:, :, None] - slot[None, None, :]) < window)
    scores = torch.where(visible[:, None, None], scores, float("-inf"))

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_ctx.float())
    return out.reshape(b, s, h, d).to(q.dtype)
