"""Ragged paged prefill attention: the CUDA kernels, wrappers and plain version.

The kernels (``csrc/ragged_prefill_attention.cu``) replace the TPU kernel
``dynamo_tpu/ops/pallas/prefill_attention.py::ragged_paged_prefill_attention``,
its bf16 and its int8 body (each row's cached prefix read from a
:class:`QuantKvCache`, the fresh K/V unquantised), each with a bf16 and an
fp16 build (q, the fresh K/V, a float cache and out in float16: the
``_f16`` C entry points): one flat axis of T
tokens packs R rows, and row r owns the real tokens ``[row_offsets[r], row_offsets[r] + seq_lens[r] - starts[r])``.  A row is a
prefill span or a 1-token decode row, whose ``start`` (context - 1) need not
be block-aligned.  Each token attends its own row's cached prefix
``[0, starts[r])`` in full, read from the paged cache ``[L, N, 2, Bs, Hk*D]``
at a runtime layer index, and its own row's fresh K/V causally by flat
index; it never sees another row.  Tokens in no span, and rows with an empty
span (the engine's power-of-two padding rows, all zeros), give 0.

Both kernels run on the warpgroup tile of ``csrc/wgmma_attention.cuh`` in
one launch of two kinds of block: span blocks of ``128 / G`` flat tokens
per KV head, and one decode-row block per (KV head, row) that computes a
1-token row's G query rows alone.  :func:`plan` is the launch, from the
geometry the kernels compile with (``csrc/launch_geometry.cuh``); the C
entry points launch that plan.

:func:`ragged_paged_prefill_attention` (a bf16 or fp16 cache) and
:func:`ragged_paged_prefill_attention_q8` (an int8 one) launch their kernel
for CUDA tensors and take :func:`ragged_prefill_attention_ref` only for CPU
tensors; on any other device they raise.  Each wrapper's ``launches``
counts its launches, and ``launches_fp16`` those of the fp16 body.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels.prefill_attention import HEAD_DIMS, MAX_GROUP
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, cache_data, check_quant_cache, gather_layer_blocks

__all__ = ["ragged_paged_prefill_attention", "ragged_paged_prefill_attention_q8",
           "ragged_prefill_attention_ref", "RaggedPlan", "plan"]


@dataclass(frozen=True)
class RaggedPlan:
    """Both kernels' launch: ``grid`` = (KV heads, decode-row blocks + span
    blocks) blocks of ``threads`` with ``smem`` bytes of dynamic shared
    memory.  Block y < ``decode_blocks`` computes row y if that row has one
    fresh token (a decode row) and exits otherwise; span block y holds flat
    tokens ``[tq * (grid[1] - 1 - y), +tq)`` (the last tile first) times the
    ``group`` query heads of its KV head, decode rows' tokens excluded.  K/V
    are streamed ``keys`` at a time."""
    tq: int
    group: int
    keys: int
    decode_blocks: int
    span_blocks: int
    grid: tuple[int, int]
    threads: int
    smem: int


@functools.lru_cache(maxsize=4096)
def plan(t: int, r: int, h: int, hk: int, d: int, quant: bool = False) -> RaggedPlan:
    """The launch for q [1, t, h, d] over hk KV heads and r rows, over a
    bf16 cache or an int8 one (``quant``)."""
    g = build.geometry()
    group = h // hk
    if group > g["B3_DECODE_ROWS"]:
        raise ValueError(f"{group} query heads per KV head exceed a decode-row block's "
                         f"{g['B3_DECODE_ROWS']} rows")
    tq = g["B3_ROWS"] // group
    spans = -(-t // tq)
    if r + spans > 65535:
        raise ValueError(f"{r + spans} blocks exceed CUDA's limit of 65535 on grid y")
    smem = g[f"B3_Q8_SMEM_D{d}" if quant else f"B3_SMEM_D{d}"]
    return RaggedPlan(tq, group, g[f"B3_KEYS_D{d}"], r, spans, (hk, r + spans), g["B3_THREADS"], smem)


def ragged_prefill_attention_ref(
    q: torch.Tensor,             # [1, T, H, D]
    k_new: torch.Tensor,         # [1, T, Hk, D]
    v_new: torch.Tensor,         # [1, T, Hk, D]
    cache,                       # [L, N, 2, Bs, Hk*D], or a QuantKvCache
    layer: int,
    block_tables: torch.Tensor,  # [R, M] int32, prefix blocks leading
    seq_lens: torch.Tensor,      # [R] int32 — context incl. the row's fresh tokens
    starts: torch.Tensor,        # [R] int32 — absolute position of the row's first token
    row_offsets: torch.Tensor,   # [R] int32 — flat index of the row's first token
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of both kernels, one row at a time: the row's
    prefix is exactly its first ``start`` cache slots (so dead slots and
    other rows' blocks are never read; an int8 prefix is dequantised in
    f32), its fresh keys exactly its own span, everything in f32, returns
    ``q.dtype``.  Working per row keeps memory at
    one row's scores; gathering every token's prefix, as the JAX package's
    oracle does, would take gigabytes at serving shapes.  Reads the row
    table on the host."""
    _, t, h, d = q.shape
    bs, hkd = cache_data(cache).shape[3:]
    hk = hkd // d
    g = h // hk
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.zeros_like(q)
    rows = zip(seq_lens.tolist(), starts.tolist(), row_offsets.tolist())
    for r, (n_ctx, start, off) in enumerate(rows):
        fresh = n_ctx - start
        if fresh <= 0:
            continue
        nb = -(-start // bs)
        kv = gather_layer_blocks(cache, layer, block_tables[r, :nb], hk)  # [nb, 2, Bs, HkD]
        kp = kv[:, 0].reshape(nb * bs, hk, d)[:start]
        vp = kv[:, 1].reshape(nb * bs, hk, d)[:start]
        keys = torch.cat([kp, k_new[0, off:off + fresh]]).float()  # [start + fresh, Hk, D]
        vals = torch.cat([vp, v_new[0, off:off + fresh]]).float()
        qr = q[0, off:off + fresh].float().reshape(fresh, hk, g, d) * sm_scale
        scores = torch.einsum("skgd,ukd->kgsu", qr, keys)
        if logit_cap is not None:
            scores = torch.tanh(scores / logit_cap) * logit_cap
        i = torch.arange(fresh, device=q.device)
        u = torch.arange(start + fresh, device=q.device)
        visible = (u[None, :] < start) | (u[None, :] - start <= i[:, None])  # [fresh, start + fresh]
        scores = torch.where(visible, scores, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        row = torch.einsum("kgsu,ukd->skgd", probs, vals).reshape(fresh, h, d)
        out[0, off:off + fresh] = row.to(q.dtype)
    return out


def _check(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets) -> None:
    quant = isinstance(cache, QuantKvCache)
    data = cache_data(cache)
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "cache": data,
               "block_tables": block_tables, "seq_lens": seq_lens, "starts": starts,
               "row_offsets": row_offsets}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    build.entry("dynamo_ragged_prefill_attention", q.dtype)  # a dtype with a body
    for name in ("q", "k_new", "v_new") + (() if quant else ("cache",)):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, as q, got {tensors[name].dtype}")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name in ("block_tables", "seq_lens", "starts", "row_offsets"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    one, t, h, d = q.shape
    l, _, two, _, hkd = data.shape
    hk = hkd // d if d else 0
    if (one != 1 or t < 1 or two != 2 or d not in HEAD_DIMS or hkd % d or h % hk
            or h // hk > MAX_GROUP):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} cache {tuple(data.shape)}")
    if quant:
        check_quant_cache(cache, hk)
    if k_new.shape != (1, t, hk, d) or v_new.shape != (1, t, hk, d):
        raise ValueError("k_new and v_new must be [1, T, Hk, D]")
    r = block_tables.shape[0] if block_tables.dim() == 2 else -1
    if r < 1 or any(x.shape != (r,) for x in (seq_lens, starts, row_offsets)):
        raise ValueError("block_tables must be [R, M] and seq_lens, starts, row_offsets [R]")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} out of range [0, {l})")


def _launch(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets,
            sm_scale, logit_cap) -> torch.Tensor:
    """Check and launch the kernel for ``cache``'s kind; returns the output."""
    layer = int(layer)
    _check(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets)
    _, t, h, d = q.shape
    _, n, _, bs, hkd = cache_data(cache).shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    quant = isinstance(cache, QuantKvCache)
    r = block_tables.shape[0]
    p = plan(t, r, h, hkd // d, d, quant)
    out = torch.empty_like(q)
    lib = build.library()
    rows = (block_tables.data_ptr(), seq_lens.data_ptr(), starts.data_ptr(), row_offsets.data_ptr(),
            out.data_ptr())
    dims = (t, h, hkd // d, d, n, bs, block_tables.shape[1], r, layer)
    tail = (p.tq, p.span_blocks, float(sm_scale), float(logit_cap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)
    fresh = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr())
    if quant:
        name = build.entry("dynamo_ragged_prefill_attention_q8", q.dtype)
        rc = getattr(lib, name)(*fresh, cache.data.data_ptr(), cache.scale.data_ptr(), *rows, *dims,
                                *cache.scale.shape[3:], *tail)
    else:
        name = build.entry("dynamo_ragged_prefill_attention", q.dtype)
        rc = getattr(lib, name)(*fresh, cache.data_ptr(), *rows, *dims, *tail)
    build.check(rc, name)
    return out


def ragged_paged_prefill_attention(
    q: torch.Tensor,             # [1, T, H, D] bf16 or fp16
    k_new: torch.Tensor,         # [1, T, Hk, D], q's dtype
    v_new: torch.Tensor,         # [1, T, Hk, D], q's dtype
    cache: torch.Tensor,         # [L, N, 2, Bs, Hk*D], q's dtype
    layer: int,
    block_tables: torch.Tensor,  # [R, M] int32
    seq_lens: torch.Tensor,      # [R] int32
    starts: torch.Tensor,        # [R] int32
    row_offsets: torch.Tensor,   # [R] int32
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Flash attention of T packed tokens of R rows against their own
    fresh K/V and cached prefix in a bf16 or fp16 cache (q's dtype).  Returns
    [1, T, H, D]."""
    if q.device.type == "cpu":
        return ragged_prefill_attention_ref(q, k_new, v_new, cache, layer, block_tables,
                                            seq_lens, starts, row_offsets, sm_scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_prefill_attention runs on cuda or cpu, not {q.device}")
    if isinstance(cache, QuantKvCache):
        raise TypeError("ragged_paged_prefill_attention takes a float cache; an int8 one goes to "
                        "ragged_paged_prefill_attention_q8")
    out = _launch(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets,
                  sm_scale, logit_cap)
    ragged_paged_prefill_attention.launches += 1
    ragged_paged_prefill_attention.launches_fp16 += q.dtype == torch.float16
    return out


def ragged_paged_prefill_attention_q8(
    q: torch.Tensor,             # [1, T, H, D] bf16 or fp16
    k_new: torch.Tensor,         # [1, T, Hk, D], q's dtype
    v_new: torch.Tensor,         # [1, T, Hk, D], q's dtype
    cache: QuantKvCache,         # data [L, N, 2, Bs, Hk*D] int8, scale [L, N, 2, Hp, Sp] f32
    layer: int,
    block_tables: torch.Tensor,  # [R, M] int32
    seq_lens: torch.Tensor,      # [R] int32
    starts: torch.Tensor,        # [R] int32
    row_offsets: torch.Tensor,   # [R] int32
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Flash attention of T packed tokens of R rows against their own
    fresh K/V and cached prefix in an int8 cache.  Returns [1, T, H, D]."""
    if q.device.type == "cpu":
        return ragged_prefill_attention_ref(q, k_new, v_new, cache, layer, block_tables,
                                            seq_lens, starts, row_offsets, sm_scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_prefill_attention_q8 runs on cuda or cpu, not {q.device}")
    if not isinstance(cache, QuantKvCache):
        raise TypeError("ragged_paged_prefill_attention_q8 takes a QuantKvCache")
    out = _launch(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets,
                  sm_scale, logit_cap)
    ragged_paged_prefill_attention_q8.launches += 1
    ragged_paged_prefill_attention_q8.launches_fp16 += q.dtype == torch.float16
    return out


ragged_paged_prefill_attention.launches = ragged_paged_prefill_attention.launches_fp16 = 0
ragged_paged_prefill_attention_q8.launches = ragged_paged_prefill_attention_q8.launches_fp16 = 0
