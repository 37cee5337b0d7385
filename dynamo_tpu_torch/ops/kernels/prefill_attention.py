"""Paged prefill attention: the CUDA kernels, their wrappers, their plain version.

The kernels (``csrc/prefill_attention.cu``) replace the TPU kernel
``dynamo_tpu/ops/pallas/prefill_attention.py::paged_prefill_attention``,
its bf16 and its int8 body (the cached prefix read from a
:class:`QuantKvCache`, the fresh K/V unquantised): each of B rows has S
fresh queries from the block-aligned position ``start``; they attend the cached prefix ``[0, start)`` in full, read from
the paged cache ``[L, N, 2, Bs, Hk*D]`` at a runtime layer index, and their
own fresh K/V causally, masked at ``seq_len - start``.  Padding query rows
(index ``>= seq_len - start``) give 0.

Both kernels are built for Hopper on one tile (wgmma products fed by a
cp.async ring and a producer warpgroup, ``csrc/wgmma_attention.cuh``; over
an int8 cache the producer converts the prefix to bf16 as it stages it);
:func:`plan` is the launch of both, from the geometry they compile with
(``csrc/launch_geometry.cuh``), and the C entry points launch that plan.

:func:`paged_prefill_attention` (a bf16 cache) and
:func:`paged_prefill_attention_q8` (an int8 one) launch their kernel for
CUDA tensors and take :func:`prefill_attention_ref` only for CPU tensors; on
any other device they raise.  Each wrapper's ``launches`` counts its
launches.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, cache_data, check_quant_cache, gather_layer_blocks

__all__ = ["paged_prefill_attention", "paged_prefill_attention_q8", "prefill_attention_ref",
           "PrefillPlan", "plan"]

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 64  # query heads per KV head one thread block can hold


@dataclass(frozen=True)
class PrefillPlan:
    """A kernel's launch: ``grid`` = (KV heads, rows, query tiles)
    blocks of ``threads`` with ``smem`` bytes of dynamic shared memory;
    block z holds tokens ``[tq * (tiles - 1 - z), +tq)`` (the longest causal
    tiles first) times the ``group`` query heads of its KV head, K/V
    streamed ``keys`` at a time."""
    tq: int
    group: int
    keys: int
    grid: tuple[int, int, int]
    threads: int
    smem: int


@functools.lru_cache(maxsize=4096)
def plan(b: int, s: int, h: int, hk: int, d: int, quant: bool = False) -> PrefillPlan:
    """The launch for q [b, s, h, d] over hk KV heads, over a bf16 cache or
    (``quant``) an int8 one: the same blocks, more shared memory."""
    g = build.geometry()
    group = h // hk
    tq = g["B2_ROWS"] // group
    grid = (hk, b, -(-s // tq))
    if max(grid[1:]) > 65535:
        raise ValueError(f"grid {grid} exceeds CUDA's limit of 65535 blocks on y and z")
    smem = g[f"B2_Q8_SMEM_D{d}" if quant else f"B2_SMEM_D{d}"]
    return PrefillPlan(tq, group, g[f"B2_KEYS_D{d}"], grid, g["B2_THREADS"], smem)


def prefill_attention_ref(
    q: torch.Tensor,             # [B, S, H, D]
    k_new: torch.Tensor,         # [B, S, Hk, D]
    v_new: torch.Tensor,         # [B, S, Hk, D]
    cache,                       # [L, N, 2, Bs, Hk*D], or a QuantKvCache
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32, prefix blocks leading
    seq_lens: torch.Tensor,      # [B] int32 — context incl. fresh tokens
    start: torch.Tensor,         # [B] int32 — absolute position of q[:, 0]
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of both kernels: the prefix is the row's whole
    table (dequantised in f32 for an int8 cache) masked at ``start``,
    everything in f32, returns ``q.dtype``.  Dead prefix slots and fresh
    padding have their V zeroed; padding query rows see nothing and give 0."""
    b, s, h, d = q.shape
    _, _, _, bs, hkd = cache_data(cache).shape
    hk = hkd // d
    g = h // hk
    m = block_tables.shape[1]
    t = m * bs
    if sm_scale is None:
        sm_scale = d ** -0.5
    start = start.long()
    fresh = seq_lens.long() - start                                     # [B]
    kv = gather_layer_blocks(cache, layer, block_tables, hk)            # [B, M, 2, Bs, HkD]
    kp = kv[:, :, 0].reshape(b, t, hk, d).float()
    vp = kv[:, :, 1].reshape(b, t, hk, d).float()
    slot = torch.arange(t, device=q.device)
    idx = torch.arange(s, device=q.device)
    pre_live = slot[None, :] < start[:, None]                           # [B, T]
    new_live = idx[None, :] < fresh[:, None]                            # [B, S]
    keys_k = torch.cat([kp, k_new.float()], dim=1)                      # [B, T+S, Hk, D]
    keys_v = torch.cat([torch.where(pre_live[:, :, None, None], vp, 0.0),
                        torch.where(new_live[:, :, None, None], v_new.float(), 0.0)], dim=1)
    qf = q.float().reshape(b, s, hk, g, d) * sm_scale
    scores = torch.einsum("bskgd,btkd->bkgst", qf, keys_k)
    if logit_cap is not None:
        scores = torch.tanh(scores / logit_cap) * logit_cap
    causal = (idx[None, :, None] >= idx[None, None, :]) & new_live[:, None, :]  # [B, S, S]
    visible = torch.cat([pre_live[:, None, :].expand(b, s, t), causal], dim=-1)
    visible = visible & new_live[:, :, None]                            # padding rows see nothing
    scores = torch.where(visible[:, None, None], scores, float("-inf"))
    m_row = scores.amax(dim=-1, keepdim=True)
    m_row = torch.where(torch.isfinite(m_row), m_row, 0.0)
    p = torch.exp(scores - m_row)
    l_row = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    out = torch.einsum("bkgst,btkd->bskgd", p / l_row, keys_v)
    return out.reshape(b, s, h, d).to(q.dtype)


def _check(q, k_new, v_new, cache, layer, block_tables, seq_lens, start) -> None:
    quant = isinstance(cache, QuantKvCache)
    data = cache_data(cache)
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "cache": data,
               "block_tables": block_tables, "seq_lens": seq_lens, "start": start}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k_new", "v_new") + (() if quant else ("cache",)):
        if tensors[name].dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {tensors[name].dtype}")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name in ("block_tables", "seq_lens", "start"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    b, s, h, d = q.shape
    l, _, two, _, hkd = data.shape
    hk = hkd // d if d else 0
    if two != 2 or d not in HEAD_DIMS or hkd % d or h % hk or h // hk > MAX_GROUP:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} cache {tuple(data.shape)}")
    if quant:
        check_quant_cache(cache, hk)
    if k_new.shape != (b, s, hk, d) or v_new.shape != (b, s, hk, d):
        raise ValueError("k_new and v_new must be [B, S, Hk, D]")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables shape {tuple(block_tables.shape)}")
    if seq_lens.shape != (b,) or start.shape != (b,):
        raise ValueError("seq_lens and start must be [B]")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} out of range [0, {l})")


def _launch(q, k_new, v_new, cache, layer, block_tables, seq_lens, start, sm_scale,
            logit_cap) -> torch.Tensor:
    """Check and launch the kernel for ``cache``'s kind; returns the output."""
    layer = int(layer)
    _check(q, k_new, v_new, cache, layer, block_tables, seq_lens, start)
    b, s, h, d = q.shape
    _, n, _, bs, hkd = cache_data(cache).shape
    hk = hkd // d
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.empty_like(q)
    lib = build.library()
    dims = (b, s, h, hk, d, n, bs, block_tables.shape[1], layer)
    tail = (float(sm_scale), float(logit_cap or 0.0), torch.cuda.current_stream(q.device).cuda_stream)
    rows = (block_tables.data_ptr(), seq_lens.data_ptr(), start.data_ptr(), out.data_ptr())
    fresh = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr())
    if isinstance(cache, QuantKvCache):
        p = plan(b, s, h, hk, d, quant=True)
        rc = lib.dynamo_prefill_attention_q8(
            *fresh, cache.data.data_ptr(), cache.scale.data_ptr(), *rows, *dims,
            *cache.scale.shape[3:], p.tq, p.grid[2], *tail)
        build.check(rc, "dynamo_prefill_attention_q8")
    else:
        p = plan(b, s, h, hk, d)
        rc = lib.dynamo_prefill_attention(*fresh, cache.data_ptr(), *rows, *dims, p.tq, p.grid[2], *tail)
        build.check(rc, "dynamo_prefill_attention")
    return out


def paged_prefill_attention(
    q: torch.Tensor,             # [B, S, H, D] bf16
    k_new: torch.Tensor,         # [B, S, Hk, D] bf16
    v_new: torch.Tensor,         # [B, S, Hk, D] bf16
    cache: torch.Tensor,         # [L, N, 2, Bs, Hk*D] bf16
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,      # [B] int32
    start: torch.Tensor,         # [B] int32
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Flash prefill for S fresh tokens against fresh K/V + a cached prefix
    in the bf16 cache.  Returns [B, S, H, D]."""
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k_new, v_new, cache, layer, block_tables,
                                     seq_lens, start, sm_scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on cuda or cpu, not {q.device}")
    if isinstance(cache, QuantKvCache):
        raise TypeError("paged_prefill_attention takes a bf16 cache; an int8 one goes to "
                        "paged_prefill_attention_q8")
    out = _launch(q, k_new, v_new, cache, layer, block_tables, seq_lens, start, sm_scale, logit_cap)
    paged_prefill_attention.launches += 1
    return out


def paged_prefill_attention_q8(
    q: torch.Tensor,             # [B, S, H, D] bf16
    k_new: torch.Tensor,         # [B, S, Hk, D] bf16
    v_new: torch.Tensor,         # [B, S, Hk, D] bf16
    cache: QuantKvCache,         # data [L, N, 2, Bs, Hk*D] int8, scale [L, N, 2, Hp, Sp] f32
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,      # [B] int32
    start: torch.Tensor,         # [B] int32
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Flash prefill for S fresh tokens against fresh K/V + a cached prefix
    in an int8 cache.  Returns [B, S, H, D]."""
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k_new, v_new, cache, layer, block_tables,
                                     seq_lens, start, sm_scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention_q8 runs on cuda or cpu, not {q.device}")
    if not isinstance(cache, QuantKvCache):
        raise TypeError("paged_prefill_attention_q8 takes a QuantKvCache")
    out = _launch(q, k_new, v_new, cache, layer, block_tables, seq_lens, start, sm_scale, logit_cap)
    paged_prefill_attention_q8.launches += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention_q8.launches = 0
