"""Paged prefill attention: the CUDA kernel, its wrapper and its plain version.

The kernel (``csrc/prefill_attention.cu``) replaces the TPU kernel
``dynamo_tpu/ops/pallas/prefill_attention.py::paged_prefill_attention``:
each of B rows has S fresh queries from the block-aligned position
``start``; they attend the cached prefix ``[0, start)`` in full, read from
the paged cache ``[L, N, 2, Bs, Hk*D]`` at a runtime layer index, and their
own fresh K/V causally, masked at ``seq_len - start``.  Padding query rows
(index ``>= seq_len - start``) give 0.

:func:`paged_prefill_attention` launches the kernel for CUDA tensors and
takes :func:`prefill_attention_ref` only for CPU tensors; on any other
device it raises.  ``paged_prefill_attention.launches`` counts launches.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import build

__all__ = ["paged_prefill_attention", "prefill_attention_ref"]

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 64  # query heads per KV head one thread block can hold


def prefill_attention_ref(
    q: torch.Tensor,             # [B, S, H, D]
    k_new: torch.Tensor,         # [B, S, Hk, D]
    v_new: torch.Tensor,         # [B, S, Hk, D]
    cache: torch.Tensor,         # [L, N, 2, Bs, Hk*D]
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32, prefix blocks leading
    seq_lens: torch.Tensor,      # [B] int32 — context incl. fresh tokens
    start: torch.Tensor,         # [B] int32 — absolute position of q[:, 0]
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the prefix is the row's whole
    table masked at ``start``, everything in f32, returns ``q.dtype``.  Dead
    prefix slots and fresh padding have their V zeroed; padding query rows
    see nothing and give 0."""
    b, s, h, d = q.shape
    _, _, _, bs, hkd = cache.shape
    hk = hkd // d
    g = h // hk
    m = block_tables.shape[1]
    t = m * bs
    if sm_scale is None:
        sm_scale = d ** -0.5
    start = start.long()
    fresh = seq_lens.long() - start                                     # [B]
    kv = cache[layer][block_tables.long()]                              # [B, M, 2, Bs, HkD]
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
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "cache": cache,
               "block_tables": block_tables, "seq_lens": seq_lens, "start": start}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k_new", "v_new", "cache"):
        if tensors[name].dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {tensors[name].dtype}")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name in ("block_tables", "seq_lens", "start"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    b, s, h, d = q.shape
    l, _, two, _, hkd = cache.shape
    hk = hkd // d if d else 0
    if two != 2 or d not in HEAD_DIMS or hkd % d or h % hk or h // hk > MAX_GROUP:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} cache {tuple(cache.shape)}")
    if k_new.shape != (b, s, hk, d) or v_new.shape != (b, s, hk, d):
        raise ValueError("k_new and v_new must be [B, S, Hk, D]")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables shape {tuple(block_tables.shape)}")
    if seq_lens.shape != (b,) or start.shape != (b,):
        raise ValueError("seq_lens and start must be [B]")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} out of range [0, {l})")


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
    """Flash prefill for S fresh tokens against fresh K/V + cached prefix.
    Returns [B, S, H, D]."""
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k_new, v_new, cache, layer, block_tables,
                                     seq_lens, start, sm_scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on cuda or cpu, not {q.device}")
    layer = int(layer)
    _check(q, k_new, v_new, cache, layer, block_tables, seq_lens, start)
    b, s, h, d = q.shape
    _, n, _, bs, hkd = cache.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.empty_like(q)
    lib = build.library()
    rc = lib.dynamo_prefill_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), start.data_ptr(), out.data_ptr(),
        b, s, h, hkd // d, d, n, bs, block_tables.shape[1], layer,
        float(sm_scale), float(logit_cap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "dynamo_prefill_attention")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
