"""Paged decode attention: the CUDA kernel, its wrapper and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the TPU kernel
``dynamo_tpu/ops/pallas/decode_attention.py::paged_decode_attention_mq``:
each of B rows has S trailing queries at positions ``q0 .. q0+S-1`` that
attend causally over slots ``[0, seq_len)`` of the row's block table in the
paged cache ``[L, N, 2, Bs, Hk*D]``, at a runtime layer index.  Rows with
``seq_len == 0`` give 0.

:func:`paged_decode_attention` launches the kernel for CUDA tensors and
takes :func:`decode_attention_ref` only for CPU tensors; on any other device
it raises.  One call is two launches on the current stream (the split-K
pass and the merge of its partials, whose f32 workspace the wrapper
allocates); ``paged_decode_attention.launches`` counts calls that launched.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import build

__all__ = ["paged_decode_attention", "decode_attention_ref", "MAX_ROWS"]

MAX_ROWS = 64  # S * (H / Hk) query rows one thread block holds
HEAD_DIMS = (64, 128, 256)
# context tokens per thread block (flash-decoding split-K); a multiple of
# the kernel's key tile (64, or 32 at D = 256)
SPLIT_TOKENS = 256


def decode_attention_ref(
    q: torch.Tensor,             # [B, S, H, D]
    cache: torch.Tensor,         # [L, N, 2, Bs, Hk*D]
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,      # [B] int32 — context incl. the new queries
    q0_pos: torch.Tensor,        # [B] int32 — absolute position of q[:, 0]
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gathers the row's whole table,
    computes in f32, returns ``q.dtype``.  Dead slots (past seq_len) have
    their V zeroed and their scores masked; a row that sees nothing is 0."""
    b, s, h, d = q.shape
    _, _, _, bs, hkd = cache.shape
    hk = hkd // d
    g = h // hk
    m = block_tables.shape[1]
    t = m * bs
    if sm_scale is None:
        sm_scale = d ** -0.5
    kv = cache[layer][block_tables.long()]                  # [B, M, 2, Bs, HkD]
    k = kv[:, :, 0].reshape(b, t, hk, d).float()
    v = kv[:, :, 1].reshape(b, t, hk, d).float()
    slot = torch.arange(t, device=q.device)
    live = slot[None, :] < seq_lens[:, None].long()         # [B, T]
    v = torch.where(live[:, :, None, None], v, 0.0)
    qf = q.float().reshape(b, s, hk, g, d) * sm_scale
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k)
    if logit_cap is not None:
        scores = torch.tanh(scores / logit_cap) * logit_cap
    q_pos = q0_pos[:, None].long() + torch.arange(s, device=q.device)[None, :]
    visible = live[:, None, :] & (slot[None, None, :] <= q_pos[:, :, None])  # [B, S, T]
    scores = torch.where(visible[:, None, None], scores, float("-inf"))
    m_row = scores.amax(dim=-1, keepdim=True)
    m_row = torch.where(torch.isfinite(m_row), m_row, 0.0)
    p = torch.exp(scores - m_row)
    l_row = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    out = torch.einsum("bkgst,btkd->bskgd", p / l_row, v)
    return out.reshape(b, s, h, d).to(q.dtype)


def _check(q, cache, layer, block_tables, seq_lens, q0_pos) -> None:
    tensors = {"q": q, "cache": cache, "block_tables": block_tables,
               "seq_lens": seq_lens, "q0_pos": q0_pos}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "cache"):
        if tensors[name].dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {tensors[name].dtype}")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name in ("block_tables", "seq_lens", "q0_pos"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    b, s, h, d = q.shape
    l, _, two, _, hkd = cache.shape
    if two != 2 or d not in HEAD_DIMS or hkd % d or h % (hkd // d):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} cache {tuple(cache.shape)}")
    if s * (h // (hkd // d)) > MAX_ROWS:
        raise ValueError(f"S * H / Hk = {s * h // (hkd // d)} exceeds {MAX_ROWS}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables shape {tuple(block_tables.shape)}")
    if seq_lens.shape != (b,) or q0_pos.shape != (b,):
        raise ValueError("seq_lens and q0_pos must be [B]")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} out of range [0, {l})")


def paged_decode_attention(
    q: torch.Tensor,             # [B, S, H, D] bf16
    cache: torch.Tensor,         # [L, N, 2, Bs, Hk*D] bf16
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,      # [B] int32
    q0_pos: torch.Tensor,        # [B] int32
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Multi-query flash decode over the paged cache.  Returns [B, S, H, D]."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, cache, layer, block_tables, seq_lens,
                                    q0_pos, sm_scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    layer = int(layer)
    _check(q, cache, layer, block_tables, seq_lens, q0_pos)
    b, s, h, d = q.shape
    _, n, _, bs, hkd = cache.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    hk, m = hkd // d, block_tables.shape[1]
    out = torch.empty_like(q)
    # per (row, kv head, chunk): unnormalised acc [S*G, D], then m and l
    # [S*G].  Dropped when this returns: the caching allocator hands the
    # memory out again only to work queued after the kernels on this stream.
    n_chunks = -(-m * bs // SPLIT_TOKENS)
    workspace = torch.empty(b * hk * n_chunks * s * (h // hk) * (d + 2),
                            dtype=torch.float32, device=q.device)
    lib = build.library()
    rc = lib.dynamo_decode_attention(
        q.data_ptr(), cache.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), q0_pos.data_ptr(), out.data_ptr(), workspace.data_ptr(),
        b, s, h, hk, d, n, bs, m, layer, SPLIT_TOKENS,
        float(sm_scale), float(logit_cap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "dynamo_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
