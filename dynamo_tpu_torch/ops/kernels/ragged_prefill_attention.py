"""Ragged paged prefill attention: the CUDA kernel, its wrapper and its plain version.

The kernel (``csrc/ragged_prefill_attention.cu``) replaces the TPU kernel
``dynamo_tpu/ops/pallas/prefill_attention.py::ragged_paged_prefill_attention``:
one flat axis of T tokens packs R rows, and row r owns the real tokens
``[row_offsets[r], row_offsets[r] + seq_lens[r] - starts[r])``.  A row is a
prefill span or a 1-token decode row, whose ``start`` (context - 1) need not
be block-aligned.  Each token attends its own row's cached prefix
``[0, starts[r])`` in full, read from the paged cache ``[L, N, 2, Bs, Hk*D]``
at a runtime layer index, and its own row's fresh K/V causally by flat
index; it never sees another row.  Tokens in no span, and rows with an empty
span (the engine's power-of-two padding rows, all zeros), give 0.

:func:`ragged_paged_prefill_attention` launches the kernel for CUDA tensors
and takes :func:`ragged_prefill_attention_ref` only for CPU tensors; on any
other device it raises.  ``ragged_paged_prefill_attention.launches`` counts
launches.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels.prefill_attention import HEAD_DIMS, MAX_GROUP

__all__ = ["ragged_paged_prefill_attention", "ragged_prefill_attention_ref"]


def ragged_prefill_attention_ref(
    q: torch.Tensor,             # [1, T, H, D]
    k_new: torch.Tensor,         # [1, T, Hk, D]
    v_new: torch.Tensor,         # [1, T, Hk, D]
    cache: torch.Tensor,         # [L, N, 2, Bs, Hk*D]
    layer: int,
    block_tables: torch.Tensor,  # [R, M] int32, prefix blocks leading
    seq_lens: torch.Tensor,      # [R] int32 — context incl. the row's fresh tokens
    starts: torch.Tensor,        # [R] int32 — absolute position of the row's first token
    row_offsets: torch.Tensor,   # [R] int32 — flat index of the row's first token
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, one row at a time: the row's
    prefix is exactly its first ``start`` cache slots (so dead slots and
    other rows' blocks are never read), its fresh keys exactly its own span,
    everything in f32, returns ``q.dtype``.  Working per row keeps memory at
    one row's scores; gathering every token's prefix, as the JAX package's
    oracle does, would take gigabytes at serving shapes.  Reads the row
    table on the host."""
    _, t, h, d = q.shape
    bs, hkd = cache.shape[3], cache.shape[4]
    hk = hkd // d
    g = h // hk
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.zeros_like(q)
    layer_kv = cache[layer]
    rows = zip(seq_lens.tolist(), starts.tolist(), row_offsets.tolist())
    for r, (n_ctx, start, off) in enumerate(rows):
        fresh = n_ctx - start
        if fresh <= 0:
            continue
        nb = -(-start // bs)
        kv = layer_kv[block_tables[r, :nb].long()]                 # [nb, 2, Bs, HkD]
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
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "cache": cache,
               "block_tables": block_tables, "seq_lens": seq_lens, "starts": starts,
               "row_offsets": row_offsets}
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
    for name in ("block_tables", "seq_lens", "starts", "row_offsets"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    one, t, h, d = q.shape
    l, _, two, _, hkd = cache.shape
    hk = hkd // d if d else 0
    if (one != 1 or t < 1 or two != 2 or d not in HEAD_DIMS or hkd % d or h % hk
            or h // hk > MAX_GROUP):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} cache {tuple(cache.shape)}")
    if k_new.shape != (1, t, hk, d) or v_new.shape != (1, t, hk, d):
        raise ValueError("k_new and v_new must be [1, T, Hk, D]")
    r = block_tables.shape[0] if block_tables.dim() == 2 else -1
    if r < 1 or any(x.shape != (r,) for x in (seq_lens, starts, row_offsets)):
        raise ValueError("block_tables must be [R, M] and seq_lens, starts, row_offsets [R]")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} out of range [0, {l})")


def ragged_paged_prefill_attention(
    q: torch.Tensor,             # [1, T, H, D] bf16
    k_new: torch.Tensor,         # [1, T, Hk, D] bf16
    v_new: torch.Tensor,         # [1, T, Hk, D] bf16
    cache: torch.Tensor,         # [L, N, 2, Bs, Hk*D] bf16
    layer: int,
    block_tables: torch.Tensor,  # [R, M] int32
    seq_lens: torch.Tensor,      # [R] int32
    starts: torch.Tensor,        # [R] int32
    row_offsets: torch.Tensor,   # [R] int32
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Flash attention of T packed tokens of R rows against their own
    fresh K/V and cached prefix.  Returns [1, T, H, D]."""
    if q.device.type == "cpu":
        return ragged_prefill_attention_ref(q, k_new, v_new, cache, layer, block_tables,
                                            seq_lens, starts, row_offsets, sm_scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_prefill_attention runs on cuda or cpu, not {q.device}")
    layer = int(layer)
    _check(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets)
    _, t, h, d = q.shape
    _, n, _, bs, hkd = cache.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.empty_like(q)
    lib = build.library()
    rc = lib.dynamo_ragged_prefill_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), starts.data_ptr(), row_offsets.data_ptr(),
        out.data_ptr(), t, h, hkd // d, d, n, bs, block_tables.shape[1], block_tables.shape[0],
        layer, float(sm_scale), float(logit_cap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "dynamo_ragged_prefill_attention")
    ragged_paged_prefill_attention.launches += 1
    return out


ragged_paged_prefill_attention.launches = 0
