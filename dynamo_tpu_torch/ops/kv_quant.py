"""Int8 KV cache: per-token, per-KV-head dynamic scales.

The counterpart of ``dynamo_tpu/ops/kv_quant.py``.  Decode reads the whole
live context every step, so KV bytes are decode bandwidth: int8 halves the
cache's footprint and each step's KV traffic.

* :class:`QuantKvCache` holds ``data`` int8 ``[L, N, 2, Bs, Hk*D]``, the
  bf16 cache's layout, and ``scale`` f32 ``[L, N, 2, Hp, Sp]`` with
  ``(Hp, Sp) = scale_tile(Hk, Bs)``.  Scales are token-minor (head row,
  token lane) and tile-padded as the JAX package stores them, so a cache
  carries over between the two packages as it is.  The padding is a TPU
  DMA constraint; here it is only storage: every reader and writer touches
  the valid ``[:Hk, :Bs]`` region, and pad lanes keep whatever they hold.
* Rows are quantised when they are written (``ops/paged_attention.py::
  write_kv_cache_layer``) and rescaled when they are read: the plain ops
  dequantise the gathered blocks, the CUDA kernels rescale in registers.
  Fresh chunk K/V are never quantised by attention.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantKvCache", "resolve_cache_dtype", "scale_tile", "pad_scales", "is_quant", "quantize_kv_rows",
           "dequant_layer_slice", "gather_layer_blocks", "cache_data", "check_quant_cache"]


class QuantKvCache(NamedTuple):
    """Paged KV cache with an int8 payload and per-row-per-head scales."""

    data: torch.Tensor   # [L, N, 2, Bs, Hk*D] int8
    scale: torch.Tensor  # [L, N, 2, Hp, Sp] f32, token-minor; valid [..., :Hk, :Bs]


def resolve_cache_dtype(dtype):
    """A KV cache dtype, given as a name or a ``torch.dtype``, resolved to
    None (the model's dtype), ``"int8"`` (a :class:`QuantKvCache`) or a
    float ``torch.dtype``; anything else raises."""
    if dtype is None:
        return None
    name = str(dtype).replace("torch.", "")
    if name == "int8":
        return "int8"
    dt = getattr(torch, name, None)
    if isinstance(dt, torch.dtype) and dt.is_floating_point:
        return dt
    raise ValueError(f"cache_dtype {dtype!r} is neither int8 nor a float dtype")


def scale_tile(hk: int, bs: int) -> tuple[int, int]:
    """(Hp, Sp): a block's scale tile, (Hk, Bs) rounded up to (8, 128)."""
    return (-(-hk // 8) * 8, -(-bs // 128) * 128)


def pad_scales(sc: torch.Tensor) -> torch.Tensor:
    """Pad token-minor scales ``[..., Hk, Bs]`` to ``[..., Hp, Sp]`` with 1.0,
    a neutral scale."""
    hk, bs = sc.shape[-2:]
    hp, sp = scale_tile(hk, bs)
    if (hp, sp) == (hk, bs):
        return sc
    return torch.nn.functional.pad(sc, (0, sp - bs, 0, hp - hk), value=1.0)


def is_quant(cache) -> bool:
    return isinstance(cache, QuantKvCache)


def cache_data(cache) -> torch.Tensor:
    """The payload tensor ``[L, N, 2, Bs, Hk*D]`` of either cache kind."""
    return cache.data if is_quant(cache) else cache


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., Hk, D]`` -> (int8 ``[..., Hk, D]``, f32 scale ``[..., Hk]``).

    The JAX package's arithmetic in its order, so CPU codes are bit for bit
    its codes: amax in f32, ``max(amax, 1e-8) / 127``, a true divide by the
    scale, round half to even, clip to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequant_layer_slice(data: torch.Tensor, scale: torch.Tensor, hk: int,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Rescale int8 blocks ``[..., Bs, Hk*D]`` by their scale tiles
    ``[..., Hp, Sp]`` (any matching leading dims) back to real values."""
    *lead, bs, hkd = data.shape
    d = hkd // hk
    sc = scale[..., :hk, :bs]                                 # drop the tile padding
    x = data.float().reshape(*lead, bs, hk, d)
    x = x * sc.transpose(-1, -2)[..., None]
    return x.reshape(*lead, bs, hkd).to(dtype)


def gather_layer_blocks(cache, layer: int, ids: torch.Tensor, hk: int) -> torch.Tensor:
    """Blocks ``ids`` (any shape of block ids) of layer ``layer``:
    ``[*ids.shape, 2, Bs, Hk*D]``, in the cache's dtype, or dequantised to
    f32 for a :class:`QuantKvCache`."""
    ids = ids.long()
    if not is_quant(cache):
        return cache[layer][ids]
    return dequant_layer_slice(cache.data[layer][ids], cache.scale[layer][ids], hk)


def check_quant_cache(cache: QuantKvCache, hk: int) -> None:
    """Raise unless ``cache`` is a contiguous int8 payload with an f32 scale
    pool whose tiles cover ``[Hk, Bs]`` (what the int8 kernels read)."""
    data, scale = cache
    if data.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"an int8 cache is int8 data and f32 scales, got {data.dtype}, {scale.dtype}")
    if not data.is_contiguous() or not scale.is_contiguous():
        raise ValueError("the int8 cache's data and scales must be contiguous")
    if data.device != scale.device:
        raise ValueError(f"cache data on {data.device}, scales on {scale.device}")
    l, n, two, bs = data.shape[:4]
    if (scale.dim() != 5 or tuple(scale.shape[:3]) != (l, n, two)
            or scale.shape[3] < hk or scale.shape[4] < bs):
        raise ValueError(f"scale pool {tuple(scale.shape)} does not cover cache {tuple(data.shape)}")
    if data.data_ptr() % 16:
        raise ValueError("the int8 cache must be 16-byte aligned")
