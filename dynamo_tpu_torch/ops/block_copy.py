"""Batched KV-block gather/scatter over the cache's block axis.

The counterpart of ``dynamo_tpu/ops/block_copy.py``, which the JAX package
computes in plain XLA (no Pallas kernel): here it is plain PyTorch,
``index_select`` and indexed assignment, on whatever device the cache is
on.  The disaggregated handoff moves a request's blocks with these: a
colocated prefill engine's gather feeds the decode engine's scatter on the
card, and the TCP path stages the gather on the host.

Cache layout: ``[L, N, 2, Bs, Hk*D]`` (layers, blocks, k/v, block size,
flat kv heads x head dim), so one block id selects the block across every
layer.  An int8 :class:`~dynamo_tpu_torch.ops.kv_quant.QuantKvCache` is
two such tensors (the payload and its ``[L, N, 2, Hp, Sp]`` scale tiles,
pad lanes included); both functions work part by part.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kv_quant import QuantKvCache

__all__ = [
    "gather_blocks",
    "gather_blocks_padded",
    "scatter_blocks",
    "scatter_blocks_inplace",
]


def _parts(cache) -> tuple:
    return tuple(cache) if isinstance(cache, (tuple, list)) else (cache,)


def _like(cache, parts: tuple):
    """``parts`` in the structure of ``cache``: one tensor, a QuantKvCache
    or a plain tuple."""
    if isinstance(cache, QuantKvCache):
        return QuantKvCache(*parts)
    if isinstance(cache, (tuple, list)):
        return tuple(parts)
    return parts[0]


def _ids(block_ids, device) -> torch.Tensor:
    if isinstance(block_ids, torch.Tensor):
        return block_ids.to(device=device, dtype=torch.long)
    return torch.as_tensor(list(block_ids), dtype=torch.long, device=device)


def gather_blocks(cache, block_ids):
    """Pull blocks out of a cache: ``[L, N, ...]`` x ``[n]`` -> ``[L, n, ...]``,
    part by part for a QuantKvCache (a new tensor; the cache is untouched)."""
    parts = _parts(cache)
    ids = _ids(block_ids, parts[0].device)
    return _like(cache, tuple(p.index_select(1, ids) for p in parts))


# The JAX package pads the id count to a power of two so XLA compiles
# O(log n) executables; eager PyTorch compiles nothing, so the padded name
# is the same function, kept so the counterpart is easy to find.
gather_blocks_padded = gather_blocks


def scatter_blocks_inplace(cache, block_ids, blocks):
    """Write transferred blocks into ``cache`` at ``block_ids``, in place:
    ``blocks`` is ``[L, n, ...]`` per part (tensors on any device), cast to
    the cache's dtype as ``b.astype(c.dtype)`` does in JAX.  Returns the
    cache."""
    parts, new = _parts(cache), _parts(blocks)
    if len(parts) != len(new):
        raise ValueError(f"blocks have {len(new)} parts, the cache {len(parts)}")
    if len(block_ids) == 0:
        return cache
    ids = _ids(block_ids, parts[0].device)
    for c, b in zip(parts, new):
        if b.shape[0] != c.shape[0] or b.shape[1] != len(ids) or b.shape[2:] != c.shape[2:]:
            raise ValueError(f"blocks {tuple(b.shape)} do not fit {len(ids)} blocks of a "
                             f"cache {tuple(c.shape)}")
        c[:, ids] = b.to(device=c.device, dtype=c.dtype)
    return cache


def scatter_blocks(cache, block_ids, blocks):
    """Out-of-place :func:`scatter_blocks_inplace`: a copy of the cache with
    the blocks written (the JAX function's functional form)."""
    copy = _like(cache, tuple(p.clone() for p in _parts(cache)))
    return scatter_blocks_inplace(copy, block_ids, blocks)
