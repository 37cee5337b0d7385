"""Ring attention: sequence parallelism over a mesh axis.

The counterpart of ``dynamo_tpu/ops/ring_attention.py``.  A prompt is split
along its sequence over the ranks of one mesh axis; each rank keeps its
query chunk and attends blockwise while the key/value chunks travel around
the ring, merged with the online-softmax (flash-attention) recurrence, so
the result is exact:

    rank i holds Q_i throughout; at ring step t it attends to
    KV_{(i - t) mod n} and merges the partial result into the running
    (m, l, o) state, held in f32.  n steps visit every chunk once.

The JAX package computes this with einsums under ``shard_map`` and moves the
chunks with ``ppermute``, not in a Pallas kernel; here the einsums are torch
ops on each rank's own shard and the ring step is the mesh's
``batch_isend_irecv`` (``utils/mesh.py::Mesh.ring_shift``).  The port has no
global arrays: :func:`ring_attention` takes each rank's local chunks where the
JAX function takes the sharded whole.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dynamo_tpu_torch.ops.paged_attention import softcap
from dynamo_tpu_torch.utils.mesh import AXIS_SP

__all__ = ["ring_attention", "ring_attention_inner"]

_NEG_INF = -1e30


def ring_attention_inner(
    q: torch.Tensor,       # [B, Sq, Hq, D]  this rank's query chunk
    k: torch.Tensor,       # [B, Sk, Hk, D]  this rank's key chunk
    v: torch.Tensor,       # [B, Sk, Hk, D]  this rank's value chunk
    q_pos: torch.Tensor,   # [B, Sq] int     global positions of the local queries
    kv_pos: torch.Tensor,  # [B, Sk] int     global positions of the local keys
    mesh,
    axis: str,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    logit_cap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One rank's ring attention.  Returns [B, Sq, Hq, D] in q's dtype.

    GQA runs in the grouped layout [B, Sq, Hk, rep, D] (the kv-head
    broadcast fuses into the products).  Masking is by position (q_pos >=
    kv_pos), so ragged and padded chunks work: give a padding key a position
    above every query.  ``window`` adds sliding-window masking (q_pos -
    kv_pos < window) and needs ``causal``; a fully masked row gives 0."""
    if window is not None and not causal:
        # the window mask lives inside the causal branch: silently ignoring
        # it for a bidirectional caller would be a wrong answer
        raise ValueError("window requires causal=True")
    n = mesh.axis_size(axis)
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    rep = hq // hk
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, hk, rep, d)
    qp = q_pos.long()[:, None, None, :, None]
    o = torch.zeros((b, hk, rep, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hk, rep, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hk, rep, sq), dtype=torch.float32, device=q.device)
    k_c, v_c, pos_c = k, v, kv_pos
    for step in range(n):
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k_c.float()) * scale
        if logit_cap is not None:  # Gemma2 attention score softcap
            s = softcap(s, logit_cap)
        if causal:
            kp = pos_c.long()[:, None, None, None, :]
            mask = qp >= kp
            if window is not None:
                mask &= (qp - kp) < window
            s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        # fully masked rows: m_new is still _NEG_INF, so s - m_new == 0 and p
        # would be 1 for every masked key — zero it (flash-attention guard)
        p = torch.where((m_new == _NEG_INF)[..., None], 0.0, p)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, v_c.float())
        m = m_new
        if step + 1 < n:  # the last step's chunks would only come home
            k_c, v_c, pos_c = mesh.ring_shift([k_c, v_c, pos_c], axis)
    out = o / torch.where(l == 0.0, 1.0, l)[..., None]  # fully masked rows -> 0
    # [B, Hk, rep, Sq, D] -> [B, Sq, Hk*rep = Hq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    mesh,
    axis: str = AXIS_SP,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    logit_cap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``axis``: q/k/v [B, S/n,
    H, D] and q_pos/kv_pos [B, S/n] are this rank's chunks of the sequence
    (rank i of the axis holds chunk i); the output is this rank's chunk."""
    if axis not in mesh.axis_names:
        # a missing axis must fail here: the ring would degenerate to one
        # (wrong) step over this rank's chunk alone
        raise ValueError(f"ring_attention axis {axis!r} not in mesh axes "
                         f"{tuple(mesh.axis_names)}")
    return ring_attention_inner(q, k, v, q_pos, kv_pos, mesh, axis, causal=causal,
                                sm_scale=sm_scale, logit_cap=logit_cap, window=window)
