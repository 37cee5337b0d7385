"""Paged decode attention: the CUDA kernel, its wrappers, its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the TPU kernel
``dynamo_tpu/ops/pallas/decode_attention.py::paged_decode_attention_mq``,
its bf16 and its int8 body: each of B rows has S trailing queries at
positions ``q0 .. q0+S-1`` that attend causally over slots ``[0, seq_len)``
of the row's block table in the paged cache ``[L, N, 2, Bs, Hk*D]``, at a
runtime layer index.  Rows with ``seq_len == 0`` give 0.

:func:`paged_decode_attention` (a bf16 cache) and
:func:`paged_decode_attention_q8` (a :class:`QuantKvCache`) launch the
kernel for CUDA tensors and take :func:`decode_attention_ref` only for CPU
tensors; on any other device they raise.  Each wrapper's ``launches``
counts its calls that launched.

One design serves both caches: a call is one launch of the pipelined
split-K kernel, compiled for each cache's element type.  :func:`plan` is
its launch, from the geometry it compiles with
(``csrc/launch_geometry.cuh``, whose stages, block budget and shared memory
differ by cache); the last chunk of each (row, KV head, row group) to
finish merges the chunks' partials, counted by a ticket that the launch
leaves zeroed.  The partials and the tickets are one buffer each per
stream (:func:`_stream_scratch`), so a call allocates nothing but its
output, and a CUDA graph can capture it as it is.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, cache_data, check_quant_cache, gather_layer_blocks

__all__ = ["paged_decode_attention", "paged_decode_attention_q8", "decode_attention_ref", "MAX_ROWS",
           "DecodePlan", "plan"]

MAX_ROWS = 64  # S * (H / Hk) query rows one thread block holds
HEAD_DIMS = (64, 128, 256)
ROW_GROUPS = (4, 8, 16)  # query rows a block holds, as compiled


@dataclass(frozen=True)
class DecodePlan:
    """The kernel's launch: ``grid`` = (KV heads x row groups, rows of
    the batch, chunks) blocks of ``threads`` with ``smem`` bytes of dynamic
    shared memory.  Block (x, b, c) attends context slots ``[c * chunk,
    (c + 1) * chunk)`` of row b for query rows ``[rows * (x % row_groups),
    + rows)`` of KV head ``x // row_groups`` (row = token s * G + group
    head g); the chunk is the slowest axis, so every row's first chunks are
    dispatched first; the ``n_chunks`` chunks cover the table's ``M * Bs`` slots once,
    the row groups the ``S * G`` query rows once.  ``workspace`` floats hold
    one partial (``rows * (D + 2)``) per (row, KV head, row group, chunk);
    ``tickets`` ints one counter per (row, KV head, row group)."""
    chunk: int
    n_chunks: int
    rows: int
    row_groups: int
    grid: tuple[int, int, int]
    threads: int
    smem: int
    workspace: int
    tickets: int


@functools.lru_cache(maxsize=4096)
def plan(b: int, s: int, h: int, hk: int, d: int, m: int, bs: int, sms: int, quant: bool) -> DecodePlan:
    """The kernel's launch for q [b, s, h, d] over hk KV heads and a block
    table of m blocks of bs slots, over an int8 cache (``quant``, B4a) or a
    bf16 one (B1), on a card of ``sms`` SMs.  A row's context is known only
    on the card: a row of n tokens puts ceil(n / chunk) blocks per (KV head,
    row group) to work, and the rest exit at once.  Chunks are a whole
    number of the kernel's shortest (``B4A_CHUNK`` tokens, one 16-key tile
    per warp), as short as keeps the grid of a full table within the cache
    kind's ``BLOCKS_PER_SM`` blocks per SM (a few waves of the blocks that
    fit, two for int8 and four for bf16, as timed on the card: rows are
    seldom full, and a short row then still spreads over many blocks while
    long rows do not queue for many more waves), and long enough that a row
    has at most ``B4A_MAX_CHUNKS`` partials to merge."""
    g = build.geometry()
    kind = "B4A" if quant else "B1"
    width = m * bs
    q_rows = s * (h // hk)
    rows = next(x for x in ROW_GROUPS if x >= min(q_rows, g[f"{kind}_ROWS_D{d}"]))
    groups = -(-q_rows // rows)
    base = g["B4A_CHUNK"]
    per_chunk = b * hk * groups  # blocks per chunk of the table
    chunk = base * max(1, -(-width // (base * g["B4A_MAX_CHUNKS"])),
                       -(-per_chunk * width // (base * g[f"{kind}_BLOCKS_PER_SM"] * sms)))
    n_chunks = -(-width // chunk)
    grid = (hk * groups, b, n_chunks)
    if max(grid[1:]) > 65535:
        raise ValueError(f"grid {grid} exceeds CUDA's limit of 65535 blocks on y and z")
    return DecodePlan(chunk, n_chunks, rows, groups, grid, g["B4A_THREADS"], g[f"{kind}_SMEM_D{d}_R{rows}"],
                      b * hk * groups * n_chunks * rows * (d + 2), b * hk * groups)


# per (device, stream): [workspace, tickets, whether a CUDA graph captured them]
_scratch: dict[tuple[torch.device, int], list] = {}
# buffers a CUDA graph captured before its stream's buffers grew: its
# replays still write them, so they are never freed
_retired: list[tuple[torch.Tensor, torch.Tensor]] = []


def _stream_scratch(device: torch.device, stream: int, p: DecodePlan,
                    capturing: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's partials and zeroed tickets on ``stream``, grown to
    ``p``'s sizes (one pair serves both cache kinds).  Launches on one
    stream run in order, so they never use the buffers at once, and the
    kernel leaves the tickets zeroed, so a CUDA graph captured on the stream
    (``capturing``) takes the buffers as they are.  When a later plan needs
    more room, buffers that a graph captured are kept alive for its replays
    rather than freed; buffers first needed inside a capture come from that
    graph's memory pool and stay held here.  A graph replays with its
    capture stream's buffers, so it must not replay while launches on that
    stream are in flight elsewhere."""
    entry = _scratch.get((device, stream))
    if entry is None or entry[0].numel() < p.workspace or entry[1].numel() < p.tickets:
        if entry is not None and entry[2]:
            _retired.append((entry[0], entry[1]))
        old_ws, old_t = (entry[0].numel(), entry[1].numel()) if entry is not None else (0, 0)
        entry = [torch.empty(max(p.workspace, old_ws), dtype=torch.float32, device=device),
                 torch.zeros(max(p.tickets, old_t), dtype=torch.int32, device=device), False]
        _scratch[(device, stream)] = entry
    entry[2] = entry[2] or capturing
    return entry[0], entry[1]


def decode_attention_ref(
    q: torch.Tensor,             # [B, S, H, D]
    cache,                       # [L, N, 2, Bs, Hk*D], or a QuantKvCache
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,      # [B] int32 — context incl. the new queries
    q0_pos: torch.Tensor,        # [B] int32 — absolute position of q[:, 0]
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of both kernels: gathers the row's whole table
    (dequantised in f32 for an int8 cache), computes in f32, returns
    ``q.dtype``.  Dead slots (past seq_len) have their V zeroed and their
    scores masked, so NaN in a dead slot or its scale never reaches the
    output; a row that sees nothing is 0."""
    b, s, h, d = q.shape
    _, _, _, bs, hkd = cache_data(cache).shape
    hk = hkd // d
    g = h // hk
    m = block_tables.shape[1]
    t = m * bs
    if sm_scale is None:
        sm_scale = d ** -0.5
    kv = gather_layer_blocks(cache, layer, block_tables, hk)  # [B, M, 2, Bs, HkD]
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
    quant = isinstance(cache, QuantKvCache)
    data = cache_data(cache)
    tensors = {"q": q, "cache": data, "block_tables": block_tables,
               "seq_lens": seq_lens, "q0_pos": q0_pos}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q",) if quant else ("q", "cache"):
        if tensors[name].dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {tensors[name].dtype}")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name in ("block_tables", "seq_lens", "q0_pos"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    b, s, h, d = q.shape
    l, _, two, _, hkd = data.shape
    if two != 2 or d not in HEAD_DIMS or hkd % d or h % (hkd // d):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} cache {tuple(data.shape)}")
    if quant:
        check_quant_cache(cache, hkd // d)
    if s * (h // (hkd // d)) > MAX_ROWS:
        raise ValueError(f"S * H / Hk = {s * h // (hkd // d)} exceeds {MAX_ROWS}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or block_tables.shape[1] < 1:
        raise ValueError(f"block_tables shape {tuple(block_tables.shape)}")
    if seq_lens.shape != (b,) or q0_pos.shape != (b,):
        raise ValueError("seq_lens and q0_pos must be [B]")
    if not 0 <= layer < l:
        raise ValueError(f"layer {layer} out of range [0, {l})")


def _launch(q, cache, layer, block_tables, seq_lens, q0_pos, sm_scale, logit_cap) -> torch.Tensor:
    """Check and launch the kernel for ``cache``'s kind; returns the output."""
    layer = int(layer)
    _check(q, cache, layer, block_tables, seq_lens, q0_pos)
    b, s, h, d = q.shape
    _, n, _, bs, hkd = cache_data(cache).shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    hk, m = hkd // d, block_tables.shape[1]
    out = torch.empty_like(q)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    quant = isinstance(cache, QuantKvCache)
    p = plan(b, s, h, hk, d, m, bs, build.sm_count(q.device.index or 0), quant)
    workspace, tickets = _stream_scratch(q.device, stream, p, torch.cuda.is_current_stream_capturing())
    # the int8 entry point takes the scale pool after the cache, and its
    # tile (Hp, Sp) after the shapes
    ptrs = (q.data_ptr(), cache_data(cache).data_ptr(), *((cache.scale.data_ptr(),) if quant else ()),
            block_tables.data_ptr(), seq_lens.data_ptr(), q0_pos.data_ptr(), out.data_ptr(),
            workspace.data_ptr(), tickets.data_ptr())
    dims = (b, s, h, hk, d, n, bs, m, layer, *(cache.scale.shape[3:] if quant else ()))
    name = "dynamo_decode_attention_q8" if quant else "dynamo_decode_attention"
    build.check(getattr(lib, name)(*ptrs, *dims, p.chunk, p.n_chunks, p.rows, p.row_groups, float(sm_scale),
                                   float(logit_cap or 0.0), stream), name)
    return out


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
    """Multi-query flash decode over the bf16 paged cache.  Returns [B, S, H, D]."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, cache, layer, block_tables, seq_lens,
                                    q0_pos, sm_scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    if isinstance(cache, QuantKvCache):
        raise TypeError("paged_decode_attention takes a bf16 cache; an int8 one goes to "
                        "paged_decode_attention_q8")
    out = _launch(q, cache, layer, block_tables, seq_lens, q0_pos, sm_scale, logit_cap)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_q8(
    q: torch.Tensor,             # [B, S, H, D] bf16
    cache: QuantKvCache,         # data [L, N, 2, Bs, Hk*D] int8, scale [L, N, 2, Hp, Sp] f32
    layer: int,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,      # [B] int32
    q0_pos: torch.Tensor,        # [B] int32
    sm_scale: float | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Multi-query flash decode over an int8 paged cache.  Returns [B, S, H, D]."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, cache, layer, block_tables, seq_lens,
                                    q0_pos, sm_scale, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_q8 runs on cuda or cpu, not {q.device}")
    if not isinstance(cache, QuantKvCache):
        raise TypeError("paged_decode_attention_q8 takes a QuantKvCache")
    out = _launch(q, cache, layer, block_tables, seq_lens, q0_pos, sm_scale, logit_cap)
    paged_decode_attention_q8.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_q8.launches = 0
