"""Grouped expert matrix product: the CUDA kernel, its wrappers, its plain versions.

The kernel (``csrc/grouped_matmul.cu``) computes the mixture-of-experts
MLP's grouped products, the work the JAX package gives to XLA's
``jax.lax.ragged_dot`` in ``dynamo_tpu/models/llama.py::
grouped_expert_dispatch``: ``out[r] = x[r] @ w[e(r)]`` for x ``[R, K]`` bf16
whose rows are sorted by expert, ``offsets`` ``[E + 1]`` int32 the device
prefix sum of the group sizes, and the stacked experts ``w`` ``[E, K, N]``:
bf16 (E1, :func:`grouped_matmul`) or int8 codes with an f32 scale ``[E, 1,
N]`` per (expert, output channel) (E2, :func:`grouped_matmul_q8`), applied
to the f32 accumulator before the one rounding to bf16.

The wrappers never read the group sizes on the host: :func:`plan` sizes the
launch from R, E, N and K alone (the row tile from the mean group R / E, a
persistent grid of a few blocks per SM, or fewer when no grouping of R rows
makes as many work items), and each block finds its work items from the
device offsets (:func:`tile_schedule` is that walk in Python).  So a call
costs no host sync, and a CUDA graph can hold it.

For CUDA tensors the wrappers launch the kernel or raise; for CPU tensors
they take the plain versions, a per-expert loop of ``torch.matmul`` over the
host's group sizes.  The int8 plain version repeats the kernel's arithmetic
(the codes exactly, an f32 product, the scale in f32, one rounding), as
B5's does; the model's CPU path instead dequantises the stack to the
activation dtype first, in the JAX package's order (``models/quant.py::
grouped_matmul``).  On any other device they raise.
``grouped_matmul.launches`` and ``grouped_matmul_q8.launches`` count calls
that launched.
"""

from __future__ import annotations

import bisect
import functools
from dataclasses import dataclass

import torch

from dynamo_tpu_torch.ops.kernels import build

__all__ = ["grouped_matmul", "grouped_matmul_q8", "grouped_matmul_ref", "grouped_matmul_q8_ref",
           "GroupedPlan", "plan", "tile_schedule"]


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of E1: expert e's rows ``offsets[e]:offsets[e + 1]``
    times ``w[e]``, one ``torch.matmul`` per expert that has rows."""
    bounds = offsets.tolist()
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[lo:hi] = x[lo:hi] @ w[e]
    return out


def grouped_matmul_q8_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of E2: each expert's rows times its int8 codes in f32,
    times its scale in f32, rounded once to ``x``'s dtype."""
    bounds = offsets.tolist()
    out = x.new_zeros((x.shape[0], wq.shape[-1]))
    for e in range(wq.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[lo:hi] = ((x[lo:hi].float() @ wq[e].float()) * scale[e].reshape(1, -1)).to(x.dtype)
    return out


@dataclass(frozen=True)
class GroupedPlan:
    """One launch: ``blocks`` persistent blocks of ``threads`` with ``smem``
    bytes of dynamic shared memory, walking work items of one expert's tile
    of ``rows`` rows by ``channels`` output channels (``grid_n`` column
    tiles cover N).  ``max_tiles`` is the most row tiles any grouping of R
    rows over E experts takes."""
    rows: int
    channels: int
    grid_n: int
    max_tiles: int
    blocks: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=1024)
def plan(r: int, e: int, n: int, k: int, quant: bool, sms: int) -> GroupedPlan:
    """The launch for R sorted rows over E experts of [K, N] weights on a
    card with ``sms`` SMs.  The row tile follows the mean group R / E: 8
    rows while most groups hold one or two (decode), 32 from ``MID_FROM``
    rows a group, 128 from ``PREFILL_FROM``.  A group of c rows takes
    ceil(c / rows) <= (c + rows - 1) / rows tiles and at most min(E, R)
    groups have rows, so no grouping takes more than
    (R + min(E, R) (rows - 1)) // rows row tiles; the grid is
    ``GMM_BLOCKS_PER_SM_<type>_R<rows>`` blocks per SM, or that many items
    if fewer."""
    g = build.geometry()
    if r >= g["GMM_PREFILL_FROM"] * e:
        rows = g["GMM_ROWS_PREFILL"]
    elif r >= g["GMM_MID_FROM"] * e:
        rows = g["GMM_ROWS_MID"]
    else:
        rows = g["GMM_ROWS_DECODE"]
    ch = g["GMM_CHANNELS"]
    grid_n = -(-n // ch)
    max_tiles = (r + min(e, r) * (rows - 1)) // rows
    kind = f"{'Q8' if quant else 'BF16'}_R{rows}"
    blocks = min(g[f"GMM_BLOCKS_PER_SM_{kind}"] * sms, max_tiles * grid_n)
    return GroupedPlan(rows, ch, grid_n, max_tiles, blocks, g["GMM_THREADS"], g[f"GMM_SMEM_{kind}"])


def tile_schedule(counts: list[int], rows: int, grid_n: int, blocks: int,
                  channels: int = 128) -> list[list[tuple[int, int, int, int]]]:
    """What each of the ``blocks`` persistent blocks computes, as the kernel
    walks it: block b takes items b, b + blocks, ... of (row tile, column
    tile), the column tiles of a row tile adjacent; row tiles are numbered
    expert by expert, ceil(count / rows) each, and an item's expert is the
    last whose first row tile is at or below the item's (the kernel's binary
    search).  Returns, per block, its items as (expert, first row, row
    count, first channel)."""
    first, starts = [0], [0]
    for c in counts:
        first.append(first[-1] + -(-c // rows))
        starts.append(starts[-1] + c)
    items = first[-1] * grid_n
    out: list[list[tuple[int, int, int, int]]] = []
    for b in range(blocks):
        mine = []
        for item in range(b, items, blocks):
            rt = item // grid_n
            e = bisect.bisect_right(first, rt) - 1
            row0 = starts[e] + (rt - first[e]) * rows
            mine.append((e, row0, min(rows, starts[e + 1] - row0), (item - rt * grid_n) * channels))
        out.append(mine)
    return out


def _check(x, w, scale, offsets, quant: bool) -> None:
    g = build.geometry()
    for name, t in (("w", w), ("offsets", offsets)) + ((("scale", scale),) if quant else ()):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    want_w = torch.int8 if quant else torch.bfloat16
    if x.dtype != torch.bfloat16 or w.dtype != want_w or offsets.dtype != torch.int32 or (
            quant and scale.dtype != torch.float32):
        raise TypeError(f"x bf16, w {want_w}, offsets int32{', scale f32' if quant else ''} expected; "
                        f"got {x.dtype}, {w.dtype}, {offsets.dtype}")
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] or offsets.shape != (w.shape[0] + 1,):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, offsets {tuple(offsets.shape)}")
    e, k, n = w.shape
    if quant and scale.numel() != e * n:
        raise ValueError(f"scale {tuple(scale.shape)} for w {tuple(w.shape)}: one per (expert, channel)")
    if k % 8 or n % (16 if quant else 8) or e > g["GMM_MAX_EXPERTS"]:
        raise ValueError(f"w {tuple(w.shape)}: K a multiple of 8, N of {16 if quant else 8}, "
                         f"at most {g['GMM_MAX_EXPERTS']} experts")
    tensors = (x, w, offsets) + ((scale,) if quant else ())
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, w, scale and offsets must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")


def _launch(x, w, scale, offsets, quant: bool, wrapper) -> torch.Tensor:
    """Plan and launch on the current stream, counted on ``wrapper``;
    reads nothing of the tensors' values on the host."""
    r = x.shape[0]
    e, k, n = w.shape
    out = torch.empty((r, n), dtype=torch.bfloat16, device=x.device)
    if r == 0:
        return out
    p = plan(r, e, n, k, quant, build.sm_count(x.device.index or 0))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().dynamo_grouped_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr() if quant else None, offsets.data_ptr(),
        out.data_ptr(), r, n, k, e, int(quant), p.rows, p.grid_n, p.blocks, stream)
    build.check(rc, "dynamo_grouped_matmul")
    wrapper.launches += 1
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """E1: x [R, K] bf16 (rows sorted by expert), w [E, K, N] bf16,
    offsets [E + 1] int32.  Returns [R, N] bf16."""
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cuda or cpu, not {x.device}")
    _check(x, w, None, offsets, quant=False)
    return _launch(x, w, None, offsets, False, grouped_matmul)


def grouped_matmul_q8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """E2: as :func:`grouped_matmul` over int8 codes ``wq`` [E, K, N] and
    their f32 ``scale`` [E, 1, N]."""
    if x.device.type == "cpu":
        return grouped_matmul_q8_ref(x, wq, scale, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul_q8 runs on cuda or cpu, not {x.device}")
    _check(x, wq, scale, offsets, quant=True)
    return _launch(x, wq, scale, offsets, True, grouped_matmul_q8)


grouped_matmul.launches = 0
grouped_matmul_q8.launches = 0
