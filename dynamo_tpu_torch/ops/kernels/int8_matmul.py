"""W8A16 matrix product: the CUDA kernel, its wrapper and its plain version.

The kernel (``csrc/int8_matmul.cu``) replaces the TPU kernel
``dynamo_tpu/ops/pallas/int8_matmul.py::int8_matmul``: ``(x @ wq) * scale``
for x ``[M, K]`` bf16, an int8 weight ``[K, N]`` and one f32 scale per
output channel ``[N]``, with the int8 -> bf16 convert inside the kernel, f32
accumulation and the scale applied in f32 before the one rounding to the
output dtype (bf16, or f32 for logits).  The weight may be a row-major
``[K, N]`` tensor or the transpose view of a row-major ``[N, K]`` one (the
tied embedding as the lm_head), which the kernel reads as it lies.

The kernel has two regimes chosen by M: up to 16 rows a weight-streaming
mma.sync kernel with the operands swapped, above that a wgmma kernel fed by
a cp.async ring.  Both split K when the output tiles alone cannot fill the
card and finish the split in the same launch, in a fixed order (the same
result on every run).  :func:`plan` is the launch, from the geometry the
kernels compile with (``csrc/launch_geometry.cuh``); the C entry point
launches that plan and refuses one that does not fit the shapes.  Any M, N
and K; rows off 16 bytes take a slower element-wise copy in the kernel.

:func:`int8_matmul` launches the kernel for CUDA tensors and takes
:func:`int8_matmul_ref` only for CPU tensors; on any other device it raises.
``int8_matmul.launches`` counts calls that launched.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from dynamo_tpu_torch.ops.kernels import build

__all__ = ["int8_matmul", "int8_matmul_ref", "MatmulPlan", "plan", "ticket_capacity"]


def int8_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 product of ``x`` and the
    int8 codes, times the scale in f32, rounded once to ``out_dtype``
    (``x``'s when None)."""
    y = x.float() @ wq.float()
    return (y * scale.float()).to(out_dtype or x.dtype)


@dataclass(frozen=True)
class MatmulPlan:
    """One launch: ``grid`` = (N tiles, M tiles, splits) blocks of
    ``threads`` with ``smem`` bytes of dynamic shared memory; split z covers
    depth [z * k_steps * bk, (z + 1) * k_steps * bk); output tiles of ``bm``
    rows by ``bn`` channels.  With splits > 1 the kernel takes a scratch of
    ``scratch`` floats, the splits' f32 sums [splits, M, N rounded up to 4],
    and one ticket per output tile."""
    regime: str
    bm: int
    bn: int
    bk: int
    k_steps: int
    splits: int
    grid: tuple[int, int, int]
    threads: int
    smem: int
    scratch: int


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, sms: int) -> MatmulPlan:
    """The launch for x [m, k] @ w [k, n] on a card with ``sms`` SMs.  The
    regime follows M.  While the output tiles leave the card's block slots
    (what fits per SM by shared memory) idle, K is split into as many ranges
    as fill the slots in one wave, and no more."""
    g = build.geometry()
    bk = g["B5_BK"]
    if m <= g["B5_DECODE_MAX_M"]:
        regime, bm, pre = "decode", (8 if m <= 8 else 16), "B5_DC_"
        grid_m = 1
    else:
        regime, bm, pre = "prefill", g["B5_PF_TOKENS"], "B5_PF_"
        grid_m = -(-m // bm)
    bn = g[pre + "CHANNELS"]
    grid_n = -(-n // bn)
    tiles = grid_n * grid_m
    steps = -(-k // bk)
    want = max(1, min(steps, g[pre + "BLOCKS_PER_SM"] * sms // tiles))
    per = -(-steps // want)
    splits = -(-steps // per)
    scratch = splits * m * (-(-n // 4) * 4) if splits > 1 else 0
    return MatmulPlan(regime, bm, bn, bk, per, splits, (grid_n, grid_m, splits), g[pre + "THREADS"],
                      g[pre + "SMEM"], scratch)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ticket_capacity(sms: int) -> int:
    """Output tiles a split launch can have: K is split only while the
    tiles leave block slots idle, and the decode regime has the most."""
    return build.geometry()["B5_DC_BLOCKS_PER_SM"] * sms


_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}


def _stream_tickets(device: torch.device, stream: int) -> torch.Tensor:
    """The zeroed split-K tickets of ``stream``: one per output tile, left
    zeroed by every launch.  Launches on one stream run in order, so they
    never hold a ticket at once; the buffer lives as long as the process,
    so a CUDA graph captured on the stream may keep its address."""
    buf = _tickets.get((device, stream))
    if buf is None:
        buf = torch.zeros(ticket_capacity(_sm_count(device.index or 0)), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = buf
    return buf


def _weight_layout(wq: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(row-major tensor the kernel reads, 1 if it is [N, K] else 0)."""
    if wq.is_contiguous():
        return wq, 0
    if wq.t().is_contiguous():
        return wq.t(), 1
    raise ValueError("wq must be a row-major [K, N] tensor or the transpose of a row-major [N, K] one")


def _check(x, wq, scale, out_dtype) -> None:
    for name, t in (("wq", wq), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype != torch.bfloat16 or wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"x bf16, wq int8, scale f32 expected; got {x.dtype}, {wq.dtype}, {scale.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0] or scale.shape != (wq.shape[1],):
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, scale {tuple(scale.shape)}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("x and scale must be contiguous")


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``(x @ wq) * scale``: x [M, K] bf16, wq [K, N] int8, scale [N] f32.
    Returns [M, N] in ``out_dtype`` (``x``'s when None)."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, wq, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")
    out_dtype = out_dtype or x.dtype
    _check(x, wq, scale, out_dtype)
    w, nk = _weight_layout(wq)
    m, k = x.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    p = plan(m, n, k, _sm_count(x.device.index or 0))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partials = tickets = None
    if p.splits > 1:  # the splits' sums, per call from the caching allocator (stream-ordered)
        partials = torch.empty(p.scratch, dtype=torch.float32, device=x.device).data_ptr()
        tickets = _stream_tickets(x.device, stream).data_ptr()
    rc = build.library().dynamo_int8_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), partials, tickets,
        m, n, k, nk, int(out_dtype == torch.float32), p.grid[0], p.grid[1], p.splits, p.k_steps, stream,
    )
    build.check(rc, "dynamo_int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
