"""W8A16 matrix product: the CUDA kernel, its wrapper and its plain version.

The kernel (``csrc/int8_matmul.cu``) replaces the TPU kernel
``dynamo_tpu/ops/pallas/int8_matmul.py::int8_matmul``: ``(x @ wq) * scale``
for x ``[M, K]`` bf16, an int8 weight ``[K, N]`` and one f32 scale per
output channel ``[N]``, with the int8 -> bf16 convert inside the kernel, f32
accumulation and the scale applied in f32 before the one rounding to the
output dtype (bf16, or f32 for logits).  The weight may be a row-major
``[K, N]`` tensor or the transpose view of a row-major ``[N, K]`` one (the
tied embedding as the lm_head), which the kernel reads as it lies.

:func:`int8_matmul` launches the kernel for CUDA tensors and takes
:func:`int8_matmul_ref` only for CPU tensors; on any other device it raises.
``int8_matmul.launches`` counts calls that launched.
"""

from __future__ import annotations

import functools

import torch

from dynamo_tpu_torch.ops.kernels import build

__all__ = ["int8_matmul", "int8_matmul_ref", "BN", "BK", "MAX_SPLITS"]

BN, BK = 64, 64   # the kernel's output columns per block and depth per step
MAX_SPLITS = 16   # most blocks one output tile's K range is split over


def int8_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 product of ``x`` and the
    int8 codes, times the scale in f32, rounded once to ``out_dtype``
    (``x``'s when None)."""
    y = x.float() @ wq.float()
    return (y * scale.float()).to(out_dtype or x.dtype)


def _block_m(m: int) -> int:
    return 16 if m <= 16 else 32 if m <= 32 else 64


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(64-deep K steps per split, splits): split K only as far as needed
    to put about two blocks on every SM."""
    tiles = -(-m // _block_m(m)) * -(-n // BN)
    k_steps = -(-k // BK)
    want = max(1, min(MAX_SPLITS, k_steps, -(-2 * sms // tiles)))
    per = -(-k_steps // want)
    return per, -(-k_steps // per)


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
    per, splits = split_plan(m, n, k, _sm_count(x.device.index or 0))
    # f32 partial sums of the K ranges; dropped when this returns, reused by
    # the allocator only for work queued after the kernels on this stream
    partial = (torch.empty(splits * m * n, dtype=torch.float32, device=x.device)
               if splits > 1 else out)
    rc = build.library().dynamo_int8_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), partial.data_ptr(),
        m, n, k, nk, int(out_dtype == torch.float32), per, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "dynamo_int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
