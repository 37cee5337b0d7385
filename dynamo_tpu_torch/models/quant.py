"""Int8 weight-only quantisation: int8 weights with per-output-channel scales.

The counterpart of ``dynamo_tpu/models/quant.py``.  Decode streams every
weight byte once per step, so int8 weights halve both the step's weight
traffic and the model's footprint (Llama-3-8B: about 16 GB in bf16, 8 GB in
int8).

* :class:`QTensor` pairs an int8 tensor ``q`` with an f32 ``scale`` of the
  same rank whose reduced axes have size 1 (``[L, 1, N]`` for a stacked
  ``[L, K, N]`` projection, ``[V, 1]`` for the per-row ``embed``), the JAX
  package's shapes, so a quantised JAX tree carries over as it is.
* :func:`matmul` of a CUDA tensor with a 2-D QTensor always launches the
  hand-written W8A16 kernel (``ops/kernels/int8_matmul.py``): the int8
  tile is converted to bf16 inside the kernel, so the weight crosses device
  memory as int8.  Eager PyTorch has no compiler to fuse the convert into
  the product's operand load, and ``x @ q.to(bf16)`` would write and re-read
  a bf16 copy of every weight on every call.  There is no switch.  The
  kernel accumulates in f32 and applies the scale in f32 before its one
  rounding to the output dtype.
* On CPU tensors :func:`matmul` is the plain version, which rounds where
  the JAX package's XLA path does: ``x @ q.to(x.dtype)`` in ``x``'s dtype
  (f32 with ``out_dtype=torch.float32``), then the scale multiplies in the
  product's dtype.  :func:`take_rows` likewise converts the rows to the
  model dtype and multiplies by the scale in that dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul

__all__ = ["QTensor", "stacked_channel_axes", "quantize", "dequantize", "matmul", "take_rows",
           "quantize_params", "random_qtensor", "CHANNEL_AXES"]


def stacked_channel_axes(ndim: int, channel_axes=(-1,)) -> tuple[int, ...]:
    """Channel axes of a possibly layer-stacked matmul weight: every axis
    before the final [in, out] pair gets its own scales."""
    if ndim >= 3:
        return tuple(range(ndim - 2)) + tuple(channel_axes)
    return tuple(channel_axes)


@dataclasses.dataclass
class QTensor:
    """Symmetric int8 weight and its broadcastable f32 per-channel scale."""

    q: torch.Tensor      # int8, the weight's shape
    scale: torch.Tensor  # f32, the same rank, reduced axes of size 1

    def __getitem__(self, i) -> "QTensor":
        """Index the leading (layer) axis of both tensors."""
        return QTensor(self.q[i], self.scale[i])

    def t(self) -> "QTensor":
        """The transpose of a 2-D weight: per-row scales become per-column
        (a view; nothing is copied)."""
        return QTensor(self.q.t(), self.scale.t())


def quantize(w: torch.Tensor, channel_axes=(-1,)) -> QTensor:
    """``w`` as int8 with one scale per channel along ``channel_axes``
    (amax over every other axis), in the JAX package's arithmetic."""
    axes = {a % w.ndim for a in channel_axes}
    reduce = tuple(a for a in range(w.ndim) if a not in axes)
    wf = w.float()
    amax = wf.abs().amax(dim=reduce, keepdim=True) if reduce else wf.abs()
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(q, scale)


def dequantize(w, dtype: torch.dtype = torch.bfloat16):
    if isinstance(w, QTensor):
        return (w.q.float() * w.scale).to(dtype)
    return w


def matmul(x: torch.Tensor, w, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` for a dense tensor or a QTensor.  For a QTensor,
    ``out_dtype`` (f32 for logits) is the result's dtype, ``x``'s when None.

    The scale is per output channel, constant along the contracted axis, so
    it applies to the product's output."""
    if not isinstance(w, QTensor):
        return x @ w
    if w.q.ndim != 2:
        raise ValueError(f"matmul takes a 2-D QTensor, got {tuple(w.q.shape)}")
    s = w.scale.squeeze(-2)  # [N]: the contracted axis has size 1
    if x.device.type != "cpu":
        lead = x.shape[:-1]
        y = int8_matmul(x.reshape(-1, x.shape[-1]), w.q, s, out_dtype=out_dtype)
        return y.reshape(*lead, w.q.shape[1])
    dt = out_dtype or x.dtype
    y = x.to(dt) @ w.q.to(dt)
    return y * s.to(dt)


def take_rows(w, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Row lookup (the embedding): ``w[idx]`` in ``dtype``; a QTensor's
    scale must be per row (``[V, 1]``)."""
    idx = idx.long()
    if isinstance(w, QTensor):
        return w.q[idx].to(dtype) * w.scale[:, 0][idx][..., None].to(dtype)
    return w[idx]


# quantised parameter names (the JAX tree's leaf names) and their channel
# axes; norms and biases stay dense
CHANNEL_AXES = {
    "wq": (-1,), "wk": (-1,), "wv": (-1,), "wo": (-1,),
    "w_gate": (-1,), "w_up": (-1,), "w_down": (-1,),
    "lm_head": (-1,),
    # per row, so one tensor serves the lookup and the tied lm_head
    "embed": (0,),
}


def quantize_params(params: dict) -> dict:
    """A params dict nested as the JAX tree, with every matmul weight as a
    QTensor and everything else as it was."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = quantize_params(v)
        elif k in CHANNEL_AXES:
            axes = CHANNEL_AXES[k]
            out[k] = quantize(v, axes if k == "embed" else stacked_channel_axes(v.ndim, axes))
        else:
            out[k] = v
    return out


def random_qtensor(shape, fan_in: int, generator: torch.Generator, channel_axes=(-1,),
                   device=None) -> QTensor:
    """A random int8 weight drawn directly (the bf16 tensor is never made):
    uniform codes in [-127, 127] with the scale that gives the dense init's
    N(0, 1/fan_in) standard deviation (the codes' is about 73.3)."""
    q = torch.randint(-127, 128, tuple(shape), generator=generator, device=device,
                      dtype=torch.int8)
    axes = {a % len(shape) for a in channel_axes}
    sshape = tuple(n if i in axes else 1 for i, n in enumerate(shape))
    scale = torch.full(sshape, 1.0 / (73.3 * fan_in ** 0.5), dtype=torch.float32, device=device)
    return QTensor(q, scale)
