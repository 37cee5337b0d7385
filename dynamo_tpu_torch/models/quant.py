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
* :func:`grouped_matmul` takes a mixture-of-experts stack, bf16 ``[E, K,
  N]`` or a QTensor with one scale per (expert, output channel), ``[E, 1,
  N]``, to the grouped expert kernel (``ops/kernels/grouped_matmul.py``),
  which reads int8 experts as int8 and, like the W8A16 kernel, scales the
  f32 accumulator; on CPU tensors an int8 stack is dequantised to the
  activation dtype before the product, as the JAX package does.  The MoE
  router stays dense, as in the JAX package: it is small, and its logits
  choose the experts.
* :func:`prune_specs`, :func:`align_specs` and :func:`shard_state` split a
  state dict over the rank mesh (``utils/mesh.py``): a spec names, per
  axis of a tensor, the mesh axis it is split over (or None).  An axis the
  mesh does not divide is replicated; an int8 weight's scale takes its
  weight's split on the axes where it has more than one entry, so a
  column-split weight's scales are split with its codes and a row-split
  weight keeps its per-output-channel scales whole.
"""

from __future__ import annotations

import dataclasses

import torch

from dynamo_tpu_torch.ops.kernels import grouped_matmul as gmm
from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul

__all__ = ["QTensor", "stacked_channel_axes", "quantize", "dequantize", "matmul", "grouped_matmul",
           "take_rows", "quantize_params", "random_qtensor", "CHANNEL_AXES", "prune_specs",
           "align_specs", "shard_state", "shard_bounds", "shard_cutter"]

SCALE = "_scale"  # state-dict suffix of a quantised weight's scale


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


def grouped_matmul(x: torch.Tensor, w, offsets: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` sorted by expert times their expert of the stack ``w``
    (``[E, K, N]``, dense or a QTensor with scale ``[E, 1, N]``);
    ``offsets`` [E + 1] int32 bounds each expert's rows."""
    if isinstance(w, QTensor):
        if x.device.type == "cpu":  # the JAX package's order: dequantise, then the product
            return gmm.grouped_matmul(x, dequantize(w, x.dtype), offsets)
        return gmm.grouped_matmul_q8(x, w.q, w.scale, offsets)
    return gmm.grouped_matmul(x, w, offsets)


def take_rows(w, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Row lookup (the embedding): ``w[idx]`` in ``dtype``; a QTensor's
    scale must be per row (``[V, 1]``)."""
    idx = idx.long()
    if isinstance(w, QTensor):
        return w.q[idx].to(dtype) * w.scale[:, 0][idx][..., None].to(dtype)
    return w[idx]


# quantised parameter names (the JAX tree's leaf names) and their channel
# axes (an MoE stack [L, E, K, N] also keeps its layer and expert axes);
# norms, biases and the MoE router stay dense
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


# ------------------------------------------------------------- sharding
def _shape_of(x) -> tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def prune_specs(state, specs: dict, mesh) -> dict:
    """Drop the mesh axes that do not divide the dimension they split:
    replicating that dimension is always correct (each rank keeps it
    whole), so any model runs on any mesh, merely without that split.
    ``state`` maps names to tensors or shapes; a name without a spec is
    replicated.  Run before :func:`align_specs`."""
    out = {}
    for name, x in state.items():
        if name.endswith(SCALE) and name[:-len(SCALE)] in state:
            continue
        shape = _shape_of(x)
        spec = tuple(specs.get(name, ())) + (None,) * len(shape)
        out[name] = tuple(e if e is not None and shape[i] % mesh.axis_size(e) == 0 else None
                          for i, e in enumerate(spec[:len(shape)]))
    return out


def align_specs(state, specs: dict) -> dict:
    """Give each int8 weight's ``<name>_scale`` its weight's spec on the axes
    where the scale has more than one entry (the reduced axes replicate)."""
    out = dict(specs)
    for name, x in state.items():
        base = name[:-len(SCALE)]
        if name.endswith(SCALE) and base in specs:
            shape = _shape_of(x)
            out[name] = tuple(e if shape[i] != 1 else None for i, e in enumerate(specs[base]))
    return out


def shard_bounds(shape, spec, mesh, block=None) -> tuple[slice, ...]:
    """This rank's slice of a tensor of ``shape`` split by ``spec``: an even
    split of each axis named there by this rank's index on the mesh axis.
    ``block`` = (axis, start, stop) overrides one axis with an explicit
    range (the kv heads a rank's query heads read, ``models/llama.py``)."""
    out = []
    for i, n in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        if block is not None and block[0] % len(shape) == i:
            out.append(slice(block[1], block[2]))
        elif e is None:
            out.append(slice(None))
        else:
            k = mesh.axis_size(e)
            j = mesh.axis_index(e)
            out.append(slice(j * n // k, (j + 1) * n // k))
    return tuple(out)


def shard_cutter(shapes: dict, specs: dict, mesh, blocks: dict | None = None):
    """``cut(name, x, index=())`` for parameters of full ``shapes``: this
    rank's slice of ``x``, the slot ``index`` (leading indices) of parameter
    ``name``, or, when ``x`` is the full shape (a tuple), this rank's shape.
    ``blocks`` maps names to explicit ``(axis, start, stop)`` ranges for
    this rank; an int8 weight's scale follows its weight's block on an axis
    where the scale has more than one entry."""
    blocks = blocks or {}

    def cut(name: str, x, index: tuple = ()):
        shape = shapes[name]
        block = blocks.get(name[:-len(SCALE)] if name.endswith(SCALE) else name)
        if block is not None and shape[block[0]] == 1:
            block = None  # a reduced scale axis: whole
        bounds = shard_bounds(shape, specs.get(name, ()), mesh, block)
        if isinstance(x, tuple):
            return tuple(len(range(*b.indices(n))) for b, n in zip(bounds, shape))
        return x[bounds[len(index):]]

    return cut


def shard_state(state: dict, specs: dict, mesh, blocks: dict | None = None,
                device=None) -> dict:
    """One rank's slice of a state dict (:func:`shard_cutter`), each tensor
    moved to ``device`` (its own when None), contiguous."""
    cut = shard_cutter({k: tuple(t.shape) for k, t in state.items()}, specs, mesh, blocks)
    return {name: cut(name, t).to(device or t.device).contiguous() for name, t in state.items()}
