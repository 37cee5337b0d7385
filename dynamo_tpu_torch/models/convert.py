"""Parameters for :class:`LlamaModel`: carried over from the JAX package, or
drawn at random.

The state dict uses the JAX params tree's names and layouts, flattened:
``embed``, ``final_norm``, ``lm_head`` and ``layers.<name>`` for each
per-layer tensor stacked on a leading L axis (``models/llama.py::
param_shapes``); an int8 weight is ``<name>`` (int8 codes) and
``<name>_scale`` (f32).  :meth:`LlamaModel.from_state` builds a model on
them.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import SCALE, param_dtypes, param_shapes
from dynamo_tpu_torch.models.quant import random_qtensor, stacked_channel_axes

__all__ = ["params_from_jax", "init_params"]


def _to_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind not in "fiub":  # bfloat16 and other extension dtypes
        a = a.astype(np.float32)
    # a copy: arrays exported from JAX are read-only
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def params_from_jax(tree: Mapping, config: ModelConfig, device=None,
                    dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """The JAX package's params tree (``{"embed", "layers": {...},
    "final_norm", "lm_head"?}``, leaves as numpy arrays) as this package's
    state dict, on ``device`` (cuda unless named) in ``dtype`` (the
    config's unless named).  A quantised tree (``quantize_params``) has
    QTensor leaves, objects with ``q`` and ``scale`` arrays: they carry over
    exactly, as int8 ``<name>`` and f32 ``<name>_scale``."""
    dev = resolve_device(device)
    dt = dtype or config.torch_dtype
    flat = {k: v for k, v in tree.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in tree["layers"].items()})
    quantized = any(hasattr(v, "q") and hasattr(v, "scale") for v in flat.values())
    for name, v in list(flat.items()):
        if hasattr(v, "q") and hasattr(v, "scale"):
            flat[name], flat[name + SCALE] = v.q, v.scale
    shapes = param_shapes(config, quantized)
    if set(flat) != set(shapes):
        raise ValueError(
            f"params tree names {sorted(flat)} do not match the model's {sorted(shapes)}")
    dtypes = param_dtypes(config, quantized)
    state = {}
    for name, shape in shapes.items():
        t = _to_tensor(flat[name], dt if dtypes[name] == config.torch_dtype else dtypes[name], dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        state[name] = t
    return state


def init_params(config: ModelConfig, generator: torch.Generator,
                device=None, quantized: bool = False) -> dict[str, torch.Tensor]:
    """Random parameters at full width, made directly on ``device``: the
    JAX package's init (``normal / sqrt(fan_in)`` matrices, unit norm
    scales — zero for Gemma's ``1 + w`` norms — and zero biases), drawn
    from ``generator``, which must live on ``device``.  Stacked tensors are
    drawn one layer at a time so the f32 draw never holds more than one
    layer's matrix (an MoE layer's expert stack: 805 MB at Qwen3-30B-A3B).
    An MoE router is drawn dense, quantised or not, as in the JAX init.

    ``quantized`` draws every matmul weight as int8 codes directly, with
    the scale that gives the dense init's standard deviation, as the JAX
    package's ``init_params(quantized=True)`` does (an expert stack has a
    scale per layer, expert and output channel): the bf16 model is never
    made."""
    dev = resolve_device(device)
    dt = config.torch_dtype
    norm_fill = 0.0 if config.rmsnorm_unit_offset else 1.0
    state = {}
    shapes = param_shapes(config, quantized)
    for name, shape in shapes.items():
        base = name.split(".", 1)[-1]
        if name.endswith(SCALE):
            continue  # drawn with its weight
        # matrices: fan-in is the contracted axis (the row axis of x @ W;
        # the embedding's is its width, as the JAX init has it)
        fan_in = shape[-1] if base == "embed" else shape[-2] if len(shape) > 1 else 0
        if name + SCALE in shapes:
            axes = (0,) if base == "embed" else stacked_channel_axes(len(shape))
            w = random_qtensor(shape, fan_in, generator, axes, device=dev)
            state[name], state[name + SCALE] = w.q, w.scale
            continue
        if base.endswith("norm"):
            fill = 1.0 if base in ("q_norm", "k_norm") else norm_fill
            state[name] = torch.full(shape, fill, dtype=dt, device=dev)
            continue
        if base in ("bq", "bk", "bv"):
            state[name] = torch.zeros(shape, dtype=dt, device=dev)
            continue
        out = torch.empty(shape, dtype=dt, device=dev)
        parts = out if name.startswith("layers.") else out[None]
        for part in parts:
            draw = torch.randn(part.shape, generator=generator, device=dev,
                               dtype=torch.float32)
            part.copy_(draw.div_(math.sqrt(fan_in)))
        state[name] = out
    return state
