"""Parameters for :class:`LlamaModel` and :class:`DeepseekModel`: carried
over from the JAX package, or drawn at random.

The state dict uses the JAX params tree's names and layouts, flattened:
``embed``, ``final_norm``, ``lm_head`` and ``layers.<name>`` for each
per-layer tensor stacked on a leading L axis (``models/llama.py::
param_shapes``); an int8 weight is ``<name>`` (int8 codes) and
``<name>_scale`` (f32).  :meth:`LlamaModel.from_state` builds a model on
them.  A DeepSeek state dict flattens that package's tree the same way, with
``dense_layers.<name>`` and ``moe_layers.<name>`` for its two layer groups
(``models/deepseek.py::param_shapes``); :meth:`DeepseekModel.from_state`
builds the model.

Each function takes a ``mesh`` (``utils/mesh.py``) and then returns this
rank's slice only (``models/llama.py::shard_plan``,
``models/deepseek.py::partition_specs``): the full tensor is cut on the host
(or, for a random draw, right after the draw) and only the slice is kept on
``device``.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.deepseek import GROUPS, DeepseekConfig
from dynamo_tpu_torch.models.deepseek import param_shapes as deepseek_param_shapes
from dynamo_tpu_torch.models.llama import SCALE, param_dtypes, param_shapes, shard_plan
from dynamo_tpu_torch.models.quant import (prune_specs, random_qtensor, shard_cutter, shard_state,
                                           stacked_channel_axes)

__all__ = ["params_from_jax", "init_params", "deepseek_params_from_jax", "deepseek_init_params",
           "shard_full_state"]


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def shard_full_state(family: str, cfg, state: dict, mesh, device) -> dict[str, torch.Tensor]:
    """This rank's slice of a full state dict, on ``device`` (the whole
    state, moved, off a mesh)."""
    if not _sharded(mesh):
        return {k: v.to(device) for k, v in state.items()}
    if family == "deepseek":
        from dynamo_tpu_torch.models.deepseek import partition_specs

        return shard_state(state, prune_specs(state, partition_specs(cfg), mesh), mesh,
                           device=device)
    specs, blocks = shard_plan(cfg, "embed" + SCALE in state, mesh)
    return shard_state(state, specs, mesh, blocks, device=device)


def _to_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind not in "fiub":  # bfloat16 and other extension dtypes
        a = a.astype(np.float32)
    # a copy: arrays exported from JAX are read-only
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def _checked_state(flat: Mapping, shapes: dict, dtypes: dict, device) -> dict[str, torch.Tensor]:
    """``flat`` (name -> array) as tensors on ``device``, each in its
    ``dtypes`` entry, its names and shapes held to ``shapes``."""
    if set(flat) != set(shapes):
        raise ValueError(
            f"params tree names {sorted(flat)} do not match the model's {sorted(shapes)}")
    state = {}
    for name, shape in shapes.items():
        t = _to_tensor(flat[name], dtypes[name], device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        state[name] = t
    return state


def params_from_jax(tree: Mapping, config: ModelConfig, device=None,
                    dtype: torch.dtype | None = None, mesh=None) -> dict[str, torch.Tensor]:
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
    dtypes = {name: dt if d == config.torch_dtype else d
              for name, d in param_dtypes(config, quantized).items()}
    if not _sharded(mesh):
        return _checked_state(flat, param_shapes(config, quantized), dtypes, dev)
    full = _checked_state(flat, param_shapes(config, quantized), dtypes, torch.device("cpu"))
    return shard_full_state("llama", config, full, mesh, dev)


def init_params(config: ModelConfig, generator: torch.Generator,
                device=None, quantized: bool = False, mesh=None) -> dict[str, torch.Tensor]:
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
    made.

    On a ``mesh`` each layer's tensor is drawn whole and cut to this rank's
    slice at once (an int8 weight with its whole scales, then cut), so the
    ranks hold slices of the model one rank would draw."""
    dev = resolve_device(device)
    dt = config.torch_dtype
    norm_fill = 0.0 if config.rmsnorm_unit_offset else 1.0
    state = {}
    shapes = param_shapes(config, quantized)
    if _sharded(mesh):
        specs, blocks = shard_plan(config, quantized, mesh)
        return _init_cut(config, generator, dev, quantized, shapes,
                         shard_cutter(shapes, specs, mesh, blocks))
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


def _init_cut(config: ModelConfig, generator, dev, quantized: bool, shapes: dict, cut):
    """:func:`init_params` on a mesh: the same draws in the same order, each
    cut to this rank's slice as it is made."""
    dt = config.torch_dtype
    norm_fill = 0.0 if config.rmsnorm_unit_offset else 1.0
    state = {}
    for name, shape in shapes.items():
        base = name.split(".", 1)[-1]
        if name.endswith(SCALE):
            continue
        fan_in = shape[-1] if base == "embed" else shape[-2] if len(shape) > 1 else 0
        stacked = name.startswith("layers.")
        if name + SCALE in shapes:
            axes = (0,) if base == "embed" else stacked_channel_axes(len(shape))
            q = torch.empty(cut(name, shape), dtype=torch.int8, device=dev)
            sc = torch.empty(cut(name + SCALE, shapes[name + SCALE]), dtype=torch.float32,
                             device=dev)
            # one random_qtensor of the whole weight, as init_params draws it
            w = random_qtensor(shape, fan_in, generator, axes, device=dev)
            q.copy_(cut(name, w.q))
            sc.copy_(cut(name + SCALE, w.scale))
            state[name], state[name + SCALE] = q, sc
            continue
        if base.endswith("norm"):
            fill = 1.0 if base in ("q_norm", "k_norm") else norm_fill
            state[name] = torch.full(cut(name, shape), fill, dtype=dt, device=dev)
            continue
        if base in ("bq", "bk", "bv"):
            state[name] = torch.zeros(cut(name, shape), dtype=dt, device=dev)
            continue
        out = torch.empty(cut(name, shape), dtype=dt, device=dev)
        parts = range(shape[0]) if stacked else [None]
        for j in parts:
            part_shape = shape[1:] if stacked else shape
            draw = torch.randn(part_shape, generator=generator, device=dev, dtype=torch.float32)
            draw = draw.div_(math.sqrt(fan_in)).to(dt)
            if stacked:
                out[j].copy_(cut(name, draw, (j,)))
            else:
                out.copy_(cut(name, draw))
        state[name] = out
    return state


def deepseek_params_from_jax(tree: Mapping, config: DeepseekConfig, device=None,
                             dtype: torch.dtype | None = None, mesh=None) -> dict[str, torch.Tensor]:
    """The JAX package's DeepSeek params tree (``{"embed", "dense_layers":
    {...}, "moe_layers": {...}, "final_norm", "lm_head"}``, leaves as numpy
    arrays) as :class:`DeepseekModel`'s state dict, on ``device`` (cuda
    unless named) in ``dtype`` (the config's unless named)."""
    flat = {k: v for k, v in tree.items() if k not in GROUPS}
    for g in GROUPS:
        flat.update({f"{g}.{k}": v for k, v in tree[g].items()})
    shapes = deepseek_param_shapes(config)
    dtypes = dict.fromkeys(shapes, dtype or config.torch_dtype)
    if not _sharded(mesh):
        return _checked_state(flat, shapes, dtypes, resolve_device(device))
    full = _checked_state(flat, shapes, dtypes, torch.device("cpu"))
    return shard_full_state("deepseek", config, full, mesh, resolve_device(device))


def deepseek_init_params(config: DeepseekConfig, generator: torch.Generator,
                         device=None, mesh=None) -> dict[str, torch.Tensor]:
    """Random parameters at full width, made directly on ``device``: the
    JAX package's DeepSeek init (``normal / sqrt(fan_in)`` matrices, the
    router included, and unit norm scales) drawn from ``generator``, which
    must live on ``device``.  Stacked tensors are drawn one layer at a time,
    so the f32 draw never holds more than one layer's matrix (an MoE layer's
    expert stack at DeepSeek-V2-Lite width: 738 MB).  On a ``mesh`` each
    layer's draw is cut to this rank's slice at once."""
    from dynamo_tpu_torch.models.loader import deepseek_slicer

    dev = resolve_device(device)
    dt = config.torch_dtype
    cut = deepseek_slicer(config, mesh)
    state = {}
    for name, shape in deepseek_param_shapes(config).items():
        if name.endswith("norm"):
            state[name] = torch.ones(cut(name, shape), dtype=dt, device=dev)
            continue
        # the contracted axis: the row axis of x @ W; the embedding's width
        fan_in = shape[-1] if name == "embed" else shape[-2]
        out = torch.empty(cut(name, shape), dtype=dt, device=dev)
        stacked = "." in name
        for j in (range(shape[0]) if stacked else [None]):
            draw = torch.randn(shape[1:] if stacked else shape, generator=generator, device=dev,
                               dtype=torch.float32).div_(math.sqrt(fan_in))
            if stacked:
                out[j].copy_(cut(name, draw, (j,)))
            else:
                out.copy_(cut(name, draw))
        state[name] = out
    return state
