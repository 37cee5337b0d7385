"""Native checkpoint format: pre-converted, pre-quantised weights on disk.

The counterpart of ``dynamo_tpu/models/checkpoint.py``.  Serving from an
HF checkpoint pays the load and the int8 quantisation at every engine
start; saving the converted state once makes startup one read of the
tensors as they are served.  ``quantize`` (cli.py) writes one;
``--model-path DIR`` serves one (detected by the ``dynamo_tpu.json``
manifest).

Layout: ``DIR/dynamo_tpu.json``, with the JAX package's manifest fields
(``format``, ``quantized``, ``config``: the ModelConfig fields), and
``DIR/params.safetensors``, the port's state dict (``models/llama.py``
names; an int8 weight is ``<name>`` int8 beside ``<name>_scale`` f32, as
``models/convert.params_from_jax`` names a QTensor's halves).  The JAX
package stores its params as an orbax tree under ``DIR/params/``, which
needs JAX to read or write: the two packages share the manifest but not
the tensors, and a directory holding an orbax tree is refused by name.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import param_dtypes, param_shapes, shard_plan
from dynamo_tpu_torch.models.quant import shard_state

__all__ = ["save_checkpoint", "load_checkpoint", "is_native_checkpoint", "MANIFEST", "PARAMS"]

MANIFEST = "dynamo_tpu.json"
PARAMS = "params.safetensors"


def is_native_checkpoint(path: str | Path) -> bool:
    return (Path(path) / MANIFEST).is_file()


def save_checkpoint(path: str | Path, cfg: ModelConfig, state: dict[str, torch.Tensor],
                    quantized: bool) -> None:
    """Write the manifest and the state under ``path`` (created or
    overwritten)."""
    from safetensors.torch import save_file

    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    # the manifest is the commit marker: removed FIRST (re-converting into
    # an existing checkpoint dir must not leave the old manifest validating
    # half-rewritten params) and written LAST, so an interrupted conversion
    # never leaves a dir that passes is_native_checkpoint
    (path / MANIFEST).unlink(missing_ok=True)
    save_file({k: v.contiguous() for k, v in state.items()}, str(path / PARAMS))
    manifest = {
        "format": 1,
        "quantized": quantized,
        "config": dataclasses.asdict(cfg),
    }
    (path / MANIFEST).write_text(json.dumps(manifest, indent=2))


def load_checkpoint(path: str | Path, dtype: Optional[str] = None, device=None, mesh=None
                    ) -> tuple[ModelConfig, dict[str, torch.Tensor], bool]:
    """(ModelConfig, state dict on ``device``, quantized).  ``dtype``
    overrides the saved dtype of the dense parameters (int8 weights and
    their scales stay as stored); None keeps the saved one.  On a ``mesh``
    each tensor is read onto the host and only this rank's slice moves to
    ``device``."""
    from safetensors import safe_open

    path = Path(path).absolute()
    manifest = json.loads((path / MANIFEST).read_text())
    if manifest.get("format") != 1:
        raise ValueError(f"unknown checkpoint format {manifest.get('format')}")
    if not (path / PARAMS).is_file():
        if (path / "params").is_dir():
            raise ValueError(
                f"{path}: params/ is an orbax tree (the JAX package's native checkpoint), "
                f"which the port cannot read without JAX; write the port's own with "
                f"`quantize` from the HF directory or GGUF file")
        raise FileNotFoundError(f"{path}: no {PARAMS}")
    cfg_kw = manifest["config"]
    if dtype:
        cfg_kw = {**cfg_kw, "dtype": dtype}
    cfg = ModelConfig(**cfg_kw)
    quantized = bool(manifest.get("quantized"))
    shapes, dtypes = param_shapes(cfg, quantized), param_dtypes(cfg, quantized)
    dev = resolve_device(device)
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        specs, blocks = shard_plan(cfg, quantized, mesh)
    state = {}
    with safe_open(str(path / PARAMS), framework="pt", device="cpu" if sharded else str(dev)) as f:
        names = set(f.keys())
        if names != set(shapes):
            raise ValueError(f"{path / PARAMS}: tensors {sorted(names ^ set(shapes))} do not "
                             f"match the {'int8' if quantized else 'dense'} model's names")
        for name, shape in shapes.items():
            t = f.get_tensor(name)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
            state[name] = t.to(dtypes[name])
            if sharded:  # one tensor on the host at a time
                state[name] = shard_state({name: state[name]}, specs, mesh, blocks,
                                          device=dev)[name]
    return cfg, state, quantized
