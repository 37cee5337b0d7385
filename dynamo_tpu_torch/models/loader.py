"""HuggingFace checkpoint directory → the port's state dict.

The counterpart of ``dynamo_tpu/models/loader.py``: HF Llama-family weight
names map onto the layout of ``models/llama.py::param_shapes`` (matrices
transposed to ``[in, out]`` and stacked on a leading L axis), so
``LlamaModel.from_state`` serves the result.  The directory's
``*.safetensors`` files are read lazily with ``framework="pt"`` onto the
target device, one tensor at a time (bf16 never passes through float32 and
the checkpoint is never whole in host memory), from one file or from shards
listed in ``model.safetensors.index.json``.  Phi-3's fused ``qkv_proj`` and
``gate_up_proj`` are split, tied embeddings leave out ``lm_head``, and with
``quantize`` each matmul weight is quantised to int8 layer by layer as it is
read (``models/quant.py``, the arithmetic of the JAX package's
``quantize_params`` on the loaded tree), so the dense model is never made.
Mixture-of-experts checkpoints load under both HF namings, Qwen3-MoE's
``mlp.gate`` / ``mlp.experts.{e}.{gate,up,down}_proj`` and Mixtral's
``block_sparse_moe.gate`` / ``experts.{e}.w1,w3,w2``: each expert's
``[F, Dm]`` tensor goes, transposed, into its slot of the stacked ``[L, E,
Dm, F]`` (quantised as it arrives: an expert's scales depend on its own
tensor only).  DeepSeek-V2 directories load through
:func:`load_deepseek_dir` into ``models/deepseek.py``'s layout (the CLI picks
it by :func:`is_deepseek_dir`, as the JAX package's does); given to
:func:`load_model_dir` they raise.

Every loader takes a ``mesh`` (``utils/mesh.py``): each tensor is then read
onto the host, cut to this rank's slice (``models/llama.py::shard_plan``,
after int8 quantisation, so a row-split weight keeps its whole
per-output-channel scales) and only the slice moves to the card.
:func:`model_from_spec` builds a rank's model from a description every rank
of a mesh can follow: a checkpoint path, a seeded random init, or a state
file.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.deepseek import DeepseekConfig
from dynamo_tpu_torch.models.deepseek import param_shapes as deepseek_param_shapes
from dynamo_tpu_torch.models.llama import SCALE, param_shapes, shard_plan
from dynamo_tpu_torch.models.quant import (CHANNEL_AXES, prune_specs, quantize, shard_cutter,
                                           stacked_channel_axes)

__all__ = ["SafetensorsDir", "load_state_from_dir", "load_state", "quantize_state",
           "load_model_dir", "is_deepseek_dir", "load_deepseek_dir", "model_from_spec"]


def _read_device(device: torch.device, mesh) -> torch.device:
    """Where a loader reads tensors: onto the card, or, on a mesh, onto the
    host, so that only a rank's slice reaches the card."""
    return torch.device("cpu") if mesh is not None and mesh.size > 1 else device


class SafetensorsDir:
    """The tensors of every ``*.safetensors`` file in a directory, by name,
    each read on demand onto ``device``."""

    def __init__(self, model_dir: str | Path, device: torch.device):
        from safetensors import safe_open

        self._open = safe_open
        self._device = str(device)
        d = Path(model_dir)
        self.files: dict[str, Path] = {}
        index = d / "model.safetensors.index.json"
        if index.exists():
            for name, fname in json.loads(index.read_text())["weight_map"].items():
                self.files[name] = d / fname
        else:
            for f in sorted(d.glob("*.safetensors")):
                with safe_open(f, framework="pt") as sf:
                    for name in sf.keys():
                        self.files[name] = f
        if not self.files:
            raise FileNotFoundError(f"no safetensors files in {d}")

    def __contains__(self, name: str) -> bool:
        return name in self.files

    def get(self, name: str) -> torch.Tensor:
        with self._open(self.files[name], framework="pt", device=self._device) as sf:
            return sf.get_tensor(name)


def _hf_names(cfg: ModelConfig, qwen3_moe: bool = False) -> dict[str, tuple[str, bool]]:
    """Port parameter name -> (HF name, with ``{i}`` for the layer and
    ``{e}`` for an expert; whether the HF matrix is transposed), for every
    parameter but the fused ones.  ``qwen3_moe`` picks Qwen3-MoE's expert
    names over Mixtral's."""
    lay = "model.layers.{i}."
    names = {
        "embed": ("model.embed_tokens.weight", False),
        "final_norm": ("model.norm.weight", False),
        "lm_head": ("lm_head.weight", True),
        "layers.attn_norm": (lay + "input_layernorm.weight", False),
        "layers.wq": (lay + "self_attn.q_proj.weight", True),
        "layers.wk": (lay + "self_attn.k_proj.weight", True),
        "layers.wv": (lay + "self_attn.v_proj.weight", True),
        "layers.wo": (lay + "self_attn.o_proj.weight", True),
        # Gemma2 renames the pre-MLP norm and adds sandwich norms; in the
        # Llama family post_attention_layernorm IS the pre-MLP norm
        "layers.mlp_norm": (lay + ("pre_feedforward_layernorm.weight" if cfg.post_norms
                                   else "post_attention_layernorm.weight"), False),
        "layers.post_attn_norm": (lay + "post_attention_layernorm.weight", False),
        "layers.post_mlp_norm": (lay + "post_feedforward_layernorm.weight", False),
        "layers.bq": (lay + "self_attn.q_proj.bias", False),
        "layers.bk": (lay + "self_attn.k_proj.bias", False),
        "layers.bv": (lay + "self_attn.v_proj.bias", False),
        "layers.q_norm": (lay + "self_attn.q_norm.weight", False),
        "layers.k_norm": (lay + "self_attn.k_norm.weight", False),
        "layers.w_gate": (lay + "mlp.gate_proj.weight", True),
        "layers.w_up": (lay + "mlp.up_proj.weight", True),
        "layers.w_down": (lay + "mlp.down_proj.weight", True),
    }
    if cfg.is_moe:  # ``{e}`` for the expert
        moe = (("mlp.gate", "mlp.experts.{e}.", "gate_proj", "up_proj", "down_proj")
               if qwen3_moe else
               ("block_sparse_moe.gate", "block_sparse_moe.experts.{e}.", "w1", "w3", "w2"))
        gate, expert, wg, wu, wd = moe
        names.update({
            "layers.router": (lay + gate + ".weight", True),
            "layers.w_gate": (lay + expert + wg + ".weight", True),
            "layers.w_up": (lay + expert + wu + ".weight", True),
            "layers.w_down": (lay + expert + wd + ".weight", True),
        })
    return names


# Phi-3 fuses these into one HF matrix each: (HF name, parts in order)
_FUSED = {
    "model.layers.{i}.self_attn.qkv_proj.weight": ("layers.wq", "layers.wk", "layers.wv"),
    "model.layers.{i}.mlp.gate_up_proj.weight": ("layers.w_gate", "layers.w_up"),
}


class _Writer:
    """The state dict being filled: each parameter allocated once on the
    device in its dtype (int8 codes and f32 scales when it is quantised),
    filled one layer (or one whole unstacked tensor) at a time."""

    def __init__(self, cfg: ModelConfig, device: torch.device, dtype: torch.dtype, quant: bool,
                 mesh=None):
        self.shapes = param_shapes(cfg, quant)
        self.device, self.dtype, self.quant = device, dtype, quant
        # this rank's slice of each parameter's slots (all of it off a mesh)
        self._cut = lambda name, x, index=(): x
        if mesh is not None and mesh.size > 1:
            specs, blocks = shard_plan(cfg, quant, mesh)
            self._cut = shard_cutter(self.shapes, specs, mesh, blocks)
        self.state: dict[str, torch.Tensor] = {}
        for name, shape in self.shapes.items():
            dt = (torch.float32 if name.endswith(SCALE)
                  else torch.int8 if name + SCALE in self.shapes else dtype)
            self.state[name] = torch.empty(self._cut(name, shape), dtype=dt, device=device)

    def put(self, name: str, w: torch.Tensor, *index: int) -> None:
        """Write ``w`` (already ``[in, out]``) as the whole parameter or its
        slot ``index`` (a layer, or a layer and an expert), rounding to the
        model dtype first, then quantising when the parameter is int8."""
        w = w.to(self.dtype)
        if name + SCALE not in self.shapes:
            self.state[name][index].copy_(self._cut(name, w, index))
            return
        base = name.split(".", 1)[-1]
        axes = CHANNEL_AXES[base] if base == "embed" else stacked_channel_axes(w.ndim,
                                                                              CHANNEL_AXES[base])
        qt = quantize(w, axes)  # the whole weight's scales, then this rank's slice
        self.state[name][index].copy_(self._cut(name, qt.q, index))
        self.state[name + SCALE][index].copy_(self._cut(name + SCALE, qt.scale, index))


def load_state_from_dir(cfg: ModelConfig, model_dir: str | Path, device=None,
                        quantize: bool = False, mesh=None) -> dict[str, torch.Tensor]:
    """The state dict of the checkpoint in ``model_dir`` for ``cfg`` (whose
    dtype the dense parameters take), on ``device`` (cuda unless named);
    this rank's slice on a ``mesh``."""
    dev = resolve_device(device)
    return load_state(cfg, SafetensorsDir(model_dir, _read_device(dev, mesh)), dev, quantize,
                      mesh=mesh)


def load_state(cfg: ModelConfig, files, device: torch.device,
               quantize: bool = False, mesh=None) -> dict[str, torch.Tensor]:
    """The state dict for ``cfg`` from ``files``, anything that answers
    ``name in files`` and ``files.get(name)`` (a tensor in the HF layout)
    for HF tensor names: a :class:`SafetensorsDir`, or a GGUF file's
    adapter (``llm/gguf.py``).  On a ``mesh``, this rank's slice."""
    out = _Writer(cfg, device, cfg.torch_dtype, quantize, mesh)
    hf = _hf_names(cfg, qwen3_moe="model.layers.0.mlp.gate.weight" in files)
    dh = cfg.head_dim
    sizes = {"layers.wq": cfg.num_heads * dh, "layers.wk": cfg.num_kv_heads * dh,
             "layers.wv": cfg.num_kv_heads * dh, "layers.w_gate": cfg.intermediate_size,
             "layers.w_up": cfg.intermediate_size}
    fused = {}
    for fmt, parts in _FUSED.items():
        if fmt.format(i=0) in files:
            fused[fmt] = parts
    done = {p for parts in fused.values() for p in parts}
    for fmt, parts in fused.items():
        for i in range(cfg.num_layers):
            # one read of each layer's fused [sum(sizes), in] matrix
            w = files.get(fmt.format(i=i))
            off = 0
            for name in parts:
                out.put(name, w[off:off + sizes[name]].t(), i)
                off += sizes[name]
    experts = range(cfg.num_experts) if cfg.is_moe else ()
    for name in out.shapes:
        if name.endswith(SCALE) or name in done:
            continue
        fmt, transpose = hf[name]
        if "{e}" in fmt:  # one expert's tensor at a time into its slot
            for i in range(cfg.num_layers):
                for e in experts:
                    out.put(name, files.get(fmt.format(i=i, e=e)).t(), i, e)
        elif name.startswith("layers."):
            for i in range(cfg.num_layers):
                w = files.get(fmt.format(i=i))
                out.put(name, w.t() if transpose else w, i)
        else:
            w = files.get(fmt)
            out.put(name, w.t() if transpose else w)
    return out.state


def quantize_state(cfg: ModelConfig, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A dense state dict's int8 counterpart, each matmul weight quantised
    one layer at a time as :func:`load_state` quantises it."""
    dev = next(iter(state.values())).device
    out = _Writer(cfg, dev, cfg.torch_dtype, True)
    for name, w in state.items():
        if name.startswith("layers."):
            for i in range(cfg.num_layers):
                out.put(name, w[i], i)
        else:
            out.put(name, w)
    return out.state


def is_deepseek_dir(model_dir: str | Path) -> bool:
    """True when config.json declares a DeepSeek architecture."""
    p = Path(model_dir) / "config.json"
    if not p.exists():
        return False
    try:
        archs = json.loads(p.read_text()).get("architectures") or []
    except (OSError, ValueError):
        return False
    return any(str(a).startswith("Deepseek") for a in archs)


def load_model_dir(model_dir: str | Path, dtype: str = "bfloat16", device=None,
                   quantize: bool = False, mesh=None) -> tuple[ModelConfig, dict[str, torch.Tensor]]:
    """(ModelConfig, state dict) from a local HF model directory (this
    rank's slice on a ``mesh``)."""
    if is_deepseek_dir(model_dir):
        raise ValueError(f"{model_dir} is a DeepSeek (MLA) checkpoint: load it with "
                         "load_deepseek_dir")
    cfg = ModelConfig.from_hf_config(model_dir, dtype=dtype)
    return cfg, load_state_from_dir(cfg, model_dir, device=device, quantize=quantize, mesh=mesh)


def _deepseek_hf_names() -> dict[str, tuple[str, bool]]:
    """DeepSeek parameter name -> (HF name, with ``{i}`` for the layer and
    ``{e}`` for an expert; whether the HF matrix is transposed)."""
    lay = "model.layers.{i}."
    attn = {"attn_norm": ("input_layernorm.weight", False),
            "mlp_norm": ("post_attention_layernorm.weight", False),
            "kv_a": ("self_attn.kv_a_proj_with_mqa.weight", True),
            "kv_a_norm": ("self_attn.kv_a_layernorm.weight", False),
            "kv_b": ("self_attn.kv_b_proj.weight", True),
            "wo": ("self_attn.o_proj.weight", True),
            "wq": ("self_attn.q_proj.weight", True),
            "q_a": ("self_attn.q_a_proj.weight", True),
            "q_a_norm": ("self_attn.q_a_layernorm.weight", False),
            "q_b": ("self_attn.q_b_proj.weight", True)}
    dense = {"w_gate": ("mlp.gate_proj.weight", True), "w_up": ("mlp.up_proj.weight", True),
             "w_down": ("mlp.down_proj.weight", True)}
    moe = {"router": ("mlp.gate.weight", True),
           "w_gate": ("mlp.experts.{e}.gate_proj.weight", True),
           "w_up": ("mlp.experts.{e}.up_proj.weight", True),
           "w_down": ("mlp.experts.{e}.down_proj.weight", True),
           "shared_gate": ("mlp.shared_experts.gate_proj.weight", True),
           "shared_up": ("mlp.shared_experts.up_proj.weight", True),
           "shared_down": ("mlp.shared_experts.down_proj.weight", True)}
    names = {"embed": ("model.embed_tokens.weight", False),
             "final_norm": ("model.norm.weight", False), "lm_head": ("lm_head.weight", True)}
    for group, own in (("dense_layers", dense), ("moe_layers", moe)):
        names.update({f"{group}.{k}": (lay + hf, t) for k, (hf, t) in {**attn, **own}.items()})
    return names


def load_deepseek_dir(model_dir: str | Path, dtype: str = "bfloat16",
                      device=None, mesh=None) -> tuple[DeepseekConfig, dict[str, torch.Tensor]]:
    """(DeepseekConfig, state dict) from a DeepSeek-V2 HF directory, on
    ``device`` (cuda unless named): each HF ``[out, in]`` matrix transposed
    into its layer's slot of the layer group's stack, the dense layers
    first (``first_k_dense_replace``) and the MoE layers after them, each
    expert's tensor into its slot of the ``[L, E, K, N]`` stack, read one
    tensor at a time as :func:`load_state_from_dir` reads (this rank's
    slice on a ``mesh``)."""
    cfg = DeepseekConfig.from_hf(json.loads((Path(model_dir) / "config.json").read_text()))
    cfg.dtype = dtype
    dev = resolve_device(device)
    files = SafetensorsDir(model_dir, _read_device(dev, mesh))
    hf = _deepseek_hf_names()
    cut = deepseek_slicer(cfg, mesh)

    def read(name: str, transpose: bool) -> torch.Tensor:
        w = files.get(name)
        return (w.t() if transpose else w).to(cfg.torch_dtype)

    state = {}
    for name, shape in deepseek_param_shapes(cfg).items():
        fmt, transpose = hf[name]
        out = torch.empty(cut(name, shape), dtype=cfg.torch_dtype, device=dev)
        group = name.rpartition(".")[0]
        if not group:
            out.copy_(cut(name, read(fmt, transpose)))
        else:  # the group's j-th layer is HF layer first + j
            first = cfg.first_k_dense_replace if group == "moe_layers" else 0
            for j in range(shape[0]):
                if "{e}" in fmt:
                    for e in range(shape[1]):
                        out[j, e].copy_(cut(name, read(fmt.format(i=first + j, e=e), transpose),
                                            (j, e)))
                else:
                    out[j].copy_(cut(name, read(fmt.format(i=first + j), transpose), (j,)))
        state[name] = out
    return cfg, state


def deepseek_slicer(cfg: DeepseekConfig, mesh):
    """``cut(name, x, index=())``: this rank's slice of parameter ``name``'s
    slot ``index`` when ``x`` is a tensor, or its local shape when ``x`` is
    the full shape (``x`` itself off a mesh)."""
    from dynamo_tpu_torch.models.deepseek import partition_specs

    if mesh is None or mesh.size == 1:
        return lambda name, x, index=(): x
    shapes = deepseek_param_shapes(cfg)
    return shard_cutter(shapes, prune_specs(shapes, partition_specs(cfg), mesh), mesh)


def model_from_spec(spec: dict, device=None, mesh=None):
    """A rank's model (its slice on ``mesh``) from a description that every
    rank of a mesh can follow, so the ranks build the same model:

    * ``{"kind": "checkpoint", "path", "dtype"?, "quantize"?}`` — any
      format ``cli.load_any_checkpoint`` reads;
    * ``{"kind": "init", "family": "llama" | "deepseek", "config": {...},
      "seed", "quantized"?}`` — random weights at full width drawn on the
      device from ``seed`` (each full tensor drawn, then cut, so every tp
      draws the same model);
    * ``{"kind": "state", "family", "config", "path"}`` — a full state dict
      saved with ``safetensors`` (an int8 one holds ``embed_scale``)."""
    from dynamo_tpu_torch.models.convert import deepseek_init_params, init_params
    from dynamo_tpu_torch.models.deepseek import DeepseekModel
    from dynamo_tpu_torch.models.llama import LlamaModel

    dev = resolve_device(device)
    kind = spec["kind"]
    if kind == "checkpoint":
        from dynamo_tpu_torch.cli import load_any_checkpoint

        return load_any_checkpoint(spec["path"], spec.get("dtype"), dev,
                                   bool(spec.get("quantize")), mesh=mesh)[0]
    family = spec.get("family", "llama")
    cfg = (DeepseekConfig if family == "deepseek" else ModelConfig)(**spec["config"])
    if kind == "init":
        gen = torch.Generator(device=dev).manual_seed(int(spec["seed"]))
        if family == "deepseek":
            return DeepseekModel.from_state(cfg, deepseek_init_params(cfg, gen, dev, mesh=mesh),
                                            mesh=mesh)
        return LlamaModel.from_state(cfg, init_params(cfg, gen, dev, bool(spec.get("quantized")),
                                                      mesh=mesh), mesh=mesh)
    if kind == "state":
        from safetensors.torch import load_file

        from dynamo_tpu_torch.models.convert import shard_full_state

        full = load_file(str(spec["path"]), device="cpu")
        state = shard_full_state(family, cfg, full, mesh, dev)
        cls = DeepseekModel if family == "deepseek" else LlamaModel
        return cls.from_state(cfg, state, mesh=mesh)
    raise ValueError(f"unknown model spec kind {kind!r}")
