"""The PyTorch port stands alone and never drops quietly to the CPU.

* No module of the port, and not the root ``chip_smoke.py``, imports JAX
  or anything of the JAX package (an AST walk over the files, found
  through the imported package, not through a path spelled out here).
* The entry points raise when no device is named and no CUDA device
  exists.
* Each kernel wrapper takes its plain version only for CPU tensors; on any
  other device that is not CUDA (``meta`` here) it raises, with no
  fallback and no launch counted.
"""

import ast
from pathlib import Path

import pytest
import torch

import dynamo_tpu_torch
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import init_params
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.ops.kernels.decode_attention import paged_decode_attention
from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention

PKG = Path(dynamo_tpu_torch.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "dynamo_tpu"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def _port_files() -> list[Path]:
    return sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = {str(f.relative_to(PKG.parent)): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files if _imported_roots(f) & FORBIDDEN}
    assert not bad, f"the port imports JAX or the JAX package: {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_device(no_cuda):
    cfg = ModelConfig.tiny()
    model = LlamaModel.from_state(cfg, init_params(cfg, torch.Generator(), device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    # named explicitly, the CPU is fine
    EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8), device="cpu")


def test_engine_refuses_unported_options():
    cfg = ModelConfig.tiny()
    model = LlamaModel.from_state(cfg, init_params(cfg, torch.Generator(), device="cpu"))
    with pytest.raises(ValueError, match="num_host_blocks"):
        EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8, num_host_blocks=4),
                   device="cpu")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_wrappers_raise_off_cuda_and_cpu():
    b, s, h, hk, d, bs = 2, 4, 8, 2, 128, 16
    cache = _meta(3, 8, 2, bs, hk * d)
    bt = _meta(b, 4, dtype=torch.int32)
    lens = _meta(b, dtype=torch.int32)
    before = (paged_decode_attention.launches, paged_prefill_attention.launches)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_decode_attention(_meta(b, 1, h, d), cache, 1, bt, lens, lens)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_prefill_attention(_meta(b, s, h, d), _meta(b, s, hk, d), _meta(b, s, hk, d),
                                cache, 1, bt, lens, lens)
    assert (paged_decode_attention.launches, paged_prefill_attention.launches) == before
