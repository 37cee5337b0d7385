"""The PyTorch port stands alone and never drops quietly to the CPU.

* No module of the port, and not the root ``chip_smoke.py``, imports JAX
  or anything of the JAX package, nor the root ``examples`` graph library,
  which imports the JAX package (an AST walk over the files, found through
  the imported package, not through a path spelled out here).
* The port's serving graphs resolve to the port's components only, and its
  supervisor spawns the port's worker entry.
* No file of the port names the JAX package's perf manifest, the load
  plane names no perf manifest, and the port's own pins the H100.
* The entry points raise when no device is named and no CUDA device
  exists.
* Each kernel wrapper takes its plain version only for CPU tensors; on any
  other device that is not CUDA (``meta`` here) it raises, with no
  fallback and no launch counted.
"""

import ast
import asyncio
import importlib
import json
import re
import sys
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
FORBIDDEN = {"jax", "jaxlib", "dynamo_tpu", "examples"}


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
    # the mesh's modules and the follower ranks' entry point are walked too
    for rel in ("utils/mesh.py", "runtime/multihost.py", "ops/ring_attention.py",
                "engine/follower.py", "analysis/detloop.py", "analysis/protocheck.py",
                "analysis/cli.py", "analysis/core.py", "analysis/rules_async.py",
                "analysis/project.py", "analysis/loadcheck.py", "load/traffic.py",
                "load/workers.py", "load/sim.py"):
        assert PKG / rel in files, rel
    bad = {str(f.relative_to(PKG.parent)): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files if _imported_roots(f) & FORBIDDEN}
    assert not bad, f"the port imports JAX or the JAX package: {bad}"


# what loading the JAX package's native library, or building it from the
# root native/ directory, would have to spell
JAX_NATIVE = re.compile(r"libdynamo_native|(?<![\w])_lib[/\\]|(?<![\w])native[/\\](src|include)"
                        r"|\bmake\b.*-C|^make$")


def test_port_builds_its_own_host_library():
    """No module of the port, and not ``chip_smoke.py``, loads the JAX
    package's native library or runs the root ``native/`` Makefile (no string
    of theirs names either): the port's host library is built by g++ from
    the port's own sources (``csrc/host/``) into the port's ``_build``, and
    that is the file loaded."""
    from dynamo_tpu_torch import native

    named = {}
    for f in _port_files():
        strings = [n.value for n in ast.walk(ast.parse(f.read_text()))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)]
        hits = [s for s in strings if JAX_NATIVE.search(s)]
        if hits:
            named[str(f.relative_to(PKG.parent))] = hits
    assert not named, named
    assert JAX_NATIVE.search("dynamo_tpu/_lib/libdynamo_native.so")
    assert JAX_NATIVE.search("make") and JAX_NATIVE.search("native/src/kv_index.cpp")
    assert not JAX_NATIVE.search("csrc/host/kv_index.cpp")
    lib = native.build_library()
    assert native.SRC.is_relative_to(PKG) and lib.parent == PKG / "_build"
    assert Path(native.load()._name) == lib


# the JAX package's perf manifest, by path or module path ("dynamo_tpu"
# then a separator: the port's own package name does not match)
JAX_PERF_MANIFEST = re.compile(r"(?<![\w])dynamo_tpu[/.]analysis[/.]perf_manifest")


def test_port_reads_no_tpu_manifest():
    """No file of the port names the JAX package's perf manifest of TPU
    predictions; the load plane prices its workers from the card's figures
    (``load/card_latency.json``) and names no perf manifest at all; the
    port's own perf manifest (the H100 roofline ``/metrics`` renders) pins
    an H100 constants version."""
    files = _port_files() + sorted(PKG.rglob("*.json"))
    assert PKG / "load" / "card_latency.json" in files
    named = [str(f.relative_to(PKG.parent)) for f in files if JAX_PERF_MANIFEST.search(f.read_text())]
    assert not named, named
    load = [f for f in files if f.is_relative_to(PKG / "load")]
    assert PKG / "load" / "card_latency.json" in load
    named = [str(f.relative_to(PKG.parent)) for f in load if "perf_manifest" in f.read_text()]
    assert not named, named
    header = json.loads((PKG / "analysis" / "perf_manifest.json").read_text())["header"]
    assert header["constants_version"].startswith("h100-"), header["constants_version"]
    assert JAX_PERF_MANIFEST.search("dynamo_tpu/analysis/perf_manifest.json")
    assert not JAX_PERF_MANIFEST.search(PKG.name + "/analysis/perf_manifest.json")


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
    # a follower rank's entry point picks cuda:{local rank % cards}: no card
    from dynamo_tpu_torch.engine.follower import rank_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device(None)
    assert rank_device("cpu") == torch.device("cpu")


def test_engine_refuses_unported_options():
    """A mesh_shape that is not the model's mesh is refused by name, on one
    rank and on a mesh.  The host-offload and persist tiers, speculation and
    lookahead dispatch are served on a mesh of more than one rank: the
    engine accepts them.  The check comes before any collective, so a
    2-rank mesh with no world behind it is enough here."""
    from dynamo_tpu_torch.utils.mesh import MESH_AXES, Mesh

    cfg = ModelConfig.tiny()
    model = LlamaModel.from_state(cfg, init_params(cfg, torch.Generator(), device="cpu"))
    with pytest.raises(ValueError, match="mesh_shape"):
        EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8, mesh_shape=(1, 2)),
                   device="cpu")
    mesh = Mesh(MESH_AXES, (1, 2))
    state = init_params(cfg, torch.Generator(), device="cpu", mesh=mesh)
    sharded = LlamaModel.from_state(cfg, state, mesh=mesh)
    with pytest.raises(ValueError, match=r"on a mesh: \['mesh_shape'\]"):
        EngineCore(sharded, EngineConfig(max_model_len=64, num_blocks=8, mesh_shape=(2, 1)),
                   device="cpu")
    for opt in (dict(num_host_blocks=8), dict(num_host_blocks=8, kv_persist_dir="/nonexistent"),
                dict(spec_tokens=2), dict(lookahead_dispatch=True), dict(cache_dtype="bfloat16")):
        EngineCore._check_supported(sharded, EngineConfig(max_model_len=64, num_blocks=8, **opt),
                                    "cpu")


@pytest.mark.parametrize("model_dtype,cache_dtype,refused", [
    ("bfloat16", "float16", True), ("bfloat16", "float32", True), ("float32", "bfloat16", True),
    ("float32", "float16", True), ("bfloat16", None, False), ("bfloat16", "bfloat16", False),
    ("bfloat16", "int8", False), ("float32", "int8", False), ("bfloat16", torch.float16, True)])
def test_cuda_engine_refuses_a_cache_dtype_no_kernel_takes(model_dtype, cache_dtype, refused):
    """On the card a float cache dtype other than the model's is refused at
    construction, by name and with "no kernel" (``refused``: the route
    check's cache clause): the attention kernels take a cache of the
    queries' dtype or an int8 cache, and nothing falls back to the plain
    ops.  A float32 model is refused on the card whatever its cache, by its
    dtype: no kernel has a float32 body.  The CPU serves every one of them.
    Checked without a card, on the construction check itself."""
    from dynamo_tpu_torch.engine.core import cuda_cache_refusal

    cfg = ModelConfig(**{**vars(ModelConfig.tiny()), "dtype": model_dtype})
    model = LlamaModel(cfg, device="meta")
    ecfg = EngineConfig(max_model_len=64, num_blocks=8, cache_dtype=cache_dtype)
    EngineCore._check_supported(model, ecfg, "cpu")
    why = cuda_cache_refusal(model_dtype, cache_dtype)
    assert bool(why) == refused
    if model_dtype == "float32":
        with pytest.raises(ValueError, match=r"model dtype 'float32' on cuda: no kernel takes"):
            EngineCore._check_supported(model, ecfg, torch.device("cuda", 0))
        return
    if not refused:
        EngineCore._check_supported(model, ecfg, torch.device("cuda", 0))
        return
    name = str(cache_dtype).replace("torch.", "")
    with pytest.raises(ValueError, match=rf"cache_dtype '{name}' on cuda: no kernel takes"):
        EngineCore._check_supported(model, ecfg, torch.device("cuda", 0))


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


GRAPHS = sorted(p.stem for p in (PKG / "examples" / "llm" / "graphs").glob("*.py")
                if p.stem != "__init__")


def test_graphs_resolve_to_port_components():
    from dynamo_tpu_torch.sdk.service import DynamoService

    assert GRAPHS == ["agg", "agg_router", "disagg", "disagg_colocated", "disagg_router"]
    for name in GRAPHS:
        mod = f"{dynamo_tpu_torch.__name__}.examples.llm.graphs.{name}"
        closure = importlib.import_module(mod).Frontend.closure(mod)
        assert len(closure) >= 3
        for svc in closure:
            assert type(svc) is DynamoService, (name, svc)
            assert svc.inner.__module__.startswith(
                f"{dynamo_tpu_torch.__name__}.examples.llm.components."), (name,
                                                                           svc.inner.__module__)


def test_supervisor_spawns_the_port_worker(monkeypatch):
    from dynamo_tpu_torch.sdk import serving

    spawned = []

    class Spawned:
        pid = 0

        def __init__(self, cmd, env):
            spawned.append((cmd, env))

    monkeypatch.setattr(serving.subprocess, "Popen", Spawned)
    monkeypatch.setenv("DYNTPU_GPUS", "0,0")
    graph = f"{dynamo_tpu_torch.__name__}.examples.llm.graphs.disagg:Frontend"
    sup = serving.ServeSupervisor(graph, coordinator_url="tcp://127.0.0.1:1")
    asyncio.run(sup.start())
    names = ["PrefillWorker", "GpuWorker", "Processor", "Frontend"]
    assert [cmd for cmd, _ in spawned] == [
        [sys.executable, "-m", f"{dynamo_tpu_torch.__name__}.sdk.serve_worker", graph, name]
        for name in names]
    assert [env["CUDA_VISIBLE_DEVICES"] for _, env in spawned] == ["0", "0", "", ""]
