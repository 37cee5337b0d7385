"""GpuWorker — the serving engine component of the example graphs.

The counterpart of the JAX package's ``examples/llm/components/worker.py``
(``TpuWorker``, as ``out=tpu`` became ``out=gpu``).  Reference analogue:
examples/llm/components/worker.py (VllmWorker) + prefill_worker.py; here
the engine is the port's EngineCore.  Config (ServiceConfig YAML, see
../configs/):

  engine: echo | tiny | gpu     (tiny = random-weights EngineCore, used by
                                 serve-level tests; gpu needs model-path;
                                 default gpu when model-path is set)
  model-path: checkpoint        (HF dir, native checkpoint, .gguf, or
                                 dyn://models/NAME, pulled from the
                                 coordinator's blob store at boot)
  quantize: none | int8
  dtype                         (weights and activations; default bfloat16)
  device                        (torch device; default the current CUDA
                                 device, and no GPU raises; cpu is the
                                 plain PyTorch path the tests take)
  max-batch-size / max-model-len / block-size / num-blocks
  num-host-blocks               (host-RAM KV offload tier; 0 = off)
  kv-quant: int8                (int8 KV cache; default = model dtype)
  remote-prefill: true          (disagg decode side: conditional remote
                                 prefill via the coordinator queue)
  max-local-prefill-length      (disagg router threshold)
  tp / dp                       (the rank mesh: the worker's process is rank 0
                                 and starts the other ranks of its host as
                                 shard followers, engine/follower.py)
  nnodes / node-rank            (hosts of one mesh, joined through the
                                 worker's coordinator)
  sp-prefill-threshold          (long prompts prefill with the sequence split
                                 over the mesh's data axis; needs dp > 1)

The mesh keys need the gpu engine (a checkpoint); the echo and tiny engines
refuse them by name.
"""

from __future__ import annotations

import asyncio
import logging
from types import SimpleNamespace

from dynamo_tpu_torch.llm.protocols import (
    BackendInput,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.ops.kernels import launch_counts
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.sdk import async_on_start, dynamo_endpoint, service

log = logging.getLogger("dynamo_tpu_torch.examples.worker")

NAMESPACE = "dynamo"

# the rank mesh's config keys, and the value each takes on one device
_MESH_KEYS = {"tp": 1, "dp": 1, "nnodes": 1, "node-rank": 0, "sp-prefill-threshold": 0}


async def resolve_cfg_model(cfg: dict, rt) -> dict:
    """The config with a ``dyn://models/<name>`` model-path pulled into the
    local cache, on the runtime's loop without blocking it: the engine
    builder's blocking resolver would starve the coordinator lease
    keepalives for the whole pull."""
    mp = cfg.get("model-path")
    if mp and rt is not None:
        from dynamo_tpu_torch.llm.model_store import is_model_ref, resolve_model

        if is_model_ref(mp):
            cfg = dict(cfg)
            cfg["model-path"] = await resolve_model(mp, rt.coordinator)
    return cfg


def _kv_quant(cfg: dict) -> str:
    """Validated ``kv-quant`` key: a typo'd value must fail the boot, not
    silently build a full-precision cache into an int8-sized num_blocks
    budget (OOM at load instead of a config error)."""
    kvq = str(cfg.get("kv-quant", "model"))
    if kvq not in ("model", "int8"):
        raise ValueError(
            f"kv-quant must be 'model' or 'int8', got {kvq!r}")
    return kvq


def _mesh_keys(cfg: dict, kind: str) -> dict:
    """The mesh keys as ``run``'s argument names; a mesh on an engine other
    than gpu raises."""
    keys = {k.replace("-", "_"): int(cfg.get(k, one)) for k, one in _MESH_KEYS.items()}
    if kind != "gpu":
        bad = {k: cfg[k] for k, one in _MESH_KEYS.items() if int(cfg.get(k, one)) != one}
        if bad:
            raise ValueError(f"{bad}: a rank mesh needs the gpu engine (a model-path), "
                             f"not {kind}")
    return keys


def build_engine(cfg: dict):
    """(engine, card) from a service config dict (shared by GpuWorker and
    PrefillWorker so both sides of a disagg pair agree on the model)."""
    kind = cfg.get("engine", "gpu" if cfg.get("model-path") else "echo")
    mesh = _mesh_keys(cfg, kind)
    if kind == "echo":
        from dynamo_tpu_torch.llm.engines import EchoEngineCore

        return EchoEngineCore(), None
    if kind == "tiny":
        import torch

        from dynamo_tpu_torch.device import resolve_device
        from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
        from dynamo_tpu_torch.models.config import ModelConfig
        from dynamo_tpu_torch.models.convert import init_params
        from dynamo_tpu_torch.models.llama import LlamaModel

        device = resolve_device(cfg.get("device"))
        mcfg = ModelConfig.tiny()
        gen = torch.Generator(device=device).manual_seed(0)
        model = LlamaModel.from_state(mcfg, init_params(
            mcfg, gen, device=device, quantized=cfg.get("quantize") == "int8"))
        ecfg = EngineConfig(
            max_batch_size=int(cfg.get("max-batch-size", 4)),
            max_model_len=int(cfg.get("max-model-len", 256)),
            block_size=int(cfg.get("block-size", 16)),
            num_blocks=int(cfg.get("num-blocks", 64)),
            num_host_blocks=int(cfg.get("num-host-blocks", 0)),
            cache_dtype=("int8" if _kv_quant(cfg) == "int8" else None),
        )
        return AsyncLLMEngine(EngineCore(model, ecfg, device=device)).start(), None
    if kind != "gpu":
        raise ValueError(f"engine must be echo, tiny or gpu, got {kind!r}")
    # full path: reuse the CLI's builder (loading, quantize)
    from dynamo_tpu_torch.cli import build_local_engine

    args = SimpleNamespace(
        out="gpu",
        model_path=cfg.get("model-path"),
        model_name=cfg.get("model-name"),
        device=cfg.get("device"),
        dtype=cfg.get("dtype", "bfloat16"),
        max_batch_size=int(cfg.get("max-batch-size", 8)),
        max_model_len=int(cfg.get("max-model-len", 4096)),
        block_size=int(cfg.get("block-size", 16)),
        num_blocks=int(cfg.get("num-blocks", 512)),
        num_host_blocks=int(cfg.get("num-host-blocks", 0)),
        quantize=cfg.get("quantize", "none"),
        kv_cache_dtype=_kv_quant(cfg),
        # the CLI's defaults for what the worker's config does not set
        kv_persist_dir=None, kv_persist_max_bytes=0, kv_persist_ttl=0,
        spec_tokens=0, spec_draft_model=None, spec_draft_num_blocks=0,
        prefill_chunk_tokens=0, prefill_token_budget=0,
        unified_token_dispatch=False, lookahead_dispatch=False,
        profile_dir=None, profile_steps=8,
        coordinator=cfg.get("coordinator"), namespace=cfg.get("namespace"),
        **mesh,
    )
    return build_local_engine(args)


def backend_input(req: dict) -> BackendInput:
    return BackendInput(
        token_ids=list(req["token_ids"]),
        sampling=SamplingOptions(**req.get("sampling", {})),
        stops=StopConditions(**req.get("stops", {})),
        model=req.get("model", ""),
    )


def wire_output(out) -> dict:
    d = {"token_ids": list(out.token_ids)}
    if out.text:
        d["text"] = out.text
    if out.finish_reason is not None:
        d["finish_reason"] = out.finish_reason.value
    if out.cached_tokens:
        d["cached_tokens"] = out.cached_tokens
    return d


async def stop_engine(engine) -> None:
    """Stop a worker's engine: a DecodeWorker closes its transfer
    endpoint, then the AsyncLLMEngine thread stops."""
    if hasattr(engine, "stop"):
        await engine.stop()
        engine = engine.engine
    if hasattr(engine, "shutdown"):
        engine.shutdown()


@service(dynamo={"namespace": NAMESPACE}, resources={"gpu": 1})
class GpuWorker:
    """Engine worker: serves `generate` over BackendInput-shaped dicts,
    and `status`, the kernels this process launched.  With
    ``remote-prefill: true`` it wraps the engine in a DecodeWorker so long
    prompts prefill remotely via the coordinator queue (disagg)."""

    def __init__(self):
        self._cfg = dict(self.service_config)
        self.engine = None

    @async_on_start
    async def boot(self):
        rt = getattr(self, "dynamo_runtime", None)
        cfg = await resolve_cfg_model(self._cfg, rt)
        # off-loop: a model build (weights load, engine start) blocks for
        # seconds — on the loop it would stall coordinator keepalives
        self.engine, self.card = await asyncio.to_thread(build_engine, cfg)
        if cfg.get("remote-prefill") and rt is not None:
            from dynamo_tpu_torch.llm.disagg_router import (
                DisaggregatedRouter,
                DisaggRouterConf,
            )
            from dynamo_tpu_torch.llm.workers import DecodeWorker

            conf = DisaggRouterConf(
                max_local_prefill_length=int(
                    cfg.get("max-local-prefill-length", 0)
                ),
            )
            self.engine = await DecodeWorker(
                self.engine,
                coordinator=rt.coordinator,
                namespace=NAMESPACE,
                router=DisaggregatedRouter(conf, namespace=NAMESPACE),
            ).start()
        if rt is not None:
            from dynamo_tpu_torch.cli import attach_worker_publishers

            attach_worker_publishers(rt, self.engine, NAMESPACE)

    async def shutdown(self):
        await stop_engine(self.engine)

    @dynamo_endpoint
    async def generate(self, req: dict):
        ctx = Context(backend_input(req))
        async for out in self.engine.generate(ctx):
            yield wire_output(out)
            if out.finished:
                return

    @dynamo_endpoint
    async def status(self, req: dict):
        # not in the JAX worker: each kernel wrapper's launches in this process
        yield {"launches": launch_counts()}
