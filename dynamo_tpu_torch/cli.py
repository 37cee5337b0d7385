"""The port's command line: ``run``, ``coordinator``, ``http``, ``router``,
``models``, ``trace``, ``quantize``, ``serve``, ``package``, ``planner``,
``metrics``, ``mock-worker``, ``deploy``, ``operator``, ``api-store`` and
``lint``.

    python -m dynamo_tpu_torch run in=<http|text:PROMPT|stdin|batch:FILE|dyn://NS.COMP.EP> \\
        out=<gpu|echo|dyn://NS.COMP.EP> --model-path DIR [options]

The counterpart of ``dynamo_tpu/cli.py``'s commands of the same names.
``run`` builds the local
pipeline frontend → preprocessor → engine → detokenizer from a checkpoint
and serves it over OpenAI HTTP (``in=http``), answers one prompt
(``in=text:``), one prompt per line (``in=stdin``) or a JSONL file of
prompts (``in=batch:``).  ``out=gpu`` serves the checkpoint on the PyTorch
engine, on the GPU.  ``--model-path`` is, in the JAX CLI's order of
dispatch, a native checkpoint (``models/checkpoint.py``, written by
``quantize``), a ``.gguf`` file (``llm/gguf.py``), or a HuggingFace
directory: Llama-family (Mixtral and Qwen3-MoE included) or DeepSeek-V2
(``models/deepseek.py``; ``--quantize int8`` is refused for it, as in the
JAX CLI).  ``dyn://models/NAME`` pulls a model pushed with ``models push``
from the coordinator's blob store into the local cache first.  With no
GPU present it fails rather than run on the CPU (``--device cpu`` is the
plain PyTorch path the tests take); ``out=echo`` echoes the prompt's
tokens back with no model.
``--num-host-blocks N`` adds the host-RAM KV offload tier and
``--kv-persist-dir DIR`` (with ``--kv-persist-max-bytes``, ``--kv-persist-ttl``)
the persistent tier below it, with the JAX CLI's defaults.
``--spec-tokens N`` turns on speculative decoding (prompt-lookup n-grams),
and ``--spec-draft-model DIR`` proposes with a small same-tokenizer model
instead, loaded unquantised as the target is loaded; a configuration the
engine refuses (a draft of another vocabulary) exits with the engine's
message.  ``--trace`` turns the tracing plane on (``/debug/traces``), and
``--profile-dir DIR --profile-steps N`` wraps the engine's first N
dispatching steps in one ``torch.profiler`` window written under DIR.
The JAX CLI's unported options are not flags of this command.

The distributed runtime (``runtime/distributed.py``, over a coordinator
given by ``--coordinator tcp://HOST:PORT``, namespace ``--namespace``):

* ``coordinator`` runs the control plane (discovery, leases, events);
* ``run in=dyn://NS.COMP.EP out=gpu`` is a worker: it serves the engine at
  that endpoint and publishes its KV events and load for a KV router;
* ``run in=... out=dyn://NS.COMP.EP --model-path DIR`` answers through a
  remote worker, preprocessing and detokenizing here with DIR's tokenizer;
* ``models add NAME dyn://NS.COMP.EP --model-path DIR`` registers a model
  under ``{ns}/models/``, ``models list|remove`` read and drop them;
* ``models push NAME DIR`` uploads a model directory to the coordinator's
  blob store and ``models pull NAME [--out DIR]`` fetches it into the
  content-addressed cache (``llm/model_store.py``);
* ``http`` is an OpenAI frontend that discovers the registered models and
  serves each through its worker endpoint;
* ``router`` serves KV-aware routing decisions at ``dyn://NS.router.generate``;
* ``trace REQUEST_ID --url URL`` fetches one request's Chrome trace from a
  frontend's ``/debug/traces``.

A worker serves the engine itself (tokens in, tokens out), which is what
a frontend's preprocessing pipeline sends it; the JAX CLI's worker serves
its text pipeline instead, which its own ``http`` frontend cannot call.

``quantize SRC OUT [--scheme int8|none]`` converts an HF directory or a
GGUF file into a native checkpoint once (on the GPU unless ``--device
cpu``), so an engine starts without the per-start load and quantisation.

Serving graphs (``sdk/``, ``examples/llm/graphs/``):

* ``serve GRAPH -f CONFIG`` starts one process per service of the graph
  (``module:EntryService``, e.g.
  ``dynamo_tpu_torch.examples.llm.graphs.disagg:Frontend``) under a
  supervisor that restarts crashed workers; SIGTERM or ctrl-c drains and
  stops them all.  GPU services take their cards from the ``DYNTPU_GPUS``
  pool ("0,1"; "0,0" puts two one-card workers on card 0).  With
  ``--package NAME[:VER]`` the graph comes from an api-store
  (``--api-store URL``), unpacked into ``--package-cache``;
* ``package build SRC --entry module:Service --name NAME -o FILE`` archives
  a graph's sources; ``package push|pull|list`` talk to an api-store over
  HTTP: the port's (``api-store``) or the JAX package's, which speak the
  same REST surface.

The control plane's components:

* ``planner`` runs the planning loop over the live metrics plane and logs
  each tick's plan (replica targets, role flips); scale-ups also publish
  the persist pre-warm hint;
* ``metrics`` serves the workers' ForwardPassMetrics and the router's hit
  rates as Prometheus text (``--push-url`` pushes it instead);
* ``mock-worker`` publishes fake metrics and KV events, no GPU needed;
* ``deploy SPEC [-o DIR]`` renders a deployment spec's k8s manifests (GPU
  resources, ``deploy/renderer.py``);
* ``operator [SPECS_DIR] [--crd]`` reconciles specs into a cluster through
  ``kubectl`` (``--dry-run``: an in-memory cluster), with live phases and
  autoscaling given ``--coordinator``;
* ``api-store`` serves the versioned graph and package registry.

``lint [PATHS]`` runs the per-file source rules (DT001-DT004) over the
package, ``--project`` adds the interprocedural rules (DT005-DT009), both
against the committed ``analysis/baseline.json``.  ``lint --proto`` runs
the protocol plane (``analysis/protocheck.py``): the control plane's
scenarios under seeded schedules and crash points, against the committed
``analysis/proto_manifest.json``.  ``lint --load`` runs the
scale-simulation plane (``analysis/loadcheck.py``): the control plane at
virtual time over simulated workers priced from the card
(``load/card_latency.json``), against ``analysis/load_manifest.json``.
Each takes ``--update-baseline`` and ``--format json``; ``--proto`` and
``--load`` take ``--replay TOKEN``.  The JAX command's other planes exit 2.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys
import time
from pathlib import Path
from typing import Optional

log = logging.getLogger("dynamo_tpu_torch.cli")

__all__ = ["build_local_engine", "load_any_checkpoint", "model_card", "attach_worker_publishers",
           "start_router_service", "parse_args", "main"]

MODELS_PREFIX = "models/"  # under {namespace}/
API_STORE = "http://127.0.0.1:7180"
# unpacked packages, one directory per (name, version)
PACKAGE_CACHE = Path("~/.cache/dynamo_tpu_torch/packages").expanduser()


def load_any_checkpoint(path: str, dtype: Optional[str], device, quantize: bool, mesh=None):
    """(model, quantized) for any checkpoint format, in the JAX CLI's order:
    native (``quantize``'s output), GGUF, an HF directory (Llama family, or
    DeepSeek by :func:`is_deepseek_dir`).  ``dtype`` None: a native
    checkpoint keeps its stored dtype, the others load as bfloat16.
    ``quantize``: int8 weights (a native int8 checkpoint already is).  On a
    ``mesh``, this rank's slice of the model."""
    from dynamo_tpu_torch.models.checkpoint import is_native_checkpoint, load_checkpoint
    from dynamo_tpu_torch.models.deepseek import DeepseekModel
    from dynamo_tpu_torch.models.llama import LlamaModel
    from dynamo_tpu_torch.models.loader import (is_deepseek_dir, load_deepseek_dir,
                                                load_model_dir, quantize_state)

    if is_native_checkpoint(path):
        # weights load as they are served: no per-start load + quantise
        # an int8 weight's scales come from the whole weight: on a mesh,
        # quantise on the host first and cut after
        whole = quantize and mesh is not None and mesh.size > 1
        mcfg, state, quantized = load_checkpoint(path, dtype=dtype,
                                                 device="cpu" if whole else device,
                                                 mesh=None if whole else mesh)
        if quantize and not quantized:
            state, quantized = quantize_state(mcfg, state), True
        if whole:
            from dynamo_tpu_torch.device import resolve_device
            from dynamo_tpu_torch.models.convert import shard_full_state

            state = shard_full_state("llama", mcfg, state, mesh, resolve_device(device))
        return LlamaModel.from_state(mcfg, state, mesh=mesh), quantized
    if path.endswith(".gguf"):
        from dynamo_tpu_torch.llm.gguf import load_gguf_model

        mcfg, state = load_gguf_model(path, dtype=dtype or "bfloat16", device=device,
                                      quantize=quantize, mesh=mesh)
        return LlamaModel.from_state(mcfg, state, mesh=mesh), quantize
    if is_deepseek_dir(path):  # the MLA family, as the JAX CLI dispatches it
        if quantize:
            raise SystemExit("--quantize int8 is not wired for this model family yet")
        mcfg, state = load_deepseek_dir(path, dtype=dtype or "bfloat16", device=device, mesh=mesh)
        return DeepseekModel.from_state(mcfg, state, mesh=mesh), False
    mcfg, state = load_model_dir(path, dtype=dtype or "bfloat16", device=device, quantize=quantize,
                                 mesh=mesh)
    return LlamaModel.from_state(mcfg, state, mesh=mesh), quantize


def model_card(path: str, name: Optional[str] = None):
    """The card of a checkpoint: from a GGUF file's metadata, else from the
    directory (a native checkpoint carries its source's tokenizer files)."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    if path.endswith(".gguf"):
        return ModelDeploymentCard.from_gguf(path, name=name)
    return ModelDeploymentCard.from_hf_dir(path, name=name)


class RankWorld:
    """This host's ranks of a ``run --tp/--dp`` mesh (``utils/mesh.py``):
    the process running ``run`` is the host's first rank, and it starts the
    others as shard followers (``engine/follower.py``), each bound to
    ``cuda:{local rank % cards}`` (or to the CPU with ``--device cpu``).  On
    one host the followers join through a TCPStore address passed to them;
    with ``--nnodes`` every host's ranks join through the coordinator's
    rendezvous (``runtime/multihost.py``).  :meth:`close` stops the
    followers it started."""

    def __init__(self, mesh, procs: list, is_root: bool):
        self.mesh, self.procs, self.is_root = mesh, procs, is_root

    @classmethod
    def start(cls, args, device, dp: int, tp: int) -> "RankWorld":
        import subprocess

        from dynamo_tpu_torch.runtime.multihost import MultiHostSpec, bootstrap, free_port
        from dynamo_tpu_torch.utils.mesh import MESH_AXES, build_mesh

        world = dp * tp
        nnodes = int(getattr(args, "nnodes", 1) or 1)
        node = int(getattr(args, "node_rank", 0) or 0)
        if world % nnodes:
            raise SystemExit(f"--tp {tp} x --dp {dp} = {world} ranks do not split over "
                             f"--nnodes {nnodes}")
        per = world // nnodes
        first = node * per
        env = dict(os.environ, DYN_MH_NPROCS=str(world), DYN_MH_MESH=f"{dp},{tp}")
        spec = MultiHostSpec(num_processes=world, process_id=first,
                             backend=os.environ.get("DYN_MH_BACKEND") or None)
        if nnodes > 1:
            if not args.coordinator:
                raise SystemExit("--nnodes > 1 joins the hosts through --coordinator")
            spec.coordinator_url = args.coordinator
            spec.group = args.namespace or "default"
            env.update(DYN_MH_COORDINATOR=args.coordinator, DYN_MH_GROUP=spec.group)
        else:
            spec.store_addr = f"127.0.0.1:{free_port()}"
            env.update(DYN_MH_STORE=spec.store_addr)
        cmd = [sys.executable, "-m", "dynamo_tpu_torch.engine.follower"]
        if device.type == "cpu":
            cmd += ["--device", "cpu"]
        procs = [subprocess.Popen(cmd, env=dict(env, DYN_MH_RANK=str(first + j),
                                                DYN_MH_LOCAL_RANK=str(j)))
                 for j in range(1, per)]
        try:
            bootstrap(spec, device)
            mesh = build_mesh((dp, tp), MESH_AXES, device=device)
        except BaseException:
            cls(None, procs, False).close()
            raise
        log.info("rank %d of a (dp %d, tp %d) mesh on %s (%s); %d followers started here",
                 first, dp, tp, device, mesh.backend, len(procs))
        return cls(mesh, procs, first == 0)

    def close(self) -> None:
        """Stop the followers (rank 0 tells the world; every host then waits
        for its own), and leave the world."""
        import subprocess

        from dynamo_tpu_torch.engine.follower import stop_followers
        from dynamo_tpu_torch.runtime.multihost import shutdown

        if self.mesh is not None and self.is_root:
            try:
                stop_followers(self.mesh)
            except Exception:  # a broken world: the followers are going down anyway
                log.exception("could not stop the shard followers")
        # every rank leaves the world together (NCCL's teardown waits for
        # its peers), then this host's followers are reaped
        shutdown()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs = []


def build_local_engine(args) -> tuple[object, object]:
    """out=gpu|echo → (engine, card): the PyTorch engine on the checkpoint
    in ``args.model_path``, started, or the echo stub.  A
    ``dyn://models/NAME`` path is pulled first (blocking this thread; an
    event loop's caller resolves it with ``llm.model_store.resolve_model``
    beforehand, as ``run`` does)."""
    from dynamo_tpu_torch.llm.model_store import is_model_ref, resolve_model_sync

    if args.model_path is None:
        raise SystemExit(f"out={args.out} needs --model-path (weights + tokenizer)")
    if is_model_ref(args.model_path):
        ref = args.model_path
        args.model_path = resolve_model_sync(
            ref, getattr(args, "coordinator", None) or os.environ.get("DYNTPU_COORDINATOR"))
        log.info("resolved %s -> %s", ref, args.model_path)
    card = model_card(args.model_path, args.model_name)
    if args.out == "echo":
        from dynamo_tpu_torch.llm.engines import EchoEngineCore

        return EchoEngineCore(), card
    if args.out != "gpu":
        raise SystemExit(f"unknown out={args.out}")

    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engine import EngineConfig

    try:
        # before the weights move: with no GPU and no --device this raises
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"out=gpu: {e}") from None
    cfg = EngineConfig(
        max_batch_size=args.max_batch_size,
        max_model_len=args.max_model_len,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        num_host_blocks=int(args.num_host_blocks or 0),
        # persistent prefix-cache tier (llm/kv/persist.py): default off
        kv_persist_dir=args.kv_persist_dir or None,
        kv_persist_max_bytes=int(args.kv_persist_max_bytes or 0),
        kv_persist_ttl_s=float(args.kv_persist_ttl or 0),
        cache_dtype="int8" if args.kv_cache_dtype == "int8" else None,
        spec_tokens=args.spec_tokens,
        draft_num_blocks=args.spec_draft_num_blocks,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        prefill_token_budget=args.prefill_token_budget,
        unified_token_dispatch=args.unified_token_dispatch,
        lookahead_dispatch=args.lookahead_dispatch,
        # profile hook: one torch.profiler window over the first
        # profile_steps dispatching steps
        profile_dir=args.profile_dir or None,
        profile_steps=args.profile_steps or 8,
        sp_prefill_threshold=int(getattr(args, "sp_prefill_threshold", 0) or 0),
    )
    if args.spec_draft_model and cfg.spec_tokens <= 0:
        raise SystemExit("--spec-draft-model requires --spec-tokens > 0")
    tp, dp = int(getattr(args, "tp", 1) or 1), int(getattr(args, "dp", 1) or 1)
    world = RankWorld.start(args, device, dp, tp) if tp * dp > 1 else None
    try:
        return _build_on(args, cfg, card, device, world)
    except BaseException:
        if world is not None:
            world.close()
        raise


def _build_on(args, cfg, card, device, world):
    """The started engine of :func:`build_local_engine`, on ``world``'s mesh
    when there is one (each rank loads its slice of the checkpoint)."""
    import torch

    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineCore

    mesh = world.mesh if world is not None else None

    def load(path, quantize, sharded=True):
        t0 = time.perf_counter()
        if mesh is not None and sharded:
            from dynamo_tpu_torch.engine.follower import broadcast_model

            model = broadcast_model({"kind": "checkpoint", "path": path, "dtype": args.dtype,
                                     "quantize": quantize}, mesh, device)
            quantized = getattr(model, "quantized", False)
        else:
            model, quantized = load_any_checkpoint(path, args.dtype, device, quantize)
        log.info("loaded %s (%s, %d layers%s) on %s%s in %.1f s", path, type(model).__name__,
                 model.config.num_layers, ", int8 weights" if quantized else "", device,
                 f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "",
                 time.perf_counter() - t0)
        return model

    if mesh is not None:
        from dynamo_tpu_torch.utils.mesh import AXIS_DATA, AXIS_MODEL

        cfg.mesh_shape = (mesh.axis_size(AXIS_DATA), mesh.axis_size(AXIS_MODEL))
    model = load(args.model_path, args.quantize == "int8")
    # draft-model speculation: a small same-tokenizer model proposes, the
    # target verifies (engine/draft.py); loaded unquantised, as in the JAX
    # CLI, from any checkpoint format --model-path takes, and whole on rank
    # 0's device beside a sharded target (it takes part in no collective)
    draft = load(args.spec_draft_model, False, sharded=False) if args.spec_draft_model else None
    try:
        core = EngineCore(model, cfg, eos_token_ids=card.eos_token_ids or None, device=device,
                          draft=draft)
    except ValueError as e:  # an option the PyTorch engine refuses
        raise SystemExit(str(e)) from None
    engine = AsyncLLMEngine(core)
    engine.world = world
    return engine.start(), card


def attach_worker_publishers(runtime, engine, namespace: str) -> None:
    """Publish a serving engine's KV events and ForwardPassMetrics so a KV
    router sees this worker, and replicate its persistent tier through the
    coordinator.  ``runtime`` is the worker's ``DistributedRuntime`` (or
    anything with its ``.instance_id``, ``.coordinator`` and
    ``.on_shutdown``), whose shutdown stops the publishers.  Call it on the
    event loop.  A no-op for engines without a
    core (echo); pipeline (``._engine``) and decode-worker (``.engine``)
    wrappers are unwrapped until an EngineCore surfaces."""
    core = None
    seen = set()
    while engine is not None and id(engine) not in seen:
        seen.add(id(engine))
        core = getattr(engine, "core", None)
        if core is not None:
            break
        engine = getattr(engine, "_engine", None) or getattr(engine, "engine", None)
    if core is None or not hasattr(core, "block_manager"):
        return
    from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, KvMetricsPublisher

    wid = runtime.instance_id
    events = KvEventPublisher(runtime.coordinator, wid, namespace).start()
    core.block_manager.event_sink = events.sink
    metrics = KvMetricsPublisher(runtime.coordinator, wid, core.metrics, namespace).start()
    # both publishers' flush loops must die with the runtime
    runtime.on_shutdown(events.stop)
    runtime.on_shutdown(metrics.stop)
    # persistent tier replication: sync the content-addressed block store
    # with the coordinator index (boot-time pull = scale-up pre-warm;
    # periodic publish shares this worker's prefixes)
    store = getattr(core, "persist_store", None)
    if store is not None:
        from dynamo_tpu_torch.llm.kv.persist import PersistReplicator

        replicator = PersistReplicator(runtime.coordinator, store, namespace)
        replicator.start_soon()
        runtime.on_shutdown(replicator.stop)


def _shutdown(engine) -> None:
    if hasattr(engine, "shutdown"):
        engine.shutdown()
    world = getattr(engine, "world", None)
    if world is not None:  # stop the shard followers this run started
        engine.world = None
        world.close()


# ------------------------------------------------------------------- run ------


def _runtime_config(args):
    from dynamo_tpu_torch.runtime.config import RuntimeConfig

    kw = {}
    if args.coordinator:
        kw["coordinator_url"] = args.coordinator
    if args.namespace:
        kw["namespace"] = args.namespace
    return RuntimeConfig(**kw)


async def _until_signalled(engine=None) -> None:
    """Return on SIGINT or SIGTERM (a long-running command then stops
    cleanly, exit 0), or when ``engine`` (an engine on a mesh) stops after a
    fatal step error, which raises SystemExit(1)."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    if engine is not None and hasattr(engine, "on_fatal"):
        engine.on_fatal = lambda e: loop.call_soon_threadsafe(stop.set)
    await stop.wait()
    _raise_if_fatal(engine)


def _raise_if_fatal(engine) -> None:
    """Exit non-zero when ``engine`` stopped after a fatal step error (a
    broken mesh: a follower rank died)."""
    error = getattr(engine, "error", None)
    if error is not None:
        raise SystemExit(f"the engine stopped: {error!r}")


def _follow(args) -> None:
    """``run --nnodes N --node-rank R`` with R > 0: this host's ranks only
    follow rank 0 (``engine/follower.py``), each starting its followers."""
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engine.follower import Follower

    device = resolve_device(args.device)
    world = RankWorld.start(args, device, int(args.dp or 1), int(args.tp or 1))
    try:
        Follower(world.mesh, device).run()
    finally:
        world.close()


async def _cmd_run(args) -> None:
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.runtime import serde
    from dynamo_tpu_torch.runtime.protocols import parse_endpoint_url

    serde.register_llm_types()
    if int(getattr(args, "nnodes", 1) or 1) > 1 and int(getattr(args, "node_rank", 0) or 0) > 0:
        await asyncio.to_thread(_follow, args)  # rank 0's host serves; this one follows
        return
    if args.inp.startswith("dyn://") and args.out.startswith("dyn://"):
        raise SystemExit("in=dyn:// serves a local engine: out= must be gpu or echo")
    runtime = raw = None
    try:
        if args.out.startswith("dyn://") or args.inp.startswith("dyn://"):
            from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

            runtime = await DistributedRuntime.connect(_runtime_config(args))
        if args.model_path is not None and args.model_path.startswith("dyn://models/"):
            # pull on this loop, without blocking it (the runtime's lease
            # keepalive rides it): only the pushing host needs the files
            args.model_path = await _resolve_model(args)
        if args.out.startswith("dyn://"):
            # a remote worker: preprocess and detokenize here
            if args.model_path is None:
                raise SystemExit("out=dyn:// needs --model-path (the tokenizer and chat template)")
            card = model_card(args.model_path, args.model_name)
            ns, comp, ep = parse_endpoint_url(args.out)
            client = await runtime.namespace(ns).component(comp).endpoint(ep).client()
            engine = build_serving_pipeline(client, card)
        else:
            # off-loop: a model build (CUDA context, weights, engine start)
            # blocks for seconds, and on the loop it would hold back the
            # runtime's first lease keepalive until the lease had lapsed
            raw, card = await asyncio.to_thread(build_local_engine, args)
            engine = build_serving_pipeline(raw, card)
        model_name = args.model_name or card.name
        if args.inp.startswith("dyn://"):
            # worker mode: serve the engine (tokens in, tokens out) at the
            # endpoint; a frontend's pipeline preprocesses and detokenizes
            ns, comp, ep = parse_endpoint_url(args.inp)
            await runtime.namespace(ns).component(comp).endpoint(ep).serve(raw)
            attach_worker_publishers(runtime, raw, ns)
            log.info("serving %s at %s as instance %x — ctrl-c or SIGTERM to stop", model_name,
                     args.inp, runtime.instance_id)
            await _until_signalled(raw)
        elif args.inp == "http":
            from dynamo_tpu_torch.llm.http.service import HttpService

            svc = HttpService(host=args.host, port=args.http_port,
                              core=raw.core if args.out == "gpu" else None)
            svc.manager.add_model(model_name, engine, card)
            await svc.start()
            log.info("OpenAI server on %s:%s — ctrl-c or SIGTERM to stop", svc.host, svc.port)
            try:
                await _until_signalled(raw)
            finally:
                await svc.stop()
        elif args.inp.startswith("text:"):
            await _one_prompt(engine, model_name, args.inp[5:], args)
        elif args.inp == "stdin":
            for line in sys.stdin:
                line = line.strip()
                if line:
                    await _one_prompt(engine, model_name, line, args)
        elif args.inp.startswith("batch:"):
            await _batch(engine, model_name, Path(args.inp[6:]), args)
        else:
            raise SystemExit(f"unknown in={args.inp}")
        _raise_if_fatal(raw)
    finally:
        if runtime is not None:
            await runtime.shutdown()
        if raw is not None:
            _shutdown(raw)


async def _resolve_model(args) -> str:
    """``dyn://models/NAME`` pulled into the local cache, on this loop."""
    from dynamo_tpu_torch.llm.model_store import resolve_model
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient

    url = args.coordinator or os.environ.get("DYNTPU_COORDINATOR")
    if not url:
        raise SystemExit(f"--model-path {args.model_path}: needs --coordinator to pull from")
    coord = await CoordinatorClient(url).connect()
    try:
        path = await resolve_model(args.model_path, coord)
    finally:
        await coord.close()
    log.info("resolved %s -> %s", args.model_path, path)
    return path


async def _one_prompt(engine, model_name: str, prompt: str, args) -> None:
    from dynamo_tpu_torch.llm.openai import parse_request
    from dynamo_tpu_torch.runtime.engine import Context

    parsed = parse_request(
        {"model": model_name, "prompt": prompt, "max_tokens": args.max_tokens},
        chat=False,
    )
    async for out in engine.generate(Context(parsed)):
        if out.text:
            print(out.text, end="", flush=True)
    print()


async def _batch(engine, model_name: str, path: Path, args) -> None:
    """JSONL in ({"text": ...} per line) → JSONL out with tokens and timing
    beside the input file, and a summary line on stdout."""
    from dynamo_tpu_torch.llm.openai import parse_request
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(text: str) -> dict:
        parsed = parse_request(
            {"model": model_name, "prompt": text, "max_tokens": args.max_tokens},
            chat=False,
        )
        t0 = time.perf_counter()
        ttft, n_tokens, chunks = None, 0, []
        async for out in engine.generate(Context(parsed)):
            if ttft is None:
                ttft = time.perf_counter() - t0
            n_tokens += len(out.token_ids)
            if out.text:
                chunks.append(out.text)
        dt = time.perf_counter() - t0
        return {
            "text": "".join(chunks),
            "output_tokens": n_tokens,
            "ttft_s": round(ttft or 0.0, 4),
            "total_s": round(dt, 4),
        }

    lines = [json.loads(l) for l in path.read_text().splitlines() if l.strip()]
    results = await asyncio.gather(*(one(l["text"]) for l in lines))
    out_path = path.with_suffix(".out.jsonl")
    with open(out_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    total_tok = sum(r["output_tokens"] for r in results)
    total_s = max(r["total_s"] for r in results) if results else 0.0
    print(json.dumps({
        "requests": len(results),
        "output_tokens": total_tok,
        "tok_per_s": round(total_tok / total_s, 2) if total_s else 0.0,
        "results": str(out_path),
    }))


# ------------------------------------------------------- distributed runtime --


async def _cmd_coordinator(args) -> None:
    """Run the control/event/queue-plane coordinator."""
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorServer

    server = await CoordinatorServer(host=args.host, port=args.port,
                                     data_dir=args.data_dir).start()
    log.info("coordinator on %s (durable=%s)", server.url, bool(args.data_dir))
    try:
        await _until_signalled()
    finally:
        await server.stop()


async def _cmd_http(args) -> None:
    """Standalone OpenAI frontend: discovers the model records under
    ``{ns}/models/`` on the coordinator and serves each through a
    preprocessing pipeline around its worker endpoint's client."""
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.runtime import serde
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.protocols import parse_endpoint_url

    serde.register_llm_types()
    runtime = await DistributedRuntime.connect(_runtime_config(args))
    svc = HttpService(host=args.host, port=args.http_port)
    ns = args.namespace or "dynamo"
    # discovery-event tasks, retained so a failed add_model (bad entry,
    # unreachable endpoint) is logged instead of vanishing with the task
    add_tasks: set[asyncio.Task] = set()

    def _add_done(task: asyncio.Task) -> None:
        add_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            log.error("add_model failed", exc_info=task.exception())

    async def add_model(name: str, entry: dict) -> None:
        e_ns, comp, ep = parse_endpoint_url(entry["endpoint"])
        client = await runtime.namespace(e_ns).component(comp).endpoint(ep).client()
        card = (ModelDeploymentCard.from_hf_dir(entry["model_path"], name=name)
                if entry.get("model_path")
                else ModelDeploymentCard.from_dict(entry.get("card", {"name": name})))
        svc.manager.add_model(name, build_serving_pipeline(client, card), card)
        log.info("model %s -> %s", name, entry["endpoint"])

    def on_event(event: str, key: str, value) -> None:
        name = key.rsplit("/", 1)[-1]
        if event == "put":
            task = asyncio.ensure_future(add_model(name, value))
            add_tasks.add(task)
            task.add_done_callback(_add_done)
        elif event == "delete":
            svc.manager.remove_model(name)

    try:
        _, snapshot = await runtime.coordinator.watch(f"{ns}/{MODELS_PREFIX}", on_event)
        for key, value in snapshot.items():
            try:
                await add_model(key.rsplit("/", 1)[-1], value)
            except Exception:
                # one bad registration must not take down the whole frontend
                log.exception("add_model %s failed at startup", key)
        await svc.start()
        log.info("OpenAI frontend on %s:%s (namespace %s)", svc.host, svc.port, ns)
        try:
            await _until_signalled()
        finally:
            await svc.stop()
    finally:
        for task in list(add_tasks):
            task.cancel()
        await runtime.shutdown()


async def start_router_service(runtime, namespace: str = "default", block_size: int = 16,
                               workers_endpoint: Optional[str] = None):
    """Wire a live KvRouter behind ``dyn://{ns}.router.generate`` (shared by
    the ``router`` command and tests).  Returns the router.

    ``workers_endpoint`` ("component/endpoint", e.g. "backend/generate")
    watches that endpoint's discovery prefix so a dead worker's delete
    event evicts it from the router's candidate set immediately."""
    from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvRouterSubscriber
    from dynamo_tpu_torch.llm.kv_router.router import KvRouter

    workers_prefix = None
    if workers_endpoint:
        comp, _, ep = workers_endpoint.partition("/")
        workers_prefix = f"{namespace}/components/{comp}/endpoints/{ep or 'generate'}/"
    router = KvRouter(block_size=block_size)
    sub = await KvRouterSubscriber(router, runtime.coordinator, namespace,
                                   workers_prefix=workers_prefix).start()
    # the subscriber's tasks must die with the runtime
    runtime.on_shutdown(sub.stop)
    # KvRouter IS the endpoint engine: its generate() yields one
    # wire-serializable decision dict per request
    await runtime.namespace(namespace).component("router").endpoint("generate").serve(router)
    return router


async def _cmd_router(args) -> None:
    """Standalone KV-aware router service: serves routing decisions at
    ``dyn://{ns}.router.generate`` and keeps its prefix index and load
    view live off the coordinator's KV-event and metrics subjects."""
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    runtime = await DistributedRuntime.connect(_runtime_config(args))
    ns = args.namespace or "default"
    try:
        await start_router_service(runtime, ns, args.block_size,
                                   workers_endpoint=args.workers_endpoint)
        log.info("router service up: dyn://%s.router.generate", ns)
        await _until_signalled()
    finally:
        await runtime.shutdown()


async def _cmd_models(args) -> None:
    """Manage the model records on the coordinator that ``http``
    frontends discover, and push or pull model directories through its
    blob store."""
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient

    ns = args.namespace or "dynamo"
    coord = await CoordinatorClient(args.coordinator or "tcp://127.0.0.1:6180").connect()
    try:
        if args.action == "push":
            # model-artifact distribution through the blob store: remote
            # workers boot from dyn://models/NAME with the files on one host
            from dynamo_tpu_torch.llm.model_store import push_model

            if not args.name or not args.endpoint:
                raise SystemExit("usage: models push NAME MODEL_DIR")
            manifest = await push_model(coord, args.name, args.endpoint)
            total = sum(f["size"] for f in manifest["files"].values())
            print(f"pushed {args.name}: {len(manifest['files'])} files, "
                  f"{total} bytes, digest {manifest['digest'][:12]}")
        elif args.action == "pull":
            from dynamo_tpu_torch.llm.model_store import pull_model

            if not args.name:
                raise SystemExit("usage: models pull NAME [--out DIR]")
            print(await pull_model(coord, args.name, cache_dir=args.out))
        elif args.action == "add":
            if not args.name or not args.endpoint:
                raise SystemExit("usage: models add NAME dyn://NS.COMP.EP [--model-path DIR]")
            entry = {"endpoint": args.endpoint, "model_path": args.model_path}
            await coord.kv_put(f"{ns}/{MODELS_PREFIX}{args.name}", entry)
            print(f"added {args.name} -> {args.endpoint}")
        elif args.action == "remove":
            ok = await coord.kv_delete(f"{ns}/{MODELS_PREFIX}{args.name}")
            print(f"removed {args.name}" if ok else f"no such model {args.name}")
        else:  # list
            items = await coord.kv_get_prefix(f"{ns}/{MODELS_PREFIX}")
            for key, value in sorted(items.items()):
                print(f"{key.rsplit('/', 1)[-1]}\t{value.get('endpoint')}")
    finally:
        await coord.close()


async def _cmd_trace(args) -> None:
    """Fetch one request's Chrome trace-event JSON from a frontend's
    ``/debug/traces/{request_id}``.  The output loads in chrome://tracing
    and https://ui.perfetto.dev; the serving processes must run with
    tracing on (``--trace`` or ``DYNAMO_TRACE=1``)."""
    from aiohttp import ClientSession

    url = f"{args.url.rstrip('/')}/debug/traces/{args.request_id}"
    async with ClientSession() as s:
        async with s.get(url) as resp:
            body = await resp.text()
            if resp.status != 200:
                raise SystemExit(f"trace fetch failed ({resp.status}): {body}")
    if args.out:
        Path(args.out).write_text(body)
        print(args.out)
    else:
        print(body)


# --------------------------------------------------------------- quantize -----


async def _cmd_quantize(args) -> None:
    """Offline conversion: an HF directory or a GGUF file to a native
    checkpoint (int8 weights unless ``--scheme none``), with the
    tokenizer and config beside it so ``--model-path`` takes the result
    as it takes the source."""
    import shutil

    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.models.checkpoint import save_checkpoint
    from dynamo_tpu_torch.models.loader import load_model_dir

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"quantize: {e}") from None
    t0 = time.perf_counter()
    quantized = args.scheme == "int8"
    if args.src.endswith(".gguf"):
        from dynamo_tpu_torch.llm.gguf import load_gguf_model

        cfg, state = load_gguf_model(args.src, dtype=args.dtype, device=device,
                                     quantize=quantized)
    else:
        try:
            cfg, state = load_model_dir(args.src, dtype=args.dtype, device=device,
                                        quantize=quantized)
        except ValueError as e:  # a DeepSeek directory
            raise SystemExit(f"quantize: {e}") from None
    save_checkpoint(args.out, cfg, state, quantized=quantized)
    del state
    out, src = Path(args.out), Path(args.src)
    if src.is_dir():
        for name in ("tokenizer.json", "tokenizer_config.json", "config.json",
                     "generation_config.json", "special_tokens_map.json"):
            if (src / name).is_file():
                shutil.copy2(src / name, out / name)
    else:
        card = model_card(args.src)
        if card.tokenizer_path and Path(card.tokenizer_path).is_file():
            shutil.copy2(card.tokenizer_path, out / "tokenizer.json")
        else:
            log.warning("the GGUF file carried no tokenizer; place a tokenizer.json in %s "
                        "before serving", out)
        if card.chat_template:
            # from_hf_dir reads it, so chat rendering survives the conversion
            (out / "chat_template.jinja").write_text(card.chat_template)
        # the eos/bos ids and the context length the GGUF metadata carried
        (out / "config.json").write_text(json.dumps({
            "eos_token_id": card.eos_token_ids,
            "bos_token_id": card.bos_token_id,
            "max_position_embeddings": card.context_length,
        }))
    log.info("wrote %s (%s, scheme=%s) in %.1f s", out, cfg.dtype, args.scheme,
             time.perf_counter() - t0)


# ------------------------------------------------------------------ serve -----


async def _cmd_serve(args) -> None:
    """Run a graph under the supervisor until SIGINT/SIGTERM or until every
    worker has exited; then stop the workers (each drains) and exit
    non-zero if any of them did."""
    from dynamo_tpu_torch.sdk.config import ServiceConfig
    from dynamo_tpu_torch.sdk.serving import ServeSupervisor

    graph = args.graph
    if args.package:
        # packaged-graph deploy (the reference's bento flow): pull the
        # archive from the api-store, verify + unpack into the cache,
        # and serve its manifest entry with the package root importable
        # (sys.path for the supervisor's entry load, PYTHONPATH for the
        # worker processes it spawns)
        manifest, src_root = await _pull_package(args.package, args.api_store,
                                                 args.package_cache)
        graph = graph if graph not in (None, "-") else manifest["entry"]
        sys.path.insert(0, str(src_root))
        prev = os.environ.get("PYTHONPATH")
        # no trailing separator when PYTHONPATH was unset: an empty
        # component means cwd, which packaged deploys must not import
        os.environ["PYTHONPATH"] = f"{src_root}{os.pathsep}{prev}" if prev else str(src_root)
        log.info("serving package %s entry %s from %s", args.package, graph, src_root)
    elif graph in (None, "-"):
        raise SystemExit("serve needs GRAPH (module:EntryService) or --package NAME[:VER]")
    config = ServiceConfig.from_yaml(args.config) if args.config else ServiceConfig()
    sup = ServeSupervisor(graph, config, coordinator_url=args.coordinator)
    await sup.start()
    watch = asyncio.ensure_future(sup.watch())
    signalled = asyncio.ensure_future(_until_signalled())
    try:
        done, _ = await asyncio.wait({watch, signalled}, return_when=asyncio.FIRST_COMPLETED)
        if watch in done:
            watch.result()  # a supervisor fault surfaces here
    finally:
        for task in (watch, signalled):
            task.cancel()
        await asyncio.gather(watch, signalled, return_exceptions=True)
        codes = await sup.stop()
        log.info("serve: worker exit codes %s", json.dumps(codes))
    if any(codes.values()):
        raise SystemExit(f"serve: workers exited {codes}")


# ---------------------------------------------------------------- package -----


def _split_pkg_ref(ref: str) -> tuple[str, Optional[str]]:
    name, _, ver = ref.partition(":")
    return name, (ver or None)


async def _pull_package(ref: str, api_store: str, cache_root: str):
    """Resolve name[:version], reuse the local cache when it already
    holds that version, else download + unpack.  Returns (manifest,
    src_root)."""
    from aiohttp import ClientSession

    from dynamo_tpu_torch.deploy.packaging import cache_lookup, cached_unpack

    name, ver = _split_pkg_ref(ref)
    async with ClientSession() as s:
        if ver is None:
            # cheap metadata GET resolves "latest" BEFORE any archive
            # transfer, so a cache hit skips the download entirely
            async with s.get(f"{api_store}/api/v1/packages/{name}/latest") as resp:
                if resp.status == 404:
                    raise SystemExit(f"package {ref!r} not found in {api_store}")
                resp.raise_for_status()
                ver = str((await resp.json())["version"])
        version = int(ver)
        hit = cache_lookup(cache_root, name, version)
        if hit is not None:
            return hit
        url = f"{api_store}/api/v1/packages/{name}/{version}/archive"
        async with s.get(url) as resp:
            if resp.status == 404:
                raise SystemExit(f"package {ref!r} not found in {api_store}")
            resp.raise_for_status()
            archive = await resp.read()
    return cached_unpack(archive, cache_root, name, version)


async def _cmd_package(args) -> None:
    from dynamo_tpu_torch.deploy.packaging import build_package, read_manifest

    if args.pkg_cmd == "build":
        manifest = build_package(args.src, args.entry, args.name, args.out)
        print(json.dumps({"name": manifest["name"], "entry": manifest["entry"],
                          "files": len(manifest["files"]), "out": args.out}))
    elif args.pkg_cmd == "push":
        from aiohttp import ClientSession

        data = Path(args.pkg).read_bytes()
        read_manifest(data)  # fail client-side with a good message
        async with ClientSession() as s:
            async with s.post(f"{args.api_store}/api/v1/packages", data=data) as resp:
                body = await resp.text()
                if resp.status != 201:
                    raise SystemExit(f"push failed ({resp.status}): {body}")
                print(body)
    elif args.pkg_cmd == "pull":
        manifest, src_root = await _pull_package(args.ref, args.api_store, args.out)
        print(json.dumps({"name": manifest["name"], "entry": manifest["entry"],
                          "src": str(src_root)}))
    elif args.pkg_cmd == "list":
        from aiohttp import ClientSession

        async with ClientSession() as s:
            async with s.get(f"{args.api_store}/api/v1/packages") as resp:
                resp.raise_for_status()
                print(json.dumps(await resp.json()))


# ------------------------------------------------------- control-plane parts --


async def _coordinator_client(args):
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient

    return await CoordinatorClient(args.coordinator or "tcp://127.0.0.1:6180").connect()


async def _cmd_operator(args) -> None:
    """Reconcile a watched directory of DynamoTpuDeployment specs and/or the
    DynamoTpuDeployment custom resources (``--crd``) into a cluster."""
    from dynamo_tpu_torch.deploy.operator import (KubectlCluster, KubectlCrSource,
                                                  MemoryCluster, Operator)
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient

    if not args.specs_dir and not args.crd:
        raise SystemExit("operator needs a specs dir and/or --crd")
    cluster = MemoryCluster() if args.dry_run else KubectlCluster(context=args.context)
    coord = None
    if args.coordinator:
        coord = await CoordinatorClient(args.coordinator, reconnect=True).connect()
    cr_source = (KubectlCrSource(context=args.context, read_only=args.dry_run)
                 if args.crd else None)
    op = Operator(cluster, interval_s=args.interval, watch_dir=args.specs_dir,
                  coordinator=coord, cr_source=cr_source)
    if args.specs_dir:
        op.load_dir(args.specs_dir)
    log.info("operator watching %s (crd=%s, %d specs, dry_run=%s, coordinator=%s)",
             args.specs_dir, args.crd, len(op.specs), args.dry_run, args.coordinator)
    op.start()
    try:
        await _until_signalled()
    finally:
        await op.stop()
        if coord is not None:
            await coord.close()


async def _cmd_deploy(args) -> None:
    """Render the k8s manifests of a DynamoTpuDeployment spec: one YAML file
    per object under ``--out``, or every object on stdout."""
    import yaml

    from dynamo_tpu_torch.deploy.renderer import (DeploymentSpec, render_manifests,
                                                  render_to_dir)

    try:
        spec = DeploymentSpec.from_yaml(Path(args.spec))
    except (KeyError, TypeError, ValueError) as e:
        raise SystemExit(f"deploy: {args.spec}: {e}") from None
    if args.out:
        for path in render_to_dir(spec, args.out):
            print(path)
    else:
        print(yaml.safe_dump_all(render_manifests(spec), sort_keys=False))


async def _cmd_api_store(args) -> None:
    """The versioned graph and package registry, with manifest rendering."""
    from dynamo_tpu_torch.components.api_store import ApiStore

    store = await ApiStore(db_path=args.db, host=args.host, port=args.port).start()
    log.info("api-store on http://%s:%s (db %s)", store.host, store.port, args.db)
    try:
        await _until_signalled()
    finally:
        await store.stop()


async def _cmd_metrics(args) -> None:
    """Prometheus ``/metrics`` fed by the workers' ForwardPassMetrics and the
    router's ``kv_hit_rate`` events (``--push-url``: push mode)."""
    from dynamo_tpu_torch.components.metrics import MetricsService

    coord = await _coordinator_client(args)
    try:
        svc = await MetricsService(coord, namespace=args.namespace or "dynamo", host=args.host,
                                   port=args.port, push_url=args.push_url).start()
        log.info("metrics on http://%s:%s/metrics", svc.host, svc.port)
        try:
            await _until_signalled()
        finally:
            await svc.stop()
    finally:
        await coord.close()


async def _cmd_planner(args) -> None:
    """The planner loop over the live metrics plane: a per-tick plan (replica
    targets, role flips) from pool saturation and the prefill queue, logged
    (``LogActuator``); a scale-up also publishes the persist pre-warm hint,
    so fresh workers pull the shared KV store at boot."""
    from dynamo_tpu_torch.llm.kv.persist import PrewarmActuator
    from dynamo_tpu_torch.planner import LogActuator, PlannerConfig, PlannerLoop

    coord = await _coordinator_client(args)
    ns = args.namespace or "dynamo"
    try:
        loop = await PlannerLoop(
            coord, namespace=ns,
            config=PlannerConfig(queue_target_per_replica=args.target_per_replica,
                                 decode_target_usage=args.target_usage),
            prefill_component=args.prefill_component, decode_component=args.decode_component,
            interval_s=args.interval,
            actuators=(LogActuator(), PrewarmActuator(coord, ns))).start()
        log.info("planner loop on namespace %r", loop.namespace)
        try:
            await _until_signalled()
        finally:
            await loop.stop()
    finally:
        await coord.close()


async def _cmd_mock_worker(args) -> None:
    """GPU-free fake workers publishing metrics and KV events, for driving
    the router and metrics stack."""
    from dynamo_tpu_torch.components.mock_worker import MockWorker

    coord = await _coordinator_client(args)
    workers = []
    try:
        for i in range(args.count):
            workers.append(await MockWorker(coord, worker_id=args.worker_id + i,
                                            namespace=args.namespace or "dynamo").start())
        log.info("%d mock worker(s) publishing", len(workers))
        await _until_signalled()
    finally:
        for w in workers:
            await w.stop()
        await coord.close()


# ------------------------------------------------------------------ parser ----


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--coordinator", default=None, help="tcp://host:port")
        sp.add_argument("--namespace", default=None)

    run = sub.add_parser("run", help="serve a checkpoint or answer prompts")
    run.add_argument("inout", nargs="+", help="in=<http|text:PROMPT|stdin|batch:FILE|"
                     "dyn://NS.COMP.EP> out=<gpu|echo|dyn://NS.COMP.EP>")
    run.add_argument("--model-path", default=None, help="native checkpoint dir, .gguf file, "
                     "HuggingFace checkpoint directory, or dyn://models/NAME")
    run.add_argument("--model-name", default=None, help="served name (default: the "
                     "directory's name)")
    run.add_argument("--device", default=None,
                     help="torch device for out=gpu (default: the current CUDA device; "
                     "'cpu' runs the plain PyTorch path, for tests)")
    run.add_argument("--dtype", default=None, help="weight and activation dtype "
                     "(default bfloat16)")
    run.add_argument("--max-batch-size", type=int, default=8)
    run.add_argument("--max-model-len", type=int, default=4096)
    run.add_argument("--block-size", type=int, default=16)
    run.add_argument("--num-blocks", type=int, default=512)
    run.add_argument("--num-host-blocks", type=int, default=0,
                     help="host-RAM KV offload tier (0 = disabled): "
                     "evicted device blocks park in host memory and "
                     "restore on prefix re-arrival")
    run.add_argument("--kv-persist-dir", default=None,
                     help="persistent prefix-cache tier (default off): "
                     "directory for the content-addressed KV block store "
                     "(llm/kv/persist.py).  Host-published blocks spill "
                     "here; restarts and coordinator-replicated peers "
                     "restore warm prefixes as cached_tokens.  Requires "
                     "--num-host-blocks > 0")
    run.add_argument("--kv-persist-max-bytes", type=int, default=0,
                     help="size cap for --kv-persist-dir (LRU by "
                     "last-touch; 0 = unbounded)")
    run.add_argument("--kv-persist-ttl", type=float, default=0,
                     help="TTL in seconds for persisted block groups "
                     "since last touch (0 = no expiry)")
    run.add_argument("--kv-cache-dtype", choices=["model", "int8"], default="model",
                     help="int8 = quantised KV cache (ops/kv_quant.py)")
    run.add_argument("--quantize", choices=["none", "int8"], default="none",
                     help="int8 weight-only quantisation, done layer by layer at load")
    run.add_argument("--prefill-chunk-tokens", type=int, default=0,
                     help="max prompt tokens per prefill dispatch (0 = whole remainder)")
    run.add_argument("--prefill-token-budget", type=int, default=0,
                     help="pack up to this many tokens of several prompts' chunks into "
                     "one ragged dispatch (0 = one request per dispatch)")
    run.add_argument("--unified-token-dispatch", action="store_true",
                     help="one mixed prefill+decode ragged dispatch per turn when both "
                     "phases have work")
    run.add_argument("--lookahead-dispatch", action="store_true",
                     help="fuse mixed turns into bursts with one result read, and "
                     "prebuild the next turn while the card computes (implies "
                     "--unified-token-dispatch)")
    run.add_argument("--spec-tokens", type=int, default=0,
                     help="speculative decoding: verify up to N proposed "
                     "tokens per dispatch (rejection-sampled — exact at "
                     "any temperature); proposals come from prompt-lookup "
                     "n-grams, or a draft model with --spec-draft-model")
    run.add_argument("--spec-draft-model", default=None,
                     help="small same-tokenizer model dir: draft-model "
                     "speculation instead of n-gram lookup")
    run.add_argument("--spec-draft-num-blocks", type=int, default=0,
                     help="draft cache block count (0 = same as "
                     "--num-blocks; shrink on HBM-tight deployments)")
    run.add_argument("--tp", type=int, default=1,
                     help="tensor-parallel size: the model's heads, MLP and vocab split over "
                     "this many ranks (one process each; run starts the others)")
    run.add_argument("--dp", type=int, default=1, help="data-parallel size (the mesh's data "
                     "axis; its ranks hold the same slices, and split long prompts with "
                     "--sp-prefill-threshold)")
    run.add_argument("--sp-prefill-threshold", type=int, default=0,
                     help="prompts at least this long prefill in one dispatch with the "
                     "sequence split over the mesh data axis (ring attention); 0 = off, "
                     "needs --dp > 1")
    run.add_argument("--nnodes", type=int, default=1,
                     help="hosts whose ranks form ONE mesh (each runs this command with its "
                     "--node-rank; they join through --coordinator)")
    run.add_argument("--node-rank", type=int, default=0)
    run.add_argument("--max-tokens", type=int, default=128,
                     help="tokens per answer for in=text:, stdin and batch:")
    run.add_argument("--host", default="127.0.0.1")
    run.add_argument("--http-port", type=int, default=8080)
    run.add_argument("--trace", action="store_true",
                     help="turn the tracing plane on (same as DYNAMO_TRACE=1): per-request "
                     "spans, exported as Chrome trace JSON at /debug/traces/{request_id}")
    run.add_argument("--profile-dir", default=None,
                     help="wrap the engine's first --profile-steps dispatching steps in one "
                     "torch.profiler window written under this directory (keyed by first "
                     "step id)")
    run.add_argument("--profile-steps", type=int, default=8)
    common(run)

    http = sub.add_parser("http", help="standalone OpenAI frontend with discovery")
    http.add_argument("--host", default="127.0.0.1")
    http.add_argument("--http-port", type=int, default=8080)
    common(http)

    coord = sub.add_parser("coordinator", help="run the coordinator service")
    coord.add_argument("--host", default="0.0.0.0")
    coord.add_argument("--port", type=int, default=6180)
    coord.add_argument("--data-dir", default=None,
                       help="WAL directory: KV + queues survive restarts")

    router = sub.add_parser("router", help="standalone KV-aware router service")
    router.add_argument("--block-size", type=int, default=16)
    router.add_argument("--workers-endpoint", default="backend/generate",
                        help="component/endpoint whose discovery deletes evict workers "
                        "from the router")
    common(router)

    models = sub.add_parser("models", help="manage model registrations and model files")
    models.add_argument("action", choices=["add", "list", "remove", "push", "pull"])
    models.add_argument("name", nargs="?")
    models.add_argument("endpoint", nargs="?",
                        help="dyn://ns.component.endpoint (add) | model dir (push)")
    models.add_argument("--model-path", default=None)
    models.add_argument("--out", default=None, help="pull: cache directory override")
    common(models)

    quant = sub.add_parser("quantize", help="convert an HF directory or GGUF file to a native "
                           "checkpoint (int8 weights by default), so engines start without "
                           "the per-start load and quantisation")
    quant.add_argument("src", help="HF model dir or .gguf file")
    quant.add_argument("out", help="output checkpoint dir")
    quant.add_argument("--scheme", choices=["int8", "none"], default="int8",
                       help="none = convert and stack the weights, no quantisation")
    quant.add_argument("--dtype", default="bfloat16")
    quant.add_argument("--device", default=None,
                       help="torch device to convert on (default: the current CUDA device; "
                       "'cpu' for tests)")

    trace = sub.add_parser("trace", help="fetch one request's Chrome trace-event JSON from a "
                           "frontend's /debug/traces endpoint (server must run with --trace "
                           "or DYNAMO_TRACE=1)")
    trace.add_argument("request_id", help="response id or the caller's x-request-id")
    trace.add_argument("--url", default="http://127.0.0.1:8080", help="frontend base URL")
    trace.add_argument("-o", "--out", default=None,
                       help="write the JSON here instead of stdout")

    from dynamo_tpu_torch.analysis.cli import configure_parser as _lint_parser

    _lint_parser(sub.add_parser(
        "lint", help="the analysis planes: the source rules (bare, --project), the protocol "
        "plane (--proto) and the scale-simulation plane (--load); exit 1 on non-accepted "
        "findings"))

    serve = sub.add_parser("serve", help="serve a graph of @service components, one process "
                           "per service worker")
    serve.add_argument("graph", nargs="?", default="-",
                       help="module.path:EntryService (optional with --package: defaults to "
                       "the manifest entry)")
    serve.add_argument("-f", "--config", default=None, help="YAML ServiceConfig")
    serve.add_argument("--package", default=None, metavar="NAME[:VER]",
                       help="serve a packaged graph pulled from the api-store")
    serve.add_argument("--api-store", default=API_STORE, dest="api_store")
    serve.add_argument("--package-cache", default=str(PACKAGE_CACHE), dest="package_cache")
    common(serve)

    pkg = sub.add_parser("package", help="build/push/pull packaged serving graphs")
    pkg_sub = pkg.add_subparsers(dest="pkg_cmd", required=True)
    pb = pkg_sub.add_parser("build", help="archive a graph source tree")
    pb.add_argument("src", help="directory of graph sources")
    pb.add_argument("--entry", required=True, help="module:Service relative to the package root")
    pb.add_argument("--name", required=True)
    pb.add_argument("-o", "--out", required=True, help="output .tar.gz")
    pp = pkg_sub.add_parser("push", help="upload a package to the api-store")
    pp.add_argument("pkg", help="package .tar.gz")
    pp.add_argument("--api-store", default=API_STORE, dest="api_store")
    pl = pkg_sub.add_parser("pull", help="download + unpack a package")
    pl.add_argument("ref", help="name[:version]")
    pl.add_argument("--api-store", default=API_STORE, dest="api_store")
    pl.add_argument("-o", "--out", default=str(PACKAGE_CACHE))
    pls = pkg_sub.add_parser("list", help="list packages in the api-store")
    pls.add_argument("--api-store", default=API_STORE, dest="api_store")

    deploy = sub.add_parser("deploy", help="render k8s manifests from a deployment spec")
    deploy.add_argument("spec", help="DynamoTpuDeployment YAML")
    deploy.add_argument("-o", "--out", default=None, help="write one file per object")

    operator = sub.add_parser("operator", help="watch a specs dir and reconcile deployments")
    operator.add_argument("specs_dir", nargs="?", default=None,
                          help="directory of DynamoTpuDeployment YAMLs")
    operator.add_argument("--crd", action="store_true",
                          help="watch DynamoTpuDeployment custom resources and write .status "
                          "back via the status subresource")
    operator.add_argument("--interval", type=float, default=5.0)
    operator.add_argument("--context", default=None, help="kubectl context")
    operator.add_argument("--dry-run", action="store_true",
                          help="reconcile against an in-memory cluster")
    operator.add_argument("--coordinator", default=None,
                          help="coordinator URL: enables phases from live registrations and "
                          "autoscaling")

    store = sub.add_parser("api-store", help="versioned graph registry service")
    store.add_argument("--db", default="graphs.db")
    store.add_argument("--host", default="127.0.0.1")
    store.add_argument("--port", type=int, default=7180)

    metrics = sub.add_parser("metrics", help="metrics aggregation service (Prometheus)")
    metrics.add_argument("--host", default="127.0.0.1")
    metrics.add_argument("--port", type=int, default=9091)
    metrics.add_argument("--push-url", default=None, help="pushgateway URL (push mode)")
    common(metrics)

    planner = sub.add_parser("planner", help="planner loop (replica targets + role flips)")
    planner.add_argument("--interval", type=float, default=2.0)
    planner.add_argument("--prefill-component", default="prefill")
    planner.add_argument("--decode-component", default="decode")
    planner.add_argument("--target-per-replica", type=int, default=4,
                         help="prefill queue depth one replica absorbs")
    planner.add_argument("--target-usage", type=float, default=0.7,
                         help="decode saturation target")
    common(planner)

    mock = sub.add_parser("mock-worker", help="fake worker publishing metrics/KV events")
    mock.add_argument("--worker-id", type=int, default=1)
    mock.add_argument("--count", type=int, default=1)
    common(mock)
    return p


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    """The parsed command line; for ``run``, with ``in=``/``out=`` as
    ``inp``/``out``."""
    args = _parser().parse_args(argv)
    if args.cmd == "run":
        kv = dict(item.split("=", 1) for item in args.inout if "=" in item)
        if "in" not in kv or "out" not in kv:
            raise SystemExit("run needs in=<...> and out=<...>")
        args.inp, args.out = kv["in"], kv["out"]
    return args


_COMMANDS = {"run": _cmd_run, "http": _cmd_http, "coordinator": _cmd_coordinator,
             "router": _cmd_router, "models": _cmd_models, "trace": _cmd_trace,
             "quantize": _cmd_quantize, "serve": _cmd_serve, "package": _cmd_package,
             "deploy": _cmd_deploy, "operator": _cmd_operator, "api-store": _cmd_api_store,
             "metrics": _cmd_metrics, "planner": _cmd_planner, "mock-worker": _cmd_mock_worker}


def main(argv: Optional[list[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = parse_args(argv)
    if args.cmd == "lint":
        # synchronous: the protocol and load planes run their own deterministic loops
        from dynamo_tpu_torch.analysis.cli import run_lint

        raise SystemExit(run_lint(args))
    if getattr(args, "trace", False) is True:
        from dynamo_tpu_torch.obs import tracing

        tracing.enable(True)
    asyncio.run(_COMMANDS[args.cmd](args))


if __name__ == "__main__":
    main()
