"""The port's example serving graphs (``dynamo_tpu_torch/examples/llm``)
against the JAX package's (``examples/llm``), on one tiny f32 checkpoint.

Each graph is served in process by its package's ``serve_graph`` (the JAX
graph with ``engine: tpu``, the port's with ``engine: gpu`` and ``device:
cpu``, both with the Processor's ``tokenizer:`` set) and answers the same
greedy requests one at a time through its Frontend's HTTP service: token-id
and text completions, a chat, and a streamed completion.  The bodies must
be equal apart from ``id`` and ``created``, and equal to the port's agg
graph's.  The disagg graphs run with ``max-local-prefill-length: 0`` (every
prompt prefilled remotely) and with a threshold that splits the prompts;
the prefill worker must have handled as many prompts in both packages.  In
the colocated graph every handoff is an on-card (here in-process) write,
none over TCP.  The port's ``serve`` command runs the disagg graph as four
processes and answers as the in-process graph does.  The Frontend builds
an admission controller from an ``admission:`` block and sheds over its
rate, and the GpuWorker serves a ``dyn://models/`` path pulled from the
coordinator as the directory itself serves.  The refusals (``tp: 2``,
``sp-prefill-threshold``, a ``gpu`` engine with no device on a machine
without a GPU) raise by name, and ``hello_world.py`` prints ``HELLO
WORLD!``.
"""

import asyncio
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml
from aiohttp import ClientSession

import dynamo_tpu.llm.kv.transfer as jtransfer
import dynamo_tpu_torch
import dynamo_tpu_torch.llm.kv.transfer as ttransfer
from dynamo_tpu.runtime.config import RuntimeConfig as JRuntimeConfig
from dynamo_tpu.runtime.transports.coordinator import CoordinatorServer as JCoordinatorServer
from dynamo_tpu.sdk import ServiceConfig as JServiceConfig
from dynamo_tpu.sdk import serve_graph as jserve_graph
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorServer
from dynamo_tpu_torch.sdk import ServiceConfig, serve_graph
from tests.conftest import make_tiny_hf_checkpoint

REPO = Path(__file__).resolve().parent.parent
# the port's package name, never spelled in a string here (the metrics lint
# reads strings starting with the JAX package's prefix as scraped metrics)
PKG = dynamo_tpu_torch.__name__
GRAPHS = f"{PKG}.examples.llm.graphs"
MAX_TOKENS = 6
SPLIT = 24  # the splitting max-local-prefill-length

# (path, body): distinct first blocks, so no prompt hits another's cache
REQUESTS = [
    ("/v1/completions", {"prompt": list(range(1, 20))}),
    ("/v1/completions", {"prompt": list(range(30, 70))}),
    ("/v1/completions", {"prompt": "hello world w3 w5"}),
    ("/v1/completions", {"prompt": " ".join(f"w{i}" for i in range(80, 120))}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "w7 hello w9"}]}),
    ("/v1/completions", {"prompt": list(range(90, 120)), "stream": True}),
]

ENGINE = {"max-batch-size": 4, "max-model-len": 128, "block-size": 16, "num-blocks": 64}
# graph -> (module's last name, config overrides for both packages, worker key)
CASES = {
    "agg": ("agg", {}),
    "agg_router": ("agg_router", {"Processor": {"router": "kv"}}),
    "disagg_remote": ("disagg", {"Worker": {"remote-prefill": True,
                                            "max-local-prefill-length": 0}}),
    "disagg_split": ("disagg", {"Worker": {"remote-prefill": True,
                                           "max-local-prefill-length": SPLIT}}),
    "disagg_router": ("disagg_router", {"Processor": {"router": "kv"},
                                        "Worker": {"remote-prefill": True,
                                                   "max-local-prefill-length": SPLIT}}),
    "disagg_colocated": ("disagg_colocated", {"ColocatedWorker": {
        "max-local-prefill-length": 0}}),
}


def remote_prefills(case: str, model_dir: Path):
    """How many of REQUESTS the case's prefill worker takes: the prompts
    longer than its threshold, as the Frontend and Processor tokenize them;
    None for a graph with no prefill worker."""
    from dynamo_tpu_torch.examples.llm.components.frontend import processor_request
    from dynamo_tpu_torch.examples.llm.components.processor import worker_payload
    from dynamo_tpu_torch.llm.openai import parse_request
    from dynamo_tpu_torch.llm.preprocessor import PromptFormatter
    from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper

    blocks = [b for b in CASES[case][1].values() if "max-local-prefill-length" in b]
    if not blocks:
        return None
    tok, fmt = TokenizerWrapper.from_file(model_dir), PromptFormatter(None)
    lens = [len(worker_payload(processor_request(
        parse_request({"model": "tiny", **body}, chat="chat" in path), fmt), tok)["token_ids"])
        for path, body in REQUESTS]
    return sum(n > blocks[0]["max-local-prefill-length"] for n in lens)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs") / "hf"
    make_tiny_hf_checkpoint(d)
    return d


def graph_config(pkg: str, case: str, model_dir: Path) -> dict:
    """One graph's ServiceConfig data for ``pkg`` ("jax" or "port")."""
    if pkg == "jax":
        worker_name, engine = "TpuWorker", {"engine": "tpu"}
    else:
        worker_name, engine = "GpuWorker", {"engine": "gpu", "device": "cpu"}
    block = {**engine, "model-path": str(model_dir), "dtype": "float32", **ENGINE}
    cfg = {
        "Frontend": {"served_model_name": "tiny", "port": 0},
        "Processor": {"tokenizer": str(model_dir / "tokenizer.json")},
        "Router": {"block-size": ENGINE["block-size"]},
        worker_name: dict(block),
        "PrefillWorker": dict(block),
        "ColocatedWorker": dict(block),
    }
    for svc, over in CASES[case][1].items():
        cfg[worker_name if svc == "Worker" else svc].update(over)
    return cfg


def _strip(body):
    """A response body without its per-request ``id`` and ``created``."""
    if isinstance(body, list):
        return [_strip(e) for e in body]
    if isinstance(body, dict):
        return {k: v for k, v in body.items() if k not in ("id", "created")}
    return body


async def post_all(port: int, requests=REQUESTS) -> list:
    """The requests one at a time; a streamed answer is its list of SSE
    events."""
    out = []
    async with ClientSession() as s:
        for path, body in requests:
            req = {"model": "tiny", "max_tokens": MAX_TOKENS, "temperature": 0, **body}
            async with s.post(f"http://127.0.0.1:{port}{path}", json=req) as r:
                assert r.status == 200, await r.text()
                if body.get("stream"):
                    text = await r.text()
                    out.append([json.loads(ln[6:]) for ln in text.splitlines()
                                if ln.startswith("data: ") and ln != "data: [DONE]"])
                else:
                    out.append(await r.json())
    return out


async def _served(pkg: str, case: str, model_dir: Path) -> dict:
    """Serve one graph in process, answer REQUESTS, stop it."""
    root = "examples.llm.graphs" if pkg == "jax" else GRAPHS
    mod = f"{root}.{CASES[case][0]}"
    entry = importlib.import_module(mod).Frontend
    stats = jtransfer.stats if pkg == "jax" else ttransfer.stats
    before = dict(stats)
    if pkg == "jax":
        srv = await JCoordinatorServer(port=0).start()
        handle = await jserve_graph(entry, JServiceConfig(graph_config(pkg, case, model_dir)),
                                    JRuntimeConfig(coordinator_url=srv.url), graph=mod)
    else:
        srv = await CoordinatorServer(port=0).start()
        handle = await serve_graph(entry, ServiceConfig(graph_config(pkg, case, model_dir)),
                                   RuntimeConfig(coordinator_url=srv.url), graph=mod)
    try:
        bodies = await post_all(handle.instances["Frontend"].port)
        prefill = handle.instances.get("PrefillWorker") or handle.instances.get(
            "ColocatedWorker")
        handled = None
        if prefill is not None:
            loop = prefill.worker if hasattr(prefill, "worker") else prefill.prefill
            # handled counts after the queue ack, which trails the notify
            # that let the answer through: wait for the last one
            for _ in range(200):
                if loop.handled >= remote_prefills(case, model_dir):
                    break
                await asyncio.sleep(0.02)
            handled = loop.handled
    finally:
        await handle.stop()
        await srv.stop()
    moved = {k: stats[k] - before[k] for k in stats}
    return dict(bodies=bodies, handled=handled, moved=moved)


@pytest.fixture(scope="module")
def served(model_dir):
    """Each case served by each package, once per module."""
    cache = {}

    def get(pkg: str, case: str) -> dict:
        if (pkg, case) not in cache:
            cache[pkg, case] = run(_served(pkg, case, model_dir))
        return cache[pkg, case]

    return get


@pytest.fixture(params=list(CASES))
def case(request, served):
    """(case, the JAX graph's readings, the port's, the port agg graph's)."""
    name = request.param
    return name, served("jax", name), served("port", name), served("port", "agg")


def test_graph_answers_equal_jax(model_dir, case):
    case, jax_, port, agg = case
    assert _strip(port["bodies"]) == _strip(jax_["bodies"])
    first = port["bodies"][0]["choices"][0]
    assert first["finish_reason"] == "length" and first["text"]
    assert port["bodies"][0]["usage"]["completion_tokens"] == MAX_TOKENS
    # the same tokens as the port's aggregated graph
    assert _strip(port["bodies"]) == _strip(agg["bodies"])
    assert port["handled"] == jax_["handled"] == remote_prefills(case, model_dir)
    if case == "disagg_colocated":
        # every handoff an in-process device write, none over TCP
        assert port["moved"]["local_write_calls"] == len(REQUESTS)
        assert port["moved"]["tcp_write_calls"] == 0


# ---------------------------------------------------------- tiny engine ----


# the token-id requests: the tiny engine's model has no checkpoint
TOKEN_REQUESTS = [r for r in REQUESTS if isinstance(r[1].get("prompt"), list)]


@pytest.fixture(scope="module")
def tiny_tokenizer(tmp_path_factory):
    """A word-level tokenizer over ModelConfig.tiny()'s 256 ids."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    tk = Tokenizer(models.WordLevel(vocab={f"w{i}": i for i in range(256)}, unk_token="w0"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    path = tmp_path_factory.mktemp("tiny") / "tokenizer.json"
    tk.save(str(path))
    return path


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_tiny_engine_graphs(tiny_tokenizer, quantize):
    """``engine: tiny``: ``ModelConfig.tiny()`` with weights from a seeded
    generator, no checkpoint.  The agg graph and the disagg graph with
    every prompt prefilled remotely give the same texts, so the decode and
    the prefill worker drew the same weights, and the prefill worker
    handled every prompt."""
    block = {"engine": "tiny", "device": "cpu", "quantize": quantize, **ENGINE}

    async def serve(graph: str, worker: dict):
        mod = f"{GRAPHS}.{graph}"
        cfg = {"Frontend": {"served_model_name": "tiny", "port": 0},
               "Processor": {"tokenizer": str(tiny_tokenizer)},
               "GpuWorker": {**block, **worker}, "PrefillWorker": dict(block)}
        srv = await CoordinatorServer(port=0).start()
        handle = await serve_graph(importlib.import_module(mod).Frontend, ServiceConfig(cfg),
                                   RuntimeConfig(coordinator_url=srv.url), graph=mod)
        try:
            bodies = await post_all(handle.instances["Frontend"].port, TOKEN_REQUESTS)
            prefill = handle.instances.get("PrefillWorker")
            if prefill is not None:
                for _ in range(200):  # handled counts after the queue ack
                    if prefill.worker.handled >= len(TOKEN_REQUESTS):
                        break
                    await asyncio.sleep(0.02)
            return bodies, prefill.worker.handled if prefill is not None else None
        finally:
            await handle.stop()
            await srv.stop()

    agg, _ = run(serve("agg", {}))
    disagg, handled = run(serve("disagg", {"remote-prefill": True,
                                           "max-local-prefill-length": 0}))
    assert agg[0]["usage"]["completion_tokens"] == MAX_TOKENS
    assert agg[0]["choices"][0]["finish_reason"] == "length"
    assert all(b["choices"][0]["text"] for b in agg[:2])
    assert _strip(disagg) == _strip(agg)
    assert handled == len(TOKEN_REQUESTS)


# ------------------------------------------------------------- refusals ----


ECHO = {"Frontend": {"served_model_name": "tiny", "port": 0},
        "GpuWorker": {"engine": "echo"}}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("service,keys,error,match", [
    # the mesh keys serve on the gpu engine only (a checkpoint); echo refuses them
    ("GpuWorker", {"tp": 2}, ValueError, r"\{'tp': 2\}.*needs the gpu engine"),
    ("GpuWorker", {"sp-prefill-threshold": 512}, ValueError, "needs the gpu engine"),
    ("GpuWorker", {"engine": "gpu", "model-path": "MODEL"}, SystemExit, "no CUDA device"),
], ids=["tp", "sp-prefill", "no-gpu"])
def test_refusals(no_cuda, model_dir, service, keys, error, match):
    cfg = json.loads(json.dumps(ECHO))
    cfg[service].update({k: (str(model_dir) if v == "MODEL" else v) for k, v in keys.items()})
    mod = f"{GRAPHS}.agg"

    async def go():
        srv = await CoordinatorServer(port=0).start()
        try:
            with pytest.raises(error, match=match):
                await serve_graph(importlib.import_module(mod).Frontend, ServiceConfig(cfg),
                                  RuntimeConfig(coordinator_url=srv.url), graph=mod)
        finally:
            await srv.stop()

    run(go())


@pytest.mark.parametrize("feature", ["admission", "dyn-models"])
def test_admission_and_model_store(served, model_dir, tmp_path, monkeypatch, feature):
    """``admission``: the Frontend builds an AdmissionController from its
    config block; of two requests against a bucket of one, the second is
    shed with 429 and Retry-After.  ``dyn-models``: the directory pushed
    to the coordinator, the GpuWorker boots from ``dyn://models/tiny``
    (pulled into the cache) and answers the first request as the agg graph
    serving the directory did."""
    from dynamo_tpu_torch.llm import model_store
    from dynamo_tpu_torch.planner import AdmissionController
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient

    monkeypatch.setattr(model_store, "DEFAULT_CACHE", tmp_path / "cache")
    mod = f"{GRAPHS}.agg"
    cfg = graph_config("port", "agg", model_dir)
    if feature == "admission":
        cfg["GpuWorker"] = {"engine": "echo"}
        cfg["Frontend"]["admission"] = {"rate_tokens_per_s": 0.01, "burst_tokens": 1,
                                        "max_concurrent": 4}
    else:
        cfg["GpuWorker"]["model-path"] = "dyn://models/tiny"

    async def go():
        srv = await CoordinatorServer(port=0).start()
        handle = None
        try:
            if feature == "dyn-models":
                c = await CoordinatorClient(srv.url).connect()
                await model_store.push_model(c, "tiny", model_dir)
                await c.close()
            handle = await serve_graph(importlib.import_module(mod).Frontend, ServiceConfig(cfg),
                                       RuntimeConfig(coordinator_url=srv.url), graph=mod)
            front = handle.instances["Frontend"]
            if feature == "dyn-models":
                return handle.instances["GpuWorker"].card.model_path, await post_all(
                    front.port, REQUESTS[:1])
            admission = front.http.admission
            statuses = []
            async with ClientSession() as s:
                for _ in range(2):
                    r = await s.post(f"http://127.0.0.1:{front.port}/v1/completions",
                                     json={"model": "tiny", "prompt": [5, 6, 7], "max_tokens": 2})
                    statuses.append((r.status, r.headers.get("Retry-After")))
            return admission, statuses
        finally:
            if handle is not None:
                await handle.stop()
            await srv.stop()

    if feature == "admission":
        admission, statuses = run(go())
        assert isinstance(admission, AdmissionController)
        assert admission.config.burst_tokens == 1.0 and admission.config.max_concurrent == 4
        assert statuses[0] == (200, None) and statuses[1][0] == 429
        assert int(statuses[1][1]) >= 1 and admission.shed_total == {"normal": 1}
    else:
        path, bodies = run(go())
        assert Path(path).parent == tmp_path / "cache"
        assert _strip(bodies) == _strip(served("port", "agg")["bodies"][:1])


def test_hello_world_example_runs():
    out = subprocess.run(
        [sys.executable, str(Path(dynamo_tpu_torch.__file__).parent / "examples" / "hello_world"
                             / "hello_world.py")],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("HELLO WORLD!")


# ------------------------------------------------------ serve, processes ----


GRAPH_COMPONENTS = {"frontend": "info", "processor": "process", "gpuworker": "generate",
                    "prefillworker": "status"}


@pytest.fixture
def in_process_split(served):
    return served("port", "disagg_split")


def test_serve_disagg_graph_as_processes(in_process_split, model_dir, tmp_path):
    """``python -m dynamo_tpu_torch serve ...disagg:Frontend -f CONFIG``
    with both workers on one card entry (DYNTPU_GPUS=0,0): four processes,
    the prompts above the threshold prefilled in the PrefillWorker process
    and handed over TCP, the answers those of the in-process graph, the
    PrefillWorker's ``status`` read through a ServiceClient, each worker
    process's kernel launches read from its ``status``, and every process
    exiting 0 on SIGTERM after its drain."""
    from dynamo_tpu_torch.examples.llm.components.prefill_worker import PrefillWorker
    from dynamo_tpu_torch.examples.llm.components.worker import GpuWorker
    from dynamo_tpu_torch.ops.kernels import wrappers as kernel_wrappers
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.sdk.service import ServiceClient

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    cfg = graph_config("port", "disagg_split", model_dir)
    cfg["Frontend"]["port"] = port
    (tmp_path / "disagg.yaml").write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               DYNTPU_GPUS="0,0")
    before = dict(ttransfer.stats)

    async def go():
        srv = await CoordinatorServer(port=0).start()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", PKG, "serve", f"{GRAPHS}.disagg:Frontend", "-f",
            str(tmp_path / "disagg.yaml"), "--coordinator", srv.url,
            cwd=str(REPO), env=env, stderr=subprocess.PIPE)
        rt = await DistributedRuntime.connect(RuntimeConfig(coordinator_url=srv.url))
        try:
            for comp, ep in GRAPH_COMPONENTS.items():
                client = await rt.namespace("dynamo").component(comp).endpoint(ep).client()
                await client.wait_for_instances(1, timeout=60)
                await client.close()
            bodies = await post_all(port)
            status = ServiceClient(rt, PrefillWorker)
            for _ in range(200):
                prefill = [s async for s in status.status({})][0]
                if prefill["handled"] >= remote_prefills("disagg_split", model_dir):
                    break
                await asyncio.sleep(0.02)
            await status.close()
            worker = ServiceClient(rt, GpuWorker)
            decode = [s async for s in worker.status({})][0]
            await worker.close()
        finally:
            await rt.shutdown()
            proc.send_signal(signal.SIGTERM)
            _, err = await asyncio.wait_for(proc.communicate(), 60)
            await srv.stop()
        return bodies, prefill, decode, proc.returncode, err.decode()

    bodies, prefill, decode, rc, err = run(go())
    handled = prefill["handled"]
    # each worker process reports its kernels' launches: none on the CPU,
    # where every wrapper takes its plain version
    assert prefill["launches"] == decode["launches"] == {k: 0 for k in kernel_wrappers()}
    assert rc == 0, err[-3000:]
    assert _strip(bodies) == _strip(in_process_split["bodies"])
    assert handled == remote_prefills("disagg_split", model_dir) > 0
    # the handoffs crossed processes: none of them in this one
    assert ttransfer.stats == before
    line = next(ln for ln in err.splitlines() if "worker exit codes" in ln)
    assert json.loads(line.split("worker exit codes ", 1)[1]) == {
        "Frontend:0": 0, "Processor:0": 0, "GpuWorker:0": 0, "PrefillWorker:0": 0}
    assert "did not drain" not in err
    assert all(f"[{name}] INFO {PKG}.serve_worker: {name} drained and stopped" in err
               for name in ("Frontend", "Processor", "GpuWorker", "PrefillWorker"))
