"""The port's command line, run in a subprocess as a user runs it.

``run in=text:`` with ``out=gpu --device cpu`` must print the same text as
the JAX package's ``run in=text: out=tpu`` on the same checkpoint.  Both CLIs
sample at the OpenAI default temperature 1 from different generators, so
the checkpoint's lm_head is scaled until every step of the prompts used
here has a logit margin (top-1 minus top-2) above 25: Gumbel noise from an
f32 uniform lies in about [-4.5, 16.6], so no draw of either generator can
move the sample off the argmax, and the text is the greedy text (checked
against the port model's own greedy decode).  ``in=stdin`` and
``in=batch:`` run with ``out=echo``; ``in=http`` answers a greedy
completion over a real socket and exits cleanly on SIGTERM; ``out=gpu``
without ``--device`` on a machine with no GPU fails with the device error,
and a configuration the PyTorch engine refuses (a draft model of another
vocabulary) fails with the engine's message.  ``--spec-tokens 2`` serves the
greedy text, n-gram lookup alone and with ``--spec-draft-model`` (the
checkpoint as its own draft), and ``--spec-draft-model`` without
``--spec-tokens`` exits with the JAX CLI's message.  On a tiny DeepSeek-V2 checkpoint ``build_local_engine`` (``--device
cpu``) answers a greedy completion with transformers' greedy tokens, and
``--quantize int8`` exits with the JAX CLI's message.

The control plane's commands: ``deploy`` prints the JAX CLI's manifests
under the renderer's translations and refuses a ``tpu:`` block;
``api-store``, ``metrics``, ``mock-worker``, ``planner`` and ``operator
--dry-run`` start, answer (an HTTP body, published events and metrics, a
plan's pre-warm hint, a reconcile) and stop with exit 0 on SIGTERM.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch
import yaml

import dynamo_tpu_torch
from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.models.loader import load_model_dir
from tests.conftest import make_tiny_hf_checkpoint
from tests.test_torch_loader import deepseek_checkpoint

REPO = Path(__file__).resolve().parent.parent
PKG = dynamo_tpu_torch.__name__
PROMPTS = ("hello world w3 w5", "w1 w2 w3")
MAX_TOKENS = 8
LM_HEAD_SCALE = 1e4
MIN_MARGIN = 25.0
ENGINE_FLAGS = ["--dtype", "float32", "--max-model-len", "64", "--num-blocks", "16",
                "--max-batch-size", "2"]


def _env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                **extra)


def _run(module, args, input_text=None, timeout=120, **env):
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, timeout=timeout, cwd=str(REPO), input=input_text,
                          env=_env(**env))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny HF checkpoint whose lm_head is scaled by LM_HEAD_SCALE."""
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp("cli") / "hf"
    hf = make_tiny_hf_checkpoint(d)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    sd["lm_head.weight"] = sd["lm_head.weight"] * LM_HEAD_SCALE
    save_file(sd, str(d / "model.safetensors"))
    return d


def _greedy(model, tok, prompt):
    """The port model's greedy continuation of ``prompt`` and the smallest
    top-1 minus top-2 logit margin over its steps (no cache reuse: the
    whole sequence is prefilled again at each step)."""
    ids = tok.encode(prompt)
    margins, out = [], []
    for _ in range(MAX_TOKENS):
        n = len(ids)
        cache = model.init_kv_cache(4, 16)
        bt = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
        pos = torch.arange(n, dtype=torch.int32)[None]
        h, _ = model.forward(torch.tensor([ids], dtype=torch.int32), pos, cache, bt,
                             torch.tensor([n], dtype=torch.int32), pos.clone(), prefix_blocks=0)
        top = torch.topk(model.compute_logits(h[0, -1:])[0], 2)
        margins.append(float(top.values[0] - top.values[1]))
        out.append(int(top.indices[0]))
        ids.append(out[-1])
    return tok.decode(out), min(margins)


@pytest.fixture(scope="module")
def jax_texts(model_dir):
    """The JAX CLI's answer to each prompt (``out=tpu`` on the CPU)."""
    texts = {}
    for p in PROMPTS:
        out = _run("dynamo_tpu.cli", ["run", f"in=text:{p}", "out=tpu", "--model-path",
                                      str(model_dir), "--max-tokens", str(MAX_TOKENS),
                                      *ENGINE_FLAGS], timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        texts[p] = out.stdout
    return texts


@pytest.mark.parametrize("prompt", PROMPTS)
def test_run_text_matches_jax_cli(model_dir, jax_texts, prompt):
    cfg, state = load_model_dir(model_dir, dtype="float32", device="cpu")
    greedy, margin = _greedy(LlamaModel.from_state(cfg, state),
                             TokenizerWrapper.from_file(model_dir), prompt)
    assert margin > MIN_MARGIN, margin
    out = _run(PKG, ["run", f"in=text:{prompt}", "out=gpu", "--device", "cpu", "--model-path",
                     str(model_dir), "--max-tokens", str(MAX_TOKENS), *ENGINE_FLAGS])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == jax_texts[prompt]
    assert out.stdout.strip() == greedy


def test_run_stdin_echo(model_dir):
    out = _run(PKG, ["run", "in=stdin", "out=echo", "--model-path", str(model_dir),
                     "--max-tokens", "8"], input_text="hello world\nworld hello\n")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines() == ["hello world", "world hello"]


def test_run_batch_echo(model_dir, tmp_path):
    f = tmp_path / "prompts.jsonl"
    f.write_text('{"text": "hello world"}\n{"text": "world hello w7"}\n')
    out = _run(PKG, ["run", f"in=batch:{f}", "out=echo", "--model-path", str(model_dir),
                     "--max-tokens", "8"])
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["requests"] == 2 and summary["output_tokens"] == 5
    results = [json.loads(l) for l in Path(summary["results"]).read_text().splitlines()]
    assert [r["text"] for r in results] == ["hello world", "world hello w7"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_http_serves_a_completion(model_dir):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", PKG, "run", "in=http", "out=gpu", "--device", "cpu",
         "--model-path", str(model_dir), "--model-name", "tiny", "--http-port", str(port),
         *ENGINE_FLAGS], cwd=str(REPO), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 15
        while True:
            try:
                with urllib.request.urlopen(f"{base}/health", timeout=1) as r:
                    assert json.loads(r.read())["models"] == ["tiny"]
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, "no server"
                time.sleep(0.1)
        body = json.dumps({"model": "tiny", "prompt": PROMPTS[0], "max_tokens": MAX_TOKENS,
                           "temperature": 0}).encode()
        req = urllib.request.Request(f"{base}/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            answer = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=15)
    assert proc.returncode == 0, err[-2000:]
    choice = answer["choices"][0]
    assert choice["finish_reason"] == "length"
    assert answer["usage"]["completion_tokens"] == MAX_TOKENS
    cfg, state = load_model_dir(model_dir, dtype="float32", device="cpu")
    greedy, _ = _greedy(LlamaModel.from_state(cfg, state), TokenizerWrapper.from_file(model_dir),
                        PROMPTS[0])
    assert choice["text"] == greedy


def test_out_gpu_without_a_gpu_fails(model_dir):
    # the card is hidden from the subprocess, so this holds on a GPU machine too
    out = _run(PKG, ["run", "in=text:hello", "out=gpu", "--model-path", str(model_dir)],
               CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert out.stdout == ""


@pytest.fixture(scope="module")
def other_vocab_dir(tmp_path_factory):
    """A tiny checkpoint of 96 ids, a draft the 128-id model cannot take."""
    d = tmp_path_factory.mktemp("cli") / "other"
    make_tiny_hf_checkpoint(d, vocab_size=96, seed=1)
    return d


def test_refused_engine_option_fails_with_the_engine_message(model_dir, other_vocab_dir):
    out = _run(PKG, ["run", "in=text:hello", "out=gpu", "--device", "cpu", "--model-path",
                     str(model_dir), "--spec-tokens", "2", "--spec-draft-model",
                     str(other_vocab_dir), *ENGINE_FLAGS])
    assert out.returncode != 0
    assert "draft model must share the target's vocab (96 != 128)" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("draft", [False, True], ids=["ngram", "draft"])
def test_run_text_with_speculation(model_dir, draft):
    prompt = "w1 w2 w1 w2 w1 w2"
    cfg, state = load_model_dir(model_dir, dtype="float32", device="cpu")
    greedy, margin = _greedy(LlamaModel.from_state(cfg, state),
                             TokenizerWrapper.from_file(model_dir), prompt)
    assert margin > MIN_MARGIN, margin
    flags = ["--spec-tokens", "2"] + (["--spec-draft-model", str(model_dir)] if draft else [])
    out = _run(PKG, ["run", f"in=text:{prompt}", "out=gpu", "--device", "cpu", "--model-path",
                     str(model_dir), "--max-tokens", str(MAX_TOKENS), *flags, *ENGINE_FLAGS])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == greedy


def test_draft_model_without_spec_tokens_exits(model_dir):
    out = _run(PKG, ["run", "in=text:hello", "out=gpu", "--device", "cpu", "--model-path",
                     str(model_dir), "--spec-draft-model", str(model_dir), *ENGINE_FLAGS])
    assert out.returncode != 0
    assert "--spec-draft-model requires --spec-tokens > 0" in out.stderr
    assert out.stdout.strip() == ""


def test_build_local_engine_attaches_the_draft(model_dir):
    from dynamo_tpu_torch.cli import build_local_engine, parse_args

    engine, _ = build_local_engine(parse_args([
        "run", "in=http", "out=gpu", "--device", "cpu", "--model-path", str(model_dir),
        "--spec-tokens", "3", "--spec-draft-model", str(model_dir), "--spec-draft-num-blocks",
        "8", *ENGINE_FLAGS]))
    try:
        core = engine.core
        assert core.config.spec_tokens == 3 and core.config.draft_num_blocks == 8
        assert core.draft is not None and core.draft.model is not core.model
        assert len(core.draft._free) == 8
        assert core.draft.model.config.vocab_size == core.model.config.vocab_size
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def deepseek_dir(tmp_path_factory):
    """(directory, transformers model) of a tiny DeepSeek-V2 checkpoint."""
    return deepseek_checkpoint(tmp_path_factory.mktemp("cli") / "deepseek", 11)


def test_build_local_engine_serves_deepseek(deepseek_dir):
    import asyncio

    from dynamo_tpu_torch.cli import build_local_engine, parse_args
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.openai import parse_request
    from dynamo_tpu_torch.models.deepseek import DeepseekModel
    from dynamo_tpu_torch.runtime.engine import Context

    path, hf = deepseek_dir
    prompt = [5, 6, 7, 8, 9, 10, 11, 12]
    with torch.no_grad():
        ref = hf.generate(torch.tensor([prompt]), max_new_tokens=MAX_TOKENS, do_sample=False,
                          eos_token_id=None, pad_token_id=0)[0, len(prompt):].tolist()
    engine, card = build_local_engine(parse_args([
        "run", "in=http", "out=gpu", "--device", "cpu", "--model-path", str(path),
        "--model-name", "ds", "--kv-cache-dtype", "model", *ENGINE_FLAGS]))
    try:
        assert isinstance(engine.core.model, DeepseekModel)
        pipeline = build_serving_pipeline(engine, card)
        request = parse_request({"model": "ds", "prompt": prompt, "max_tokens": MAX_TOKENS,
                                 "temperature": 0}, chat=False)

        async def answer():
            return [out async for out in pipeline.generate(Context(request))]

        outs = asyncio.run(answer())
    finally:
        engine.shutdown()
    assert [t for o in outs for t in o.token_ids] == ref
    assert outs[-1].finish_reason.value == "length"


def test_quantize_int8_refused_for_deepseek_as_in_jax(deepseek_dir):
    path, _ = deepseek_dir
    msg = "--quantize int8 is not wired for this model family yet"
    out = _run(PKG, ["run", "in=text:w5 w6", "out=gpu", "--device", "cpu", "--model-path",
                     str(path), "--quantize", "int8", *ENGINE_FLAGS])
    assert out.returncode != 0 and msg in out.stderr and out.stdout == ""
    ref = _run("dynamo_tpu.cli", ["run", "in=text:w5 w6", "out=tpu", "--model-path", str(path),
                                  "--quantize", "int8", *ENGINE_FLAGS])
    assert ref.returncode != 0 and msg in ref.stderr


# ------------------------------------------------ the control-plane commands

DEPLOY_SPEC = """
name: llm
namespace: serving
image: img:1
services:
  decode:
    command: [python3, -m, PKG, run, "in=dyn://dynamo.decode.generate", out=gpu]
    replicas: 2
    ACCEL
""".replace("PKG", PKG)


def test_deploy_renders_as_the_jax_cli_does(tmp_path):
    """``deploy SPEC`` prints the JAX CLI's manifests under the renderer's
    translations; ``-o DIR`` writes one file per object; a ``tpu:`` block
    exits with the refusal."""
    from dynamo_tpu_torch.deploy.renderer import CLI

    port_spec, jax_spec = tmp_path / "gpu.yaml", tmp_path / "tpu.yaml"
    port_spec.write_text(DEPLOY_SPEC.replace("ACCEL", "gpu: {count: 4}"))
    jax_spec.write_text(DEPLOY_SPEC.replace("ACCEL", 'tpu: {type: v5e, topology: "2x2", '
                                                     "chips: 4}"))
    out = _run(PKG, ["deploy", str(port_spec)])
    ref = _run("dynamo_tpu.cli", ["deploy", str(jax_spec)])
    assert out.returncode == 0 == ref.returncode, out.stderr[-2000:]
    docs = [d for d in yaml.safe_load_all(out.stdout) if d]
    want = [d for d in yaml.safe_load_all(ref.stdout) if d]
    for d in want:
        pod = d["spec"]["template"]["spec"] if d["kind"] == "Deployment" else None
        if pod is None:
            continue
        c = pod["containers"][0]
        if c["command"][0] == "dynamo-tpu":
            c["command"] = CLI + c["command"][1:]
        if "resources" in c:
            c["resources"] = {k: {"nvidia.com/gpu": v["google.com/tpu"]}
                              for k, v in c["resources"].items()}
            del pod["nodeSelector"]
    assert docs == want and len(docs) == 7
    written = _run(PKG, ["deploy", str(port_spec), "-o", str(tmp_path / "m")])
    assert written.returncode == 0 and len(written.stdout.split()) == 7
    refused = _run(PKG, ["deploy", str(jax_spec)])
    assert refused.returncode != 0 and "tpu: block" in refused.stderr


async def _serve_until(args, ready, up_line, timeout=30):
    """Start a long-running command, wait until it has logged ``up_line``
    (its signal handlers follow at once) and ``ready(stderr so far)`` (a
    coroutine function) is true, then SIGTERM it; (result of ready, rc,
    stderr)."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", PKG, *args, cwd=str(REPO), env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    err = []

    async def read_err():
        async for line in proc.stderr:
            err.append(line.decode())

    reader = asyncio.ensure_future(read_err())
    try:
        deadline = time.monotonic() + timeout
        got = None
        while time.monotonic() < deadline and proc.returncode is None:
            if any(up_line in line for line in err):
                await asyncio.sleep(0.2)
                got = await ready("".join(err))
                if got:
                    break
            await asyncio.sleep(0.1)
    finally:
        if proc.returncode is None:
            proc.send_signal(signal.SIGTERM)
        await asyncio.wait_for(proc.wait(), 30)
        await asyncio.wait_for(reader, 30)
    return got, proc.returncode, "".join(err)


def _on_coordinator(body):
    from dynamo_tpu_torch.runtime.transports.coordinator import (CoordinatorClient,
                                                                 CoordinatorServer)

    async def go():
        srv = await CoordinatorServer(port=0).start()
        c = await CoordinatorClient(srv.url).connect()
        try:
            return await body(srv.url, c)
        finally:
            await c.close()
            await srv.stop()

    return asyncio.run(go())


async def _http_get(url):
    from aiohttp import ClientError, ClientSession

    try:
        async with ClientSession() as s:
            async with s.get(url) as r:
                return r.status, await r.text()
    except (ClientError, OSError):
        return None


def test_api_store_and_metrics_commands_answer():
    from dynamo_tpu_torch.llm.kv_router.publisher import metrics_subject
    from dynamo_tpu_torch.obs.metric_names import RouterMetric

    store_port, metrics_port = _free_port(), _free_port()

    async def body(url, c):
        async def store_ready(_):
            got = await _http_get(f"http://127.0.0.1:{store_port}/api/v1/graphs")
            return got if got and got[0] == 200 else None

        store = await _serve_until(["api-store", "--db", ":memory:", "--port",
                                    str(store_port)], store_ready, "api-store on")

        async def metrics_ready(_):
            await c.publish(metrics_subject("t", 5), {
                "worker_id": 5, "request_active_slots": 1, "request_total_slots": 8,
                "kv_active_blocks": 7, "kv_total_blocks": 64})
            got = await _http_get(f"http://127.0.0.1:{metrics_port}/metrics")
            return got if got and 'worker="5"' in got[1] else None

        metrics = await _serve_until(["metrics", "--port", str(metrics_port), "--coordinator",
                                      url, "--namespace", "t"], metrics_ready, "metrics on")
        return store, metrics

    (store, s_rc, s_err), (metrics, m_rc, m_err) = _on_coordinator(body)
    assert store == (200, "[]") and s_rc == 0, s_err[-2000:]
    assert metrics is not None and m_rc == 0, m_err[-2000:]
    assert f'{RouterMetric.KV_BLOCKS_ACTIVE}{{worker="5"}} 7' in metrics[1]


def test_planner_and_mock_worker_commands_answer():
    from dynamo_tpu_torch.llm.kv.persist import prewarm_key
    from dynamo_tpu_torch.llm.kv_router.publisher import events_subject, metrics_subject

    async def body(url, c):
        seen = {"events": 0, "metrics": 0}

        def count(kind):
            def cb(subject, payload):
                seen[kind] += 1
            return cb

        await c.subscribe(events_subject("t"), count("events"))
        await c.subscribe(metrics_subject("t"), count("metrics"))

        async def workers_ready(_):
            return seen["events"] > 0 and seen["metrics"] >= 2

        mock = await _serve_until(["mock-worker", "--coordinator", url, "--namespace", "t",
                                   "--worker-id", "3", "--count", "2"], workers_ready,
                                  "mock worker(s) publishing")
        # a decode pool of one worker reporting saturation, a deep prefill
        # queue: the planner's first tick scales both up and publishes the
        # pre-warm hint
        lease = await c.lease_create(ttl=30.0)
        for comp in ("prefill", "decode"):
            await c.kv_put(f"t/components/{comp}/endpoints/generate/{lease:x}",
                           {"instance_id": lease}, lease_id=lease)
        for _ in range(9):
            await c.queue_push("t_prefill_queue", {"r": 1})

        async def planned(_):
            await c.publish(metrics_subject("t", lease), {
                "worker_id": lease, "request_active_slots": 8, "request_total_slots": 8,
                "kv_active_blocks": 1, "kv_total_blocks": 10})
            return await c.kv_get(prewarm_key("t"))

        plan = await _serve_until(["planner", "--coordinator", url, "--namespace", "t",
                                   "--interval", "0.2"], planned, "planner loop on")
        return mock, plan

    (mock_ok, mock_rc, mock_err), (hint, p_rc, p_err) = _on_coordinator(body)
    assert mock_ok and mock_rc == 0, mock_err[-2000:]
    assert "2 mock worker(s) publishing" in mock_err
    assert hint is not None and p_rc == 0, p_err[-2000:]
    assert hint["prefill_replicas"] == 3 and hint["decode_replicas"] >= 2
    assert "plan tick=" in p_err


def test_operator_command_reconciles_dry_run(tmp_path):
    """``operator DIR --dry-run`` (an in-memory cluster: no kubectl) loads the
    specs, reconciles on its interval, observing the coordinator's live
    registrations, and stops on SIGTERM; without a specs dir or ``--crd``
    it exits with the JAX CLI's message (the next test)."""
    (tmp_path / "llm.yaml").write_text(DEPLOY_SPEC.replace("ACCEL", "gpu: {count: 1}"))

    async def body(url, c):
        async def ticked(err):  # a few reconcile intervals after start
            await asyncio.sleep(0.3)
            return True

        return await _serve_until(["operator", str(tmp_path), "--dry-run", "--interval", "0.1",
                                   "--coordinator", url], ticked, "operator watching")

    _, rc, err = _on_coordinator(body)
    assert rc == 0, err[-2000:]
    assert "operator watching" in err and "1 specs, dry_run=True" in err


def test_operator_command_needs_a_source():
    bad = _run(PKG, ["operator"])
    assert bad.returncode != 0 and "operator needs a specs dir and/or --crd" in bad.stderr
