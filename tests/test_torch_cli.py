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
"""

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
