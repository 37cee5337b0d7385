"""The port's command line: ``run``.

    python -m dynamo_tpu_torch run in=<http|text:PROMPT|stdin|batch:FILE> out=<gpu|echo> \\
        --model-path DIR [options]

The counterpart of ``dynamo_tpu/cli.py``'s ``run``: it builds the local
pipeline frontend → preprocessor → engine → detokenizer from a HuggingFace
checkpoint directory and serves it over OpenAI HTTP (``in=http``), answers
one prompt (``in=text:``), one prompt per line (``in=stdin``) or a JSONL
file of prompts (``in=batch:``).  ``out=gpu`` serves the checkpoint on the
PyTorch engine, on the GPU: a Llama-family directory (Mixtral and Qwen3-MoE
included) or a DeepSeek-V2 one (``models/deepseek.py``; ``--quantize int8``
is refused for it, as in the JAX CLI).  With no GPU present it fails rather
than run on the CPU (``--device cpu`` is the plain PyTorch path the tests take);
``out=echo`` echoes the prompt's tokens back with no model.
``--spec-tokens N`` turns on speculative decoding (prompt-lookup n-grams),
and ``--spec-draft-model DIR`` proposes with a small same-tokenizer model
instead, loaded unquantised as the target is loaded; a configuration the
engine refuses (a draft of another vocabulary) exits with the engine's
message.  The JAX CLI's unported options are not flags of this command.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import sys
import time
from pathlib import Path
from typing import Optional

log = logging.getLogger("dynamo_tpu_torch.cli")

__all__ = ["build_local_engine", "parse_args", "main"]


def build_local_engine(args) -> tuple[object, object]:
    """out=gpu|echo → (engine, card): the PyTorch engine on the checkpoint
    in ``args.model_path``, started, or the echo stub."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    if args.model_path is None:
        raise SystemExit(f"out={args.out} needs --model-path (weights + tokenizer)")
    card = ModelDeploymentCard.from_hf_dir(args.model_path, name=args.model_name)
    if args.out == "echo":
        from dynamo_tpu_torch.llm.engines import EchoEngineCore

        return EchoEngineCore(), card
    if args.out != "gpu":
        raise SystemExit(f"unknown out={args.out}")

    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.models.deepseek import DeepseekModel
    from dynamo_tpu_torch.models.llama import LlamaModel
    from dynamo_tpu_torch.models.loader import is_deepseek_dir, load_deepseek_dir, load_model_dir

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
        cache_dtype="int8" if args.kv_cache_dtype == "int8" else None,
        spec_tokens=args.spec_tokens,
        draft_num_blocks=args.spec_draft_num_blocks,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        prefill_token_budget=args.prefill_token_budget,
        unified_token_dispatch=args.unified_token_dispatch,
        lookahead_dispatch=args.lookahead_dispatch,
    )
    if args.spec_draft_model and cfg.spec_tokens <= 0:
        raise SystemExit("--spec-draft-model requires --spec-tokens > 0")
    quantize = args.quantize == "int8"
    dtype = args.dtype or "bfloat16"

    def load(path, quantize):
        t0 = time.perf_counter()
        if is_deepseek_dir(path):  # the MLA family, as the JAX CLI dispatches it
            if quantize:
                raise SystemExit("--quantize int8 is not wired for this model family yet")
            mcfg, state = load_deepseek_dir(path, dtype=dtype, device=device)
            model = DeepseekModel.from_state(mcfg, state)
        else:
            mcfg, state = load_model_dir(path, dtype=dtype, device=device, quantize=quantize)
            model = LlamaModel.from_state(mcfg, state)
        log.info("loaded %s (%s, %d layers%s) on %s in %.1f s", path, type(model).__name__,
                 mcfg.num_layers, ", int8 weights" if quantize else "", device,
                 time.perf_counter() - t0)
        return model

    model = load(args.model_path, quantize)
    # draft-model speculation: a small same-tokenizer model proposes, the
    # target verifies (engine/draft.py); loaded unquantised, as in the JAX CLI
    draft = load(args.spec_draft_model, False) if args.spec_draft_model else None
    try:
        core = EngineCore(model, cfg, eos_token_ids=card.eos_token_ids or None, device=device,
                          draft=draft)
    except ValueError as e:  # an option the PyTorch engine refuses
        raise SystemExit(str(e)) from None
    return AsyncLLMEngine(core).start(), card


def _shutdown(engine) -> None:
    if hasattr(engine, "shutdown"):
        engine.shutdown()


# ------------------------------------------------------------------- run ------


async def _cmd_run(args) -> None:
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline

    raw, card = build_local_engine(args)
    try:
        engine = build_serving_pipeline(raw, card)
        model_name = args.model_name or card.name
        if args.inp == "http":
            from dynamo_tpu_torch.llm.http.service import HttpService

            svc = HttpService(host=args.host, port=args.http_port,
                              core=raw.core if args.out == "gpu" else None)
            svc.manager.add_model(model_name, engine, card)
            await svc.start()
            log.info("OpenAI server on %s:%s — ctrl-c or SIGTERM to stop", svc.host, svc.port)
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
            try:
                await stop.wait()
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
    finally:
        _shutdown(raw)


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


# ------------------------------------------------------------------ parser ----


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="serve a checkpoint or answer prompts")
    run.add_argument("inout", nargs="+", help="in=<http|text:PROMPT|stdin|batch:FILE> "
                     "out=<gpu|echo>")
    run.add_argument("--model-path", default=None, help="HuggingFace checkpoint directory")
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
    run.add_argument("--max-tokens", type=int, default=128,
                     help="tokens per answer for in=text:, stdin and batch:")
    run.add_argument("--host", default="127.0.0.1")
    run.add_argument("--http-port", type=int, default=8080)
    return p


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    """The parsed command line, with ``in=``/``out=`` as ``inp``/``out``."""
    args = _parser().parse_args(argv)
    kv = dict(item.split("=", 1) for item in args.inout if "=" in item)
    if "in" not in kv or "out" not in kv:
        raise SystemExit("run needs in=<...> and out=<...>")
    args.inp, args.out = kv["in"], kv["out"]
    return args


def main(argv: Optional[list[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    asyncio.run(_cmd_run(parse_args(argv)))


if __name__ == "__main__":
    main()
