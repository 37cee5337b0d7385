#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dynamo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # one CUDA card; nvcc on PATH or in $CUDA_HOME/bin

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit, from nvidia-smi;
2. build: every ``dynamo_tpu_torch/csrc/*.cu`` compiled with nvcc for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at Llama-3-8B attention geometry (H=32, Hk=8, D=128, Bs=16, L=32,
   bf16, layer index 5), then timed at the serving path's shapes beside
   its plain version, a PyTorch library call on the same work, and its
   bound on this card;
4. serving: Llama-3-8B at full width and depth (random weights from a
   seeded generator) behind ``AsyncLLMEngine``, six concurrent greedy
   requests (17 to 1500 prompt tokens, two sharing a 256-token prefix),
   with both kernels' launch counters zeroed before and read after;
5. parity: a 2-layer model at full 8B width, one 300-token prompt over a
   128-token cached prefix then 8 decode steps, on the card (kernels,
   bf16) and on the CPU (plain PyTorch, f32), last-position logits held
   to a stated tolerance.

Then one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# published peaks of one H100 SXM (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Llama-3-8B attention geometry
H, HK, D, BS, L = 32, 8, 128, 16, 32
LAYER = 5  # a runtime layer index other than 0

# serving traffic: prompt lengths; the last two share a 256-token prefix
PROMPT_LENS = (17, 300, 640, 1500, 356, 956)
SHARED_PREFIX = 256
MAX_TOKENS = 32

# bf16 tolerance, kernel vs plain version on identical bf16 inputs, per
# element: |out - ref| <= KERNEL_ATOL + KERNEL_RTOL * |ref|.  Both sides
# accumulate in f32 and round the output to bf16 once, and summation-order
# noise can tip that rounding by one bf16 ulp (<= |x| / 128); the prefill
# kernel also rounds the softmax probabilities to bf16 for the tensor-core
# PV product (2**-9 relative per term, <= 0.01 absolute for V rows drawn
# from N(0, 1)).  RTOL allows two ulps, ATOL the probability rounding.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 2.0 ** -6
# 2-layer model, card (bf16 activations) vs CPU (f32), same bf16 weights:
# ~a dozen bf16 roundings of 2**-9 relative each compound to ~1e-2
PARITY_REL_L2 = 5e-2
PARITY_MAX_REL = 1e-1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call on the card, by CUDA events around ``iters``
    calls (``fn(i)`` gets the call index, so callers can rotate inputs
    past the 50 MB L2)."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ------------------------------------------------------------------ kernels
def _poisoned_cache(torch, gen, n_blocks, tables, lens, hkd):
    """A random bf16 cache [L, N, 2, Bs, Hk*D] whose every slot no row
    owns below its length is NaN, in every layer."""
    cache = torch.randn((L, n_blocks, 2, BS, hkd), generator=gen, device="cuda",
                        dtype=torch.float32).to(torch.bfloat16)
    live = torch.zeros((n_blocks, BS), dtype=torch.bool, device="cuda")
    for row, n in zip(tables.tolist(), lens):
        for j in range(n):
            live[row[j // BS], j % BS] = True
    cache.masked_fill_(~live[None, :, None, :, None], float("nan"))
    return cache


def _tables(torch, lens, m, n_blocks, gen):
    """Disjoint random block tables [B, m], 0-filled past each row's
    blocks (the engine's layout)."""
    perm = torch.randperm(n_blocks, generator=gen, device="cuda").tolist()
    bt = torch.zeros((len(lens), m), dtype=torch.int32)
    k = 0
    for i, n in enumerate(lens):
        nb = -(-n // BS)
        bt[i, :nb] = torch.tensor(perm[k:k + nb], dtype=torch.int32)
        k += nb
    return bt.cuda()


def compare(torch, what: str, out, ref) -> float:
    """Max abs error of a kernel's output against its plain version;
    fails on a non-finite output or an element outside the tolerance."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    excess = (diff - KERNEL_RTOL * ref.float().abs()).max().item()
    check(excess <= KERNEL_ATOL,
          f"{what}: |out - ref| exceeds {KERNEL_ATOL} + {KERNEL_RTOL} |ref| by {excess - KERNEL_ATOL}")
    return diff.max().item()


def decode_case(torch, gen, lens, s, logit_cap, geom=(H, HK, D)):
    from dynamo_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention)

    m = 2048 // BS
    n_blocks = sum(-(-n // BS) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen)
    h, hk, d = geom
    cache = _poisoned_cache(torch, gen, n_blocks, bt.cpu(), lens, hk * d)
    b = len(lens)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q0 = (seq_lens - s).clamp_min(0)
    args = (q, cache, LAYER, bt, seq_lens, q0)
    out = paged_decode_attention(*args, logit_cap=logit_cap)
    err = compare(torch, f"decode {geom} S={s} cap={logit_cap}", out,
                  decode_attention_ref(*args, logit_cap=logit_cap))
    for i, n in enumerate(lens):
        if n == 0:
            check(bool((out[i] == 0).all()), f"decode S={s}: zero-length row {i} is not 0")
    return err


def prefill_case(torch, gen, starts, fresh, s, geom=(H, HK, D)):
    from dynamo_tpu_torch.ops.kernels.prefill_attention import (
        paged_prefill_attention, prefill_attention_ref)

    m = 2048 // BS
    lens = [st + f for st, f in zip(starts, fresh)]
    n_blocks = sum(-(-n // BS) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen)
    # only the cached prefix is live in the cache; fresh slots stay NaN
    h, hk, d = geom
    cache = _poisoned_cache(torch, gen, n_blocks, bt.cpu(), starts, hk * d)
    b = len(starts)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    k_new = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
    v_new = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
    for i, f in enumerate(fresh):  # padding rows of the fresh K/V are NaN too
        k_new[i, f:] = float("nan")
        v_new[i, f:] = float("nan")
    args = (q, k_new, v_new, cache, LAYER, bt,
            torch.tensor(lens, dtype=torch.int32, device="cuda"),
            torch.tensor(starts, dtype=torch.int32, device="cuda"))
    out = paged_prefill_attention(*args)
    err = compare(torch, f"prefill {geom} starts={starts}", out, prefill_attention_ref(*args))
    for i, f in enumerate(fresh):
        check(bool((out[i, f:] == 0).all()), f"prefill: padding rows of row {i} are not 0")
    return err


def kernel_phase(torch) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"decode": 0.0, "prefill": 0.0}
    mixed = [0, 1, 17, 100, 333, 1024, 1500, 2048]
    for s in (1, 4):
        for cap in (None, 50.0):
            e = decode_case(torch, gen, mixed, s, cap)
            log(f"kernel decode  B=8 S={s} softcap={cap}: max abs err {e:.3g}")
            errs["decode"] = max(errs["decode"], e)
    e = prefill_case(torch, gen, starts=[0, 256], fresh=[512, 500], s=512)
    log(f"kernel prefill B=2 S=512 start=[0, 256] fresh=[512, 500]: max abs err {e:.3g}")
    errs["prefill"] = e
    # the other head widths the kernels take (Llama-3.2-1B: 64, Gemma: 256),
    # with MHA and G = 8 groupings; checked, not part of the reported error
    for geom in ((8, 8, 64), (16, 2, 256)):
        d_err = decode_case(torch, gen, [0, 5, 300], 2, None, geom=geom)
        p_err = prefill_case(torch, gen, starts=[64], fresh=[90], s=96, geom=geom)
        log(f"kernel (H, Hk, D)={geom}: decode S=2 max abs err {d_err:.3g}, "
            f"prefill start=64 max abs err {p_err:.3g}")
    return errs


def timing_phase(torch, card: str) -> dict:
    """Each kernel at the serving path's shapes, timed and checked against
    its plain version there: decode is one layer of a burst step (B = 8
    slots, S = 1, the six requests mid-generation), and prefill the longest
    prompt's one dispatch (S = 1504, start = 0)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention)
    from dynamo_tpu_torch.ops.kernels.prefill_attention import (
        paged_prefill_attention, prefill_attention_ref)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    m = 2048 // BS
    out = {}

    # decode
    lens = [n + MAX_TOKENS // 2 for n in PROMPT_LENS] + [0, 0]
    b = len(lens)
    n_blocks = sum(-(-n // BS) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen)
    cache = torch.randn((L, n_blocks, 2, BS, HK * D), generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((b, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q0 = (seq_lens - 1).clamp_min(0)
    # successive launches walk the 32 layers, as a decode step does, so
    # the context is not served from L2
    kernel_ms = cuda_time_ms(lambda i: paged_decode_attention(q, cache, i % L, bt, seq_lens, q0), 64)
    plain_ms = cuda_time_ms(lambda i: decode_attention_ref(q, cache, i % L, bt, seq_lens, q0), 8)
    out["decode_err"] = compare(torch, "decode at the serving shapes",
                                paged_decode_attention(q, cache, LAYER, bt, seq_lens, q0),
                                decode_attention_ref(q, cache, LAYER, bt, seq_lens, q0))
    t = max(lens)
    kd = torch.zeros((b, HK, t, D), dtype=torch.bfloat16, device="cuda")
    vd = torch.zeros_like(kd)
    for i, n in enumerate(lens):
        rows = bt[i, :-(-n // BS)].long()
        kd[i, :, :n] = cache[LAYER, rows, 0].reshape(-1, HK, D)[:n].transpose(0, 1)
        vd[i, :, :n] = cache[LAYER, rows, 1].reshape(-1, HK, D)[:n].transpose(0, 1)
    mask = (torch.arange(t, device="cuda")[None, :] < seq_lens[:, None])[:, None, None, :]
    qd = q.transpose(1, 2).contiguous()
    library_ms = cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), 64)
    ctx = sum(lens)
    dec_bytes = 2 * (2 * b * H * D) + 2 * ctx * HK * D * 2 + 4 * (b * m + 2 * b)
    dec_flops = 4 * H * D * ctx
    out["decode"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=1e3 * max(dec_bytes / HBM_BYTES_PER_S, dec_flops / BF16_FLOP_PER_S),
                         bound_by="bytes" if dec_bytes / HBM_BYTES_PER_S >= dec_flops / BF16_FLOP_PER_S
                         else "operations")
    log(f"time decode  B={b} S=1 ctx={ctx}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {out['decode']['bound_ms']:.4f} ms, "
        f"max abs err {out['decode_err']:.3g} ({card})")

    # prefill
    s = -(-max(PROMPT_LENS) // BS) * BS
    fresh = max(PROMPT_LENS)
    bt1 = _tables(torch, [fresh], m, -(-fresh // BS) + 8, gen)
    cache1 = torch.randn((L, bt1.max().item() + 1, 2, BS, HK * D), generator=gen,
                         device="cuda").to(torch.bfloat16)
    qp = torch.randn((1, s, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((1, s, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((1, s, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
    lens1 = torch.tensor([fresh], dtype=torch.int32, device="cuda")
    st1 = torch.zeros(1, dtype=torch.int32, device="cuda")
    pargs = (qp, kp, vp, cache1, LAYER, bt1, lens1, st1)
    kernel_ms = cuda_time_ms(lambda i: paged_prefill_attention(*pargs), 10)
    plain_ms = cuda_time_ms(lambda i: prefill_attention_ref(*pargs), 3, warmup=1)
    out["prefill_err"] = compare(torch, "prefill at the serving shapes",
                                 paged_prefill_attention(*pargs), prefill_attention_ref(*pargs))
    qs = qp[:, :fresh].transpose(1, 2).contiguous()
    ks = kp[:, :fresh].transpose(1, 2).contiguous()
    vs = vp[:, :fresh].transpose(1, 2).contiguous()
    library_ms = cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), 10)
    pairs = fresh * (fresh + 1) // 2
    pre_flops = 4 * H * D * pairs
    pre_bytes = 2 * (2 * fresh * H * D + 2 * fresh * HK * D) + 4 * (m + 2)
    out["prefill"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=1e3 * max(pre_flops / BF16_FLOP_PER_S, pre_bytes / HBM_BYTES_PER_S),
                          bound_by="operations" if pre_flops / BF16_FLOP_PER_S >= pre_bytes / HBM_BYTES_PER_S
                          else "bytes")
    log(f"time prefill B=1 S={s} fresh={fresh} start=0: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {out['prefill']['bound_ms']:.4f} ms, "
        f"max abs err {out['prefill_err']:.3g} ({card})")
    return out


# ------------------------------------------------------------------ serving
def llama3_8b(num_layers: int = 32):
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                       num_layers=num_layers, num_heads=32, num_kv_heads=8,
                       max_position_embeddings=8192, rope_theta=500000.0, dtype="bfloat16")


def prompts(seed: int = 0) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 128256, SHARED_PREFIX).tolist()
    out = []
    for i, n in enumerate(PROMPT_LENS):
        if i >= len(PROMPT_LENS) - 2:  # the two sharing a prefix
            out.append(shared + rng.integers(0, 128256, n - SHARED_PREFIX).tolist())
        else:
            out.append(rng.integers(0, 128256, n).tolist())
    return out


async def _serve(engine, reqs):
    from dynamo_tpu_torch.llm.protocols import BackendInput, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(i, toks):
        t0 = time.perf_counter()
        first, outs = None, []
        ctx = Context(BackendInput(token_ids=toks, sampling=SamplingOptions(temperature=0.0),
                                   stops=StopConditions(max_tokens=MAX_TOKENS)), id=f"req-{i}")
        async for out in engine.generate(ctx):
            if first is None and out.token_ids:
                first = time.perf_counter() - t0
            outs.append(out)
        return first, time.perf_counter() - t0, outs

    return await asyncio.gather(*(one(i, t) for i, t in enumerate(reqs)))


def serving_phase(torch, card: str) -> dict:
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.llm.protocols import FinishReason
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel
    from dynamo_tpu_torch.ops.kernels.decode_attention import paged_decode_attention
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention

    cfg = llama3_8b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda"))
    torch.cuda.synchronize()
    log(f"serving: Llama-3-8B, {cfg.num_layers} layers, random weights in "
        f"{time.perf_counter() - t0:.1f} s")
    core = EngineCore(model, EngineConfig(max_batch_size=8, max_model_len=2048, block_size=16,
                                          decode_steps=8), device="cuda")
    engine = AsyncLLMEngine(core).start()
    try:
        # warm-up request: first-launch costs stay out of the measurement
        asyncio.run(_serve(engine, [list(range(1, 40))]))
        paged_decode_attention.launches = 0
        paged_prefill_attention.launches = 0
        t0 = time.perf_counter()
        results = asyncio.run(_serve(engine, prompts()))
        wall = time.perf_counter() - t0
        launches = {"decode": paged_decode_attention.launches,
                    "prefill": paged_prefill_attention.launches}
        metrics = core.metrics()
        for i, (_, _, outs) in enumerate(results):
            toks = [t for o in outs for t in o.token_ids]
            check(outs[-1].finish_reason is FinishReason.LENGTH,
                  f"request {i}: finish {outs[-1].finish_reason}, expected length")
            check(len(toks) == MAX_TOKENS, f"request {i}: {len(toks)} tokens, expected {MAX_TOKENS}")
            check(all(0 <= t < cfg.vocab_size for t in toks), f"request {i}: token out of range")
        cached = [outs[-1].cached_tokens for _, _, outs in results]
        check(max(cached[-2:]) >= SHARED_PREFIX,
              f"no request reused the shared {SHARED_PREFIX}-token prefix: cached {cached}")
        check(launches["decode"] > 0 and launches["prefill"] > 0,
              f"a kernel was not launched on the serving path: {launches}")
        ttfts = [r[0] for r in results]
        decode_tokens = len(results) * (MAX_TOKENS - 1)
        decode_window = wall - min(ttfts)
        log(f"serving: {len(results)} requests, wall {wall:.3f} s, TTFT min/median/max "
            f"{min(ttfts):.3f}/{sorted(ttfts)[len(ttfts) // 2]:.3f}/{max(ttfts):.3f} s, decode "
            f"{decode_tokens / decode_window:.1f} tok/s over {decode_window:.3f} s, cached {cached}, "
            f"host gap {metrics['host_gap_ms_per_turn']:.2f} ms/turn, launches {launches} ({card})")
        profile_serving(torch, engine, prompts(seed=1), card)
    finally:
        engine.shutdown()
    del engine, core, model
    torch.cuda.empty_cache()
    return launches


def profile_serving(torch, engine, reqs, card: str) -> None:
    """The same traffic (fresh prompts, so no prefix is cached) once more
    under torch.profiler: the share of wall time the card ran a kernel,
    and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asyncio.run(_serve(engine, reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    events = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy_s = sum(dev_us(e) for e in events) / 1e6
    top = ", ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.1f} ms x{e.count}" for e in events[:6])
    log(f"profile: device busy {busy_s:.3f} s of {wall:.3f} s wall ({100 * busy_s / wall:.1f}%); "
        f"top kernels: {top} ({card})")


# ------------------------------------------------------------------- parity
def _forward_logits(torch, model, device, prompt, steps, prefix):
    """Prefill ``prompt[:prefix]``, then the rest over that cached prefix
    (prefill kernel with start > 0), then ``steps`` single-token decode
    steps teacher-forced with ``steps`` fixed tokens; returns the logits
    at the last position of each dispatch after the first."""
    bs, m = BS, 2048 // BS
    n = len(prompt) + len(steps)
    nb = -(-n // bs)
    cache = model.init_kv_cache(nb + 1, bs)
    bt = torch.zeros((1, m), dtype=torch.int32, device=device)
    bt[0, :nb] = torch.arange(1, nb + 1, dtype=torch.int32)
    logits = []

    def run(toks, start, prefix_blocks):
        s = len(toks)
        pad = -(-s // bs) * bs if prefix_blocks is not None else s
        t = torch.zeros((1, pad), dtype=torch.int32, device=device)
        t[0, :s] = torch.tensor(toks, dtype=torch.int32)
        pos = torch.zeros((1, pad), dtype=torch.int32, device=device)
        pos[0, :s] = torch.arange(start, start + s, dtype=torch.int32)
        slot = torch.full((1, pad), -1, dtype=torch.int32, device=device)
        slot[0, :s] = bt[0, pos[0, :s].long() // bs] * bs + pos[0, :s] % bs
        lens = torch.tensor([start + s], dtype=torch.int32, device=device)
        hidden, _ = model.forward(t, pos, cache, bt, lens, slot, prefix_blocks=prefix_blocks)
        return model.compute_logits(hidden[:, s - 1]).float().cpu()

    run(prompt[:prefix], 0, 0)
    logits.append(run(prompt[prefix:], prefix, prefix // bs))
    for i, tok in enumerate(steps):
        logits.append(run([tok], len(prompt) + i, None))
    return torch.cat(logits)


def parity_phase(torch, card: str) -> None:
    import numpy as np

    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = llama3_8b(2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_params(cfg, gen, device="cuda")
    gpu = LlamaModel.from_state(cfg, state)
    cpu_cfg = llama3_8b(2)
    cpu_cfg.dtype = "float32"
    cpu = LlamaModel.from_state(cpu_cfg, {k: v.float().cpu() for k, v in state.items()})
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
    steps = rng.integers(0, cfg.vocab_size, 8).tolist()
    a = _forward_logits(torch, gpu, torch.device("cuda"), prompt, steps, prefix=128)
    b = _forward_logits(torch, cpu, torch.device("cpu"), prompt, steps, prefix=128)
    check(bool(torch.isfinite(a).all()), "parity: non-finite logits on the card")
    rel_l2 = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
    max_rel = ((a - b).abs().amax(dim=-1) / b.abs().amax(dim=-1)).max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"parity: 2-layer 8B width, 300-token prompt over a 128-token prefix + 8 decode steps: "
        f"max rel L2 {rel_l2:.3g} (tol {PARITY_REL_L2}), max |diff|/max|logit| {max_rel:.3g} "
        f"(tol {PARITY_MAX_REL}), argmax agreement {agree:.3f} ({card})")
    check(rel_l2 <= PARITY_REL_L2, f"parity: rel L2 {rel_l2} > {PARITY_REL_L2}")
    check(max_rel <= PARITY_MAX_REL, f"parity: max rel {max_rel} > {PARITY_MAX_REL}")


# --------------------------------------------------------------------- main
def main() -> int:
    if not (ROOT / "dynamo_tpu_torch").is_dir():
        print("chip_smoke: dynamo_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dynamo_tpu_torch.ops.kernels import build

    try:
        card = card_line()
        log(card)
        t0 = time.perf_counter()
        build.build_library(verbose=True)
        build.library()
        log(f"build: {time.perf_counter() - t0:.1f} s ({card})")
        errs = kernel_phase(torch)
        times = timing_phase(torch, card)
        launches = serving_phase(torch, card)
        parity_phase(torch, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        dict(name="paged_decode_attention", route="cuda",
             source="dynamo_tpu_torch/csrc/decode_attention.cu",
             replaces="dynamo_tpu/ops/pallas/decode_attention.py:281",
             launches=launches["decode"], max_abs_err=max(errs["decode"], times["decode_err"]),
             **times["decode"]),
        dict(name="paged_prefill_attention", route="cuda",
             source="dynamo_tpu_torch/csrc/prefill_attention.cu",
             replaces="dynamo_tpu/ops/pallas/prefill_attention.py:246",
             launches=launches["prefill"], max_abs_err=max(errs["prefill"], times["prefill_err"]),
             **times["prefill"]),
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
