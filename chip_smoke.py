#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dynamo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # one CUDA card; nvcc on PATH or in $CUDA_HOME/bin

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit, from nvidia-smi;
2. build: every ``dynamo_tpu_torch/csrc/*.cu`` compiled with nvcc for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at Llama-3-8B attention geometry (H=32, Hk=8, D=128, Bs=16, L=32,
   bf16, layer index 5) with NaN in every dead cache slot and padding
   K/V, then decode and prefill timed at the default path's shapes beside
   their plain versions, a PyTorch library call on the same work, and
   their bound on this card;
4. serving: Llama-3-8B at full width and depth (random weights from a
   seeded generator) behind ``AsyncLLMEngine``, six concurrent greedy
   requests (17 to 1500 prompt tokens, two sharing a 256-token prefix),
   twice on the same model: the default path (one-request prefill, decode
   bursts), then the token-budget path (``prefill_token_budget=1024``,
   unified mixed dispatch, lookahead bursts).  Every kernel's launch
   counter is zeroed just before each run and read just after; the ragged
   kernel is then timed at the largest mixed dispatch the second run made;
5. parity: a 2-layer model at full 8B width on the card (kernels, bf16) and
   on the CPU (plain PyTorch, f32): one 300-token prompt over a 128-token
   cached prefix then 8 decode steps, and one packed prefill then one
   mixed ragged dispatch (two decode rows, two spans); logits held to a
   stated tolerance.

Then one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
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
# the two serving configurations, on one model
DEFAULT_PATH = dict(max_batch_size=8, max_model_len=2048, block_size=16, decode_steps=8)
BUDGET_PATH = dict(DEFAULT_PATH, prefill_token_budget=1024, unified_token_dispatch=True,
                   lookahead_dispatch=True)

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


def _ints(torch, xs):
    return torch.tensor(xs, dtype=torch.int32, device="cuda")


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


def ragged_layout(rows, region: int, n_pad: int):
    """Host layout of one ragged dispatch, as the engine packs it: rows are
    (start, fresh); the leading 1-token rows take one flat slot each in a
    ``region``-slot decode region, every other row a block-rounded span
    after it; ``n_pad`` zero padding rows follow the real ones.  Returns
    (T, starts, seq_lens, row_offsets) as lists over all rows."""
    n_dec = 0
    while region and n_dec < len(rows) and rows[n_dec][1] == 1:
        n_dec += 1
    offs, off = list(range(n_dec)), region
    for _, fresh in rows[n_dec:]:
        offs.append(off)
        off += -(-fresh // BS) * BS
    pad = [0] * n_pad
    return (off, [st for st, _ in rows] + pad, [st + f for st, f in rows] + pad, offs + pad)


def ragged_case(torch, gen, rows, region, n_pad, geom=(H, HK, D), logit_cap=None):
    """The ragged kernel against its plain version on one layout: the pool
    is NaN except each row's live prefix, and padding K/V is NaN; padding
    tokens must come out exactly 0."""
    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention, ragged_prefill_attention_ref)

    m = 2048 // BS
    t, starts, lens, offs = ragged_layout(rows, region, n_pad)
    n_blocks = sum(-(-n // BS) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen)
    h, hk, d = geom
    cache = _poisoned_cache(torch, gen, n_blocks, bt.cpu(), starts, hk * d)
    q = torch.randn((1, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    k_new = torch.randn((1, t, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
    v_new = torch.randn((1, t, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
    live = torch.zeros(t, dtype=torch.bool, device="cuda")
    for st, n, o in zip(starts, lens, offs):
        live[o:o + n - st] = True
    k_new[0, ~live] = float("nan")
    v_new[0, ~live] = float("nan")
    args = (q, k_new, v_new, cache, LAYER, bt, _ints(torch, lens), _ints(torch, starts),
            _ints(torch, offs))
    out = ragged_paged_prefill_attention(*args, logit_cap=logit_cap)
    err = compare(torch, f"ragged {geom} rows={rows}", out,
                  ragged_prefill_attention_ref(*args, logit_cap=logit_cap))
    check(bool((out[0, ~live] == 0).all()), f"ragged {geom}: padding tokens are not 0")
    return err


def kernel_phase(torch) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"decode": 0.0, "prefill": 0.0, "ragged": 0.0}
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
    # ragged: the unified layout (8 decode rows, contexts 1 to 2047, ahead of
    # a span from 0 and one from a block-aligned start, then padding rows),
    # softcap on and off, and a packed prefill as the engine's first dispatch
    decode_rows = [(n - 1, 1) for n in (1, 17, 100, 333, 1024, 1500, 2047, 64)]
    unified = decode_rows + [(0, 300), (256, 200)]
    for cap in (None, 50.0):
        e = ragged_case(torch, gen, unified, 16, 6, logit_cap=cap)
        log(f"kernel ragged unified layout (8 decode rows + 2 spans + 6 padding rows) "
            f"softcap={cap}: max abs err {e:.3g}")
        errs["ragged"] = max(errs["ragged"], e)
    e = ragged_case(torch, gen, [(0, 17), (0, 300), (0, 640), (0, 48)], 0, 0)
    log(f"kernel ragged packed prefill spans 17/300/640/48: max abs err {e:.3g}")
    errs["ragged"] = max(errs["ragged"], e)
    # MHA (G = 1, 64-token tiles) and G = 8 (8-token tiles) straddle rows
    for geom in ((8, 8, 64), (16, 2, 256)):
        e = ragged_case(torch, gen, [(4, 1), (299, 1), (76, 1), (0, 90), (64, 45)], 16, 3,
                        geom=geom)
        log(f"kernel ragged (H, Hk, D)={geom} 3 decode rows + 2 spans: max abs err {e:.3g}")
    return errs


def timing_phase(torch, card: str) -> dict:
    """Decode and prefill at the default path's shapes, timed and checked
    against their plain versions there: decode is one layer of a burst step
    (B = 8 slots, S = 1, the six requests mid-generation), and prefill the
    longest prompt's one dispatch (S = 1504, start = 0)."""
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


def ragged_timing(torch, card: str, mixed: dict) -> dict:
    """The ragged kernel at the largest mixed dispatch the token-budget
    serving run made (its row table as recorded; random bf16 q, K/V and
    pool), timed beside its plain version, one SDPA call on the same work
    laid out dense with a block-diagonal causal mask (the prefix gather
    excluded), and its bound on this card."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention, ragged_prefill_attention_ref)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    t, bt, lens, starts, offs = (mixed[k] for k in ("t", "bt", "lens", "starts", "offs"))
    cache = torch.randn((L, int(bt.max()) + 1, 2, BS, HK * D), generator=gen,
                        device="cuda").to(torch.bfloat16)
    q = torch.randn((1, t, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((1, t, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((1, t, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
    rows = (_ints(torch, lens), _ints(torch, starts), _ints(torch, offs))
    # successive launches walk the 32 layers, as a serving dispatch does
    kernel_ms = cuda_time_ms(lambda i: ragged_paged_prefill_attention(
        q, k, v, cache, i % L, bt, *rows), 32)
    plain_ms = cuda_time_ms(lambda i: ragged_prefill_attention_ref(
        q, k, v, cache, i % L, bt, *rows), 3, warmup=1)
    err = compare(torch, "ragged at the serving dispatch",
                  ragged_paged_prefill_attention(q, k, v, cache, LAYER, bt, *rows),
                  ragged_prefill_attention_ref(q, k, v, cache, LAYER, bt, *rows))
    # what the decode rows cost: each streams its prefix through a whole
    # 64-row tile with one token's rows live.  The same dispatch with the
    # decode rows' spans emptied (seq_len = start) runs the spans alone.
    dec = [r for r, (st, n, o) in enumerate(zip(starts, lens, offs)) if n - st == 1 and o == r]
    spans_only = [st if r in dec else n for r, (st, n) in enumerate(zip(starts, lens))]
    spans_rows = (_ints(torch, spans_only), rows[1], rows[2])
    spans_ms = cuda_time_ms(lambda i: ragged_paged_prefill_attention(
        q, k, v, cache, i % L, bt, *spans_rows), 32)

    # dense layout: each live row's queries; its prefix then its fresh keys
    qs, ks, vs, spans = [], [], [], []
    u = 0
    for r, (st, n, o) in enumerate(zip(starts, lens, offs)):
        f = n - st
        if f <= 0:
            continue
        blocks = bt[r, :-(-st // BS)].long()
        ks += [cache[LAYER, blocks, 0].reshape(-1, HK, D)[:st], k[0, o:o + f]]
        vs += [cache[LAYER, blocks, 1].reshape(-1, HK, D)[:st], v[0, o:o + f]]
        qs.append(q[0, o:o + f])
        spans.append((u, st, f))
        u += st + f
    qd = torch.cat(qs).transpose(0, 1)[None].contiguous()
    kd = torch.cat(ks).transpose(0, 1)[None].contiguous()
    vd = torch.cat(vs).transpose(0, 1)[None].contiguous()
    mask = torch.zeros((qd.shape[2], u), dtype=torch.bool, device="cuda")
    row0 = 0
    for base, st, f in spans:
        i = torch.arange(f, device="cuda")
        mask[row0:row0 + f, base:base + st] = True
        mask[row0:row0 + f, base + st:base + st + f] = i[None, :] <= i[:, None]
        row0 += f
    library_ms = cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), 10)

    r_rows, m = bt.shape
    flops = 4 * H * D * ragged_work(starts, lens)
    nbytes = (2 * (2 * t * H * D + 2 * t * HK * D) + 2 * 2 * sum(starts) * HK * D
              + 4 * (r_rows * m + 3 * r_rows))
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    out = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"time ragged T={t} rows={len(spans)}, starts {starts}, seq_lens {lens}: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}), max abs err {err:.3g}; without its "
        f"{len(dec)} decode rows the kernel takes {spans_ms:.4f} ms ({card})")
    out["err"] = err
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


def _kernel_wrappers() -> dict:
    from dynamo_tpu_torch.ops.kernels.decode_attention import paged_decode_attention
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention
    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention)

    return {"decode": paged_decode_attention, "prefill": paged_prefill_attention,
            "ragged": ragged_paged_prefill_attention}


def serve_run(torch, model, config: dict, card: str, label: str, profile: bool = False) -> dict:
    """Serve the six requests once through ``AsyncLLMEngine`` under one
    EngineConfig, with every kernel's launch counter zeroed just before and
    read just after; returns the streams, launches and engine counters."""
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.llm.protocols import FinishReason

    core = EngineCore(model, EngineConfig(**config), device="cuda")
    engine = AsyncLLMEngine(core).start()
    try:
        # warm-up request: first-launch costs stay out of the measurement
        asyncio.run(_serve(engine, [list(range(1, 40))]))
        wrappers = _kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        before = (core.steps, core.overlap_s, core.read_wait_s)
        t0 = time.perf_counter()
        results = asyncio.run(_serve(engine, prompts()))
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        metrics = core.metrics()
        dispatches = core.steps - before[0]
        overlap_ms = 1e3 * (core.overlap_s - before[1]) / dispatches
        wait_ms = 1e3 * (core.read_wait_s - before[2]) / dispatches
        for i, (_, _, outs) in enumerate(results):
            toks = [t for o in outs for t in o.token_ids]
            check(outs[-1].finish_reason is FinishReason.LENGTH,
                  f"{label} request {i}: finish {outs[-1].finish_reason}, expected length")
            check(len(toks) == MAX_TOKENS, f"{label} request {i}: {len(toks)} tokens")
            check(all(0 <= t < model.config.vocab_size for t in toks),
                  f"{label} request {i}: token out of range")
        cached = [outs[-1].cached_tokens for _, _, outs in results]
        check(max(cached[-2:]) >= SHARED_PREFIX,
              f"{label}: no request reused the shared {SHARED_PREFIX}-token prefix: {cached}")
        ttfts = [r[0] for r in results]
        decode_tokens = len(results) * (MAX_TOKENS - 1)
        decode_window = wall - min(ttfts)
        counters = {k: metrics[k] for k in (
            "prefill_dispatches_total", "prefill_batch_occupancy", "unified_dispatches_total",
            "unified_decode_rows", "unified_prefill_tokens", "lookahead_bursts_total",
            "lookahead_hits_total", "lookahead_mispredicts_total", "lookahead_commits_total",
            "lookahead_flushes_total", "device_gets_total")}
        log(f"serving {label}: {len(results)} requests, wall {wall:.3f} s, TTFT min/median/max "
            f"{min(ttfts):.3f}/{sorted(ttfts)[len(ttfts) // 2]:.3f}/{max(ttfts):.3f} s, decode "
            f"{decode_tokens / decode_window:.1f} tok/s over {decode_window:.3f} s, cached {cached}, "
            f"host gap {metrics['host_gap_ms_per_turn']:.2f} ms/turn, {dispatches} dispatches, "
            f"per dispatch: overlap-window host work {overlap_ms:.2f} ms, result-read wait "
            f"{wait_ms:.2f} ms, launches {launches}, counters {json.dumps(counters)} ({card})")
        if profile:
            profile_serving(torch, engine, prompts(seed=1), card)
    finally:
        engine.shutdown()
    streams = [[t for o in outs for t in o.token_ids] for _, _, outs in results]
    return dict(launches=launches, metrics=metrics, streams=streams)


@contextlib.contextmanager
def recorded_ragged_calls():
    """Record the row table of every ragged attention call the model makes
    at layer 0 (one per dispatch), by wrapping the routing's reference to
    the kernel's wrapper; the wrapper itself, and its launch count, are
    untouched."""
    from dynamo_tpu_torch.ops import paged_attention as routing

    real = routing.ragged_paged_prefill_attention
    calls = []

    def recording(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets,
                  *args, **kw):
        if layer == 0:
            calls.append((q.shape[1], block_tables, seq_lens, starts, row_offsets))
        return real(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets,
                    *args, **kw)

    routing.ragged_paged_prefill_attention = recording
    try:
        yield calls
    finally:
        routing.ragged_paged_prefill_attention = real


def ragged_work(starts, lens) -> int:
    """Visible (query, key) pairs of a ragged dispatch: each row's fresh
    tokens see its whole prefix and their own span causally."""
    return sum((n - st) * st + (n - st) * (n - st + 1) // 2 for st, n in zip(starts, lens))


def largest_mixed(calls) -> dict:
    """The recorded dispatch with the most attention work among those that
    mix decode rows (1-token rows at the head of the axis) with spans."""
    best = None
    for t, bt, lens, starts, offs in calls:
        lens, starts, offs = lens.tolist(), starts.tolist(), offs.tolist()
        fresh = [n - st for n, st in zip(lens, starts)]
        mixed = fresh and fresh[0] == 1 and offs[0] == 0 and max(fresh) > 1
        if mixed and (best is None or ragged_work(starts, lens) > ragged_work(best["starts"],
                                                                               best["lens"])):
            best = dict(t=t, bt=bt, lens=lens, starts=starts, offs=offs)
    check(best is not None, "the token-budget run made no mixed dispatch")
    return best


def serving_phase(torch, card: str):
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = llama3_8b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda"))
    torch.cuda.synchronize()
    log(f"serving: Llama-3-8B, {cfg.num_layers} layers, random weights in "
        f"{time.perf_counter() - t0:.1f} s")
    default = serve_run(torch, model, DEFAULT_PATH, card, "default path", profile=True)
    check(default["launches"]["decode"] > 0 and default["launches"]["prefill"] > 0,
          f"a kernel was not launched on the default path: {default['launches']}")
    torch.cuda.empty_cache()  # the first engine and its cache are gone
    with recorded_ragged_calls() as calls:
        budget = serve_run(torch, model, BUDGET_PATH, card, "token-budget path")
    m = budget["metrics"]
    check(budget["launches"]["ragged"] > 0 and budget["launches"]["decode"] > 0,
          f"a kernel was not launched on the token-budget path: {budget['launches']}")
    check(m["unified_dispatches_total"] > 0 and m["lookahead_bursts_total"] > 0,
          f"the token-budget path made no mixed dispatch or no burst: {m}")
    same = sum(a == b for a, b in zip(default["streams"], budget["streams"]))
    log(f"serving: {same} of {len(default['streams'])} token-budget streams equal the default "
        f"path's (informational: the kernels round bf16 at different places) ({card})")
    mixed = largest_mixed(calls)
    del model, calls
    torch.cuda.empty_cache()
    return default, budget, mixed


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


def _ragged_logits(torch, model, device, dispatches):
    """Run ragged dispatches over a fresh cache; each is (rows, region)
    with rows (tokens, start, block table) laid out by
    :func:`ragged_layout`.  Returns the logits at every row's last token."""
    m = 2048 // BS
    n_blocks = 1 + max(b for rows, _ in dispatches for _, _, table in rows for b in table)
    cache = model.init_kv_cache(n_blocks, BS)
    logits = []

    def ints(xs):
        return torch.tensor(xs, dtype=torch.int32, device=device)

    for rows, region in dispatches:
        t, starts, lens, offs = ragged_layout([(st, len(toks)) for toks, st, _ in rows], region, 0)
        tokens = torch.zeros((1, t), dtype=torch.int32)
        pos = torch.zeros((1, t), dtype=torch.int32)
        slot = torch.full((1, t), -1, dtype=torch.int32)
        seq_ids = torch.full((1, t), -1, dtype=torch.int32)
        bt = torch.zeros((len(rows), m), dtype=torch.int32)
        for r, ((toks, st, table), o) in enumerate(zip(rows, offs)):
            n = len(toks)
            bt[r, :len(table)] = torch.tensor(table, dtype=torch.int32)
            tokens[0, o:o + n] = torch.tensor(toks, dtype=torch.int32)
            p = torch.arange(st, st + n)
            pos[0, o:o + n] = p
            slot[0, o:o + n] = bt[r, p // BS] * BS + p % BS
            seq_ids[0, o:o + n] = r
        max_pb = max(-(-st // BS) for st in starts)
        pb = 0 if max_pb == 0 else min(m, 1 << (max_pb - 1).bit_length())
        last = torch.tensor([o + n - st - 1 for st, n, o in zip(starts, lens, offs)])
        hidden, _ = model.forward(tokens.to(device), pos.to(device), cache, bt.to(device),
                                  ints(lens), slot.to(device), prefix_blocks=pb,
                                  ragged=(seq_ids.to(device), ints(starts), ints(offs)),
                                  ragged_row_tokens=region)
        logits.append(model.compute_logits(hidden[0, last.to(device)]).float().cpu())
    return torch.cat(logits)


def _hold_logits(torch, what: str, a, b, card: str) -> None:
    check(bool(torch.isfinite(a).all()), f"{what}: non-finite logits on the card")
    rel_l2 = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
    max_rel = ((a - b).abs().amax(dim=-1) / b.abs().amax(dim=-1)).max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"parity {what}: max rel L2 {rel_l2:.3g} (tol {PARITY_REL_L2}), max |diff|/max|logit| "
        f"{max_rel:.3g} (tol {PARITY_MAX_REL}), argmax agreement {agree:.3f} ({card})")
    check(rel_l2 <= PARITY_REL_L2, f"parity {what}: rel L2 {rel_l2} > {PARITY_REL_L2}")
    check(max_rel <= PARITY_MAX_REL, f"parity {what}: max rel {max_rel} > {PARITY_MAX_REL}")


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
    _hold_logits(torch, "default path: 2-layer 8B width, 300-token prompt over a 128-token "
                 "prefix + 8 decode steps",
                 _forward_logits(torch, gpu, torch.device("cuda"), prompt, steps, prefix=128),
                 _forward_logits(torch, cpu, torch.device("cpu"), prompt, steps, prefix=128),
                 card)

    # a packed prefill of A, B and C's head, then a mixed dispatch: decode
    # rows for A and B ahead of D from 0 and C's rest from 128
    a, b, c, d = (rng.integers(0, cfg.vocab_size, n).tolist() for n in (200, 97, 300, 150))
    x, y = rng.integers(0, cfg.vocab_size, 2).tolist()
    tables, nxt = [], 1
    for n in (201, 98, 300, 150):
        nb = -(-n // BS)
        tables.append(list(range(nxt, nxt + nb)))
        nxt += nb
    dispatches = [
        ([(a, 0, tables[0]), (b, 0, tables[1]), (c[:128], 0, tables[2])], 0),
        ([([x], 200, tables[0]), ([y], 97, tables[1]), (d, 0, tables[3]),
          (c[128:], 128, tables[2])], 16),
    ]
    _hold_logits(torch, "ragged: 2-layer 8B width, packed prefill of 3 spans, then 2 decode "
                 "rows + 2 spans",
                 _ragged_logits(torch, gpu, torch.device("cuda"), dispatches),
                 _ragged_logits(torch, cpu, torch.device("cpu"), dispatches), card)


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
        default, budget, mixed = serving_phase(torch, card)
        times["ragged"] = ragged_timing(torch, card, mixed)
        times["ragged_err"] = times["ragged"].pop("err")
        parity_phase(torch, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: each kernel's count over the serving run of the path it
    # carries (decode and prefill: the default path; ragged: the token-budget path)
    kernels = [
        dict(name="paged_decode_attention", route="cuda",
             source="dynamo_tpu_torch/csrc/decode_attention.cu",
             replaces="dynamo_tpu/ops/pallas/decode_attention.py:281",
             launches=default["launches"]["decode"],
             max_abs_err=max(errs["decode"], times["decode_err"]), **times["decode"]),
        dict(name="paged_prefill_attention", route="cuda",
             source="dynamo_tpu_torch/csrc/prefill_attention.cu",
             replaces="dynamo_tpu/ops/pallas/prefill_attention.py:246",
             launches=default["launches"]["prefill"],
             max_abs_err=max(errs["prefill"], times["prefill_err"]), **times["prefill"]),
        dict(name="ragged_paged_prefill_attention", route="cuda",
             source="dynamo_tpu_torch/csrc/ragged_prefill_attention.cu",
             replaces="dynamo_tpu/ops/pallas/prefill_attention.py:593",
             launches=budget["launches"]["ragged"],
             max_abs_err=max(errs["ragged"], times["ragged_err"]), **times["ragged"]),
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
