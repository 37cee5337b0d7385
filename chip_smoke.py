#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dynamo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # one CUDA card; nvcc on PATH or in $CUDA_HOME/bin

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit, from nvidia-smi;
2. build: every ``dynamo_tpu_torch/csrc/*.cu`` compiled with nvcc for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card.
   The attention kernels run at Llama-3-8B attention geometry (H=32, Hk=8,
   D=128, L=32, layer index 5) and at D = 64 and 256, over a bf16 cache
   (Bs=16) with NaN in every dead slot and padding K/V, and over an int8
   cache (Bs=16 and 32) with random codes in every dead slot and NaN in
   every dead slot's scale and every pad lane of the scale tiles.  The
   ragged kernels also run at their block edges (G = 1, 4 and 8 at D =
   64, 128 and 256; spans cut by and ending on span-block boundaries; a
   full 16-row decode region with contexts 1 to 2047; starts inside a
   64-key tile; softcap on and off; bf16, and int8 at Bs = 16 and 32), and
   every ragged launch is run twice and must give the same bits.  The
   int8 decode and prefill kernels also run at their edges (G = 1, 4 and 8
   at D = 64, 128 and 256, Bs = 16 and 32; decode at S = 1 and 8 with
   contexts 0 to 2048 either side of its chunks and tiles, each launch run
   twice for the same bits; prefill from a start inside a key tile).  The
   W8A16 matmul runs at every projection shape of Llama-3-8B and its
   lm_head (f32 out), at M = 1 to 1504 across both regimes' edges, for a
   [K, N] weight and for the transpose of an [N, K] one, then at ragged
   shapes (N = 32002 or 1000, K = 4104), and a split-K launch is run twice
   and must give the same bits.  Then decode, prefill and the
   matmul are timed at the serving paths' shapes (decode and the matmul as
   CUDA graphs, the card's time, and eagerly for the log) beside their plain
   versions, a PyTorch library call on the same work (the median of three
   readings, timed as its kernel is: decode's SDPA also as a CUDA graph),
   and their bound on this card;
4. serving: Llama-3-8B at full width and depth (random weights from a
   seeded generator) behind ``AsyncLLMEngine``, six concurrent greedy
   requests (17 to 1500 prompt tokens, two sharing a 256-token prefix),
   twice on the bf16 model: the default path (one-request prefill, decode
   bursts), then the token-budget path (``prefill_token_budget=1024``,
   unified mixed dispatch, lookahead bursts); then the bf16 model is freed
   and the same two runs are made on an int8 model (int8 weights drawn
   directly, ``cache_dtype="int8"``, ``block_size=32`` as ``bench.py``
   serves on an accelerator).  Every kernel's launch counter is zeroed just
   before each run and read just after; the ragged kernels are then timed
   at the largest mixed dispatch of each token-budget run, with its decode
   rows and without them;
5. parity: 2-layer models at full 8B width on the card (kernels, bf16) and
   on the CPU (plain PyTorch, f32), bf16 weights with a bf16 cache and int8
   weights with an int8 cache: one 300-token prompt over a 128-token cached
   prefix then 8 decode steps, and one packed prefill then one mixed
   ragged dispatch (two decode rows, two spans); logits held to a stated
   tolerance.

Then one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "dynamo_tpu_torch").is_dir():
    sys.exit("chip_smoke: dynamo_tpu_torch/ is not beside this script")
sys.path.insert(0, str(ROOT))

from dynamo_tpu_torch.tools.cuda_timing import (  # noqa: E402
    LM_HEAD, PROJECTIONS, card_line, cuda_time_ms, graph_time_ms, median_ms, ragged_layout)

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
# the same two on the int8 model: int8 KV cache in 32-token blocks
# (bench.py's accelerator defaults)
BS_Q8 = 32
INT8_DEFAULT_PATH = dict(DEFAULT_PATH, block_size=BS_Q8, cache_dtype="int8")
INT8_BUDGET_PATH = dict(BUDGET_PATH, block_size=BS_Q8, cache_dtype="int8")
# the W8A16 checks' row counts: both regimes' edges, decode and prefill
MATMUL_ROWS = (1, 6, 8, 16, 17, 64, 65, 128, 129, 300, 1504)
# [K, N] with rows off 16 bytes in one layout or both (a 32002-token
# vocabulary, a depth of 4104), at row counts of both regimes
RAGGED_MATMULS = ((4096, 32002), (4104, 32002), (4104, 1000))
RAGGED_MATMUL_ROWS = (1, 8, 16, 17, 300)

# bf16 tolerance, kernel vs plain version on identical bf16 inputs, per
# element: |out - ref| <= KERNEL_ATOL + KERNEL_RTOL * |ref|.  Both sides
# accumulate in f32 and round the output to bf16 once, and summation-order
# noise can tip that rounding by one bf16 ulp (<= |x| / 128); the prefill
# kernel also rounds the softmax probabilities to bf16 for the tensor-core
# PV product (2**-9 relative per term, <= 0.01 absolute for V rows drawn
# from N(0, 1)).  RTOL allows two ulps, ATOL the probability rounding.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 2.0 ** -6
# The int8 kernels are held to the same form and numbers.  Their inputs
# are int8 codes times f32 scales drawn so the dequantised values are of
# order 1, as the bf16 inputs are: int8 -> bf16 is exact, the scales apply
# in f32, and the one extra rounding (the attention kernels round P times
# the V scale to bf16 for the tensor-core PV product, 2**-9 relative per
# term) is the probability rounding ATOL already allows.  The W8A16 kernel
# accumulates exact bf16 x int8 products in f32 in another order than the
# plain version and rounds once, which RTOL covers.
# 2-layer model, card (bf16 activations) vs CPU (f32), same bf16 weights:
# ~a dozen bf16 roundings of 2**-9 relative each compound to ~1e-2.  With
# int8 weights and an int8 cache the weights are the same codes on both
# sides; the cache quantises bf16 activations on the card and f32 ones on
# the CPU, so some codes differ by one step (1/127 of a row's amax), which
# adds noise of the order of the bf16 roundings: the same bounds hold.
PARITY_REL_L2 = 5e-2
PARITY_MAX_REL = 1e-1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# kernels whose every instantiation must be in the library: the paged
# prefill kernel at three head dims over bf16 and int8 caches; the int8
# decode kernel at D = 64 and 128 with 4, 8 or 16 query rows and at D = 256
# with 4 or 8
SASS_INSTANTIATIONS = {"wgmma_prefill_kernel": 6, "decode_q8_kernel": 8}


def sass_check(torch, lib_path) -> None:
    """The redesigned kernels as compiled: the wgmma kernels (B5 above 16
    rows, the paged prefill kernels B2 and B4b, and every ragged
    instantiation, B3 and B4c) issue HGMMA, and they, B5's decode kernel and
    the int8 decode kernel (B4a) copy with LDGSTS (cp.async), except B5's
    instantiations for rows off 16 bytes (template flag VEC = false), which
    copy element by element.  Logged per kernel; a missing instruction
    fails."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()[:500]}")
    counts, name = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "LDGSTS" in line

    def copies_async(n):  # B5's last template argument is VEC
        m = re.search(r"w8a16_\w+?_kernelI(.*?)EE", n)
        return m is None or m.group(1).endswith("Lb1")

    want = {"w8a16_wgmma_kernel": True, "wgmma_prefill_kernel": True, "ragged_kernel": True,
            "w8a16_decode_kernel": False, "decode_q8_kernel": False}
    for key, needs_hgmma in want.items():
        found = {n: c for n, c in counts.items() if key in n}
        check(bool(found), f"sass: no {key} in the library")
        for n, (hgmma, ldgsts) in found.items():
            check((ldgsts > 0 or not copies_async(n)) and (hgmma > 0 or not needs_hgmma),
                  f"sass: {n[:80]} has HGMMA {hgmma}, LDGSTS {ldgsts}")
        check(len(found) >= SASS_INSTANTIATIONS.get(key, 1),
              f"sass: {len(found)} instantiations of {key}, expected {SASS_INSTANTIATIONS.get(key, 1)}")
        log(f"sass {key}: {len(found)} instantiations, HGMMA "
            f"{sorted({c[0] for c in found.values()})}, LDGSTS {sorted({c[1] for c in found.values()})}")


# ------------------------------------------------------------------ kernels
def _live_slots(torch, n_blocks, tables, lens, bs):
    """[N, Bs] bool on the card: the slots some row owns below its length."""
    live = torch.zeros((n_blocks, bs), dtype=torch.bool)
    for row, n in zip(tables.tolist(), lens):
        pos = torch.arange(n)
        live[torch.tensor(row)[pos // bs], pos % bs] = True
    return live.cuda()


def _poisoned_cache(torch, gen, n_blocks, tables, lens, hkd, bs=BS):
    """A random bf16 cache [L, N, 2, Bs, Hk*D] whose every slot no row
    owns below its length is NaN, in every layer."""
    cache = torch.randn((L, n_blocks, 2, bs, hkd), generator=gen, device="cuda",
                        dtype=torch.float32).to(torch.bfloat16)
    live = _live_slots(torch, n_blocks, tables, lens, bs)
    cache.masked_fill_(~live[None, :, None, :, None], float("nan"))
    return cache


def _q8_cache(torch, gen, n_blocks, hk, d, bs, tables=None, lens=None):
    """A random int8 cache (QuantKvCache) [L, N, 2, Bs, Hk*D]: random codes
    everywhere, scales that make the dequantised values of order 1 (the
    codes' standard deviation is about 73.3).  With ``tables`` and
    ``lens``, every slot no row owns below its length keeps its random
    codes but gets a NaN scale, and every pad lane of the scale tiles is
    NaN."""
    from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, scale_tile

    data = torch.randint(-127, 128, (L, n_blocks, 2, bs, hk * d), generator=gen, device="cuda",
                         dtype=torch.int8)
    hp, sp = scale_tile(hk, bs)
    scale = torch.ones((L, n_blocks, 2, hp, sp), device="cuda")
    valid = scale[..., :hk, :bs]
    valid.copy_((0.5 + torch.rand(valid.shape, generator=gen, device="cuda")) / 73.3)
    if tables is not None:
        scale[..., hk:, :] = float("nan")
        scale[..., bs:] = float("nan")
        live = _live_slots(torch, n_blocks, tables, lens, bs)
        valid.masked_fill_(~live[None, :, None, None, :], float("nan"))
    return QuantKvCache(data, scale)


def _tables(torch, lens, m, n_blocks, gen, bs=BS):
    """Disjoint random block tables [B, m], 0-filled past each row's
    blocks (the engine's layout)."""
    perm = torch.randperm(n_blocks, generator=gen, device="cuda").tolist()
    bt = torch.zeros((len(lens), m), dtype=torch.int32)
    k = 0
    for i, n in enumerate(lens):
        nb = -(-n // bs)
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


def _attention_cache(torch, gen, n_blocks, bt, live_lens, hk, d, bs, quant):
    """The poisoned cache of a kernel check: bf16, or int8 (``quant``)."""
    if quant:
        return _q8_cache(torch, gen, n_blocks, hk, d, bs, bt.cpu(), live_lens)
    return _poisoned_cache(torch, gen, n_blocks, bt.cpu(), live_lens, hk * d, bs)


def decode_case(torch, gen, lens, s, logit_cap, geom=(H, HK, D), bs=BS, quant=False):
    from dynamo_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention, paged_decode_attention_q8)

    m = 2048 // bs
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen, bs)
    h, hk, d = geom
    cache = _attention_cache(torch, gen, n_blocks, bt, lens, hk, d, bs, quant)
    b = len(lens)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q0 = (seq_lens - s).clamp_min(0)
    args = (q, cache, LAYER, bt, seq_lens, q0)
    kernel = paged_decode_attention_q8 if quant else paged_decode_attention
    out = kernel(*args, logit_cap=logit_cap)
    what = f"decode {'int8 ' if quant else ''}{geom} Bs={bs} S={s} cap={logit_cap} lens={lens}"
    err = compare(torch, what, out, decode_attention_ref(*args, logit_cap=logit_cap))
    for i, n in enumerate(lens):
        if n == 0:
            check(bool((out[i] == 0).all()), f"decode S={s}: zero-length row {i} is not 0")
    if quant:  # the split-K merge is in chunk order: the same bits every launch
        check(torch.equal(out, kernel(*args, logit_cap=logit_cap)), f"{what}: two launches differ")
    return err


def prefill_case(torch, gen, starts, fresh, s, geom=(H, HK, D), bs=BS, quant=False, logit_cap=None):
    from dynamo_tpu_torch.ops.kernels.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_q8, prefill_attention_ref)

    m = 2048 // bs
    lens = [st + f for st, f in zip(starts, fresh)]
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen, bs)
    # only the cached prefix is live in the cache; fresh slots stay poisoned
    h, hk, d = geom
    cache = _attention_cache(torch, gen, n_blocks, bt, starts, hk, d, bs, quant)
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
    kernel = paged_prefill_attention_q8 if quant else paged_prefill_attention
    out = kernel(*args, logit_cap=logit_cap)
    err = compare(torch, f"prefill {'int8 ' if quant else ''}{geom} Bs={bs} starts={starts} fresh={fresh} "
                  f"cap={logit_cap}", out, prefill_attention_ref(*args, logit_cap=logit_cap))
    for i, f in enumerate(fresh):
        check(bool((out[i, f:] == 0).all()), f"prefill: padding rows of row {i} are not 0")
    return err


def ragged_case(torch, gen, rows, region, n_pad, geom=(H, HK, D), logit_cap=None, bs=BS,
                quant=False):
    """The ragged kernel against its plain version on one layout: the pool
    is poisoned except each row's live prefix, and padding K/V is NaN;
    padding tokens must come out exactly 0, and a second launch must give
    the same bits."""
    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention, ragged_paged_prefill_attention_q8,
        ragged_prefill_attention_ref)

    m = 2048 // bs
    t, starts, lens, offs = ragged_layout(rows, region, n_pad, bs)
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen, bs)
    h, hk, d = geom
    cache = _attention_cache(torch, gen, n_blocks, bt, starts, hk, d, bs, quant)
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
    kernel = ragged_paged_prefill_attention_q8 if quant else ragged_paged_prefill_attention
    out = kernel(*args, logit_cap=logit_cap)
    what = f"ragged {'int8 ' if quant else ''}{geom} Bs={bs} rows={rows}"
    err = compare(torch, what, out, ragged_prefill_attention_ref(*args, logit_cap=logit_cap))
    check(bool((out[0, ~live] == 0).all()), f"{what}: padding tokens are not 0")
    check(torch.equal(out, kernel(*args, logit_cap=logit_cap)), f"{what}: two launches differ")
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
    # the bf16 kernel's tile edges: softcap; fresh lengths off the token tile
    # (128 / G tokens); a start that is block-aligned but not 64-aligned, so
    # a 64-key tile crosses it into poisoned slots; G = 64 (two tokens per
    # block); each at D = 64, 128 and 256
    for starts, fresh, s, geom, cap in (
            ([0, 80], [77, 301], 320, (H, HK, D), 50.0),
            ([80, 1040], [45, 1], 64, (H, HK, D), None),
            ([80], [45], 48, (64, 1, 128), None),
            ([48], [33], 48, (64, 1, 64), 50.0),
            ([80, 16], [100, 7], 112, (16, 2, 256), 50.0),
            ([0], [129], 144, (8, 8, 64), None)):
        e = prefill_case(torch, gen, starts=starts, fresh=fresh, s=s, geom=geom, logit_cap=cap)
        log(f"kernel prefill (H, Hk, D)={geom} S={s} start={starts} fresh={fresh} softcap={cap}: "
            f"max abs err {e:.3g}")
        errs["prefill"] = max(errs["prefill"], e)
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
    errs.update(q8_kernel_phase(torch, gen))
    for key, e in ragged_edge_phase(torch, gen).items():
        errs[key] = max(errs[key], e)
    errs["matmul"] = matmul_phase(torch, gen)
    return errs


def q8_kernel_phase(torch, gen) -> dict:
    """The three int8 attention kernels against their plain version, at
    the bf16 checks' layouts and at both block sizes, then the int8 decode
    and prefill kernels at their edges."""
    errs = {"decode_q8": 0.0, "prefill_q8": 0.0, "ragged_q8": 0.0}
    mixed = [0, 1, 17, 100, 333, 1024, 1500, 2048]
    decode_rows = [(n - 1, 1) for n in (1, 17, 100, 333, 1024, 1500, 2047, 64)]
    for bs in (16, BS_Q8):
        for s in (1, 4):
            for cap in (None, 50.0):
                e = decode_case(torch, gen, mixed, s, cap, bs=bs, quant=True)
                log(f"kernel decode int8 Bs={bs} B=8 S={s} softcap={cap}: max abs err {e:.3g}")
                errs["decode_q8"] = max(errs["decode_q8"], e)
        e = prefill_case(torch, gen, starts=[0, 256], fresh=[512, 500], s=512, bs=bs, quant=True)
        log(f"kernel prefill int8 Bs={bs} B=2 S=512 start=[0, 256]: max abs err {e:.3g}")
        errs["prefill_q8"] = max(errs["prefill_q8"], e)
        e = prefill_case(torch, gen, starts=[1024, 96], fresh=[300, 45], s=320, bs=bs, quant=True)
        log(f"kernel prefill int8 Bs={bs} B=2 S=320 start=[1024, 96]: max abs err {e:.3g}")
        errs["prefill_q8"] = max(errs["prefill_q8"], e)
        for cap in (None, 50.0):
            e = ragged_case(torch, gen, decode_rows + [(0, 300), (256, 200)], 16, 6,
                            logit_cap=cap, bs=bs, quant=True)
            log(f"kernel ragged int8 Bs={bs} unified layout softcap={cap}: max abs err {e:.3g}")
            errs["ragged_q8"] = max(errs["ragged_q8"], e)
        for geom in ((8, 8, 64), (16, 2, 256)):
            d_err = decode_case(torch, gen, [0, 5, 300], 2, None, geom=geom, bs=bs, quant=True)
            p_err = prefill_case(torch, gen, starts=[64], fresh=[90], s=96, geom=geom, bs=bs,
                                 quant=True)
            r_err = ragged_case(torch, gen, [(4, 1), (299, 1), (76, 1), (0, 90), (64, 45)], 16, 3,
                                geom=geom, bs=bs, quant=True)
            log(f"kernel int8 (H, Hk, D)={geom} Bs={bs}: decode S=2 max abs err {d_err:.3g}, "
                f"prefill start=64 {p_err:.3g}, ragged 3 decode rows + 2 spans {r_err:.3g}")
    for key, e in q8_edge_phase(torch, gen).items():
        errs[key] = max(errs[key], e)
    return errs


# The int8 decode (B4a) and prefill (B4b) kernels' edges, at G = 1, 4 and 8
# (H, Hk, D below) and Bs = 16 and 32.  B4a: contexts 0 and 1, either side
# of its 64-token chunks and 16-key tiles, and the whole 2048-token table,
# at S = 1 and 8 (8 x G query rows: one to eight row groups), each launched
# twice for the same bits.  B4b: a start inside a key tile (block-aligned,
# not tile-aligned), fresh lengths off the token tile (128 / G tokens).
Q8_EDGE_GEOMS = ((8, 8, 64), (32, 8, 128), (16, 2, 256))
DECODE_EDGE_LENS = [0, 1, 15, 17, 63, 64, 65, 127, 129, 2047, 2048]


def q8_edge_phase(torch, gen) -> dict:
    errs = {"decode_q8": 0.0, "prefill_q8": 0.0}
    i = 0
    for geom in Q8_EDGE_GEOMS:
        keys = 32 if geom[2] == 256 else 64  # the prefill kernel's key tile
        for bs in (16, BS_Q8):
            for s in (1, 8):
                cap = 50.0 if i % 2 else None
                i += 1
                e = decode_case(torch, gen, DECODE_EDGE_LENS, s, cap, geom=geom, bs=bs, quant=True)
                errs["decode_q8"] = max(errs["decode_q8"], e)
                log(f"kernel decode int8 edges (H, Hk, D)={geom} Bs={bs} S={s} softcap={cap} contexts "
                    f"{DECODE_EDGE_LENS}: max abs err {e:.3g}, two launches bit-identical")
            start = next((st for st in range(bs, 4 * keys, bs) if st % keys), bs)
            cap = 50.0 if i % 2 else None
            i += 1
            e = prefill_case(torch, gen, starts=[start, 0], fresh=[155, 77], s=160, geom=geom, bs=bs,
                             quant=True, logit_cap=cap)
            errs["prefill_q8"] = max(errs["prefill_q8"], e)
            log(f"kernel prefill int8 edges (H, Hk, D)={geom} Bs={bs} start=[{start}, 0] fresh=[155, 77] "
                f"softcap={cap}: max abs err {e:.3g}")
    return errs


# The ragged kernels' block edges.  (H, Hk, D): G = 1, 4 and 8 (span blocks
# of 128, 32 and 16 tokens) at D = 64, 128 and 256.  Layouts (rows, decode
# region, padding rows): spans that end on a 128-, 32- and 16-token block
# boundary and spans that a boundary cuts; a full 16-row decode region with
# contexts 1 to 2047 (64 k and 64 k + 1 keys among them) ahead of a span;
# spans from starts inside a 64-key tile, one at a flat offset inside one.
RAGGED_EDGE_GEOMS = ((8, 8, 64), (32, 8, 128), (16, 2, 256))
RAGGED_EDGE_LAYOUTS = {
    "block boundaries": ([(0, 128), (48, 96), (0, 200)], 0, 2),
    "full decode region": ([(n - 1, 1) for n in (1, 2, 17, 63, 64, 65, 100, 128, 129, 333, 640, 1024,
                                                 1025, 1500, 2000, 2047)] + [(0, 90)], 16, 1),
    "misaligned starts": ([(5, 1), (80, 150), (16, 45)], 16, 2),
}


def ragged_edge_phase(torch, gen) -> dict:
    """Both ragged kernels at every edge geometry and layout, bf16 and int8
    at Bs = 16 and 32, softcap on for every other case; each case also
    checks that padding tokens are 0 and two launches give the same bits."""
    errs = {"ragged": 0.0, "ragged_q8": 0.0}
    i = 0
    for geom in RAGGED_EDGE_GEOMS:
        for name, (rows, region, n_pad) in RAGGED_EDGE_LAYOUTS.items():
            for quant, bs in ((False, BS), (True, 16), (True, BS_Q8)):
                cap = 50.0 if i % 2 else None
                i += 1
                e = ragged_case(torch, gen, rows, region, n_pad, geom=geom, logit_cap=cap, bs=bs,
                                quant=quant)
                key = "ragged_q8" if quant else "ragged"
                errs[key] = max(errs[key], e)
                log(f"kernel ragged edges {'int8' if quant else 'bf16'} Bs={bs} (H, Hk, D)={geom} {name} "
                    f"softcap={cap}: max abs err {e:.3g}, two launches bit-identical")
    return errs


def _q8_weight(torch, gen, k, n, layout):
    """A random int8 weight [K, N] as the model holds it ("kn"), or as the
    transpose of a row-major [N, K] one ("nk", the tied embedding), with
    scales that make x @ w of order 1 for x of order 1."""
    shape = (k, n) if layout == "kn" else (n, k)
    wq = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    scale = (0.5 + torch.rand(n, generator=gen, device="cuda")) / (73.3 * math.sqrt(k))
    return (wq if layout == "kn" else wq.t()), scale


def matmul_phase(torch, gen) -> float:
    """The W8A16 kernel against its plain version at every matmul shape of
    Llama-3-8B, both weight layouts, at row counts on both sides of the
    decode regime's limit (16) and of the wgmma regime's 128-row tiles, and
    at the serving paths' decode and prefill counts; then at ragged shapes
    (rows off 16 bytes: a 32002-token vocabulary, a depth of 4104), and a
    split-K launch run twice, which must give the same bits."""
    from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    worst = 0.0
    shapes = dict(PROJECTIONS, lm_head=LM_HEAD)
    for name, (k, n) in shapes.items():
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        errs = []
        for layout in ("kn", "nk"):
            wq, scale = _q8_weight(torch, gen, k, n, layout)
            for m in MATMUL_ROWS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                out = int8_matmul(x, wq, scale, out_dtype)
                check(out.dtype == out_dtype and out.shape == (m, n), f"matmul {name}: {out.shape}")
                errs.append(compare(torch, f"matmul {name} [{k}, {n}] {layout} M={m}", out,
                                    int8_matmul_ref(x, wq, scale, out_dtype)))
            del wq, scale
        log(f"kernel matmul {name} [K, N]=[{k}, {n}] M in {MATMUL_ROWS}, both layouts: "
            f"max abs err {max(errs):.3g}")
        worst = max(worst, *errs)
    for k, n in RAGGED_MATMULS:
        errs = []
        for layout in ("kn", "nk"):
            wq, scale = _q8_weight(torch, gen, k, n, layout)
            for m in RAGGED_MATMUL_ROWS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                errs.append(compare(torch, f"matmul [{k}, {n}] {layout} M={m}", int8_matmul(x, wq, scale),
                                    int8_matmul_ref(x, wq, scale)))
            del wq, scale
        log(f"kernel matmul ragged [K, N]=[{k}, {n}] M in {RAGGED_MATMUL_ROWS}, both layouts: "
            f"max abs err {max(errs):.3g}")
        worst = max(worst, *errs)
    # wk splits K 64 ways at M = 8 (decode regime), 16 ways at M = 64
    # (wgmma regime): the same bits twice
    for name, m in (("wk", 8), ("wk", 64)):
        k, n = PROJECTIONS[name]
        wq, scale = _q8_weight(torch, gen, k, n, "kn")
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        check(torch.equal(int8_matmul(x, wq, scale), int8_matmul(x, wq, scale)),
              f"matmul {name} M={m}: two runs of the split-K launch differ")
    log("kernel matmul split K, wk at M=8 and M=64: two runs bit-identical")
    return worst


def _sdpa_decode_ms(torch, q, lens, dense_kv) -> tuple[float, float]:
    """SDPA on one decode step's layer, the decode kernels' library
    yardstick: q [B, 1, H, D] over each layer's K/V laid out dense
    beforehand (``dense_kv(layer)`` gives [B, Hk, T, D] twice), successive
    calls walking the 32 layers as the kernels do.  Timed as the kernels
    are, as a CUDA graph of the 32 calls (the card's time) and launched
    eagerly; medians of three readings."""
    import torch.nn.functional as F

    kvs = [dense_kv(layer) for layer in range(L)]
    seq = torch.tensor(lens, device="cuda")
    mask = (torch.arange(kvs[0][0].shape[2], device="cuda")[None, :] < seq[:, None])[:, None, None, :]
    qd = q.transpose(1, 2).contiguous()
    calls = [lambda kv=kv: F.scaled_dot_product_attention(qd, *kv, attn_mask=mask, enable_gqa=True)
             for kv in kvs]
    graph_ms = median_ms(lambda: graph_time_ms(calls, 20) / L)
    eager_ms = median_ms(lambda: cuda_time_ms(lambda i: calls[i % L](), 64))
    return graph_ms, eager_ms


def timing_phase(torch, card: str) -> dict:
    """Decode and prefill at the default path's shapes, timed and checked
    against their plain versions there: decode is one layer of a burst step
    (B = 8 slots, S = 1, the six requests mid-generation; timed as a CUDA
    graph, as the int8 decode kernel is), and prefill the longest prompt's
    one dispatch (S = 1504, start = 0)."""
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
    # the context is not served from L2; timed as a CUDA graph of the 32
    # calls (the card's time) and, for the log, launched eagerly
    calls = [lambda i=i: paged_decode_attention(q, cache, i, bt, seq_lens, q0) for i in range(L)]
    kernel_ms = graph_time_ms(calls, 20) / L
    eager_ms = cuda_time_ms(lambda i: calls[i % L](), 64)
    plain_ms = cuda_time_ms(lambda i: decode_attention_ref(q, cache, i % L, bt, seq_lens, q0), 8)
    out["decode_err"] = compare(torch, "decode at the serving shapes",
                                paged_decode_attention(q, cache, LAYER, bt, seq_lens, q0),
                                decode_attention_ref(q, cache, LAYER, bt, seq_lens, q0))

    def dense_kv(layer):
        kd = torch.zeros((b, HK, max(lens), D), dtype=torch.bfloat16, device="cuda")
        vd = torch.zeros_like(kd)
        for i, n in enumerate(lens):
            rows = bt[i, :-(-n // BS)].long()
            kd[i, :, :n] = cache[layer, rows, 0].reshape(-1, HK, D)[:n].transpose(0, 1)
            vd[i, :, :n] = cache[layer, rows, 1].reshape(-1, HK, D)[:n].transpose(0, 1)
        return kd, vd

    library_ms, library_eager_ms = _sdpa_decode_ms(torch, q, lens, dense_kv)
    ctx = sum(lens)
    dec_bytes = 2 * (2 * b * H * D) + 2 * ctx * HK * D * 2 + 4 * (b * m + 2 * b)
    dec_flops = 4 * H * D * ctx
    out["decode"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=1e3 * max(dec_bytes / HBM_BYTES_PER_S, dec_flops / BF16_FLOP_PER_S),
                         bound_by="bytes" if dec_bytes / HBM_BYTES_PER_S >= dec_flops / BF16_FLOP_PER_S
                         else "operations")
    log(f"time decode  B={b} S=1 ctx={ctx}: kernel {kernel_ms:.4f} ms (CUDA graph; eager {eager_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (CUDA graph; eager {library_eager_ms:.4f}), "
        f"bound {out['decode']['bound_ms']:.4f} ms, "
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
    library_ms = median_ms(lambda: cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), 10))
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


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _dequant_rows(torch, cache, rows, n, layer=LAYER):
    """The first ``n`` K and V rows [n, Hk, D] (bf16) of blocks ``rows`` of
    ``layer`` of an int8 cache."""
    from dynamo_tpu_torch.ops.kv_quant import gather_layer_blocks

    kv = gather_layer_blocks(cache, layer, rows, HK).to(torch.bfloat16)
    return kv[:, 0].reshape(-1, HK, D)[:n], kv[:, 1].reshape(-1, HK, D)[:n]


def q8_timing_phase(torch, card: str) -> dict:
    """The int8 decode and prefill kernels at the int8 default path's
    shapes (Bs = 32), timed and checked against their plain version there:
    decode is one layer of a burst step (B = 8 slots, S = 1, the six
    requests mid-generation; a CUDA graph of the 32 layers' calls, the
    card's time, since the kernel is shorter than a launch from Python) and
    prefill the dispatch of the request that
    hits the shared prefix (start = 256, 700 fresh tokens).  The library
    yardstick is SDPA on K/V dequantised to bf16 beforehand (for decode,
    each layer's, timed as the kernel is): it reads twice the cache bytes
    the kernel reads, and the dequantisation is not timed."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention_q8)
    from dynamo_tpu_torch.ops.kernels.prefill_attention import (
        paged_prefill_attention_q8, prefill_attention_ref)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bs, m = BS_Q8, 2048 // BS_Q8
    out = {}

    # decode
    lens = [n + MAX_TOKENS // 2 for n in PROMPT_LENS] + [0, 0]
    b = len(lens)
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen, bs)
    cache = _q8_cache(torch, gen, n_blocks, HK, D, bs)
    q = torch.randn((b, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    seq_lens = _ints(torch, lens)
    q0 = (seq_lens - 1).clamp_min(0)
    calls = [lambda i=i: paged_decode_attention_q8(q, cache, i, bt, seq_lens, q0) for i in range(L)]
    kernel_ms = graph_time_ms(calls, 20) / L  # the card's time: the kernel is shorter than its launch
    eager_ms = cuda_time_ms(lambda i: calls[i % L](), 64)
    plain_ms = cuda_time_ms(lambda i: decode_attention_ref(q, cache, i % L, bt, seq_lens, q0), 8)
    out["decode_q8_err"] = compare(torch, "int8 decode at the serving shapes",
                                   paged_decode_attention_q8(q, cache, LAYER, bt, seq_lens, q0),
                                   decode_attention_ref(q, cache, LAYER, bt, seq_lens, q0))
    # captured in a CUDA graph as it is (its tickets reset themselves), the
    # kernel replays the eager launch's bits
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        eager = paged_decode_attention_q8(q, cache, LAYER, bt, seq_lens, q0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            captured = paged_decode_attention_q8(q, cache, LAYER, bt, seq_lens, q0)
        for _ in range(3):
            graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(captured, eager), "int8 decode: a CUDA graph replay differs from the eager launch")

    def dense_kv(layer):
        kd = torch.zeros((b, HK, max(lens), D), dtype=torch.bfloat16, device="cuda")
        vd = torch.zeros_like(kd)
        for i, n in enumerate(lens):
            if n:
                k_rows, v_rows = _dequant_rows(torch, cache, bt[i, :-(-n // bs)], n, layer)
                kd[i, :, :n], vd[i, :, :n] = k_rows.transpose(0, 1), v_rows.transpose(0, 1)
        return kd, vd

    library_ms, library_eager_ms = _sdpa_decode_ms(torch, q, lens, dense_kv)
    ctx = sum(lens)
    # q and out bf16; the int8 K/V payload of the live context and the f32
    # scale of each (token, KV head, K or V) it reads; the tables
    nbytes = 2 * (2 * b * H * D) + 2 * ctx * HK * D + 2 * ctx * HK * 4 + 4 * (b * m + 2 * b)
    out["decode_q8"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                            **_bound(4 * H * D * ctx, nbytes))
    log(f"time decode int8 B={b} S=1 Bs={bs} ctx={ctx}: kernel {kernel_ms:.4f} ms (CUDA graph; eager "
        f"{eager_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa on bf16 K/V (twice the cache bytes) {library_ms:.4f} ms (CUDA graph; eager "
        f"{library_eager_ms:.4f}), bound "
        f"{out['decode_q8']['bound_ms']:.4f} ms ({out['decode_q8']['bound_by']}), max abs err "
        f"{out['decode_q8_err']:.3g}, a CUDA graph replay bit-identical to the eager launch ({card})")

    # prefill over a cached prefix
    start, fresh = SHARED_PREFIX, PROMPT_LENS[-1] - SHARED_PREFIX
    s = -(-fresh // bs) * bs
    bt1 = _tables(torch, [start + fresh], m, -(-(start + fresh) // bs) + 8, gen, bs)
    cache1 = _q8_cache(torch, gen, int(bt1.max()) + 1, HK, D, bs)
    qp, kp, vp = (torch.randn((1, s, x, D), generator=gen, device="cuda").to(torch.bfloat16)
                  for x in (H, HK, HK))
    pargs = (qp, kp, vp, cache1, LAYER, bt1, _ints(torch, [start + fresh]), _ints(torch, [start]))
    kernel_ms = cuda_time_ms(lambda i: paged_prefill_attention_q8(*pargs), 10)
    plain_ms = cuda_time_ms(lambda i: prefill_attention_ref(*pargs), 3, warmup=1)
    out["prefill_q8_err"] = compare(torch, "int8 prefill at the serving shapes",
                                    paged_prefill_attention_q8(*pargs), prefill_attention_ref(*pargs))
    k_pre, v_pre = _dequant_rows(torch, cache1, bt1[0, :start // bs], start)
    ks = torch.cat([k_pre, kp[0, :fresh]]).transpose(0, 1)[None].contiguous()
    vs = torch.cat([v_pre, vp[0, :fresh]]).transpose(0, 1)[None].contiguous()
    qs = qp[:, :fresh].transpose(1, 2).contiguous()
    i = torch.arange(fresh, device="cuda")
    j = torch.arange(start + fresh, device="cuda")
    pmask = (j[None, :] < start) | (j[None, :] - start <= i[:, None])
    library_ms = median_ms(lambda: cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=pmask, enable_gqa=True), 10))
    pairs = fresh * start + fresh * (fresh + 1) // 2
    nbytes = (2 * (2 * fresh * H * D + 2 * fresh * HK * D) + 2 * start * HK * D
              + 2 * start * HK * 4 + 4 * (m + 2))
    out["prefill_q8"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                             **_bound(4 * H * D * pairs, nbytes))
    log(f"time prefill int8 B=1 S={s} fresh={fresh} start={start} Bs={bs}: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa on bf16 K/V {library_ms:.4f} ms, bound "
        f"{out['prefill_q8']['bound_ms']:.4f} ms ({out['prefill_q8']['bound_by']}), max abs err "
        f"{out['prefill_q8_err']:.3g} ({card})")
    return out


def matmul_timing(torch, card: str) -> dict:
    """The W8A16 kernel on one decode step's layer of the int8 model: the
    seven projections at M = 8 rows, in order, with four layers' distinct
    weights in turn (875 MB, far past the 50 MB L2), beside the plain
    version, cuBLAS bf16 on the same weights dequantised beforehand (twice
    the weight bytes; the dequantisation is not timed) and the bound.  Each
    is timed as a CUDA graph of the calls (the card's time; at M = 8 the
    host launches slower than the card runs, so eager timing measures the
    host) and, for the log, eagerly.  Also logged: each projection at M = 8,
    the layer at a prefill's M = 1504, and the lm_head at M = 8 with f32
    logits."""
    from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    layers = [{name: _q8_weight(torch, gen, k, n, "kn") for name, (k, n) in PROJECTIONS.items()}
              for _ in range(4)]
    dense = [{name: (wq.to(torch.bfloat16) * scale.to(torch.bfloat16)) for name, (wq, scale)
              in layer.items()} for layer in layers]

    def rows(m):
        return {name: torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                for name, (k, _) in PROJECTIONS.items()}

    def kernel(x, li, name):
        return int8_matmul(x, *layers[li][name])

    def plain(x, li, name):
        return int8_matmul_ref(x, *layers[li][name])

    def library(x, li, name):
        return torch.matmul(x, dense[li][name])

    def layer_calls(fn, xs, names=tuple(PROJECTIONS)):
        return [lambda li=li, name=name: fn(xs[name], li, name) for li in range(4) for name in names]

    def layer_ms(fn, xs, iters):
        """One layer's time: a graph of four layers' calls, per layer."""
        return graph_time_ms(layer_calls(fn, xs), iters) / 4

    def eager_ms(fn, xs, iters):
        calls = layer_calls(fn, xs)
        return cuda_time_ms(lambda i: [c() for c in calls], iters) / 4

    def layer_bound(m):
        flops = sum(2 * m * k * n for k, n in PROJECTIONS.values())
        nbytes = sum(k * n + 2 * m * k + 2 * m * n + 4 * n for k, n in PROJECTIONS.values())
        return _bound(flops, nbytes)

    out = {}
    xs = rows(8)
    out["matmul"] = dict(ms=layer_ms(kernel, xs, 40), plain_ms=layer_ms(plain, xs, 8),
                         library_ms=median_ms(lambda: layer_ms(library, xs, 40)), **layer_bound(8))
    errs = [compare(torch, f"matmul {name} at M=8", kernel(xs[name], 0, name),
                    plain(xs[name], 0, name)) for name in PROJECTIONS]
    out["matmul_err"] = max(errs)
    r = out["matmul"]
    log(f"time matmul int8 one layer's 7 projections at M=8 (CUDA graph): kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, cuBLAS bf16 on dequantised weights (twice the weight bytes) "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); launched eagerly: "
        f"kernel {eager_ms(kernel, xs, 16):.4f} ms, "
        f"cuBLAS {median_ms(lambda: eager_ms(library, xs, 16)):.4f} ms; "
        f"max abs err {out['matmul_err']:.3g} ({card})")
    per = {name: graph_time_ms(layer_calls(kernel, xs, (name,)), 40) / 4 for name in PROJECTIONS}
    bounds = {name: _bound(2 * 8 * k * n, k * n + 16 * k + 16 * n + 4 * n)["bound_ms"]
              for name, (k, n) in PROJECTIONS.items()}
    log("time matmul int8 at M=8 by projection (CUDA graph): " + ", ".join(
        f"{name} [{k}, {n}] {per[name]:.4f} ms (bound {bounds[name]:.4f})"
        for name, (k, n) in PROJECTIONS.items()) + f" ({card})")
    xp = rows(1504)
    pre = dict(ms=layer_ms(kernel, xp, 8), library_ms=median_ms(lambda: layer_ms(library, xp, 8)),
               **layer_bound(1504))
    per = {name: graph_time_ms(layer_calls(kernel, xp, (name,)), 8) / 4 for name in PROJECTIONS}
    log(f"time matmul int8 one layer's 7 projections at M=1504 (CUDA graph): kernel {pre['ms']:.4f} ms, "
        f"cuBLAS bf16 {pre['library_ms']:.4f} ms, bound {pre['bound_ms']:.4f} ms ({pre['bound_by']}); by "
        f"projection " + ", ".join(f"{name} {v:.4f}" for name, v in per.items()) + f" ({card})")
    del layers, dense
    k, n = LM_HEAD
    heads = [_q8_weight(torch, gen, k, n, "kn") for _ in range(2)]
    x = torch.randn((8, k), generator=gen, device="cuda").to(torch.bfloat16)
    head_ms = graph_time_ms([lambda i=i: int8_matmul(x, *heads[i], torch.float32) for i in range(2)],
                            20) / 2
    dense_head = heads[0][0].to(torch.bfloat16) * heads[0][1].to(torch.bfloat16)
    head_lib = median_ms(lambda: cuda_time_ms(
        lambda i: torch.mm(x, dense_head, out_dtype=torch.float32), 16))
    hb = _bound(2 * 8 * k * n, k * n + 16 * k + 32 * n + 4 * n)
    log(f"time matmul int8 lm_head [{k}, {n}] at M=8, f32 out (CUDA graph): kernel {head_ms:.4f} ms, cuBLAS "
        f"bf16 {head_lib:.4f} ms (one weight, L2-warm for weights under 50 MB), bound {hb['bound_ms']:.4f} ms "
        f"({hb['bound_by']}) ({card})")
    return out


def ragged_timing(torch, card: str, mixed: dict, quant: bool = False) -> dict:
    """The ragged kernel at the largest mixed dispatch a token-budget
    serving run made (its row table and block size as recorded; random bf16
    q and K/V, a random bf16 or int8 pool), timed beside its plain version,
    one SDPA call on the same work laid out dense with a block-diagonal
    causal mask (the prefix gather, and for an int8 pool its dequantisation
    to bf16, excluded), and its bound on this card."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention, ragged_paged_prefill_attention_q8,
        ragged_prefill_attention_ref)
    from dynamo_tpu_torch.ops.kv_quant import gather_layer_blocks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    t, bt, lens, starts, offs, bs = (mixed[k] for k in ("t", "bt", "lens", "starts", "offs", "bs"))
    n_blocks = int(bt.max()) + 1
    if quant:
        cache = _q8_cache(torch, gen, n_blocks, HK, D, bs)
    else:
        cache = torch.randn((L, n_blocks, 2, bs, HK * D), generator=gen,
                            device="cuda").to(torch.bfloat16)
    kernel = ragged_paged_prefill_attention_q8 if quant else ragged_paged_prefill_attention
    q = torch.randn((1, t, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((1, t, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((1, t, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
    rows = (_ints(torch, lens), _ints(torch, starts), _ints(torch, offs))
    # successive launches walk the 32 layers, as a serving dispatch does
    kernel_ms = cuda_time_ms(lambda i: kernel(q, k, v, cache, i % L, bt, *rows), 32)
    plain_ms = cuda_time_ms(lambda i: ragged_prefill_attention_ref(
        q, k, v, cache, i % L, bt, *rows), 3, warmup=1)
    label = "int8 ragged" if quant else "ragged"
    err = compare(torch, f"{label} at the serving dispatch",
                  kernel(q, k, v, cache, LAYER, bt, *rows),
                  ragged_prefill_attention_ref(q, k, v, cache, LAYER, bt, *rows))
    # what the decode rows cost: the same dispatch with the decode rows'
    # spans emptied (seq_len = start) runs the span blocks alone.
    dec = [r for r, (st, n, o) in enumerate(zip(starts, lens, offs)) if n - st == 1 and o == r]
    spans_only = [st if r in dec else n for r, (st, n) in enumerate(zip(starts, lens))]
    spans_rows = (_ints(torch, spans_only), rows[1], rows[2])
    spans_ms = cuda_time_ms(lambda i: kernel(q, k, v, cache, i % L, bt, *spans_rows), 32)

    # dense layout: each live row's queries; its prefix then its fresh keys
    qs, ks, vs, spans = [], [], [], []
    u = 0
    for r, (st, n, o) in enumerate(zip(starts, lens, offs)):
        f = n - st
        if f <= 0:
            continue
        kv = gather_layer_blocks(cache, LAYER, bt[r, :-(-st // bs)], HK).to(torch.bfloat16)
        ks += [kv[:, 0].reshape(-1, HK, D)[:st], k[0, o:o + f]]
        vs += [kv[:, 1].reshape(-1, HK, D)[:st], v[0, o:o + f]]
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
    library_ms = median_ms(lambda: cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), 10))

    r_rows, m = bt.shape
    flops = 4 * H * D * ragged_work(starts, lens)
    # q, out and the fresh K/V bf16; each row's prefix K/V, bf16 or int8
    # plus the f32 scale of each (token, KV head, K or V); the tables
    prefix = 2 * sum(starts) * HK * (D + 4 if quant else 2 * D)
    nbytes = 2 * (2 * t * H * D + 2 * t * HK * D) + prefix + 4 * (r_rows * m + 3 * r_rows)
    out = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, **_bound(flops, nbytes))
    log(f"time {label} T={t} Bs={bs} rows={len(spans)}, starts {starts}, seq_lens {lens}: kernel "
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
    from dynamo_tpu_torch.ops.kernels import decode_attention as dec
    from dynamo_tpu_torch.ops.kernels import int8_matmul as mm
    from dynamo_tpu_torch.ops.kernels import prefill_attention as pre
    from dynamo_tpu_torch.ops.kernels import ragged_prefill_attention as rag

    return {"decode": dec.paged_decode_attention, "prefill": pre.paged_prefill_attention,
            "ragged": rag.ragged_paged_prefill_attention,
            "decode_q8": dec.paged_decode_attention_q8, "prefill_q8": pre.paged_prefill_attention_q8,
            "ragged_q8": rag.ragged_paged_prefill_attention_q8, "matmul": mm.int8_matmul}


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
def recorded_ragged_calls(name: str = "ragged_paged_prefill_attention"):
    """Record the row table of every ragged attention call the model makes
    at layer 0 (one per dispatch), by wrapping the routing's reference to
    the kernel's wrapper ``name`` (the bf16 or the int8 one); the wrapper
    itself, and its launch count, are untouched."""
    from dynamo_tpu_torch.ops import paged_attention as routing
    from dynamo_tpu_torch.ops.kv_quant import cache_data

    real = getattr(routing, name)
    calls = []

    def recording(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets,
                  *args, **kw):
        if layer == 0:
            calls.append((q.shape[1], block_tables, seq_lens, starts, row_offsets,
                          cache_data(cache).shape[3]))
        return real(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets,
                    *args, **kw)

    setattr(routing, name, recording)
    try:
        yield calls
    finally:
        setattr(routing, name, real)


def ragged_work(starts, lens) -> int:
    """Visible (query, key) pairs of a ragged dispatch: each row's fresh
    tokens see its whole prefix and their own span causally."""
    return sum((n - st) * st + (n - st) * (n - st + 1) // 2 for st, n in zip(starts, lens))


def largest_mixed(calls) -> dict:
    """The recorded dispatch with the most attention work among those that
    mix decode rows (1-token rows at the head of the axis) with spans."""
    best = None
    for t, bt, lens, starts, offs, bs in calls:
        lens, starts, offs = lens.tolist(), starts.tolist(), offs.tolist()
        fresh = [n - st for n, st in zip(lens, starts)]
        mixed = fresh and fresh[0] == 1 and offs[0] == 0 and max(fresh) > 1
        if mixed and (best is None or ragged_work(starts, lens) > ragged_work(best["starts"],
                                                                               best["lens"])):
            best = dict(t=t, bt=bt, lens=lens, starts=starts, offs=offs, bs=bs)
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
    default, budget, mixed = serve_both(torch, model, card, quant=False)
    del model
    torch.cuda.empty_cache()
    return default, budget, mixed


def serve_both(torch, model, card: str, quant: bool):
    """The default path then the token-budget path on one model; checks
    that each run launched its path's kernels and none of the other cache
    kind's attention kernels.  Returns both runs and the largest mixed
    dispatch of the second."""
    tag = "int8 " if quant else ""
    q8 = "_q8" if quant else ""
    other = (("decode", "prefill", "ragged") if quant
             else ("decode_q8", "prefill_q8", "ragged_q8", "matmul"))
    default = serve_run(torch, model, INT8_DEFAULT_PATH if quant else DEFAULT_PATH, card,
                        f"{tag}default path", profile=True)
    need = ["decode" + q8, "prefill" + q8] + (["matmul"] if quant else [])
    check(all(default["launches"][k] > 0 for k in need) and
          not any(default["launches"][k] for k in other),
          f"{tag}default path: launches {default['launches']}, need {need} > 0, {other} = 0")
    torch.cuda.empty_cache()  # the first engine and its cache are gone
    with recorded_ragged_calls("ragged_paged_prefill_attention" + q8) as calls:
        budget = serve_run(torch, model, INT8_BUDGET_PATH if quant else BUDGET_PATH, card,
                           f"{tag}token-budget path")
    m = budget["metrics"]
    need = ["ragged" + q8, "decode" + q8] + (["matmul"] if quant else [])
    check(all(budget["launches"][k] > 0 for k in need) and
          not any(budget["launches"][k] for k in other),
          f"{tag}token-budget path: launches {budget['launches']}, need {need} > 0, {other} = 0")
    check(m["unified_dispatches_total"] > 0 and m["lookahead_bursts_total"] > 0,
          f"the {tag}token-budget path made no mixed dispatch or no burst: {m}")
    same = sum(a == b for a, b in zip(default["streams"], budget["streams"]))
    log(f"serving: {same} of {len(default['streams'])} {tag}token-budget streams equal the "
        f"default path's (informational: the kernels round bf16 at different places) ({card})")
    mixed = largest_mixed(calls)
    del calls
    torch.cuda.empty_cache()
    return default, budget, mixed


def serving_phase_q8(torch, card: str):
    """The two serving runs on Llama-3-8B with int8 weights (drawn directly
    on the card, the bf16 model never made) and an int8 KV cache."""
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = llama3_8b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda", quantized=True))
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"serving: Llama-3-8B int8, {cfg.num_layers} layers, {weights / 1e9:.2f} GB of random "
        f"weights in {time.perf_counter() - t0:.1f} s")
    out = serve_both(torch, model, card, quant=True)
    del model
    torch.cuda.empty_cache()
    return out


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
def _forward_logits(torch, model, device, prompt, steps, prefix, bs=BS, cache_dtype=None):
    """Prefill ``prompt[:prefix]``, then the rest over that cached prefix
    (prefill kernel with start > 0), then ``steps`` single-token decode
    steps teacher-forced with ``steps`` fixed tokens; returns the logits
    at the last position of each dispatch after the first."""
    m = 2048 // bs
    n = len(prompt) + len(steps)
    nb = -(-n // bs)
    cache = model.init_kv_cache(nb + 1, bs, cache_dtype)
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


def _ragged_logits(torch, model, device, dispatches, bs=BS, cache_dtype=None):
    """Run ragged dispatches over a fresh cache; each is (rows, region)
    with rows (tokens, start, block table) laid out by
    :func:`ragged_layout`.  Returns the logits at every row's last token."""
    m = 2048 // bs
    n_blocks = 1 + max(b for rows, _ in dispatches for _, _, table in rows for b in table)
    cache = model.init_kv_cache(n_blocks, bs, cache_dtype)
    logits = []

    def ints(xs):
        return torch.tensor(xs, dtype=torch.int32, device=device)

    for rows, region in dispatches:
        t, starts, lens, offs = ragged_layout([(st, len(toks)) for toks, st, _ in rows], region, 0,
                                              bs)
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
            slot[0, o:o + n] = bt[r, p // bs] * bs + p % bs
            seq_ids[0, o:o + n] = r
        max_pb = max(-(-st // bs) for st in starts)
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


def parity_phase(torch, card: str, quant: bool = False) -> None:
    """A 2-layer model at 8B width on the card and on the CPU, the same
    weights on both: bf16 weights with a bf16 cache (Bs = 16), or int8
    weights with an int8 cache (``quant``, Bs = 32)."""
    import numpy as np

    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = llama3_8b(2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_params(cfg, gen, device="cuda", quantized=quant)
    gpu = LlamaModel.from_state(cfg, state)
    cpu_cfg = llama3_8b(2)
    cpu_cfg.dtype = "float32"
    # int8 codes and f32 scales as they are; bf16 tensors in f32
    cpu = LlamaModel.from_state(cpu_cfg, {
        k: (v if v.dtype in (torch.int8, torch.float32) else v.float()).cpu()
        for k, v in state.items()})
    bs, kv = (BS_Q8, "int8") if quant else (BS, None)
    tag = "int8 weights and cache, " if quant else ""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
    steps = rng.integers(0, cfg.vocab_size, 8).tolist()
    _hold_logits(torch, f"default path: 2-layer 8B width, {tag}300-token prompt over a "
                 "128-token prefix + 8 decode steps",
                 _forward_logits(torch, gpu, torch.device("cuda"), prompt, steps, 128, bs, kv),
                 _forward_logits(torch, cpu, torch.device("cpu"), prompt, steps, 128, bs, kv),
                 card)

    # a packed prefill of A, B and C's head, then a mixed dispatch: decode
    # rows for A and B ahead of D from 0 and C's rest from 128
    a, b, c, d = (rng.integers(0, cfg.vocab_size, n).tolist() for n in (200, 97, 300, 150))
    x, y = rng.integers(0, cfg.vocab_size, 2).tolist()
    tables, nxt = [], 1
    for n in (201, 98, 300, 150):
        nb = -(-n // bs)
        tables.append(list(range(nxt, nxt + nb)))
        nxt += nb
    dispatches = [
        ([(a, 0, tables[0]), (b, 0, tables[1]), (c[:128], 0, tables[2])], 0),
        ([([x], 200, tables[0]), ([y], 97, tables[1]), (d, 0, tables[3]),
          (c[128:], 128, tables[2])], bs),
    ]
    _hold_logits(torch, f"ragged: 2-layer 8B width, {tag}packed prefill of 3 spans, then 2 "
                 "decode rows + 2 spans",
                 _ragged_logits(torch, gpu, torch.device("cuda"), dispatches, bs, kv),
                 _ragged_logits(torch, cpu, torch.device("cpu"), dispatches, bs, kv), card)
    del gpu, cpu, state
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- main
def main() -> int:
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
        lib_path = build.build_library(verbose=True)
        build.library()
        log(f"build: {time.perf_counter() - t0:.1f} s ({card})")
        sass_check(torch, lib_path)
        errs = kernel_phase(torch)
        times = timing_phase(torch, card)
        times.update(q8_timing_phase(torch, card))
        times.update(matmul_timing(torch, card))
        default, budget, mixed = serving_phase(torch, card)
        times["ragged"] = ragged_timing(torch, card, mixed)
        times["ragged_err"] = times["ragged"].pop("err")
        q8_default, q8_budget, q8_mixed = serving_phase_q8(torch, card)
        times["ragged_q8"] = ragged_timing(torch, card, q8_mixed, quant=True)
        times["ragged_q8_err"] = times["ragged_q8"].pop("err")
        parity_phase(torch, card)
        parity_phase(torch, card, quant=True)
    except (SmokeFailure, RuntimeError) as e:  # a failed check, build or nvidia-smi
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: each kernel's count over the serving run of the path it
    # carries (decode and prefill: the default path; ragged: the token-budget
    # path; the int8 kernels: the same paths on the int8 model)
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
        dict(name="paged_decode_attention_q8", route="cuda",
             source="dynamo_tpu_torch/csrc/decode_attention.cu",
             replaces="dynamo_tpu/ops/pallas/decode_attention.py:94",
             launches=q8_default["launches"]["decode_q8"],
             max_abs_err=max(errs["decode_q8"], times["decode_q8_err"]), **times["decode_q8"]),
        dict(name="paged_prefill_attention_q8", route="cuda",
             source="dynamo_tpu_torch/csrc/prefill_attention.cu",
             replaces="dynamo_tpu/ops/pallas/prefill_attention.py:57",
             launches=q8_default["launches"]["prefill_q8"],
             max_abs_err=max(errs["prefill_q8"], times["prefill_q8_err"]), **times["prefill_q8"]),
        dict(name="ragged_paged_prefill_attention_q8", route="cuda",
             source="dynamo_tpu_torch/csrc/ragged_prefill_attention.cu",
             replaces="dynamo_tpu/ops/pallas/prefill_attention.py:384",
             launches=q8_budget["launches"]["ragged_q8"],
             max_abs_err=max(errs["ragged_q8"], times["ragged_q8_err"]), **times["ragged_q8"]),
        dict(name="int8_matmul", route="cuda",
             source="dynamo_tpu_torch/csrc/int8_matmul.cu",
             replaces="dynamo_tpu/ops/pallas/int8_matmul.py:64",
             launches=q8_default["launches"]["matmul"],
             max_abs_err=max(errs["matmul"], times["matmul_err"]), **times["matmul"]),
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
