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
   decode kernel over both caches and the int8 prefill kernel also run at
   their edges (G = 1, 4 and 8 at D = 64, 128 and 256, Bs = 16 and 32;
   decode at S = 1 and 8 with contexts 0 to 2048 either side of its chunks
   and tiles; prefill from a start inside a key tile), and every decode
   launch is run twice and must give the same bits; the decode kernel over
   both caches also at the speculative verify's S = 5 and 8, with every
   query live and with rows of fewer live queries than S.  The
   W8A16 matmul runs at every projection shape of Llama-3-8B and its
   lm_head (f32 out), at M = 1 to 1504 across both regimes' edges, for a
   [K, N] weight and for the transpose of an [N, K] one, then at ragged
   shapes (N = 32002 or 1000, K = 4104) and at Qwen3-30B-A3B's attention
   projections and lm_head (K = 2048 to N = 4096, 512 and 151,936; 4096 to
   2048), and a split-K launch is run twice and must give the same bits.
   The grouped expert matmul (E1 over bf16 experts, E2 over int8 ones) runs
   at Qwen3-30B-A3B's expert shapes (128 experts, top 8, [2048, 768] and
   [768, 2048]) for 1, 8, 1,504 and 3,765 tokens and at one Mixtral-8x7B
   layer's stack (8 experts, top 2, [4096, 14336] and [14336, 4096]) for 8
   and 1,504 tokens, with uniform routing and with every row on one expert,
   and at shapes off its tiles (K = 144, N = 200 and 208), each launch
   twice for the same bits; the MoE MLP as a whole (router,
   sort, grouped launches, combine) is held to the dense oracle.  Then
   decode, prefill, the matmul and one MoE layer's three grouped launches
   (T = 8 and 1,504) are timed at the serving paths' shapes (decode, the
   matmul and the grouped launches as CUDA graphs, the card's time, and
   eagerly for the log; a graph replay of
   each decode kernel must give the eager launch's bits) beside their plain
   versions, a PyTorch library call on the same work (the median of three
   readings; every SDPA yardstick as a CUDA graph, the card's time, and
   eagerly for the log; for the grouped launches ``torch._grouped_mm`` and
   a per-expert cuBLAS loop, both as CUDA graphs), and their bound on this
   card; the decode kernel over both caches also at the verify's S = 5 and
   8 and the matmul at its M = 40;
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
   rows and without them.  Before the bf16 model is freed it also serves
   the six prompts as token-id completions through the port's HTTP service
   (concurrent, streamed): TTFT at the client beside the direct run's; and
   it runs the ``grammar`` phase: a 128,256-token vocabulary of bytes from
   a seed (ids 3-258 the single bytes, the rest printable strings of 2 to
   8 bytes) and its JSON tables; ``grammar_mask`` / ``grammar_advance`` on
   the card equal to the CPU's at reachable states of a JSON + choice +
   regex composite, the seeded noise bit-equal; their times at B = 8
   beside their bound; then the six prompts as a constrained mix (two
   greedy JSON-mode rows, a seeded JSON-mode row at temperature 1, a
   seeded free row, a guided choice and a guided regex) on the default
   path (B1, B2) and on the token-budget path (B3, B1), each row held to
   its grammar, and the seeded rows again with one decode turn a dispatch
   and other companions for the same streams.  Last on the bf16 model, the
   ``spec`` phase: speculative decoding on the copy task (each prompt a
   seeded 32-token segment repeated to its length, 64 tokens each, five
   greedy rows and one seeded at temperature 0.9, top_p 0.9) with
   speculation off, n-gram lookup at k = 4 and 7, the model as its own
   draft and a Llama-3.2-1B-width draft (random weights from a seed), k = 4;
   and on the int8 model off and n-gram at k = 4.  Each run: every request
   64 tokens at ``length``, the decode kernel launched at S = k + 1 (B1, or
   B4a on int8), no plain-op attention call but a draft's ingest, the
   self-draft accepting more than the 1B draft, and every stream that parts
   from speculation off's parting at a near-tie (the common prefix
   re-scored on the card; ``SPEC_TIE_EPS``).  It prints each run's
   readings and one ``{"spec": [...]}`` line at the end;
5. parity: 2-layer models at full 8B width on the card (kernels, bf16) and
   on the CPU (plain PyTorch, f32), bf16 weights with a bf16 cache and int8
   weights with an int8 cache: one 300-token prompt over a 128-token cached
   prefix then 8 decode steps, and one packed prefill then one mixed
   ragged dispatch (two decode rows, two spans); on bf16 also one
   speculative verify dispatch at S = 5 over three prefixes (5, 3 and 1
   live queries); logits held to a stated tolerance;
6. front door: a 2-layer HF checkpoint at Llama-3-8B width (random bf16
   weights from a seeded generator, two safetensors shards and an index, a
   word-level tokenizer of 128,256 ids and a chat template), written into
   the git-ignored ``_frontdoor/`` beside this script and removed at the
   end.  ``python3 -m dynamo_tpu_torch run in=http out=gpu`` serves it as a
   subprocess: unary, streamed, chat (through the template), n = 2,
   logprobs, stop-string and unknown-model requests, ``/metrics``, a clean
   exit on SIGTERM.  Then ``build_local_engine`` loads it in this process,
   bf16 on the default path and int8 (weights and cache, Bs = 32) on the
   token-budget path, each behind the port's ``HttpService``: the loaded
   tensors against the shards, and each answer, one request at a time,
   against a fresh engine's greedy tokens; the bf16 server must launch the
   decode and prefill kernels, the int8 one the int8 decode, int8 ragged and
   W8A16 kernels.  With a byte-level tokenizer beside the same weights the
   CLI also answers a ``json_schema`` chat (JSON of the schema's shape, or
   cut inside it at max_tokens), a ``guided_regex`` completion (replayed
   through its tables) and one seeded completion twice (the same text);
7. mixture of experts, serving: Qwen3-30B-A3B at full width and depth (48
   layers, 128 experts, random weights from a seeded generator) behind
   ``AsyncLLMEngine``, the six requests on bf16 weights and the default
   path (decode, prefill and E1 kernels), then on int8 weights and an int8
   cache (Bs = 32) on the token-budget path (int8 decode, int8 ragged,
   W8A16 and E2 kernels), each run profiled;
8. mixture of experts, parity: phase 5's four logit checks on a 2-layer
   model at Qwen3-30B-A3B width;
9. mixture of experts, front door: a 2-layer Qwen3-MoE checkpoint at
   Qwen3-30B-A3B width under the real checkpoint's tensor names (3.7 GB,
   384 expert tensors a layer) with a word-level tokenizer of 151,936 ids,
   served by the CLI (bf16, then ``--quantize int8``) and by
   ``build_local_engine`` as in phase 6 (bf16 default path: decode, prefill
   and E1; int8 token-budget path: int8 decode, int8 ragged, W8A16 and E2),
   the loaded tensors held to the shards and the answers to a fresh
   engine's;
10. DeepSeek-V2, serving: DeepSeek-V2-Lite at full width and depth (27
   layers, MLA with the absorbed latent cache, 64 routed experts top 6 and
   2 shared, random weights from a seeded generator; its YaRN
   ``rope_scaling`` dropped, as neither package implements it) behind
   ``AsyncLLMEngine``, the six requests on the default path with a bf16
   cache (profiled) and with an int8 cache (Bs = 32): E1 and no other
   kernel (MLA attention is the plain op, as in the JAX package);
11. DeepSeek-V2, parity: phase 5's default-path check (bf16 and int8
   cache) on a 2-layer model at DeepSeek-V2-Lite width (the dense layer and
   one MoE layer) and on one DeepSeek-V2 MoE layer (q-LoRA 1,536, 128
   heads, 160 experts, group-limited routing 8 / 3, routed scaling 16);
12. DeepSeek-V2, front door: a 2-layer checkpoint at DeepSeek-V2-Lite's
   width and tensor names (2.2 GB, 216 tensors) with a word-level tokenizer
   of 102,400 ids, served by the CLI and by ``build_local_engine`` with a
   bf16 and with an int8 cache (E1); ``--quantize int8`` refused with the
   JAX CLI's message.

The kernel timings also time E1 at one DeepSeek-V2-Lite MoE layer's
launches (64 experts, top 6, [2048, 1408] and [1408, 2048]), and the MLA
latent attention (the plain op) at B1's decode step and B2's prefill,
each beside its bound and SDPA on the same latent K/V.  Phase 4 prints
one ``{"grammar": {...}}`` line (the grammar ops' and the seeded noise's
times, launches and bounds, the table sizes, the constrained serving
readings beside the unconstrained ones).  At the end one ``{"mla": [...]}``
line, one ``{"kernels": [...]}`` line (the grouped
kernels' rows hold their T = 8 reading and, under ``t1504``, their T =
1,504 one; E1's also its DeepSeek-V2-Lite readings and launches), and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "dynamo_tpu_torch").is_dir():
    sys.exit("chip_smoke: dynamo_tpu_torch/ is not beside this script")
sys.path.insert(0, str(ROOT))

from dynamo_tpu_torch.tools.cuda_timing import (  # noqa: E402
    DECODE_LENS, LM_HEAD, MOE_EXPERTS, MOE_LAUNCHES, MOE_TOKENS, MOE_TOP_K, PROJECTIONS, card_line,
    cuda_time_ms, graph_time_ms, median_ms, moe_layer_work, moe_offsets, moe_stack, ragged_layout)

# published peaks of one H100 SXM (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores

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
# Qwen3-30B-A3B's int8 attention projections and lm_head, [K, N]
QWEN3_MOE_MATMULS = {"wq": (2048, 4096), "wk/wv": (2048, 512), "wo": (4096, 2048),
                     "lm_head": (2048, 151936)}
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
# An MoE router picks experts by comparing logits, so the card (bf16 hidden
# states; Qwen3's logits rounded to bf16, DeepSeek's f32) and the CPU (f32)
# can pick a different expert for a token whose k-th and (k+1)-th logits
# nearly tie (or, under group-limited routing, whose groups' best logits
# do), and then that token's output differs by a whole expert's share, far
# past the bounds above.  The logits are therefore compared with the CPU routed as
# the card routed (its own f32 logits weighting the card's experts); and
# where its own choice differs, the CPU's logits of the card's expert and
# of its own k-th must lie within ROUTE_TIE: about five times the card's
# logit error on unit-variance logits (hidden states ~1% off after a layer,
# plus the bf16 rounding of the logit, 2**-8 relative).
ROUTE_TIE = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# kernels whose every instantiation must be in the library: the paged
# prefill kernel at three head dims over bf16 and int8 caches; the decode
# kernel over each cache (its mangled name's first template argument:
# __nv_bfloat16 for B1, `a`, signed char, for B4a) at D = 64 and 128 with
# 4, 8 or 16 query rows and at D = 256 with 4 or 8; the grouped expert
# kernel at 8, 32 and 128 rows a tile over bf16 and int8 experts
DECODE_BF16, DECODE_INT8 = "13decode_kernelI13__nv_bfloat16", "13decode_kernelIa"
GROUPED = "grouped_wgmma_kernel"
SASS_INSTANTIATIONS = {"wgmma_prefill_kernel": 6, DECODE_BF16: 8, DECODE_INT8: 8, GROUPED: 6}
# SASS of the instructions counted per kernel: the wgmma, the cp.async
# copy, the TMA tile load and a 16-byte shared-memory store
SASS_OPS = {"hgmma": "HGMMA", "ldgsts": "LDGSTS", "tma": "UTMALDG", "sts128": "STS.128"}


def sass_check(torch, lib_path) -> None:
    """The redesigned kernels as compiled: the wgmma kernels (B5 above 16
    rows, the paged prefill kernels B2 and B4b, every ragged instantiation,
    B3 and B4c, and every grouped expert instantiation, E1 and E2) issue
    HGMMA; they, B5's decode kernel and the decode attention kernel over
    each cache (B1, B4a) copy with LDGSTS (cp.async), except B5's
    instantiations for rows off 16 bytes (template flag VEC = false), which
    copy element by element, and the grouped kernels, which copy with TMA
    (UTMALDG) and store no 16-byte vector to shared memory: E2 writes no
    bf16 copy of its int8 weight tile (its A operand is converted in
    registers).  Logged per kernel with its instructions' counts; a missing
    instruction fails."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()[:500]}")
    counts, name = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op, text in SASS_OPS.items():
                counts[name][op] += text in line

    def copies_async(n):  # B5's last template argument is VEC
        m = re.search(r"w8a16_\w+?_kernelI(.*?)EE", n)
        return m is None or m.group(1).endswith("Lb1")

    want = {"w8a16_wgmma_kernel": True, "wgmma_prefill_kernel": True, "ragged_kernel": True,
            "w8a16_decode_kernel": False, DECODE_BF16: False, DECODE_INT8: False, GROUPED: True}
    for key, needs_hgmma in want.items():
        found = {n: c for n, c in counts.items() if key in n}
        check(bool(found), f"sass: no {key} in the library")
        for n, c in found.items():
            copies = (c["tma"] > 0 and c["sts128"] == 0) if key == GROUPED else (
                c["ldgsts"] > 0 or not copies_async(n))
            check(copies and (c["hgmma"] > 0 or not needs_hgmma), f"sass: {n[:80]} has {c}")
        check(len(found) >= SASS_INSTANTIATIONS.get(key, 1),
              f"sass: {len(found)} instantiations of {key}, expected {SASS_INSTANTIATIONS.get(key, 1)}")
        log(f"sass {key}: {len(found)} instantiations, " + ", ".join(
            f"{SASS_OPS[op]} {sorted({c[op] for c in found.values()})}" for op in SASS_OPS))


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


def decode_case(torch, gen, lens, s, logit_cap, geom=(H, HK, D), bs=BS, quant=False, live=None):
    """B1 or B4a (``quant``) against its plain version over a poisoned pool;
    ``live`` gives each row's live queries (S unless named: a verify row
    with fewer proposals than k), the queries past them are padding at
    q0 + j as the engine lays them out."""
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
    q0 = (seq_lens - torch.tensor(live or [s] * b, dtype=torch.int32, device="cuda")).clamp_min(0)
    args = (q, cache, LAYER, bt, seq_lens, q0)
    kernel = paged_decode_attention_q8 if quant else paged_decode_attention
    out = kernel(*args, logit_cap=logit_cap)
    what = (f"decode {'int8 ' if quant else ''}{geom} Bs={bs} S={s} cap={logit_cap} lens={lens}"
            f"{f' live={live}' if live else ''}")
    err = compare(torch, what, out, decode_attention_ref(*args, logit_cap=logit_cap))
    for i, n in enumerate(lens):
        if n == 0:
            check(bool((out[i] == 0).all()), f"decode S={s}: zero-length row {i} is not 0")
    # the split-K merge is in chunk order: the same bits every launch
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
    for s in SPEC_VERIFY_S:
        for live in (None, verify_live(mixed, s)):
            e = decode_case(torch, gen, mixed, s, None, live=live)
            log(f"kernel decode  B=8 S={s} (verify) live queries {live or s}: max abs err {e:.3g}")
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
    for key, e in edge_phase(torch, gen).items():
        errs[key] = max(errs[key], e)
    for key, e in ragged_edge_phase(torch, gen).items():
        errs[key] = max(errs[key], e)
    errs["matmul"] = matmul_phase(torch, gen)
    errs.update(moe_kernel_phase(torch, gen))
    return errs


def q8_kernel_phase(torch, gen) -> dict:
    """The three int8 attention kernels against their plain version, at
    the bf16 checks' layouts and at both block sizes."""
    errs = {"decode_q8": 0.0, "prefill_q8": 0.0, "ragged_q8": 0.0}
    mixed = [0, 1, 17, 100, 333, 1024, 1500, 2048]
    decode_rows = [(n - 1, 1) for n in (1, 17, 100, 333, 1024, 1500, 2047, 64)]
    for bs in (16, BS_Q8):
        for s in (1, 4):
            for cap in (None, 50.0):
                e = decode_case(torch, gen, mixed, s, cap, bs=bs, quant=True)
                log(f"kernel decode int8 Bs={bs} B=8 S={s} softcap={cap}: max abs err {e:.3g}")
                errs["decode_q8"] = max(errs["decode_q8"], e)
        for s in SPEC_VERIFY_S:
            for live in (None, verify_live(mixed, s)):
                e = decode_case(torch, gen, mixed, s, None, bs=bs, quant=True, live=live)
                log(f"kernel decode int8 Bs={bs} B=8 S={s} (verify) live queries {live or s}: max "
                    f"abs err {e:.3g}")
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
    return errs


# The decode kernel's edges over both caches (B1 bf16, B4a int8) and the
# int8 prefill kernel's (B4b), at G = 1, 4 and 8 (H, Hk, D below) and Bs =
# 16 and 32.  Decode: contexts 0 and 1, either side of its 64-token chunks
# and 16-key tiles, and the whole 2048-token table, at S = 1 and 8 (8 x G
# query rows: one to eight row groups), each launched twice for the same
# bits.  B4b: a start inside a key tile (block-aligned, not tile-aligned),
# fresh lengths off the token tile (128 / G tokens).
EDGE_GEOMS = ((8, 8, 64), (32, 8, 128), (16, 2, 256))
DECODE_EDGE_LENS = [0, 1, 15, 17, 63, 64, 65, 127, 129, 2047, 2048]


def edge_phase(torch, gen) -> dict:
    errs = {"decode": 0.0, "decode_q8": 0.0, "prefill_q8": 0.0}
    i = 0
    for geom in EDGE_GEOMS:
        keys = 32 if geom[2] == 256 else 64  # the prefill kernel's key tile
        for bs in (16, BS_Q8):
            for s in (1, 8):
                cap = 50.0 if i % 2 else None
                i += 1
                for quant in (False, True):
                    e = decode_case(torch, gen, DECODE_EDGE_LENS, s, cap, geom=geom, bs=bs, quant=quant)
                    key = "decode_q8" if quant else "decode"
                    errs[key] = max(errs[key], e)
                    log(f"kernel decode {'int8' if quant else 'bf16'} edges (H, Hk, D)={geom} Bs={bs} S={s} "
                        f"softcap={cap} contexts {DECODE_EDGE_LENS}: max abs err {e:.3g}, two launches "
                        f"bit-identical")
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
    (rows off 16 bytes: a 32002-token vocabulary, a depth of 4104), at
    Qwen3-30B-A3B's attention projections and lm_head, and a
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
    for name, (k, n) in QWEN3_MOE_MATMULS.items():
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        wq, scale = _q8_weight(torch, gen, k, n, "kn")
        errs = [compare(torch, f"matmul Qwen3-30B-A3B {name} [{k}, {n}] M={m}",
                        int8_matmul(x, wq, scale, out_dtype), int8_matmul_ref(x, wq, scale, out_dtype))
                for m in MATMUL_ROWS
                for x in [torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)]]
        del wq, scale
        log(f"kernel matmul Qwen3-30B-A3B {name} [K, N]=[{k}, {n}] M in {MATMUL_ROWS}: "
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


def _sdpa_decode_ms(torch, q, lens, dense_kv, layers: int = L, q0=None) -> tuple[float, float]:
    """SDPA on one decode step's layer, the decode kernels' library
    yardstick: q [B, S, H, D] over each layer's K/V laid out dense
    beforehand (``dense_kv(layer)`` gives [B, Hk, T, D] twice), successive
    calls walking the ``layers`` layers (32 unless named) as the kernels
    do; for S > 1 query j of row i sees keys up to ``q0[i] + j``.  Timed as
    the kernels are, as a CUDA graph of the calls (the card's time) and
    launched eagerly; medians of three readings."""
    import torch.nn.functional as F

    kvs = [dense_kv(layer) for layer in range(layers)]
    seq = torch.tensor(lens, device="cuda")
    t = torch.arange(kvs[0][0].shape[2], device="cuda")
    mask = (t[None, :] < seq[:, None])[:, None, None, :]
    if q0 is not None:
        qpos = q0[:, None].long() + torch.arange(q.shape[1], device="cuda")[None, :]
        mask = mask & (t[None, None, :] <= qpos[:, :, None])[:, None]
    qd = q.transpose(1, 2).contiguous()
    calls = [lambda kv=kv: F.scaled_dot_product_attention(qd, *kv, attn_mask=mask, enable_gqa=True)
             for kv in kvs]
    graph_ms = median_ms(lambda: graph_time_ms(calls, 20) / layers)
    eager_ms = median_ms(lambda: cuda_time_ms(lambda i: calls[i % layers](), 64))
    return graph_ms, eager_ms


def _sdpa_ms(call, iters: int = 10) -> tuple[float, float]:
    """An SDPA yardstick as a CUDA graph (the card's time, as the kernels
    beside it are compared) and launched eagerly: medians of three readings."""
    return (median_ms(lambda: graph_time_ms([call], iters)),
            median_ms(lambda: cuda_time_ms(lambda i: call(), iters)))


def _check_graph_replay(torch, call, what: str) -> None:
    """A decode call captured in a CUDA graph as it is (the kernel's
    tickets reset themselves) replays the eager launch's bits."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        eager = call()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            captured = call()
        for _ in range(3):
            graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(captured, eager), f"{what}: a CUDA graph replay differs from the eager launch")


def timing_phase(torch, card: str) -> dict:
    """Decode and prefill at the default path's shapes, timed and checked
    against their plain versions there: decode is one layer of a burst step
    (B = 8 slots, S = 1, the six requests mid-generation; timed as a CUDA
    graph, as the int8 decode kernel is, and a graph replay held to the
    eager launch's bits), and prefill the longest prompt's one dispatch
    (S = 1504, start = 0)."""
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
    _check_graph_replay(torch, lambda: paged_decode_attention(q, cache, LAYER, bt, seq_lens, q0), "decode")

    library_ms, library_eager_ms = _sdpa_decode_ms(
        torch, q, lens, lambda layer: _dense_kv(torch, cache, bt, lens, layer, BS))
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
        f"max abs err {out['decode_err']:.3g}, a CUDA graph replay bit-identical to the eager launch ({card})")

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
    kernel_graph_ms = graph_time_ms([lambda: paged_prefill_attention(*pargs)], 10)
    plain_ms = cuda_time_ms(lambda i: prefill_attention_ref(*pargs), 3, warmup=1)
    out["prefill_err"] = compare(torch, "prefill at the serving shapes",
                                 paged_prefill_attention(*pargs), prefill_attention_ref(*pargs))
    qs = qp[:, :fresh].transpose(1, 2).contiguous()
    ks = kp[:, :fresh].transpose(1, 2).contiguous()
    vs = vp[:, :fresh].transpose(1, 2).contiguous()
    library_ms, library_eager_ms = _sdpa_ms(
        lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True))
    pairs = fresh * (fresh + 1) // 2
    pre_flops = 4 * H * D * pairs
    pre_bytes = 2 * (2 * fresh * H * D + 2 * fresh * HK * D) + 4 * (m + 2)
    out["prefill"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=1e3 * max(pre_flops / BF16_FLOP_PER_S, pre_bytes / HBM_BYTES_PER_S),
                          bound_by="operations" if pre_flops / BF16_FLOP_PER_S >= pre_bytes / HBM_BYTES_PER_S
                          else "bytes")
    log(f"time prefill B=1 S={s} fresh={fresh} start=0: kernel {kernel_ms:.4f} ms (CUDA graph "
        f"{kernel_graph_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (CUDA graph; eager {library_eager_ms:.4f}), "
        f"bound {out['prefill']['bound_ms']:.4f} ms, "
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


def _dense_kv(torch, cache, bt, lens, layer: int, bs: int):
    """Layer ``layer``'s K and V of each row's live context, laid out dense
    for SDPA ([B, Hk, T, D] bf16 each; an int8 cache dequantised)."""
    from dynamo_tpu_torch.ops.kv_quant import is_quant

    quant = is_quant(cache)
    kd = torch.zeros((len(lens), HK, max(lens), D), dtype=torch.bfloat16, device="cuda")
    vd = torch.zeros_like(kd)
    for i, n in enumerate(lens):
        if not n:
            continue
        if quant:
            k_rows, v_rows = _dequant_rows(torch, cache, bt[i, :-(-n // bs)], n, layer)
        else:
            rows = bt[i, :-(-n // bs)].long()
            k_rows = cache[layer, rows, 0].reshape(-1, HK, D)[:n]
            v_rows = cache[layer, rows, 1].reshape(-1, HK, D)[:n]
        kd[i, :, :n], vd[i, :, :n] = k_rows.transpose(0, 1), v_rows.transpose(0, 1)
    return kd, vd


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
    _check_graph_replay(torch, lambda: paged_decode_attention_q8(q, cache, LAYER, bt, seq_lens, q0),
                        "int8 decode")

    library_ms, library_eager_ms = _sdpa_decode_ms(
        torch, q, lens, lambda layer: _dense_kv(torch, cache, bt, lens, layer, bs))
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
    kernel_graph_ms = graph_time_ms([lambda: paged_prefill_attention_q8(*pargs)], 10)
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
    library_ms, library_eager_ms = _sdpa_ms(
        lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=pmask, enable_gqa=True))
    pairs = fresh * start + fresh * (fresh + 1) // 2
    nbytes = (2 * (2 * fresh * H * D + 2 * fresh * HK * D) + 2 * start * HK * D
              + 2 * start * HK * 4 + 4 * (m + 2))
    out["prefill_q8"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                             **_bound(4 * H * D * pairs, nbytes))
    log(f"time prefill int8 B=1 S={s} fresh={fresh} start={start} Bs={bs}: kernel {kernel_ms:.4f} ms "
        f"(CUDA graph {kernel_graph_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, sdpa on bf16 K/V {library_ms:.4f} ms (CUDA graph; eager "
        f"{library_eager_ms:.4f}), bound "
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
    # the verify's rows: B = 8 slots x S = k + 1 = 5
    m_verify = 8 * (SPEC_VERIFY_S[0])
    xv = rows(m_verify)
    out["matmul_verify"] = dict(m=m_verify, ms=layer_ms(kernel, xv, 40),
                                plain_ms=layer_ms(plain, xv, 8),
                                library_ms=median_ms(lambda: layer_ms(library, xv, 40)),
                                **layer_bound(m_verify))
    v = out["matmul_verify"]
    log(f"time matmul int8 one layer's 7 projections at M={m_verify} (the verify at S=5, CUDA "
        f"graph): kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, cuBLAS bf16 on dequantised "
        f"weights {v['library_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']}); "
        f"max abs err {max(compare(torch, f'matmul {n} at M={m_verify}', kernel(xv[n], 0, n), plain(xv[n], 0, n)) for n in PROJECTIONS):.3g} "
        f"({card})")
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


def verify_timing(torch, card: str) -> dict:
    """B1 (Bs 16) and B4a (Bs 32, the int8 path's block) at the verify shape:
    one layer of a verify over the eight slots (the six requests
    mid-generation, 3,865 tokens, and two empty rows) at S = 5 and 8 (k = 4
    and 7), a CUDA graph of the 32 layers' calls (the card's time), beside
    the plain version, SDPA on dense K/V (bf16; dequantised for the int8
    cache) timed the same way, and the bound.  Returns {"decode_verify":
    {S: reading}, "decode_q8_verify": {S: reading}}."""
    from dynamo_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention, paged_decode_attention_q8)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    lens = [n + MAX_TOKENS // 2 for n in PROMPT_LENS] + [0, 0]
    b = len(lens)
    seq_lens = _ints(torch, lens)
    out = {}
    for quant in (False, True):
        bs = BS_Q8 if quant else BS
        m = 2048 // bs
        n_blocks = sum(-(-n // bs) for n in lens) + 8
        bt = _tables(torch, lens, m, n_blocks, gen, bs)
        if quant:
            cache = _q8_cache(torch, gen, n_blocks, HK, D, bs)
        else:
            cache = torch.randn((L, n_blocks, 2, bs, HK * D), generator=gen,
                                device="cuda").to(torch.bfloat16)
        kernel = paged_decode_attention_q8 if quant else paged_decode_attention

        key = "decode_q8_verify" if quant else "decode_verify"
        out[key] = {}
        for s in SPEC_VERIFY_S:
            q = torch.randn((b, s, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            q0 = (seq_lens - s).clamp_min(0)
            calls = [lambda i=i: kernel(q, cache, i, bt, seq_lens, q0) for i in range(L)]
            kernel_ms = graph_time_ms(calls, 20) / L
            eager_ms = cuda_time_ms(lambda i: calls[i % L](), 64)
            plain_ms = cuda_time_ms(lambda i: decode_attention_ref(q, cache, i % L, bt, seq_lens, q0), 8)
            err = compare(torch, f"{key} S={s}", kernel(q, cache, LAYER, bt, seq_lens, q0),
                          decode_attention_ref(q, cache, LAYER, bt, seq_lens, q0))
            library_ms, library_eager_ms = _sdpa_decode_ms(
                torch, q, lens, lambda layer: _dense_kv(torch, cache, bt, lens, layer, bs), q0=q0)
            ctx = sum(lens)
            pairs = sum(min(n, max(n - s, 0) + j + 1) for n in lens for j in range(s))
            kv_bytes = 2 * ctx * HK * D * (1 if quant else 2) + (2 * ctx * HK * 4 if quant else 0)
            nbytes = 2 * (2 * b * s * H * D) + kv_bytes + 4 * (b * m + 2 * b)
            out[key][f"S={s}"] = r = dict(ms=kernel_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                                          library_ms=library_ms, max_abs_err=err,
                                          **_bound(4 * H * D * pairs, nbytes))
            log(f"time decode {'int8 Bs=32' if quant else 'bf16 Bs=16'} B={b} S={s} (verify) "
                f"ctx={ctx}: kernel {kernel_ms:.4f} ms (CUDA graph; eager {eager_ms:.4f}), plain "
                f"{plain_ms:.4f} ms, sdpa{' on bf16 K/V' if quant else ''} {library_ms:.4f} ms "
                f"(CUDA graph; eager {library_eager_ms:.4f}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), max abs err {err:.3g} ({card})")
        del cache
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


# --------------------------------------------------------- mixture of experts
# (experts, top k, hidden, expert width): Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B
# config.json), served below, and Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1
# config.json), 93 GB in bf16, so only one layer's expert stack is checked
# one DeepSeek-V2-Lite MoE layer (deepseek-ai/DeepSeek-V2-Lite config.json:
# 64 routed experts, top 6, hidden 2048, expert width 1408): (experts, top
# k, its three launches' [K, N])
V2_LITE_MOE = (64, 6, {"w_gate": (2048, 1408), "w_up": (2048, 1408), "w_down": (1408, 2048)})
MOE_GEOMS = {"Qwen3-30B-A3B": (MOE_EXPERTS, MOE_TOP_K, *MOE_LAUNCHES["w_gate"]),
             "Mixtral-8x7B": (8, 2, 4096, 14336),
             "DeepSeek-V2-Lite": (*V2_LITE_MOE[:2], *V2_LITE_MOE[2]["w_gate"])}
# tokens per check: one decode row, a decode step at 8 slots, the longest
# prompt, and a dispatch of 3,765 tokens (the six prompts' total)
MOE_CHECK_TOKENS = {"Qwen3-30B-A3B": (1, 8, 1504, 3765), "Mixtral-8x7B": (8, 1504),
                    "DeepSeek-V2-Lite": (1, 8, 1504)}
# the grouped kernel's edges: 5 experts of [144, N] and [N, 144] (a depth
# off the 64-deep sub-tile, N off the 128-channel tile and bf16's 64-channel
# TMA box: 200 is a multiple of 8, as bf16 needs, 208 of 16, as int8
# needs), top 2 of 5, 37 and 300 tokens (the 8-, 32- and 128-row tiles)
MOE_EDGE = dict(experts=5, k=2, depth=144, n={False: 200, True: 208}, tokens=(5, 37, 300))


def qwen3_30b_a3b(num_layers: int = 48):
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=151936, hidden_size=2048, intermediate_size=768,
                       num_layers=num_layers, num_heads=32, num_kv_heads=4, head_dim=128,
                       rope_theta=1e6, rms_norm_eps=1e-6, max_position_embeddings=40960,
                       qk_norm=True, num_experts=128, num_experts_per_tok=8, norm_topk_prob=True,
                       dtype="bfloat16")


def _expert_stack(torch, gen, experts, k, n, quant):
    """``cuda_timing.moe_stack``, an int8 stack as a QTensor."""
    from dynamo_tpu_torch.models.quant import QTensor

    w = moe_stack(gen, experts, k, n, quant)
    return QTensor(*w) if quant else w


def _grouped(quant):
    """(kernel, plain version) of E2 (``quant``) or E1, taking (x, w, offsets)
    with w a QTensor for E2."""
    from dynamo_tpu_torch.ops.kernels import grouped_matmul as g

    if quant:
        return (lambda x, w, o: g.grouped_matmul_q8(x, w.q, w.scale, o),
                lambda x, w, o: g.grouped_matmul_q8_ref(x, w.q, w.scale, o))
    return g.grouped_matmul, g.grouped_matmul_ref


def moe_kernel_phase(torch, gen) -> dict:
    """The grouped expert kernels (E1 bf16, E2 int8) against their plain
    versions at Qwen3-30B-A3B's expert shapes ([2048, 768] gate/up, [768,
    2048] down) for 1, 8, 1,504 and 3,765 tokens of top-8 rows, and at one
    Mixtral-8x7B layer's ([4096, 14336], [14336, 4096]) for 8 and 1,504
    tokens of top-2 rows, each with uniform routing and with every row on
    one expert (the others empty), and at the tile edges (``MOE_EDGE``);
    every launch run twice for the same bits.  Then the MoE MLP as a whole (router, sort, three grouped
    launches, combine) against the dense oracle, bf16 and int8."""
    errs = {"moe": 0.0, "moe_q8": 0.0}
    for model, (experts, k, dm, f) in MOE_GEOMS.items():
        for quant in (False, True):
            key = "moe_q8" if quant else "moe"
            kernel, plain = _grouped(quant)
            stacks = {"gate/up": (dm, _expert_stack(torch, gen, experts, dm, f, quant)),
                      "down": (f, _expert_stack(torch, gen, experts, f, dm, quant))}
            worst = 0.0
            for t in MOE_CHECK_TOKENS[model]:
                for routing in ("uniform", "one"):
                    offsets = moe_offsets(gen, t, experts, k, routing)
                    for name, (kdim, w) in stacks.items():
                        x = torch.randn((t * k, kdim), generator=gen, device="cuda").to(torch.bfloat16)
                        what = f"{key} {model} {name} T={t} ({t * k} rows) {routing}"
                        out = kernel(x, w, offsets)
                        check(torch.equal(out, kernel(x, w, offsets)), f"{what}: two launches differ")
                        worst = max(worst, compare(torch, what, out, plain(x, w, offsets)))
            log(f"kernel {key} {model} ({experts} experts, top {k}, [{dm}, {f}] and [{f}, {dm}]) "
                f"T in {MOE_CHECK_TOKENS[model]}, uniform and one-expert routing: max abs err {worst:.3g}, "
                f"every launch twice bit-identical")
            errs[key] = max(errs[key], worst)
            del stacks
            torch.cuda.empty_cache()
    for quant in (False, True):
        kernel, plain = _grouped(quant)
        e, k, kd, n = MOE_EDGE["experts"], MOE_EDGE["k"], MOE_EDGE["depth"], MOE_EDGE["n"][quant]
        worst = 0.0
        for a, b in ((kd, n), (n, kd)):
            w = _expert_stack(torch, gen, e, a, b, quant)
            for t in MOE_EDGE["tokens"]:
                offsets = moe_offsets(gen, t, e, k, "uniform")
                x = torch.randn((t * k, a), generator=gen, device="cuda").to(torch.bfloat16)
                what = f"{'moe_q8' if quant else 'moe'} edge [{a}, {b}] T={t}"
                out = kernel(x, w, offsets)
                check(torch.equal(out, kernel(x, w, offsets)), f"{what}: two launches differ")
                worst = max(worst, compare(torch, what, out, plain(x, w, offsets)))
        log(f"kernel {'moe_q8' if quant else 'moe'} edges: {e} experts, [{kd}, {n}] and [{n}, {kd}], "
            f"T in {MOE_EDGE['tokens']}: max abs err {worst:.3g}, every launch twice bit-identical")
        errs["moe_q8" if quant else "moe"] = max(errs["moe_q8" if quant else "moe"], worst)
    moe_mlp_check(torch, gen)
    return errs


def moe_mlp_check(torch, gen) -> None:
    """``_moe_mlp_grouped`` (the serving path: router, stable sort, the
    grouped kernel, the inverse-permutation combine) against
    ``_moe_mlp_dense`` (every expert on every token, cuBLAS) on the card at
    Qwen3-30B-A3B width, bf16 and int8 experts, one layer."""
    from dynamo_tpu_torch.models.llama import _moe_mlp_dense, _moe_mlp_grouped

    cfg = qwen3_30b_a3b(1)
    experts, _, dm, f = MOE_GEOMS["Qwen3-30B-A3B"]
    router = (torch.randn((dm, experts), generator=gen, device="cuda") / math.sqrt(dm)).to(torch.bfloat16)
    for quant in (False, True):
        lp = {"router": router, "w_gate": _expert_stack(torch, gen, experts, dm, f, quant),
              "w_up": _expert_stack(torch, gen, experts, dm, f, quant),
              "w_down": _expert_stack(torch, gen, experts, f, dm, quant)}
        errs = []
        for t in (1, 8, 64):
            x = torch.randn((1, t, dm), generator=gen, device="cuda").to(torch.bfloat16)
            got = _moe_mlp_grouped(cfg, lp, x)
            check(torch.equal(got, _moe_mlp_grouped(cfg, lp, x)), f"moe MLP T={t}: two runs differ")
            errs.append(compare(torch, f"moe MLP {'int8' if quant else 'bf16'} T={t}", got,
                                _moe_mlp_dense(cfg, lp, x)))
        log(f"kernel moe MLP (router + grouped dispatch + combine) vs the dense oracle, Qwen3-30B-A3B "
            f"width, {'int8' if quant else 'bf16'} experts, T = 1, 8, 64: max abs err {max(errs):.3g}, "
            f"two runs bit-identical")
        del lp
    torch.cuda.empty_cache()


def moe_timing(torch, card: str) -> dict:
    """One MoE layer's three grouped launches (gate and up on the sorted
    rows, down on the activations), uniform routing, at a decode step (T =
    8) and at the longest prompt's prefill (T = 1,504), two layers' stacks
    in turn (past the 50 MB L2): E1 and E2 at Qwen3-30B-A3B's launches
    (``cuda_timing.MOE_LAUNCHES``: 64 and 12,032 rows), and E1 at
    DeepSeek-V2-Lite's (``V2_LITE_MOE``: 48 and 9,024 rows).  The kernel as
    a CUDA graph (the card's time) and eagerly, the plain version, the
    per-expert cuBLAS loop over the same groups as a CUDA graph (int8: on
    the experts dequantised beforehand), ``torch._grouped_mm`` where this
    torch has it (the ``library_ms``; int8: on dequantised experts), and the
    bound: the weight bytes of the experts the rows route to (counted), x
    and every launch's input and output once, against 2 R K N per launch
    (``cuda_timing.moe_layer_work``).  Returns each kernel's Qwen3 T = 8
    row, with its T = 1,504 row under ``t1504`` and E1's DeepSeek-V2-Lite
    rows under ``deepseek_v2_lite``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    out = {}
    for quant in (False, True):
        key = "moe_q8" if quant else "moe"
        rows = _moe_layer_times(torch, card, gen, quant, "Qwen3-30B-A3B", MOE_EXPERTS, MOE_TOP_K,
                                MOE_LAUNCHES)
        (row8, err8), (row1504, err1504) = (rows[t] for t in MOE_TOKENS)
        out[key] = dict(row8, t1504=row1504)
        out[key + "_err"] = max(err8, err1504)
    rows = _moe_layer_times(torch, card, gen, False, "DeepSeek-V2-Lite", *V2_LITE_MOE)
    out["moe"]["deepseek_v2_lite"] = {f"t{t}": row for t, (row, _) in rows.items()}
    out["moe_err"] = max(out["moe_err"], *(err for _, err in rows.values()))
    return out


def _moe_layer_times(torch, card: str, gen, quant: bool, model: str, experts: int, top_k: int,
                     names: dict) -> dict:
    """``moe_timing`` for one kernel at one model's launches ``names``
    (name -> [K, N]): {T: (row, max abs err)} for T in MOE_TOKENS."""
    from dynamo_tpu_torch.models.quant import dequantize

    key = "moe_q8" if quant else "moe"
    kernel, plain = _grouped(quant)
    layers = [{n: _expert_stack(torch, gen, experts, kd, nd, quant) for n, (kd, nd) in names.items()}
              for _ in range(2)]
    dense = [{n: dequantize(w, torch.bfloat16) for n, w in layer.items()} for layer in layers]
    out = {}
    for t in MOE_TOKENS:
        r = t * top_k
        offsets = moe_offsets(gen, t, experts, top_k)
        bounds = offsets.tolist()
        groups = [(e, bounds[e], bounds[e + 1]) for e in range(experts) if bounds[e + 1] > bounds[e]]
        xs = {"w_gate": torch.randn((r, names["w_gate"][0]), generator=gen, device="cuda").to(torch.bfloat16)}
        xs["w_up"] = xs["w_gate"]
        xs["w_down"] = torch.randn((r, names["w_down"][0]), generator=gen, device="cuda").to(torch.bfloat16)
        outs = {n: torch.empty((r, nd), dtype=torch.bfloat16, device="cuda") for n, (_, nd) in names.items()}

        def calls(fn):
            return [lambda li=li, n=n: fn(xs[n], layers[li][n], offsets) for li in range(2) for n in names]

        def cublas():
            for li in range(2):
                for n in names:
                    for e, lo, hi in groups:
                        torch.matmul(xs[n][lo:hi], dense[li][n][e], out=outs[n][lo:hi])

        iters = 20 if t == 8 else 5
        ms = graph_time_ms(calls(kernel), iters) / 2
        eager = cuda_time_ms(lambda i: [c() for c in calls(kernel)], iters) / 2
        plain_ms = cuda_time_ms(lambda i: [c() for c in calls(plain)], 3) / 2
        loop_ms = median_ms(lambda: graph_time_ms([cublas], iters) / 2)
        lib_ms = None
        if hasattr(torch, "_grouped_mm"):
            ends = offsets[1:].contiguous()
            try:
                lib_ms = median_ms(lambda: graph_time_ms([
                    lambda li=li, n=n: torch._grouped_mm(xs[n], dense[li][n], offs=ends)
                    for li in range(2) for n in names], iters) / 2)
            except RuntimeError as e:  # a yardstick this torch cannot run is recorded, not used
                log(f"time {key}: torch._grouped_mm did not run here: {str(e)[:200]}")
        err = max(compare(torch, f"{key} {model} timing {n} T={t}", calls(kernel)[i](), calls(plain)[i]())
                  for i, n in enumerate(names))
        flops, nbytes = moe_layer_work(r, len(groups), quant, names)
        b = _bound(flops, nbytes)
        out[t] = (dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b), err)
        log(f"time {key} one {model} layer's 3 grouped launches at T={t} ({r} rows, "
            f"{len(groups)} of {experts} experts routed to): kernel {ms:.4f} ms (CUDA graph), "
            f"eager {eager:.4f} ms, plain {plain_ms:.4f} ms, per-expert cuBLAS loop "
            f"{'on dequantised experts ' if quant else ''}{loop_ms:.4f} ms (CUDA graph), "
            f"torch._grouped_mm {'not available' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
            f"max abs err {err:.3g} ({card})")
    del layers, dense
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ serving
def llama3_8b(num_layers: int = 32):
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                       num_layers=num_layers, num_heads=32, num_kv_heads=8,
                       max_position_embeddings=8192, rope_theta=500000.0, dtype="bfloat16")


def prompts(seed: int = 0, vocab: int = 128256) -> list[list[int]]:
    """The six prompts, token ids below ``vocab`` (Llama 3's unless named)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    out = []
    for i, n in enumerate(PROMPT_LENS):
        if i >= len(PROMPT_LENS) - 2:  # the two sharing a prefix
            out.append(shared + rng.integers(0, vocab, n - SHARED_PREFIX).tolist())
        else:
            out.append(rng.integers(0, vocab, n).tolist())
    return out


def model_prompts(model, seed: int = 0) -> list[list[int]]:
    """The six prompts for ``model``: Llama 3's ids, or below a smaller
    vocabulary (DeepSeek's 102,400)."""
    return prompts(seed, min(LLAMA3_VOCAB, model.config.vocab_size))


async def _serve(engine, reqs, sampling=None, max_tokens: int = MAX_TOKENS, tag: str = "req"):
    """Each request of ``reqs`` (token ids) concurrently, greedy or with
    ``sampling[i]`` (SamplingOptions fields), ``max_tokens`` tokens at most,
    as ids ``{tag}-{i}`` (a warm-up takes another tag: the engine may apply
    a late abort of a finished id to the next request of that id):
    [(TTFT, seconds to the end, outputs)]."""
    from dynamo_tpu_torch.llm.protocols import BackendInput, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(i, toks):
        t0 = time.perf_counter()
        first, outs = None, []
        opts = SamplingOptions(**(sampling[i] if sampling else {"temperature": 0.0}))
        ctx = Context(BackendInput(token_ids=toks, sampling=opts,
                                   stops=StopConditions(max_tokens=max_tokens)), id=f"{tag}-{i}")
        async for out in engine.generate(ctx):
            if first is None and out.token_ids:
                first = time.perf_counter() - t0
            outs.append(out)
        return first, time.perf_counter() - t0, outs

    return await asyncio.gather(*(one(i, t) for i, t in enumerate(reqs)))


def _kernel_wrappers() -> dict:
    from dynamo_tpu_torch.ops.kernels import decode_attention as dec
    from dynamo_tpu_torch.ops.kernels import grouped_matmul as gmm
    from dynamo_tpu_torch.ops.kernels import int8_matmul as mm
    from dynamo_tpu_torch.ops.kernels import prefill_attention as pre
    from dynamo_tpu_torch.ops.kernels import ragged_prefill_attention as rag

    return {"decode": dec.paged_decode_attention, "prefill": pre.paged_prefill_attention,
            "ragged": rag.ragged_paged_prefill_attention,
            "decode_q8": dec.paged_decode_attention_q8, "prefill_q8": pre.paged_prefill_attention_q8,
            "ragged_q8": rag.ragged_paged_prefill_attention_q8, "matmul": mm.int8_matmul,
            "moe": gmm.grouped_matmul, "moe_q8": gmm.grouped_matmul_q8}


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
        asyncio.run(_serve(engine, [list(range(1, 40))], tag="warm-up"))
        wrappers = _kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        before = (core.steps, core.overlap_s, core.read_wait_s)
        t0 = time.perf_counter()
        results = asyncio.run(_serve(engine, model_prompts(model)))
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
            profile_serving(torch, engine, model_prompts(model, seed=1), card)
    finally:
        engine.shutdown()
    streams = [[t for o in outs for t in o.token_ids] for _, _, outs in results]
    return dict(launches=launches, metrics=metrics, streams=streams, ttfts=ttfts,
                decode_tok_s=decode_tokens / decode_window)


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
    http_serving_run(torch, model, default, card)
    grammar_phase(torch, model, default, card)
    t0 = time.perf_counter()
    spec = spec_phase(torch, model, card)
    log(f"spec phase (bf16): {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    return default, budget, mixed, spec


def serve_both(torch, model, card: str, quant: bool):
    """The default path then the token-budget path on one model; checks
    that each run launched its path's kernels and none of the other cache
    kind's attention kernels.  Returns both runs and the largest mixed
    dispatch of the second."""
    tag = "int8 " if quant else ""
    q8 = "_q8" if quant else ""
    other = (("decode", "prefill", "ragged", "moe", "moe_q8") if quant
             else ("decode_q8", "prefill_q8", "ragged_q8", "matmul", "moe", "moe_q8"))
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
    t0 = time.perf_counter()
    spec = spec_phase_q8(torch, model, card)
    log(f"spec phase (int8): {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    return out + (spec,)


# ------------------------------------------------------------- speculation
# The copy task of benchmarks/bench_spec.py: each of the six prompts repeats
# a seeded 32-token segment to its length, so prompt lookup matches from
# the first turn; 64 tokens each, five rows greedy and one seeded.
SPEC_SEGMENT = 32
SPEC_MAX_TOKENS = 64
SPEC_SEEDED_ROW = 5
SPEC_SEEDED = dict(temperature=0.9, top_p=0.9, seed=1234)
SPEC_VERIFY_S = (5, 8)  # S = k + 1 for k = 4 and 7
# A verify and a burst compute the same logits through other kernels (the
# projections at 8 x S rows, the decode kernel at S > 1), so bf16 rounding
# can flip a greedy pick where two tokens nearly tie, and nowhere else.
# Each card computation's logits lie within eps = PARITY_MAX_REL x max|logit|
# of the exact ones (phase 5's card-vs-CPU bound): two tokens that two runs
# order differently lie within 2 eps of each other exactly, hence within 4
# eps in a third card computation, the re-scoring prefill.  A seeded row
# compares its noisy scores l / T + g the same way, within 4 eps / T.
SPEC_TIE_EPS = 4


def verify_live(lens, s: int) -> list[int]:
    """Live queries of each row of a verify whose rows proposed fewer than
    k tokens (1 to S), cut at the row's context."""
    pattern = (1, s, 2, s - 3, s, 3, s - 1, 1)
    return [min(n, pattern[i % len(pattern)]) for i, n in enumerate(lens)]


def llama32_1b():
    """Llama-3.2-1B's published geometry (meta-llama/Llama-3.2-1B
    config.json): Llama 3's tokenizer, so a draft for Llama-3-8B."""
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=LLAMA3_VOCAB, hidden_size=2048, intermediate_size=8192,
                       num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
                       max_position_embeddings=131072, rope_theta=500000.0,
                       rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 8192},
                       tie_word_embeddings=True, dtype="bfloat16")


def spec_prompts(seed: int = 2) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for n in PROMPT_LENS:
        seg = rng.integers(0, LLAMA3_VOCAB, SPEC_SEGMENT).tolist()
        out.append((seg * -(-n // SPEC_SEGMENT))[:n])
    return out


def spec_sampling() -> list[dict]:
    return [SPEC_SEEDED if i == SPEC_SEEDED_ROW else {"temperature": 0.0}
            for i in range(len(PROMPT_LENS))]


@contextlib.contextmanager
def recorded_attention(torch, draft=None):
    """Count the decode kernel's calls by wrapper and S, and time every call
    of the plain attention op with CUDA events, by wrapping the routing's
    references (the wrappers and their launch counts are untouched).  A
    plain-op call made inside the draft's dispatch is marked: its k - 1
    steps run at S = 1, so only its ingest can make one."""
    from dynamo_tpu_torch.ops import paged_attention as routing

    names = ("paged_decode_attention", "paged_decode_attention_q8", "paged_attention")
    real = {n: getattr(routing, n) for n in names}
    rec = dict(decode={}, plain=[])
    in_draft = [False]

    def decode(name):
        def call(q, *args, **kw):
            key = f"{'B4a' if name.endswith('q8') else 'B1'} S={q.shape[1]}"
            rec["decode"][key] = rec["decode"].get(key, 0) + 1
            return real[name](q, *args, **kw)
        return call

    def plain(q, *args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real["paged_attention"](q, *args, **kw)
        end.record()
        rec["plain"].append((q.shape[1], in_draft[0], start, end))
        return out

    if draft is not None:
        real_impl = draft._impl

        def impl(*args, **kw):
            in_draft[0] = True
            try:
                return real_impl(*args, **kw)
            finally:
                in_draft[0] = False
        draft._impl = impl
    for n in names[:2]:
        setattr(routing, n, decode(n))
    routing.paged_attention = plain
    try:
        yield rec
    finally:
        for n in names:
            setattr(routing, n, real[n])
        if draft is not None:
            del draft._impl


def spec_run(torch, model, config: dict, card: str, label: str, draft=None) -> dict:
    """The spec cell's six requests once through ``AsyncLLMEngine`` under
    one EngineConfig (a draft model when named), every launch counter zeroed
    just before and read just after; each decode turn timed on the host (a
    verify turn, the draft's dispatch included, or a burst), the decode
    kernel's calls split by S, the plain op's calls timed."""
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.llm.protocols import FinishReason

    core = EngineCore(model, EngineConfig(**config), device="cuda", draft=draft)
    turns = {"verify": [], "burst": []}
    real_decode = core._run_decode

    def run_decode():
        t0, s0, d0, g0 = time.perf_counter(), core.spec_steps, core.decode_steps, core.tokens_generated
        real_decode()
        kind = "verify" if core.spec_steps > s0 else "burst"
        turns[kind].append((time.perf_counter() - t0, core.decode_steps - d0,
                            core.tokens_generated - g0))

    core._run_decode = run_decode
    engine = AsyncLLMEngine(core).start()
    try:
        asyncio.run(_serve(engine, [list(range(1, 40))], max_tokens=8, tag="warm-up"))
        wrappers = _kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        for v in turns.values():
            v.clear()
        keys = ("spec_steps", "spec_proposed", "spec_accepted", "device_gets_total")
        before = {k: core.metrics()[k] for k in keys}
        host0, turns0 = core._host_s, core._turns
        dispatches0 = core.draft.dispatches if core.draft is not None else 0
        with recorded_attention(torch, core.draft) as rec:
            t0 = time.perf_counter()
            results = asyncio.run(_serve(engine, spec_prompts(), spec_sampling(),
                                         max_tokens=SPEC_MAX_TOKENS))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        counts = {k: core.metrics()[k] - before[k] for k in keys}
        host_gap_ms = 1e3 * (core._host_s - host0) / max(1, core._turns - turns0)
        draft_dispatches = (core.draft.dispatches - dispatches0) if core.draft is not None else 0
    finally:
        engine.shutdown()
        # the wrapper closes over the core: without this the core, its cache,
        # its model and its draft wait for the cycle collector
        del core._run_decode
    for i, (_, _, outs) in enumerate(results):
        toks = [t for o in outs for t in o.token_ids]
        check(outs[-1].finish_reason is FinishReason.LENGTH,
              f"spec {label} request {i}: finish {outs[-1].finish_reason}, expected length")
        check(len(toks) == SPEC_MAX_TOKENS, f"spec {label} request {i}: {len(toks)} tokens")
    plain = [(s, ingest, start.elapsed_time(end)) for s, ingest, start, end in rec["plain"]]
    ttfts = sorted(r[0] for r in results)
    decode_window = wall - ttfts[0]
    share = counts["spec_accepted"] / counts["spec_proposed"] if counts["spec_proposed"] else 0.0
    verify_tokens = sum(t for _, _, t in turns["verify"])
    verify_ms = [1e3 * dt for dt, _, _ in turns["verify"]]
    burst_step_ms = [1e3 * dt / n for dt, n, _ in turns["burst"] if n]
    out = dict(
        label=label, wall_s=wall, ttft_median_s=ttfts[len(ttfts) // 2], ttft_max_s=ttfts[-1],
        decode_tok_s=len(results) * (SPEC_MAX_TOKENS - 1) / decode_window,
        host_gap_ms_per_turn=host_gap_ms, **counts, accepted_share=share,
        tokens_per_verify=verify_tokens / counts["spec_steps"] if counts["spec_steps"] else 0.0,
        verify_turns=len(verify_ms), verify_turn_ms=sorted(verify_ms)[len(verify_ms) // 2]
        if verify_ms else None, bursts=len(burst_step_ms),
        burst_step_ms=sorted(burst_step_ms)[len(burst_step_ms) // 2] if burst_step_ms else None,
        draft_dispatches=draft_dispatches, decode_calls_by_s=rec["decode"],
        plain_calls=len(plain), plain_calls_outside_draft=sum(1 for _, ing, _ in plain if not ing),
        plain_ms=sum(ms for _, _, ms in plain), plain_s=sorted({s for s, _, _ in plain}),
        launches=launches)
    log(f"spec {label}: wall {wall:.3f} s, TTFT median/max {out['ttft_median_s']:.3f}/"
        f"{out['ttft_max_s']:.3f} s, decode {out['decode_tok_s']:.1f} tok/s, host gap "
        f"{host_gap_ms:.2f} ms/turn; verify turns {out['verify_turns']} (median "
        f"{out['verify_turn_ms'] or 0:.2f} ms), bursts {out['bursts']} (median "
        f"{out['burst_step_ms'] or 0:.2f} ms a step); spec_steps {counts['spec_steps']}, "
        f"proposed {counts['spec_proposed']}, accepted {counts['spec_accepted']} (share "
        f"{share:.3f}), tokens emitted per verify {out['tokens_per_verify']:.2f} (6 rows); draft "
        f"dispatches {draft_dispatches}; decode kernel calls by S {rec['decode']}; plain-op calls "
        f"{len(plain)} (S {out['plain_s']}, outside the draft {out['plain_calls_outside_draft']}) "
        f"{out['plain_ms']:.3f} ms; device reads {counts['device_gets_total']} ({card})")
    out["streams"] = [[t for o in outs for t in o.token_ids] for _, _, outs in results]
    return out


def _rescore(torch, model, seq, bs, cache_dtype):
    """The logits after ``seq`` from one prefill over a fresh cache."""
    n = len(seq)
    pad = -(-n // bs) * bs
    nb = pad // bs
    cache = model.init_kv_cache(nb + 1, bs, cache_dtype)
    bt = torch.zeros((1, 2048 // bs), dtype=torch.int32, device="cuda")
    bt[0, :nb] = torch.arange(1, nb + 1, dtype=torch.int32)
    t = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    t[0, :n] = torch.tensor(seq, dtype=torch.int32)
    pos = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    pos[0, :n] = torch.arange(n, dtype=torch.int32)
    slot = torch.full((1, pad), -1, dtype=torch.int32, device="cuda")
    slot[0, :n] = bt[0, pos[0, :n].long() // bs] * bs + pos[0, :n] % bs
    hidden, _ = model.forward(t, pos, cache, bt, torch.tensor([n], dtype=torch.int32,
                                                               device="cuda"), slot,
                              prefix_blocks=0)
    return model.compute_logits(hidden[:, n - 1])[0].float().cpu()


def spec_near_ties(torch, model, base: dict, run: dict, card: str, bs=BS, cache_dtype=None) -> int:
    """Hold ``run``'s streams to ``base``'s (speculation off): where a row
    parts, re-score the common prefix on the card and require the two
    tokens' logits (a seeded row: its noisy scores) within SPEC_TIE_EPS x
    PARITY_MAX_REL x max|logit| (/ T).  Returns the rows that parted."""
    from dynamo_tpu_torch.engine.sampling import K_MAX, seeded_gumbel

    prompts, sampling = spec_prompts(), spec_sampling()
    parted = 0
    for i, (a, b) in enumerate(zip(base["streams"], run["streams"])):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        parted += 1
        logits = _rescore(torch, model, prompts[i] + a[:j], bs, cache_dtype)
        tol = SPEC_TIE_EPS * PARITY_MAX_REL * float(logits.abs().max())
        la, lb = float(logits[a[j]]), float(logits[b[j]])
        samp = sampling[i]
        if samp.get("seed") is None:
            gap, what = abs(la - lb), "logit gap"
        else:
            t = samp["temperature"]
            g = seeded_gumbel(torch.tensor([samp["seed"] & 0x7FFFFFFF], dtype=torch.int32),
                              torch.tensor([len(prompts[i]) + j], dtype=torch.int32),
                              torch.tensor([[a[j], b[j]]], dtype=torch.int32))[0]
            gap, what, tol = abs((la - lb) / t + float(g[0] - g[1])), "noisy-score gap", tol / t
        top = torch.topk(logits, 2).values
        ranks = [int((logits > logits[tok]).sum()) for tok in (a[j], b[j])]
        edge = ""
        if samp.get("top_p", 1.0) < 1.0:
            # the probability mass ranked above each token (the top-K_MAX
            # candidates at T): a token near top_p sits at the kept set's edge
            probs = torch.softmax(torch.topk(logits, K_MAX).values / samp["temperature"], -1)
            before = (torch.cumsum(probs, -1) - probs).tolist()
            edge = (f", mass ranked above them {', '.join(f'{before[r]:.4f}' if r < K_MAX else '-' for r in ranks)} "
                    f"(top_p {samp['top_p']})")
        log(f"spec {run['label']} vs off: request {i} parts at token {j} ({a[j]} vs {b[j]}, logit "
            f"ranks {ranks[0]} and {ranks[1]}{edge}), re-scored {what} {gap:.4g} (tol {tol:.4g}; "
            f"top-2 margin there {float(top[0] - top[1]):.4g}) ({card})")
        check(gap <= tol, f"spec {run['label']}: request {i} parts at token {j} by a {what} of "
              f"{gap} > {tol}: not a near-tie")
    log(f"spec {run['label']}: {len(base['streams']) - parted} of {len(base['streams'])} streams "
        f"equal speculation off's ({card})")
    return parted


def spec_checks(runs: dict, quant: bool = False) -> None:
    """Each speculative run verified, at S = k + 1 on the decode kernel, and
    made plain-op calls only in a draft's ingest (none without a draft)."""
    kernel = "B4a" if quant else "B1"
    for label, r in runs.items():
        k = r.get("k", 0)
        if not k:
            check(r["spec_steps"] == 0, f"spec {label}: {r['spec_steps']} verifies with spec off")
            continue
        check(r["spec_steps"] > 0, f"spec {label}: no verify turn")
        check(r["decode_calls_by_s"].get(f"{kernel} S={k + 1}", 0) > 0,
              f"spec {label}: {kernel} never launched at S={k + 1}: {r['decode_calls_by_s']}")
        if r["draft"]:
            check(r["plain_calls_outside_draft"] == 0,
                  f"spec {label}: {r['plain_calls_outside_draft']} plain-op calls outside the "
                  "draft's ingest")
        else:
            check(r["plain_calls"] == 0, f"spec {label}: {r['plain_calls']} plain-op calls")


def spec_phase(torch, model, card: str) -> dict:
    """Speculative decoding on the loaded Llama-3-8B bf16 model: the spec
    cell's requests with speculation off, n-gram lookup at k = 4 and 7, the
    model as its own draft (its weights, a cache of its own) and a
    Llama-3.2-1B-width draft (random weights from a seed), k = 4."""
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    t0 = time.perf_counter()
    cfg = llama32_1b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    draft = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda"))
    n_params = sum(p.numel() for p in draft.parameters())
    log(f"spec: Llama-3.2-1B-width draft, {n_params / 1e9:.3f} B parameters, "
        f"{2 * n_params / 1e9:.2f} GB bf16, random weights in {time.perf_counter() - t0:.1f} s")
    plan = (("off", 0, None), ("ngram k=4", 4, None), ("ngram k=7", 7, None),
            ("self-draft k=4", 4, model), ("1B draft k=4", 4, draft))
    runs = {}
    for label, k, d in plan:
        runs[label] = spec_run(torch, model, dict(DEFAULT_PATH, spec_tokens=k), card, label,
                               draft=d)
        runs[label].update(k=k, draft=d is not None)
        torch.cuda.empty_cache()
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    spec_checks(runs)
    for label, r in runs.items():
        if r["k"]:
            r["parted"] = spec_near_ties(torch, model, runs["off"], r, card)
    self_share = runs["self-draft k=4"]["accepted_share"]
    small_share = runs["1B draft k=4"]["accepted_share"]
    check(self_share > small_share, f"spec: the self-draft accepted {self_share:.3f}, not more "
          f"than the 1B draft's {small_share:.3f}")
    log(f"spec: accepted share, self-draft {self_share:.3f} against the 1B draft's "
        f"{small_share:.3f} ({card})")
    return runs


def spec_phase_q8(torch, model, card: str) -> dict:
    """Speculation off and n-gram lookup at k = 4 on the int8 model (int8
    weights and cache, Bs = 32): the verify on B4a and B5."""
    runs = {}
    for label, k in (("int8 off", 0), ("int8 ngram k=4", 4)):
        runs[label] = spec_run(torch, model, dict(INT8_DEFAULT_PATH, spec_tokens=k), card, label)
        runs[label].update(k=k, draft=False)
        gc.collect()
        torch.cuda.empty_cache()
    spec_checks(runs, quant=True)
    check(runs["int8 ngram k=4"]["launches"]["matmul"] > 0, "spec int8: B5 never launched")
    runs["int8 ngram k=4"]["parted"] = spec_near_ties(
        torch, model, runs["int8 off"], runs["int8 ngram k=4"], card, bs=BS_Q8, cache_dtype="int8")
    return runs


def moe_serving_phase(torch, card: str) -> tuple[dict, dict]:
    """Qwen3-30B-A3B at full width and depth (48 layers, random weights from
    a seeded generator, drawn on the card one layer at a time) behind
    ``AsyncLLMEngine``, the six requests once per configuration, each run
    profiled: bf16 on the default path (B1, B2, E1), then, the bf16 model
    freed, int8 weights with an int8 KV cache (Bs = 32) on the token-budget
    path (B4a, B4c, B5, E2).  Every Llama model and engine is gone before:
    61 GB of bf16 weights leave about 18 GB of the card."""
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = qwen3_30b_a3b()
    runs = []
    for quant, config, label, need, none in (
            (False, DEFAULT_PATH, "Qwen3-30B-A3B bf16 default path", ["decode", "prefill", "moe"],
             ["decode_q8", "prefill_q8", "ragged", "ragged_q8", "matmul", "moe_q8"]),
            (True, INT8_BUDGET_PATH, "Qwen3-30B-A3B int8 token-budget path",
             ["decode_q8", "ragged_q8", "matmul", "moe_q8"], ["decode", "prefill", "ragged", "moe"])):
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        t0 = time.perf_counter()
        model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda", quantized=quant))
        torch.cuda.synchronize()
        weights = sum(p.numel() * p.element_size() for p in model.parameters())
        log(f"serving: Qwen3-30B-A3B{' int8' if quant else ''}, {cfg.num_layers} layers, "
            f"{weights / 1e9:.2f} GB of random weights in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run = serve_run(torch, model, config, card, label, profile=True)
        log(f"serving: the {label} run, its warm-up and its profile took "
            f"{time.perf_counter() - t0:.1f} s on the host")
        check(all(run["launches"][k] > 0 for k in need) and not any(run["launches"][k] for k in none),
              f"{label}: launches {run['launches']}, need {need} > 0, {none} = 0")
        if quant:
            m = run["metrics"]
            check(m["unified_dispatches_total"] > 0 and m["lookahead_bursts_total"] > 0,
                  f"the {label} made no mixed dispatch or no burst: {m}")
        runs.append(run)
        del model
    torch.cuda.empty_cache()
    return runs[0], runs[1]


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

    # device time and launches by kernel name, summed over the raw events:
    # key_averages() builds a Python object for each of a run's ~10^5
    # launches and took up to 160 s for one Qwen3-30B-A3B run
    t0 = time.perf_counter()
    per_name: dict[str, tuple[float, int]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            us, n = per_name.get(e.name(), (0.0, 0))
            per_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    events = sorted(per_name.items(), key=lambda kv: kv[1][0], reverse=True)
    busy_s = sum(us for us, _ in per_name.values()) / 1e6
    top = ", ".join(f"{name[:48]} {us / 1e3:.1f} ms x{n}" for name, (us, n) in events[:6])
    log(f"profile: device busy {busy_s:.3f} s of {wall:.3f} s wall ({100 * busy_s / wall:.1f}%); "
        f"top kernels: {top}; {len(events)} device event names summed in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    grouped = {}  # the grouped expert kernel's device time by (E1 or E2, rows a tile)
    for name, (us, count) in events:
        m = re.search(r"grouped_wgmma_kernel<(\d+), (true|false)>", name)
        if m:
            kind = "E2" if m.group(2) == "true" else "E1"
            ms, n = grouped.get((kind, int(m.group(1))), (0.0, 0))
            grouped[(kind, int(m.group(1)))] = (ms + us / 1e3, n + count)
    for kind in ("E1", "E2"):
        rows = sorted((r, v) for (k, r), v in grouped.items() if k == kind)
        if rows:
            log(f"profile: {kind} device time {sum(v[0] for _, v in rows):.1f} ms over "
                f"{sum(v[1] for _, v in rows)} launches; by rows a tile: " + ", ".join(
                    f"{r}: {ms:.1f} ms x{n}" for r, (ms, n) in rows) + f" ({card})")


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
        LIVE_TOKENS["mask"] = slot.reshape(-1) >= 0
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
        LIVE_TOKENS["mask"] = slot.reshape(-1) >= 0
        hidden, _ = model.forward(tokens.to(device), pos.to(device), cache, bt.to(device),
                                  ints(lens), slot.to(device), prefix_blocks=pb,
                                  ragged=(seq_ids.to(device), ints(starts), ints(offs)),
                                  ragged_row_tokens=region)
        logits.append(model.compute_logits(hidden[0, last.to(device)]).float().cpu())
    return torch.cat(logits)


# the live (non-padding) tokens of the dispatch being run, flat, for
# moe_routes: a padding token's hidden state is nobody's output and may
# differ between the kernels and the plain versions
LIVE_TOKENS = {"mask": None}


@contextlib.contextmanager
def moe_routes(torch, replay=None):
    """Within the block every MoE router call's expert ids are recorded
    (``replay`` None; the yielded list fills in call order), or replaced
    by the recorded ones (``replay``: that list), the replaying side
    weighting them by its own logits as the router does.  Both families'
    routers are covered: the Llama family's (Mixtral, Qwen3-MoE) and
    DeepSeek's, whose group-limited routing also records the groups it
    kept.  On replay the yielded dict counts the live (token, layer)
    routes whose own choice agreed and the largest logit gap of a
    disagreeing one (see ROUTE_TIE and :func:`_route_gap`)."""
    from dynamo_tpu_torch.models import deepseek, llama

    real = {mod: mod._moe_router for mod in (llama, deepseek)}
    recorded = [] if replay is None else iter(replay)
    stats = {"routes": 0, "same": 0, "max_gap": 0.0}

    def router(mod):
        def routed(cfg, lp, xf):
            weights, topi = real[mod](cfg, lp, xf)
            logits = deepseek.router_logits(lp, xf) if mod is deepseek else (xf @ lp["router"]).float()
            grouped = getattr(cfg, "topk_method", None) == "group_limited_greedy"
            if replay is None:
                groups = deepseek.limited_groups(cfg, torch.softmax(logits, -1)) if grouped else None
                recorded.append((topi.cpu(), None if groups is None else groups.cpu()))
                return weights, topi
            pinned, groups = (None if x is None else x.to(topi.device) for x in next(recorded))
            live = LIVE_TOKENS["mask"].to(topi.device)
            same = (topi.sort(-1).values == pinned.sort(-1).values).all(-1)[live]
            gap = _route_gap(torch, cfg, logits, pinned, groups)[live]
            stats["routes"] += len(same)
            stats["same"] += int(same.sum())
            stats["max_gap"] = max(stats["max_gap"], float(gap.max()))
            return mod.router_weights(cfg, logits, pinned), pinned
        return routed

    for mod in real:
        mod._moe_router = router(mod)
    try:
        yield recorded if replay is None else stats
    finally:
        for mod, fn in real.items():
            mod._moe_router = fn


def _route_gap(torch, cfg, logits, pinned, groups=None):
    """Per token, how far this side's logits [T, E] are from choosing the
    pinned experts [T, k]: the k-th largest logit minus a pinned expert's,
    at most over the pinned (0 where they are this side's top k).  Under
    group-limited routing (``groups``: the pinned side's kept groups [T,
    topk_group]) the k-th largest is taken within those groups, and the
    group choice adds its own gap: this side's ``topk_group``-th group best
    minus the best of a group the pinned side kept."""
    k = pinned.shape[1]
    if groups is not None:
        t, per = logits.shape[0], cfg.n_routed_experts // cfg.n_group
        best = logits.reshape(t, cfg.n_group, per).amax(-1)                  # [T, G]
        kth_group = best.sort(-1, descending=True).values[:, cfg.topk_group - 1:cfg.topk_group]
        group_gap = (kth_group - best.gather(-1, groups)).clamp_min(0).amax(-1)
        allowed = torch.zeros_like(best, dtype=torch.bool).scatter_(1, groups, True)
        logits = logits.masked_fill(~allowed.repeat_interleave(per, dim=-1), float("-inf"))
    kth = logits.sort(-1, descending=True).values[:, k - 1:k]
    gap = (kth - logits.gather(-1, pinned)).clamp_min(0).amax(-1)
    return gap if groups is None else gap.maximum(group_gap)


def _hold_card_to_cpu(torch, what: str, on_card, on_cpu, card: str) -> None:
    """The card's logits (``on_card()``) held to the CPU's; an MoE model's
    CPU run routes as the card's did, and its own routes are held to
    ROUTE_TIE."""
    with moe_routes(torch) as routes:
        got = on_card()
    with moe_routes(torch, routes) as stats:
        ref = on_cpu()
    if stats["routes"]:
        _hold_routes(what, stats, card)
    _hold_logits(torch, what, got, ref, card)


def _hold_routes(what: str, stats: dict, card: str) -> None:
    log(f"parity {what}: {stats['same']} of {stats['routes']} (token, layer) routes chose the card's "
        f"experts on the CPU too; the largest logit gap of one that did not: {stats['max_gap']:.3g} "
        f"(tol {ROUTE_TIE}) ({card})")
    check(stats["max_gap"] <= ROUTE_TIE,
          f"parity {what}: a route differs by a logit gap of {stats['max_gap']} > {ROUTE_TIE}")


def _hold_logits(torch, what: str, a, b, card: str) -> None:
    check(bool(torch.isfinite(a).all()), f"{what}: non-finite logits on the card")
    rel_l2 = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
    max_rel = ((a - b).abs().amax(dim=-1) / b.abs().amax(dim=-1)).max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"parity {what}: max rel L2 {rel_l2:.3g} (tol {PARITY_REL_L2}), max |diff|/max|logit| "
        f"{max_rel:.3g} (tol {PARITY_MAX_REL}), argmax agreement {agree:.3f} ({card})")
    check(rel_l2 <= PARITY_REL_L2, f"parity {what}: rel L2 {rel_l2} > {PARITY_REL_L2}")
    check(max_rel <= PARITY_MAX_REL, f"parity {what}: max rel {max_rel} > {PARITY_MAX_REL}")


def _verify_logits(torch, model, device, rows, bs=BS, cache_dtype=None):
    """Prefill each row's prefix (its own dispatch), then ONE speculative
    verify dispatch [B, S]: row i's live tokens at its prefix length on,
    padding past them (positions 0, no cache write), as the engine lays a
    verify out.  Returns the logits at every live verify position."""
    m = 2048 // bs
    s = max(len(toks) for _, toks in rows)
    b = len(rows)
    cache = model.init_kv_cache(1 + sum(-(-(len(p) + s) // bs) for p, _ in rows), bs, cache_dtype)
    host_bt = torch.zeros((b, m), dtype=torch.int32)
    nxt = 1
    for i, (prefix, _) in enumerate(rows):
        nb = -(-(len(prefix) + s) // bs)
        host_bt[i, :nb] = torch.arange(nxt, nxt + nb, dtype=torch.int32)
        nxt += nb
    bt = host_bt.to(device)
    for i, (prefix, _) in enumerate(rows):  # prefill each prefix
        n = len(prefix)
        pad = -(-n // bs) * bs
        t = torch.zeros((1, pad), dtype=torch.int32)
        t[0, :n] = torch.tensor(prefix, dtype=torch.int32)
        pos = torch.zeros((1, pad), dtype=torch.int32)
        pos[0, :n] = torch.arange(n, dtype=torch.int32)
        slot = torch.full((1, pad), -1, dtype=torch.int32)
        slot[0, :n] = host_bt[i, pos[0, :n].long() // bs] * bs + pos[0, :n] % bs
        LIVE_TOKENS["mask"] = (slot.reshape(-1) >= 0).to(device)
        model.forward(t.to(device), pos.to(device), cache, bt[i:i + 1],
                      torch.tensor([n], dtype=torch.int32, device=device), slot.to(device),
                      prefix_blocks=0)
    tokens = torch.zeros((b, s), dtype=torch.int32)
    pos = torch.zeros((b, s), dtype=torch.int32)
    slot = torch.full((b, s), -1, dtype=torch.int32)
    lens = torch.zeros(b, dtype=torch.int32)
    for i, (prefix, toks) in enumerate(rows):
        n, p = len(toks), len(prefix)
        tokens[i, :n] = torch.tensor(toks, dtype=torch.int32)
        pos[i, :n] = torch.arange(p, p + n, dtype=torch.int32)
        slot[i, :n] = host_bt[i, pos[i, :n].long() // bs] * bs + pos[i, :n] % bs
        lens[i] = p + n
    LIVE_TOKENS["mask"] = (slot.reshape(-1) >= 0).to(device)
    hidden, _ = model.forward(tokens.to(device), pos.to(device), cache, bt, lens.to(device),
                              slot.to(device))
    live = (slot >= 0).to(device)
    return model.compute_logits(hidden[live]).float().cpu()


def parity_phase(torch, card: str, quant: bool = False, make_cfg=None, width: str = "8B",
                 verify: bool = False) -> None:
    """A 2-layer model at full width (``make_cfg``: Llama-3-8B's unless
    named) on the card and on the CPU, the same weights on both: bf16
    weights with a bf16 cache (Bs = 16), or int8 weights with an int8 cache
    (``quant``, Bs = 32).  An MoE model's CPU run takes the card's expert
    choices (``moe_routes``).  With ``verify``, also a speculative verify
    dispatch at S = 5 (the decode kernel on the card)."""
    import numpy as np

    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    make_cfg = make_cfg or llama3_8b
    cfg = make_cfg(2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_params(cfg, gen, device="cuda", quantized=quant)
    gpu = LlamaModel.from_state(cfg, state)
    cpu_cfg = make_cfg(2)
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
    _hold_card_to_cpu(
        torch, f"default path: 2-layer {width} width, {tag}300-token prompt over a 128-token "
        "prefix + 8 decode steps",
        lambda: _forward_logits(torch, gpu, torch.device("cuda"), prompt, steps, 128, bs, kv),
        lambda: _forward_logits(torch, cpu, torch.device("cpu"), prompt, steps, 128, bs, kv), card)

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
    _hold_card_to_cpu(
        torch, f"ragged: 2-layer {width} width, {tag}packed prefill of 3 spans, then 2 decode "
        "rows + 2 spans",
        lambda: _ragged_logits(torch, gpu, torch.device("cuda"), dispatches, bs, kv),
        lambda: _ragged_logits(torch, cpu, torch.device("cpu"), dispatches, bs, kv), card)
    if verify:
        # three rows: all five verify tokens live, three, and one (a row
        # whose proposal is empty)
        s = SPEC_VERIFY_S[0]
        rows = [(rng.integers(0, cfg.vocab_size, n).tolist(),
                 rng.integers(0, cfg.vocab_size, live).tolist())
                for n, live in ((300, s), (97, 3), (640, 1))]
        _hold_card_to_cpu(
            torch, f"verify: 2-layer {width} width, {tag}one S={s} dispatch over prefixes of "
            "300, 97 and 640 tokens, 5, 3 and 1 live queries",
            lambda: _verify_logits(torch, gpu, torch.device("cuda"), rows, bs, kv),
            lambda: _verify_logits(torch, cpu, torch.device("cpu"), rows, bs, kv), card)
    del gpu, cpu, state
    torch.cuda.empty_cache()


# --------------------------------------------------------------- front door
# A 2-layer HF checkpoint at Llama-3-8B width (3.0 GB in bf16), written by
# this script into a git-ignored directory beside it and removed at the end
FRONT_DIR = ROOT / "_frontdoor"
FRONT_LAYERS = 2
FRONT_MODEL = "front"
FRONT_MAX_TOKENS = 16
# the word-level tokenizer's special tokens, at Llama 3's ids (128,000 on)
# or, for a larger vocabulary, at the same places in its last 256 ids; ids
# 0-2 are the chat roles and the rest up to the specials the words w3 ...
SPECIALS = {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001, "<unk>": 128002,
            "<|start_header_id|>": 128006, "<|end_header_id|>": 128007, "<|eot_id|>": 128009}
ROLES = ("system", "user", "assistant")
LLAMA3_VOCAB = 128256


def specials(vocab: int = LLAMA3_VOCAB) -> dict[str, int]:
    return {t: i + vocab - LLAMA3_VOCAB for t, i in SPECIALS.items()}


def eos_ids(vocab: int = LLAMA3_VOCAB) -> list[int]:
    sp = specials(vocab)
    return [sp["<|end_of_text|>"], sp["<|eot_id|>"]]
# Llama 3's chat layout, spaced for a whitespace tokenizer; it emits BOS
# itself, so the preprocessor must not add a second one
CHAT_TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}<|start_header_id|> {{ m['role'] }} <|end_header_id|> "
    "{{ m['content'] }} <|eot_id|> {% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|> assistant <|end_header_id|>{% endif %}")
FRONT_CHAT = [{"role": "system", "content": "w5 w6"}, {"role": "user", "content": "w7 w8 w9"}]
# BOS, then 6 + 7 tokens of the two turns and 3 of the generation prompt
FRONT_CHAT_TOKENS = 17
# (port name, HF name with {i} for the layer, whether HF stores it [out, in])
FRONT_NAMES = {
    "embed": ("model.embed_tokens.weight", False), "final_norm": ("model.norm.weight", False),
    "lm_head": ("lm_head.weight", True),
    "layers.attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
    "layers.mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight", False),
    "layers.wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "layers.wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "layers.wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "layers.wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "layers.w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "layers.w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "layers.w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
}
# the in-process servers' bf16 flags, and the int8 token-budget ones
FRONT_FLAGS = ["--max-model-len", "2048", "--num-blocks", "256"]
FRONT_INT8_FLAGS = FRONT_FLAGS + ["--quantize", "int8", "--kv-cache-dtype", "int8",
                                  "--block-size", "32", "--prefill-token-budget", "1024",
                                  "--unified-token-dispatch", "--lookahead-dispatch"]


def write_tokenizer(d: Path, size: int = LLAMA3_VOCAB) -> None:
    """A word-level tokenizer of ``size`` ids (Llama 3's 128,256 unless
    named; BOS added on encode) and a tokenizer_config.json with the chat
    template."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    sp, first = specials(size), size - 256
    vocab = {r: i for i, r in enumerate(ROLES)}
    vocab.update({f"w{i}": i for i in range(len(ROLES), first)})
    vocab.update(sp)
    vocab.update({f"<|reserved_special_token_{i}|>": i for i in range(first, size)
                  if i not in sp.values()})
    tk = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.add_special_tokens([t for t, i in sorted(vocab.items(), key=lambda x: x[1]) if i >= first])
    bos = sp["<|begin_of_text|>"]
    tk.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A", special_tokens=[("<|begin_of_text|>", bos)])
    d.mkdir(parents=True, exist_ok=True)
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "chat_template": CHAT_TEMPLATE, "bos_token": "<|begin_of_text|>",
        "eos_token": "<|eot_id|>"}))


def write_checkpoint(torch, d: Path) -> float:
    """The 2-layer checkpoint: config.json and random bf16 weights from a
    seeded generator (matrices N(0, 1/fan_in), norms 1 + N(0, 0.1^2)) in
    two safetensors shards with an index.  Returns the bytes written."""
    from safetensors.torch import save_file

    cfg = llama3_8b(FRONT_LAYERS)
    dm, hd, f = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": dm, "intermediate_size": f,
        "num_hidden_layers": FRONT_LAYERS, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings, "rms_norm_eps": 1e-5,
        "hidden_act": "silu", "tie_word_embeddings": False, "bos_token_id": 128000,
        "eos_token_id": eos_ids(), "torch_dtype": "bfloat16"}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def matrix(rows, cols):  # HF layout [out, in]
        w = torch.randn((rows, cols), generator=gen, device="cuda", dtype=torch.float32)
        return w.div_(math.sqrt(cols)).to(torch.bfloat16).cpu()

    def norm():
        w = 1 + 0.1 * torch.randn((dm,), generator=gen, device="cuda", dtype=torch.float32)
        return w.to(torch.bfloat16).cpu()

    def layer(i):
        p = f"model.layers.{i}."
        return {p + "input_layernorm.weight": norm(), p + "post_attention_layernorm.weight": norm(),
                p + "self_attn.q_proj.weight": matrix(cfg.num_heads * hd, dm),
                p + "self_attn.k_proj.weight": matrix(cfg.num_kv_heads * hd, dm),
                p + "self_attn.v_proj.weight": matrix(cfg.num_kv_heads * hd, dm),
                p + "self_attn.o_proj.weight": matrix(dm, cfg.num_heads * hd),
                p + "mlp.gate_proj.weight": matrix(f, dm), p + "mlp.up_proj.weight": matrix(f, dm),
                p + "mlp.down_proj.weight": matrix(dm, f)}

    shards = [{"model.embed_tokens.weight": matrix(cfg.vocab_size, dm), **layer(0)},
              {**layer(1), "model.norm.weight": norm(), "lm_head.weight": matrix(cfg.vocab_size, dm)}]
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, str(d / name), metadata={"format": "pt"})
        weight_map.update({t: name for t in shard})
        total += sum(t.numel() * t.element_size() for t in shard.values())
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def check_loaded(torch, model, d: Path, label: str, names: dict = FRONT_NAMES,
                 experts: int = 0, first_layer: dict | None = None) -> None:
    """Every parameter the loader built equals the shards' tensor,
    transposed where HF stores [out, in] and stacked over the layers of its
    group (``layers.``, or DeepSeek's ``dense_layers.`` / ``moe_layers.``,
    whose slot j is HF layer ``first_layer[group] + j``) and the
    ``experts`` of a name with ``{e}``: exactly in bf16; for int8 weights,
    the codes and scales equal the quantisation of the shards' bf16
    tensor."""
    from safetensors import safe_open

    from dynamo_tpu_torch.models.quant import quantize

    index = json.loads((d / "model.safetensors.index.json").read_text())["weight_map"]
    state = model.state_dict()
    n = 0
    for name, (fmt, transpose) in names.items():
        slots = [()]
        group = name.rpartition(".")[0]
        if group:
            depth = state[name].shape[0]
            slots = [(i, e) for i in range(depth) for e in range(experts)] if "{e}" in fmt else [
                (i,) for i in range(depth)]
        first = (first_layer or {}).get(group, 0)
        for slot in slots:
            key = fmt.format(i=first + slot[0], e=slot[-1]) if slot else fmt
            with safe_open(d / index[key], framework="pt", device="cuda") as f:
                w = f.get_tensor(key)
            w = w.t() if transpose else w
            got = state[name][slot]
            if name + "_scale" in state:
                qt = quantize(w, (0,) if name == "embed" else (-1,))
                same = torch.equal(got, qt.q) and torch.equal(state[name + "_scale"][slot], qt.scale)
            else:
                same = got.dtype == w.dtype and torch.equal(got, w)
            check(same, f"front door {label}: {name}{list(slot)} differs from the checkpoint's {key}")
            n += 1
    log(f"front door {label}: {n} loaded tensors equal the checkpoint's shards")


async def _post(session, url: str, body: dict) -> tuple:
    """(status, JSON body or the SSE events' data, seconds to the first SSE
    event that carries text or a finish)."""
    t0 = time.perf_counter()
    async with session.post(url, json=body) as r:
        if r.headers.get("Content-Type", "").split(";")[0] != "text/event-stream":
            return r.status, await r.json(), None
        events, first = [], None
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[6:]
            ev = data if data == "[DONE]" else json.loads(data)
            if first is None and ev != "[DONE]" and ev["choices"] and (
                    ev["choices"][0].get("text") or ev["choices"][0].get("delta", {}).get("content")
                    or ev["choices"][0].get("finish_reason")):
                first = time.perf_counter() - t0
            events.append(ev)
        return r.status, events, first


def _text(events) -> str:
    """The text of one choice's SSE events (completion or chat)."""
    return "".join(e["choices"][0].get("text") or e["choices"][0].get("delta", {}).get("content")
                   or "" for e in events if e != "[DONE]" and e["choices"])


def _front_requests() -> list[tuple[str, dict]]:
    """The requests a server answers one at a time and a fresh engine
    replays: (path, body), all greedy."""
    base = {"model": FRONT_MODEL, "max_tokens": FRONT_MAX_TOKENS, "temperature": 0}
    words = " ".join(f"w{i}" for i in range(1000, 1030))
    return [
        ("/v1/completions", {**base, "prompt": words}),
        ("/v1/completions", {**base, "prompt": list(range(2000, 2300)), "stream": True}),
        ("/v1/chat/completions", {**base, "messages": FRONT_CHAT, "stream": True}),
        ("/v1/completions", {**base, "prompt": words[:60], "logprobs": 3}),
    ]


def _detok(tokenizer, toks) -> str:
    """Tokens to text as the serving path's detokenizer streams them (a
    special token in the middle drops the space before the next word,
    where ``decode`` of the whole list keeps it)."""
    stream = tokenizer.decode_stream()
    return "".join(stream.step(t) for t in toks)


def _answer_text(answer) -> str:
    if isinstance(answer, list):
        return _text(answer)
    c = answer["choices"][0]
    return c["text"] if "text" in c else c["message"]["content"]


@contextlib.contextmanager
def cli_server(model_dir: Path, flags=()):
    """``python3 -m dynamo_tpu_torch run in=http out=gpu`` on ``model_dir``
    (with ``flags``) as a subprocess, as a user starts it; yields (its base
    URL, a coroutine function waiting for /health that returns the seconds
    it took), then stops it with SIGTERM, which must exit 0.  Its log is
    ``_frontdoor/cli.log`` while it runs."""
    import signal
    import socket

    import aiohttp

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    log_path = FRONT_DIR / "cli.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch", "run", "in=http", "out=gpu",
             "--model-path", str(model_dir), "--model-name", FRONT_MODEL, "--http-port",
             str(port), *flags], cwd=str(ROOT), stdout=err, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"

    async def ready(s) -> float:
        while True:
            try:
                async with s.get(f"{base}/health") as r:
                    health = await r.json()
                break
            except aiohttp.ClientConnectionError:
                check(proc.poll() is None and time.perf_counter() - t0 < 300,
                      "the CLI server did not come up: " + log_path.read_text()[-3000:])
                await asyncio.sleep(0.25)
        check(health["models"] == [FRONT_MODEL], f"CLI /health: {health}")
        return time.perf_counter() - t0

    try:
        yield base, ready
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    check(rc == 0, f"the CLI server exited with {rc} on SIGTERM: {log_path.read_text()[-3000:]}")


def cli_phase(card: str, flags: tuple = (), label: str = "Llama-3-8B-width") -> None:
    """``python3 -m dynamo_tpu_torch run in=http out=gpu`` on the
    checkpoint (with ``flags``), as a user starts it: every request kind,
    /metrics, and a clean exit on SIGTERM."""
    import aiohttp

    with cli_server(FRONT_DIR, flags) as (base, wait_ready):
        async def go():
            async with aiohttp.ClientSession() as s:
                ready = await wait_ready(s)
                base_body = {"model": FRONT_MODEL, "max_tokens": FRONT_MAX_TOKENS,
                             "temperature": 0}
                words = " ".join(f"w{i}" for i in range(3000, 3020))
                answers = {}
                for kind, path, body in [
                    ("unary", "/v1/completions", {**base_body, "prompt": words}),
                    ("stream", "/v1/completions", {**base_body, "prompt": words, "stream": True}),
                    ("chat", "/v1/chat/completions", {**base_body, "messages": FRONT_CHAT,
                                                      "stream": True}),
                    ("n2", "/v1/completions", {**base_body, "prompt": words, "n": 2}),
                    ("logprobs", "/v1/completions", {**base_body, "prompt": words, "logprobs": 2}),
                    ("stop", "/v1/completions", {**base_body, "prompt": words, "stop": [" "]}),
                    ("404", "/v1/completions", {**base_body, "model": "nope", "prompt": words}),
                ]:
                    answers[kind] = await _post(s, base + path, body)
                async with s.get(f"{base}/metrics") as r:
                    metrics = await r.text()
            return ready, answers, metrics

        ready, answers, metrics = asyncio.run(go())

    def finished(c, usage_tokens):
        return (c["finish_reason"] == "length" and usage_tokens == FRONT_MAX_TOKENS) or (
            c["finish_reason"] == "stop" and 1 <= usage_tokens <= FRONT_MAX_TOKENS)

    status, body, _ = answers["unary"]
    check(status == 200 and finished(body["choices"][0], body["usage"]["completion_tokens"]),
          f"CLI unary completion: {status} {body}")
    status, events, _ = answers["stream"]
    check(status == 200 and events[-1] == "[DONE]" and
          events[-2]["choices"][0]["finish_reason"] in ("length", "stop"),
          f"CLI streamed completion: {status} {events[-3:]}")
    status, events, _ = answers["chat"]
    check(status == 200 and events[0]["choices"][0]["delta"].get("role") == "assistant" and
          events[-1] == "[DONE]" and events[-2]["usage"]["prompt_tokens"] == FRONT_CHAT_TOKENS,
          f"CLI streamed chat (expected {FRONT_CHAT_TOKENS} prompt tokens through the template, "
          f"one BOS): {status} {events[:1]} {events[-2:]}")
    status, body, _ = answers["n2"]
    check(status == 200 and [c["index"] for c in body["choices"]] == [0, 1],
          f"CLI n=2: {status} {body}")
    status, body, _ = answers["logprobs"]
    lp = body["choices"][0]["logprobs"] if status == 200 else {}
    check(status == 200 and len(lp["tokens"]) == body["usage"]["completion_tokens"] and
          all(math.isfinite(v) and v <= 0 for v in lp["token_logprobs"]) and
          all(len(t) <= 2 for t in lp["top_logprobs"]), f"CLI logprobs: {status} {body}")
    status, body, _ = answers["stop"]
    c = body["choices"][0] if status == 200 else {}
    check(status == 200 and c["finish_reason"] == "stop" and " " not in c["text"],
          f"CLI stop string: {status} {body}")
    status, body, _ = answers["404"]
    check(status == 404 and body["error"]["type"] == "model_not_found", f"CLI 404: {status} {body}")
    from dynamo_tpu_torch.obs.metric_names import HttpMetric

    rows = dict(line.rsplit(" ", 1) for line in metrics.splitlines() if not line.startswith("#"))
    done = {ep: int(rows.get(f'{HttpMetric.REQUESTS_TOTAL}{{model="{FRONT_MODEL}",'
                             f'endpoint="{ep}",status="success"}}', 0))
            for ep in ("completions", "chat_completions")}
    check(done == {"completions": 5, "chat_completions": 1} and
          int(rows.get(f'{HttpMetric.OUTPUT_TOKENS_TOTAL}{{model="{FRONT_MODEL}"}}', 0)) > 0,
          f"CLI /metrics: requests {done}")
    log(f"front door CLI: `python3 -m dynamo_tpu_torch run in=http out=gpu{''.join(' ' + f for f in flags)}` "
        f"on the {FRONT_LAYERS}-layer {label} checkpoint answered /health after {ready:.1f} s, then unary, "
        f"streamed, chat, n=2, logprobs, stop-string and 404 requests, /metrics counted "
        f"{done}; exit 0 on SIGTERM ({card})")


GRAMMAR_DIR = FRONT_DIR / "bytes"
GRAMMAR_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                                   "n": {"type": "integer"}},
                  "required": ["ok", "n"]}


def write_byte_tokenizer(d: Path, size: int = LLAMA3_VOCAB) -> None:
    """A byte-level BPE with no merges (so every text is one token per
    byte and the grammar compiler sees real bytes): the 256 bytes in
    GPT-2's printable alphabet at ids 3-258, Llama 3's special tokens at
    their ids, filler entries up to ``size``; and a tokenizer_config.json
    with the chat template."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    from dynamo_tpu_torch.engine.grammar import _gpt2_unicode_to_bytes

    sp = specials(size)
    vocab = {r: i for i, r in enumerate(ROLES)}
    vocab.update({ch: 3 + b for ch, b in _gpt2_unicode_to_bytes().items()})
    vocab.update(sp)
    vocab.update({f"<|filler_{i}|>": i for i in range(259, size) if i not in sp.values()})
    tk = Tokenizer(models.BPE(vocab=vocab, merges=[], unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    tk.add_special_tokens(list(sp))
    d.mkdir(parents=True, exist_ok=True)
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "chat_template": CHAT_TEMPLATE, "bos_token": "<|begin_of_text|>",
        "eos_token": "<|eot_id|>"}))


def grammar_cli_phase(card: str) -> None:
    """The front-door checkpoint with a byte-level tokenizer, served by
    ``python3 -m dynamo_tpu_torch run in=http out=gpu``: a chat with a
    ``json_schema`` response format answers JSON of the schema's shape (or
    stops at max_tokens inside it), a ``guided_regex`` completion replays
    through the regex's tables, and one seeded completion sent twice gives
    the same text."""
    import aiohttp

    from dynamo_tpu_torch.engine.grammar import (
        compile_regex_vocab, compile_vocab, json_schema_to_regex)

    for f in FRONT_DIR.iterdir():
        if f.suffix in (".json", ".safetensors") and not f.name.startswith("tokenizer"):
            (GRAMMAR_DIR / f.name).parent.mkdir(parents=True, exist_ok=True)
            (GRAMMAR_DIR / f.name).symlink_to(f)
    write_byte_tokenizer(GRAMMAR_DIR)
    base_body = {"model": FRONT_MODEL, "max_tokens": 48}
    schema_format = {"type": "json_schema", "json_schema": {"name": "r", "schema": GRAMMAR_SCHEMA}}
    seeded = {**base_body, "prompt": "Once upon a time", "temperature": 0.9, "seed": 7}
    with cli_server(GRAMMAR_DIR) as (base, wait_ready):
        async def go():
            async with aiohttp.ClientSession() as s:
                ready = await wait_ready(s)
                answers = [await _post(s, base + path, body) for path, body in [
                    ("/v1/chat/completions", {**base_body, "temperature": 0,
                                              "messages": [{"role": "user", "content": "Report."}],
                                              "response_format": schema_format}),
                    ("/v1/completions", {**base_body, "temperature": 0, "prompt": "Phone: ",
                                         "guided_regex": GRAMMAR_REGEX}),
                    ("/v1/completions", seeded), ("/v1/completions", seeded)]]
            return ready, answers

        ready, answers = asyncio.run(go())
    check(all(a[0] == 200 for a in answers), f"grammar CLI: statuses {[a[:2] for a in answers]}")
    bytes_vocab = [bytes([b]) for b in range(256)]
    texts = [_answer_text(a[1]) for a in answers]
    reasons = [a[1]["choices"][0]["finish_reason"] for a in answers]
    schema_rx = json_schema_to_regex(GRAMMAR_SCHEMA)
    for i, (rx, text, reason) in enumerate(zip((schema_rx, GRAMMAR_REGEX), texts, reasons)):
        tables = compile_regex_vocab(bytes_vocab, rx)
        check(_replays(tables, list(text.encode()), ()) and (
            reason == "length" or re.fullmatch(rx, text)),
            f"grammar CLI answer {i} ({reason}): {text!r} is outside {rx}")
    if reasons[0] == "stop":
        json.loads(texts[0])
    check(_replays(compile_vocab(bytes_vocab), list(texts[0].encode()), ()),
          f"grammar CLI: the schema answer {texts[0]!r} leaves the JSON grammar")
    check(texts[2] == texts[3], f"grammar CLI: one seeded request gave {texts[2]!r} then "
                                f"{texts[3]!r}")
    log(f"grammar CLI: `python3 -m dynamo_tpu_torch run in=http out=gpu` on the {FRONT_LAYERS}-layer "
        f"checkpoint with a byte-level tokenizer answered /health after {ready:.1f} s; json_schema "
        f"chat {reasons[0]} {texts[0][:60]!r}, guided_regex {reasons[1]} {texts[1]!r}, the seeded "
        f"completion twice {texts[2][:40]!r}; exit 0 on SIGTERM ({card})")


def front_server(torch, flags: list[str], card: str, label: str, need: list[str],
                 none: list[str], names: dict = FRONT_NAMES, experts: int = 0,
                 first_layer: dict | None = None) -> None:
    """``build_local_engine`` on the checkpoint with ``flags`` behind the
    port's HttpService on port 0: the loaded tensors against the shards,
    then the requests one at a time with every kernel counter zeroed just
    before and read just after (the kernels in ``need`` must have
    launched, those in ``none`` not), then each answer against a fresh
    engine's greedy tokens on the same model and config, one at a time."""
    import aiohttp

    from dynamo_tpu_torch.cli import build_local_engine, parse_args
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineCore
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService
    from dynamo_tpu_torch.llm.openai import parse_request
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime.engine import Context

    args = parse_args(["run", "in=http", "out=gpu", "--model-path", str(FRONT_DIR),
                       "--model-name", FRONT_MODEL, *flags])
    engine, mcard = build_local_engine(args)
    model, config = engine.core.model, engine.core.config
    reqs = _front_requests()
    try:
        check_loaded(torch, model, FRONT_DIR, label, names, experts, first_layer)
        wrappers = _kernel_wrappers()

        async def serve():
            svc = HttpService(port=0, core=engine.core)
            svc.manager.add_model(FRONT_MODEL, build_serving_pipeline(engine, mcard), mcard)
            await svc.start()
            try:
                async with aiohttp.ClientSession() as s:
                    url = f"http://127.0.0.1:{svc.port}"
                    return [await _post(s, url + path, body) for path, body in reqs]
            finally:
                await svc.stop()

        for fn in wrappers.values():
            fn.launches = 0
        answers = asyncio.run(serve())
        launches = {name: fn.launches for name, fn in wrappers.items()}
    finally:
        engine.shutdown()
    check(all(a[0] == 200 for a in answers), f"front door {label}: statuses {[a[0] for a in answers]}")
    check(all(launches[k] > 0 for k in need) and not any(launches[k] for k in none),
          f"front door {label}: launches {launches}, need {need} > 0, {none} = 0")

    fresh = AsyncLLMEngine(EngineCore(model, config, eos_token_ids=mcard.eos_token_ids or None,
                                      device="cuda")).start()
    pre = OpenAIPreprocessor(mcard)
    try:
        async def direct():
            out = []
            for path, body in reqs:
                ctx = await pre.forward(Context(parse_request(body, chat="chat" in path)))
                toks = [t async for o in fresh.generate(Context(ctx.data)) for t in o.token_ids]
                out.append(_detok(pre.tokenizer, toks))
            return out

        texts = asyncio.run(direct())
    finally:
        fresh.shutdown()
    got = [_answer_text(a[1]) for a in answers]
    check(got == texts, f"front door {label}: HTTP answers {got} != a fresh engine's {texts}")
    log(f"front door {label}: build_local_engine({' '.join(flags)}) behind HttpService; "
        f"{len(reqs)} requests one at a time (unary, streamed token-id prompt, streamed chat, "
        f"logprobs) equal a fresh engine's greedy text; launches {launches} ({card})")


def front_door_phase(torch, card: str) -> None:
    t0 = time.perf_counter()
    nbytes = write_checkpoint(torch, FRONT_DIR)
    log(f"front door: wrote a {FRONT_LAYERS}-layer Llama-3-8B-width checkpoint, "
        f"{nbytes / 1e9:.2f} GB in two shards, in {time.perf_counter() - t0:.1f} s")
    cli_phase(card)
    grammar_cli_phase(card)
    front_server(torch, FRONT_FLAGS, card, "bf16 default path", ["decode", "prefill"],
                 ["decode_q8", "prefill_q8", "ragged", "ragged_q8", "matmul", "moe", "moe_q8"])
    torch.cuda.empty_cache()
    front_server(torch, FRONT_INT8_FLAGS, card, "int8 token-budget path",
                 ["decode_q8", "ragged_q8", "matmul"], ["decode", "prefill", "ragged", "moe", "moe_q8"])
    torch.cuda.empty_cache()
    log(f"front door: phase wall {time.perf_counter() - t0:.1f} s ({card})")


# The Qwen3-MoE checkpoint: Qwen3-30B-A3B's width and tensor names, cut to
# 2 layers (3.7 GB: 384 expert tensors a layer), its 151,936-id vocabulary
MOE_FRONT_NAMES = {
    **{k: v for k, v in FRONT_NAMES.items() if k not in ("layers.w_gate", "layers.w_up", "layers.w_down")},
    "layers.q_norm": ("model.layers.{i}.self_attn.q_norm.weight", False),
    "layers.k_norm": ("model.layers.{i}.self_attn.k_norm.weight", False),
    "layers.router": ("model.layers.{i}.mlp.gate.weight", True),
    "layers.w_gate": ("model.layers.{i}.mlp.experts.{e}.gate_proj.weight", True),
    "layers.w_up": ("model.layers.{i}.mlp.experts.{e}.up_proj.weight", True),
    "layers.w_down": ("model.layers.{i}.mlp.experts.{e}.down_proj.weight", True),
}


def write_moe_checkpoint(torch, d: Path) -> float:
    """The 2-layer Qwen3-MoE checkpoint: config.json as Qwen3-30B-A3B's with
    2 layers, and random bf16 weights from a seeded generator (matrices
    N(0, 1/fan_in), norms 1 + N(0, 0.1^2)) under the real checkpoint's
    names, in two safetensors shards with an index.  Returns the bytes
    written."""
    from safetensors.torch import save_file

    cfg = qwen3_30b_a3b(FRONT_LAYERS)
    dm, hd, f, e = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.num_experts
    sp = specials(cfg.vocab_size)
    (d / "config.json").write_text(json.dumps({
        "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe",
        "vocab_size": cfg.vocab_size, "hidden_size": dm, "intermediate_size": 6144,
        "moe_intermediate_size": f, "num_hidden_layers": FRONT_LAYERS,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": hd, "num_experts": e, "num_experts_per_tok": cfg.num_experts_per_tok,
        "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [],
        "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "hidden_act": "silu", "tie_word_embeddings": False,
        "bos_token_id": sp["<|begin_of_text|>"], "eos_token_id": eos_ids(cfg.vocab_size),
        "torch_dtype": "bfloat16"}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def matrix(rows, cols):  # HF layout [out, in]
        w = torch.randn((rows, cols), generator=gen, device="cuda", dtype=torch.float32)
        return w.div_(math.sqrt(cols)).to(torch.bfloat16).cpu()

    def norm(n=dm):
        w = 1 + 0.1 * torch.randn((n,), generator=gen, device="cuda", dtype=torch.float32)
        return w.to(torch.bfloat16).cpu()

    def layer(i):
        p = f"model.layers.{i}."
        out = {p + "input_layernorm.weight": norm(), p + "post_attention_layernorm.weight": norm(),
               p + "self_attn.q_proj.weight": matrix(cfg.num_heads * hd, dm),
               p + "self_attn.k_proj.weight": matrix(cfg.num_kv_heads * hd, dm),
               p + "self_attn.v_proj.weight": matrix(cfg.num_kv_heads * hd, dm),
               p + "self_attn.o_proj.weight": matrix(dm, cfg.num_heads * hd),
               p + "self_attn.q_norm.weight": norm(hd), p + "self_attn.k_norm.weight": norm(hd),
               p + "mlp.gate.weight": matrix(e, dm)}
        for j in range(e):
            q = f"{p}mlp.experts.{j}."
            out.update({q + "gate_proj.weight": matrix(f, dm), q + "up_proj.weight": matrix(f, dm),
                        q + "down_proj.weight": matrix(dm, f)})
        return out

    shards = [{"model.embed_tokens.weight": matrix(cfg.vocab_size, dm), **layer(0)},
              {**layer(1), "model.norm.weight": norm(), "lm_head.weight": matrix(cfg.vocab_size, dm)}]
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, str(d / name), metadata={"format": "pt"})
        weight_map.update({t: name for t in shard})
        total += sum(t.numel() * t.element_size() for t in shard.values())
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def moe_front_door_phase(torch, card: str) -> None:
    """The front door on the 2-layer Qwen3-MoE checkpoint: the CLI server
    (bf16, then ``--quantize int8``), then ``build_local_engine`` in this
    process, bf16 on the default path (B1, B2, E1) and int8 weights and
    cache on the token-budget path (B4a, B4c, B5, E2)."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(FRONT_DIR, ignore_errors=True)
    cfg = qwen3_30b_a3b(FRONT_LAYERS)
    write_tokenizer(FRONT_DIR, cfg.vocab_size)
    nbytes = write_moe_checkpoint(torch, FRONT_DIR)
    n_files = len(json.loads((FRONT_DIR / "model.safetensors.index.json").read_text())["weight_map"])
    log(f"front door: wrote a {FRONT_LAYERS}-layer Qwen3-30B-A3B-width Qwen3-MoE checkpoint, "
        f"{nbytes / 1e9:.2f} GB, {n_files} tensors in two shards, in {time.perf_counter() - t0:.1f} s")
    cli_phase(card, (), "Qwen3-MoE")
    cli_phase(card, ("--quantize", "int8"), "Qwen3-MoE")
    front_server(torch, FRONT_FLAGS, card, "Qwen3-MoE bf16 default path", ["decode", "prefill", "moe"],
                 ["decode_q8", "prefill_q8", "ragged", "ragged_q8", "matmul", "moe_q8"],
                 MOE_FRONT_NAMES, cfg.num_experts)
    torch.cuda.empty_cache()
    front_server(torch, FRONT_INT8_FLAGS, card, "Qwen3-MoE int8 token-budget path",
                 ["decode_q8", "ragged_q8", "matmul", "moe_q8"], ["decode", "prefill", "ragged", "moe"],
                 MOE_FRONT_NAMES, cfg.num_experts)
    torch.cuda.empty_cache()
    log(f"front door Qwen3-MoE: phase wall {time.perf_counter() - t0:.1f} s ({card})")


def _http_run(model, mcard) -> tuple[list, float]:
    """One HTTP run on a fresh default-path engine: a warm-up request, then
    the six prompts concurrently; returns the answers and the wall time.
    Every stream must end on the length limit and the server must count
    MAX_TOKENS tokens out for each request, so that decode tok/s counts
    the tokens the streams carried."""
    import aiohttp

    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService

    engine = AsyncLLMEngine(EngineCore(model, EngineConfig(**DEFAULT_PATH), device="cuda")).start()

    async def go():
        svc = HttpService(port=0, core=engine.core)
        svc.manager.add_model(mcard.name, build_serving_pipeline(engine, mcard), mcard)
        await svc.start()
        try:
            async with aiohttp.ClientSession() as s:
                url = f"http://127.0.0.1:{svc.port}/v1/completions"

                def body(toks):
                    return {"model": mcard.name, "prompt": toks, "max_tokens": MAX_TOKENS,
                            "temperature": 0, "stream": True}

                await _post(s, url, body(list(range(1, 40))))  # warm-up, as the direct run
                t0 = time.perf_counter()
                out = await asyncio.gather(*(_post(s, url, body(p)) for p in prompts()))
                return out, time.perf_counter() - t0, svc.metrics.tokens_out[mcard.name]
        finally:
            await svc.stop()

    try:
        answers, wall, n_out = asyncio.run(go())
    finally:
        engine.shutdown()
    check(all(a[0] == 200 and a[1][-1] == "[DONE]" for a in answers),
          f"32-layer HTTP run: {[a[0] for a in answers]}")
    finishes = [[e["choices"][0]["finish_reason"] for e in a[1] if e != "[DONE]" and e["choices"]
                 and e["choices"][0].get("finish_reason")] for a in answers]
    check(all(f == ["length"] for f in finishes) and n_out == (len(answers) + 1) * MAX_TOKENS,
          f"32-layer HTTP run: finish reasons {finishes}, {n_out} tokens out for "
          f"{len(answers) + 1} requests of {MAX_TOKENS}")
    return answers, wall


def http_serving_run(torch, model, direct: dict, card: str) -> None:
    """The serving phase's 32-layer model behind the port's HttpService
    with the word-level tokenizer: the six prompts as token-id completions,
    concurrent and streamed, 32 greedy tokens each; TTFT at the client
    (first SSE event with text).  The host's speed drifts within a call, so
    the HTTP runs alternate with direct runs (direct, HTTP, direct, HTTP,
    direct, the first direct run being the default path's) and the front
    door's cost is the median of the HTTP runs' TTFT medians minus that of
    the direct runs'."""
    import statistics

    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper

    mcard = ModelDeploymentCard(name="llama3-8b", tokenizer_path=str(FRONT_DIR / "tokenizer.json"),
                                context_length=8192)
    tok = TokenizerWrapper.from_file(FRONT_DIR)
    runs = {"direct": [direct], "http": []}
    for turn in range(2):
        answers, wall = _http_run(model, mcard)
        ttfts = [a[2] for a in answers]
        runs["http"].append(dict(ttfts=ttfts, decode_tok_s=len(answers) * (MAX_TOKENS - 1) /
                                 (wall - min(ttfts))))
        same = sum(_text(a[1]) == _detok(tok, s) for a, s in zip(answers, direct["streams"]))
        log(f"serving over HTTP, run {turn + 1}: Llama-3-8B {model.config.num_layers} layers, "
            f"default path, the six prompts as token-id completions, concurrent, streamed, "
            f"{MAX_TOKENS} greedy tokens: wall {wall:.3f} s, TTFT min/median/max "
            f"{min(ttfts):.3f}/{sorted(ttfts)[len(ttfts) // 2]:.3f}/{max(ttfts):.3f} s at the client, "
            f"decode {runs['http'][-1]['decode_tok_s']:.1f} tok/s; {same} of {len(answers)} texts "
            f"equal the first direct run's (informational: batch timing differs) ({card})")
        runs["direct"].append(serve_run(torch, model, DEFAULT_PATH, card,
                                        f"default path beside HTTP, run {turn + 2}"))
    # a run's median as the serving lines print it (the upper of the six's two)
    med = {k: [sorted(r["ttfts"])[len(r["ttfts"]) // 2] for r in v] for k, v in runs.items()}
    tps = {k: [r["decode_tok_s"] for r in v] for k, v in runs.items()}
    cost = statistics.median(med["http"]) - statistics.median(med["direct"])
    log(f"front-door cost: TTFT medians over HTTP {[round(x, 3) for x in med['http']]} s, direct "
        f"{[round(x, 3) for x in med['direct']]} s: {1e3 * cost:.1f} ms per request (median of "
        f"the HTTP runs minus median of the direct runs); decode tok/s over HTTP "
        f"{[round(x, 1) for x in tps['http']]}, direct {[round(x, 1) for x in tps['direct']]} "
        f"({card})")


# ------------------------------------------------------------------ grammar
GRAMMAR_CHOICES = ["alpha", "beta", "gamma"]
GRAMMAR_REGEX = "[0-9][0-9][0-9]-[0-9][0-9][0-9][0-9]"
# the constrained mix, one row per serving prompt; the seeded rows sit on
# prompts that share no prefix, so their prefill never depends on another
# request's cached blocks
GRAMMAR_TRAFFIC = (
    dict(temperature=0.0, json_mode=True),
    dict(temperature=1.0, seed=1234, json_mode=True),
    dict(temperature=0.9, top_p=0.9, seed=4321),
    dict(temperature=0.0, json_mode=True),
    dict(temperature=0.0, guided_choice=GRAMMAR_CHOICES),
    dict(temperature=0.0, guided_regex=GRAMMAR_REGEX),
)
GRAMMAR_SEEDED = (1, 2)
GRAMMAR_B = 8  # rows of the grammar and seeded-noise checks and timings: max_batch_size


def grammar_vocab(seed: int = 0, vocab: int = LLAMA3_VOCAB) -> list:
    """Token bytes of a ``vocab``-entry vocabulary made from a seed: ids
    3-258 the single bytes, the rest below Llama 3's specials printable
    ASCII strings of 2 to 8 bytes; ids 0-2 and the specials (EOS among
    them) None."""
    import numpy as np

    rng = np.random.default_rng(seed)
    first = vocab - 256
    lens = rng.integers(2, 9, size=first)
    chars = rng.integers(0x20, 0x7F, size=(first, 8)).astype(np.uint8)
    toks: list = [None] * vocab
    for i in range(259, first):
        toks[i] = chars[i, :lens[i]].tobytes()
    for b in range(256):
        toks[3 + b] = bytes([b])
    return toks


def _replays(tables, ids, eos) -> bool:
    """Every token of ``ids`` up to an EOS is one the tables allow where
    it was sampled (request-relative states from the initial one)."""
    from dynamo_tpu_torch.engine.grammar import INIT_STATE

    s, d, st = INIT_STATE, 0, 0
    for t in ids:
        if t in eos:
            return True
        if not tables.valid_mask(s, d, st)[t]:
            return False
        s, d, st = tables.advance(s, d, st, t)
    return True


def grammar_ops(torch, grammar, toks, card: str) -> dict:
    """The device half of constrained decoding and the seeded noise on the
    card against the CPU, then their times.

    ``grammar_mask`` / ``grammar_advance`` over a composite of the JSON
    grammar, a choice set and a regex at 128,256 tokens: four rounds of 8
    rows at states reached by random walks on the host tables (one row
    unconstrained), masked logits and advanced states equal to the CPU's
    exactly.  ``seeded_uniform`` on 512 random (seed, step, token)
    triples: bit-equal to the CPU's, ``seeded_gumbel`` within 2 f32 ulps.
    Then each op at B = 8 as a CUDA graph (the card's time) and eagerly,
    its kernel launches per call, and its bound."""
    import numpy as np

    from dynamo_tpu_torch.engine.grammar import (
        INIT_STATE, compile_choice_vocab, compile_regex_vocab, compose_tables, device_tables,
        grammar_advance, grammar_mask)
    from dynamo_tpu_torch.engine.sampling import K_MAX, seeded_gumbel, seeded_uniform

    eos = eos_ids()
    parts = [grammar.tables, compile_choice_vocab(toks, GRAMMAR_CHOICES, eos),
             compile_regex_vocab(toks, GRAMMAR_REGEX, eos)]
    comp, offs = compose_tables(parts)
    v, b = LLAMA3_VOCAB, GRAMMAR_B
    t0 = time.perf_counter()
    gt = device_tables(comp, v, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    gt_cpu = device_tables(comp, v, "cpu")
    rng = np.random.default_rng(0)

    def walk():
        """A random part's initial state, then up to 24 random valid tokens
        (a third of them opening a container where one may open)."""
        part = int(rng.integers(0, 3))
        s, d, st = INIT_STATE if part == 0 else 1 + offs[part], 0, 0
        for _ in range(int(rng.integers(0, 25))):
            ok = np.flatnonzero(comp.valid_mask(s, d, st))
            ok = ok[~np.isin(ok, eos)]
            push = ok[comp.npush[s, ok] > 0]
            if push.size and rng.random() < 0.3:
                ok = push
            if not ok.size:
                break
            s, d, st = comp.advance(s, d, st, int(rng.choice(ok)))
        return s, d, st

    depths = []
    for rnd in range(4):
        state, depth, stack = (np.asarray(x, np.int32) for x in zip(*(walk() for _ in range(b))))
        depths += depth.tolist()
        jrows = np.arange(b) != rnd  # one row unconstrained
        logits = rng.normal(size=(b, v)).astype(np.float32)
        cpu = [torch.from_numpy(a) for a in (logits, jrows, state, depth, stack)]
        dev = [a.cuda() for a in cpu]
        masked_cpu = grammar_mask(cpu[0], gt_cpu, *cpu[1:])
        masked = grammar_mask(dev[0], gt, *dev[1:])
        check(torch.equal(masked.cpu(), masked_cpu),
              f"grammar_mask on the card differs from the CPU's (round {rnd})")
        picks = np.zeros(b, np.int32)
        for i in range(b):
            ok = np.flatnonzero(masked_cpu[i].numpy() > -1e29)
            picks[i] = rng.choice(ok) if ok.size else eos[0]
        adv_cpu = grammar_advance(gt_cpu, *cpu[1:], torch.from_numpy(picks))
        adv = grammar_advance(gt, *dev[1:], torch.from_numpy(picks).cuda())
        check(all(torch.equal(a.cpu(), r) for a, r in zip(adv, adv_cpu)),
              f"grammar_advance on the card differs from the CPU's (round {rnd})")
    seeds = torch.from_numpy(rng.integers(0, 2 ** 31, size=b).astype(np.int32))
    steps = torch.from_numpy(rng.integers(0, 1 << 17, size=b).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, v, size=(b, K_MAX)).astype(np.int64))
    u_cpu, g_cpu = seeded_uniform(seeds, steps, ids), seeded_gumbel(seeds, steps, ids)
    u = seeded_uniform(seeds.cuda(), steps.cuda(), ids.cuda()).cpu()
    g = seeded_gumbel(seeds.cuda(), steps.cuda(), ids.cuda()).cpu()
    check(torch.equal(u.view(torch.int32), u_cpu.view(torch.int32)),
          "seeded uniforms on the card are not bit-equal to the CPU's")
    ulps = ((g - g_cpu).abs() / torch.finfo(torch.float32).eps / g_cpu.abs().clamp_min(1.0)).max()
    check(float(ulps) <= 2.0, f"seeded Gumbel noise on the card is {float(ulps):.2f} ulps off")

    # times at B = 8 on the last round's operands
    from torch.profiler import ProfilerActivity, profile

    sampled = torch.from_numpy(picks).cuda()
    sd, sp, cid = seeds.cuda(), steps.cuda(), ids.cuda()
    calls = {"grammar_mask": lambda: grammar_mask(dev[0], gt, *dev[1:]),
             "grammar_advance": lambda: grammar_advance(gt, *dev[1:], sampled),
             "seeded_gumbel": lambda: seeded_gumbel(sd, sp, cid)}
    # bytes each op must move: the four [S, V] table rows at each row's
    # state (int16 + 3 int8) and the f32 logits read and written; the
    # advance's five table entries and three int32 states in and out a
    # row; the noise's int32 seeds and steps and int64 ids in, f32 out.
    # The noise's operations are 32-bit integer and f32 ALU work (about 290
    # a value: three threefry blocks of 20 rounds and their key schedule),
    # counted against the f32 rate outside the tensor cores.
    work = {"grammar_mask": (0.0, b * v * (2 + 3 + 4 + 4) + v),
            "grammar_advance": (0.0, b * (2 + 4 + 4 * 4 + 3 * 4)),
            "seeded_gumbel": (290.0 * b * K_MAX, b * 8 + b * K_MAX * (8 + 4))}
    out = {}
    for name, fn in calls.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n_launch = sum(e.count for e in prof.key_averages()
                       if (getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0.0)) > 0)
        ops, nbytes = work[name]
        t_ops, t_bytes = ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        out[name] = dict(graph_ms=graph_time_ms([fn], 200), eager_ms=cuda_time_ms(lambda i: fn(), 200),
                         launches_per_call=n_launch, bound_ms=1e3 * max(t_ops, t_bytes),
                         bound_by="operations" if t_ops > t_bytes else "bytes")
    log(f"grammar ops: mask/advance on the card equal the CPU's exactly over 4 x {b} rows "
        f"at reachable states (depths up to {max(depths)}) of a {comp.n_states}-state composite "
        f"(json {parts[0].n_states}, choice {parts[1].n_states}, regex {parts[2].n_states}; "
        f"{gt.nbytes / 1e6:.1f} MB on the card, uploaded in {upload_s:.3f} s); seeded uniforms "
        f"bit-equal on {b * K_MAX} triples, Gumbel within {float(ulps):.2f} ulps; per call at "
        f"B = {b}, V = {v}: " + "; ".join(
            f"{k} graph {r['graph_ms']:.4f} ms, eager {r['eager_ms']:.4f} ms, "
            f"{r['launches_per_call']} launches, bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
            for k, r in out.items()) + f" ({card})")
    return dict(ops=out, composite_mb=gt.nbytes / 1e6, composite_states=comp.n_states,
                upload_s=upload_s)


@contextlib.contextmanager
def counted_grammar_calls():
    """Count the engine's calls of ``grammar_mask`` and ``grammar_advance``
    in a serving run, by wrapping the engine module's references to them
    (the functions themselves are untouched)."""
    from dynamo_tpu_torch.engine import core as engine_core

    counts = {"grammar_mask": 0, "grammar_advance": 0}
    real = {name: getattr(engine_core, name) for name in counts}

    def counting(name):
        def call(*args):
            counts[name] += 1
            return real[name](*args)
        return call

    for name in counts:
        setattr(engine_core, name, counting(name))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(engine_core, name, fn)


def grammar_serve_run(torch, model, grammar, toks, config: dict, card: str, label: str,
                      traffic=GRAMMAR_TRAFFIC, reqs=None) -> dict:
    """The constrained mix (``traffic``, one row per prompt of ``reqs``:
    the six serving prompts unless named) once through ``AsyncLLMEngine``
    under ``config``, every kernel counter zeroed just before and read just
    after; each row held to its grammar: a JSON row that ended on EOS
    parses, one cut at max_tokens replays through the JSON tables; the
    choice row's text is a choice; the regex row replays through its tables
    (and, ended, fullmatches)."""
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.grammar import compile_regex_vocab
    from dynamo_tpu_torch.llm.protocols import FinishReason

    eos = eos_ids()
    core = EngineCore(model, EngineConfig(**config), eos_token_ids=eos, device="cuda",
                      grammar=grammar)
    engine = AsyncLLMEngine(core).start()
    reqs = reqs or prompts()
    try:
        asyncio.run(_serve(engine, [list(range(1, 40))], tag="warm-up"))  # unconstrained
        wrappers = _kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        with counted_grammar_calls() as calls:
            t0 = time.perf_counter()
            results = asyncio.run(_serve(engine, reqs, list(traffic)))
            wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        metrics = core.metrics()
    finally:
        engine.shutdown()
    streams = [[t for o in outs for t in o.token_ids] for _, _, outs in results]
    reasons = [outs[-1].finish_reason for _, _, outs in results]
    regex_tables = compile_regex_vocab(toks, GRAMMAR_REGEX, eos_ids=eos)
    texts = []
    for i, (opts, ids, reason) in enumerate(zip(traffic, streams, reasons)):
        text = b"".join(toks[t] for t in ids if toks[t] is not None)
        texts.append(text)
        check(reason in (FinishReason.EOS, FinishReason.LENGTH) and 0 < len(ids) <= MAX_TOKENS,
              f"grammar {label} row {i}: finish {reason} after {len(ids)} tokens")
        if opts.get("guided_regex"):
            check(_replays(regex_tables, ids, eos) and (
                reason is FinishReason.LENGTH or re.fullmatch(GRAMMAR_REGEX, text.decode())),
                f"grammar {label} row {i}: {text!r} is outside {GRAMMAR_REGEX}")
        elif opts.get("json_mode"):
            if reason is FinishReason.EOS:
                try:  # the JSON grammar does not check UTF-8 inside strings
                    json.loads(text.decode("utf-8", errors="replace"))
                except ValueError as e:
                    raise SmokeFailure(f"grammar {label} row {i}: {text!r} is not JSON: {e}")
            check(_replays(grammar.tables, ids, eos),
                  f"grammar {label} row {i}: {text!r} leaves the JSON grammar")
        elif opts.get("guided_choice"):
            check(reason is FinishReason.EOS and text.decode() in GRAMMAR_CHOICES,
                  f"grammar {label} row {i}: {text!r} is not one of {GRAMMAR_CHOICES}")
    ttfts = [r[0] for r in results]
    decode_tokens = sum(len(x) - 1 for x in streams)
    decode_window = wall - min(ttfts)
    kinds = [("json" if o.get("json_mode") else "choice" if o.get("guided_choice") else
              "regex" if o.get("guided_regex") else "free") + (" seeded" if "seed" in o else "")
             for o in traffic]
    log(f"grammar serving {label}: {len(results)} requests ({', '.join(kinds)}), wall {wall:.3f} s, TTFT min/median/max {min(ttfts):.3f}/"
        f"{sorted(ttfts)[len(ttfts) // 2]:.3f}/{max(ttfts):.3f} s, decode "
        f"{decode_tokens / decode_window:.1f} tok/s over {decode_window:.3f} s, host gap "
        f"{metrics['host_gap_ms_per_turn']:.2f} ms/turn, device reads {metrics['device_gets_total']}, "
        f"finish {[r.value for r in reasons]}, texts {[t[:40] for t in texts]}, grammar calls "
        f"{calls}, launches {launches} ({card})")
    return dict(streams=streams, launches=launches, metrics=metrics, ttfts=ttfts, wall=wall,
                decode_tok_s=decode_tokens / decode_window, calls=dict(calls))


def grammar_phase(torch, model, plain: dict, card: str) -> None:
    """Constrained decoding and per-request seeds on the serving phase's
    bf16 Llama-3-8B: a 128,256-token vocabulary from a seed and its JSON
    tables; the device ops against the CPU and their times
    (:func:`grammar_ops`); the constrained mix on the default path (B1, B2)
    and on the token-budget path (B3, B1); then the two seeded requests
    again, with one decode turn a dispatch and other companions, for the
    same streams.  Its serving line stands beside the unconstrained
    default run's (``plain``)."""
    from dynamo_tpu_torch.engine.grammar import JsonGrammar

    t_phase = time.perf_counter()
    toks = grammar_vocab()
    t0 = time.perf_counter()
    grammar = JsonGrammar.from_token_bytes(toks, eos_ids=eos_ids())
    compile_s = time.perf_counter() - t0
    log(f"grammar: JSON tables, {grammar.tables.n_states} states x {grammar.tables.vocab_size} "
        f"tokens, compiled in {compile_s:.2f} s on the host ({card})")
    ops = grammar_ops(torch, grammar, toks, card)
    torch.cuda.empty_cache()
    default = grammar_serve_run(torch, model, grammar, toks, DEFAULT_PATH, card, "default path")
    check(default["launches"]["decode"] > 0 and default["launches"]["prefill"] > 0,
          f"grammar default path: launches {default['launches']}, need decode and prefill > 0")
    torch.cuda.empty_cache()
    budget = grammar_serve_run(torch, model, grammar, toks, BUDGET_PATH, card, "token-budget path")
    check(budget["launches"]["ragged"] > 0 and budget["launches"]["decode"] > 0,
          f"grammar token-budget path: launches {budget['launches']}, need ragged and decode > 0")
    torch.cuda.empty_cache()
    # the seeded requests again: one decode turn a dispatch, and two
    # unconstrained greedy companions in place of the other four rows
    base = prompts()
    others = prompts(seed=3)[:2]
    again = grammar_serve_run(
        torch, model, grammar, toks, dict(DEFAULT_PATH, decode_steps=1), card,
        "seeded again, decode_steps=1, other companions",
        traffic=[GRAMMAR_TRAFFIC[i] for i in GRAMMAR_SEEDED] + [dict(temperature=0.0)] * 2,
        reqs=[base[i] for i in GRAMMAR_SEEDED] + others)
    for j, i in enumerate(GRAMMAR_SEEDED):
        check(again["streams"][j] == default["streams"][i],
              f"grammar: seeded request {i} gave {again['streams'][j]} with decode_steps=1 and "
              f"other companions, {default['streams'][i]} in the constrained run")
    torch.cuda.empty_cache()
    pm = plain["metrics"]
    log(f"grammar beside plain (default path, the same six prompts): constrained wall "
        f"{default['wall']:.3f} s, TTFT median/max {sorted(default['ttfts'])[3]:.3f}/"
        f"{max(default['ttfts']):.3f} s, decode {default['decode_tok_s']:.1f} tok/s, host gap "
        f"{default['metrics']['host_gap_ms_per_turn']:.2f} ms/turn; unconstrained TTFT "
        f"median/max {sorted(plain['ttfts'])[3]:.3f}/{max(plain['ttfts']):.3f} s, decode "
        f"{plain['decode_tok_s']:.1f} tok/s, host gap {pm['host_gap_ms_per_turn']:.2f} ms/turn; "
        f"tok/s share {default['decode_tok_s'] / plain['decode_tok_s']:.3f} ({card})")
    log(json.dumps({"grammar": dict(
        ops["ops"], composite_mb=ops["composite_mb"], composite_states=ops["composite_states"],
        upload_s=ops["upload_s"], json_compile_s=compile_s,
        launches={k: default["calls"][k] for k in ("grammar_mask", "grammar_advance")},
        constrained=dict(wall=default["wall"], ttft_median=sorted(default["ttfts"])[3],
                         ttft_max=max(default["ttfts"]), decode_tok_s=default["decode_tok_s"],
                         host_gap_ms=default["metrics"]["host_gap_ms_per_turn"]),
        plain=dict(ttft_median=sorted(plain["ttfts"])[3], ttft_max=max(plain["ttfts"]),
                   decode_tok_s=plain["decode_tok_s"], host_gap_ms=pm["host_gap_ms_per_turn"]),
        card=card)}))
    log(f"phase grammar (inside the bf16 serving phase): {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------- DeepSeek
def deepseek_v2_lite(num_layers: int = 27):
    """DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite config.json) at full
    width: no q-LoRA, kv_lora 512, nope 128, rope 64, v 128, 16 heads, 64
    routed experts top 6 of width 1,408 and 2 shared, greedy routing, the
    first layer dense (FFN 10,944).  Its YaRN ``rope_scaling`` is dropped:
    neither package implements it (``DeepseekConfig.from_hf`` refuses it)."""
    from dynamo_tpu_torch.models.deepseek import DeepseekConfig

    return DeepseekConfig(vocab_size=102400, hidden_size=2048, num_layers=num_layers, num_heads=16,
                          qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                          kv_lora_rank=512, q_lora_rank=None, intermediate_size=10944,
                          moe_intermediate_size=1408, n_routed_experts=64, num_experts_per_tok=6,
                          n_shared_experts=2, routed_scaling_factor=1.0, topk_method="greedy",
                          first_k_dense_replace=1, rms_norm_eps=1e-6, rope_theta=10000.0,
                          max_position_embeddings=163840, dtype="bfloat16")


def deepseek_v2_moe_layer():
    """One DeepSeek-V2 MoE layer (deepseek-ai/DeepSeek-V2 config.json) as a
    1-layer model: hidden 5,120, q-LoRA 1,536, 128 heads, 160 routed experts
    top 6 of width 1,536 and 2 shared, group-limited routing (8 groups, top
    3), routed scaling 16; 7.55 GB of experts.  The model (236 B) does not
    fit one card; ``rope_scaling`` dropped as for V2-Lite."""
    from dynamo_tpu_torch.models.deepseek import DeepseekConfig

    return DeepseekConfig(vocab_size=102400, hidden_size=5120, num_layers=1, num_heads=128,
                          qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                          kv_lora_rank=512, q_lora_rank=1536, intermediate_size=12288,
                          moe_intermediate_size=1536, n_routed_experts=160, num_experts_per_tok=6,
                          n_shared_experts=2, routed_scaling_factor=16.0,
                          topk_method="group_limited_greedy", n_group=8, topk_group=3,
                          first_k_dense_replace=0, rms_norm_eps=1e-6, rope_theta=10000.0,
                          max_position_embeddings=163840, dtype="bfloat16")


def _deepseek_model(torch, cfg, seed: int = 0):
    """A DeepseekModel of ``cfg`` on the card, random weights from a seeded
    generator (``deepseek_init_params``, one layer's draw at a time)."""
    from dynamo_tpu_torch.models.convert import deepseek_init_params
    from dynamo_tpu_torch.models.deepseek import DeepseekModel

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return DeepseekModel.from_state(cfg, deepseek_init_params(cfg, gen, device="cuda"))


def deepseek_serving_phase(torch, card: str) -> tuple[dict, dict]:
    """DeepSeek-V2-Lite at full width and depth behind ``AsyncLLMEngine``,
    the six requests on the default path: a bf16 cache (profiled), then an
    int8 cache in 32-token blocks.  Each run launches E1 and nothing else:
    no B kernel (MLA attention is the plain op) and no E2 (no int8
    weights).  Every Qwen3 model is gone before: 31.4 GB of weights."""
    t0 = time.perf_counter()
    cfg = deepseek_v2_lite()
    model = _deepseek_model(torch, cfg)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"serving: DeepSeek-V2-Lite, {cfg.num_layers} layers, {weights / 1e9:.2f} GB of random "
        f"weights in {time.perf_counter() - t0:.1f} s")
    none = [k for k in _kernel_wrappers() if k != "moe"]
    runs = []
    for config, label, profile in (
            (DEFAULT_PATH, "DeepSeek-V2-Lite bf16 cache, default path", True),
            (INT8_DEFAULT_PATH, "DeepSeek-V2-Lite int8 cache (Bs 32), default path", False)):
        run = serve_run(torch, model, config, card, label, profile=profile)
        check(run["launches"]["moe"] > 0 and not any(run["launches"][k] for k in none),
              f"{label}: launches {run['launches']}, need moe > 0, {none} = 0")
        runs.append(run)
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(runs[0]["streams"], runs[1]["streams"]))
    log(f"serving: {same} of {len(runs[0]['streams'])} DeepSeek-V2-Lite int8-cache streams equal the "
        f"bf16 cache's (informational: the cache rounds to int8) ({card})")
    del model
    torch.cuda.empty_cache()
    return runs[0], runs[1]


def deepseek_parity_phase(torch, card: str) -> None:
    """Phase 5's default-path check (a 300-token prompt over a 128-token
    cached prefix, then 8 decode steps) on the card (bf16 weights) and on
    the CPU (f32, the same weights), with a bf16 cache (Bs 16) and an int8
    one (Bs 32): a 2-layer model at DeepSeek-V2-Lite width (the dense layer
    and one MoE layer), and one DeepSeek-V2 MoE layer.  The CPU routes as
    the card routed (``moe_routes``)."""
    import numpy as np

    from dynamo_tpu_torch.models.deepseek import DeepseekModel

    for make_cfg, width in ((lambda: deepseek_v2_lite(2), "2-layer DeepSeek-V2-Lite width"),
                            (deepseek_v2_moe_layer, "1 DeepSeek-V2 MoE layer")):
        cfg = make_cfg()
        gpu = _deepseek_model(torch, cfg)
        cpu_cfg = make_cfg()
        cpu_cfg.dtype = "float32"
        cpu = DeepseekModel.from_state(cpu_cfg, {k: v.cpu().float() for k, v in gpu.state_dict().items()})
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
        steps = rng.integers(0, cfg.vocab_size, 8).tolist()
        for bs, kv, tag in ((BS, None, "bf16 cache"), (BS_Q8, "int8", "int8 cache")):
            _hold_card_to_cpu(
                torch, f"default path: {width}, {tag}, 300-token prompt over a 128-token prefix "
                "+ 8 decode steps",
                lambda: _forward_logits(torch, gpu, torch.device("cuda"), prompt, steps, 128, bs, kv),
                lambda: _forward_logits(torch, cpu, torch.device("cpu"), prompt, steps, 128, bs, kv),
                card)
        del gpu, cpu
        torch.cuda.empty_cache()


def mla_timing(torch, card: str) -> list[dict]:
    """One DeepSeek-V2-Lite layer's latent attention, the plain op the model
    runs (``DeepseekModel._paged`` over a bf16 cache of 576-wide latent
    rows, one KV head, G = 16), as a CUDA graph: decode at B1's row shape
    (B = 8, S = 1, ``cuda_timing.DECODE_LENS``, 3,865 context tokens; the
    graph walks 27 layers' caches, past the L2, as a decode step does) and
    prefill at B2's (S = 1,504 from 0 over a 2,048-slot table).  Beside
    each: SDPA on the same latent K/V (laid out dense beforehand, V the
    whole row as the plain op reads it) timed the same way, held to the
    plain op, and the bound: one latent row per context token read once,
    q and the 512-wide output, against 2 H (576 + 512) operations per
    visible (query, key) pair.  Returns the ``mla`` line's rows."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.models.deepseek import DeepseekModel

    cfg = deepseek_v2_lite()
    layers = cfg.num_layers
    model = DeepseekModel(cfg, device="meta")  # _paged reads only the config
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    # the latent row (576) of one KV head, the part that is attended (512), the heads (16)
    m, d, latent, h = 2048 // BS, cfg.head_dim, cfg.kv_lora_rank, cfg.num_heads
    rows = []

    def work(pairs, q_rows, ctx_rows, what):
        nbytes = 2 * ctx_rows * d + 2 * q_rows * h * (d + latent)
        return dict(name=what, **_bound(2 * h * (d + latent) * pairs, nbytes))

    # decode
    lens = list(DECODE_LENS)
    b = len(lens)
    n_blocks = sum(-(-n // BS) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen)
    cache = torch.randn((layers, n_blocks, 1, BS, d), generator=gen, device="cuda").to(torch.bfloat16)
    cache = cache.expand(-1, -1, 2, -1, -1).contiguous()  # the latent row in both planes, as written
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    seq_lens = _ints(torch, lens)
    pos = (seq_lens - 1).clamp_min(0)[:, None].contiguous()
    calls = [lambda li=li: model._paged(q, cache, li, bt, seq_lens, pos) for li in range(layers)]
    ms = median_ms(lambda: graph_time_ms(calls, 10) / layers)
    eager = cuda_time_ms(lambda i: calls[i % layers](), 27)
    live = [i for i, n in enumerate(lens) if n]

    def dense_kv(layer):
        kd = torch.zeros((b, 1, max(lens), d), dtype=torch.bfloat16, device="cuda")
        for i, n in enumerate(lens):
            kd[i, 0, :n] = cache[layer, bt[i, :-(-n // BS)].long(), 0].reshape(-1, d)[:n]
        return kd, kd

    lib_ms, lib_eager = _sdpa_decode_ms(torch, q, lens, dense_kv, layers)
    kd, _ = dense_kv(LAYER)
    mask = (torch.arange(max(lens), device="cuda")[None, :] < seq_lens[:, None])[:, None, None, :]
    sdpa = F.scaled_dot_product_attention(q.transpose(1, 2), kd, kd, attn_mask=mask, enable_gqa=True,
                                          scale=model.sm_scale).transpose(1, 2)
    err = compare(torch, "mla decode: the plain op vs SDPA", model._paged(q, cache, LAYER, bt, seq_lens, pos)[live],
                  sdpa[live])
    row = work(sum(lens), b, sum(lens), "mla_decode")
    rows.append(dict(row, shape=f"B={b} S=1 ctx={sum(lens)}", ms=ms, library_ms=lib_ms, max_abs_err=err))
    log(f"time mla decode B={b} S=1 ctx={sum(lens)} (one DeepSeek-V2-Lite layer, latent {d}, G={h}): "
        f"plain op {ms:.4f} ms (CUDA graph; eager {eager:.4f}), sdpa {lib_ms:.4f} ms (CUDA graph; "
        f"eager {lib_eager:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain op vs "
        f"sdpa max abs err {err:.3g} ({card})")
    del cache

    # prefill from 0
    fresh = max(PROMPT_LENS)
    s = -(-fresh // BS) * BS
    bt1 = _tables(torch, [fresh], m, -(-fresh // BS) + 8, gen)
    cache1 = torch.randn((1, int(bt1.max()) + 1, 1, BS, d), generator=gen, device="cuda").to(torch.bfloat16)
    cache1 = cache1.expand(-1, -1, 2, -1, -1).contiguous()
    q1 = torch.randn((1, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    lens1 = _ints(torch, [fresh])
    pos1 = torch.zeros((1, s), dtype=torch.int32, device="cuda")
    pos1[0, :fresh] = torch.arange(fresh, dtype=torch.int32, device="cuda")
    call = lambda: model._paged(q1, cache1, 0, bt1, lens1, pos1)  # noqa: E731
    ms = median_ms(lambda: graph_time_ms([call], 5))
    eager = cuda_time_ms(lambda i: call(), 5)
    k1 = cache1[0, bt1[0, :-(-fresh // BS)].long(), 0].reshape(-1, d)[:fresh][None, None]
    qs = q1[:, :fresh].transpose(1, 2).contiguous()

    def sdpa1():
        return F.scaled_dot_product_attention(qs, k1, k1, is_causal=True, enable_gqa=True,
                                              scale=model.sm_scale)

    lib_ms, lib_eager = _sdpa_ms(sdpa1)
    err = compare(torch, "mla prefill: the plain op vs SDPA", call()[:, :fresh], sdpa1().transpose(1, 2))
    row = work(fresh * (fresh + 1) // 2, fresh, fresh, "mla_prefill")
    rows.append(dict(row, shape=f"B=1 S={s} fresh={fresh} start=0", ms=ms, library_ms=lib_ms,
                     max_abs_err=err))
    log(f"time mla prefill B=1 S={s} fresh={fresh} start=0 (one DeepSeek-V2-Lite layer): plain op "
        f"{ms:.4f} ms (CUDA graph; eager {eager:.4f}), sdpa {lib_ms:.4f} ms (CUDA graph; eager "
        f"{lib_eager:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain op vs sdpa max "
        f"abs err {err:.3g} ({card})")
    del cache1
    torch.cuda.empty_cache()
    return rows


# The DeepSeek checkpoint: DeepSeek-V2-Lite's width and tensor names, cut
# to 2 layers (the dense one and one MoE layer: 216 tensors, 2.2 GB)
DEEPSEEK_ATTN_NAMES = {
    "attn_norm": ("input_layernorm.weight", False),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "kv_a": ("self_attn.kv_a_proj_with_mqa.weight", True),
    "kv_a_norm": ("self_attn.kv_a_layernorm.weight", False),
    "kv_b": ("self_attn.kv_b_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
}
DEEPSEEK_FRONT_NAMES = {
    "embed": ("model.embed_tokens.weight", False), "final_norm": ("model.norm.weight", False),
    "lm_head": ("lm_head.weight", True),
    **{f"{g}.{k}": ("model.layers.{i}." + hf, t) for g in ("dense_layers", "moe_layers")
       for k, (hf, t) in DEEPSEEK_ATTN_NAMES.items()},
    "dense_layers.w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "dense_layers.w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "dense_layers.w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
    "moe_layers.router": ("model.layers.{i}.mlp.gate.weight", True),
    "moe_layers.w_gate": ("model.layers.{i}.mlp.experts.{e}.gate_proj.weight", True),
    "moe_layers.w_up": ("model.layers.{i}.mlp.experts.{e}.up_proj.weight", True),
    "moe_layers.w_down": ("model.layers.{i}.mlp.experts.{e}.down_proj.weight", True),
    "moe_layers.shared_gate": ("model.layers.{i}.mlp.shared_experts.gate_proj.weight", True),
    "moe_layers.shared_up": ("model.layers.{i}.mlp.shared_experts.up_proj.weight", True),
    "moe_layers.shared_down": ("model.layers.{i}.mlp.shared_experts.down_proj.weight", True),
}
QUANTIZE_REFUSED = "--quantize int8 is not wired for this model family yet"  # the JAX CLI's words


def write_deepseek_checkpoint(torch, d: Path) -> float:
    """The 2-layer DeepSeek checkpoint: config.json as DeepSeek-V2-Lite's
    with 2 layers and no ``rope_scaling``, and random bf16 weights from a
    seeded generator (matrices N(0, 1/fan_in), norms 1 + N(0, 0.1^2)) under
    the real checkpoint's names, in two safetensors shards with an index.
    Returns the bytes written."""
    from safetensors.torch import save_file

    cfg = deepseek_v2_lite(FRONT_LAYERS)
    dm, h, e = cfg.hidden_size, cfg.num_heads, cfg.n_routed_experts
    r, rope, fm = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.moe_intermediate_size
    sp = specials(cfg.vocab_size)
    (d / "config.json").write_text(json.dumps({
        "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
        "vocab_size": cfg.vocab_size, "hidden_size": dm, "intermediate_size": cfg.intermediate_size,
        "moe_intermediate_size": fm, "num_hidden_layers": FRONT_LAYERS, "num_attention_heads": h,
        "num_key_value_heads": h, "n_routed_experts": e, "num_experts_per_tok": cfg.num_experts_per_tok,
        "n_shared_experts": cfg.n_shared_experts, "routed_scaling_factor": cfg.routed_scaling_factor,
        "kv_lora_rank": r, "q_lora_rank": None, "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": rope, "v_head_dim": cfg.v_head_dim, "topk_method": "greedy",
        "n_group": 1, "topk_group": 1, "norm_topk_prob": False, "scoring_func": "softmax",
        "first_k_dense_replace": 1, "moe_layer_freq": 1, "rope_theta": cfg.rope_theta,
        "rope_scaling": None, "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "hidden_act": "silu", "attention_bias": False,
        "tie_word_embeddings": False, "bos_token_id": sp["<|begin_of_text|>"],
        "eos_token_id": eos_ids(cfg.vocab_size), "torch_dtype": "bfloat16"}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)

    def matrix(rows, cols):  # HF layout [out, in]
        w = torch.randn((rows, cols), generator=gen, device="cuda", dtype=torch.float32)
        return w.div_(math.sqrt(cols)).to(torch.bfloat16).cpu()

    def norm(n=dm):
        w = 1 + 0.1 * torch.randn((n,), generator=gen, device="cuda", dtype=torch.float32)
        return w.to(torch.bfloat16).cpu()

    def layer(i):
        p = f"model.layers.{i}."
        out = {p + "input_layernorm.weight": norm(), p + "post_attention_layernorm.weight": norm(),
               p + "self_attn.q_proj.weight": matrix(h * cfg.qk_head_dim, dm),
               p + "self_attn.kv_a_proj_with_mqa.weight": matrix(r + rope, dm),
               p + "self_attn.kv_a_layernorm.weight": norm(r),
               p + "self_attn.kv_b_proj.weight": matrix(h * (cfg.qk_nope_head_dim + cfg.v_head_dim), r),
               p + "self_attn.o_proj.weight": matrix(dm, h * cfg.v_head_dim)}
        if i < cfg.first_k_dense_replace:
            f = cfg.intermediate_size
            out.update({p + "mlp.gate_proj.weight": matrix(f, dm), p + "mlp.up_proj.weight": matrix(f, dm),
                        p + "mlp.down_proj.weight": matrix(dm, f)})
            return out
        fs = fm * cfg.n_shared_experts
        out[p + "mlp.gate.weight"] = matrix(e, dm)
        for j in range(e):
            q = f"{p}mlp.experts.{j}."
            out.update({q + "gate_proj.weight": matrix(fm, dm), q + "up_proj.weight": matrix(fm, dm),
                        q + "down_proj.weight": matrix(dm, fm)})
        out.update({p + "mlp.shared_experts.gate_proj.weight": matrix(fs, dm),
                    p + "mlp.shared_experts.up_proj.weight": matrix(fs, dm),
                    p + "mlp.shared_experts.down_proj.weight": matrix(dm, fs)})
        return out

    shards = [{"model.embed_tokens.weight": matrix(cfg.vocab_size, dm), **layer(0)},
              {**layer(1), "model.norm.weight": norm(), "lm_head.weight": matrix(cfg.vocab_size, dm)}]
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, str(d / name), metadata={"format": "pt"})
        weight_map.update({t: name for t in shard})
        total += sum(t.numel() * t.element_size() for t in shard.values())
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def deepseek_front_door_phase(torch, card: str) -> None:
    """The front door on the 2-layer DeepSeek checkpoint: the CLI server
    (bf16 cache), ``--quantize int8`` refused with the JAX CLI's message,
    then ``build_local_engine`` in this process with a bf16 cache and with
    an int8 one (Bs 32), each launching E1 and nothing else, the loaded
    tensors held to the shards and the answers to a fresh engine's."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(FRONT_DIR, ignore_errors=True)
    cfg = deepseek_v2_lite(FRONT_LAYERS)
    write_tokenizer(FRONT_DIR, cfg.vocab_size)
    nbytes = write_deepseek_checkpoint(torch, FRONT_DIR)
    n_files = len(json.loads((FRONT_DIR / "model.safetensors.index.json").read_text())["weight_map"])
    log(f"front door: wrote a {FRONT_LAYERS}-layer DeepSeek-V2-Lite-width checkpoint, "
        f"{nbytes / 1e9:.2f} GB, {n_files} tensors in two shards, in {time.perf_counter() - t0:.1f} s")
    cli_phase(card, (), "DeepSeek-V2-Lite")
    refused = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch", "run", "in=text:w5 w6", "out=gpu", "--model-path",
         str(FRONT_DIR), "--quantize", "int8"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=300)
    check(refused.returncode != 0 and QUANTIZE_REFUSED in refused.stderr and not refused.stdout,
          f"front door DeepSeek: --quantize int8 exited {refused.returncode}, stderr "
          f"{refused.stderr[-1000:]!r}")
    log(f"front door CLI: `--quantize int8` on the DeepSeek checkpoint exits {refused.returncode} with "
        f"{QUANTIZE_REFUSED!r} ({card})")
    none = [k for k in _kernel_wrappers() if k != "moe"]
    first = {"moe_layers": cfg.first_k_dense_replace}
    for flags, label in ((FRONT_FLAGS, "DeepSeek bf16 cache"),
                         (FRONT_FLAGS + ["--kv-cache-dtype", "int8", "--block-size", str(BS_Q8)],
                          "DeepSeek int8 cache")):
        front_server(torch, flags, card, label, ["moe"], none, DEEPSEEK_FRONT_NAMES,
                     cfg.n_routed_experts, first)
        torch.cuda.empty_cache()
    log(f"front door DeepSeek: phase wall {time.perf_counter() - t0:.1f} s ({card})")


# --------------------------------------------------------------------- main
def phase_clock():
    """A function that logs, under a phase's name, the seconds since its
    last call and since the clock was made: where the run's time goes."""
    start = last = time.perf_counter()

    def mark(name: str) -> None:
        nonlocal last
        now = time.perf_counter()
        log(f"phase {name}: {now - last:.1f} s (run {now - start:.1f} s)")
        last = now

    return mark


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import shutil

    from dynamo_tpu_torch.ops.kernels import build

    shutil.rmtree(FRONT_DIR, ignore_errors=True)
    mark = phase_clock()
    try:
        card = card_line()
        log(card)
        t0 = time.perf_counter()
        lib_path = build.build_library(verbose=True)
        build.library()
        log(f"build: {time.perf_counter() - t0:.1f} s ({card})")
        mark("build")
        sass_check(torch, lib_path)
        errs = kernel_phase(torch)
        mark("kernel checks")
        times = timing_phase(torch, card)
        times.update(q8_timing_phase(torch, card))
        times.update(matmul_timing(torch, card))
        times.update(verify_timing(torch, card))
        times.update(moe_timing(torch, card))
        mla = mla_timing(torch, card)
        mark("kernel timings")
        write_tokenizer(FRONT_DIR)
        default, budget, mixed, spec = serving_phase(torch, card)
        times["ragged"] = ragged_timing(torch, card, mixed)
        times["ragged_err"] = times["ragged"].pop("err")
        mark("Llama-3-8B bf16 serving")
        q8_default, q8_budget, q8_mixed, q8_spec = serving_phase_q8(torch, card)
        times["ragged_q8"] = ragged_timing(torch, card, q8_mixed, quant=True)
        times["ragged_q8_err"] = times["ragged_q8"].pop("err")
        mark("Llama-3-8B int8 serving")
        parity_phase(torch, card, verify=True)
        parity_phase(torch, card, quant=True)
        mark("Llama-3-8B parity")
        front_door_phase(torch, card)
        mark("Llama-3-8B front door")
        moe_default, moe_budget = moe_serving_phase(torch, card)
        mark("Qwen3-30B-A3B serving")
        parity_phase(torch, card, make_cfg=qwen3_30b_a3b, width="Qwen3-30B-A3B")
        parity_phase(torch, card, quant=True, make_cfg=qwen3_30b_a3b, width="Qwen3-30B-A3B")
        mark("Qwen3-30B-A3B parity")
        moe_front_door_phase(torch, card)
        mark("Qwen3-MoE front door")
        ds_default, ds_q8 = deepseek_serving_phase(torch, card)
        mark("DeepSeek-V2-Lite serving")
        deepseek_parity_phase(torch, card)
        mark("DeepSeek parity")
        deepseek_front_door_phase(torch, card)
        mark("DeepSeek front door")
    except (SmokeFailure, RuntimeError) as e:  # a failed check, build or nvidia-smi
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(FRONT_DIR, ignore_errors=True)
    # launches: each kernel's count over the serving run of the path it
    # carries (decode and prefill: the default path; ragged: the token-budget
    # path; the int8 kernels: the same paths on the int8 model; the grouped
    # expert kernels: Qwen3-30B-A3B's bf16 default and int8 token-budget runs;
    # E1 also DeepSeek-V2-Lite's two default-path runs, bf16 and int8 cache)
    times["moe"]["deepseek_v2_lite"].update(
        launches=ds_default["launches"]["moe"], launches_int8_cache=ds_q8["launches"]["moe"])
    # the verify shape: each decode kernel's readings at S = 5 and 8 and its
    # launches at S = k + 1 over the spec runs; B5's at the verify's M = 40
    spec.update(q8_spec)
    verify_launches = {kernel: {label: r["decode_calls_by_s"].get(f"{kernel} S={r['k'] + 1}", 0)
                                for label, r in spec.items()
                                if r["k"] and label.startswith("int8") == (kernel == "B4a")}
                       for kernel in ("B1", "B4a")}
    kernels = [
        dict(name="paged_decode_attention", route="cuda",
             source="dynamo_tpu_torch/csrc/decode_attention.cu",
             replaces="dynamo_tpu/ops/pallas/decode_attention.py:281",
             launches=default["launches"]["decode"],
             max_abs_err=max(errs["decode"], times["decode_err"]), **times["decode"],
             verify=dict(times["decode_verify"], launches=verify_launches["B1"])),
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
             max_abs_err=max(errs["decode_q8"], times["decode_q8_err"]), **times["decode_q8"],
             verify=dict(times["decode_q8_verify"], launches=verify_launches["B4a"])),
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
             max_abs_err=max(errs["matmul"], times["matmul_err"]), **times["matmul"],
             verify=dict(times["matmul_verify"],
                         launches=spec["int8 ngram k=4"]["launches"]["matmul"])),
        dict(name="grouped_matmul", route="cuda",
             source="dynamo_tpu_torch/csrc/grouped_matmul.cu",
             replaces="dynamo_tpu/models/llama.py:631",
             launches=moe_default["launches"]["moe"],
             max_abs_err=max(errs["moe"], times["moe_err"]), **times["moe"]),
        dict(name="grouped_matmul_q8", route="cuda",
             source="dynamo_tpu_torch/csrc/grouped_matmul.cu",
             replaces="dynamo_tpu/models/llama.py:631",
             launches=moe_budget["launches"]["moe_q8"],
             max_abs_err=max(errs["moe_q8"], times["moe_q8_err"]), **times["moe_q8"]),
    ]
    log(json.dumps({"spec": [{k: v for k, v in r.items() if k != "streams"}
                             for r in spec.values()]}))
    log(json.dumps({"mla": mla}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
