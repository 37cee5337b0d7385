#!/usr/bin/env python3
"""Time the seven kernels (matmul, decode, paged and ragged prefill attention) of checkouts on one card.

    python3 dynamo_tpu_torch/tools/kernel_ab.py --base DIR [--change DIR] [--repeat N] [--only K,...]
    python3 dynamo_tpu_torch/tools/kernel_ab.py --trees ROOT:TAG [ROOT:TAG ...] [--repeat N] [--only K,...]

DIR and ROOT are roots of checkouts (the directory holding
``dynamo_tpu_torch/``); ``--change`` defaults to this checkout.  Each tree
is built and timed in its own process: with ``--base``, in the order base,
change, change, base, so that the card's clocks and neighbours drift alike
over both; with ``--trees``, in the order given (list each tree more than
once and in turns, a b b a, to the same end; throwaway trees of one edit
each bisect a change in one call).  Each metric is read ``--repeat`` times
(default 1) in every run; ``--only`` keeps the named kernels (b1, b2, b3,
b4a, b4b, b4c, b5) and their yardsticks.  Every line names the card and its
power limit.  The shapes are Llama-3-8B's as the serving paths run them:

- B5: one layer's seven projections ([K, N] int8 weights, four layers'
  weights in turn, past the 50 MB L2) at M = 8 (a decode step), 16 and 17
  (the two regimes' edges), 64, 300 and 1504 (the longest prompt's
  prefill), and the tied lm_head [4096,
  128256] at M = 8 with f32 out.  Device time is a CUDA graph of the calls
  replayed (no host launch cost); "eager" is the same calls launched from
  Python, which at M = 8 measures the host as much as the card.
- B2: the 1500-token prompt (S = 1504, start 0) and a 700-token prompt over
  a 256-token cached prefix, one layer (H = 32, Hk = 8, D = 128, Bs = 16).
- B1 and B4a: one layer of a decode step at the default paths' serving
  shape (``DECODE_LENS``: B = 8 slots, six requests mid-generation and two
  empty, 3,865 context tokens, S = 1; bf16 with Bs = 16, int8 with Bs = 32
  in a 2048-token table), as a CUDA graph (the card's time) and eagerly
  (B4a is shorter than a launch from Python, so eager timing reads the
  host); B4a also at 8 rows of 2,000 tokens and 2 rows of 300 (graph).
  B4b: the int8 default path's prefix hit (start 256, 700 fresh, S = 704,
  Bs = 32).
- yardsticks: SDPA on the same work, K/V laid out dense in bf16 beforehand
  (for the int8 kernels dequantised, twice the bytes they read), timed as
  the kernel is: decode (B1 and B4a) as a CUDA graph and eagerly, each
  layer's K/V its own; B2 at S = 1504 and at 704 over 256 (the latter also
  B4b's) eagerly.  Graph is compared with graph, eager with eager.
- B3 and B4c: the ragged kernel over a bf16 cache (Bs = 16) and an int8
  one (Bs = 32) at two row tables (``cuda_timing.py``): the packed prefill
  17/300/640/48 and a mixed dispatch of T = 1024, eight decode rows ahead
  of two spans, and that dispatch with the decode rows emptied (the spans
  alone).
- host cost: microseconds of host time per wrapper call, launches queued
  faster than the card runs them.

Successive calls of an attention kernel walk the 32 layers, past the L2.
Prints one ``AB {...}`` JSON line per run (each metric's readings), then a
table of each run's median and, per tag, the median and range of all its
readings: so a yardstick is held as the median of its readings across the
call.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the timers and shapes chip_smoke.py uses; run as a script, this file's
# directory is on the path, so this loads without the package (whose
# kernels come from the tree under test)
from cuda_timing import (DECODE_LENS, LM_HEAD, PROJECTIONS, RAGGED_MIXED, RAGGED_PACKED, card_line,
                         cuda_time_ms, graph_time_ms, ragged_layout)

ROWS = (8, 16, 17, 64, 300, 1504)
KERNELS = ("b1", "b2", "b3", "b4a", "b4b", "b4c", "b5")


def _measure(tag: str, repeat: int, only: set[str]) -> dict:
    import torch
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.kernels import build
    from dynamo_tpu_torch.ops.kernels.decode_attention import paged_decode_attention, paged_decode_attention_q8
    from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention, paged_prefill_attention_q8
    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention, ragged_paged_prefill_attention_q8)
    from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, scale_tile

    build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"tag": tag, "card": torch.cuda.get_device_name(0)}
    host = {}  # wrapper calls whose host cost is read last

    def read(key, time_once):
        out[key] = [time_once() for _ in range(repeat)]

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def weight(k, n):
        wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        return wq, (0.5 + torch.rand(n, generator=gen, device="cuda")) / (73.3 * math.sqrt(k))

    if "b5" in only:
        layers = [{name: weight(*kn) for name, kn in PROJECTIONS.items()} for _ in range(4)]
        for m in ROWS:
            xs = {name: bf16(m, k) for name, (k, _) in PROJECTIONS.items()}
            calls = [lambda name=name, li=li: int8_matmul(xs[name], *layers[li][name])
                     for li in range(4) for name in PROJECTIONS]
            iters = 8 if m >= 300 else 40
            read(f"b5_layer_m{m}", lambda: graph_time_ms(calls, iters) / 4)
            read(f"b5_layer_m{m}_eager", lambda: cuda_time_ms(lambda i: [c() for c in calls], iters) / 4)
            if m in (8, 1504):
                for name in PROJECTIONS:
                    read(f"b5_{name}_m{m}", lambda: graph_time_ms(
                        [lambda name=name, li=li: int8_matmul(xs[name], *layers[li][name]) for li in range(4)],
                        iters) / 4)
        del layers
        heads = [weight(*LM_HEAD) for _ in range(2)]
        x = bf16(8, LM_HEAD[0])
        read("b5_lm_head_m8", lambda: graph_time_ms(
            [lambda i=i: int8_matmul(x, *heads[i], torch.float32) for i in range(2)], 20) / 2)
        del heads
        host["b5"] = lambda a=(bf16(8, 4096), *weight(4096, 1024)): int8_matmul(*a)

    h, hk, d, n_layers = 32, 8, 128, 32

    def tables(lens, bsz):
        """Each row's blocks contiguous from block 1, in a 2048-token table;
        and the pool's block count."""
        blocks = [-(-n // bsz) for n in lens]
        bt = torch.zeros((len(lens), 2048 // bsz), dtype=torch.int32)
        for r, nb in enumerate(blocks):
            bt[r, :nb] = torch.arange(1 + sum(blocks[:r]), 1 + sum(blocks[:r + 1]), dtype=torch.int32)
        return bt.cuda(), 1 + sum(blocks)

    def pool(n_blocks, bsz, quant):
        shape = (n_layers, n_blocks, 2, bsz, hk * d)
        if not quant:
            return bf16(*shape)
        hp, sp = scale_tile(hk, bsz)
        return QuantKvCache(torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8),
                            (0.5 + torch.rand((n_layers, n_blocks, 2, hp, sp), generator=gen,
                                              device="cuda")) / 73.3)

    def ints(xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    if "b2" in only:
        cache = bf16(n_layers, 200, 2, 16, hk * d)
        bt2 = torch.arange(1, 129, dtype=torch.int32, device="cuda")[None]
        for key, (s, start, fresh) in (("b2_s1504", (1504, 0, 1500)), ("b2_s704_start256", (704, 256, 700))):
            q, k, v = bf16(1, s, h, d), bf16(1, s, hk, d), bf16(1, s, hk, d)
            lens, st = ints([start + fresh]), ints([start])
            read(key, lambda: cuda_time_ms(
                lambda i: paged_prefill_attention(q, k, v, cache, i % n_layers, bt2, lens, st), 20))
        # host cost on a 64-token prompt, shorter on the card than its launch
        small = (bf16(1, 64, h, d), bf16(1, 64, hk, d), bf16(1, 64, hk, d), cache, 5, bt2, ints([64]), ints([0]))
        host["b2"] = lambda a=small: paged_prefill_attention(*a)
    if only & {"b2", "b4b"}:
        for key, (start, fresh) in (("sdpa_b2_s1504", (0, 1500)), ("sdpa_prefill_704_start256", (256, 700))):
            i, j = torch.arange(fresh, device="cuda"), torch.arange(start + fresh, device="cuda")
            mask = (j[None, :] < start) | (j[None, :] - start <= i[:, None])
            q, k, v = bf16(1, h, fresh, d), bf16(1, hk, start + fresh, d), bf16(1, hk, start + fresh, d)
            read(key, lambda: cuda_time_ms(lambda i: sdpa(q, k, v, mask), 20))

    def decode_calls(lens, bsz, quant):
        """One decode step's layer calls at ``lens``, one per layer."""
        bt, n_blocks = tables(lens, bsz)
        cache = pool(n_blocks, bsz, quant)
        q = bf16(len(lens), 1, h, d)
        seq = ints(lens)
        q0 = (seq - 1).clamp_min(0)
        kernel = paged_decode_attention_q8 if quant else paged_decode_attention
        return [lambda i=i: kernel(q, cache, i, bt, seq, q0) for i in range(n_layers)]

    for name, bsz, quant in (("b1", 16, False), ("b4a", 32, True)):
        if name not in only:
            continue
        calls = decode_calls(DECODE_LENS, bsz, quant)
        read(f"{name}_decode", lambda: graph_time_ms(calls, 20) / n_layers)
        read(f"{name}_decode_eager", lambda: cuda_time_ms(lambda i: calls[i % n_layers](), 64))
        host[name] = calls[0]
        del calls
    if "b4a" in only:
        for key, lens in (("b4a_8x2000", [2000] * 8), ("b4a_2x300", [300, 300])):
            calls = decode_calls(lens, 32, True)
            read(key, lambda: graph_time_ms(calls, 20) / n_layers)
            del calls
    if only & {"b1", "b4a"}:
        t = max(DECODE_LENS)
        lens = torch.tensor(DECODE_LENS, device="cuda")
        mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qd = bf16(len(DECODE_LENS), h, 1, d)
        kvs = [(bf16(len(DECODE_LENS), hk, t, d), bf16(len(DECODE_LENS), hk, t, d)) for _ in range(n_layers)]
        calls = [lambda kv=kv: sdpa(qd, *kv, mask) for kv in kvs]
        read("sdpa_decode", lambda: graph_time_ms(calls, 20) / n_layers)
        read("sdpa_decode_eager", lambda: cuda_time_ms(lambda i: calls[i % n_layers](), 64))
        del calls, kvs

    if "b4b" in only:
        start, fresh, bsz = 256, 700, 32
        bt, n_blocks = tables([start + fresh], bsz)
        cache = pool(n_blocks, bsz, True)
        s = -(-fresh // bsz) * bsz
        q, k, v = bf16(1, s, h, d), bf16(1, s, hk, d), bf16(1, s, hk, d)
        lens, st = ints([start + fresh]), ints([start])
        read("b4b_s704_start256", lambda: cuda_time_ms(
            lambda i: paged_prefill_attention_q8(q, k, v, cache, i % n_layers, bt, lens, st), 20))
        host["b4b"] = lambda a=(q, k, v, cache, 5, bt, lens, st): paged_prefill_attention_q8(*a)

    def ragged_call(rows, region, quant, spans_only=False):
        """The ragged kernel at one row table, rows' blocks contiguous in a
        fresh pool (int8 with Bs = 32, or bf16 with Bs = 16)."""
        rbs = 32 if quant else 16
        t, starts, lens, offs = ragged_layout(rows, region, 0, rbs)
        bt, n_blocks = tables(lens, rbs)
        cache = pool(n_blocks, rbs, quant)
        q, k, v = bf16(1, t, h, d), bf16(1, t, hk, d), bf16(1, t, hk, d)
        if spans_only:  # the decode rows' spans emptied (seq_len = start)
            lens = [st if n - st == 1 else n for st, n in zip(starts, lens)]
        args = [ints(x) for x in (lens, starts, offs)]
        kernel = ragged_paged_prefill_attention_q8 if quant else ragged_paged_prefill_attention
        return lambda i=0: kernel(q, k, v, cache, i % n_layers, bt, *args)

    for name, quant in (("b3", False), ("b4c", True)):
        if name not in only:
            continue
        for key, case in (("packed", (*RAGGED_PACKED, quant)), ("mixed", (*RAGGED_MIXED, quant)),
                          ("mixed_spans", (*RAGGED_MIXED, quant, True))):
            call = ragged_call(*case)
            read(f"{name}_{key}", lambda: cuda_time_ms(call, 32))
        host[name] = ragged_call([(0, 64)], 0, quant)

    for name, fn in host.items():
        def host_us():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            us = (time.perf_counter() - t0) / 2000 * 1e6
            torch.cuda.synchronize()
            return us
        read(f"host_us_{name}_call", host_us)
    return out


def _table(runs: list[dict], card: str) -> None:
    """Each run's median per metric, then each tag's median and range over
    all its readings."""
    tags = list(dict.fromkeys(r["tag"] for r in runs))
    keys = [k for k in runs[0] if k not in ("tag", "card") and all(k in r for r in runs)]
    print(f"{'metric (ms unless us)':26s} " + " ".join(f"{r['tag'][:9]:>9s}" for r in runs) + "   "
          + " ".join(f"{t[:9] + ' med (range)':>28s}" for t in tags) + f"  ({card})")
    for k in keys:
        per_tag = []
        for t in tags:
            xs = [x for r in runs if r["tag"] == t for x in r[k]]
            per_tag.append(f"{statistics.median(xs):9.4f} ({min(xs):.4f}-{max(xs):.4f})")
        print(f"{k:26s} " + " ".join(f"{statistics.median(r[k]):9.4f}" for r in runs) + "   "
              + " ".join(f"{x:>28s}" for x in per_tag))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--base", help="root of the checkout to compare against (base, change, change, base)")
    which.add_argument("--trees", nargs="+", metavar="ROOT:TAG", help="checkouts to time, in this order")
    ap.add_argument("--change", default=str(Path(__file__).resolve().parents[2]),
                    help="root of the checkout under test with --base (default: this one)")
    ap.add_argument("--repeat", type=int, default=1, help="readings of each metric per run")
    ap.add_argument("--only", default=",".join(KERNELS), help="kernels to time, comma-separated")
    ap.add_argument("--run", nargs=2, metavar=("ROOT", "TAG"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(KERNELS) or args.repeat < 1 or not (args.run or args.base or args.trees):
        ap.error(f"give --base or --trees; --only takes names from {KERNELS}; --repeat at least 1")
    if args.run:
        sys.path.insert(0, str(Path(args.run[0]).resolve()))
        import torch

        if not torch.cuda.is_available():
            print("kernel_ab: no CUDA device", file=sys.stderr)
            return 3
        print("AB " + json.dumps(_measure(args.run[1], args.repeat, only)), flush=True)
        return 0
    if args.base:
        order = [(args.base, "base"), (args.change, "change"), (args.change, "change"), (args.base, "base")]
    else:
        order = [(root, tag or root) for root, _, tag in (t.partition(":") for t in args.trees)]
    card = card_line()
    print(card, flush=True)
    runs = []
    for root, tag in order:
        r = subprocess.run([sys.executable, __file__, "--repeat", str(args.repeat),
                            "--only", args.only, "--run", root, tag], capture_output=True, text=True)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")]
        if r.returncode or not line:
            print(f"kernel_ab: the {tag} run ({root}) failed:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        print(line[0], flush=True)
        runs.append(json.loads(line[0][3:]))
    _table(runs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
