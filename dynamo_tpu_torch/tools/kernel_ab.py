#!/usr/bin/env python3
"""Time the B5, B2, B3 and B4c kernels (matmul, paged and ragged prefill) of two checkouts on one card.

    python3 dynamo_tpu_torch/tools/kernel_ab.py --base DIR [--change DIR]

DIR is the root of a checkout (the directory holding ``dynamo_tpu_torch/``);
``--change`` defaults to this checkout.  Each tree is built and timed in its
own process, in the order base, change, change, base, so that the card's
clocks and neighbours drift alike over both; every line names the card and
its power limit.  The shapes are Llama-3-8B's as the serving paths run them:

- B5: one layer's seven projections ([K, N] int8 weights, four layers'
  weights in turn, past the 50 MB L2) at M = 8 (a decode step), 16 and 17
  (the two regimes' edges), 64, 300 and 1504 (the longest prompt's
  prefill), and the tied lm_head [4096,
  128256] at M = 8 with f32 out.  Device time is a CUDA graph of the calls
  replayed (no host launch cost); "eager" is the same calls launched from
  Python, which at M = 8 measures the host as much as the card.
- B2: the 1500-token prompt (S = 1504, start 0) and a 700-token prompt over
  a 256-token cached prefix, one layer (H = 32, Hk = 8, D = 128, Bs = 16).
- B3 and B4c: the ragged kernel over a bf16 cache (Bs = 16) and an int8
  one (Bs = 32) at two row tables (``cuda_timing.py``): the packed prefill
  17/300/640/48 and a mixed dispatch of T = 1024, eight decode rows ahead
  of two spans, and that dispatch with the decode rows emptied (the spans
  alone); successive calls walk the 32 layers.
- host cost: microseconds of host time per wrapper call, launches queued
  faster than the card runs them.

Prints one ``AB {...}`` JSON line per run and a closing summary table.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# the timers and shapes chip_smoke.py uses; run as a script, this file's
# directory is on the path, so this loads without the package (whose
# kernels come from the tree under test)
from cuda_timing import (LM_HEAD, PROJECTIONS, RAGGED_MIXED, RAGGED_PACKED, card_line, cuda_time_ms,
                         graph_time_ms, ragged_layout)

ROWS = (8, 16, 17, 64, 300, 1504)


def _measure(tag: str) -> dict:
    import torch

    from dynamo_tpu_torch.ops.kernels import build
    from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention
    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention, ragged_paged_prefill_attention_q8)
    from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, scale_tile

    build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def weight(k, n):
        wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        return wq, (0.5 + torch.rand(n, generator=gen, device="cuda")) / (73.3 * math.sqrt(k))

    out = {"tag": tag, "card": torch.cuda.get_device_name(0)}
    layers = [{name: weight(*kn) for name, kn in PROJECTIONS.items()} for _ in range(4)]
    for m in ROWS:
        xs = {name: torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
              for name, (k, _) in PROJECTIONS.items()}
        calls = [lambda name=name, li=li: int8_matmul(xs[name], *layers[li][name])
                 for li in range(4) for name in PROJECTIONS]
        iters = 8 if m >= 300 else 40
        out[f"b5_layer_m{m}"] = graph_time_ms(calls, iters) / 4
        out[f"b5_layer_m{m}_eager"] = cuda_time_ms(lambda i: [c() for c in calls], iters) / 4
        if m in (8, 1504):
            for name in PROJECTIONS:
                out[f"b5_{name}_m{m}"] = graph_time_ms(
                    [lambda name=name, li=li: int8_matmul(xs[name], *layers[li][name]) for li in range(4)],
                    iters) / 4
    del layers
    heads = [weight(*LM_HEAD) for _ in range(2)]
    x = torch.randn((8, LM_HEAD[0]), generator=gen, device="cuda").to(torch.bfloat16)
    out["b5_lm_head_m8"] = graph_time_ms(
        [lambda i=i: int8_matmul(x, *heads[i], torch.float32) for i in range(2)], 20) / 2
    del heads

    h, hk, d, bs, n_layers = 32, 8, 128, 16, 32
    cache = torch.randn((n_layers, 200, 2, bs, hk * d), generator=gen, device="cuda").to(torch.bfloat16)
    tables = torch.arange(1, 129, dtype=torch.int32, device="cuda")[None]

    def prefill_case(s, start, fresh):
        q = torch.randn((1, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, s, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, s, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.tensor([start + fresh], dtype=torch.int32, device="cuda")
        st = torch.tensor([start], dtype=torch.int32, device="cuda")
        return lambda i=0: paged_prefill_attention(q, k, v, cache, 5, tables, lens, st)

    out["b2_s1504"] = cuda_time_ms(prefill_case(1504, 0, 1500), 20)
    out["b2_s704_start256"] = cuda_time_ms(prefill_case(704, 256, 700), 20)

    def ragged_case(rows, region, quant, spans_only=False):
        """The ragged kernel at one row table, rows' blocks contiguous in a
        fresh pool (int8 with Bs = 32, or bf16 with Bs = 16)."""
        rbs = 32 if quant else 16
        t, starts, lens, offs = ragged_layout(rows, region, 0, rbs)
        blocks = [-(-n // rbs) for n in lens]
        bt = torch.zeros((len(lens), 2048 // rbs), dtype=torch.int32)
        for i, nb in enumerate(blocks):
            bt[i, :nb] = torch.arange(1 + sum(blocks[:i]), 1 + sum(blocks[:i + 1]), dtype=torch.int32)
        n_blocks = 1 + sum(blocks)
        if quant:
            data = torch.randint(-127, 128, (n_layers, n_blocks, 2, rbs, hk * d), generator=gen,
                                 device="cuda", dtype=torch.int8)
            hp, sp = scale_tile(hk, rbs)
            pool = QuantKvCache(data, (0.5 + torch.rand((n_layers, n_blocks, 2, hp, sp), generator=gen,
                                                        device="cuda")) / 73.3)
        else:
            pool = torch.randn((n_layers, n_blocks, 2, rbs, hk * d), generator=gen,
                               device="cuda").to(torch.bfloat16)
        q = torch.randn((1, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, t, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, t, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
        if spans_only:  # the decode rows' spans emptied (seq_len = start)
            lens = [st if n - st == 1 else n for st, n in zip(starts, lens)]
        ints = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (lens, starts, offs)]
        bt = bt.cuda()
        kernel = ragged_paged_prefill_attention_q8 if quant else ragged_paged_prefill_attention
        return lambda i=0: kernel(q, k, v, pool, i % n_layers, bt, *ints)

    for tag, quant in (("b3", False), ("b4c", True)):
        out[f"{tag}_packed"] = cuda_time_ms(ragged_case(*RAGGED_PACKED, quant), 32)
        out[f"{tag}_mixed"] = cuda_time_ms(ragged_case(*RAGGED_MIXED, quant), 32)
        out[f"{tag}_mixed_spans"] = cuda_time_ms(ragged_case(*RAGGED_MIXED, quant, spans_only=True), 32)

    xs8 = torch.randn((8, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    w1 = weight(4096, 1024)
    small = prefill_case(64, 0, 64)
    small_ragged = ragged_case([(0, 64)], 0, False)
    for key, fn in (("host_us_b5_call", lambda: int8_matmul(xs8, *w1)), ("host_us_b2_call", small),
                    ("host_us_b3_call", small_ragged)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        out[key] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="root of the checkout to compare against")
    ap.add_argument("--change", default=str(Path(__file__).resolve().parents[2]),
                    help="root of the checkout under test (default: this one)")
    ap.add_argument("--run", nargs=2, metavar=("ROOT", "TAG"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        sys.path.insert(0, str(Path(args.run[0]).resolve()))
        import torch

        if not torch.cuda.is_available():
            print("kernel_ab: no CUDA device", file=sys.stderr)
            return 3
        print("AB " + json.dumps(_measure(args.run[1])), flush=True)
        return 0
    card = card_line()
    print(card, flush=True)
    runs = []
    for root, tag in ((args.base, "base"), (args.change, "change"), (args.change, "change"),
                      (args.base, "base")):
        r = subprocess.run([sys.executable, __file__, "--base", args.base, "--run", root, tag],
                           capture_output=True, text=True)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")]
        if r.returncode or not line:
            print(f"kernel_ab: the {tag} run ({root}) failed:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        print(line[0], flush=True)
        runs.append(json.loads(line[0][3:]))
    keys = [k for k in runs[0] if k not in ("tag", "card")]
    print(f"{'metric (ms unless us)':28s} {'base':>9s} {'change':>9s} {'change':>9s} {'base':>9s}  ({card})")
    for k in keys:
        print(f"{k:28s} " + " ".join(f"{r[k]:9.4f}" for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
