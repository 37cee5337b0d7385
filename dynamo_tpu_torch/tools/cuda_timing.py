"""Timing on one CUDA card, the Llama-3-8B matmul shapes, the ragged
attention row tables and one Qwen3-30B-A3B MoE layer's grouped launches,
shared by ``chip_smoke.py`` and ``tools/kernel_ab.py``.

It imports nothing of the package, so ``kernel_ab.py`` can load it beside
another checkout's kernels; ``torch`` is imported when a timer runs.
"""

from __future__ import annotations

import math
import subprocess

# Llama-3-8B's matmuls as the model runs them, [K, N]: the seven
# projections of a layer (q, k and v are three products) and the lm_head
PROJECTIONS = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
               "w_gate": (4096, 14336), "w_up": (4096, 14336), "w_down": (14336, 4096)}
LM_HEAD = (4096, 128256)

# one decode step of the default paths' serving run: the six requests
# (prompts of 17, 300, 640, 1500, 356 and 956 tokens) mid-generation, 16
# tokens in, and two empty slots of the 8
DECODE_LENS = [33, 316, 656, 1516, 372, 972, 0, 0]

# ragged attention row tables, (start, fresh) per row: the token-budget
# path's first dispatch (prompts of 17, 300 and 640 tokens and the first 48
# of a 1500-token one, from 0), and a mixed dispatch of T = 1024 (eight
# decode rows in a 16-slot decode region, ahead of a 700-token span over a
# 256-token cached prefix and a 300-token span from 0)
RAGGED_PACKED = ([(0, 17), (0, 300), (0, 640), (0, 48)], 0)
RAGGED_MIXED = ([(n - 1, 1) for n in (33, 316, 656, 1516, 372, 972, 100, 2000)] + [(256, 700), (0, 300)],
                16)


# one Qwen3-30B-A3B MoE layer (Qwen/Qwen3-30B-A3B config.json: 128
# experts, top 8, hidden 2048, expert width 768) as the grouped expert
# kernels run it: three launches, [K, N] per expert (gate and up on the
# sorted rows, down on the activations), at a decode step's 8 tokens and
# the longest prompt's 1,504
MOE_EXPERTS, MOE_TOP_K = 128, 8
MOE_LAUNCHES = {"w_gate": (2048, 768), "w_up": (2048, 768), "w_down": (768, 2048)}
MOE_TOKENS = (8, 1504)


def moe_offsets(gen, t: int, experts: int = MOE_EXPERTS, k: int = MOE_TOP_K, routing: str = "uniform"):
    """Group offsets [E + 1] int32 on the card for t tokens' top-k rows
    sorted by expert: "uniform" (each token's k distinct experts drawn at
    random) or "one" (every row on one expert, every other expert empty)."""
    import torch

    counts = torch.zeros(experts, dtype=torch.int64, device="cuda")
    if routing == "one":
        counts[experts // 3] = t * k
    else:
        topi = torch.rand((t, experts), generator=gen, device="cuda").argsort(dim=-1)[:, :k]
        counts += torch.bincount(topi.flatten(), minlength=experts)
    offsets = torch.zeros(experts + 1, dtype=torch.int32, device="cuda")
    offsets[1:] = counts.cumsum(0)
    return offsets


def moe_stack(gen, experts: int, k: int, n: int, quant: bool):
    """Random experts [E, K, N] on the card: bf16 N(0, 1/K), or (int8
    codes, f32 scales [E, 1, N]) that give the same spread."""
    import torch

    if quant:
        wq = torch.randint(-127, 128, (experts, k, n), generator=gen, device="cuda", dtype=torch.int8)
        scale = (0.5 + torch.rand((experts, 1, n), generator=gen, device="cuda")) / (73.3 * math.sqrt(k))
        return wq, scale
    out = torch.empty((experts, k, n), dtype=torch.bfloat16, device="cuda")
    for e in range(experts):  # one expert's f32 draw at a time
        out[e] = torch.randn((k, n), generator=gen, device="cuda").div_(math.sqrt(k))
    return out


def moe_layer_work(r: int, live: int, quant: bool, launches: dict = MOE_LAUNCHES) -> tuple[float, float]:
    """(operations, bytes) of one MoE layer's three grouped launches (name
    -> [K, N], Qwen3-30B-A3B's unless named) over r rows routed to ``live``
    experts: 2 r K N per launch; the live experts' weights (int8 with their
    f32 scales, or bf16) and every launch's input and output rows once."""
    wb = 1 if quant else 2
    nbytes = (live * sum(k * n for k, n in launches.values()) * wb
              + (live * sum(n for _, n in launches.values()) * 4 if quant else 0)
              + sum(2 * r * (k + n) for k, n in launches.values()))
    return sum(2 * r * k * n for k, n in launches.values()), nbytes


def ragged_layout(rows, region: int, n_pad: int, bs: int = 16):
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
        off += -(-fresh // bs) * bs
    pad = [0] * n_pad
    return (off, [st for st, _ in rows] + pad, [st + f for st, f in rows] + pad, offs + pad)


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them; raises RuntimeError when nvidia-smi fails."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call on the card, by CUDA events around ``iters``
    calls launched from Python (``fn(i)`` gets the call index, so callers
    can rotate inputs past the 50 MB L2).  Once the kernels are shorter than
    their launch, this measures the host."""
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


def graph_time_ms(calls, iters: int) -> float:
    """Mean time of one replay of a CUDA graph holding ``calls`` in order:
    the card's time for the kernels without the host's launch cost."""
    import torch

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        for c in calls:  # first launches and allocations outside the capture
            c()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for c in calls:
                c()
    torch.cuda.synchronize()
    return cuda_time_ms(lambda i: graph.replay(), iters)


def median_ms(time_once, repeats: int = 3) -> float:
    """The median of ``repeats`` readings of ``time_once()`` (a timer call
    returning ms): library calls drift between readings on one card."""
    return sorted(time_once() for _ in range(repeats))[repeats // 2]
