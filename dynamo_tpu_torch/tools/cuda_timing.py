"""Timing on one CUDA card, the Llama-3-8B matmul shapes and the ragged
attention row tables, shared by ``chip_smoke.py`` and ``tools/kernel_ab.py``.

It imports nothing of the package, so ``kernel_ab.py`` can load it beside
another checkout's kernels; ``torch`` is imported when a timer runs.
"""

from __future__ import annotations

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
