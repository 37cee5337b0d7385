"""Timing on one CUDA card, and the Llama-3-8B matmul shapes, shared by
``chip_smoke.py`` and ``tools/kernel_ab.py``.

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
