"""Kernel registry: one census and one cost table for the nine CUDA kernels
and their float16 bodies.

The counterpart of ``dynamo_tpu/ops/pallas/registry.py``.  Every hand-written
kernel the port launches is registered here with the facts that the kernel
plane (``analysis/kerncheck.py``, ``lint --kern``), the perf plane
(``analysis/perfcheck.py``, ``lint --perf``) and ``chip_smoke.py`` read:

- **the census** (:data:`KERNELS`): each wrapper of
  ``ops/kernels/__init__.py::wrappers()`` by its function name, with the
  TPU site it replaces, its C entry and source, its plain version, its
  launch counter and the ``chip_smoke.py`` function that holds it to that
  plain version on the card, and the activation dtypes it has a body for
  (``dtypes``: bfloat16, and float16 for all but the grouped kernels E1/E2,
  each fp16 body counted in the wrapper's ``launches_fp16`` as well; what
  a model's route takes on the card, :func:`route_dtypes`).
  ``unified_ragged_attention`` stays a placeholder with no module, as in
  the JAX package: decode and ragged prefill are two kernels.
- **two cost functions per kernel**, each a dict of ``hbm_bytes``,
  ``flops``, ``transcendentals`` and ``intensity``:
  :func:`work_cost` is the work itself, whatever implements it (each input
  tensor read once and each output written once, the paged cache only at
  the context slots the rows hold and the expert stack only for the
  experts rows route to; 2·M·K·N for a product, 2·H·(D_qk + D_v) per
  visible (query, key) pair): the bound every kernel row of ``PERF.md``
  prints.  :func:`plan_cost` is what the kernel's own launch plan streams:
  decode's row groups each re-read their head's context and its split-K
  partials go out and back, the prefill tiles re-stream the prefix, B5's
  x tiles re-stream for each N tile, a grouped work item reads whole
  tiles.  :func:`bound` turns either into milliseconds at the H100's rates
  of ``obs/topology.py``.
- **the audit matrix** (:func:`audit_cases`): JAX's case names and row
  geometries (empty rows, 1-token rows at a start off the block boundary,
  lengths that do not divide the block, a max-block row) at head dim 64,
  the least the kernels take (JAX audits D = 16; ``tests/
  test_torch_kerncheck.py`` holds the plain versions to JAX's kernels at
  JAX's own geometry), the port's additions (the verify's S = 5 and 8,
  the int8 prefill, the grouped kernels at T = 8 and 1,504, and each fp16
  body at its bf16 twin's geometry, ``dtype`` float16), and a spec-only
  case at each serving shape ``PERF.md`` §6 times.  Run cases build their
  inputs from a numpy seed; :func:`poison` NaN-poisons what no live lane
  may read.

Nothing here builds or launches a kernel: the plans come from the wrappers'
``plan`` functions and ``build.geometry()``, which read
``csrc/launch_geometry.cuh`` as text.
"""

from __future__ import annotations

import dataclasses
import math

from dynamo_tpu_torch.obs.topology import DEFAULT_TOPOLOGY, TOPOLOGIES
from dynamo_tpu_torch.ops.kernels.build import ACTIVATIONS
from dynamo_tpu_torch.tools.cuda_timing import (
    DECODE_LENS,
    MOE_EXPERTS,
    MOE_LAUNCHES,
    MOE_TOP_K,
    PROJECTIONS,
)

__all__ = [
    "H100_SMS",
    "KERNELS",
    "LIMITS",
    "audit_cases",
    "blocks_per_sm",
    "bound",
    "cost_dict",
    "fuzz_case",
    "lanes",
    "plan_cost",
    "plan_facts",
    "poison",
    "total_cost",
    "work_cost",
]

_PKG = __name__.split(".")[0]
_KMOD = f"{_PKG}.ops.kernels"

# One H100 SXM: its SMs and the CUDA limits a launch must keep (Hopper:
# 227 KB of shared memory a block may opt into, 228 KB an SM, 1 KB of each
# block's reserved by the system).
H100_SMS = 132
LIMITS = {
    "smem_per_block": 232_448,
    "smem_per_sm": 233_472,
    "smem_reserved_per_block": 1_024,
    "threads_per_block": 1_024,
    "threads_per_sm": 2_048,
    "blocks_per_sm": 32,
    "grid_x": 2 ** 31 - 1,
    "grid_yz": 65_535,
}

# ------------------------------------------------------------ the census ----


# the activation dtypes of a kernel with an fp16 body (its C entry + "_f16",
# counted in ``launches_fp16`` too), and of one without
HALF = tuple(ACTIVATIONS)
BF16 = ("bfloat16",)


def _kernel(kid, module, wrapper, plain, entry, source, replaces, probe, plain_reads_host=False,
            dtypes=HALF):
    return {"id": kid, "module": f"{_KMOD}.{module}", "wrapper": wrapper, "plain": plain,
            "entry": entry, "source": f"{_PKG}/csrc/{source}", "replaces": replaces,
            "counter": "launches", "probe": probe, "plain_reads_host": plain_reads_host,
            "placeholder": False, "dtypes": dtypes}


_DEC, _PRE = "dynamo_tpu/ops/pallas/decode_attention.py", "dynamo_tpu/ops/pallas/prefill_attention.py"
# name -> facts.  ``probe`` is the chip_smoke.py function that holds the
# kernel to its plain version on the card at the registry's geometries;
# ``plain_reads_host`` marks a plain version that reads its row table or
# group offsets on the host (the perf plane never runs it on shapes alone).
KERNELS = {
    "paged_decode_attention": _kernel(
        "B1", "decode_attention", "paged_decode_attention", "decode_attention_ref",
        "dynamo_decode_attention", "decode_attention.cu", f"{_DEC}:281", "kern_phase"),
    "paged_decode_attention_q8": _kernel(
        "B4a", "decode_attention", "paged_decode_attention_q8", "decode_attention_ref",
        "dynamo_decode_attention_q8", "decode_attention.cu", f"{_DEC}:94", "kern_phase"),
    "paged_prefill_attention": _kernel(
        "B2", "prefill_attention", "paged_prefill_attention", "prefill_attention_ref",
        "dynamo_prefill_attention", "prefill_attention.cu", f"{_PRE}:246", "kern_phase"),
    "paged_prefill_attention_q8": _kernel(
        "B4b", "prefill_attention", "paged_prefill_attention_q8", "prefill_attention_ref",
        "dynamo_prefill_attention_q8", "prefill_attention.cu", f"{_PRE}:57", "kern_phase"),
    "ragged_paged_prefill_attention": _kernel(
        "B3", "ragged_prefill_attention", "ragged_paged_prefill_attention",
        "ragged_prefill_attention_ref", "dynamo_ragged_prefill_attention",
        "ragged_prefill_attention.cu", f"{_PRE}:593", "kern_phase", plain_reads_host=True),
    "ragged_paged_prefill_attention_q8": _kernel(
        "B4c", "ragged_prefill_attention", "ragged_paged_prefill_attention_q8",
        "ragged_prefill_attention_ref", "dynamo_ragged_prefill_attention_q8",
        "ragged_prefill_attention.cu", f"{_PRE}:384", "kern_phase", plain_reads_host=True),
    "int8_matmul": _kernel(
        "B5", "int8_matmul", "int8_matmul", "int8_matmul_ref", "dynamo_int8_matmul",
        "int8_matmul.cu", "dynamo_tpu/ops/pallas/int8_matmul.py:64", "kern_phase"),
    "grouped_matmul": _kernel(
        "E1", "grouped_matmul", "grouped_matmul", "grouped_matmul_ref", "dynamo_grouped_matmul",
        "grouped_matmul.cu", "dynamo_tpu/models/llama.py:631", "kern_phase", plain_reads_host=True,
        dtypes=BF16),
    "grouped_matmul_q8": _kernel(
        "E2", "grouped_matmul", "grouped_matmul_q8", "grouped_matmul_q8_ref",
        "dynamo_grouped_matmul", "grouped_matmul.cu", "dynamo_tpu/models/llama.py:660",
        "kern_phase", plain_reads_host=True, dtypes=BF16),
    # the JAX registry's placeholder (its registry.py:106): one kernel for
    # decode and ragged prefill, not yet written in either package
    "unified_ragged_attention": {"id": None, "module": None, "placeholder": True},
}

# the kernels a dense Llama-family model's route launches on the card, and
# the grouped expert kernels a mixture of experts adds
DENSE_ROUTE = ("paged_decode_attention", "paged_prefill_attention", "ragged_paged_prefill_attention",
               "paged_decode_attention_q8", "paged_prefill_attention_q8",
               "ragged_paged_prefill_attention_q8", "int8_matmul")
MOE_ROUTE = ("grouped_matmul", "grouped_matmul_q8")


def route_dtypes(moe: bool = False) -> tuple[str, ...]:
    """The activation dtypes every kernel on a dense model's route (and,
    with ``moe``, a mixture of experts') has a body for: what an engine on
    the card can serve."""
    names = DENSE_ROUTE + (MOE_ROUTE if moe else ())
    return tuple(d for d in HALF if all(d in KERNELS[n]["dtypes"] for n in names))


# the decode / ragged-prefill split the placeholder would end
SPLIT = {"decode": "paged_decode_attention", "ragged_prefill": "ragged_paged_prefill_attention",
         "unified": "unified_ragged_attention"}


def wrapper_fn(name: str):
    """The wrapper function of kernel ``name``."""
    import importlib

    meta = KERNELS[name]
    return getattr(importlib.import_module(meta["module"]), meta["wrapper"])


def plain_fn(name: str):
    """The plain PyTorch version of kernel ``name``."""
    import importlib

    meta = KERNELS[name]
    return getattr(importlib.import_module(meta["module"]), meta["plain"])


# ----------------------------------------------------------- cost model ----


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cost_dict(hbm_bytes: int, flops: int, trans: int) -> dict:
    """The JAX registry's ``_cost_dict``."""
    return {
        "hbm_bytes": int(hbm_bytes),
        "flops": int(flops),
        "transcendentals": int(trans),
        "intensity": round(flops / hbm_bytes, 4) if hbm_bytes else 0.0,
    }


def total_cost(costs) -> dict:
    """The sum of several cost dicts (a layer's launches)."""
    costs = list(costs)
    return cost_dict(sum(c["hbm_bytes"] for c in costs), sum(c["flops"] for c in costs),
                     sum(c["transcendentals"] for c in costs))


def bound(cost: dict, dtype: str = "bfloat16", topology: str = DEFAULT_TOPOLOGY) -> dict:
    """The least time the card could take for ``cost``: the larger of its
    operations over the peak rate of ``dtype`` (every kernel here computes
    on the bf16 tensor cores, int8 operands converted) and its bytes over
    the memory rate.  ``{"bound_ms", "bound_by"}``."""
    topo = TOPOLOGIES[topology]
    t_ops = cost["flops"] / topo["peak_flops"].get(dtype, topo["default_flops"])
    t_bytes = cost["hbm_bytes"] / topo["hbm_bw"]
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_cost(h: int, d_qk: int, d_v: int, pairs: int, nbytes: int) -> dict:
    """Attention over ``pairs`` visible (query, key) pairs of ``h`` heads:
    2·H·(D_qk + D_v) operations and H exponentials a pair."""
    return cost_dict(nbytes, 2 * h * (d_qk + d_v) * pairs, h * pairs)


def decode_pairs(lens, s: int, q0=None) -> int:
    """Visible pairs of a decode launch: row b's query j sits at ``q0[b] +
    j`` (``max(len - s, 0)`` unless given) and sees slots ``[0, min(len,
    q0 + j + 1))``."""
    q0 = [max(n - s, 0) for n in lens] if q0 is None else list(q0)
    return sum(max(0, min(n, p + j + 1)) for n, p in zip(lens, q0) for j in range(s))


def span_pairs(starts, lens) -> int:
    """Visible pairs of prefill spans: each fresh token sees its row's whole
    prefix and its own span causally."""
    return sum((n - st) * st + (n - st) * (n - st + 1) // 2 for st, n in zip(starts, lens))


def _kv_bytes(tokens: int, hk: int, d: int, quant: bool) -> int:
    """K and V of ``tokens`` cached tokens: bf16, or int8 codes plus the f32
    scale of each (token, KV head, K or V)."""
    return 2 * tokens * hk * (d + 4 if quant else 2 * d)


def latent_attention_work(h: int, d_latent: int, d_v: int, pairs: int, q_rows: int,
                          ctx_rows: int) -> dict:
    """The plain MLA op the DeepSeek model runs (no kernel: Queue B's M1):
    one bf16 latent row of ``d_latent`` per context token read once, the
    ``q_rows`` queries of ``h`` heads (``d_latent`` wide) read and their
    ``d_v``-wide outputs written once."""
    nbytes = 2 * ctx_rows * d_latent + 2 * q_rows * h * (d_latent + d_v)
    return attention_cost(h, d_latent, d_v, pairs, nbytes)


def decode_work(b, s, h, hk, d, m, lens, q0=None, quant=False) -> dict:
    """B1 / B4a: q and out [b, s, h, d] bf16, each row's ``lens`` context
    slots of K and V, the block table, seq_lens and q0."""
    nbytes = 2 * (2 * b * s * h * d) + _kv_bytes(sum(lens), hk, d, quant) + 4 * (b * m + 2 * b)
    return attention_cost(h, d, d, decode_pairs(lens, s, q0), nbytes)


def prefill_work(b, s, h, hk, d, m, starts, lens, quant=False) -> dict:
    """B2 / B4b: q, k_new, v_new and out [b, s, ...] bf16, each row's
    ``starts`` prefix slots of K and V, the block table, seq_lens, start."""
    nbytes = (2 * (2 * b * s * h * d + 2 * b * s * hk * d) + _kv_bytes(sum(starts), hk, d, quant)
              + 4 * (b * m + 2 * b))
    return attention_cost(h, d, d, span_pairs(starts, lens), nbytes)


def ragged_work(t, h, hk, d, m, starts, lens, quant=False) -> dict:
    """B3 / B4c: q, k_new, v_new and out [1, t, ...] bf16, each row's
    prefix, the block tables and the three row arrays."""
    r = len(starts)
    nbytes = (2 * (2 * t * h * d + 2 * t * hk * d) + _kv_bytes(sum(starts), hk, d, quant)
              + 4 * (r * m + 3 * r))
    return attention_cost(h, d, d, span_pairs(starts, lens), nbytes)


def matmul_work(m, k, n, out_bytes=2) -> dict:
    """B5: x [m, k] bf16, the int8 weight [k, n] and its f32 scale [n] read
    once, out [m, n] written once."""
    return cost_dict(k * n + 2 * m * k + out_bytes * m * n + 4 * n, 2 * m * k * n, 0)


def grouped_work(r, k, n, live, quant=False) -> dict:
    """E1 / E2: x [r, k] and out [r, n] bf16, and the [k, n] weights (bf16,
    or int8 with an f32 scale a channel) of the ``live`` experts that rows
    route to; the rest of the stack is never read."""
    nbytes = live * k * n * (1 if quant else 2) + (live * n * 4 if quant else 0) + 2 * r * (k + n)
    return cost_dict(nbytes, 2 * r * k * n, 0)


_WORK = {
    "paged_decode_attention": lambda g: decode_work(
        g["b"], g["s"], g["h"], g["hk"], g["d"], g["m"], g["lens"], g.get("q0")),
    "paged_decode_attention_q8": lambda g: decode_work(
        g["b"], g["s"], g["h"], g["hk"], g["d"], g["m"], g["lens"], g.get("q0"), quant=True),
    "paged_prefill_attention": lambda g: prefill_work(
        g["b"], g["s"], g["h"], g["hk"], g["d"], g["m"], g["starts"], g["lens"]),
    "paged_prefill_attention_q8": lambda g: prefill_work(
        g["b"], g["s"], g["h"], g["hk"], g["d"], g["m"], g["starts"], g["lens"], quant=True),
    "ragged_paged_prefill_attention": lambda g: ragged_work(
        g["t"], g["h"], g["hk"], g["d"], g["m"], g["starts"], g["lens"]),
    "ragged_paged_prefill_attention_q8": lambda g: ragged_work(
        g["t"], g["h"], g["hk"], g["d"], g["m"], g["starts"], g["lens"], quant=True),
    "int8_matmul": lambda g: matmul_work(g["m"], g["k"], g["n"], g.get("out_bytes", 2)),
    "grouped_matmul": lambda g: grouped_work(g["r"], g["k"], g["n"], _live(g)),
    "grouped_matmul_q8": lambda g: grouped_work(g["r"], g["k"], g["n"], _live(g), quant=True),
}


def _live(g: dict) -> int:
    return g["live"] if "live" in g else sum(1 for c in g["counts"] if c)


def work_cost(kernel: str, geometry: dict) -> dict:
    """The work of one launch of ``kernel`` at ``geometry`` (the keys its
    cost function reads: decode b, s, h, hk, d, m, lens[, q0]; prefill b,
    s, h, hk, d, m, starts, lens; ragged t, h, hk, d, m, starts, lens;
    matmul m, k, n[, out_bytes]; grouped r, k, n and live or counts), or
    of several launches (``geometry["calls"]``, a list), summed."""
    if "calls" in geometry:
        return total_cost(work_cost(kernel, c) for c in geometry["calls"])
    return _WORK[kernel](geometry)


# ------------------------------------------------------------ the plans ----


def plan_of(kernel: str, g: dict):
    """The wrapper's launch plan at geometry ``g`` on an H100 (132 SMs)."""
    from dynamo_tpu_torch.ops.kernels import decode_attention as dec
    from dynamo_tpu_torch.ops.kernels import grouped_matmul as gmm
    from dynamo_tpu_torch.ops.kernels import int8_matmul as mm
    from dynamo_tpu_torch.ops.kernels import prefill_attention as pre
    from dynamo_tpu_torch.ops.kernels import ragged_prefill_attention as rag

    quant = kernel.endswith("_q8")
    if kernel.startswith("paged_decode"):
        return dec.plan(g["b"], g["s"], g["h"], g["hk"], g["d"], g["m"], g["bs"], H100_SMS, quant)
    if kernel.startswith("paged_prefill"):
        return pre.plan(g["b"], g["s"], g["h"], g["hk"], g["d"], quant)
    if kernel.startswith("ragged"):
        return rag.plan(g["t"], len(g["starts"]), g["h"], g["hk"], g["d"], quant)
    if kernel == "int8_matmul":
        return mm.plan(g["m"], g["n"], g["k"], H100_SMS)
    return gmm.plan(g["r"], g["e"], g["n"], g["k"], quant, H100_SMS)


def blocks_per_sm(threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of dynamic shared
    memory that one SM holds at once, by shared memory, threads and the
    block limit (registers are the compiler's and not counted)."""
    by_smem = LIMITS["smem_per_sm"] // (smem + LIMITS["smem_reserved_per_block"])
    return min(by_smem, LIMITS["threads_per_sm"] // max(threads, 1), LIMITS["blocks_per_sm"])


def plan_facts(plan) -> dict:
    """A plan as the kernel plane records it: its fields, the grid as a
    3-tuple, and the blocks an SM holds."""
    facts = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(plan).items()}
    grid = list(getattr(plan, "grid", None) or (plan.blocks,))
    facts["grid"] = grid + [1] * (3 - len(grid))
    facts["blocks_per_sm"] = blocks_per_sm(plan.threads, plan.smem)
    return facts


def _geometry() -> dict:
    from dynamo_tpu_torch.ops.kernels import build

    return build.geometry()


def _decode_plan_cost(p, g, quant) -> dict:
    b, s, h, hk, d, bs = g["b"], g["s"], g["h"], g["hk"], g["d"], g["bs"]
    keys = _geometry()["B4A_KEYS"]
    blocks_per_chunk = hk * p.row_groups
    nbytes = 2 * b * s * h * d  # out
    flops = trans = 0
    for n in g["lens"]:
        live = _cdiv(n, p.chunk)
        # each row group of a KV head re-reads the head's context
        nbytes += p.row_groups * _kv_bytes(n, hk, d, quant)
        nbytes += live * (2 * s * h * d + blocks_per_chunk * 4 * (_cdiv(p.chunk, bs) + 2))
        if live > 1:  # the partials out, and back into the last chunk's merge
            nbytes += 2 * live * blocks_per_chunk * p.rows * (d + 2) * 4
        walked = sum(_cdiv(min(p.chunk, n - c * p.chunk), keys) * keys for c in range(live))
        flops += 4 * d * blocks_per_chunk * p.rows * walked
        trans += blocks_per_chunk * p.rows * walked
    return cost_dict(nbytes, flops, trans)


def _tile(n: int, keys: int) -> int:
    return _cdiv(n, keys) * keys


def _prefill_plan_cost(p, g, quant) -> dict:
    b, s, h, hk, d = g["b"], g["s"], g["h"], g["hk"], g["d"]
    tiles = p.grid[2]
    rows = p.tq * p.group
    nbytes = 4 * (b * g["m"] + 2 * b)
    flops = trans = 0
    for start in g["starts"][:b]:
        for z in range(tiles):
            fresh = min((z + 1) * p.tq, s)  # causal: the fresh keys up to the tile's end
            pre, new = _tile(start, p.keys), _tile(fresh, p.keys)
            per_head = (_kv_bytes(pre, 1, d, quant) + 2 * 2 * new * d + 2 * 2 * rows * d)
            nbytes += hk * per_head
            flops += hk * 4 * d * rows * (pre + new)
            trans += hk * rows * (pre + new)
    return cost_dict(nbytes, flops, trans)


def _ragged_plan_cost(p, g, quant) -> dict:
    t, h, hk, d = g["t"], g["h"], g["hk"], g["d"]
    starts, lens, offs = g["starts"], g["lens"], g["offs"]
    r = len(starts)
    nbytes = 4 * (r * g["m"] + 3 * r) * p.grid[0]
    flops = trans = 0
    # a decode-row block: one row of one fresh token, G query rows
    for st, n in zip(starts, lens):
        if n - st == 1:
            keys = _tile(st, p.keys) + p.keys
            nbytes += hk * (_kv_bytes(_tile(st, p.keys), 1, d, quant) + 2 * 2 * d + 2 * 2 * p.group * d)
            flops += hk * 4 * d * p.group * keys
            trans += hk * p.group * keys
    # a span block: its tq flat tokens, each overlapping row's prefix and
    # own span up to the tile's end
    rows = p.tq * p.group
    for y in range(p.span_blocks):
        lo, hi = y * p.tq, min((y + 1) * p.tq, t)
        nbytes += hk * 2 * 2 * rows * d
        for st, n, off in zip(starts, lens, offs):
            f = n - st
            if f <= 1 or off >= hi or off + f <= lo:
                continue
            pre, new = _tile(st, p.keys), _tile(min(hi, off + f) - off, p.keys)
            nbytes += hk * (_kv_bytes(pre, 1, d, quant) + 2 * 2 * new * d)
            flops += hk * 4 * d * rows * (pre + new)
            trans += hk * rows * (pre + new)
    return cost_dict(nbytes, flops, trans)


def _matmul_plan_cost(p, g) -> dict:
    m, k, n, ob = g["m"], g["k"], g["n"], g.get("out_bytes", 2)
    grid_n, grid_m = p.grid[0], p.grid[1]
    nbytes = (grid_n * m * k * 2          # x, once per N tile
              + grid_m * k * n            # the int8 weight, once per M tile
              + grid_m * n * 4            # the scale, in each M tile's epilogue
              + m * n * ob                # out
              + 2 * p.scratch * 4)        # the splits' f32 sums, out and back
    return cost_dict(nbytes, 2 * grid_m * p.bm * k * grid_n * p.bn, 0)


def _counts(g: dict) -> list[int]:
    """Per-expert rows: as given, else ``r`` spread evenly over ``live``."""
    if "counts" in g:
        return list(g["counts"])
    live, r = g["live"], g["r"]
    return [r // live + (1 if i < r % live else 0) for i in range(live)] + [0] * (g["e"] - live)


def _grouped_plan_cost(p, g, quant) -> dict:
    k, n = g["k"], g["n"]
    wb = 1 if quant else 2
    nbytes = 2 * g["r"] * n + 4 * (g["e"] + 1)
    flops = 0
    for c in _counts(g):
        for rt in range(_cdiv(c, p.rows)):
            rows = min(p.rows, c - rt * p.rows)
            for ct in range(p.grid_n):
                ch = min(p.channels, n - ct * p.channels)
                nbytes += rows * k * 2 + k * ch * wb + (ch * 4 if quant else 0)
                flops += 2 * p.rows * k * ch
    return cost_dict(nbytes, flops, 0)


def plan_cost(kernel: str, geometry: dict) -> dict:
    """What the launch plan of ``kernel`` streams at ``geometry`` (one or
    several launches, as :func:`work_cost`): every block the plan launches,
    walking its key or depth range in whole tiles."""
    if "calls" in geometry:
        return total_cost(plan_cost(kernel, c) for c in geometry["calls"])
    p = plan_of(kernel, geometry)
    quant = kernel.endswith("_q8")
    if kernel.startswith("paged_decode"):
        return _decode_plan_cost(p, geometry, quant)
    if kernel.startswith("paged_prefill"):
        return _prefill_plan_cost(p, geometry, quant)
    if kernel.startswith("ragged"):
        return _ragged_plan_cost(p, geometry, quant)
    if kernel == "int8_matmul":
        return _matmul_plan_cost(p, geometry)
    return _grouped_plan_cost(p, geometry, quant)


def static_geometry(kernel: str, args: dict) -> dict:
    """A launch's geometry from its operands' shapes alone, at the most
    work they allow (the JAX registry's static bound): every decode row at
    its full table, a prefill row's S fresh tokens after as long a prefix as
    the table holds, the ragged tokens spread evenly over the rows at their
    full tables, every expert routed to."""
    from dynamo_tpu_torch.ops.kv_quant import cache_data

    if kernel == "int8_matmul":
        x, w = args["x"], args["wq"]
        out = args.get("out_dtype")
        return {"m": x.shape[0], "k": x.shape[1], "n": w.shape[1],
                "out_bytes": 4 if out is not None and out.itemsize == 4 else 2}
    if kernel.startswith("grouped"):
        x, w = args["x"], args.get("w", args.get("wq"))
        e = w.shape[0]
        return {"r": x.shape[0], "e": e, "k": w.shape[1], "n": w.shape[2],
                "live": min(e, x.shape[0])}
    q, bt = args["q"], args["block_tables"]
    data = cache_data(args["cache"])
    bs, hkd = data.shape[3], data.shape[4]
    b, s, h, d = q.shape
    m = bt.shape[1]
    g = {"h": h, "hk": hkd // d, "d": d, "m": m, "bs": bs}
    if kernel.startswith("paged_decode"):
        return dict(g, b=b, s=s, lens=[m * bs] * b)
    if kernel.startswith("paged_prefill"):
        start = max(0, m * bs - s) // bs * bs
        return dict(g, b=b, s=s, starts=[start] * b, lens=[start + s] * b)
    r = bt.shape[0]
    fresh = [s // r + (1 if i < s % r else 0) for i in range(r)]
    starts = [max(0, m * bs - f) for f in fresh]
    offs = [sum(fresh[:i]) for i in range(r)]
    return dict(g, t=s, starts=starts, lens=[st + f for st, f in zip(starts, fresh)], offs=offs)


# ------------------------------------------------------ audit geometry ----

# JAX's audit dims (its registry.py:486) but the head dim: 64, the least
# the CUDA kernels take.  Two layers, GQA 2, four-block tables of 8 slots.
_L, _BS, _HK, _D, _H, _M = 2, 8, 2, 64, 4, 4

# JAX's adversarial ragged rows (its registry.py:665): (start, fresh)
RAGGED_ROWS = (
    (8, 0),    # empty row: zero fresh tokens
    (11, 1),   # decode row: 1 token, start NOT block-aligned
    (8, 13),   # non-block-divisible chunk length
    (24, 8),   # max-block row: the full M*Bs context
)


def _np():
    import numpy as np

    return np


def _disjoint_tables(rows: int, m: int):
    """One disjoint block-id table per row, skipping block 0, so a read of a
    padding table slot (which the engine leaves 0) hits an unreferenced,
    poisoned block."""
    np = _np()
    return (1 + np.arange(rows * m, dtype=np.int32)).reshape(rows, m)


def _ragged_geometry(rows, tq: int = 8):
    np = _np()
    starts = [int(r[0]) for r in rows]
    fresh = [int(r[1]) for r in rows]
    lens = [st + f for st, f in zip(starts, fresh)]
    offs = [int(x) for x in np.concatenate([[0], np.cumsum(fresh)[:-1]])]
    total = sum(fresh)
    t = max(tq, _cdiv(total, tq) * tq)
    sid = np.full(t, -1, np.int32)
    for r, (off, f) in enumerate(zip(offs, fresh)):
        sid[off:off + f] = r
    return starts, lens, offs, sid, t


def quantize_cache(cache, hk: int):
    """f32 cache [L, N, 2, Bs, Hk*D] -> QuantKvCache with the token-minor,
    tile-padded scale layout (the JAX registry's quantize_audit_cache)."""
    from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, pad_scales, quantize_kv_rows

    l, n, _, bs, hkd = cache.shape
    d = hkd // hk
    q8, sc = quantize_kv_rows(cache.reshape(l, n, 2, bs, hk, d))
    return QuantKvCache(q8.reshape(l, n, 2, bs, hkd).contiguous(),
                        pad_scales(sc.transpose(-1, -2)).contiguous())


def _t(x, dtype=None):
    import torch

    t = torch.as_tensor(x)
    return t.to(dtype) if dtype is not None else t


def _held_slots(n_blocks: int, valid, bt, bs: int, slots: int):
    """[N, slots] bool: the block slots some row's first ``valid[r]``
    context slots hold.  Every other slot, and every unreferenced block,
    is poisoned."""
    import torch

    keep = torch.zeros(n_blocks, slots, dtype=torch.bool)
    for r in range(bt.shape[0]):
        for ti in range(bt.shape[1]):
            n = max(0, min(bs, int(valid[r]) - ti * bs))
            keep[int(bt[r, ti]), :n] = True
    return keep


def poison(case: dict, inp: dict) -> dict:
    """A copy of ``inp`` with NaN wherever no live lane may read: the paged
    cache past each row's context and in every unreferenced block (for an
    int8 cache its f32 scales, pad lanes included), fresh q/k/v rows past
    each prefill row's tokens and ragged tokens in no span, the weights and
    scales of experts no row routes to.  The matmul has no padding."""
    import torch

    from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, is_quant

    g = case["geometry"]
    out = dict(inp)
    kind = case["kernel"]
    nan = float("nan")
    if kind.startswith(("paged_decode", "paged_prefill", "ragged")):
        bt = inp["block_tables"].cpu()
        valid = g["lens"] if kind.startswith("paged_decode") else g["starts"]
        cache = inp["cache"]
        bs = g["bs"]
        if is_quant(cache):
            keep = _held_slots(cache.scale.shape[1], valid, bt, bs, cache.scale.shape[-1]).to(cache.scale.device)
            hk = g["hk"]
            sc = torch.full_like(cache.scale, nan)
            live = keep[None, :, None, None, :].expand(sc.shape[0], -1, 2, hk, -1)
            sc[..., :hk, :] = torch.where(live, cache.scale[..., :hk, :], sc[..., :hk, :])
            out["cache"] = QuantKvCache(cache.data, sc.contiguous())
        else:
            keep = _held_slots(cache.shape[1], valid, bt, bs, bs).to(cache.device)
            out["cache"] = torch.where(keep[None, :, None, :, None], cache,
                                       torch.full_like(cache, nan)).contiguous()
        if kind.startswith("paged_prefill"):
            idx = torch.arange(g["s"], device=inp["q"].device)
            fresh = torch.as_tensor([n - st for st, n in zip(g["starts"], g["lens"])],
                                    device=inp["q"].device)
            pad = idx[None, :] >= fresh[:, None]
        elif kind.startswith("ragged"):
            pad = torch.as_tensor(g["sid"] < 0, device=inp["q"].device)[None]
        else:
            return out
        for name in ("q", "k_new", "v_new"):
            x = inp[name]
            out[name] = torch.where(pad[..., None, None], torch.full_like(x, nan), x).contiguous()
        return out
    if kind.startswith("grouped"):
        counts = torch.as_tensor(g["counts"], device=inp["x"].device)
        dead = (counts == 0)[:, None, None]
        wname = "wq" if kind.endswith("_q8") else "w"
        if kind.endswith("_q8"):
            out["scale"] = torch.where(dead, torch.full_like(inp["scale"], nan), inp["scale"])
        else:
            out["w"] = torch.where(dead, torch.full_like(inp["w"], nan), inp["w"])
        out[wname] = out[wname].contiguous()
    return out


# ------------------------------------------------------- the run cases ----


def _attention_inputs(kind: str, g: dict, seed: int, device, dtype) -> dict:
    """A case's inputs, drawn from ``seed`` in the JAX registry's order:
    the f32 cache [L, N, 2, Bs, Hk*D], then q (and k_new, v_new); the
    cache quantised for an int8 kernel."""
    import torch

    np = _np()
    rng = np.random.default_rng(seed)
    rows = len(g["lens"])
    n = rows * g["m"] + 1
    hkd = g["hk"] * g["d"]
    cache = torch.as_tensor(rng.normal(size=(_L, n, 2, g["bs"], hkd)), dtype=torch.float32)
    bt = _disjoint_tables(rows, g["m"])
    if kind.startswith("paged_decode"):
        q = rng.normal(size=(rows, g["s"], g["h"], g["d"]))
        fresh = {}
    else:
        lead = (rows, g["s"]) if kind.startswith("paged_prefill") else (1, g["t"])
        q = rng.normal(size=lead + (g["h"], g["d"]))
        fresh = {"k_new": rng.normal(size=lead + (g["hk"], g["d"])),
                 "v_new": rng.normal(size=lead + (g["hk"], g["d"]))}
    quant = kind.endswith("_q8")
    data_dtype = dtype if not quant else None
    kc = quantize_cache(cache, g["hk"]) if quant else cache.to(data_dtype)
    inp = {"q": torch.as_tensor(q, dtype=torch.float32).to(dtype),
           **{k: torch.as_tensor(v, dtype=torch.float32).to(dtype) for k, v in fresh.items()},
           "cache": kc, "block_tables": torch.as_tensor(bt),
           "layer": 1 if not kind.startswith("paged_prefill") else 0}
    i32 = torch.int32
    if kind.startswith("paged_decode"):
        inp.update(seq_lens=_t(g["lens"], i32), q0_pos=_t(g["q0"], i32))
    elif kind.startswith("paged_prefill"):
        inp.update(seq_lens=_t(g["lens"], i32), start=_t(g["starts"], i32))
    else:
        inp.update(seq_lens=_t(g["lens"], i32), starts=_t(g["starts"], i32),
                   row_offsets=_t(g["offs"], i32))
    return to_device(inp, device)


def to_device(inp: dict, device) -> dict:
    """``inp`` with every tensor (and an int8 cache's two) on ``device``."""
    from dynamo_tpu_torch.ops.kv_quant import QuantKvCache

    out = {}
    for k, v in inp.items():
        if isinstance(v, QuantKvCache):
            v = QuantKvCache(v.data.to(device), v.scale.to(device))
        elif hasattr(v, "to"):
            v = v.to(device)
        out[k] = v
    return out


_DECODE_ARGS = ("q", "cache", "layer", "block_tables", "seq_lens", "q0_pos")
_PREFILL_ARGS = ("q", "k_new", "v_new", "cache", "layer", "block_tables", "seq_lens", "start")
_RAGGED_ARGS = ("q", "k_new", "v_new", "cache", "layer", "block_tables", "seq_lens", "starts",
                "row_offsets")
# each wrapper's positional arguments, by the case input that fills them
ARGS = {
    "paged_decode_attention": _DECODE_ARGS, "paged_decode_attention_q8": _DECODE_ARGS,
    "paged_prefill_attention": _PREFILL_ARGS, "paged_prefill_attention_q8": _PREFILL_ARGS,
    "ragged_paged_prefill_attention": _RAGGED_ARGS, "ragged_paged_prefill_attention_q8": _RAGGED_ARGS,
    "int8_matmul": ("x", "wq", "scale"),
    "grouped_matmul": ("x", "w", "offsets"),
    "grouped_matmul_q8": ("x", "wq", "scale", "offsets"),
}


def call_args(kernel: str, inp: dict) -> tuple:
    """The positional arguments of ``kernel``'s wrapper (and plain
    version) from a case's inputs."""
    return tuple(inp[n] for n in ARGS[kernel])


def run(case: dict, inp: dict):
    """The kernel's wrapper on ``inp``: its plain version for CPU tensors,
    the kernel for CUDA ones."""
    return wrapper_fn(case["kernel"])(*call_args(case["kernel"], inp))


def run_plain(case: dict, inp: dict):
    """The kernel's plain version on ``inp``."""
    return plain_fn(case["kernel"])(*call_args(case["kernel"], inp))


def _attention_masks(kind: str, g: dict, shape):
    """(live, zero) lanes of an attention output: decode rows that hold a
    context (and their zero-length rows, exactly 0); prefill tokens below
    each row's fresh count (padding rows exactly 0); ragged tokens in a span
    (tokens in none exactly 0)."""
    np = _np()
    if kind.startswith("paged_decode"):
        lens = np.asarray(g["lens"])
        live = (lens > 0)[:, None, None, None]
        zero = (lens == 0)[:, None, None, None]
    elif kind.startswith("paged_prefill"):
        fresh = np.asarray(g["lens"]) - np.asarray(g["starts"])
        live = (np.arange(g["s"])[None, :] < fresh[:, None])[:, :, None, None]
        zero = ~live
    else:
        live = (g["sid"] >= 0)[None, :, None, None]
        zero = ~live
    return np.broadcast_to(live, shape).copy(), np.broadcast_to(zero, shape).copy()


def lanes(case: dict, shape):
    """(live, zero) boolean numpy masks of a run case's output: the lanes
    the oracle holds and the padding and zero-length lanes that must be
    exactly 0 (every lane of a product is live)."""
    np = _np()
    kind = case["kernel"]
    if kind.startswith(("paged_", "ragged")):
        return _attention_masks(kind, case["geometry"], shape)
    return np.ones(shape, bool), np.zeros(shape, bool)


def _attention_oracle(kind: str, g: dict, inp: dict):
    """The port's plain serving ops of ``ops/paged_attention.py`` on the CPU
    (independent of the kernels' plain versions): the decode op over the
    whole table, the prefill op, the ragged op (JAX's oracle)."""
    import torch

    from dynamo_tpu_torch.ops import paged_attention as pa

    if kind.startswith("paged_decode"):
        pos = inp["q0_pos"][:, None].long() + torch.arange(g["s"])[None, :]
        return pa.paged_attention_layer(inp["q"], inp["cache"], inp["layer"], inp["block_tables"],
                                        inp["seq_lens"], pos.to(torch.int32))
    if kind.startswith("paged_prefill"):
        pb = _cdiv(max(g["starts"]), g["bs"])
        return pa.prefill_attention(inp["q"], inp["k_new"], inp["v_new"], inp["cache"], inp["layer"],
                                    inp["block_tables"], inp["seq_lens"], inp["start"], pb)
    pb = _cdiv(max(g["starts"]), g["bs"]) if g["starts"] else 0
    sid = torch.as_tensor(g["sid"])[None]
    return pa.ragged_prefill_attention(inp["q"], inp["k_new"], inp["v_new"], inp["cache"], inp["layer"],
                                       inp["block_tables"], inp["seq_lens"], inp["starts"],
                                       inp["row_offsets"], sid, pb)


def _case(name, kernel, mode, geometry, **kw) -> dict:
    case = {"name": name, "kernel": kernel, "mode": mode, "geometry": geometry, "atol": 2e-4}
    case.update(kw)
    return case


# the fp16 cases' canary tolerance on the CPU, where the plain version and
# the oracle both round their outputs to fp16: one ulp at the attention
# outputs' magnitude (|out| < 4, ulp 2^-9 ~ 2e-3; over an int8 cache < 8,
# 2^-8), and for the W8A16 product (|out| < 1,024 at K = 1,024) one ulp,
# 0.5, beside the f32 oracle's half-ulp rounding
FP16_ATOL = {"attention": 2e-3, "attention_q8": 4e-3, "matmul": 1.0}


def fp16_twin(case: dict, atol: float) -> dict:
    """``case``'s float16 twin: the same geometry and seed, its inputs (q,
    the fresh K/V, a float cache, x) and outputs in float16; named with
    ``fp16`` in place of ``bf16``, or after the name."""
    name = case["name"]
    name = name.replace("-bf16", "-fp16") if "-bf16" in name else f"{name}-fp16"
    return dict(case, name=name, dtype="float16", atol=atol)


def _decode_case(name: str, quant: bool, s: int = 1, lens=None) -> dict:
    b = len(lens) if lens is not None else (8 if s == 1 else 4)
    if lens is None:
        # empty row, 1-token row, block-exact, non-divisible, max-table;
        # multi-query rows with first-query positions off the block
        lens = ([1, _M * _BS, 11, 0, _BS, 5, 17, 29] if s == 1 else [7, _M * _BS, 2, 19])
    g = {"b": b, "s": s, "h": _H, "hk": _HK, "d": _D, "m": _M, "bs": _BS, "lens": list(lens),
         "q0": [max(n - s, 0) for n in lens]}
    kernel = "paged_decode_attention_q8" if quant else "paged_decode_attention"
    return _case(name, kernel, "run", g, seed=101 if quant else 100,
                 atol=2e-3 if quant else 2e-4)


def _prefill_case(name: str, quant: bool, starts, lens, s: int, bs: int = _BS, m: int = _M,
                  seed: int = 200) -> dict:
    g = {"b": len(starts), "s": s, "h": _H, "hk": _HK, "d": _D, "m": m, "bs": bs,
         "starts": list(starts), "lens": list(lens)}
    kernel = "paged_prefill_attention_q8" if quant else "paged_prefill_attention"
    return _case(name, kernel, "run", g, seed=seed + (1 if quant else 0),
                 atol=2e-3 if quant else 2e-4)


def _ragged_case(name: str, quant: bool, rows=RAGGED_ROWS, seed: int = 300, tq: int = 8) -> dict:
    starts, lens, offs, sid, t = _ragged_geometry(rows, tq)
    g = {"t": t, "h": _H, "hk": _HK, "d": _D, "m": _M, "bs": _BS, "starts": starts, "lens": lens,
         "offs": offs, "sid": sid}
    kernel = "ragged_paged_prefill_attention_q8" if quant else "ragged_paged_prefill_attention"
    return _case(name, kernel, "run", g, seed=seed + (1 if quant else 0),
                 atol=2e-3 if quant else 2e-4)


def _int8_matmul_case() -> dict:
    # JAX's: grid (2, 2, 2) there, revisiting K
    return _case("int8-matmul", "int8_matmul", "run", {"m": 256, "k": 1024, "n": 1024}, seed=400,
                 atol=8.0)


# the grouped cases' experts: 8 experts of [128, 64] (N a multiple of 16
# for the int8 kernel), top 2; a few experts get no row
_MOE_E, _MOE_TOPK, _MOE_K, _MOE_N = 8, 2, 128, 64


def _moe_counts(t: int, seed: int) -> list[int]:
    """Rows per expert for t tokens' top-2 experts, drawn from ``seed`` over
    the first 6 of 8 experts (so two get nothing)."""
    np = _np()
    rng = np.random.default_rng(seed)
    picks = np.stack([rng.choice(6, size=_MOE_TOPK, replace=False) for _ in range(t)])
    counts = np.bincount(picks.ravel(), minlength=_MOE_E)
    return [int(c) for c in counts]


def _moe_case(name: str, quant: bool, t: int) -> dict:
    seed = 500 + t + (1 if quant else 0)
    counts = _moe_counts(t, seed)
    g = {"r": t * _MOE_TOPK, "e": _MOE_E, "k": _MOE_K, "n": _MOE_N, "counts": counts,
         "t": t, "top_k": _MOE_TOPK}
    kernel = "grouped_matmul_q8" if quant else "grouped_matmul"
    return _case(name, kernel, "run", g, seed=seed, atol=4e-2)


def build(case: dict, device="cpu", dtype=None) -> dict:
    """A run case's inputs from its numpy seed, on ``device``; attention q,
    k_new, v_new and a float cache in ``dtype`` (f32 on the CPU by default,
    bf16 for the kernels), or in the case's own ``dtype`` (an fp16 case:
    float16 everywhere, the W8A16 product's x too)."""
    import torch

    np = _np()
    kind, g = case["kernel"], case["geometry"]
    dtype = getattr(torch, case["dtype"]) if "dtype" in case else dtype or torch.float32
    if kind.startswith(("paged_", "ragged")):
        return _attention_inputs(kind, g, case["seed"], device, dtype)
    rng = np.random.default_rng(case["seed"])
    if kind == "int8_matmul":
        x_dtype = torch.float16 if case.get("dtype") == "float16" else torch.bfloat16
        x = torch.as_tensor(rng.normal(size=(g["m"], g["k"])), dtype=torch.float32).to(x_dtype)
        wq = torch.as_tensor(rng.integers(-127, 128, size=(g["k"], g["n"])), dtype=torch.int8)
        scale = torch.as_tensor(rng.uniform(0.01, 0.1, size=(g["n"],)), dtype=torch.float32)
        return to_device({"x": x, "wq": wq, "scale": scale}, device)
    e, k, n = g["e"], g["k"], g["n"]
    x = torch.as_tensor(rng.normal(size=(g["r"], k)), dtype=torch.float32).to(torch.bfloat16)
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(g["counts"])]), dtype=torch.int32)
    if kind.endswith("_q8"):
        wq = torch.as_tensor(rng.integers(-127, 128, size=(e, k, n)), dtype=torch.int8)
        scale = torch.as_tensor(rng.uniform(0.5, 1.5, size=(e, 1, n)) / (73.3 * math.sqrt(k)),
                                dtype=torch.float32)
        return to_device({"x": x, "wq": wq, "scale": scale, "offsets": offsets}, device)
    w = torch.as_tensor(rng.normal(size=(e, k, n)) / math.sqrt(k), dtype=torch.float32)
    return to_device({"x": x, "w": w.to(torch.bfloat16), "offsets": offsets}, device)


def oracle(case: dict, inp: dict):
    """(reference f32 numpy, live lanes, zero lanes) of a run case on CPU
    inputs, from an implementation the wrapper's plain version does not
    share."""
    np = _np()
    kind, g = case["kernel"], case["geometry"]
    if kind.startswith(("paged_", "ragged")):
        ref = _attention_oracle(kind, g, inp).float().numpy()
        return (ref, *lanes(case, ref.shape))
    if kind == "int8_matmul":
        x = inp["x"].float().numpy()
        ref = (x @ inp["wq"].float().numpy()) * inp["scale"].numpy()[None, :]
        return (ref, *lanes(case, ref.shape))
    x = inp["x"].float().numpy()
    w = (inp["wq"] if kind.endswith("_q8") else inp["w"]).float().numpy()
    if kind.endswith("_q8"):
        w = w * inp["scale"].numpy()
    off = np.concatenate([[0], np.cumsum(g["counts"])])
    ref = np.zeros((g["r"], g["n"]), np.float32)
    for e in range(g["e"]):
        ref[off[e]:off[e + 1]] = x[off[e]:off[e + 1]] @ w[e]
    return (ref, *lanes(case, ref.shape))


# ------------------------------------------ the serving shapes (spec) ----

# PERF.md §6's serving shapes: Llama-3-8B attention (H 32, Hk 8, D 128), a
# 2,048-slot table, Bs 16 for bf16 caches and 32 for int8 ones
_SH, _SHK, _SD = 32, 8, 128
# the largest mixed dispatches the token-budget serving runs recorded
# (chip_smoke.py's ragged_timing): T = 1,024, decode rows in a decode
# region of one block, then block-rounded spans (tools/cuda_timing.py
# ragged_layout)
_RAGGED_SERVING = {
    16: ([25, 308, 648, 1056, 0, 0, 0, 0], [26, 309, 649, 1500, 356, 0, 0, 0], [0, 1, 2, 16, 464, 0, 0, 0]),
    32: ([25, 308, 648, 1024, 0, 0, 0, 0], [26, 309, 649, 1500, 356, 0, 0, 0], [0, 1, 2, 32, 512, 0, 0, 0]),
}
# one DeepSeek-V2-Lite MoE layer (deepseek-ai/DeepSeek-V2-Lite config.json)
V2_LITE_MOE = (64, 6, {"w_gate": (2048, 1408), "w_up": (2048, 1408), "w_down": (1408, 2048)})
# experts the timed layers' uniform routing reached, by (model, int8, T),
# as chip_smoke.py's moe timing logged them (NVIDIA H100 80GB HBM3)
_MOE_LIVE = {("qwen3", False, 8): 56, ("qwen3", False, 1504): 128, ("qwen3", True, 8): 54,
             ("qwen3", True, 1504): 128, ("v2lite", False, 8): 30, ("v2lite", False, 1504): 64}


def _spec_decode(name, quant, s, bs):
    m = 2048 // bs
    g = {"b": len(DECODE_LENS), "s": s, "h": _SH, "hk": _SHK, "d": _SD, "m": m, "bs": bs,
         "lens": list(DECODE_LENS), "q0": [max(n - s, 0) for n in DECODE_LENS]}
    return _case(name, "paged_decode_attention_q8" if quant else "paged_decode_attention", "spec", g)


def _spec_moe(name, quant, model, t):
    experts, top_k, launches = ((MOE_EXPERTS, MOE_TOP_K, MOE_LAUNCHES) if model == "qwen3"
                                else V2_LITE_MOE)
    live = _MOE_LIVE[(model, quant, t)]
    calls = [{"r": t * top_k, "e": experts, "k": k, "n": n, "live": live} for k, n in launches.values()]
    return _case(name, "grouped_matmul_q8" if quant else "grouped_matmul", "spec", {"calls": calls})


def serving_cases() -> list[dict]:
    """A spec-only case at each serving shape PERF.md §6 times, the
    geometry its bound was computed at: decode (B = 8, S = 1, 5, 8) and the
    verify, the 1,504-token prefill, the int8 prefix hit (256 + 700), the
    T = 1,024 mixed dispatches, one layer's seven W8A16 projections at M =
    8, 40 and 1,504, and one MoE layer's three grouped launches."""
    cases = []
    for quant, bs in ((False, 16), (True, 32)):
        tag = "decode-int8" if quant else "decode"
        cases += [_spec_decode(f"{tag}-serving", quant, 1, bs),
                  _spec_decode(f"{tag}-serving-s5", quant, 5, bs),
                  _spec_decode(f"{tag}-serving-s8", quant, 8, bs)]
    cases.append(_case("prefill-serving", "paged_prefill_attention", "spec",
                       {"b": 1, "s": 1504, "h": _SH, "hk": _SHK, "d": _SD, "m": 128, "bs": 16,
                        "starts": [0], "lens": [1500]}))
    cases.append(_case("prefill-int8-serving", "paged_prefill_attention_q8", "spec",
                       {"b": 1, "s": 704, "h": _SH, "hk": _SHK, "d": _SD, "m": 64, "bs": 32,
                        "starts": [256], "lens": [956]}))
    for quant, bs in ((False, 16), (True, 32)):
        starts, lens, offs = _RAGGED_SERVING[bs]
        cases.append(_case("ragged-int8-serving" if quant else "ragged-serving",
                           "ragged_paged_prefill_attention_q8" if quant else "ragged_paged_prefill_attention",
                           "spec", {"t": 1024, "h": _SH, "hk": _SHK, "d": _SD, "m": 2048 // bs, "bs": bs,
                                    "starts": starts, "lens": lens, "offs": offs}))
    for m in (8, 40, 1504):
        cases.append(_case(f"matmul-serving-m{m}", "int8_matmul", "spec",
                           {"calls": [{"m": m, "k": k, "n": n} for k, n in PROJECTIONS.values()]}))
    for t in (8, 1504):
        cases.append(_spec_moe(f"moe-serving-t{t}", False, "qwen3", t))
        cases.append(_spec_moe(f"moe-v2lite-serving-t{t}", False, "v2lite", t))
        cases.append(_spec_moe(f"moe-int8-serving-t{t}", True, "qwen3", t))
    return cases


def audit_cases() -> list[dict]:
    """The committed audit matrix: every non-placeholder kernel by its run
    cases (the plain versions on the CPU, and on the card the kernels
    against them, NaN-poisoned) and its spec-only serving shapes."""
    cases = [
        _decode_case("decode-bf16", quant=False),
        _decode_case("decode-int8", quant=True),
        _decode_case("decode-mq-unaligned", quant=False, s=2),
    ]
    for s in (5, 8):
        lens = [s + 2, _M * _BS, 0, 29]  # q0 off the block; a zero-length row
        cases.append(_decode_case(f"decode-verify-s{s}", quant=False, s=s, lens=lens))
        cases.append(_decode_case(f"decode-int8-verify-s{s}", quant=True, s=s, lens=lens))
    cases += [
        # JAX's: a 1-block prefix and none; row 1 has 3 padding tail rows
        _prefill_case("prefill-bf16", False, [8, 0], [24, 13], 16),
        # the int8 prefix hit of the serving run (256 + 700, Bs 32) beside
        # JAX's non-divisible row from 0
        _prefill_case("prefill-int8", True, [256, 0], [956, 13], 704, bs=32, m=30),
        _ragged_case("ragged-bf16", quant=False),
        _ragged_case("ragged-int8", quant=True),
        _int8_matmul_case(),
        _moe_case("moe-bf16-t8", False, 8),
        _moe_case("moe-bf16-t1504", False, 1504),
        _moe_case("moe-int8-t8", True, 8),
        _moe_case("moe-int8-t1504", True, 1504),
        # JAX's serving-scale spec cases
        _case("decode-8b", "paged_decode_attention", "spec",
              {"b": 64, "s": 1, "h": 32, "hk": 8, "d": 128, "m": 128, "bs": 16, "lens": [2048] * 64,
               "q0": [2047] * 64}),
        _case("prefill-8b", "paged_prefill_attention", "spec",
              {"b": 1, "s": 2048, "h": 32, "hk": 4, "d": 128, "m": 128, "bs": 16, "starts": [0],
               "lens": [2048]}),
    ]
    cases += fp16_cases(cases)
    return cases + serving_cases()


# the fp16 bodies' run cases: each attention kernel at S = 1 (decode also at
# the verify's S = 8), the prefill and ragged kernels at their bf16 cases'
# rows, the W8A16 product at JAX's geometry
FP16_TWINS = ("decode-bf16", "decode-int8", "decode-verify-s8", "decode-int8-verify-s8",
              "prefill-bf16", "prefill-int8", "ragged-bf16", "ragged-int8", "int8-matmul")


def fp16_cases(cases: list[dict]) -> list[dict]:
    """The float16 twins of :data:`FP16_TWINS` among ``cases``."""
    by_name = {c["name"]: c for c in cases}
    out = []
    for name in FP16_TWINS:
        c = by_name[name]
        kind = ("matmul" if c["kernel"] == "int8_matmul"
                else "attention_q8" if c["kernel"].endswith("_q8") else "attention")
        out.append(fp16_twin(c, FP16_ATOL[kind]))
    return out


def fuzz_case(seed: int) -> dict:
    """One seeded random ragged geometry (the JAX registry's fuzz_case):
    rows from the adversarial families (empty, 1-token decode, odd-length
    chunk from a block start, max-block), canary-checked, never in the
    manifest.  Deterministic per seed: the replay token is the seed."""
    np = _np()
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(int(rng.integers(2, 6))):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            rows.append((int(rng.integers(0, _M * _BS)), 0))
        elif kind == 1:
            rows.append((int(rng.integers(0, _M * _BS - 1)), 1))
        elif kind == 2:
            start = int(rng.integers(0, _M - 1)) * _BS
            rows.append((start, int(rng.integers(1, _M * _BS - start + 1))))
        else:
            start = int(rng.integers(0, _M)) * _BS
            rows.append((start, _M * _BS - start))
    if all(f == 0 for _, f in rows):
        rows[0] = (0, 1)
    return _ragged_case(f"fuzz[ragged-{seed}]", quant=bool(rng.integers(0, 2)), rows=tuple(rows),
                        seed=seed)

