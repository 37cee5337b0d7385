"""Launch planning of the W8A16 matmul (B5), paged prefill (B2, B4b), ragged prefill (B3, B4c) and grouped expert matmul (E1, E2) kernels.

The wrappers decide in plain Python how each CUDA kernel is launched, from
the geometry the kernels compile with (``csrc/launch_geometry.cuh``, read
by ``build.geometry``): B5's regime (decode below 17 rows, wgmma above),
its tiles, its split of K and its scratch; B2's grid of (KV head, row,
query tile) blocks and its K/V tile, which B4b launches too; the ragged kernels' grid of decode-row
and span blocks; the grouped kernels' row tile and their persistent grid,
whose blocks walk work items they find from the device offsets
(``grouped_matmul.tile_schedule`` is that walk in Python).
These tests hold those plans, on the
CPU, at every Llama-3-8B matmul shape, at ragged shapes, and at the head
geometries the prefill wrapper accepts: every output element is covered by
exactly one tile and every depth by exactly one split, no split is empty,
the grid is within CUDA's limits, the scratch holds every split's sums and
the stream's tickets cover the tiles, and each block's shared memory, as the geometry states it,
fits the card.
"""

from __future__ import annotations

import pytest
import torch

from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels import grouped_matmul as gmm
from dynamo_tpu_torch.ops.kernels import int8_matmul as mm
from dynamo_tpu_torch.ops.kernels import prefill_attention as pa
from dynamo_tpu_torch.ops.kernels import ragged_prefill_attention as ra
from dynamo_tpu_torch.tools.cuda_timing import RAGGED_MIXED, RAGGED_PACKED, ragged_layout

SMS = 132  # an H100 SXM
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper
GRID_X_MAX, GRID_YZ_MAX = 2 ** 31 - 1, 65535

# Llama-3-8B's matmuls as the model runs them, [K, N], and ragged ones
# (a 32002-token vocabulary, a depth off 16)
SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
          "w_gate": (4096, 14336), "w_up": (4096, 14336), "w_down": (14336, 4096),
          "lm_head": (4096, 128256), "vocab_32002": (4096, 32002), "ragged": (4104, 1000)}
LLAMA_SHAPES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")
ROWS = (1, 6, 8, 16, 17, 64, 65, 300, 1504, 2048)


def _partitions(starts: list[int], width: int, total: int) -> bool:
    """Whether ranges [s, s + width) clipped to [0, total) cover it once."""
    covered = 0
    for s in sorted(starts):
        if s != covered or s >= total:
            return False
        covered = min(total, s + width)
    return covered == total


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_int8_matmul_plan(name, m, layout):
    k, n = SHAPES[name]
    # the kernel reads a [K, N] weight, or the transpose of an [N, K] one, in place
    w = torch.empty((k, n) if layout == "kn" else (n, k), dtype=torch.int8, device="meta")
    lay, nk = mm._weight_layout(w if layout == "kn" else w.t())
    assert nk == (layout == "nk") and lay.is_contiguous()

    p = mm.plan(m, n, k, SMS)
    g = build.geometry()
    assert p.regime == ("decode" if m <= g["B5_DECODE_MAX_M"] else "prefill")
    gx, gy, gz = p.grid
    assert 1 <= gx <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX and 1 <= gz <= GRID_YZ_MAX
    assert gz == p.splits and p.threads <= 1024 and p.threads % 128 == 0
    # output tiles: N by bn columns, M by bm rows (the decode kernel holds
    # every row of M <= 16 in its token fragments)
    assert _partitions([x * p.bn for x in range(gx)], p.bn, n)
    if p.regime == "decode":
        assert gy == 1 and m <= p.bm <= 16
    else:
        assert _partitions([y * p.bm for y in range(gy)], p.bm, m)
    # depth: the splits partition [0, K) and none is empty
    span = p.k_steps * p.bk
    assert _partitions([z * span for z in range(gz)], span, k)
    assert (gz - 1) * span < k
    # enough blocks for the card: at least two per SM in the decode regime
    # (every Llama-3-8B shape); K split only while the tiles leave block
    # slots idle (four per SM decoding, one in the wgmma regime), and never
    # past one wave of them
    slots = (4 if p.regime == "decode" else 1) * SMS
    if p.regime == "decode" and name in LLAMA_SHAPES:
        assert gx * gz >= 2 * SMS
    if gz > 1:
        assert gx * gy < slots and gx * gy * gz <= slots
    # split K: one f32 slice [M, N rounded up to 4] per split, none
    # without a split, and a ticket per output tile in the stream's buffer
    assert p.scratch == (gz * m * (-(-n // 4) * 4) if gz > 1 else 0)
    if gz > 1:
        assert gx * gy <= mm.ticket_capacity(SMS)
    assert p.smem == g["B5_DC_SMEM" if p.regime == "decode" else "B5_PF_SMEM"] <= SMEM_LIMIT


def test_int8_matmul_split_k_scratch_lives_through_the_launch(monkeypatch):
    """A split-K launch's partials are held by a live tensor when the
    kernel is enqueued.  Freed before it, the caching allocator could give
    the block to a tensor another thread (a second engine on the same
    stream) enqueues work on ahead of the launch, and the partials would
    overwrite it.  The CUDA branch runs here on CPU tensors against a
    stand-in library that checks the pointer's owner is alive."""
    import weakref

    m, (k, n) = 8, SHAPES["wq"]
    p = mm.plan(m, n, k, SMS)
    assert p.splits > 1
    scratches = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        if shape == (p.scratch,) and kw.get("dtype") is torch.float32:
            scratches.append(weakref.ref(t))
        return t

    class Library:
        def dynamo_int8_matmul(self, x, w, scale, out, partials, tickets, *dims):
            (owner,) = scratches
            assert owner() is not None and owner().data_ptr() == partials
            launched.append(dims)
            return 0

    launched = []
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(build, "sm_count", lambda index=0: SMS)
    monkeypatch.setattr(build, "library", Library)
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    w = torch.zeros((k, n), dtype=torch.int8)
    mm._launch(x, w, torch.ones(n), torch.bfloat16)
    assert len(launched) == 1 and launched[0][-3] == p.splits


@pytest.mark.parametrize("s", [1, 17, 1504])
@pytest.mark.parametrize("d", pa.HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 4, 8, 64])
def test_prefill_attention_plan(group, d, s):
    hk, b = 8 if group < 64 else 1, 3
    p = pa.plan(b, s, group * hk, hk, d)
    gx, gy, gz = p.grid
    assert (gx, gy) == (hk, b) and 1 <= gz <= GRID_YZ_MAX and p.threads <= 1024
    # a block's rows are its tq tokens times the group's query heads
    g = build.geometry()
    assert p.group == group and 1 <= p.tq * group <= g["B2_ROWS"]
    # block z holds tokens [tq * (tiles - 1 - z), + tq): the longest causal
    # tile first, and the tiles cover the S tokens exactly once
    firsts = [p.tq * (gz - 1 - z) for z in range(gz)]
    assert firsts == sorted(firsts, reverse=True)
    assert _partitions(firsts, p.tq, s)
    # K/V tiles: whole 16-key wgmma steps; fewer keys at D = 256
    assert p.keys % 16 == 0 and p.keys == (32 if d == 256 else 64)
    assert p.smem == g[f"B2_SMEM_D{d}"] <= SMEM_LIMIT


def test_prefill_plan_covers_every_group_the_wrapper_takes():
    for group in range(1, pa.MAX_GROUP + 1):
        p = pa.plan(1, 1000, group, 1, 128)
        assert p.tq >= 1 and p.tq * group <= build.geometry()["B2_ROWS"]
        assert _partitions([p.tq * z for z in range(p.grid[2])], p.tq, 1000)


@pytest.mark.parametrize("d", pa.HEAD_DIMS)
def test_int8_prefill_takes_the_bf16_plan(d):
    """B4b launches B2's plan for every group the wrapper accepts: the same
    blocks and tiles; only the shared memory grows by the int8 staging."""
    g = build.geometry()
    for group in range(1, pa.MAX_GROUP + 1):
        for s in (1, 704, 1504):
            p, p8 = pa.plan(2, s, group, 1, d), pa.plan(2, s, group, 1, d, quant=True)
            assert (p8.tq, p8.group, p8.keys, p8.grid, p8.threads) == (p.tq, p.group, p.keys, p.grid, p.threads)
            assert p8.smem == g[f"B2_Q8_SMEM_D{d}"] <= SMEM_LIMIT
            # a prefix tile's int8 K and V rows, and the K and V scales of the
            # ring's tiles and of the staging slots
            extra = g["B2_STAGES"] * (2 * p.keys * d + 2 * 2 * p.keys * 4)
            assert p8.smem == p.smem + extra


# ragged row tables (rows [(start, fresh)], decode region): the serving
# tables kernel_ab.py times, the unified layout with padding rows, spans
# cut by block boundaries, a full 16-row decode region, a 1-token row
# outside the decode region
RAGGED_TABLES = {
    "packed": RAGGED_PACKED,
    "mixed": RAGGED_MIXED,
    "unified": ([(n - 1, 1) for n in (1, 17, 100, 333, 1024, 1500, 2047, 64)] + [(0, 300), (256, 200)], 16),
    "block-boundaries": ([(0, 128), (48, 96), (0, 200)], 0),
    "full-decode-region": ([(n - 1, 1) for n in (1, 2, 17, 63, 64, 65, 100, 128, 129, 333, 640, 1024,
                                                 1025, 1500, 2000, 2047)] + [(0, 90)], 16),
    "one-token-span": ([(5, 1), (80, 150), (160, 1), (16, 45)], 16),
}


def _ragged_blocks(p, starts, lens, offs, t):
    """Which blocks compute each flat token, as the kernel assigns them:
    decode-row block y computes row y's token when the row has one fresh
    token; span block y the tokens [tq * (grid y - 1 - y), + tq) that
    belong to rows of two or more fresh tokens."""
    owner = {}
    for r, (st, n, o) in enumerate(zip(starts, lens, offs)):
        for tok in range(o, o + n - st):
            owner[tok] = r
    blocks = {tok: [] for tok in owner}
    for y in range(p.grid[1]):
        if y < p.decode_blocks:
            if y < len(lens) and lens[y] - starts[y] == 1:
                blocks[offs[y]].append(y)
            continue
        i0 = p.tq * (p.grid[1] - 1 - y)
        for tok in range(i0, min(i0 + p.tq, t)):
            r = owner.get(tok)
            if r is not None and lens[r] - starts[r] > 1:
                blocks[tok].append(y)
    return blocks


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("group", [1, 4, 8, 64])
@pytest.mark.parametrize("table", sorted(RAGGED_TABLES))
def test_ragged_attention_plan(table, group, quant):
    rows, region = RAGGED_TABLES[table]
    bs = 32 if quant else 16
    t, starts, lens, offs = ragged_layout(rows, region, 3, bs)
    hk = 8 if group < 64 else 1
    g = build.geometry()
    for d in pa.HEAD_DIMS:
        p = ra.plan(t, len(lens), group * hk, hk, d, quant)
        assert p.grid == (hk, p.decode_blocks + p.span_blocks) and p.grid[1] <= GRID_YZ_MAX
        assert p.decode_blocks == len(lens) and p.threads == g["B3_THREADS"] <= 1024
        # a span block's rows are its tq tokens times the group's query heads
        assert p.group == group and 1 <= p.tq * group <= g["B3_ROWS"]
        assert _partitions([p.tq * z for z in range(p.span_blocks)], p.tq, t)
        assert p.keys % 16 == 0 and p.keys == (32 if d == 256 else 64)
        key = f"B3_Q8_SMEM_D{d}" if quant else f"B3_SMEM_D{d}"
        assert p.smem == g[key] <= SMEM_LIMIT
    # every live token is computed by exactly one block, and a decode row's
    # token by its own decode-row block and by no span block
    for tok, blocks in _ragged_blocks(p, starts, lens, offs, t).items():
        assert len(blocks) == 1, (tok, blocks)
        r = [i for i, (st, n, o) in enumerate(zip(starts, lens, offs)) if o <= tok < o + n - st][0]
        assert (blocks[0] < p.decode_blocks) == (lens[r] - starts[r] == 1)


def test_ragged_plan_refuses_groups_past_a_decode_block():
    with pytest.raises(ValueError, match="decode-row block"):
        ra.plan(64, 4, 65, 1, 128)


def test_geometry_reads_every_define():
    """The planners see every number the kernels compile with: each
    ``#define`` of the geometry header parses as one integer entry."""
    text = (build.CSRC / "launch_geometry.cuh").read_text()
    defines = [line for line in text.splitlines() if line.startswith("#define")]
    assert len(defines) == len(build.geometry()) > 0


# the grouped expert matmul at Qwen3-30B-A3B's and Mixtral-8x7B's expert
# shapes: (experts, top k, K, N)
GROUPED_SHAPES = {"qwen3-gate/up": (128, 8, 2048, 768), "qwen3-down": (128, 8, 768, 2048),
                  "mixtral-gate/up": (8, 2, 4096, 14336), "mixtral-down": (8, 2, 14336, 4096)}


def _grouping(routing: str, tokens: int, experts: int, k: int) -> list[int]:
    """Rows per expert: uniform (each token's k distinct experts at random),
    every row on one expert, rows on the last expert and one other only, or
    every group one row past a multiple of 16 (the most tiles R rows can
    take, short of the bound's slack)."""
    import numpy as np

    rng = np.random.default_rng(tokens * experts)
    r = tokens * k
    if routing == "uniform":
        topi = np.argsort(rng.random((tokens, experts)), axis=1)[:, :k]
        return np.bincount(topi.ravel(), minlength=experts).tolist()
    counts = [0] * experts
    if routing == "one":
        counts[experts // 3] = r
    elif routing == "two":
        counts[1], counts[-1] = r // 2, r - r // 2
    else:  # "ragged": 16 q + 1 rows each while rows last, the rest on expert 0
        left = r
        for e in range(experts):
            take = min(left, 16 * (e % 3) + 1)
            counts[e], left = take, left - take
        counts[0] += left
    return counts


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("routing", ["uniform", "one", "two", "ragged"])
@pytest.mark.parametrize("tokens", [1, 8, 1504, 3765])
@pytest.mark.parametrize("name", list(GROUPED_SHAPES))
def test_grouped_matmul_plan(name, tokens, routing, quant):
    """Every (row, channel) is computed by exactly one work item, of its
    own expert, over the whole depth (the kernel does not split K); the row
    tile follows the mean group; no grouping makes more row tiles than the
    plan's bound, which sizes the grid; the persistent grid is at most the
    blocks per SM the geometry gives this row tile, walks every item once, and leaves no block idle while any
    other has two items more than it; the grid is within CUDA's limits and
    the block's shared memory fits."""
    experts, k, kd, n = GROUPED_SHAPES[name]
    counts = _grouping(routing, tokens, experts, k)
    r = tokens * k
    assert sum(counts) == r
    p = gmm.plan(r, experts, n, kd, quant, SMS)
    g = build.geometry()
    want_rows = (g["GMM_ROWS_PREFILL"] if r >= g["GMM_PREFILL_FROM"] * experts else
                 g["GMM_ROWS_MID"] if r >= g["GMM_MID_FROM"] * experts else g["GMM_ROWS_DECODE"])
    assert p.rows == want_rows
    assert p.grid_n == -(-n // p.channels)
    assert _partitions([p.channels * i for i in range(p.grid_n)], p.channels, n)
    tiles = sum(-(-c // p.rows) for c in counts)
    assert tiles <= p.max_tiles
    assert p.blocks == min(g[f"GMM_BLOCKS_PER_SM_{'Q8' if quant else 'BF16'}_R{p.rows}"] * SMS,
                            p.max_tiles * p.grid_n)
    assert 1 <= p.blocks <= GRID_X_MAX
    assert p.smem <= SMEM_LIMIT and p.threads == g["GMM_THREADS"]
    sched = gmm.tile_schedule(counts, p.rows, p.grid_n, p.blocks, p.channels)
    assert len(sched) == p.blocks
    loads = [len(mine) for mine in sched]
    assert sum(loads) == tiles * p.grid_n and max(loads) - min(loads) <= 1
    owner = [e for e, c in enumerate(counts) for _ in range(c)]
    seen = [[0] * p.grid_n for _ in range(r)]
    for mine in sched:
        for e, row0, rows, n0 in mine:
            assert 1 <= rows <= p.rows and n0 % p.channels == 0 and 0 <= n0 < n
            for row in range(row0, row0 + rows):
                assert owner[row] == e
                seen[row][n0 // p.channels] += 1
    assert seen == [[1] * p.grid_n for _ in range(r)]


def test_grouped_bound_covers_the_worst_grouping():
    """Groups one row past a multiple of the tile take the most tiles R rows
    can: here a quarter of the experts hold rows + 1 rows and the rest one,
    (R - E) / rows + E tiles, which is the plan's bound (R + E (rows - 1))
    // rows at each of the three row tiles (the mean group 1 + rows / 4
    picks that tile): the bound holds and is reached.  With fewer rows than
    experts it is R (a tile a row), which one row on each of R experts
    reaches."""
    experts = 128
    g = build.geometry()
    for rows in (g["GMM_ROWS_DECODE"], g["GMM_ROWS_MID"], g["GMM_ROWS_PREFILL"]):
        counts = [rows * (e % 4 == 0) + 1 for e in range(experts)]
        r = sum(counts)
        tiles = len(gmm.tile_schedule(counts, rows, 1, 1)[0])
        p = gmm.plan(r, experts, 768, 2048, True, SMS)
        assert p.rows == rows
        assert tiles == (r - experts) // rows + experts == p.max_tiles
    p = gmm.plan(64, experts, 768, 2048, True, SMS)
    assert p.rows == g["GMM_ROWS_DECODE"] and p.max_tiles == 64
    assert len(gmm.tile_schedule([1] * 64 + [0] * 64, p.rows, 1, 1)[0]) == p.max_tiles
