"""The decode attention kernel's launch plan and its algorithm, on the CPU.

One kernel serves a bf16 cache (B1) and an int8 one (B4a), compiled for
each with its own stages, block budget and shared memory; every test here
runs for both cache kinds.  The CUDA kernel cannot run here, so what
surrounds it is held in Python:

* the planner (``decode_attention.plan``, from ``csrc/launch_geometry.cuh``)
  at Bs 16 and 32, D 64/128/256, 1 to 64 rows and tables of 2048 to 32768
  slots: the chunk is the shortest whose full-table grid fits the cache
  kind's block budget and whose rows merge at most MAX_CHUNKS partials; the
  chunks a row's blocks compute (the kernel's ``ceil(ctx / chunk)`` rule) cover every live token of the row exactly
  once, for contexts 0, 1, a chunk edge -1/0/+1 and the table's width; the
  ticket of each (row, KV head, row group) counts ``ceil(seq_len / chunk)``
  arrivals; each chunk's 16-key tiles, dealt to the block's four warps as
  the kernel deals them, cover its keys once; the row groups cover the
  S * G query rows once; the grid, the workspace and the shared memory fit;
* the per-stream partials and tickets: bounded at any table width, reused
  while large enough, and kept alive once a CUDA graph captured them;
* a plain f32 emulation of the kernel's arithmetic, tile by tile: each
  warp's online softmax in base 2 over its tiles (over an int8 cache the K
  scale on the score before the softcap and the V scale on P; dead keys
  zero-filled), the warps' merge, then the chunks' partials merged in
  chunk order.  It matches ``decode_attention_ref`` within 1e-5, with rows
  of context 0, chunks that some query rows see nothing of (S > 1),
  softcap, and NaN in every dead slot (bf16) or in every dead slot's scale
  and every pad lane of the scale tiles (int8).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops import kv_quant
from dynamo_tpu_torch.ops.kernels import build
from dynamo_tpu_torch.ops.kernels import decode_attention as da

SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper
SMS = 132  # an H100 SXM
HEAD_DIMS = (64, 128, 256)
WARPS = 4
TILE = 16
LOG2E = 1.4426950408889634
# the cache kinds: int8 (B4a) and bf16 (B1), by their geometry's prefix
KINDS = pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])


def _kind(quant: bool) -> str:
    return "B4A" if quant else "B1"


def live_chunks(seq_len: int, p, width: int) -> list[tuple[int, int]]:
    """The context slots ``[lo, hi)`` of each chunk the kernel computes for
    a row of ``seq_len`` tokens, by its rule: block c works when c * chunk
    is below the row's context, cut at the table's ``width = M * Bs``
    slots; the row's ticket counts ``len(...)`` arrivals."""
    ctx = min(seq_len, width)
    return [(c * p.chunk, min((c + 1) * p.chunk, ctx)) for c in range(p.n_chunks) if c * p.chunk < ctx]


def _covers_once(ranges, total) -> bool:
    """Whether sorted ranges [lo, hi) tile [0, total) with no gap or overlap."""
    edge = 0
    for lo, hi in ranges:
        if lo != edge or hi <= lo:
            return False
        edge = hi
    return edge == total


@KINDS
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("max_model_len", [2048, 4096, 32768])
@pytest.mark.parametrize("b", [1, 2, 8, 64])
def test_decode_q8_plan_covers_each_live_token_once(b, max_model_len, bs, d, quant):
    g, kind = build.geometry(), _kind(quant)
    m = max_model_len // bs
    width = m * bs
    p = da.plan(b, 1, 32, 8, d, m, bs, SMS, quant)
    base, cap = g["B4A_CHUNK"], g[f"{kind}_BLOCKS_PER_SM"] * SMS
    assert p.chunk % base == 0 and p.chunk >= base
    assert 1 <= p.n_chunks <= g["B4A_MAX_CHUNKS"]
    assert (p.n_chunks - 1) * p.chunk < width <= p.n_chunks * p.chunk
    assert p.grid == (8 * p.row_groups, b, p.n_chunks) and p.threads == g["B4A_THREADS"] <= 1024
    # the shortest chunk whose full-table grid stays within the card's
    # block budget and whose row merges at most MAX_CHUNKS partials
    per_chunk = p.grid[0] * p.grid[1]
    assert per_chunk * p.n_chunks <= cap + per_chunk or p.n_chunks == 1
    shorter = p.chunk - base
    if shorter:
        n = -(-width // shorter)
        assert n > g["B4A_MAX_CHUNKS"] or per_chunk * width > cap * shorter
    assert p.smem == g[f"{kind}_SMEM_D{d}_R{p.rows}"] <= SMEM_LIMIT
    c = p.chunk
    for ctx in sorted(x for x in {0, 1, c - 1, c, c + 1, 2 * c - 1, 2 * c + 1, width - 1, width} if x <= width):
        chunks = live_chunks(ctx, p, width)
        assert _covers_once(chunks, ctx)
        assert len(chunks) == math.ceil(ctx / c)  # the ticket's arrivals
        assert all(lo // c < p.n_chunks for lo, _ in chunks)
        for lo, hi in chunks:  # tiles w, w + 4, ... of the chunk to warp w
            n_tiles = -(-(hi - lo) // TILE)
            keys = []
            for w in range(WARPS):
                n_mine = (n_tiles - 1 - w) // WARPS + 1 if w < n_tiles else 0
                for k in range(n_mine):
                    t0 = lo + (w + k * WARPS) * TILE
                    keys += [t for t in range(t0, t0 + TILE) if t < hi]
            assert sorted(keys) == list(range(lo, hi))
    # a context past the table is cut at the table's end, as the plain version cuts it
    assert live_chunks(width + 5, p, width) == live_chunks(width, p, width)


@KINDS
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 4, 8, 64])
def test_decode_q8_plan_row_groups(group, d, quant):
    g, kind = build.geometry(), _kind(quant)
    for s in range(1, 9):
        if s * group > da.MAX_ROWS:
            continue
        p = da.plan(3, s, group * 2, 2, d, 64, 32, SMS, quant)
        q_rows = s * group
        assert p.rows in da.ROW_GROUPS and p.rows <= g[f"{kind}_ROWS_D{d}"]
        assert (p.row_groups - 1) * p.rows < q_rows <= p.row_groups * p.rows
        assert p.rows >= min(q_rows, g[f"{kind}_ROWS_D{d}"])  # the fewest blocks the kernel holds
        assert p.workspace == 3 * 2 * p.row_groups * p.n_chunks * p.rows * (d + 2)
        assert p.tickets == 3 * 2 * p.row_groups
        # a warp's partial fits its ring (of raw int8 or bf16 rows), which
        # the kernel reuses for it
        ring = g[f"{kind}_STAGES"] * 2 * g["B4A_KEYS"] * d * (1 if quant else 2)
        assert p.rows * (d + 2) * 4 <= ring


@KINDS
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bs", [16, 32])
def test_decode_q8_scratch_is_bounded_by_the_widest_table(bs, d, quant):
    """Whatever the table's width, a plan's partials stay within MAX_CHUNKS
    chunks of the query rows rounded up to whole row groups, and its tickets
    at one per (row, KV head, row group)."""
    g = build.geometry()
    for group, s in ((1, 1), (4, 1), (4, 8), (8, 8), (64, 1)):
        for m in (1, 2, 64, 2048, 32768 // bs):
            p = da.plan(5, s, 2 * group, 2, d, m, bs, SMS, quant)
            padded = p.row_groups * p.rows
            assert padded < s * group + p.rows and padded <= da.MAX_ROWS
            assert p.workspace <= 5 * 2 * g["B4A_MAX_CHUNKS"] * padded * (d + 2)
            assert p.tickets == 5 * 2 * p.row_groups


@KINDS
def test_decode_q8_stream_scratch_keeps_what_a_graph_captured(monkeypatch, quant):
    """Each stream has one workspace and one zeroed ticket buffer, reused
    while large enough; when a plan needs more, buffers a CUDA graph
    captured are kept alive for its replays and others are dropped."""
    monkeypatch.setattr(da, "_scratch", {})
    monkeypatch.setattr(da, "_retired", [])
    cpu = torch.device("cpu")
    small = da.plan(2, 1, 32, 8, 128, 64, 32, SMS, quant)
    wide = da.plan(8, 2, 32, 8, 128, 64, 32, SMS, quant)
    assert wide.workspace > small.workspace and wide.tickets > small.tickets
    ws, tickets = da._stream_scratch(cpu, 1, small, False)
    assert ws.numel() == small.workspace and torch.equal(tickets, torch.zeros(small.tickets, dtype=torch.int32))
    assert all(x is y for x, y in zip(da._stream_scratch(cpu, 1, small, False), (ws, tickets)))
    other, _ = da._stream_scratch(cpu, 2, small, False)
    assert other is not ws  # a stream of its own
    ws2, tickets2 = da._stream_scratch(cpu, 1, wide, False)  # grown, the old dropped
    assert ws2.numel() == wide.workspace and tickets2.numel() == wide.tickets and da._retired == []
    assert da._stream_scratch(cpu, 1, small, True)[0] is ws2  # captured as they are
    wider = da.plan(16, 4, 32, 8, 128, 64, 32, SMS, quant)
    ws3, _ = da._stream_scratch(cpu, 1, wider, False)
    assert ws3 is not ws2 and len(da._retired) == 1 and da._retired[0][0] is ws2
    da._stream_scratch(cpu, 1, da.plan(32, 8, 64, 8, 128, 64, 32, SMS, quant), False)
    assert len(da._retired) == 1  # ws3 was never captured


@KINDS
def test_geometry_of_the_decode_kernel_adds_up(quant):
    """The shared memory the header states is the layout the kernel carves,
    for every (head dim, rows) instantiation over the cache kind: f32 Q
    rows, each warp's ring of raw K and V rows (1 or 2 bytes a value) and,
    over an int8 cache, their f32 scales, each warp's f32 probabilities,
    the chunks' m and l and 1 / l, and a flag."""
    g, kind = build.geometry(), _kind(quant)
    warps, keys, stages = g["B4A_THREADS"] // 32, g["B4A_KEYS"], g[f"{kind}_STAGES"]
    assert warps * keys == g["B4A_CHUNK"]
    n = 0
    for d in HEAD_DIMS:
        for rows in (x for x in da.ROW_GROUPS if x <= g[f"{kind}_ROWS_D{d}"]):
            ring = warps * stages * 2 * keys * d * (1 if quant else 2)
            scales = warps * stages * 2 * keys * 4 if quant else 0
            total = (rows * d * 4 + ring + scales + warps * rows * keys * 4
                     + (2 * g["B4A_MAX_CHUNKS"] + 1) * rows * 4 + 16)
            assert total == g[f"{kind}_SMEM_D{d}_R{rows}"] <= SMEM_LIMIT
            n += 1
    assert n == sum(1 for k in g if k.startswith(f"{kind}_SMEM_"))


# ------------------------------------------------------------------ emulation
def _emulate(q, cache, layer, bt, seq_lens, q0_pos, p, logit_cap=None):
    """The kernel's arithmetic in f32 over a bf16 cache or an int8 one (a
    QuantKvCache): per (row, KV head, chunk), each warp's online softmax
    (base 2) over its 16-key tiles, the warps merged, then the chunks'
    partials merged in chunk order."""
    b, s, h, d = q.shape
    quant = isinstance(cache, kv_quant.QuantKvCache)
    data = kv_quant.cache_data(cache)
    _, _, _, bs, hkd = data.shape
    hk = hkd // d
    group = h // hk
    m = bt.shape[1]
    width = m * bs
    cap = logit_cap is not None and logit_cap > 0
    sm_scale = d ** -0.5
    qk = sm_scale / logit_cap if cap else sm_scale * LOG2E
    out = torch.zeros((b, s, h, d), dtype=torch.float32)

    def key(pos, kv, head):
        """Key pos's row and scale (1 over a bf16 cache); nothing is read
        for a dead key."""
        blk = int(bt[row, min(pos // bs, m - 1)])
        vals = data[layer, blk, kv, pos % bs, head * d:(head + 1) * d].float()
        return vals, cache.scale[layer, blk, kv, head, pos % bs].item() if quant else 1.0

    for row in range(b):
        ctx = min(int(seq_lens[row]), width)
        q0 = int(q0_pos[row])
        for head in range(hk):
            qr = q[row, :, head * group:(head + 1) * group].reshape(s * group, d).float() * qk
            qpos = torch.tensor([q0 + x // group for x in range(s * group)])
            parts = []
            for lo, hi in live_chunks(ctx, p, width):
                n_tiles = -(-(hi - lo) // TILE)
                warps = []
                for w in range(WARPS):
                    mw = torch.full((s * group,), -math.inf)
                    lw = torch.zeros(s * group)
                    ow = torch.zeros((s * group, d))
                    for k in range((n_tiles - 1 - w) // WARPS + 1 if w < n_tiles else 0):
                        t0 = lo + (w + k * WARPS) * TILE
                        keys = torch.arange(t0, t0 + TILE)
                        live = keys < hi
                        kt = torch.zeros((TILE, d))
                        vt = torch.zeros((TILE, d))
                        ks = torch.zeros(TILE)
                        vs = torch.zeros(TILE)
                        for j in range(TILE):
                            if live[j]:
                                kt[j], ks[j] = key(t0 + j, 0, head)
                                vt[j], vs[j] = key(t0 + j, 1, head)
                        x = (qr @ kt.T) * ks[None, :]
                        if cap:
                            x = logit_cap * LOG2E * torch.tanh(x)
                        visible = live[None, :] & (keys[None, :] <= qpos[:, None])
                        x = torch.where(visible, x, -math.inf)
                        m_new = torch.maximum(mw, x.max(dim=1).values)
                        seen = m_new > -math.inf
                        alpha = torch.where(seen, torch.exp2(mw - m_new), 1.0)
                        pr = torch.where(seen[:, None], torch.exp2(x - m_new[:, None]), 0.0)
                        lw = lw * alpha + pr.sum(dim=1)
                        ow = ow * alpha[:, None] + (pr * vs[None, :]) @ vt
                        mw = m_new
                    warps.append((mw, lw, ow))
                mm = torch.stack([w[0] for w in warps]).max(dim=0).values
                wt = [torch.where(w[0] > -math.inf, torch.exp2(w[0] - mm), 0.0) for w in warps]
                parts.append((mm, sum(a * w[1] for a, w in zip(wt, warps)),
                              sum(a[:, None] * w[2] for a, w in zip(wt, warps))))
            if not parts:  # an empty row is 0
                continue
            mm = torch.stack([x[0] for x in parts]).max(dim=0).values
            o = torch.zeros((s * group, d))
            ll = torch.zeros(s * group)
            for mc, lc, oc in parts:  # chunk order
                wc = torch.where(mc > -math.inf, torch.exp2(mc - mm), 0.0)
                ll = ll + wc * lc
                o = o + wc[:, None] * oc
            o = o / ll.clamp_min(1e-9)[:, None]
            out[row, :, head * group:(head + 1) * group] = o.reshape(s, group, d)
    return out


def _case(rng, lens, s, h, hk, d, bs, m, quant):
    """A decode case: random int8 codes with NaN scales in every dead slot
    and pad lane, or a random bf16 cache with NaN in every dead slot."""
    n = sum(-(-x // bs) for x in lens) + 3
    perm = rng.permutation(n)
    bt = np.zeros((len(lens), m), np.int32)
    k = 0
    for i, x in enumerate(lens):
        nb = -(-x // bs)
        bt[i, :nb] = perm[k:k + nb]
        k += nb
    live = np.zeros((n, bs), bool)
    for row, x in zip(bt, lens):
        for j in range(x):
            live[row[j // bs], j % bs] = True
    if quant:
        data = rng.integers(-127, 128, size=(2, n, 2, bs, hk * d)).astype(np.int8)
        hp, sp = kv_quant.scale_tile(hk, bs)
        scale = np.full((2, n, 2, hp, sp), np.nan, np.float32)  # pad lanes and dead slots NaN
        sc = (rng.random((2, n, 2, hk, bs)) * 0.02 + 0.005).astype(np.float32)
        scale[..., :hk, :bs] = np.where(live[None, :, None, None, :], sc, np.nan)
        cache = kv_quant.QuantKvCache(torch.from_numpy(data), torch.from_numpy(scale))
    else:
        data = rng.normal(size=(2, n, 2, bs, hk * d)).astype(np.float32)
        data = np.where(live[None, :, None, :, None], data, np.nan)
        cache = torch.from_numpy(data).to(torch.bfloat16)
    q = rng.normal(size=(len(lens), s, h, d)).astype(np.float32)
    seq = np.array(lens, np.int32)
    q0 = np.maximum(seq - s, 0).astype(np.int32)
    return torch.from_numpy(q), cache, torch.from_numpy(bt), torch.from_numpy(seq), torch.from_numpy(q0)


@KINDS
@pytest.mark.parametrize("s,cap", [(1, None), (4, None), (4, 30.0), (8, 30.0)])
@pytest.mark.parametrize("bs", [16, 32])
def test_chunked_partials_merge_to_the_plain_version(bs, s, cap, quant):
    rng = np.random.default_rng(11 + s + bs)
    h, hk, d = 4, 2, 64
    m = 160 // bs
    # context 0, 1, chunk edges -1/0/+1 (65 at S = 4: query rows 0-2 see
    # nothing of the second chunk), a row filling the table
    lens = [0, 1, 63, 64, 65, 130, m * bs]
    q, cache, bt, seq, q0 = _case(rng, lens, s, h, hk, d, bs, m, quant)
    p = da.plan(len(lens), s, h, hk, d, m, bs, SMS, quant)
    assert p.chunk == 64 and p.n_chunks == -(-m * bs // 64)
    out = _emulate(q, cache, 1, bt, seq, q0, p, cap)
    ref = da.decode_attention_ref(q, cache, 1, bt, seq, q0, logit_cap=cap)
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
