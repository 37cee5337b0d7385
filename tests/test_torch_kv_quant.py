"""The port's int8 KV cache against the JAX package's.

Seeded numpy inputs (f32) go to both packages:

* ``quantize_kv_rows``: codes and scales bit for bit the JAX package's;
* ``write_kv_cache_layer`` on a ``QuantKvCache``: the row path, the
  block-aligned path with dropped slots inside a block and a dropped block,
  and the unified layout's ``row_tokens`` split leave the payload and the
  scale pool exactly as the JAX write does, and the scale tiles' pad lanes
  keep 1.0;
* ``dequant_layer_slice`` within 1e-6;
* the three plain int8 attention ops (``paged_attention_layer``,
  ``prefill_attention``, ``ragged_prefill_attention`` on a ``QuantKvCache``)
  against the JAX package's dequantising plain ops, and the int8 kernels'
  plain versions against the Pallas kernels' int8 bodies in interpret mode,
  as ``tests/test_kv_quant.py`` and ``tests/test_pallas_kernels.py`` run
  them.  Block sizes 16 and 32.  For the Pallas comparison the pool holds
  random int8 codes in every dead slot and NaN in every dead slot's scale
  and in every pad lane of the scale tiles.

Tolerance: atol 2e-4 on attention outputs (f32 on both sides over the same
int8 contents; the gap is summation order, the flash rescaling and where the
scales multiply), compared on live tokens only.  Writes are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import kv_quant as jax_kv_quant
from dynamo_tpu.ops.paged_attention import paged_attention_layer as jax_paged_attention_layer
from dynamo_tpu.ops.paged_attention import prefill_attention as jax_prefill_attention
from dynamo_tpu.ops.paged_attention import ragged_prefill_attention as jax_ragged
from dynamo_tpu.ops.paged_attention import write_kv_cache_layer as jax_write_kv_cache_layer
from dynamo_tpu.ops.pallas.decode_attention import paged_decode_attention_mq
from dynamo_tpu.ops.pallas.prefill_attention import paged_prefill_attention as pallas_prefill
from dynamo_tpu.ops.pallas.prefill_attention import ragged_paged_prefill_attention as pallas_ragged
from dynamo_tpu_torch.ops import kv_quant
from dynamo_tpu_torch.ops import paged_attention as ops
from dynamo_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_ref,
    paged_decode_attention_q8,
)
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention_q8,
    prefill_attention_ref,
)
from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
    ragged_paged_prefill_attention_q8,
    ragged_prefill_attention_ref,
)

ATOL = 2e-4
N_LAYERS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quant_cache(rng, n, bs, hk, d):
    """(data int8 [L, N, 2, Bs, Hk*D], scale f32 [L, N, 2, Hp, Sp]) as
    numpy: random codes, random scales, pad lanes 1.0."""
    data = rng.integers(-127, 128, size=(N_LAYERS, n, 2, bs, hk * d)).astype(np.int8)
    sc = (rng.random((N_LAYERS, n, 2, hk, bs)) * 0.05 + 0.01).astype(np.float32)
    hp, sp = kv_quant.scale_tile(hk, bs)
    scale = np.ones((N_LAYERS, n, 2, hp, sp), np.float32)
    scale[..., :hk, :bs] = sc
    return data, scale


def _poison_scales(scale, bt, live_lens, hk, bs):
    """NaN into every pad lane and into the scale of every slot no row owns
    below its live length (the payload there stays random codes)."""
    scale = scale.copy()
    live = np.zeros((scale.shape[1], bs), bool)
    for row, ln in zip(bt, live_lens):
        for j in range(ln):
            live[row[j // bs], j % bs] = True
    dead = np.zeros(scale.shape[1:], bool)          # [N, 2, Hp, Sp]
    dead[:, :, hk:, :] = True
    dead[:, :, :, bs:] = True
    dead[:, :, :hk, :bs] |= ~live[:, None, None, :]
    scale[:, dead] = np.nan
    return scale


def _jq(data, scale):
    return jax_kv_quant.QuantKvCache(jnp.asarray(data), jnp.asarray(scale))


def _tq(data, scale):
    return kv_quant.QuantKvCache(_t(data), _t(scale))


def _tables(rng, lens, m, n, bs):
    """Disjoint random block tables [B, m], 0-filled past each row's blocks."""
    perm = rng.permutation(n)
    bt = np.zeros((len(lens), m), np.int32)
    k = 0
    for i, ln in enumerate(lens):
        nb = -(-ln // bs)
        bt[i, :nb] = perm[k:k + nb]
        k += nb
    return bt


# ------------------------------------------------------------ quantise / write
def test_quantize_kv_rows_bit_identical_to_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 17, 4, 32)) * rng.choice([1e-3, 1.0, 40.0], size=(3, 17, 4, 1)))
    x = x.astype(np.float32)
    x[1, 2, 3] = 0.0     # an all-zero row: the 1e-8 floor
    x[2, 5, 0, :4] = [0.5, -0.5, 1.5, -2.5]  # halves round to even
    jq, js = jax_kv_quant.quantize_kv_rows(jnp.asarray(x))
    q, s = kv_quant.quantize_kv_rows(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _write_case(bs, kind):
    """(k_new, v_new, slot, write kwargs) of one write layout."""
    rng = np.random.default_rng(bs)
    hk, d = 2, 16
    if kind == "rows":
        b, s = 3, 2
        slot = np.array([[3 * bs + 5, 7 * bs], [1 * bs + bs - 1, -1], [-1, 12 * bs + 2]], np.int32)
        kw = {}
    elif kind == "blocks":
        b, s = 2, 3 * bs  # row 0: a dropped block; row 1 ends mid-block
        slot = np.full((b, s), -1, np.int32)
        slot[0, :2 * bs] = np.r_[np.arange(bs) + 5 * bs, np.arange(bs) + 2 * bs]
        slot[1, :2 * bs + 3] = np.r_[np.arange(bs) + 7 * bs, np.arange(bs) + 9 * bs,
                                     np.arange(3) + 11 * bs]
        kw = dict(block_aligned=True)
    else:  # the unified layout: per-row decode tokens, then block-aligned spans
        b, s = 1, 2 * bs + bs
        slot = np.full((b, s), -1, np.int32)
        slot[0, :5] = [3 * bs + 5, 7 * bs, 1 * bs + 7, 12 * bs + 2, 9 * bs + 1]
        slot[0, bs:2 * bs + 5] = np.r_[np.arange(bs) + 4 * bs, np.arange(5) + 10 * bs]
        kw = dict(block_aligned=True, row_tokens=bs)
    k_new = (rng.normal(size=(b, s, hk, d)) * 3).astype(np.float32)
    v_new = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    return rng, hk, d, k_new, v_new, slot, kw


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("kind", ["rows", "blocks", "row_tokens"])
def test_write_quant_cache_matches_jax(bs, kind):
    rng, hk, d, k_new, v_new, slot, kw = _write_case(bs, kind)
    data, scale = _quant_cache(rng, 16, bs, hk, d)
    before = data.copy()  # the port's cache shares the numpy buffers
    ref = jax_write_kv_cache_layer(_jq(data, scale), jnp.int32(1), jnp.asarray(k_new),
                                   jnp.asarray(v_new), jnp.asarray(slot), **kw)
    cache = _tq(data, scale)
    out = ops.write_kv_cache_layer(cache, 1, _t(k_new), _t(v_new), _t(slot), **kw)
    assert out is cache  # written in place
    np.testing.assert_array_equal(cache.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(cache.scale.numpy(), np.asarray(ref.scale))
    assert (cache.scale[..., hk:, :] == 1.0).all() and (cache.scale[..., bs:] == 1.0).all()
    assert not np.array_equal(cache.data.numpy(), before)  # something was written


def test_dequant_layer_slice_matches_jax():
    rng = np.random.default_rng(1)
    data, scale = _quant_cache(rng, 8, 16, 2, 32)
    blocks = np.array([[3, 1], [0, 7]])
    ref = jax_kv_quant.dequant_layer_slice(jnp.asarray(data[2][blocks]),
                                           jnp.asarray(scale[2][blocks]), 2)
    out = kv_quant.dequant_layer_slice(_t(data[2][blocks]), _t(scale[2][blocks]), 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    got = kv_quant.gather_layer_blocks(_tq(data, scale), 2, _t(blocks), 2)
    np.testing.assert_array_equal(got.numpy(), out.numpy())


# ---------------------------------------------- plain int8 ops vs JAX plain ops
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("s,cap", [(1, None), (4, 30.0)])
def test_paged_attention_layer_quant_matches_jax(bs, s, cap):
    rng = np.random.default_rng(2)
    b, h, hk, d, n, m = 3, 8, 2, 32, 24, 4
    lens = np.array([5, 33, 4 * bs - 3], np.int32)
    data, scale = _quant_cache(rng, n, bs, hk, d)
    bt = _tables(rng, lens, m, n, bs)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pos = (lens[:, None] - s + np.arange(s)[None, :]).astype(np.int32)
    ref = jax_paged_attention_layer(jnp.asarray(q), _jq(data, scale), jnp.int32(2),
                                    jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(pos),
                                    logit_cap=cap)
    out = ops.paged_attention_layer(_t(q), _tq(data, scale), 2, _t(bt), _t(lens), _t(pos),
                                    logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("prefix_blocks,cap", [(0, None), (2, None), (2, 30.0)])
def test_prefill_attention_quant_matches_jax(bs, prefix_blocks, cap):
    rng = np.random.default_rng(3)
    b, s, h, hk, d, n = 2, 16, 4, 2, 32, 16
    start = np.full(b, prefix_blocks * bs, np.int32)
    fresh = np.array([s, s - 5], np.int32)
    lens = start + fresh
    m = prefix_blocks + 2
    bt = _tables(rng, lens, m, n, bs)
    data, scale = _quant_cache(rng, n, bs, hk, d)
    q, k_new, v_new = (rng.normal(size=(b, s, x, d)).astype(np.float32) for x in (h, hk, hk))
    ref = jax_prefill_attention(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                                _jq(data, scale), jnp.int32(1), jnp.asarray(bt), jnp.asarray(lens),
                                jnp.asarray(start), prefix_blocks, logit_cap=cap)
    out = ops.prefill_attention(_t(q), _t(k_new), _t(v_new), _tq(data, scale), 1, _t(bt),
                                _t(lens), _t(start), prefix_blocks, logit_cap=cap)
    for i, f in enumerate(fresh):  # live rows only: padding rows differ by contract
        np.testing.assert_allclose(out[i, :f].numpy(), np.asarray(ref)[i, :f], atol=ATOL)


def _ragged_layout(rows, bs, m, n, rng, region):
    """Rows [(start, fresh)] packed as the engine does: leading 1-token rows
    take one slot each of a ``region``-slot decode region, the rest
    block-rounded spans after it, then one zero padding row."""
    n_dec = 0
    while region and n_dec < len(rows) and rows[n_dec][1] == 1:
        n_dec += 1
    offs, off = list(range(n_dec)), region
    for _, f in rows[n_dec:]:
        offs.append(off)
        off += -(-f // bs) * bs
    r = len(rows) + 1
    seq_ids = np.full((1, off), -1, np.int32)
    lens, starts, roff = (np.zeros(r, np.int32) for _ in range(3))
    for i, ((st, f), o) in enumerate(zip(rows, offs)):
        seq_ids[0, o:o + f] = i
        lens[i], starts[i], roff[i] = st + f, st, o
    bt = np.zeros((r, m), np.int32)
    bt[:len(rows)] = _tables(rng, lens[:len(rows)], m, n, bs)
    return off, seq_ids, bt, lens, starts, roff


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_ragged_attention_quant_matches_jax(bs, cap):
    rng = np.random.default_rng(4)
    h, hk, d, n, m = 4, 2, 32, 24, 5
    rows = [(bs + 3, 1), (1, 1), (0, 1), (bs, 20), (0, 9)]
    t, seq_ids, bt, lens, starts, roff = _ragged_layout(rows, bs, m, n, rng, 8)
    live = seq_ids[0] >= 0
    data, scale = _quant_cache(rng, n, bs, hk, d)
    q, k_new, v_new = (rng.normal(size=(1, t, x, d)).astype(np.float32) for x in (h, hk, hk))
    pb = 2
    ref = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), _jq(data, scale), jnp.int32(1),
        jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(starts), jnp.asarray(roff),
        jnp.asarray(seq_ids), pb, logit_cap=cap))
    args = (_t(q), _t(k_new), _t(v_new), _tq(data, scale), 1, _t(bt), _t(lens), _t(starts),
            _t(roff))
    out = ops.ragged_prefill_attention(*args, _t(seq_ids), pb, logit_cap=cap).numpy()
    np.testing.assert_allclose(out[0][live], ref[0][live], atol=ATOL)
    plain = ragged_prefill_attention_ref(*args, logit_cap=cap).numpy()
    np.testing.assert_allclose(plain[0][live], ref[0][live], atol=ATOL)


# ----------------------------- the int8 kernels' plain versions vs Pallas bodies
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("s,cap", [(1, None), (4, 30.0)])
def test_decode_q8_ref_matches_pallas_interpret(bs, s, cap):
    rng = np.random.default_rng(5)
    b, h, hk, d, n, m = 4, 8, 2, 32, 24, 4
    lens = np.array([0, 1, bs + 3, 4 * bs], np.int32)  # zero-length row, single slot, full table
    bt = _tables(rng, lens, m, n, bs)
    data, scale = _quant_cache(rng, n, bs, hk, d)
    scale = _poison_scales(scale, bt, lens, hk, bs)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    q0 = np.maximum(lens - s, 0).astype(np.int32)
    ref = paged_decode_attention_mq(jnp.asarray(q), _jq(data, scale), jnp.int32(1),
                                    jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(q0),
                                    logit_cap=cap, blocks_per_chunk=2, seqs_per_group=2,
                                    interpret=True)
    args = (_t(q), _tq(data, scale), 1, _t(bt), _t(lens), _t(q0))
    out = decode_attention_ref(*args, logit_cap=cap)
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all()  # a zero-length row gives exactly 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # on CPU tensors the int8 wrapper is the plain version: same bits, no launch
    before = paged_decode_attention_q8.launches
    torch.testing.assert_close(paged_decode_attention_q8(*args, logit_cap=cap), out, rtol=0, atol=0)
    assert paged_decode_attention_q8.launches == before


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("prefix_blocks,cap", [(0, None), (2, None), (2, 30.0)])
def test_prefill_q8_ref_matches_pallas_interpret(bs, prefix_blocks, cap):
    rng = np.random.default_rng(6)
    b, s, h, hk, d, n = 2, 32, 8, 2, 32, 16
    start = np.full(b, prefix_blocks * bs, np.int32)
    fresh = np.array([s, s - 7], np.int32)
    lens = start + fresh
    m = prefix_blocks + 2
    bt = _tables(rng, lens, m, n, bs)
    data, scale = _quant_cache(rng, n, bs, hk, d)
    scale = _poison_scales(scale, bt, start, hk, bs)  # only the prefix is live
    q, k_new, v_new = (rng.normal(size=(b, s, x, d)).astype(np.float32) for x in (h, hk, hk))
    k_new[1, fresh[1]:] = np.nan  # fresh padding may hold anything
    v_new[1, fresh[1]:] = np.nan
    ref = pallas_prefill(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), _jq(data, scale),
                         jnp.int32(2), jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(start),
                         logit_cap=cap, rows_per_chunk=16, blocks_per_chunk=2, interpret=True)
    args = (_t(q), _t(k_new), _t(v_new), _tq(data, scale), 2, _t(bt), _t(lens), _t(start))
    out = prefill_attention_ref(*args, logit_cap=cap)
    assert torch.isfinite(out).all()
    assert (out[1, fresh[1]:] == 0).all()  # padding query rows give exactly 0
    for i, f in enumerate(fresh):
        np.testing.assert_allclose(out[i, :f].numpy(), np.asarray(ref)[i, :f], atol=ATOL)
    before = paged_prefill_attention_q8.launches
    torch.testing.assert_close(paged_prefill_attention_q8(*args, logit_cap=cap), out,
                               rtol=0, atol=0)
    assert paged_prefill_attention_q8.launches == before


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_ragged_q8_ref_matches_pallas_interpret(bs, cap):
    """The unified layout (decode rows at non-aligned starts ahead of two
    spans, one over a cached prefix) and a zero padding row."""
    rng = np.random.default_rng(7)
    h, hk, d, n, m = 4, 2, 32, 24, 5
    rows = [(bs + 3, 1), (1, 1), (2 * bs - 1, 1), (bs, 20), (0, 9)]
    t, seq_ids, bt, lens, starts, roff = _ragged_layout(rows, bs, m, n, rng, 8)
    live = seq_ids[0] >= 0
    data, scale = _quant_cache(rng, n, bs, hk, d)
    scale = _poison_scales(scale, bt, starts, hk, bs)
    q, k_new, v_new = (rng.normal(size=(1, t, x, d)).astype(np.float32) for x in (h, hk, hk))
    k_new[0, ~live] = np.nan
    v_new[0, ~live] = np.nan
    ref = np.asarray(pallas_ragged(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), _jq(data, scale), jnp.int32(1),
        jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(starts), jnp.asarray(roff),
        logit_cap=cap, rows_per_chunk=8, blocks_per_chunk=2, interpret=True))
    args = (_t(q), _t(k_new), _t(v_new), _tq(data, scale), 1, _t(bt), _t(lens), _t(starts),
            _t(roff))
    out = ragged_prefill_attention_ref(*args, logit_cap=cap)
    assert torch.isfinite(out).all()
    assert (out[0][~torch.from_numpy(live)] == 0).all()  # padding tokens give exactly 0
    np.testing.assert_allclose(out.numpy()[0][live], ref[0][live], atol=ATOL)
    before = ragged_paged_prefill_attention_q8.launches
    torch.testing.assert_close(ragged_paged_prefill_attention_q8(*args, logit_cap=cap), out,
                               rtol=0, atol=0)
    assert ragged_paged_prefill_attention_q8.launches == before


# The card's ragged edge layouts (chip_smoke.py) at tiny widths over an
# int8 cache: name: (H, Hk, rows [(start, fresh)], decode region).  The
# card's span blocks hold 128 / G tokens: a G = 1 span cut by a block
# boundary; G = 8 boundaries at a span end and mid-span; a full 16-row
# decode region with contexts across 64-key tiles (64 and 65 among them);
# spans from starts inside a 64-key tile, at a flat offset inside one.
Q8_EDGE_LAYOUTS = {
    "g1-boundary-mid-span": (4, 4, [(0, 100), (16, 60)], 0),
    "g8-boundaries": (16, 2, [(8, 1), (0, 16), (24, 20)], 16),
    "full-decode-region": (8, 2, [(n - 1, 1) for n in (1, 2, 17, 63, 64, 65, 100, 128, 129, 150, 200,
                                                        255, 256, 257, 300, 319)] + [(0, 20)], 16),
    "misaligned-starts": (8, 2, [(5, 1), (80, 50), (16, 45)], 8),
}


def _q8_edge_data(layout, bs):
    """One edge layout's inputs (seeded numpy) and the JAX package's
    outputs on them: the dequantising plain op on a clean pool, and the
    Pallas int8 body in interpret mode on a pool with NaN in every dead
    slot's scale and every pad lane, and NaN padding K/V."""
    h, hk, rows, region = Q8_EDGE_LAYOUTS[layout]
    d = 32
    rng = np.random.default_rng(20 + sorted(Q8_EDGE_LAYOUTS).index(layout))
    m = 320 // bs
    n = sum(-(-(st + f) // bs) for st, f in rows) + 4
    t, seq_ids, bt, lens, starts, roff = _ragged_layout(rows, bs, m, n, rng, region)
    live = seq_ids[0] >= 0
    data, scale = _quant_cache(rng, n, bs, hk, d)
    q, k_new, v_new = (rng.normal(size=(1, t, x, d)).astype(np.float32) for x in (h, hk, hk))
    max_pb = max(-(-int(s) // bs) for s in starts)
    pb = 0 if max_pb == 0 else min(m, 1 << (max_pb - 1).bit_length())
    oracle = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), _jq(data, scale), jnp.int32(1),
        jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(starts), jnp.asarray(roff),
        jnp.asarray(seq_ids), pb))
    scale_p = _poison_scales(scale, bt, starts, hk, bs)
    k_p, v_p = k_new.copy(), v_new.copy()
    k_p[0, ~live] = np.nan
    v_p[0, ~live] = np.nan
    pallas = np.asarray(pallas_ragged(
        jnp.asarray(q), jnp.asarray(k_p), jnp.asarray(v_p), _jq(data, scale_p), jnp.int32(1),
        jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(starts), jnp.asarray(roff),
        rows_per_chunk=8, blocks_per_chunk=2, interpret=True))
    return dict(q=q, k_new=k_new, v_new=v_new, data=data, scale=scale, rows=(bt, lens, starts, roff),
                live=live, scale_p=scale_p, k_p=k_p, v_p=v_p, oracle=oracle, pallas=pallas)


@pytest.fixture(scope="module")
def q8_edge_data():
    """Every int8 edge case's inputs and JAX outputs, made once in the
    module's set-up: compiling the JAX op and the Pallas body at each
    layout's shapes is most of a case's time."""
    return {(layout, bs): _q8_edge_data(layout, bs) for layout in Q8_EDGE_LAYOUTS for bs in (16, 32)}


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("layout", sorted(Q8_EDGE_LAYOUTS))
def test_ragged_q8_edges_match_jax_and_pallas_interpret(q8_edge_data, layout, bs):
    """The int8 plain version at each edge layout against the JAX package's
    dequantising plain op and, on the poisoned pool, against the Pallas
    int8 body; padding tokens give exactly 0, and the wrapper on CPU
    tensors is the plain version."""
    x = q8_edge_data[layout, bs]
    live = x["live"]
    rows = tuple(_t(a) for a in x["rows"])
    plain = ragged_prefill_attention_ref(_t(x["q"]), _t(x["k_new"]), _t(x["v_new"]),
                                         _tq(x["data"], x["scale"]), 1, *rows).numpy()
    np.testing.assert_allclose(plain[0][live], x["oracle"][0][live], atol=ATOL)
    args = (_t(x["q"]), _t(x["k_p"]), _t(x["v_p"]), _tq(x["data"], x["scale_p"]), 1, *rows)
    out = ragged_prefill_attention_ref(*args)
    assert torch.isfinite(out).all()
    assert (out[0][~torch.from_numpy(live)] == 0).all()  # padding tokens give exactly 0
    np.testing.assert_allclose(out.numpy()[0][live], x["pallas"][0][live], atol=ATOL)
    before = ragged_paged_prefill_attention_q8.launches
    torch.testing.assert_close(ragged_paged_prefill_attention_q8(*args), out, rtol=0, atol=0)
    assert ragged_paged_prefill_attention_q8.launches == before
