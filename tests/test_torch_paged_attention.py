"""The PyTorch port's paged-attention ops against the JAX package's.

Two references for each op, fed the same numpy inputs (f32, seeded):

* the JAX package's plain ops (``dynamo_tpu.ops.paged_attention``) for the
  port's plain ops — the cache write (row and block-aligned paths), the
  gather oracle, prefill attention and the decode routing on the CPU;
* the Pallas kernels themselves, run in interpret mode as
  ``tests/test_pallas_kernels.py`` runs them, for the plain versions that
  stand beside the port's CUDA kernels (``decode_attention_ref``,
  ``prefill_attention_ref``).

Tolerance: atol 2e-4 on f32 attention outputs (both sides compute in f32;
the gap is summation order and the flash rescaling of the Pallas kernels),
exact equality for cache writes (pure data movement).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from dynamo_tpu.ops.paged_attention import paged_attention_layer as jax_paged_attention_layer
from dynamo_tpu.ops.paged_attention import prefill_attention as jax_prefill_attention
from dynamo_tpu.ops.paged_attention import write_kv_cache_layer as jax_write_kv_cache_layer
from dynamo_tpu.ops.pallas.decode_attention import paged_decode_attention_mq
from dynamo_tpu.ops.pallas.prefill_attention import paged_prefill_attention as pallas_prefill
from dynamo_tpu_torch.ops import paged_attention as ops
from dynamo_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_ref,
    paged_decode_attention,
)
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention,
    prefill_attention_ref,
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


def _cache(rng, n, bs, hk, d):
    return rng.normal(size=(N_LAYERS, n, 2, bs, hk * d)).astype(np.float32)


def _tables(rng, lens, m, n, bs):
    """Disjoint random block tables [B, m], 0-filled past each row's
    blocks (the engine's layout)."""
    perm = rng.permutation(n)
    bt = np.zeros((len(lens), m), np.int32)
    k = 0
    for i, ln in enumerate(lens):
        nb = -(-ln // bs)
        bt[i, :nb] = perm[k:k + nb]
        k += nb
    return bt


def _poison(cache, bt, live_lens, bs):
    """NaN into every cache slot no row owns below its live length."""
    live = np.zeros(cache.shape[1:2] + (bs,), bool)
    for row, ln in zip(bt, live_lens):
        for j in range(ln):
            live[row[j // bs], j % bs] = True
    cache = cache.copy()
    cache[:, ~live.any(axis=1)] = np.nan  # unowned blocks
    for blk, off in zip(*np.nonzero(~live & live.any(axis=1, keepdims=True))):
        cache[:, blk, :, off] = np.nan   # dead slots of owned blocks
    return cache


# ------------------------------------------------------ port vs JAX plain ops
@pytest.mark.parametrize("block_aligned", [False, True])
def test_write_kv_cache_layer_matches_jax(block_aligned):
    rng = np.random.default_rng(0)
    n, bs, hk, d = 12, 8, 2, 16
    cache = _cache(rng, n, bs, hk, d)
    b, s = 2, 24  # three blocks per row; row 1 ends mid-block, row 0 has a dropped block
    k_new = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v_new = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    slot = np.full((b, s), -1, np.int32)
    slot[0, :16] = np.r_[np.arange(8) + 5 * bs, np.arange(8) + 2 * bs]
    slot[1, :19] = np.r_[np.arange(8) + 7 * bs, np.arange(8) + 9 * bs, np.arange(3) + 11 * bs]
    ref = jax_write_kv_cache_layer(jnp.asarray(cache), jnp.int32(1), jnp.asarray(k_new),
                                   jnp.asarray(v_new), jnp.asarray(slot),
                                   block_aligned=block_aligned)
    out = _t(cache)
    ops.write_kv_cache_layer(out, 1, _t(k_new), _t(v_new), _t(slot), block_aligned=block_aligned)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("s,window,cap", [(1, None, None), (3, None, 30.0), (2, 20, None)])
def test_paged_attention_matches_jax(s, window, cap):
    rng = np.random.default_rng(1)
    b, h, hk, d, bs, n, m = 3, 4, 2, 16, 8, 32, 6
    lens = np.array([5, 33, 48], np.int32)
    k_cache = rng.normal(size=(n, bs, hk, d)).astype(np.float32)
    v_cache = rng.normal(size=(n, bs, hk, d)).astype(np.float32)
    bt = _tables(rng, lens, m, n, bs)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pos = (lens[:, None] - s + np.arange(s)[None, :]).astype(np.int32)
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
                              jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(pos),
                              logit_cap=cap, window=window)
    out = ops.paged_attention(_t(q), _t(k_cache), _t(v_cache), _t(bt), _t(lens), _t(pos),
                              logit_cap=cap, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("s", [1, 4])
def test_paged_attention_layer_cpu_routing_matches_jax(s):
    rng = np.random.default_rng(2)
    b, h, hk, d, bs, n, m = 2, 4, 2, 16, 8, 16, 4
    lens = np.array([9, 30], np.int32)
    cache = _cache(rng, n, bs, hk, d)
    bt = _tables(rng, lens, m, n, bs)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pos = (lens[:, None] - s + np.arange(s)[None, :]).astype(np.int32)
    ref = jax_paged_attention_layer(jnp.asarray(q), jnp.asarray(cache), jnp.int32(2),
                                    jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(pos))
    out = ops.paged_attention_layer(_t(q), _t(cache), 2, _t(bt), _t(lens), _t(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize(
    "prefix_blocks,cap,window",
    [(0, None, None), (3, None, None), (3, 30.0, None), (2, None, 20)],
)
def test_prefill_attention_matches_jax(prefix_blocks, cap, window):
    rng = np.random.default_rng(3)
    b, s, h, hk, d, bs, n = 2, 16, 4, 2, 16, 8, 32
    start = np.full(b, prefix_blocks * bs, np.int32)
    fresh = np.array([s, s - 5], np.int32)  # row 1 has a padded tail
    lens = start + fresh
    m = prefix_blocks + s // bs + 1
    bt = _tables(rng, lens, m, n, bs)
    cache = _cache(rng, n, bs, hk, d)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k_new = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v_new = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    ref = jax_prefill_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(cache),
        jnp.int32(1), jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(start), prefix_blocks,
        logit_cap=cap, window=window)
    out = ops.prefill_attention(_t(q), _t(k_new), _t(v_new), _t(cache), 1, _t(bt), _t(lens),
                                _t(start), prefix_blocks, logit_cap=cap, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# ------------------------------------- kernels' plain versions vs Pallas kernels
@pytest.mark.parametrize(
    "s,h,hk,cap",
    [(1, 8, 2, None), (1, 4, 4, 30.0), (4, 8, 2, None), (4, 8, 2, 30.0)],
)
def test_decode_ref_matches_pallas_interpret(s, h, hk, cap):
    rng = np.random.default_rng(4)
    b, d, bs, n, m = 4, 32, 8, 40, 8
    lens = np.array([0, 1, 19, 64], np.int32)  # zero-length row, single slot, full table
    bt = _tables(rng, lens, m, n, bs)
    cache = _poison(_cache(rng, n, bs, hk, d), bt, lens, bs)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    q0 = np.maximum(lens - s, 0).astype(np.int32)
    ref = paged_decode_attention_mq(jnp.asarray(q), jnp.asarray(cache), jnp.int32(1),
                                    jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(q0),
                                    logit_cap=cap, blocks_per_chunk=2, interpret=True)
    out = decode_attention_ref(_t(q), _t(cache), 1, _t(bt), _t(lens), _t(q0), logit_cap=cap)
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all()  # a zero-length row gives exactly 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize(
    "prefix_blocks,h,hk,cap",
    [(0, 8, 2, None), (3, 8, 2, None), (2, 4, 4, 30.0)],
)
def test_prefill_ref_matches_pallas_interpret(prefix_blocks, h, hk, cap):
    rng = np.random.default_rng(5)
    b, s, d, bs, n = 2, 32, 32, 8, 40
    start = np.full(b, prefix_blocks * bs, np.int32)
    fresh = np.array([s, s - 7], np.int32)  # row 1 has a padded tail
    lens = start + fresh
    m = prefix_blocks + s // bs + 1
    bt = _tables(rng, lens, m, n, bs)
    # only the cached prefix is live in the cache
    cache = _poison(_cache(rng, n, bs, hk, d), bt, start, bs)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k_new = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v_new = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    k_new[1, fresh[1]:] = np.nan  # fresh padding may hold anything
    v_new[1, fresh[1]:] = np.nan
    ref = pallas_prefill(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                         jnp.asarray(cache), jnp.int32(2), jnp.asarray(bt), jnp.asarray(lens),
                         jnp.asarray(start), logit_cap=cap, rows_per_chunk=16,
                         blocks_per_chunk=2, interpret=True)
    out = prefill_attention_ref(_t(q), _t(k_new), _t(v_new), _t(cache), 2, _t(bt), _t(lens),
                                _t(start), logit_cap=cap)
    assert torch.isfinite(out).all()
    assert (out[1, fresh[1]:] == 0).all()  # padding query rows give exactly 0
    for i, f in enumerate(fresh):  # live rows only: the Pallas padding rows are garbage
        np.testing.assert_allclose(out[i, :f].numpy(), np.asarray(ref)[i, :f], atol=ATOL)


# ------------------------------------------------- wrappers on CPU tensors
def test_wrappers_take_plain_versions_on_cpu():
    rng = np.random.default_rng(6)
    b, s, h, hk, d, bs, n = 2, 16, 4, 2, 64, 8, 16
    lens = np.array([10, 16], np.int32)
    bt = _tables(rng, lens, 3, n, bs)
    cache = _t(_cache(rng, n, bs, hk, d))
    q = _t(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    before = (paged_decode_attention.launches, paged_prefill_attention.launches)
    args = (q, cache, 1, _t(bt), _t(lens), _t(lens - 1))
    torch.testing.assert_close(paged_decode_attention(*args), decode_attention_ref(*args),
                               rtol=0, atol=0)
    qp = _t(rng.normal(size=(b, s, h, d)).astype(np.float32))
    kv = _t(rng.normal(size=(b, s, hk, d)).astype(np.float32))
    pargs = (qp, kv, kv, cache, 1, _t(bt), _t(lens), _t(np.zeros(b, np.int32)))
    torch.testing.assert_close(paged_prefill_attention(*pargs), prefill_attention_ref(*pargs),
                               rtol=0, atol=0)
    # the CPU path is the plain version: no kernel launch is counted
    assert (paged_decode_attention.launches, paged_prefill_attention.launches) == before
