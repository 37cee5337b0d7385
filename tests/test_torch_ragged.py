"""The port's ragged (token-budget) prefill path against the JAX package's.

Seeded numpy inputs (f32) go to both packages:

* ``ops.ragged_prefill_attention`` and the ragged kernel's plain version
  (``ragged_prefill_attention_ref``) against the JAX package's plain op
  ``ragged_prefill_attention`` (its oracle) and against the Pallas kernel
  ``ragged_paged_prefill_attention`` in interpret mode, at small
  ``rows_per_chunk``/``blocks_per_chunk``, as ``tests/test_pallas_kernels.py``
  runs it.  Layouts: spans at start 0 and at block-aligned starts, the
  unified layout (decode rows at non-aligned starts ahead of the spans), a
  zero-length padding row, softcap, and G = 1 and G = 8.  The Pallas kernel
  runs on a NaN-poisoned pool with NaN padding K/V.
* ``write_kv_cache_layer(row_tokens=...)``: the unified layout's split write.
* ``LlamaModel.forward(ragged=..., ragged_row_tokens=...)``: hidden states
  and cache of a packed prefill and then a mixed dispatch.

Tolerance: atol 2e-4 on attention outputs and 1e-4 on hidden states (f32 on
both sides; the gap is summation order and flash rescaling), compared on
live tokens only — the Pallas kernel's padding tokens are finite garbage,
the port's exactly 0.  Cache writes are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.ops.paged_attention import ragged_prefill_attention as jax_ragged
from dynamo_tpu.ops.paged_attention import write_kv_cache_layer as jax_write_kv_cache_layer
from dynamo_tpu.ops.pallas.prefill_attention import ragged_paged_prefill_attention as pallas_ragged
from dynamo_tpu_torch.ops import paged_attention as ops
from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
    ragged_paged_prefill_attention,
    ragged_prefill_attention_ref,
)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel

ATOL = 2e-4
HIDDEN_ATOL = 1e-4
N_LAYERS = 3
LAYER = 2


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


def _offsets(fresh, bs, region):
    """Flat offsets of packed rows, laid out as the engine does: with a
    ``region``-slot decode region, the leading 1-token rows take one slot
    each in it; every other row takes a block-rounded span after it."""
    n_dec = 0
    while region and n_dec < len(fresh) and fresh[n_dec] == 1:
        n_dec += 1
    offs, off = list(range(n_dec)), region
    for f in fresh[n_dec:]:
        offs.append(off)
        off += -(-f // bs) * bs
    return offs, off


def _layout(rows, bs, m, r_pad, n_blocks, rng, decode_region=0):
    """Pack rows [(start, fresh)] on one flat axis (:func:`_offsets`); rows
    past the real ones are zero padding rows.  Block tables are disjoint,
    random and 0-filled past each row's blocks.  Returns (T, seq_ids
    [1, T], bt [R, M], seq_lens, starts, roff)."""
    offs, t = _offsets([f for _, f in rows], bs, decode_region)
    seq_ids = np.full((1, t), -1, np.int32)
    bt = np.zeros((r_pad, m), np.int32)
    seq_lens, starts, roff = (np.zeros(r_pad, np.int32) for _ in range(3))
    perm = rng.permutation(n_blocks)
    k = 0
    for i, ((start, fresh), o) in enumerate(zip(rows, offs)):
        seq_ids[0, o:o + fresh] = i
        nb = -(-(start + fresh) // bs)
        bt[i, :nb] = perm[k:k + nb]
        k += nb
        seq_lens[i], starts[i], roff[i] = start + fresh, start, o
    return t, seq_ids, bt, seq_lens, starts, roff


def _poison(cache, bt, starts, bs):
    """NaN into every cache slot that is no row's live prefix slot."""
    live = np.zeros(cache.shape[1:2] + (bs,), bool)
    for row, n in zip(bt, starts):
        for j in range(n):
            live[row[j // bs], j % bs] = True
    return np.where(live[None, :, None, :, None], cache, np.nan).astype(cache.dtype)


# name: (H, Hk, D, rows [(start, fresh)], padding rows, decode region, softcap, TQ, C)
CASES = {
    "spans-start-0": (4, 2, 32, [(0, 20), (0, 16), (0, 9)], 1, 0, None, 16, 2),
    "spans-aligned-starts": (4, 2, 32, [(16, 20), (0, 16), (40, 9)], 1, 0, None, 16, 2),
    "unified-decode-rows": (4, 2, 32, [(33, 1), (1, 1), (17, 1), (0, 1), (32, 28), (8, 5)],
                            2, 8, None, 8, 2),
    "zero-length-padding-row": (4, 2, 32, [(24, 12)], 3, 0, None, 16, 4),
    "softcap": (4, 2, 32, [(5, 1), (11, 1), (16, 30)], 0, 8, 30.0, 16, 2),
    "g1": (4, 4, 32, [(9, 1), (0, 1), (24, 13), (8, 16)], 0, 8, None, 16, 2),
    "g8": (16, 2, 32, [(21, 1), (3, 1), (8, 25), (0, 6)], 0, 8, 30.0, 8, 2),
}


# The card's kernel checks' layouts at tiny widths (chip_smoke.py, ragged
# edges), with the pool and tables they need: name: (H, Hk, D, rows,
# padding rows, decode region, softcap, TQ, C, Bs, M, blocks).  The card's
# span blocks hold 128 / G tokens: G = 1, 4 and 8 put a block boundary
# mid-span and at a span end; a full 16-row decode region with contexts
# across several 64-key tiles (64 and 65 among them); decode contexts
# crossing key tiles; spans from starts inside a 64-key tile at flat
# offsets inside one.
EDGE_CASES = {
    "g1-boundary-mid-span": (4, 4, 32, [(0, 100), (16, 60)], 1, 0, None, 16, 2, 8, 16, 40),
    "g4-boundary-at-span-end": (8, 2, 32, [(0, 64), (40, 20), (0, 30)], 1, 0, 30.0, 16, 2, 8, 12, 40),
    "g8-both-boundaries": (16, 2, 32, [(8, 1), (0, 16), (24, 20)], 0, 16, None, 8, 2, 8, 12, 40),
    "full-decode-region": (8, 2, 32, [(n - 1, 1) for n in (1, 2, 9, 63, 64, 65, 100, 128, 129, 150, 200,
                                                            255, 256, 257, 300, 319)] + [(0, 20)],
                           1, 16, None, 8, 4, 8, 40, 320),
    "decode-crossing-key-tiles": (8, 2, 32, [(199, 1), (130, 1), (64, 40)], 1, 8, 30.0, 8, 4, 8, 32, 80),
    "misaligned-starts": (8, 2, 32, [(5, 1), (80, 50), (16, 45)], 2, 8, None, 8, 2, 8, 20, 48),
}


def _case_data(h, hk, d, rows, n_pad, region, cap, tq, c, seed, bs=8, m=12, n_blocks=48):
    """One layout's inputs (seeded numpy) and the JAX package's outputs on
    them: the oracle on a clean pool, and the Pallas kernel in interpret
    mode on a NaN-poisoned pool with NaN padding K/V."""
    rng = np.random.default_rng(seed)
    t, seq_ids, bt, seq_lens, starts, roff = _layout(rows, bs, m, len(rows) + n_pad, n_blocks,
                                                     rng, decode_region=region)
    live = seq_ids[0] >= 0
    cache = rng.normal(size=(N_LAYERS, n_blocks, 2, bs, hk * d)).astype(np.float32)
    q = rng.normal(size=(1, t, h, d)).astype(np.float32)
    k_new = rng.normal(size=(1, t, hk, d)).astype(np.float32)
    v_new = rng.normal(size=(1, t, hk, d)).astype(np.float32)
    max_pb = max(-(-int(s) // bs) for s in starts)
    pb = 0 if max_pb == 0 else min(m, 1 << (max_pb - 1).bit_length())
    oracle = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(cache),
        jnp.int32(LAYER), jnp.asarray(bt), jnp.asarray(seq_lens), jnp.asarray(starts),
        jnp.asarray(roff), jnp.asarray(seq_ids), pb, logit_cap=cap))
    cache_p = _poison(cache, bt, starts, bs)
    k_p, v_p = k_new.copy(), v_new.copy()
    k_p[0, ~live] = np.nan
    v_p[0, ~live] = np.nan
    pallas = np.asarray(pallas_ragged(
        jnp.asarray(q), jnp.asarray(k_p), jnp.asarray(v_p), jnp.asarray(cache_p),
        jnp.int32(LAYER), jnp.asarray(bt), jnp.asarray(seq_lens), jnp.asarray(starts),
        jnp.asarray(roff), logit_cap=cap, rows_per_chunk=tq, blocks_per_chunk=c,
        interpret=True))
    return dict(q=q, k_new=k_new, v_new=v_new, cache=cache, bt=bt, seq_lens=seq_lens,
                starts=starts, roff=roff, seq_ids=seq_ids, pb=pb, cap=cap, live=live,
                cache_p=cache_p, k_p=k_p, v_p=v_p, oracle=oracle, pallas=pallas)


def _check_port(x):
    """The port's plain op and the kernel's plain version against the JAX
    oracle, the plain version against the Pallas kernel on the poisoned
    pool (padding tokens exactly 0), and the wrapper on CPU tensors against
    the plain version."""
    live, cap = x["live"], x["cap"]
    rows = (_t(x["bt"]), _t(x["seq_lens"]), _t(x["starts"]), _t(x["roff"]))
    args = (_t(x["q"]), _t(x["k_new"]), _t(x["v_new"]), _t(x["cache"]), LAYER, *rows)
    op = ops.ragged_prefill_attention(*args, _t(x["seq_ids"]), x["pb"], logit_cap=cap).numpy()
    np.testing.assert_allclose(op[0][live], x["oracle"][0][live], atol=ATOL)
    ref = ragged_prefill_attention_ref(*args, logit_cap=cap).numpy()
    np.testing.assert_allclose(ref[0][live], x["oracle"][0][live], atol=ATOL)

    pargs = (_t(x["q"]), _t(x["k_p"]), _t(x["v_p"]), _t(x["cache_p"]), LAYER, *rows)
    ref_p = ragged_prefill_attention_ref(*pargs, logit_cap=cap)
    assert torch.isfinite(ref_p).all()
    assert (ref_p[0][~torch.from_numpy(live)] == 0).all()  # padding tokens give exactly 0
    np.testing.assert_allclose(ref_p.numpy()[0][live], x["pallas"][0][live], atol=ATOL)

    # on CPU tensors the wrapper is the plain version: same bits, no launch
    before = ragged_paged_prefill_attention.launches
    torch.testing.assert_close(ragged_paged_prefill_attention(*pargs, logit_cap=cap), ref_p,
                               rtol=0, atol=0)
    assert ragged_paged_prefill_attention.launches == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_attention_matches_jax_oracle_and_pallas(case):
    _check_port(_case_data(*CASES[case], seed=sorted(CASES).index(case)))


@pytest.fixture(scope="module")
def edge_data():
    """Every edge case's inputs and JAX outputs, made once in the module's
    set-up: compiling the JAX oracle and the Pallas kernel at each layout's
    shapes is most of a case's time."""
    out = {}
    for i, case in enumerate(sorted(EDGE_CASES)):
        h, hk, d, rows, n_pad, region, cap, tq, c, bs, m, n_blocks = EDGE_CASES[case]
        out[case] = _case_data(h, hk, d, rows, n_pad, region, cap, tq, c, seed=100 + i, bs=bs, m=m,
                               n_blocks=n_blocks)
    return out


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_ragged_attention_edges_match_jax_oracle_and_pallas(edge_data, case):
    _check_port(edge_data[case])


@pytest.mark.parametrize("window", [12, 200])
def test_ragged_attention_window_matches_jax_oracle(window):
    """Sliding window: the port's op takes the position-exact plain path
    when the attended span can exceed the window, full attention otherwise."""
    h, hk, d, bs, m, n_blocks = 4, 2, 16, 8, 10, 40
    rng = np.random.default_rng(11)
    rows = [(19, 1), (6, 1), (16, 20)]
    t, seq_ids, bt, seq_lens, starts, roff = _layout(rows, bs, m, 4, n_blocks, rng,
                                                     decode_region=8)
    live = seq_ids[0] >= 0
    cache = rng.normal(size=(N_LAYERS, n_blocks, 2, bs, hk * d)).astype(np.float32)
    q = rng.normal(size=(1, t, h, d)).astype(np.float32)
    k_new = rng.normal(size=(1, t, hk, d)).astype(np.float32)
    v_new = rng.normal(size=(1, t, hk, d)).astype(np.float32)
    oracle = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(cache),
        jnp.int32(1), jnp.asarray(bt), jnp.asarray(seq_lens), jnp.asarray(starts),
        jnp.asarray(roff), jnp.asarray(seq_ids), 4, window=window))
    out = ops.ragged_prefill_attention(_t(q), _t(k_new), _t(v_new), _t(cache), 1, _t(bt),
                                       _t(seq_lens), _t(starts), _t(roff), _t(seq_ids), 4,
                                       window=window).numpy()
    np.testing.assert_allclose(out[0][live], oracle[0][live], atol=ATOL)


def test_write_kv_cache_layer_row_tokens_matches_jax():
    """The unified layout's split write: the first 16 flat tokens (decode
    rows, any in-block slot, some dropped) scatter per row, the rest take
    the block write (one partly valid block, one dropped block)."""
    rng = np.random.default_rng(12)
    n, bs, hk, d = 16, 8, 2, 16
    cache = rng.normal(size=(N_LAYERS, n, 2, bs, hk * d)).astype(np.float32)
    t = 48
    k_new = rng.normal(size=(1, t, hk, d)).astype(np.float32)
    v_new = rng.normal(size=(1, t, hk, d)).astype(np.float32)
    slot = np.full((1, t), -1, np.int32)
    slot[0, :5] = [3 * bs + 5, 7 * bs + 0, 1 * bs + 7, 12 * bs + 2, 9 * bs + 1]
    slot[0, 16:29] = np.r_[np.arange(8) + 4 * bs, np.arange(5) + 10 * bs]
    ref = jax_write_kv_cache_layer(jnp.asarray(cache), jnp.int32(1), jnp.asarray(k_new),
                                   jnp.asarray(v_new), jnp.asarray(slot), block_aligned=True,
                                   row_tokens=16)
    out = _t(cache)
    ops.write_kv_cache_layer(out, 1, _t(k_new), _t(v_new), _t(slot), block_aligned=True,
                             row_tokens=16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _params(jmodel, seed=0):
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    # perturb every leaf: zero biases and unit norm scales would hide bugs
    return jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype), tree)


def _ragged_dispatch(rows, bs, m, tables, region):
    """Host operands of one ragged forward: rows are (tokens, start) per
    packed row, laid out by :func:`_offsets`."""
    r_pad = 1 << max(0, (len(rows) - 1).bit_length())
    offs, t = _offsets([len(toks) for toks, _ in rows], bs, region)
    tokens = np.zeros((1, t), np.int32)
    pos = np.zeros((1, t), np.int32)
    slot = np.full((1, t), -1, np.int32)
    seq_ids = np.full((1, t), -1, np.int32)
    bt = np.zeros((r_pad, m), np.int32)
    lens, starts, roff = (np.zeros(r_pad, np.int32) for _ in range(3))
    for i, ((toks, start), o) in enumerate(zip(rows, offs)):
        n = len(toks)
        tokens[0, o:o + n] = toks
        p = np.arange(start, start + n)
        pos[0, o:o + n] = p
        bt[i, :len(tables[i])] = tables[i]
        slot[0, o:o + n] = bt[i, p // bs] * bs + p % bs
        seq_ids[0, o:o + n] = i
        lens[i], starts[i], roff[i] = start + n, start, o
    max_pb = max(-(-int(s) // bs) for s in starts)
    pb = 0 if max_pb == 0 else min(m, 1 << (max_pb - 1).bit_length())
    return tokens, pos, bt, lens, slot, (seq_ids, starts, roff), pb, seq_ids[0] >= 0


@pytest.mark.parametrize("variant", ["llama", "gemma2-softcap"])
def test_llama_ragged_forward_matches_jax(variant):
    """A packed prefill of three prompts (two from start 0, one after a
    cached 16-token head), then a mixed dispatch: decode rows for two of
    them at non-aligned positions ahead of a new prompt's span and the
    third prompt's next block-aligned chunk."""
    kw = {} if variant == "llama" else dict(
        hidden_activation="gelu_tanh", rmsnorm_unit_offset=True, scale_embeddings=True,
        post_norms=True, query_pre_attn_scalar=24.0, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, tie_word_embeddings=True)
    jmodel = JaxLlamaModel(JaxModelConfig.tiny(**kw))
    tree = _params(jmodel)
    cfg = ModelConfig.tiny(**kw)
    model = LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))
    jparams = jax.tree.map(jnp.asarray, tree)
    bs, m, n_blocks = 8, 8, 32
    jcache = jmodel.init_kv_cache(n_blocks, bs)
    cache = model.init_kv_cache(n_blocks, bs)
    rng = np.random.default_rng(2)
    a, b, c, e = (rng.integers(0, cfg.vocab_size, n).tolist() for n in (13, 21, 40, 9))
    tables = [[5, 9], [1, 14, 3], [20, 2, 7, 11, 26], [30, 17]]

    def run(rows, tabs, region):
        tokens, pos, bt, lens, slot, ragged, pb, live = _ragged_dispatch(rows, bs, m, tabs, region)
        nonlocal jcache
        jh, jcache = jmodel.forward(jparams, jnp.asarray(tokens), jnp.asarray(pos), jcache,
                                    jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(slot),
                                    prefix_blocks=pb, ragged=tuple(map(jnp.asarray, ragged)),
                                    ragged_row_tokens=region)
        h, _ = model.forward(_t(tokens), _t(pos), cache, _t(bt), _t(lens), _t(slot),
                             prefix_blocks=pb, ragged=tuple(map(_t, ragged)),
                             ragged_row_tokens=region)
        np.testing.assert_allclose(h.numpy()[0][live], np.asarray(jh)[0][live],
                                   atol=HIDDEN_ATOL)

    # packed prefill: a and b from 0, c's head (16 tokens) from 0
    run([(a, 0), (b, 0), (c[:16], 0)], tables[:3], 0)
    # c's next chunk over its cached head (block-aligned start 16)
    run([(c[16:32], 16)], tables[2:3], 0)
    # mixed: decode rows for a and b (positions 13 and 21), then e from 0
    # and c's last chunk from 32
    run([([7], 13), ([11], 21), (e, 0), (c[32:], 32)],
        [tables[0], tables[1], tables[3], tables[2]], bs)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=HIDDEN_ATOL)


def test_ragged_wrapper_raises_off_cuda_and_cpu():
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    t, h, hk, d = 32, 8, 2, 128
    ints = meta(4, dtype=torch.int32)
    before = ragged_paged_prefill_attention.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        ragged_paged_prefill_attention(meta(1, t, h, d), meta(1, t, hk, d), meta(1, t, hk, d),
                                       meta(3, 8, 2, 16, hk * d), 1, meta(4, 4, dtype=torch.int32),
                                       ints, ints, ints)
    assert ragged_paged_prefill_attention.launches == before
