"""The PyTorch sampler against the JAX ``sample_full`` on the same inputs.

Logits, penalty buffers and logit bias come from a numpy seed and go to
both samplers.  ``jax.random`` and ``torch.Generator`` draw different bits,
so the port is handed the very Gumbel noise the JAX sampler draws from its
key (``sample_full(gumbel=...)``); with the same noise every mask — top-k,
top-p, min-p — shows up as the same sampled token.  The JAX side runs with
``exact=True`` (its ``approx_max_k`` has no counterpart in the port, whose
``torch.topk`` is exact).

Rows with a per-request seed need no such hand-over: ``seeded_uniform``
reproduces the JAX engine's seeded draw
``uniform(fold_in(fold_in(PRNGKey(seed), step), token_id))`` bit for bit
(threefry in its partitionable form, the default since JAX 0.5, pinned
here with ``jax.threefry_partitionable(True)``), and ``sample_full`` with
``seeds`` picks the JAX sampler's ids from its own noise.

Tolerance: sampled and candidate ids exactly equal; logprobs atol 1e-5 (f32
log-softmax over the same logits, summation order aside); seeded uniforms
bit-equal; seeded Gumbel values within 2.4e-7 x max(1, |g|) (two f32 logs,
one ulp each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.sampling import sample_full as jax_sample_full
from dynamo_tpu_torch.engine.sampling import K_MAX, sample_full, seeded_gumbel, seeded_uniform

LP_ATOL = 1e-5
B, V = 16, 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    # peaked rows (scale 4) make top-p/min-p cut inside the candidate set
    logits = (rng.normal(size=(B, V)) * rng.choice([1.0, 4.0], size=(B, 1))).astype(np.float32)
    temp = rng.choice([0.0, 0.7, 1.0, 1.5], size=B).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 40], size=B).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.5], size=B).astype(np.float32)
    min_p = rng.choice([0.0, 0.05, 0.2], size=B).astype(np.float32)
    return rng, logits, temp, top_k, top_p, min_p


def _both(logits, temp, top_k, top_p, seed, k_cand=K_MAX, **extra):
    key = jax.random.PRNGKey(seed)
    ref = jax_sample_full(jnp.asarray(logits), key, jnp.asarray(temp), jnp.asarray(top_k),
                          jnp.asarray(top_p), k_cand=k_cand, exact=True,
                          **{k: jnp.asarray(v) for k, v in extra.items()})
    noise = np.array(jax.random.gumbel(key, (B, min(k_cand, V)), dtype=jnp.float32))
    out = sample_full(torch.from_numpy(logits), None, torch.from_numpy(temp),
                      torch.from_numpy(top_k), torch.from_numpy(top_p), k_cand=k_cand,
                      gumbel=torch.from_numpy(noise),
                      **{k: torch.from_numpy(v) for k, v in extra.items()})
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


def _assert_same(ref, out):
    np.testing.assert_array_equal(out[0], ref[0])            # sampled token
    np.testing.assert_allclose(out[1], ref[1], atol=LP_ATOL)  # its logprob
    np.testing.assert_array_equal(out[2], ref[2])            # candidate ids
    np.testing.assert_allclose(out[3], ref[3], atol=LP_ATOL)  # candidate logprobs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_topp_minp_match_jax(seed):
    _, logits, temp, top_k, top_p, min_p = _inputs(seed)
    ref, out = _both(logits, temp, top_k, top_p, seed, min_p=min_p)
    _assert_same(ref, out)
    greedy = temp <= 0
    np.testing.assert_array_equal(out[0][greedy], logits[greedy].argmax(-1))


def test_penalties_and_logit_bias_match_jax():
    rng, logits, temp, top_k, top_p, _ = _inputs(3)
    t = 24
    pen_tokens = rng.integers(0, 40, size=(B, t)).astype(np.int32)  # repeats on purpose
    pen_tokens[:, 18:] = -1
    pen_first = np.zeros((B, t), bool)
    for i in range(B):
        seen = set()
        for j, tok in enumerate(pen_tokens[i]):
            if tok >= 0 and tok not in seen:
                pen_first[i, j] = True
                seen.add(tok)
    freq = rng.choice([0.0, 0.5, 1.5], size=B).astype(np.float32)
    pres = rng.choice([0.0, 0.3, 2.0], size=B).astype(np.float32)
    bias_tokens = np.full((B, 8), -1, np.int32)
    bias_tokens[:, :3] = rng.integers(0, V, size=(B, 3))
    bias_vals = np.where(bias_tokens >= 0, rng.choice([-100.0, 5.0, 100.0], size=(B, 8)),
                         0.0).astype(np.float32)
    ref, out = _both(logits, temp, top_k, top_p, 3, pen_tokens=pen_tokens, pen_first=pen_first,
                     freq_pen=freq, pres_pen=pres, bias_tokens=bias_tokens, bias_vals=bias_vals)
    _assert_same(ref, out)


def test_wide_candidate_set_matches_jax():
    _, logits, temp, top_k, top_p, _ = _inputs(4)
    top_k[:4] = 100  # beyond K_MAX: the engine widens k_cand to 128
    ref, out = _both(logits, temp, top_k, top_p, 4, k_cand=128)
    _assert_same(ref, out)


def test_generator_noise_is_seeded_and_greedy_ignores_it():
    _, logits, temp, top_k, top_p, _ = _inputs(5)
    args = [torch.from_numpy(a) for a in (logits, temp, top_k, top_p)]

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return sample_full(args[0], g, *args[1:])[0].numpy()

    np.testing.assert_array_equal(draw(7), draw(7))
    greedy = temp <= 0
    np.testing.assert_array_equal(draw(8)[greedy], logits[greedy].argmax(-1))


def _triples(n, seed):
    """Random (seed, step, token id) triples, the extremes of each range
    included."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 31, size=n).astype(np.int32)
    steps = rng.integers(0, 1 << 17, size=n).astype(np.int32)
    toks = rng.integers(0, 152_064, size=n).astype(np.int32)
    seeds[:3], steps[:3], toks[:3] = [0, 2 ** 31 - 1, 1], [0, 1, (1 << 17) - 1], [0, 1, 128_255]
    return seeds, steps, toks


def _jax_seeded(seeds, steps, toks):
    tiny = jnp.finfo(jnp.float32).tiny

    def one(seed, step, tok):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), step), tok)
        return (jax.random.uniform(key, (), minval=tiny, maxval=1.0),
                jax.random.gumbel(key, (), dtype=jnp.float32))

    with jax.threefry_partitionable(True):
        u, g = jax.vmap(one)(jnp.asarray(seeds), jnp.asarray(steps), jnp.asarray(toks))
    return np.asarray(u), np.asarray(g)


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_noise_matches_jax(seed):
    seeds, steps, toks = _triples(2048, seed)
    ref_u, ref_g = _jax_seeded(seeds, steps, toks)
    # [B, K] layout as the sampler calls it: one seed and step per row
    args = (torch.from_numpy(seeds), torch.from_numpy(steps), torch.from_numpy(toks)[:, None])
    u = seeded_uniform(*args)[:, 0].numpy()
    g = seeded_gumbel(*args)[:, 0].numpy()
    np.testing.assert_array_equal(u.view(np.int32), ref_u.view(np.int32))
    assert np.all(np.abs(g - ref_g) <= 2.4e-7 * np.maximum(1.0, np.abs(ref_g)))


@pytest.mark.parametrize("k_cand", [K_MAX, 128])
def test_seeded_rows_match_jax(k_cand):
    """Half the rows seeded (the same seed on two rows, steps apart):
    seeded rows draw their own noise in both samplers, unseeded rows are
    handed the JAX sampler's key noise.  At k_cand 128 a seeded row's
    window still caps at K_MAX."""
    rng, logits, temp, top_k, top_p, min_p = _inputs(6 + k_cand)
    temp = np.where(temp > 0, temp, 0.8).astype(np.float32)  # greedy rows ignore seeds
    seed_rows = np.arange(B) % 2 == 0
    seeds = np.where(seed_rows, rng.integers(0, 2 ** 31, size=B), 0).astype(np.int32)
    seeds[2] = seeds[0]
    steps = rng.integers(0, 4096, size=B).astype(np.int32)
    if k_cand > K_MAX:
        top_k[:4] = 100
    key = jax.random.PRNGKey(6)
    with jax.threefry_partitionable(True):
        ref = jax_sample_full(jnp.asarray(logits), key, jnp.asarray(temp), jnp.asarray(top_k),
                              jnp.asarray(top_p), min_p=jnp.asarray(min_p),
                              seeds=jnp.asarray(seeds), seed_rows=jnp.asarray(seed_rows),
                              seed_steps=jnp.asarray(steps), k_cand=k_cand, exact=True)
        noise = np.array(jax.random.gumbel(key, (B, k_cand), dtype=jnp.float32))
    t = torch.from_numpy
    out = sample_full(t(logits), None, t(temp), t(top_k), t(top_p), min_p=t(min_p), seeds=t(seeds),
                      seed_rows=t(seed_rows), seed_steps=t(steps), k_cand=k_cand,
                      gumbel=t(noise))
    _assert_same([np.asarray(r) for r in ref], [o.numpy() for o in out])
    # the seeded picks do not depend on the hand-over noise
    out2 = sample_full(t(logits), None, t(temp), t(top_k), t(top_p), min_p=t(min_p),
                       seeds=t(seeds), seed_rows=t(seed_rows), seed_steps=t(steps),
                       k_cand=k_cand, gumbel=t(noise[::-1].copy()))
    np.testing.assert_array_equal(out2[0].numpy()[seed_rows], out[0].numpy()[seed_rows])
