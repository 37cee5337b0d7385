"""Batched token sampling with logprobs and penalties, in PyTorch.

The counterpart of ``dynamo_tpu/engine/sampling.py::sample_full``: one
vectorised sampler covers greedy / temperature / top-k / top-p / min-p with
per-row parameters, so heterogeneous requests share a single decode step.
Candidates are the top ``k_cand`` logits, found with ``torch.topk`` (exact;
the JAX sampler's approximate ``approx_max_k`` has no counterpart here).

Frequency/presence penalties (OpenAI semantics over *generated* tokens) and
logit bias are scatter-added into the logits before candidate selection.
Logprobs are log-softmax over the *penalised* logits (temperature- and
top-k/p-independent): the chosen token's logprob plus the candidate set's
ids/logprobs for top_logprobs slicing on the host.

Randomness is Gumbel noise.  An unseeded row's is drawn from the caller's
``torch.Generator`` (the engine owns one, seeded from ``EngineConfig.seed``);
``torch.Generator`` and ``jax.random`` draw different bits, so those rows'
streams at temperature > 0 differ from the JAX engine's.  A row with a
per-request ``seed`` (OpenAI ``seed``) draws its noise from
:func:`seeded_gumbel`, a pure function of (seed, position, token id) that
reproduces the JAX engine's ``jax.random`` draw bit for bit, so seeded
streams match the JAX engine's as greedy streams do.
"""

from __future__ import annotations

import torch

K_MAX = 64

__all__ = ["sample_full", "seeded_uniform", "seeded_gumbel", "K_MAX"]

_M32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key words (k0, k1), as ``jax.random``'s threefry PRNG computes it.
    Every word is an int64 tensor holding an unsigned 32-bit value (torch's
    uint32 support is partial), masked back to 32 bits after each add and
    shift; the four broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ (((x1 << r) & _M32) | (x1 >> (32 - r)))
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def seeded_uniform(seeds: torch.Tensor, steps: torch.Tensor,
                   token_ids: torch.Tensor) -> torch.Tensor:
    """[B, K] f32 uniforms in [tiny, 1): for row b and candidate k, the draw
    ``jax.random.uniform(fold_in(fold_in(PRNGKey(seeds[b]), steps[b]),
    token_ids[b, k]), minval=tiny, maxval=1)``, bit for bit.

    ``PRNGKey(s)`` is the key (0, s) for a seed in [0, 2**31); ``fold_in(key,
    x)`` is threefry of the counter (0, x) under ``key``; a scalar draw is
    ``hi ^ lo`` of threefry at counter (0, 0), which is the partitionable
    form that JAX >= 0.5 uses by default (``jax_threefry_partitionable``;
    older releases such as 0.4.37 default to the other form and draw other
    bits).  The top 23 bits fill an f32 mantissa in [1, 2), minus 1, then
    the affine map to [tiny, 1)."""
    seed = seeds.long()[:, None] & 0x7FFFFFFF
    zero = torch.zeros_like(seed)
    k0, k1 = _threefry2x32(zero, seed, zero, steps.long()[:, None] & _M32)
    k0, k1 = _threefry2x32(k0, k1, zero, token_ids.long() & _M32)
    hi, lo = _threefry2x32(k0, k1, zero, zero)
    mant = ((hi ^ lo) >> 9) | 0x3F800000
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    return (u * (1.0 - _TINY) + _TINY).clamp_min(_TINY)


def seeded_gumbel(seeds: torch.Tensor, steps: torch.Tensor,
                  token_ids: torch.Tensor) -> torch.Tensor:
    """[B, K] Gumbel noise ``-log(-log(u))`` of :func:`seeded_uniform`: the
    JAX engine's seeded noise for (seed, position, token id)."""
    return -torch.log(-torch.log(seeded_uniform(seeds, steps, token_ids)))


def _scatter_add_rows(logits: torch.Tensor, tokens: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """``logits[b, tokens[b, j]] += values[b, j]`` for tokens >= 0 (a -1
    pad adds 0 to token 0, which is a no-op)."""
    b, t = tokens.shape
    rows = torch.arange(b, device=logits.device)[:, None].expand(b, t)
    valid = tokens >= 0
    tok = torch.where(valid, tokens, 0).long()
    val = torch.where(valid, values.to(logits.dtype), 0.0)
    return logits.index_put((rows.reshape(-1), tok.reshape(-1)), val.reshape(-1),
                            accumulate=True)


def _apply_penalties(
    logits: torch.Tensor,      # [B, V] f32
    pen_tokens: torch.Tensor,  # [B, T] int32, -1 padded — generated tokens (all occurrences)
    pen_first: torch.Tensor,   # [B, T] bool — True at each token's first occurrence
    freq_pen: torch.Tensor,    # [B] f32
    pres_pen: torch.Tensor,    # [B] f32
) -> torch.Tensor:
    valid = pen_tokens >= 0
    # every occurrence subtracts freq_pen (count * penalty == per-occurrence
    # add); the first occurrence additionally subtracts pres_pen
    upd = -(freq_pen[:, None] * valid + pres_pen[:, None] * (valid & pen_first))
    return _scatter_add_rows(logits, pen_tokens, upd)


def sample_full(
    logits: torch.Tensor,        # [B, V] f32
    generator: torch.Generator | None,
    temperature: torch.Tensor,   # [B] f32; <=0 → greedy
    top_k: torch.Tensor,         # [B] int32; 0 → disabled
    top_p: torch.Tensor,         # [B] f32; 1.0 → disabled
    pen_tokens: torch.Tensor | None = None,  # [B, T] int32 (-1 pad)
    pen_first: torch.Tensor | None = None,   # [B, T] bool
    freq_pen: torch.Tensor | None = None,    # [B] f32
    pres_pen: torch.Tensor | None = None,    # [B] f32
    bias_tokens: torch.Tensor | None = None,  # [B, Nb] int32 (-1 pad)
    bias_vals: torch.Tensor | None = None,    # [B, Nb] f32
    min_p: torch.Tensor | None = None,        # [B] f32; 0 → disabled
    seeds: torch.Tensor | None = None,        # [B] int32 per-request seeds
    seed_rows: torch.Tensor | None = None,    # [B] bool — row uses its seed
    seed_steps: torch.Tensor | None = None,   # [B] int32 fold index (position)
    *,
    k_cand: int = K_MAX,
    gumbel: torch.Tensor | None = None,       # [B, k_cand] noise; drawn when None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (sampled [B], chosen_logprob [B], cand_ids [B, k_cand],
    cand_logprobs [B, k_cand]).  Candidates are sorted descending, so the
    host slices the first ``top_logprobs`` entries per request.

    ``gumbel`` lets a test feed the same noise to this sampler and to the
    JAX one; the engine leaves it None and the noise comes from
    ``generator``.  Seeded rows (``seed_rows``) take :func:`seeded_gumbel`
    noise instead, keyed by the candidate's token id, so their streams do
    not depend on the batch.  Nothing here synchronises with the device."""
    b, v = logits.shape
    k_cand = min(k_cand, v)
    logits = logits.float()

    if bias_tokens is not None:
        # OpenAI logit_bias, added BEFORE candidate selection so a +100
        # bias can promote any token
        logits = _scatter_add_rows(logits, bias_tokens, bias_vals)
    if pen_tokens is not None:
        logits = _apply_penalties(logits, pen_tokens, pen_first, freq_pen, pres_pen)

    vals, idx = torch.topk(logits, k_cand, dim=-1, sorted=True)

    # logprobs over the full (penalised) vocab distribution
    log_z = torch.logsumexp(logits, dim=-1)  # [B]
    cand_lps = vals - log_z[:, None]

    greedy = temperature <= 0.0
    temp = torch.where(greedy, 1.0, temperature.clamp_min(1e-6))[:, None]
    scaled = vals / temp

    rank = torch.arange(k_cand, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, k_cand, top_k.clamp_max(k_cand))[:, None]
    keep_base = rank < k  # the top-k mask, before top-p/min-p filtering

    # top-p over the kept candidates: keep the smallest prefix whose
    # cumulative probability reaches top_p (first token always kept)
    probs = torch.softmax(torch.where(keep_base, scaled, float("-inf")), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep_base & ((cum - probs) < top_p[:, None])
    if min_p is not None:
        # min-p: drop candidates whose probability is below min_p *
        # max_prob; the first (max) candidate always survives
        keep = keep & (probs >= min_p[:, None] * probs[:, :1])

    if seeds is not None:
        # a seeded row's whole pipeline (softmax normalisation, top-p
        # cutoff, min-p floor) runs over the true top-K_MAX, so a companion
        # widening k_cand cannot shift its kept set: a seeded request's
        # effective top_k caps at K_MAX
        kb = keep_base & (rank < min(K_MAX, k_cand))
        probs_s = torch.softmax(torch.where(kb, scaled, float("-inf")), dim=-1)
        cum_s = torch.cumsum(probs_s, dim=-1)
        keep_s = kb & ((cum_s - probs_s) < top_p[:, None])
        if min_p is not None:
            keep_s = keep_s & (probs_s >= min_p[:, None] * probs_s[:, :1])
        keep = torch.where(seed_rows[:, None], keep_s, keep)

    masked = torch.where(keep, scaled, float("-inf"))
    if gumbel is None:
        u = torch.rand((b, k_cand), generator=generator, device=logits.device,
                       dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_(min=_TINY)))
    if seeds is not None:
        # keyed by TOKEN ID, not candidate rank: the stream is the same
        # across runs, burst boundaries and batch compositions
        gumbel = torch.where(seed_rows[:, None], seeded_gumbel(seeds, seed_steps, idx), gumbel)
    choice_sampled = torch.argmax(masked + gumbel, dim=-1)
    choice = torch.where(greedy, 0, choice_sampled)  # top-k output is sorted
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    chosen_lp = torch.gather(cand_lps, 1, choice[:, None])[:, 0]
    return sampled.to(torch.int32), chosen_lp, idx.to(torch.int32), cand_lps
