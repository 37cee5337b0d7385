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

Randomness is Gumbel noise drawn from the caller's ``torch.Generator`` (the
engine owns one, seeded from ``EngineConfig.seed``).  ``torch.Generator``
and ``jax.random`` draw different bits, so sampled streams at temperature >
0 differ from the JAX engine's; greedy rows are deterministic.  Per-request
``seed`` streams are not ported: the engine refuses such requests.
"""

from __future__ import annotations

import torch

K_MAX = 64

__all__ = ["sample_full", "K_MAX"]


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
    *,
    k_cand: int = K_MAX,
    gumbel: torch.Tensor | None = None,       # [B, k_cand] noise; drawn when None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (sampled [B], chosen_logprob [B], cand_ids [B, k_cand],
    cand_logprobs [B, k_cand]).  Candidates are sorted descending, so the
    host slices the first ``top_logprobs`` entries per request.

    ``gumbel`` lets a test feed the same noise to this sampler and to the
    JAX one; the engine leaves it None and the noise comes from
    ``generator``.  Nothing here synchronises with the device."""
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

    masked = torch.where(keep, scaled, float("-inf"))
    if gumbel is None:
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand((b, k_cand), generator=generator, device=logits.device,
                       dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
    choice_sampled = torch.argmax(masked + gumbel, dim=-1)
    choice = torch.where(greedy, 0, choice_sampled)  # top-k output is sorted
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    chosen_lp = torch.gather(cand_lps, 1, choice[:, None])[:, 0]
    return sampled.to(torch.int32), chosen_lp, idx.to(torch.int32), cand_lps
