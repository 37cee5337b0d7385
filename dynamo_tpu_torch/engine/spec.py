"""Prompt-lookup (n-gram) speculative decoding — the draft-model-free kind.

Decode emits one token per model pass; speculation verifies K proposed
tokens in ONE pass and keeps the longest correct prefix, so repetitive
continuations (code, extraction, quoting — exactly the long-output
serving workloads) emit several tokens per dispatch.  Proposals come from
the sequence itself: if the last N tokens already occurred earlier, the
tokens that followed that occurrence are likely to follow again
(vLLM's "prompt lookup decoding"; the reference gets this from its
engines' speculative modes).

Verify shape: the engine's S = k + 1 forward against the paged cache
(engine/core.py:spec_verify_step) -- proposed tokens scatter their KV and
attend causally, a SAMPLE at every position comes back (each with its own
noise), and the host accepts the matching prefix.  Rejected positions'
KV is simply overwritten when the real tokens reach those slots (slots
are position-derived).  Exactness: for a point-mass proposal,
sample-and-match IS the canonical rejection-sampling rule (accept w.p.
p(x); a mismatching sample is already the renormalised residual), so
every emitted token is distributed exactly as plain decoding at any
temperature; greedy rows reduce to argmax (bit-identical streams), and
seeded rows are bit-identical with speculation on or off because their
noise is a pure function of (seed, position, token id).

The counterpart of ``dynamo_tpu/engine/spec.py``, the same function under
the same name: pure numpy, host side.

Engine wiring lives in engine/core.py (`spec_tokens`/`spec_ngram`
config); this module is the pure host-side proposer.
"""

from __future__ import annotations

__all__ = ["propose_ngram"]


def propose_ngram(tokens, ngram: int, k: int, min_ngram: int = 1) -> list[int]:
    """Propose up to ``k`` continuation tokens for ``tokens`` by n-gram
    lookup: find the most recent earlier occurrence of the longest suffix
    (length ``ngram`` down to ``min_ngram``) and return the tokens that
    followed it.  Returns [] when nothing matches.
    """
    import numpy as np

    n_total = len(tokens)
    if n_total < min_ngram + 1 or k <= 0:
        return []
    arr = np.asarray(tokens, dtype=np.int64)
    for n in range(min(ngram, n_total - 1), min_ngram - 1, -1):
        suffix = arr[n_total - n:]
        # vectorised match over all candidate starts (n is tiny, so this
        # is n boolean passes over the array — the hot decode loop calls
        # this per row per dispatch, a Python scan would be O(ctx) slices)
        n_cand = n_total - n  # exclude the suffix's own position
        ok = np.ones(n_cand, dtype=bool)
        for j in range(n):
            ok &= arr[j: n_cand + j] == suffix[j]
        hits = np.flatnonzero(ok)
        if hits.size == 0:
            continue
        # the most recent occurrence whose continuation fills all k slots
        # wins (overlapping repeats leave short tails on the nearest match
        # — an earlier one proposes more)
        full = hits[hits + n + k <= n_total]
        start = int(full[-1]) if full.size else int(hits[-1])
        cont = arr[start + n: start + n + k]
        if cont.size:
            return cont.tolist()
    return []
