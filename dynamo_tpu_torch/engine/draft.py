"""Draft-model speculative decoding — the proposer half, in PyTorch.

The counterpart of ``dynamo_tpu/engine/draft.py``.  A small draft model
(same tokenizer/vocab as the target) keeps its own paged KV cache and
proposes ``k`` greedy continuations per sequence in ONE dispatch; the
target engine verifies them with its rejection-sampled verify pass
(engine/core.py:spec_verify_step).  Greedy point-mass proposals keep the
verify rule exact at any temperature, and seeded streams remain
bit-identical with speculation on or off — the draft only changes WHICH
tokens get proposed, never how emitted tokens are sampled.

Shape of a dispatch: the draft ingests each row's not-yet-seen tokens (one
S = U forward over the paged draft cache, U a power-of-two bucket) and then
runs k - 1 single-token steps, a Python loop on the device (the JAX
package's ``lax.scan``), with ONE host read of the [B, k] proposals at the
end.  The draft lags the target by exactly the tokens emitted since its
last dispatch, so in steady operation U stays <= k + 1; a freshly admitted
row's first dispatch ingests its whole prompt (chunked through the same
buckets).

The ingest forward has no ``prefix_blocks`` (its rows start anywhere, a
fresh prompt beside steady rows in one padded dispatch), so on the card an
ingest of U <= ``MQ_MAX_S`` tokens takes the decode kernel and a longer one
the position-exact plain attention op, as the JAX package routes it; the k
- 1 steps take the decode kernel at S = 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["DraftProposer"]

_MAX_INGEST_BUCKET = 512  # longest single ingest dispatch (prompt chunks)


class DraftProposer:
    """Owns the draft model's paged cache + per-slot sync state.  The model
    holds its own weights (the JAX package's (model, params) pair)."""

    def __init__(self, model, config, num_blocks: Optional[int] = None):
        self.model = model
        self.config = config
        self.block_size = config.block_size
        self.device = model.device
        nb = num_blocks or config.num_blocks
        # the draft cache follows the engine's cache kind: int8 when the
        # engine's is int8 (quantisation error only shifts PROPOSALS; the
        # target's verification stays exact), else the draft's own dtype
        self.cache = model.init_kv_cache(
            nb, config.block_size, "int8" if str(config.cache_dtype) == "int8" else None)
        self._free = list(range(nb))
        self._blocks: dict[int, list[int]] = {}   # slot -> draft block ids
        self._synced: dict[int, int] = {}         # slot -> tokens ingested
        self.dispatches = 0

    # ------------------------------------------------------------- lifecycle
    def release(self, slot: int) -> None:
        """Return a finished/aborted slot's draft blocks to the pool."""
        self._free.extend(self._blocks.pop(slot, ()))
        self._synced.pop(slot, None)

    # ------------------------------------------------------------- device fn
    @torch.no_grad()
    def _impl(self, tokens, positions, block_tables, seq_lens, slot_idx, last_idx, active, k):
        """Ingest U tokens per row, then draft k greedy tokens.

        tokens/positions/slot_idx: [B, U] (-1-padded slots drop writes);
        seq_lens: [B] context length AFTER ingest; last_idx: [B] index of
        each row's last real ingest token; active: [B] bool.
        Returns the proposals [B, k] int32 on the device."""
        model, bs = self.model, self.block_size
        b = tokens.shape[0]
        hidden, _ = model.forward(tokens, positions, self.cache, block_tables, seq_lens,
                                  slot_idx)
        h_last = hidden[torch.arange(b, device=hidden.device), last_idx.long()]
        tok = torch.argmax(model.compute_logits(h_last), dim=-1).to(torch.int32)
        # position of the first drafted token = the row's context length
        pos, lens = seq_lens, seq_lens
        m = block_tables.shape[1]
        drafted = []
        for _ in range(k - 1):
            blk = (pos // bs).clamp_max(m - 1)
            base = torch.gather(block_tables, 1, blk[:, None].long())[:, 0]
            slot = torch.where(active, base * bs + pos % bs, -1)
            hidden, _ = model.forward(tok[:, None], pos[:, None], self.cache, block_tables,
                                      lens + 1, slot[:, None])
            drafted.append(tok)
            tok = torch.argmax(model.compute_logits(hidden[:, 0]), dim=-1).to(torch.int32)
            pos, lens = pos + 1, lens + 1
        return torch.stack(drafted + [tok], dim=1)

    # ---------------------------------------------------------------- propose
    def _grow(self, slot: int, want_tokens: int) -> bool:
        """Ensure the slot's draft block table covers ``want_tokens``.
        All-or-nothing: a row that cannot fully grow takes NOTHING —
        partial grabs would strand pool blocks on rows that can never
        draft, starving every other row until the hoarders finish."""
        ids = self._blocks.setdefault(slot, [])
        need = (max(want_tokens, 1) - 1) // self.block_size + 1
        if need - len(ids) > len(self._free):
            return False
        while len(ids) < need:
            ids.append(self._free.pop())
        return True

    def _read(self, props: torch.Tensor) -> np.ndarray:
        """The one device->host read of a dispatch's proposals."""
        return props.cpu().numpy()

    def _dispatch(self, entries, k: int, draft_active: bool) -> np.ndarray:
        """One draft dispatch over ``entries`` = [(req, start, n)] rows
        placed AT THEIR SLOT in a batch padded to max_batch_size.  The
        block table is sliced to the live context (pow2 of the widest row)
        like the verify path.  Returns the [B, k] proposals (pad rows
        garbage — caller indexes by slot)."""
        b = self.config.max_batch_size
        u = 1 << max(0, (max(n for _, _, n in entries) - 1).bit_length())
        m = 1 << max(0, (max(len(self._blocks[req.slot])
                             for req, _, _ in entries) - 1).bit_length())
        # every operand is int32: one host buffer, one upload, views after
        buf = np.zeros(3 * b * u + b * m + 3 * b, np.int32)
        tokens, positions, slot_idx = (buf[i * b * u:(i + 1) * b * u].reshape(b, u)
                                       for i in range(3))
        bt = buf[3 * b * u:3 * b * u + b * m].reshape(b, m)
        seq_lens, last_idx, active = buf[3 * b * u + b * m:].reshape(3, b)
        slot_idx[:] = -1
        for req, start, n in entries:
            i = req.slot
            ids = np.asarray(self._blocks[i], np.int32)
            tokens[i, :n] = req.seq.tokens[start:start + n]
            positions[i, :n] = np.arange(start, start + n, dtype=np.int32)
            blk = positions[i, :n] // self.block_size
            slot_idx[i, :n] = ids[blk] * self.block_size + positions[i, :n] % self.block_size
            bt[i, :len(ids)] = ids
            seq_lens[i] = start + n
            last_idx[i] = n - 1
            active[i] = draft_active
            self._synced[i] = start + n
        up = torch.from_numpy(buf).to(self.device)
        o = 3 * b * u + b * m
        props = self._impl(
            up[:b * u].view(b, u), up[b * u:2 * b * u].view(b, u),
            up[3 * b * u:o].view(b, m), up[o:o + b], up[2 * b * u:3 * b * u].view(b, u),
            up[o + b:o + 2 * b], up[o + 2 * b:] != 0, k)
        self.dispatches += 1
        return self._read(props)

    def propose(self, reqs, k: int, max_blocks_per_seq: int) -> dict[int, list[int]]:
        """Draft up to ``k`` tokens for each RUNNING request.  Returns
        {slot: proposal tokens}; a row the draft cannot serve this round
        (no free blocks / table overflow) is simply absent — the caller
        falls back to the n-gram proposer for it.

        Rows far behind (fresh long prompts) catch up via at most ONE
        batched ingest-only dispatch per call (k=1, proposals discarded,
        all behind rows in one padded batch) and are skipped for
        proposals until caught up — a 32k prompt costs one extra
        dispatch per engine step for a few steps instead of stalling its
        batch-mates behind ~64 serial dispatches in one step.
        """
        rows = []
        behind = []
        for req in reqs:
            slot = req.slot
            total = req.seq.total_tokens
            if total + k > max_blocks_per_seq * self.block_size:
                continue
            if not self._grow(slot, total + k):
                continue
            if total - self._synced.get(slot, 0) > _MAX_INGEST_BUCKET:
                behind.append(req)
            else:
                rows.append(req)
        if behind:
            self._dispatch(
                [(req, self._synced.get(req.slot, 0), _MAX_INGEST_BUCKET)
                 for req in behind],
                k=1, draft_active=False,
            )
            # a row fully caught up by that chunk may draft this round
            rows.extend(
                req for req in behind
                if req.seq.total_tokens - self._synced[req.slot]
                <= _MAX_INGEST_BUCKET
            )
        if not rows:
            return {}
        entries = [
            (req, self._synced.get(req.slot, 0),
             req.seq.total_tokens - self._synced.get(req.slot, 0))
            for req in rows
        ]
        props = self._dispatch(entries, k=k, draft_active=True)
        # the drafted tokens' KV was written at positions seq_lens..+k-1;
        # the NEXT dispatch re-ingests the really-accepted tokens over
        # those slots, so sync state advances only by ingested tokens
        return {req.slot: [int(t) for t in props[req.slot, :k]]
                for req in rows}
