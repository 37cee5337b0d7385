"""EngineCore — the continuous-batching scheduler + executor, in PyTorch.

The counterpart of ``dynamo_tpu/engine/core.py`` on its default path: one
request's prefill (or prefill chunk) per dispatch through
:func:`unified_step`, then multi-step decode bursts for every running slot
through :func:`multi_decode_step`.  The model's forward handles any [B, S]
of new tokens against the paged cache, which is one tensor updated in place.

Scheduling policy: admit waiting requests into free slots, run at most one
prefill step per iteration, otherwise one decode burst for all running
slots; with chunked prefill the two alternate while both have work.
Prefix-cache hits shorten prefill via the block manager.

The decode burst is a Python loop on the device (the JAX engine's
``lax.scan``): forward → sample → feed the token back, ``decode_steps``
times, with ONE host sync at the end of the burst.

Not ported yet, and refused at construction (:meth:`EngineCore.
_check_supported`): token-budget ragged prefill, unified and lookahead
dispatch, speculative decoding, sequence-parallel prefill, host offload and
the persistent tier, the int8 cache, meshes, and the profile hook.
Constrained decoding and per-request ``seed`` streams are refused per
request with ``FinishReason.ERROR``.

Thread-safety: everything here runs on the engine thread; submit()/abort()
are the only cross-thread entry points and only touch thread-safe queues.
"""

from __future__ import annotations

import logging
import queue
import time
from typing import Optional

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.request import EngineRequest, RequestState
from dynamo_tpu_torch.engine.sampling import K_MAX, sample_full
from dynamo_tpu_torch.llm.kv.block_manager import KvBlockManager, NoFreeBlocks
from dynamo_tpu_torch.llm.protocols import FinishReason, LLMEngineOutput
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger("dynamo_tpu_torch.engine")

__all__ = ["EngineCore", "unified_step", "multi_decode_step"]


def _pack(sampled, lp, cids, clps) -> torch.Tensor:
    """One f32 [B, 2 + 2C] tensor of a step's results, so the host reads a
    step (or a whole burst) back with one copy.  Token ids are below 2**24
    and therefore exact in f32."""
    return torch.cat([sampled[:, None].float(), lp[:, None], cids.float(), clps], dim=1)


def _unpack(res: np.ndarray):
    """(sampled, logprob, cand_ids, cand_lps) from a packed [..., 2 + 2C]
    host array."""
    c = (res.shape[-1] - 2) // 2
    return (res[..., 0].astype(np.int64), res[..., 1],
            res[..., 2:2 + c].astype(np.int64), res[..., 2 + c:])


@torch.no_grad()
def unified_step(model: LlamaModel, cache, tokens, positions, block_tables, seq_lens,
                 slot_idx, last_idx, generator, temp, top_k, top_p, prefix_blocks=None,
                 k_cand=K_MAX, min_p=None, bias_tokens=None, bias_vals=None):
    """The serving step: forward over the paged cache (written in place),
    gather each row's last hidden state, project to logits, sample.

    Returns the packed [B, 2 + 2C] result (see :func:`_pack`) on the
    device; nothing here synchronises with it."""
    hidden, _ = model.forward(tokens, positions, cache, block_tables, seq_lens, slot_idx,
                              prefix_blocks=prefix_blocks)
    b = tokens.shape[0]
    last_h = hidden[torch.arange(b, device=hidden.device), last_idx.long()]  # [B, Dm]
    logits = model.compute_logits(last_h)  # [B, V] f32
    out = sample_full(logits, generator, temp, top_k, top_p, bias_tokens=bias_tokens,
                      bias_vals=bias_vals, min_p=min_p, k_cand=k_cand)
    return _pack(*out)


@torch.no_grad()
def multi_decode_step(model: LlamaModel, cache, last_tokens, positions, block_tables,
                      seq_lens, limits, generator, temp, top_k, top_p, pen=None,
                      min_p=None, bias_tokens=None, bias_vals=None, *, num_steps: int,
                      block_size: int, k_cand: int = K_MAX):
    """``num_steps`` decode iterations on the device in one dispatch
    (multi-step scheduling): forward → sample → feed the token back.

    ``limits[i]`` is the max total tokens sequence i has block space for:
    a position at/past its limit writes no KV (slot -1) and the host
    discards its samples; the context length is clamped at the limit so
    the block table is never walked past the row's blocks.  Inactive rows
    have limits=0.

    ``pen`` = (pen_tokens [B,T] -1-padded, pen_first, pen_cursor [B],
    freq_pen, pres_pen): each newly sampled token is appended on the device
    so mid-burst repeats are penalised without a host round trip.

    Returns the packed [K, B, 2 + 2C] results on the device."""
    m = block_tables.shape[1]
    rows = torch.arange(last_tokens.shape[0], device=last_tokens.device)
    toks, pos, lens = last_tokens, positions, seq_lens
    if pen is not None:
        ptoks, pfirst, cur, freq, pres = (t.clone() for t in pen)
        t_cap = ptoks.shape[1]
    outs = []
    for _ in range(num_steps):
        blk = (pos // block_size).clamp_max(m - 1)
        base = torch.gather(block_tables, 1, blk[:, None].long())[:, 0]
        slot = torch.where(pos < limits, base * block_size + pos % block_size, -1)
        hidden, _ = model.forward(toks[:, None], pos[:, None], cache, block_tables, lens,
                                  slot[:, None])
        logits = model.compute_logits(hidden[:, 0])
        out = sample_full(
            logits, generator, temp, top_k, top_p,
            *((ptoks, pfirst, freq, pres) if pen is not None else ()),
            bias_tokens=bias_tokens, bias_vals=bias_vals, min_p=min_p, k_cand=k_cand,
        )
        sampled = out[0]
        if pen is not None:
            seen = (ptoks == sampled[:, None]).any(dim=-1)
            at = cur.clamp_max(t_cap - 1).long()
            ptoks[rows, at] = sampled
            pfirst[rows, at] = ~seen
            cur = (cur + 1).clamp_max(t_cap - 1)
        outs.append(_pack(*out))
        # past the limit no KV was written: an unclamped length would walk
        # the block table out of bounds
        lens = torch.minimum(lens + 1, limits)
        toks, pos = sampled, pos + 1
    return torch.stack(outs)


class EngineCore:
    def __init__(
        self,
        model: LlamaModel,
        config: EngineConfig,
        eos_token_ids: Optional[list[int]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine on {self.device}")
        self._check_supported(model, config)
        self.model = model
        self.config = config
        self.eos_token_ids = set(eos_token_ids or [])
        self.block_manager = KvBlockManager(
            config.num_blocks, config.block_size,
            enable_prefix_reuse=config.enable_prefix_reuse,
        )
        # one tensor for the whole model, updated in place by every step
        self.cache = model.init_kv_cache(config.num_blocks, config.block_size)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)

        self.slots: list[Optional[EngineRequest]] = [None] * config.max_batch_size
        self.waiting: "queue.SimpleQueue[EngineRequest]" = queue.SimpleQueue()
        self._admitted: list[EngineRequest] = []  # waiting for a slot/blocks
        self._by_id: dict[str, EngineRequest] = {}
        self._abort_q: "queue.SimpleQueue[str]" = queue.SimpleQueue()
        # aborts that arrived before their request was even admitted
        self._pending_aborts: set[str] = set()
        # perf counters
        self.steps = 0
        self.prefill_steps = 0
        self.prefill_dispatches = 0
        self.prefill_rows_dispatched = 0
        self.decode_steps = 0
        self.tokens_generated = 0
        self.prompt_tokens_computed = 0  # actual prefill work (dedupe-aware)
        self.device_gets = 0             # step-loop device->host result reads
        # host time per turn: a step's wall time minus its device waits
        self._host_s = 0.0
        self._wait_s = 0.0
        self._turns = 0
        self._last_was_prefill = False

    @staticmethod
    def _check_supported(model: LlamaModel, cfg: EngineConfig) -> None:
        """Refuse the options whose paths are not ported yet, instead of
        serving them on a path that ignores them."""
        unported = {
            "prefill_token_budget": cfg.prefill_token_budget > 0,
            "unified_token_dispatch": cfg.unified_token_dispatch,
            "lookahead_dispatch": cfg.lookahead_dispatch,
            "spec_tokens": cfg.spec_tokens > 0,
            "sp_prefill_threshold": cfg.sp_prefill_threshold > 0,
            "num_host_blocks": cfg.num_host_blocks > 0,
            "kv_persist_dir": bool(cfg.kv_persist_dir),
            "cache_dtype": cfg.cache_dtype not in (None, model.config.dtype),
            "mesh_shape": tuple(cfg.mesh_shape) != (1, 1),
            "profile_dir": bool(cfg.profile_dir),
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise ValueError(f"EngineConfig options not supported by the PyTorch engine: {bad}")

    # ------------------------------------------------------------ dispatch
    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _read(self, packed: torch.Tensor) -> np.ndarray:
        """The one device->host read of a dispatch's packed results."""
        t0 = time.perf_counter()
        res = packed.cpu().numpy()
        self._wait_s += time.perf_counter() - t0
        self.device_gets += 1
        return res

    def _sampling_extras(self, reqs, rows=None, b=None) -> dict:
        """min_p / logit_bias tensors for one dispatch, or {} when no
        request uses them.  ``rows``: slot index per request for
        batch-shaped dispatches (decode); None = requests are the dispatch
        rows in order (prefill)."""
        kw = {}
        if b is None:
            b = self.config.max_batch_size if rows is not None else len(reqs)
        at = (lambda i: rows[i]) if rows is not None else (lambda i: i)
        if any(r.sampling.min_p > 0 for r in reqs):
            mp = np.zeros(b, np.float32)
            for i, r in enumerate(reqs):
                mp[at(i)] = r.sampling.min_p
            kw["min_p"] = self._up(mp)
        if any(r.sampling.logit_bias for r in reqs):
            longest = max(len(r.sampling.logit_bias or {}) for r in reqs)
            nb = max(8, 1 << (longest - 1).bit_length())
            toks = np.full((b, nb), -1, np.int32)
            vals = np.zeros((b, nb), np.float32)
            for i, r in enumerate(reqs):
                for j, (t, v) in enumerate(list((r.sampling.logit_bias or {}).items())[:nb]):
                    toks[at(i), j] = int(t)
                    vals[at(i), j] = float(v)
            kw["bias_tokens"] = self._up(toks)
            kw["bias_vals"] = self._up(vals)
        return kw

    @staticmethod
    def _k_cand(reqs) -> int:
        """Candidate-set width: K_MAX, widened (power-of-two, at most 1024)
        when a request asks for top_k beyond it, so a large top_k never
        silently truncates."""
        want = max((r.sampling.top_k for r in reqs), default=0)
        return min(1 << (want - 1).bit_length(), 1024) if want > K_MAX else K_MAX

    # ------------------------------------------------------- cross-thread API
    def submit(self, request: EngineRequest) -> None:
        request.submitted_at = time.perf_counter()
        self.waiting.put(request)

    def abort(self, request_id: str) -> None:
        self._abort_q.put(request_id)

    def has_work(self) -> bool:
        return (
            not self.waiting.empty()
            or bool(self._admitted)
            or any(s is not None for s in self.slots)
        )

    def fail_all(self) -> None:
        """Fail every in-flight and queued request (engine step blew up) so
        callers get an error finish instead of a hung stream."""
        for req in [r for r in self.slots if r is not None]:
            self._finish_slot(req, FinishReason.ERROR)
        for req in self._admitted:
            self._finish(req, FinishReason.ERROR)
        self._admitted.clear()
        while True:
            try:
                self._finish(self.waiting.get_nowait(), FinishReason.ERROR)
            except queue.Empty:
                break

    def metrics(self) -> dict:
        """ForwardPassMetrics equivalent, under the JAX engine's key names
        (the dispatch paths not ported here report 0)."""
        active = sum(1 for s in self.slots if s is not None)
        return {
            "request_active_slots": active,
            "request_total_slots": self.config.max_batch_size,
            "kv_active_blocks": self.block_manager.active_blocks,
            "kv_total_blocks": self.block_manager.num_blocks,
            "num_requests_waiting": self.waiting.qsize() + len(self._admitted),
            "kv_usage_perc": self.block_manager.usage,
            "tokens_generated": self.tokens_generated,
            "spec_steps": 0,
            "spec_proposed": 0,
            "spec_accepted": 0,
            "prefill_dispatches_total": self.prefill_dispatches,
            "prefill_batch_occupancy": (
                self.prefill_rows_dispatched / self.prefill_dispatches
                if self.prefill_dispatches else 0.0
            ),
            "prefill_budget_utilization": 0.0,
            "unified_dispatches_total": 0,
            "unified_decode_rows": 0,
            "unified_prefill_tokens": 0,
            "unified_budget_utilization": 0.0,
            "lookahead_bursts_total": 0,
            "lookahead_hits_total": 0,
            "lookahead_mispredicts_total": 0,
            "lookahead_commits_total": 0,
            "lookahead_flushes_total": 0,
            "lookahead_dispatch_depth": 0,
            "device_gets_total": self.device_gets,
            "host_gap_ms_per_turn": (
                1e3 * self._host_s / self._turns if self._turns else 0.0
            ),
        }

    # -------------------------------------------------------------- main loop
    def step(self) -> bool:
        """Run one scheduling iteration.  Returns False when idle."""
        t0 = time.perf_counter()
        self._wait_s = 0.0
        did_work = self._step_inner()
        if did_work:
            self._host_s += time.perf_counter() - t0 - self._wait_s
            self._turns += 1
        return did_work

    def _step_inner(self) -> bool:
        self._process_aborts()
        self._admit()
        # slots not yet decoding (mid-chunked-prefill): honour aborts here —
        # _append_token never runs for them
        for req in self.slots:
            if req is not None and req.state is RequestState.PREFILL and req.abort_requested:
                self._finish_slot(req, FinishReason.CANCELLED)
        ready = [
            r for r in self.slots
            if r is not None and r.state is RequestState.PREFILL and self._prefill_ready(r)
        ]
        decoding = any(r is not None and r.state is RequestState.RUNNING for r in self.slots)
        # chunked-prefill interleave: when both phases have work, alternate
        # one prefill chunk with one decode burst so admissions never stall
        # the decoders for a whole long prompt
        if ready and decoding and self.config.prefill_chunk_tokens:
            if self._last_was_prefill:
                self._last_was_prefill = False
                self._run_decode()
            else:
                self._last_was_prefill = True
                self._run_prefill(ready[0])
            return True
        if ready:
            self._last_was_prefill = True
            self._run_prefill(ready[0])
            return True
        if decoding:
            self._last_was_prefill = False
            self._run_decode()
            return True
        return False

    def _process_aborts(self) -> None:
        while True:
            try:
                rid = self._abort_q.get_nowait()
            except queue.Empty:
                break
            req = self._by_id.get(rid)
            if req is not None:
                req.abort_requested = True
                continue
            admitted = next((r for r in self._admitted if r.request_id == rid), None)
            if admitted is not None:
                admitted.abort_requested = True
                continue
            # not seen yet: the request may still be in the cross-thread
            # waiting queue — remember the abort so admission applies it
            self._pending_aborts.add(rid)

    def _drain_waiting(self) -> None:
        while True:
            try:
                req = self.waiting.get_nowait()
            except queue.Empty:
                break
            if req.request_id in self._pending_aborts:
                self._pending_aborts.discard(req.request_id)
                req.abort_requested = True
            self._admitted.append(req)

    @staticmethod
    def _unservable(req: EngineRequest) -> bool:
        """Requests whose sampling needs a path this engine does not carry:
        constrained decoding, and per-request seed streams (``torch`` cannot
        reproduce ``jax.random``'s seeded bits)."""
        s = req.sampling
        return bool(s.json_mode or s.guided_choice or s.guided_regex
                    or (s.seed is not None and not s.greedy))

    def _admit(self) -> None:
        self._drain_waiting()
        # leftovers after a full drain can never match (finished/unknown ids)
        self._pending_aborts.clear()
        for req in list(self._admitted):
            if req.abort_requested:
                self._admitted.remove(req)
                self._finish(req, FinishReason.CANCELLED)
                continue
            slot = next((i for i, s in enumerate(self.slots) if s is None), None)
            if slot is None:
                break
            if req.prompt_len == 0 or self._unservable(req):
                self._admitted.remove(req)
                self._finish(req, FinishReason.ERROR)
                continue
            if req.prompt_len >= self.config.max_model_len:
                self._admitted.remove(req)
                self._finish(req, FinishReason.LENGTH)
                continue
            req.seq = TokenBlockSequence(req.prompt, self.config.block_size)
            try:
                alloc = self.block_manager.allocate(req.seq.sequence_hashes(), req.prompt_len)
            except NoFreeBlocks:
                break  # retry next step once blocks free up
            req.block_ids = alloc.block_ids
            req.cached_tokens = alloc.cached_tokens
            req.computed_tokens = req.cached_tokens
            req.wait_upto = req.cached_tokens + alloc.joined_tokens
            self._reserve_own(req)
            req.slot = slot
            if req.submitted_at:
                req.queue_wait_s = time.perf_counter() - req.submitted_at
            req.state = RequestState.PREFILL
            self.slots[slot] = req
            self._by_id[req.request_id] = req
            self._admitted.remove(req)

    # ---------------------------------------------------------------- prefill
    def _reserve_own(self, req: EngineRequest) -> None:
        """Register this request as the computer of its not-yet-covered
        full prompt blocks, so concurrent identical prompts join these
        blocks instead of prefilling duplicates."""
        bs = self.config.block_size
        for i in range(req.wait_upto // bs, req.prompt_len // bs):
            blk = req.seq.blocks[i]
            if self.block_manager.reserve(blk.sequence_hash, req.block_ids[i]):
                req.reserved_pairs.append((blk.sequence_hash, req.block_ids[i]))

    def _prefill_ready(self, req: EngineRequest) -> bool:
        """Absorb joined in-flight blocks their owner has committed; return
        True when this request can dispatch a prefill chunk now.  If the
        owner aborted before committing, take over the remaining prompt."""
        bs = self.config.block_size
        bm = self.block_manager
        while req.computed_tokens < req.wait_upto:
            i = req.computed_tokens // bs
            if bm.block_committed(req.block_ids[i]):
                req.computed_tokens += bs
                req.cached_tokens += bs  # someone else's compute — a hit
                continue
            if bm.is_reserved(req.seq.blocks[i].sequence_hash):
                return False  # owner still prefilling — wait, don't recompute
            # owner vanished without committing: take over from here
            req.wait_upto = req.computed_tokens
            self._reserve_own(req)
        return True

    def _run_prefill(self, req: EngineRequest) -> None:
        """One prefill chunk of one request.  The chunk is padded to a
        block multiple (eager PyTorch needs no shape buckets; the block
        multiple keeps the block-granular cache write), and the cached
        prefix is passed as its exact block count."""
        cfg = self.config
        bs = cfg.block_size
        remaining = req.prompt_len - req.computed_tokens
        # chunked prefill: non-final chunks end on a block boundary so the
        # next chunk stays block-aligned
        take = min(remaining, cfg.prefill_chunk_tokens or remaining)
        final = take == remaining
        s = -(-take // bs) * bs
        m = cfg.max_blocks_per_seq
        end = req.computed_tokens + take

        tokens = np.zeros((1, s), np.int32)
        positions = np.zeros((1, s), np.int32)
        slot_idx = np.full((1, s), -1, np.int32)
        tokens[0, :take] = req.prompt[req.computed_tokens:end]
        pos = np.arange(req.computed_tokens, end, dtype=np.int32)
        positions[0, :take] = pos
        bt = np.zeros((1, m), np.int32)
        bt[0, :len(req.block_ids)] = req.block_ids
        slot_idx[0, :take] = bt[0, pos // bs] * bs + pos % bs

        extras = self._sampling_extras([req]) if final else {}
        packed = unified_step(
            self.model, self.cache, self._up(tokens), self._up(positions), self._up(bt),
            self._up(np.asarray([end], np.int32)), self._up(slot_idx),
            self._up(np.asarray([take - 1], np.int32)), self._gen,
            self._up(np.asarray([req.sampling.temperature], np.float32)),
            self._up(np.asarray([req.sampling.top_k], np.int32)),
            self._up(np.asarray([req.sampling.top_p], np.float32)),
            prefix_blocks=req.computed_tokens // bs, k_cand=self._k_cand([req]), **extras,
        )
        self.steps += 1
        sampled, lps, cids, clps = _unpack(self._read(packed))
        self.prefill_steps += 1
        self.prefill_dispatches += 1
        self.prefill_rows_dispatched += 1
        self.prompt_tokens_computed += take
        req.computed_tokens = end
        self._commit_prefill_blocks(req)
        if not final:
            return  # more chunks to go; sample discarded
        self._complete_prefill(req, sampled, lps, cids, clps)

    def _commit_prefill_blocks(self, req: EngineRequest) -> None:
        """Offer newly completed prompt blocks to the block manager (the
        ``committed_upto`` watermark keeps chunked prefill linear)."""
        bs = self.config.block_size
        done = req.computed_tokens // bs
        for blk in req.seq.blocks[req.committed_upto // bs:done]:
            self.block_manager.commit(
                req.block_ids[blk.position], blk.sequence_hash,
                blk.parent_sequence_hash, list(blk.tokens),
            )
        req.committed_upto = done * bs

    def _complete_prefill(self, req, sampled, lps, cids, clps) -> None:
        # a completed prefill must not count against the next arrival: reset
        # the interleave unless another prefill is mid-flight
        if not any(
            r is not None and r is not req and r.state is RequestState.PREFILL
            for r in self.slots
        ):
            self._last_was_prefill = False
        req.state = RequestState.RUNNING
        self._append_token(req, int(sampled[0]), first=True,
                           logprob=float(lps[0]), cand=(cids[0], clps[0]))

    # ----------------------------------------------------------------- decode
    def _grow_blocks(self, req: EngineRequest, extra_tokens: int) -> Optional[int]:
        """Extend ``req``'s block table to cover ``extra_tokens`` more
        positions beyond its uncomputed tail; returns the row's token
        limit, or None when not even the current token has a slot (the
        request was finished at LENGTH)."""
        cfg = self.config
        p = req.seq.total_tokens - 1
        want_tokens = min(p + extra_tokens, cfg.max_model_len)
        needed = (want_tokens - 1) // cfg.block_size + 1
        if len(req.block_ids) < needed:
            try:
                req.block_ids.extend(self.block_manager.allocate_raw(needed - len(req.block_ids)))
            except NoFreeBlocks:
                if len(req.block_ids) * cfg.block_size <= p:
                    self._finish_slot(req, FinishReason.LENGTH)
                    return None
        return min(len(req.block_ids) * cfg.block_size, cfg.max_model_len)

    def _run_decode(self) -> None:
        """One decode dispatch = up to ``config.decode_steps`` tokens per
        active sequence (``interactive_decode_steps`` while prefill work is
        pending), generated on the device with one host sync per burst.
        Blocks for the whole burst are allocated up front; a sequence that
        runs out of block space stops writing KV at its ``limit`` and is
        finished at LENGTH once its allowed samples are consumed."""
        cfg = self.config
        b, m = cfg.max_batch_size, cfg.max_blocks_per_seq
        can_admit = (
            any(s is None for s in self.slots) and self.block_manager.free_blocks > 0
        ) or any(r is not None and r.abort_requested for r in self.slots)
        prefill_pending = (
            ((bool(self._admitted) or not self.waiting.empty()) and can_admit)
            or any(r is not None and r.state is RequestState.PREFILL for r in self.slots)
        )
        k_steps = max(1, cfg.interactive_decode_steps if prefill_pending else cfg.decode_steps)
        tokens = np.zeros(b, np.int32)
        positions = np.zeros(b, np.int32)
        bt = np.zeros((b, m), np.int32)
        seq_lens = np.zeros(b, np.int32)
        limits = np.zeros(b, np.int32)
        temp = np.ones(b, np.float32)
        top_k = np.zeros(b, np.int32)
        top_p = np.ones(b, np.float32)

        active: list[EngineRequest] = []
        for i, req in enumerate(self.slots):
            if req is None or req.state is not RequestState.RUNNING:
                continue
            p = req.seq.total_tokens - 1  # position of the not-yet-computed last token
            limit = self._grow_blocks(req, k_steps)
            if limit is None:
                continue  # not even the current token has a slot
            active.append(req)
            tokens[i] = req.seq.tokens[-1]
            positions[i] = p
            bt[i, :len(req.block_ids)] = req.block_ids
            seq_lens[i] = req.seq.total_tokens
            limits[i] = limit
            temp[i] = req.sampling.temperature
            top_k[i] = req.sampling.top_k
            top_p[i] = req.sampling.top_p
        if not active:
            return
        pen = self._penalty_buffers(active, k_steps)
        packed = multi_decode_step(
            self.model, self.cache, self._up(tokens), self._up(positions), self._up(bt),
            self._up(seq_lens), self._up(limits), self._gen, self._up(temp),
            self._up(top_k), self._up(top_p),
            pen=None if pen is None else tuple(self._up(a) for a in pen),
            num_steps=k_steps, block_size=cfg.block_size, k_cand=self._k_cand(active),
            **self._sampling_extras(active, rows=[r.slot for r in active]),
        )
        self.steps += 1
        sampled, lps, cids, clps = _unpack(self._read(packed))  # [K, B], ..., [K, B, C]
        self.decode_steps += sampled.shape[0]
        for req in active:
            slot = req.slot
            want_lp = req.sampling.logprobs or req.sampling.top_logprobs > 0
            # samples at/past the limit wrote no KV — not appendable
            allowed = min(sampled.shape[0], int(limits[slot] - positions[slot]))
            for k in range(allowed):
                if req.state is not RequestState.RUNNING:
                    break  # EOS/stop/max_tokens hit mid-burst
                self._append_token(
                    req, int(sampled[k, slot]),
                    logprob=float(lps[k, slot]) if want_lp else None,
                    cand=(cids[k, slot], clps[k, slot]) if want_lp else None,
                )
            if req.state is RequestState.RUNNING and allowed < sampled.shape[0]:
                # block space exhausted before the burst ended
                self._finish_slot(req, FinishReason.LENGTH)

    def _penalty_buffers(self, active, k_steps: int):
        """The generated-token penalty buffers for this dispatch, or None
        when no active request uses penalties: [B, T] token buffer (-1
        pad), first-occurrence mask, per-row cursor, and the two penalty
        vectors."""
        if not any(r.sampling.frequency_penalty or r.sampling.presence_penalty for r in active):
            return None
        b = self.config.max_batch_size
        longest = max(r.seq.total_tokens - r.prompt_len for r in active)
        t_cap = max(16, 1 << (longest + k_steps - 1).bit_length())
        t_cap = min(t_cap, max(16, 1 << (self.config.max_model_len - 1).bit_length()))
        ptoks = np.full((b, t_cap), -1, np.int32)
        pfirst = np.zeros((b, t_cap), bool)
        cursor = np.zeros(b, np.int32)
        freq = np.zeros(b, np.float32)
        pres = np.zeros(b, np.float32)
        for r in active:
            i = r.slot
            gen = r.seq.tokens[r.prompt_len:]
            n = min(len(gen), t_cap)
            seen: set[int] = set()
            for j, t in enumerate(gen[:n]):
                ptoks[i, j] = t
                if t not in seen:
                    pfirst[i, j] = True
                    seen.add(t)
            cursor[i] = n
            freq[i] = r.sampling.frequency_penalty
            pres[i] = r.sampling.presence_penalty
        return ptoks, pfirst, cursor, freq, pres

    # ------------------------------------------------------------- lifecycle
    def _append_token(self, req: EngineRequest, token: int, first: bool = False,
                      logprob: Optional[float] = None, cand=None) -> None:
        """Record a sampled token, emit the delta, apply stop conditions.

        The token's KV is *not* yet in the cache — the next decode step
        computes it (one-step lag).  A block completed by the previous
        token is committed here once its KV landed."""
        if req.abort_requested:
            self._finish_slot(req, FinishReason.CANCELLED)
            return
        bs = self.config.block_size
        kv_resident = req.seq.total_tokens  # tokens with KV in cache, pre-append
        if not first and kv_resident > 0 and kv_resident % bs == 0:
            blk = req.seq.blocks[kv_resident // bs - 1]
            if blk.position < len(req.block_ids):
                self.block_manager.commit(
                    req.block_ids[blk.position], blk.sequence_hash,
                    blk.parent_sequence_hash, list(blk.tokens),
                )
        req.seq.append(token)
        req.generated += 1
        self.tokens_generated += 1

        finish: Optional[FinishReason] = None
        st = req.stops
        if token in self.eos_token_ids and not st.ignore_eos and req.generated >= st.min_tokens:
            finish = FinishReason.EOS
        elif token in st.stop_token_ids and req.generated >= st.min_tokens:
            finish = FinishReason.STOP
        elif st.max_tokens is not None and req.generated >= st.max_tokens:
            finish = FinishReason.LENGTH
        elif req.seq.total_tokens >= self.config.max_model_len:
            finish = FinishReason.LENGTH

        out = LLMEngineOutput(token_ids=[token], finish_reason=finish,
                              cached_tokens=req.cached_tokens)
        if logprob is not None and (req.sampling.logprobs or req.sampling.top_logprobs):
            out.logprobs = [logprob]
            n = req.sampling.top_logprobs
            if n > 0 and cand is not None:
                ids, lps = cand
                out.top_logprobs = [[(int(i), float(l)) for i, l in zip(ids[:n], lps[:n])]]
        req.emit(out)
        if finish is not None:
            self._finish_slot(req, finish, emitted=True)

    def _finish_slot(self, req: EngineRequest, reason: FinishReason,
                     emitted: bool = False) -> None:
        if req.slot >= 0 and self.slots[req.slot] is req:
            self.slots[req.slot] = None
        # drop unresolved reservations (commit resolved the rest) so any
        # joiners waiting on us take over instead of hanging
        for h, bid in req.reserved_pairs:
            self.block_manager.unreserve(h, bid)
        req.reserved_pairs = []
        self.block_manager.release(req.block_ids)
        req.block_ids = []
        self._by_id.pop(req.request_id, None)
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        if not emitted:
            req.emit(LLMEngineOutput(token_ids=[], finish_reason=reason,
                                     cached_tokens=req.cached_tokens))

    def _finish(self, req: EngineRequest, reason: FinishReason) -> None:
        """Finish a request that never got a slot."""
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.emit(LLMEngineOutput(token_ids=[], finish_reason=reason))
