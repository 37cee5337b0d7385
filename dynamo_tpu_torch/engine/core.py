"""EngineCore — the continuous-batching scheduler + executor, in PyTorch.

The counterpart of ``dynamo_tpu/engine/core.py``.  The model's forward
handles any [B, S] of new tokens against the paged cache, which is one
tensor updated in place.  Dispatches:

* :func:`unified_step` — one request's prefill (or prefill chunk);
* :func:`ragged_prefill_step` — with ``prefill_token_budget``, several
  requests' prefill chunks packed as block-aligned spans on one flat axis;
* :func:`unified_token_step` — with ``unified_token_dispatch``, a mixed
  turn: every decoding slot's next token (decode rows leading the flat
  axis) and the ready prefill chunks in ONE dispatch;
* :func:`unified_burst_step` — with ``lookahead_dispatch``, that mixed turn
  followed by further decode turns on the device, one result read per
  burst; while it runs the host prebuilds the next turn's operands;
* :func:`multi_decode_step` — multi-step decode bursts for every running
  slot;
* :func:`spec_verify_step` — with ``spec_tokens = k``, speculative decoding:
  each running slot's last token and up to k proposed tokens (prompt-lookup
  n-grams, :mod:`~dynamo_tpu_torch.engine.spec`, or a draft model,
  :mod:`~dynamo_tpu_torch.engine.draft`) verified in ONE S = k + 1 forward
  that samples every position; the host keeps the agreeing prefix and one
  more token.  It is tried first on every decode turn (the unified
  scheduler's pure-decode turns included); a batch it does not suit takes
  the burst.  On the card the verify takes the decode kernel for S <= 8
  (``MQ_MAX_S``) and the plain attention op beyond, as in the JAX package.

Scheduling policy: admit waiting requests into free slots, then one prefill
turn or one decode burst per iteration (alternating under chunked prefill),
or, with unified dispatch, one mixed turn when both phases have work.
Prefix-cache hits shorten prefill via the block manager.

A burst is a Python loop on the device (the JAX engine's ``lax.scan``):
forward → (grammar mask) → sample → (grammar advance) → feed the token
back, with ONE host sync at the end.  Unseeded rows' ``jax.random.split``
keys become draws from the engine's one ``torch.Generator``, so their
temperature > 0 streams differ from the JAX engine's; greedy rows and rows
with a per-request ``seed`` (:func:`~dynamo_tpu_torch.engine.sampling.
seeded_gumbel`) give the JAX engine's streams token for token.

Constrained decoding (``json_mode``, ``guided_choice``, ``guided_regex``,
and a JSON schema through its regex) masks each constrained row's logits
with its grammar's tables (:mod:`dynamo_tpu_torch.engine.grammar`) and
advances the row's automaton state on the device inside the burst; the
host mirrors the state in :meth:`EngineCore._append_token`.

The cache is the model's dtype or, with ``cache_dtype="int8"``, a
:class:`~dynamo_tpu_torch.ops.kv_quant.QuantKvCache` (int8 payload and
scales, quantised as it is written); every dispatch above takes either.
Int8 weights come with the model (``init_params(quantized=True)`` or
``params_from_jax`` of a quantised tree).

Disaggregated serving (``llm/workers.py``): a request with
``remote_prefill`` is admitted with its blocks allocated and waits in
``REMOTE_PREFILL`` until a prefill worker's KV lands
(:meth:`EngineCore.scatter_external`) and its first token arrives
(:meth:`EngineCore.complete_remote_prefill`); a request with
``remote_decode`` stops after its prefill, emits its first token and holds
its blocks (:meth:`EngineCore.held_blocks`) until the worker has moved them
out (:meth:`EngineCore.gather_blocks_device` on the card for a colocated
decode engine, :meth:`EngineCore.gather_blocks_np` through the host for
TCP) and released them.  Commit hooks fire per committed prefill chunk for
the streamed handoff (``llm/kv/stream.py``).

KV tiers below the device cache (``num_host_blocks``, ``kv_persist_dir``):
a block the block manager evicts is snapshotted on the card (a gather,
dispatched before anything can overwrite the block) and copied to the
pinned host pool (``llm/kv/host_pool.py``) on the ``kv-offload`` thread,
on a side stream that waits on an event recorded after the gather; the
queue item holds the snapshot until that copy has completed.  With a
persist directory each stored batch is also written through to the disk
store (``llm/kv/persist.py``) on that thread.  Admission restores a
request's host-resident (or, below them, disk-resident) prefix blocks
into its fresh device blocks — one asynchronous upload per run of pool
rows, from the pinned pool, on the current stream — and counts them as
cached, so prefill starts after them.

Each core owns a step timeline (``obs/timeline.py``: ``step`` is wrapped
in ``begin``/``end`` and every phase boundary marks, at the JAX engine's
sites and with its dispatch kinds) and a perf model (``obs/perfmodel.py``:
each dispatch kind priced at its first offer); ``metrics()`` reads its
host gap from the timeline.  With ``profile_dir`` set, the first
``profile_steps`` dispatching steps run under one ``torch.profiler``
window (CPU, and CUDA on the card) whose Chrome trace lands under
``profile_dir/steps-NNNNNN/``, keyed by the starting step id.

More than one device (a model built on a ``utils/mesh.py`` mesh): the
process model is one process per rank.  This core runs on rank 0 only — it
holds the scheduler, the block manager, the sampler and the front door —
and ranks 1..n-1 are shard followers (``engine/follower.py``) that run only
what rank 0 broadcasts: each dispatch's forward operands (host arrays, one
object broadcast before the dispatch), each cache mutation (a scatter of
handed-off blocks, a gather for a handoff out) and the sequence-parallel
prefill.  Every rank runs the same step function on its own slices, so the
collectives inside the model (an all-reduce after ``wo`` and ``w_down``, the
lm_head's all-gather) line up; rank 0 samples, and where a burst feeds a
sampled token back, broadcasts it (:func:`_shared_tokens`) — a follower
never touches a generator.  No rank runs a scheduler of its own: one
diverging admission would hang a collective.  A follower that dies takes
the world down: rank 0's next collective raises.  ``sp_prefill_threshold``
with a mesh whose "data" axis is above 1 prefills long prompts in ONE
dispatch with the sequence split over "data" (ring attention) and the fresh
KV all-gathered so every data rank's cache holds the prompt.

On a mesh the options below the dispatches work as on one card.  The KV
tiers snapshot evicted blocks whole (every rank's kv heads gathered onto
rank 0, a follower operation) before the kv-offload thread copies them to
the host, and a restore scatters each rank its heads, so the host pool and
the persist files hold the blocks one card would.  The speculative verify
and the lookahead burst are broadcast dispatches like the others (the
burst broadcasts the tokens each turn feeds back); the draft model stays
unsharded on rank 0's device and takes part in no collective.  Acceptance
and the rollback of rejected positions are host work on rank 0: every rank
wrote the same slots in the verify, and the next dispatch overwrites them
alike.

A float cache dtype other than the model's is cast to on the write and
from on the read by the plain ops, as in the JAX package.

Refused at construction (:meth:`EngineCore._check_supported`): a
``mesh_shape`` that is not the model's mesh, a cache dtype that is neither
int8 nor a float dtype, and on the card whatever no kernel on the model's
route takes (:func:`cuda_route_refusal`): a model dtype but bfloat16 and
float16, a float16 mixture of experts, a float cache dtype other than the
model's.  No request reaches a kernel wrapper that refuses its dtype.

Thread-safety: everything here runs on the engine thread; submit()/abort()
and run_on_step() are the only cross-thread entry points and only touch
thread-safe queues (the routing probes prefix_hit_tokens,
persist_hit_blocks and kv_bytes_per_block only read).  The kv-offload
thread shares the host pool under ``_offload_lock``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.counters import LookaheadCounters, PrefillCounters, persist_counters
from dynamo_tpu_torch.engine.draft import DraftProposer
from dynamo_tpu_torch.engine.grammar import (
    JsonGrammar, compile_choice_vocab, compile_regex_vocab, compose_tables, device_tables,
    grammar_advance, grammar_mask,
)
from dynamo_tpu_torch.engine.request import INIT_STATE, EngineRequest, RequestState
from dynamo_tpu_torch.engine.sampling import K_MAX, sample_full
from dynamo_tpu_torch.llm.kv.block_manager import KvBlockManager, NoFreeBlocks
from dynamo_tpu_torch.llm.kv.events import TIER_PERSIST, KvRemovedEvent, KvStoredEvent
from dynamo_tpu_torch.llm.kv.host_pool import HostKvPool, flatten_blocks, unflatten_blocks
from dynamo_tpu_torch.llm.protocols import FinishReason, LLMEngineOutput
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.obs.perfmodel import PerfModel, model_shapes, visible_pairs
from dynamo_tpu_torch.obs.timeline import COLLECTIVE, StepTimeline
from dynamo_tpu_torch.ops.block_copy import gather_blocks_padded, scatter_blocks_inplace
from dynamo_tpu_torch.ops.kernels.registry import route_dtypes
from dynamo_tpu_torch.ops.kv_quant import (QuantKvCache, cache_data, pad_scales, quantize_kv_rows,
                                           resolve_cache_dtype, scale_tile)
from dynamo_tpu_torch.tokens import TokenBlockSequence
from dynamo_tpu_torch.utils.mesh import AXIS_DATA

log = logging.getLogger("dynamo_tpu_torch.engine")

__all__ = ["EngineCore", "unified_step", "multi_decode_step", "ragged_prefill_step",
           "unified_token_step", "unified_burst_step", "spec_verify_step", "sp_prefill_step",
           "STEP_FNS"]


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


def _pen_args(pen) -> tuple:
    """sample_full's positional penalty arguments from a carried penalty
    state (pen_tokens, pen_first, pen_cursor, freq_pen, pres_pen)."""
    return () if pen is None else (pen[0], pen[1], pen[3], pen[4])


def _append_sampled(pen, sampled: torch.Tensor):
    """Append one turn's samples to the carried penalty buffers on the
    device (in place: the caller owns the buffers), so later turns of a
    burst penalise mid-burst repeats without a host round trip."""
    ptoks, pfirst, cur, freq, pres = pen
    rows = torch.arange(sampled.shape[0], device=sampled.device)
    t_cap = ptoks.shape[1]
    seen = (ptoks == sampled[:, None]).any(dim=-1)
    at = cur.clamp_max(t_cap - 1).long()
    ptoks[rows, at] = sampled
    pfirst[rows, at] = ~seen
    return ptoks, pfirst, (cur + 1).clamp_max(t_cap - 1), freq, pres


def _sample(logits, generator, temp, top_k, top_p, pen_args: tuple, extras: dict, gram,
            steps, k_cand: int):
    """One turn's sampling: mask the constrained rows' logits with their
    grammar, then sample.  ``gram`` is a dispatch's grammar state, (tables,
    jrows, state, depth, stack) in the argument order of ``grammar_mask``
    and ``grammar_advance`` (see :meth:`EngineCore._gram_kwargs`), or None
    when no row is constrained; ``steps`` [B] is each row's seed fold index
    (the absolute position of the token being sampled).

    A shard follower has no generator (None): it samples nothing and gets
    zero placeholders; the tokens a burst feeds back come from rank 0
    (:func:`_shared_tokens`)."""
    if generator is None:
        b, dev = logits.shape[0], logits.device
        return (torch.zeros(b, dtype=torch.int64, device=dev),
                torch.zeros(b, device=dev), torch.zeros((b, 1), dtype=torch.int64, device=dev),
                torch.zeros((b, 1), device=dev))
    if gram is not None:
        logits = grammar_mask(logits, *gram)
    if extras.get("seeds") is not None:
        extras = dict(extras, seed_steps=steps)
    return sample_full(logits, generator, temp, top_k, top_p, *pen_args, k_cand=k_cand,
                       **extras)


def _shared_tokens(model, tokens: torch.Tensor) -> torch.Tensor:
    """The sampled tokens a burst feeds back, as rank 0 sampled them, on
    every rank of the model's mesh (one broadcast; as they are off a
    mesh)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return tokens
    return mesh.broadcast(tokens.to(torch.int64).contiguous())


def _advance(gram, sampled):
    """Advance the carried grammar state by one turn's samples, on the
    device."""
    return None if gram is None else gram[:2] + grammar_advance(*gram, sampled)


def _decode_turns(model: LlamaModel, cache, toks, pos, lens, block_tables, limits, generator,
                  temp, top_k, top_p, pen, extras: dict, gram, num_steps: int, block_size: int,
                  k_cand: int) -> list[torch.Tensor]:
    """``num_steps`` decode turns on the device: forward → sample → feed the
    token back.  A position at/past its row's ``limit`` writes no KV (slot
    -1) and the context length is clamped at the limit, so the block table
    is never walked past the row's blocks.  The grammar state ``gram`` (see
    :func:`_sample`) and the penalty buffers advance on the device each turn;
    a seeded row folds on ``pos + 1``, its sampled token's position.
    Returns each turn's packed [B, 2 + 2C] result."""
    m = block_tables.shape[1]
    outs = []
    for _ in range(num_steps):
        blk = (pos // block_size).clamp_max(m - 1)
        base = torch.gather(block_tables, 1, blk[:, None].long())[:, 0]
        slot = torch.where(pos < limits, base * block_size + pos % block_size, -1)
        hidden, _ = model.forward(toks[:, None], pos[:, None], cache, block_tables, lens,
                                  slot[:, None])
        logits = model.compute_logits(hidden[:, 0])
        out = _sample(logits, generator, temp, top_k, top_p, _pen_args(pen), extras, gram,
                      pos + 1, k_cand)
        if pen is not None:
            pen = _append_sampled(pen, out[0])
        gram = _advance(gram, out[0])
        outs.append(_pack(*out))
        lens = torch.minimum(lens + 1, limits)
        toks, pos = out[0], pos + 1
        if len(outs) < num_steps:
            toks = _shared_tokens(model, toks)
    return outs


@torch.no_grad()
def unified_step(model: LlamaModel, cache, tokens, positions, block_tables, seq_lens,
                 slot_idx, last_idx, generator, temp, top_k, top_p, prefix_blocks=None,
                 k_cand=K_MAX, min_p=None, bias_tokens=None, bias_vals=None, seeds=None,
                 seed_rows=None, gram=None):
    """The serving step: forward over the paged cache (written in place),
    gather each row's last hidden state, project to logits, mask the
    constrained rows, sample (a seeded row folds on ``seq_lens``).

    Returns the packed [B, 2 + 2C] result (see :func:`_pack`) on the
    device; nothing here synchronises with it."""
    hidden, _ = model.forward(tokens, positions, cache, block_tables, seq_lens, slot_idx,
                              prefix_blocks=prefix_blocks)
    b = tokens.shape[0]
    last_h = hidden[torch.arange(b, device=hidden.device), last_idx.long()]  # [B, Dm]
    logits = model.compute_logits(last_h)  # [B, V] f32
    extras = dict(min_p=min_p, bias_tokens=bias_tokens, bias_vals=bias_vals, seeds=seeds,
                  seed_rows=seed_rows)
    return _pack(*_sample(logits, generator, temp, top_k, top_p, (), extras, gram, seq_lens,
                          k_cand))


@torch.no_grad()
def multi_decode_step(model: LlamaModel, cache, last_tokens, positions, block_tables,
                      seq_lens, limits, generator, temp, top_k, top_p, pen=None,
                      min_p=None, bias_tokens=None, bias_vals=None, seeds=None, seed_rows=None,
                      gram=None, *, num_steps: int, block_size: int, k_cand: int = K_MAX):
    """``num_steps`` decode iterations on the device in one dispatch
    (multi-step scheduling), see :func:`_decode_turns`.  Inactive rows
    have limits=0.

    ``pen`` = (pen_tokens [B,T] -1-padded, pen_first, pen_cursor [B],
    freq_pen, pres_pen): each newly sampled token is appended on the device
    so mid-burst repeats are penalised without a host round trip; the
    constrained rows' grammar state ``gram`` advances on the device the
    same way.

    Returns the packed [K, B, 2 + 2C] results on the device."""
    if pen is not None:
        pen = tuple(t.clone() for t in pen)
    extras = dict(min_p=min_p, bias_tokens=bias_tokens, bias_vals=bias_vals, seeds=seeds,
                  seed_rows=seed_rows)
    return torch.stack(_decode_turns(
        model, cache, last_tokens, positions, seq_lens, block_tables, limits, generator,
        temp, top_k, top_p, pen, extras, gram, num_steps, block_size, k_cand))


@torch.no_grad()
def spec_verify_step(model: LlamaModel, cache, tokens, positions, block_tables, seq_lens,
                     slot_idx, generator, temp, top_k, top_p, min_p=None, seeds=None,
                     seed_rows=None, *, k_cand: int = K_MAX) -> torch.Tensor:
    """Speculative verify: forward S tokens per row against the paged
    cache (KV scattered as a decode step scatters it) and SAMPLE at every
    position with that position's own noise — the host accepts the proposal
    prefix the samples agree with.

    This is exact rejection sampling for a point-mass proposal: "sample
    from the target and accept iff it matches" accepts with probability
    p(x), and on mismatch the drawn sample is already distributed as the
    renormalised residual, so every emitted token is distributed exactly as
    plain decoding, at any temperature.  Greedy rows reduce to argmax;
    seeded rows fold on each sampled token's absolute position
    (``positions + 1``), so their streams are the same with speculation on
    or off.  Each row's options are repeated over its S positions.

    Returns the sampled tokens [B, S] int32 on the device (zeros on a
    shard follower, which samples nothing)."""
    hidden, _ = model.forward(tokens, positions, cache, block_tables, seq_lens, slot_idx)
    b, s = tokens.shape
    logits = model.compute_logits(hidden.reshape(b * s, -1))  # [B*S, V] f32

    def rep(a):
        return None if a is None else a.repeat_interleave(s)

    extras = dict(min_p=rep(min_p), seeds=rep(seeds), seed_rows=rep(seed_rows))
    sampled = _sample(logits, generator, rep(temp), rep(top_k), rep(top_p), (), extras, None,
                      positions.reshape(b * s) + 1, k_cand)[0]
    return sampled.reshape(b, s)


@torch.no_grad()
def ragged_prefill_step(model: LlamaModel, cache, tokens, positions, block_tables, seq_lens,
                        slot_idx, seq_ids, seq_starts, row_offsets, last_idx, generator, temp,
                        top_k, top_p, prefix_blocks=0, k_cand=K_MAX, min_p=None,
                        bias_tokens=None, bias_vals=None, seeds=None, seed_rows=None,
                        gram=None):
    """Token-budget ragged prefill: ONE forward over a flat packed token
    axis ([1, T]) holding several requests' prefill chunks, then a per-ROW
    sample — ``last_idx`` [R] gathers each row's last fresh hidden state off
    the flat axis.  The host keeps only final-chunk rows' samples; a seeded
    row folds on its ``seq_lens``.

    Returns the packed [R, 2 + 2C] result on the device."""
    hidden, _ = model.forward(tokens, positions, cache, block_tables, seq_lens, slot_idx,
                              prefix_blocks=prefix_blocks,
                              ragged=(seq_ids, seq_starts, row_offsets))
    logits = model.compute_logits(hidden[0, last_idx.long()])  # [R, V] f32
    extras = dict(min_p=min_p, bias_tokens=bias_tokens, bias_vals=bias_vals, seeds=seeds,
                  seed_rows=seed_rows)
    return _pack(*_sample(logits, generator, temp, top_k, top_p, (), extras, gram, seq_lens,
                          k_cand))


@torch.no_grad()
def unified_token_step(model: LlamaModel, cache, tokens, positions, block_tables, seq_lens,
                       slot_idx, seq_ids, seq_starts, row_offsets, last_idx, generator, temp,
                       top_k, top_p, pen=None, *, row_tokens=0, prefix_blocks=0, k_cand=K_MAX,
                       min_p=None, bias_tokens=None, bias_vals=None, seeds=None, seed_rows=None,
                       gram=None):
    """Unified mixed prefill+decode step: ONE forward over a flat packed
    token axis whose first ``row_tokens`` slots hold DECODE rows (one fresh
    token each, written to the cache per row — their in-block offsets are
    arbitrary) and whose remainder holds block-aligned prefill spans.  A
    decode row is a 1-token chunk to the ragged attention, its ``start``
    the full cached context.

    Decode rows and final-chunk prefill rows sample (penalties over the
    host-built ``pen`` = (pen_tokens, pen_first, freq_pen, pres_pen), logit
    bias, min_p, grammar masks, seeds folded on ``seq_lens``, top_logprobs
    candidates); mid-chunk rows sample garbage the host discards.  Returns
    the packed [R, 2 + 2C] result."""
    hidden, _ = model.forward(tokens, positions, cache, block_tables, seq_lens, slot_idx,
                              prefix_blocks=prefix_blocks,
                              ragged=(seq_ids, seq_starts, row_offsets),
                              ragged_row_tokens=row_tokens)
    logits = model.compute_logits(hidden[0, last_idx.long()])  # [R, V] f32
    extras = dict(min_p=min_p, bias_tokens=bias_tokens, bias_vals=bias_vals, seeds=seeds,
                  seed_rows=seed_rows)
    return _pack(*_sample(logits, generator, temp, top_k, top_p, pen or (), extras, gram,
                          seq_lens, k_cand))


@torch.no_grad()
def unified_burst_step(model: LlamaModel, cache, tokens, positions, block_tables, seq_lens,
                       slot_idx, seq_ids, seq_starts, row_offsets, last_idx, limits, generator,
                       temp, top_k, top_p, pen=None, min_p=None, bias_tokens=None,
                       bias_vals=None, seeds=None, seed_rows=None, gram=None, *,
                       num_steps: int, block_size: int, row_tokens: int = 0,
                       prefix_blocks: int = 0, k_cand: int = K_MAX):
    """Fused multi-turn unified dispatch: turn 0 is exactly
    :func:`unified_token_step`, then ``num_steps - 1`` further decode turns
    run on the device over the unified ROW axis (:func:`_decode_turns`),
    with turn 0's samples fed back — so a burst needs ONE result read.

    Stops are handled on the host after the burst: the device keeps
    generating past a stop and the host discards a stopped row's tail
    (a lookahead mispredict).  KV written past a stop lands only in blocks
    the request still owns and never commits.  Prefill and padding rows
    are inert in the later turns: ``limits`` is 0 for them, so they write
    no KV, attend over no context, and sample garbage the host discards.

    ``pen`` = (pen_tokens, pen_first, pen_cursor, freq_pen, pres_pen):
    every turn's samples are appended on the device (``pen_cursor`` is each
    row's next write index), and grammar states advance there too.  Seeded
    rows fold on the absolute position (turn 0: ``seq_lens``; later turns:
    ``pos + 1``), so their streams equal the single-turn dispatches'.
    Returns the packed [K, R, 2 + 2C] results, turn 0 first."""
    hidden, _ = model.forward(tokens, positions, cache, block_tables, seq_lens, slot_idx,
                              prefix_blocks=prefix_blocks,
                              ragged=(seq_ids, seq_starts, row_offsets),
                              ragged_row_tokens=row_tokens)
    logits = model.compute_logits(hidden[0, last_idx.long()])  # [R, V] f32
    extras = dict(min_p=min_p, bias_tokens=bias_tokens, bias_vals=bias_vals, seeds=seeds,
                  seed_rows=seed_rows)
    if pen is not None:
        pen = tuple(t.clone() for t in pen)
    out0 = _sample(logits, generator, temp, top_k, top_p, _pen_args(pen), extras, gram,
                   seq_lens, k_cand)
    if pen is not None:
        pen = _append_sampled(pen, out0[0])
    gram = _advance(gram, out0[0])
    # the later turns start as the decode turn that would follow: turn 0's
    # token (rank 0's sample, on every rank) sits at position seq_lens, the
    # context now includes it (clamped at the block limit — past it no KV
    # was written)
    toks = _shared_tokens(model, out0[0]) if num_steps > 1 else out0[0]
    outs = _decode_turns(model, cache, toks, seq_lens, torch.minimum(seq_lens + 1, limits),
                         block_tables, limits, generator, temp, top_k, top_p, pen, extras,
                         gram, num_steps - 1, block_size, k_cand)
    return torch.stack([_pack(*out0)] + outs)


@torch.no_grad()
def sp_prefill_step(model, cache, tokens, positions, block_ids, generator, temp, top_k, top_p,
                    *, last_idx: int, k_cand: int = K_MAX):
    """Sequence-parallel prefill of one whole prompt (``tokens`` /
    ``positions`` [1, S_pad], S_pad a multiple of Bs x the "data" size) in
    ONE dispatch on every rank: each data rank takes its chunk of the
    sequence through ring attention (``forward_seq_parallel``), the last
    prompt token's hidden row reaches every rank (a sum over "data" of the
    one rank's row), rank 0 samples the first token, and the fresh KV is
    all-gathered over "data" and written, as whole blocks (int8-quantised
    in the same pass for an int8 cache), into ``block_ids`` of every data
    rank's cache.  Returns the packed [1, 2 + 2C] result."""
    mesh = model.mesh
    n, i = mesh.axis_size(AXIS_DATA), mesh.axis_index(AXIS_DATA)
    chunk = tokens.shape[1] // n
    lo = i * chunk
    hidden, kv = model.forward_seq_parallel(tokens[:, lo:lo + chunk],
                                            positions[:, lo:lo + chunk], sp_axis=AXIS_DATA)
    last = hidden[0, last_idx - lo] if lo <= last_idx < lo + chunk else hidden.new_zeros(
        hidden.shape[-1])
    last = mesh.all_reduce(last, AXIS_DATA)
    out = _sample(model.compute_logits(last[None]), generator, temp, top_k, top_p, (), {}, None,
                  None, k_cand)
    kv = mesh.all_gather(kv, AXIS_DATA, dim=3)  # [L, 2, 1, S_pad, Hk*D]
    l, _, _, _, hkd = kv.shape
    bs = cache_data(cache).shape[3]
    nb = block_ids.shape[0]
    blocks = kv[:, :, 0, :nb * bs].reshape(l, 2, nb, bs, hkd).transpose(1, 2).contiguous()
    if isinstance(cache, QuantKvCache):
        d = model.config.head_dim
        hk = hkd // d
        q8, sc = quantize_kv_rows(blocks.reshape(l, nb, 2, bs, hk, d))
        blocks = QuantKvCache(q8.reshape(l, nb, 2, bs, hkd), pad_scales(sc.transpose(-1, -2)))
    scatter_blocks_inplace(cache, block_ids, blocks)
    return _pack(*out)


def shard_blocks(model, parts: tuple) -> tuple:
    """This rank's kv heads of whole handed-off blocks (host tensors
    ``[L, n, 2, Bs, Hk*D]``, and for the int8 cache the scale tiles
    ``[L, n, 2, Hp, Sp]``), the scales re-padded to this rank's tile."""
    first, count = model.kv_heads()
    cfg = model.config
    if count == cfg.num_kv_heads:
        return parts
    d = cfg.head_dim
    data = parts[0][..., first * d:(first + count) * d]
    if len(parts) == 1:
        return (data,)
    bs = data.shape[3]
    hp, sp = scale_tile(count, bs)
    scale = torch.ones(tuple(parts[1].shape[:3]) + (hp, sp), dtype=torch.float32)
    scale[..., :count, :] = parts[1][..., first:first + count, :sp]
    return data, scale


def gather_shard_blocks(model, cache, block_ids):
    """Every rank's kv heads of ``block_ids``, assembled on each rank as the
    whole blocks one card would hold (a gather over "model"; each rank's
    heads land at their own offset, so ranks that share a head write the
    same values)."""
    from dynamo_tpu_torch.utils.mesh import AXIS_MODEL

    mesh = model.mesh
    local = gather_blocks_padded(cache, block_ids)
    parts = tuple(local) if isinstance(local, QuantKvCache) else (local,)
    cfg = model.config
    tp = mesh.axis_size(AXIS_MODEL)
    first, count = model.kv_heads()
    if count == cfg.num_kv_heads:
        return local
    d, hk = cfg.head_dim, cfg.num_kv_heads
    firsts = [model.kv_heads(m)[0] for m in range(tp)]
    data = mesh.all_gather(parts[0], AXIS_MODEL, dim=0)  # [tp*L, n, 2, Bs, count*D]
    l = parts[0].shape[0]
    whole = parts[0].new_empty(parts[0].shape[:-1] + (hk * d,))
    for m, f in enumerate(firsts):
        whole[..., f * d:(f + count) * d] = data[m * l:(m + 1) * l]
    if len(parts) == 1:
        return whole
    bs = whole.shape[3]
    hp, sp = scale_tile(hk, bs)
    sc = mesh.all_gather(parts[1], AXIS_MODEL, dim=0)  # [tp*L, n, 2, hp_r, sp]
    scale = parts[1].new_ones(parts[1].shape[:3] + (hp, sp))
    for m, f in enumerate(firsts):
        scale[..., f:f + count, :] = sc[m * l:(m + 1) * l, ..., :count, :sp]
    return QuantKvCache(whole, scale)


def cuda_cache_refusal(model_dtype: str, cache_dtype) -> Optional[str]:
    """Why an engine on the card cannot serve a KV cache of ``cache_dtype``
    under a model of ``model_dtype``, or None when it can (the cache clause
    of :func:`cuda_route_refusal`).  The attention kernels take a float
    cache of the queries' own dtype (B1, B2, B3) or an int8 cache (B4a,
    B4b, B4c); no kernel takes a float cache of another dtype, and the
    plain ops serve one only on the CPU."""
    dt = resolve_cache_dtype(cache_dtype)
    if dt in (None, "int8") or dt == getattr(torch, model_dtype):
        return None
    dt = str(dt).replace("torch.", "")
    return (f"cache_dtype {dt!r} on cuda: no kernel takes a {dt} KV cache under "
            f"{model_dtype} queries (the attention kernels take a cache of the queries' dtype, "
            "or int8)")


def cuda_route_refusal(model_cfg, cache_dtype) -> Optional[str]:
    """Why an engine on the card cannot serve ``model_cfg`` (a Llama-family
    or DeepSeek config) with a KV cache of ``cache_dtype``, or None when
    every kernel on its route takes it (``ops/kernels/registry.py``'s
    ``route_dtypes``: the attention kernels B1-B4c and the W8A16 matmul B5
    have bfloat16 and float16 bodies, the grouped expert kernels E1/E2 a
    bfloat16 one).  Checked at construction, so no request reaches a
    wrapper that would refuse its tensors."""
    dtype, dense = model_cfg.dtype, route_dtypes()
    if dtype not in dense:
        return (f"model dtype {dtype!r} on cuda: no kernel takes {dtype} activations (the "
                f"attention kernels B1-B4c and the W8A16 matmul B5 have {' and '.join(dense)} "
                "bodies); serve it in one of those or on the CPU")
    moe = getattr(model_cfg, "is_moe", False) or getattr(model_cfg, "n_routed_experts", 0) > 0
    if moe and dtype not in route_dtypes(moe=True):
        return (f"{dtype} mixture-of-experts model on cuda: no grouped expert kernel (E1/E2) "
                f"takes {dtype} (they have {' and '.join(route_dtypes(moe=True))} bodies); serve "
                "it in one of those or on the CPU")
    return cuda_cache_refusal(dtype, cache_dtype)


# the dispatches a shard follower replays, by name: (function, the number of
# forward operands before its generator argument)
STEP_FNS = {
    "unified_step": (unified_step, 6),
    "ragged_prefill_step": (ragged_prefill_step, 9),
    "unified_token_step": (unified_token_step, 9),
    "multi_decode_step": (multi_decode_step, 5),
    "unified_burst_step": (unified_burst_step, 10),
    "spec_verify_step": (spec_verify_step, 5),
    "sp_prefill_step": (sp_prefill_step, 3),
}


class EngineCore:
    def __init__(
        self,
        model: LlamaModel,
        config: EngineConfig,
        eos_token_ids: Optional[list[int]] = None,
        device=None,
        grammar: Optional[JsonGrammar] = None,
        draft: Optional[LlamaModel] = None,
    ):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine on {self.device}")
        # the model's rank mesh: this core is rank 0's, the followers replay
        # what it broadcasts (engine/follower.py)
        self.mesh = getattr(model, "mesh", None)
        if self.mesh is not None and not self.mesh.is_root:
            raise ValueError(f"rank {self.mesh.rank} is a shard follower: only rank 0 runs "
                             "the engine (engine/follower.py)")
        self._check_supported(model, config, self.device)
        self.model = model
        self.config = config
        # draft-model speculation: a model (its weights in the module) with
        # the same tokenizer/vocab as the target — proposals come from the
        # draft (engine/draft.py) instead of n-gram lookup; the verify pass
        # is unchanged (greedy point-mass proposals keep it exact)
        self.draft = None
        if draft is not None:
            if config.spec_tokens <= 0:
                # a silently-inactive draft would be a lie to the operator
                raise ValueError(
                    "a draft model requires spec_tokens > 0 (--spec-tokens) to ever propose")
            if draft.config.vocab_size != model.config.vocab_size:
                raise ValueError(
                    "draft model must share the target's vocab "
                    f"({draft.config.vocab_size} != {model.config.vocab_size})")
            if draft.device != self.device:
                raise ValueError(f"the draft lives on {draft.device}, the engine on {self.device}")
            self.draft = DraftProposer(draft, config, num_blocks=config.draft_num_blocks or None)
        self.eos_token_ids = set(eos_token_ids or [])
        # constrained decoding: the JSON grammar's host tables (compiled
        # from the tokenizer lazily on the first constrained request, see
        # attach_grammar_tokenizer), the choice/regex tables by key, and
        # the device composites by dispatch key set
        self._grammar = grammar
        self._grammar_tok = None
        self._choice_tables: dict[tuple, object] = {}
        self._gdev_cache: dict[tuple, tuple] = {}
        self.block_manager = KvBlockManager(
            config.num_blocks, config.block_size,
            enable_prefix_reuse=config.enable_prefix_reuse,
        )
        # one tensor for the whole model (or an int8 payload and its scale
        # pool), updated in place by every step
        cache_dtype = config.cache_dtype or model.config.dtype
        self.cache_quant = str(cache_dtype) == "int8"
        # seq-parallel long prefill: ring attention over "data" (when the
        # mesh has more than one data rank)
        self._sp_size = 0
        if config.sp_prefill_threshold > 0 and self.mesh is not None \
                and self.mesh.axis_size(AXIS_DATA) > 1:
            if not hasattr(model, "forward_seq_parallel") or not getattr(
                    model, "supports_seq_parallel", True):
                # fail at construction, not on the first long prompt
                raise ValueError(f"{type(model).__name__} does not support seq-parallel "
                                 "prefill (this config); disable sp_prefill_threshold")
            self._sp_size = self.mesh.axis_size(AXIS_DATA)
        # every follower builds its own cache, over its kv heads
        self._send("engine", config.num_blocks, config.block_size, cache_dtype)
        self.cache = model.init_kv_cache(config.num_blocks, config.block_size, cache_dtype)
        self._init_tiers(model, config, cache_dtype)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)

        self.slots: list[Optional[EngineRequest]] = [None] * config.max_batch_size
        self.waiting: "queue.SimpleQueue[EngineRequest]" = queue.SimpleQueue()
        self._admitted: list[EngineRequest] = []  # waiting for a slot/blocks
        self._by_id: dict[str, EngineRequest] = {}
        self._abort_q: "queue.SimpleQueue[str]" = queue.SimpleQueue()
        # aborts that arrived before their request was even admitted
        self._pending_aborts: set[str] = set()
        # ops enqueued by other threads, run on the engine thread at the next
        # step boundary (KV scatter/gather, remote-prefill completion, ...)
        self._ops: "queue.SimpleQueue[tuple[Callable, concurrent.futures.Future]]" = (
            queue.SimpleQueue())
        # prefill-side held blocks: finished remote-decode prefills whose
        # blocks must survive until the transfer out completes
        self._held: dict[str, list[int]] = {}
        # streamed-handoff commit hooks (llm/kv/stream.py): per request,
        # fn(committed_block_ids, done) fired on the engine thread at each
        # committed prefill chunk and once more with done=True at the end
        self._commit_hooks: dict[str, Callable[[list[int], bool], None]] = {}
        # perf counters
        self.steps = 0
        self.prefill_steps = 0
        self.sp_prefills = 0             # seq-parallel long-prefill dispatches
        # prefill batching and unified mixed dispatch (dispatches, rows and
        # tokens packed, budget offered/used), and lookahead bursts with the
        # speculative next-turn prebuild commit/flush protocol: what
        # metrics() reports and the HTTP service's /metrics renders
        self.prefill_counters = PrefillCounters()
        self.lookahead_counters = LookaheadCounters()
        self.decode_steps = 0
        self.spec_steps = 0              # speculative verify dispatches
        self.spec_proposed = 0           # tokens proposed (n-gram lookup or draft)
        self.spec_accepted = 0           # proposals the model agreed with
        self.tokens_generated = 0
        self.prompt_tokens_computed = 0  # actual prefill work (dedupe-aware)
        self.device_gets = 0             # step-loop device->host result reads
        # this core's step timeline and roofline (obs/): one per core,
        # since several engine threads may share the process
        self.perf_model = PerfModel()
        self.timeline = StepTimeline(perf_model=self.perf_model)
        self._perf_shapes = None
        # profile hook: one torch.profiler window over the first
        # config.profile_steps dispatching steps, keyed by starting step id
        self._profiler = None
        self._profile_done = False
        self._profile_from_step = 0
        self._profile_path = ""
        # totals: seconds blocked in result reads, and seconds of host work
        # done between a dispatch's enqueue and its read (the lookahead
        # overlap window)
        self.read_wait_s = 0.0
        self.overlap_s = 0.0
        # the next unified turn's operands, prebuilt in the overlap window
        # (committed next turn if the predicted plan held, flushed otherwise)
        self._spec_next: Optional[dict] = None
        # cached _unified_penalties host buffers (invalidated on
        # admission/finish; incremental append between turns)
        self._pen_cache: Optional[dict] = None
        self._last_was_prefill = False

    @staticmethod
    def _check_supported(model: LlamaModel, cfg: EngineConfig, device) -> None:
        """Refuse what this engine cannot serve, instead of serving it on a
        path that ignores it: a ``mesh_shape`` that is not the model's mesh,
        a cache dtype that is neither int8 nor a float dtype, and on the card
        a model dtype, a family in that dtype or a cache dtype that no kernel
        on the route takes (:func:`cuda_route_refusal`)."""
        mesh = getattr(model, "mesh", None)
        shape = (1, 1) if mesh is None else (mesh.axis_size(AXIS_DATA), mesh.size
                                             // mesh.axis_size(AXIS_DATA))
        if tuple(cfg.mesh_shape) not in ((1, 1), shape):
            where = " on a mesh" if mesh is not None else ""
            raise ValueError(f"EngineConfig options not supported by the PyTorch engine{where}: "
                             "['mesh_shape']")
        resolve_cache_dtype(cfg.cache_dtype)
        if torch.device(device).type == "cuda":
            why = cuda_route_refusal(model.config, cfg.cache_dtype)
            if why:
                raise ValueError(why)

    def _send(self, op: str, *payload) -> None:
        """Broadcast one operation to the shard followers (nothing off a
        mesh): sent before rank 0 runs it, so every rank enters its
        collectives in the same order."""
        if self.mesh is not None:
            self.mesh.broadcast_object((op,) + payload)

    def _fwd(self, fn, host: tuple, **statics) -> tuple:
        """A dispatch's forward operands (``host`` numpy arrays) on the
        device; on a mesh, first broadcast to the followers with ``fn``'s
        name (a :data:`STEP_FNS` entry) and the static keywords, which the
        caller passes to ``fn`` too.  Sampling operands stay here."""
        if self.mesh is not None:
            self._send("step", fn.__name__, host, statics)
            self.timeline.mark(COLLECTIVE)
            self._wait0 = self.mesh.wait_s
        return tuple(self._up(a) for a in host)

    def _mark_dispatch(self, kind: str) -> None:
        """The dispatch mark; on a mesh the forward's collective waits move
        from ``dispatch`` to their own phase."""
        self.timeline.mark("dispatch", kind=kind)
        if self.mesh is not None:
            self.timeline.move(self.mesh.wait_s - self._wait0, "dispatch", COLLECTIVE)

    # ------------------------------------------------------------ dispatch
    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _read(self, packed: torch.Tensor) -> np.ndarray:
        """The one device->host read of a dispatch's packed results."""
        t0 = time.perf_counter()
        res = packed.cpu().numpy()
        self.read_wait_s += time.perf_counter() - t0
        self.device_gets += 1
        return res

    def _overlap(self, work) -> None:
        """Host work between a dispatch's enqueue and its result read (the
        lookahead overlap window).  Eager PyTorch returns from a dispatch
        only once the host has enqueued every kernel of it, so this work
        overlaps the card only while the card still runs behind the host."""
        t0 = time.perf_counter()
        work()
        self.overlap_s += time.perf_counter() - t0

    # ------------------------------------------------------- grammar tables
    def attach_grammar_tokenizer(self, tokenizer, eos_ids=None) -> None:
        """Provide the tokenizer the grammar tables are compiled from; the
        compile itself runs lazily on the first constrained request."""
        if self._grammar is None:
            self._grammar_tok = (tokenizer, tuple(eos_ids or self.eos_token_ids))

    def _ensure_grammar(self) -> Optional[JsonGrammar]:
        if self._grammar is None and self._grammar_tok is not None:
            tok, eos = self._grammar_tok
            self._grammar_tok = None
            self._grammar = JsonGrammar.from_tokenizer(tok, eos_ids=eos)
            log.info("compiled JSON grammar tables (%d states x %d tokens)",
                     self._grammar.tables.n_states, self._grammar.tables.vocab_size)
        return self._grammar

    def _grammar_usable(self) -> bool:
        g = self._ensure_grammar()
        return g is not None and any(
            0 <= e < self.model.config.vocab_size for e in g.tables.eos_ids)

    @staticmethod
    def _grammar_key(req: EngineRequest):
        """None | "json" | ("choice", ...) | ("regex", ...) — which grammar
        (if any) constrains this request.  guided_regex wins over json_mode:
        schema requests carry both, the regex enforcing the schema's shape
        and json_mode serving as the fallback if that regex turns out
        uncompilable."""
        if req.sampling.guided_regex:
            return ("regex", req.sampling.guided_regex)
        if req.sampling.json_mode:
            return "json"
        if req.sampling.guided_choice:
            return ("choice",) + tuple(req.sampling.guided_choice)
        return None

    # composite state budget: a dispatch's composed tables must stay well
    # inside int16 ids; requests that would exceed it wait for slots to
    # free (same backpressure shape as NoFreeBlocks)
    GRAMMAR_STATE_BUDGET = 16384

    def _grammar_states_bound(self, key) -> int:
        """Upper bound on a grammar's state count.  Regex grammars compile
        (and cache) their tables here — the DFA size is not knowable from
        the pattern text, and admission must refuse or stall BEFORE a
        dispatch composes an overflowing table."""
        if key == "json":
            return 128  # the JSON pushdown automaton is ~90 states
        if key[0] == "regex":
            return self._tables_for(key).n_states
        return sum(len(c.encode("utf-8")) for c in key[1:]) + 2

    def _active_grammar_budget_ok(self, new_key) -> bool:
        keys = {self._grammar_key(r) for r in self.slots if r is not None}
        keys.discard(None)
        keys.add(new_key)
        return sum(self._grammar_states_bound(k) for k in keys) <= self.GRAMMAR_STATE_BUDGET

    def _tables_for(self, key):
        """Host VocabTables for one grammar key (request-relative state
        space).  Choice and regex tables compile on first use and are cached
        by key; a compile failure is cached too (bounded), so a resubmitted
        bad pattern does not pay the compile again."""
        if key == "json":
            return self._grammar.tables
        if key in self._choice_tables:
            cached = self._choice_tables[key]
            if isinstance(cached, Exception):
                raise cached
            return cached
        try:
            if key[0] == "regex":
                tables = compile_regex_vocab(self._grammar.token_bytes, key[1],
                                             eos_ids=self._grammar.tables.eos_ids)
            else:
                tables = compile_choice_vocab(self._grammar.token_bytes, list(key[1:]),
                                              eos_ids=self._grammar.tables.eos_ids)
        except Exception as e:
            # varied bad patterns must not grow the cache without limit or
            # starve live tables
            failures = [k for k, v in self._choice_tables.items() if isinstance(v, Exception)]
            if len(failures) >= 32:
                self._choice_tables.pop(failures[0])
            self._choice_tables[key] = e
            raise
        cap = max(16, self.config.max_batch_size)
        if len(self._choice_tables) >= cap:
            # evict a set no active request is using — in-flight grammars
            # stay resident or every dispatch would recompile them
            active = {self._grammar_key(r) for r in self.slots if r is not None}
            victim = next((k for k, v in self._choice_tables.items()
                           if k not in active and not isinstance(v, Exception)), None)
            if victim is not None:
                self._choice_tables.pop(victim)
                self._gdev_cache.clear()  # composites may reference it
        self._choice_tables[key] = tables
        return tables

    def _composite_for(self, keys: tuple):
        """(device tables, {key: state offset}) for a dispatch whose
        constrained rows use exactly ``keys`` (json first — the pushdown
        sentinel resolves against offset-0 ids).  A new key set costs one
        upload of its composite, made while the dispatch's operands are
        built; at most 8 composites stay on the device."""
        if keys not in self._gdev_cache:
            comp, offs = compose_tables([self._tables_for(k) for k in keys])
            if len(self._gdev_cache) >= 8:
                self._gdev_cache.clear()
            self._gdev_cache[keys] = (
                device_tables(comp, self.model.config.vocab_size, self.device),
                dict(zip(keys, offs)),
            )
        return self._gdev_cache[keys]

    def _dispatch_keys(self, reqs) -> tuple:
        """Ordered grammar keys for one dispatch: json first (pushdown
        sentinel constraint), then the others in a canonical order, so
        identical grammar sets hit the same cached composite whatever the
        arrival order."""
        keys = {self._grammar_key(r) for r in reqs}
        keys.discard(None)
        return tuple(sorted(keys, key=lambda k: (k != "json", k)))

    def _gram_kwargs(self, samp, b: int) -> dict:
        """The grammar operand ``gram`` of one dispatch whose sampling rows
        are ``samp`` = [(dispatch row, request)] out of ``b`` rows: the
        composite tables, which rows are constrained, and each row's
        (state, depth, stack) in composite ids; {} when no row is
        constrained."""
        if not any(self._grammar_key(rq) for _, rq in samp) or self._ensure_grammar() is None:
            return {}
        keys = self._dispatch_keys([rq for _, rq in samp])
        gdev, offs = self._composite_for(keys)
        jrows = np.zeros(b, bool)
        jstate = np.full(b, INIT_STATE, np.int32)
        jdepth = np.zeros(b, np.int32)
        jstack = np.zeros(b, np.int32)
        for r, rq in samp:
            key = self._grammar_key(rq)
            if key is None:
                continue
            jrows[r] = True
            gs, gd, gk = rq.gstate
            # request-relative state id -> composite id
            jstate[r] = gs + offs[key] if gs > 0 else gs
            jdepth[r], jstack[r] = gd, gk
        return dict(gram=(gdev, *(self._up(a) for a in (jrows, jstate, jdepth, jstack))))

    def _sampling_extras(self, reqs, rows=None, b=None) -> dict:
        """min_p / per-request seed / logit_bias / grammar tensors for one
        dispatch, or {} when no request uses them.  ``rows``: each request's
        dispatch row (its slot for decode, its packed row for ragged and
        unified dispatches); None = requests are the dispatch rows in order
        (prefill).  ``b`` overrides the row count (ragged: the padded row
        axis)."""
        kw = {}
        if b is None:
            b = self.config.max_batch_size if rows is not None else len(reqs)
        at = (lambda i: rows[i]) if rows is not None else (lambda i: i)
        if any(r.sampling.min_p > 0 for r in reqs):
            mp = np.zeros(b, np.float32)
            for i, r in enumerate(reqs):
                mp[at(i)] = r.sampling.min_p
            kw["min_p"] = self._up(mp)
        if any(r.sampling.seed is not None and not r.sampling.greedy for r in reqs):
            sd = np.zeros(b, np.int32)
            sr = np.zeros(b, bool)
            for i, r in enumerate(reqs):
                if r.sampling.seed is not None and not r.sampling.greedy:
                    sd[at(i)] = int(r.sampling.seed) & 0x7FFFFFFF
                    sr[at(i)] = True
            kw["seeds"] = self._up(sd)
            kw["seed_rows"] = self._up(sr)
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
        kw.update(self._gram_kwargs([(at(i), r) for i, r in enumerate(reqs)], b))
        return kw

    @staticmethod
    def _k_cand(reqs) -> int:
        """Candidate-set width: K_MAX, widened (power-of-two, at most 1024)
        when a request asks for top_k beyond it, so a large top_k never
        silently truncates.  ``torch.topk`` is always exact, so seeded rows
        need no switch to an exact candidate set as in the JAX engine; their
        window caps at K_MAX inside ``sample_full``."""
        want = max((r.sampling.top_k for r in reqs), default=0)
        return min(1 << (want - 1).bit_length(), 1024) if want > K_MAX else K_MAX

    # ------------------------------------------------------- cross-thread API
    def submit(self, request: EngineRequest) -> None:
        request.submitted_at = time.perf_counter()
        self.waiting.put(request)

    def abort(self, request_id: str) -> None:
        self._abort_q.put(request_id)

    def run_on_step(self, fn: Callable) -> "concurrent.futures.Future":
        """Enqueue ``fn`` to run on the engine thread at the next step
        boundary; the returned future resolves with its result.  This is the
        only safe way for other threads to touch the cache or the block
        manager (one writer)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._ops.put((fn, fut))
        return fut

    def fail_pending_ops(self, error: BaseException) -> None:
        """Fail every queued :meth:`run_on_step` operation with ``error``:
        the engine thread has stopped, and no step boundary will run them."""
        while True:
            try:
                _fn, fut = self._ops.get_nowait()
            except queue.Empty:
                return
            if fut.set_running_or_notify_cancel():
                fut.set_exception(error)

    def has_work(self) -> bool:
        return (
            not self.waiting.empty()
            or bool(self._admitted)
            or not self._ops.empty()
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
        """ForwardPassMetrics equivalent, under the JAX engine's key names."""
        active = sum(1 for s in self.slots if s is not None)
        pc, lc = self.prefill_counters, self.lookahead_counters
        return {
            "request_active_slots": active,
            "request_total_slots": self.config.max_batch_size,
            "kv_active_blocks": self.block_manager.active_blocks,
            "kv_total_blocks": self.block_manager.num_blocks,
            "num_requests_waiting": self.waiting.qsize() + len(self._admitted),
            "kv_usage_perc": self.block_manager.usage,
            "tokens_generated": self.tokens_generated,
            "spec_steps": self.spec_steps,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "prefill_dispatches_total": pc.dispatches_total,
            "prefill_batch_occupancy": pc.batch_occupancy,
            "prefill_budget_utilization": pc.budget_utilization,
            "unified_dispatches_total": pc.unified_dispatches_total,
            "unified_decode_rows": pc.unified_decode_rows_total,
            "unified_prefill_tokens": pc.unified_prefill_tokens_total,
            "unified_budget_utilization": pc.unified_budget_utilization,
            "lookahead_bursts_total": lc.bursts_total,
            "lookahead_hits_total": lc.hits_total,
            "lookahead_mispredicts_total": lc.mispredicts_total,
            "lookahead_commits_total": lc.commits_total,
            "lookahead_flushes_total": lc.flushes_total,
            "lookahead_dispatch_depth": lc.dispatch_depth,
            "device_gets_total": self.device_gets,
            "host_gap_ms_per_turn": self.timeline.host_gap_ms_per_turn,
            **(self.host_pool.stats() if self.host_pool is not None else {}),
            **(self.persist_store.stats() if self.persist_store is not None else {}),
        }

    # -------------------------------------------------------------- main loop
    def step(self) -> bool:
        """Run one scheduling iteration.  Returns False when idle.

        The body is wrapped in the step timeline: ``begin()`` opens the
        step, the scheduler and every dispatch ``mark()`` their phase
        boundaries, ``end()`` attributes the residue — so per-phase wall
        time sums to step wall time by construction."""
        self._maybe_profile_start()
        self.timeline.begin()
        try:
            return self._step_inner()
        finally:
            self.timeline.end(trace=self._active_trace())
            self._maybe_profile_stop()

    def _active_trace(self):
        """(trace_id, span_id) of any traced request currently in a slot —
        parents the per-step ``engine.step`` span under a live request
        trace.  None when tracing is off or no slotted request carries a
        trace."""
        from dynamo_tpu_torch.obs import tracing

        if not tracing.enabled():
            return None
        for req in self.slots:
            trace = getattr(req, "trace", None)
            if trace:
                return trace
        return None

    def _maybe_profile_start(self) -> None:
        cfg = self.config
        if not cfg.profile_dir or self._profile_done or self._profiler is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        path = os.path.join(cfg.profile_dir, f"steps-{self.steps:06d}")
        os.makedirs(path, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.start()
        self._profile_path = path
        self._profile_from_step = self.steps

    def _maybe_profile_stop(self, force: bool = False) -> None:
        if self._profiler is None:
            return
        if force or self.steps - self._profile_from_step >= max(1, self.config.profile_steps):
            prof, self._profiler = self._profiler, None
            self._profile_done = True
            prof.stop()
            prof.export_chrome_trace(os.path.join(self._profile_path, "trace.json"))
            log.info("profile of steps %d-%d written to %s", self._profile_from_step,
                     self.steps - 1, self._profile_path)

    def _shapes(self):
        """The model's roofline shapes (``obs/perfmodel.py``), read once;
        None for a model they cannot be read off (the offer then records
        no prediction: monitoring never breaks a dispatch)."""
        if self._perf_shapes is None:
            try:
                self._perf_shapes = model_shapes(
                    self.model, self.kv_bytes_per_block() // self.config.block_size)
            except Exception:
                log.debug("no roofline shapes for %s", type(self.model).__name__,
                          exc_info=True)
                self._perf_shapes = False
        return self._perf_shapes or None

    @staticmethod
    def _decode_work(seq_lens, k: int) -> dict:
        """A ``k``-step decode of rows whose contexts (current token
        included) are ``seq_lens``: each step's token sees its row's
        context so far."""
        n = len(seq_lens)
        pairs = sum(k * int(c) + k * (k - 1) // 2 for c in seq_lens)
        return dict(tokens=n * k, sampled=n * k, pairs=pairs, kv_tokens=pairs - n * k, steps=k)

    def _step_inner(self) -> bool:
        tl = self.timeline
        self._drain_offload()  # evictions from the previous step's tail
        tl.mark("kv_spill_restore")
        self._process_ops()
        self._process_aborts()
        tl.mark("host_ops")
        self._admit()
        tl.mark("admission")
        # slots not yet decoding (waiting on external KV, or mid-chunked-
        # prefill): honour aborts here — _append_token never runs for them
        for req in self.slots:
            if (req is not None
                    and req.state in (RequestState.REMOTE_PREFILL, RequestState.PREFILL)
                    and req.abort_requested):
                self._finish_slot(req, FinishReason.CANCELLED)
        ready = [
            r for r in self.slots
            if r is not None and r.state is RequestState.PREFILL and self._prefill_ready(r)
        ]
        decoding = any(r is not None and r.state is RequestState.RUNNING for r in self.slots)
        if self._unified_enabled():
            # unified token-budget scheduler: a mixed turn is ONE ragged
            # dispatch (decode rows + prefill spans on one flat axis)
            return self._step_unified(ready, decoding)
        # chunked-prefill interleave: when both phases have work, alternate
        # one prefill turn (one chunk, or one ragged token-budget batch)
        # with one decode burst so admissions never stall the decoders for
        # a whole long prompt
        if ready and decoding and self.config.prefill_chunk_tokens:
            if self._last_was_prefill:
                self._last_was_prefill = False
                self._run_decode()
            else:
                self._last_was_prefill = True
                self._dispatch_prefill(ready)
            return True
        if ready:
            self._last_was_prefill = True
            self._dispatch_prefill(ready)
            return True
        if decoding:
            self._last_was_prefill = False
            self._run_decode()
            return True
        return False

    def _unified_enabled(self) -> bool:
        return (
            self.config.unified_token_dispatch
            and self.config.prefill_token_budget > 0
            and getattr(self.model, "supports_unified_dispatch", False)
        )

    def _lookahead_enabled(self) -> bool:
        """Lookahead dispatch is a layer over unified dispatch (the fused
        burst generalises the unified mixed step), so it engages only where
        unified dispatch would."""
        return self.config.lookahead_dispatch and self._unified_enabled()

    def _step_unified(self, ready: list[EngineRequest], decoding: bool) -> bool:
        """One turn of the unified token-budget scheduler: mixed work runs
        as ONE dispatch via :meth:`_run_unified`; pure-prefill turns keep
        the ragged token-budget batch and pure-decode turns the multi-step
        burst."""
        if ready and decoding and self._run_unified(ready):
            return True
        if ready:
            self._dispatch_prefill(ready)
            return True
        if decoding:
            self._run_decode()
            return True
        return False

    def _dispatch_prefill(self, ready: list[EngineRequest]) -> None:
        """One prefill turn over the READY requests (slot order): the
        token-budget ragged batch packs all of them, or, with batching off
        (prefill_token_budget=0) or a model without the ragged path, the
        head request prefills alone.  A seq-parallel long prompt at the head
        dispatches alone (:meth:`_run_sp_prefill`) and stays out of a
        batch."""
        if self._sp_eligible(ready[0]):
            self._run_sp_prefill(ready[0])
        elif self.config.prefill_token_budget > 0 and getattr(
                self.model, "supports_ragged_prefill", False):
            self._run_prefill_batch([r for r in ready if not self._sp_eligible(r)])
        else:
            self._run_prefill(ready[0])

    # ------------------------------------------------ seq-parallel prefill
    def _sp_eligible(self, req: EngineRequest) -> bool:
        """A prompt for the sequence-parallel prefill: long enough, nothing
        cached, and none of the sampling hooks its first-token sampler
        lacks (grammar, bias, min_p, a seed), as in the JAX engine."""
        sp = req.sampling
        return (self._sp_size > 0 and req.computed_tokens == 0
                and req.prompt_len >= self.config.sp_prefill_threshold
                and not (sp.json_mode or sp.guided_choice or sp.guided_regex or sp.logit_bias
                         or sp.min_p)
                and not (sp.seed is not None and not sp.greedy))

    def _run_sp_prefill(self, req: EngineRequest) -> None:
        """The whole prompt in ONE dispatch with the sequence split over the
        mesh's "data" axis (:func:`sp_prefill_step`).  The prompt is padded
        to a power of two of units of Bs x the data size (the JAX engine's
        bucketing); padding keys sit past every real query, causally
        invisible."""
        cfg = self.config
        bs = cfg.block_size
        unit = bs * self._sp_size
        units = -(-req.prompt_len // unit)
        s_pad = (1 << (units - 1).bit_length()) * unit
        tokens = np.zeros((1, s_pad), np.int32)
        tokens[0, :req.prompt_len] = req.prompt
        positions = np.arange(s_pad, dtype=np.int32)[None, :]
        nb = -(-req.prompt_len // bs)
        block_ids = np.asarray(req.block_ids[:nb], np.int64)
        tl = self.timeline
        tl.mark("host_build")
        last = req.prompt_len - 1
        args = self._fwd(sp_prefill_step, (tokens, positions, block_ids), last_idx=last)
        up = self._up
        samp = (up(np.asarray([req.sampling.temperature], np.float32)),
                up(np.asarray([req.sampling.top_k], np.int32)),
                up(np.asarray([req.sampling.top_p], np.float32)))
        tl.mark("upload")
        packed = sp_prefill_step(self.model, self.cache, *args, self._gen, *samp, last_idx=last,
                                 k_cand=self._k_cand([req]))
        self._mark_dispatch("sp_prefill")
        sampled, lps, cids, clps = _unpack(self._read(packed))
        tl.mark("readback")
        self.steps += 1
        self.prefill_steps += 1
        self.sp_prefills += 1
        self.prefill_counters.record(rows=1, tokens=req.prompt_len)
        self.prompt_tokens_computed += req.prompt_len
        req.computed_tokens = req.prompt_len
        self._commit_prefill_blocks(req)
        self._complete_prefill(req, sampled, lps, cids, clps)

    def _process_ops(self) -> None:
        while True:
            try:
                fn, fut = self._ops.get_nowait()
            except queue.Empty:
                break
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except Exception as e:  # handed to the caller through the future
                fut.set_exception(e)

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
        """Pull the cross-thread waiting queue into ``_admitted``, applying
        pending aborts (also run in the lookahead overlap window)."""
        while True:
            try:
                req = self.waiting.get_nowait()
            except queue.Empty:
                break
            if req.request_id in self._pending_aborts:
                self._pending_aborts.discard(req.request_id)
                req.abort_requested = True
            self._admitted.append(req)

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
            if req.prompt_len == 0:
                self._admitted.remove(req)
                self._finish(req, FinishReason.ERROR)
                continue
            if req.prompt_len >= self.config.max_model_len:
                self._admitted.remove(req)
                self._finish(req, FinishReason.LENGTH)
                continue
            gkey = self._grammar_key(req)
            if gkey is not None and not (
                self._grammar_usable()
                and (gkey == "json" or self._grammar.token_bytes is not None)
            ):
                # constrained decoding needs tokenizer-compiled tables AND a
                # model-vocab EOS id (terminal states are EOS-only; without
                # one the mask would go all -inf on completion)
                self._admitted.remove(req)
                self._finish(req, FinishReason.ERROR)
                continue
            if gkey is not None:
                try:
                    budget_ok = self._active_grammar_budget_ok(gkey)
                except Exception:
                    if gkey[0] == "regex" and req.sampling.json_mode:
                        # a schema-derived regex overflowed the DFA cap:
                        # fall back to the generic JSON grammar
                        log.warning("schema regex uncompilable for %s; falling back to "
                                    "generic JSON mode", req.request_id)
                        req.sampling.guided_regex = None
                        gkey = "json"
                        budget_ok = self._active_grammar_budget_ok(gkey)
                    else:
                        # bad pattern / oversized DFA with no fallback: fail
                        # the request, not the engine step
                        log.exception("grammar compile failed for %s", req.request_id)
                        self._admitted.remove(req)
                        self._finish(req, FinishReason.ERROR)
                        continue
                if not budget_ok:
                    # the composed tables must stay inside int16 state ids:
                    # wait for constrained slots to free (backpressure, not
                    # an error)
                    break
            req.seq = TokenBlockSequence(req.prompt, self.config.block_size)
            try:
                alloc = self.block_manager.allocate(req.seq.sequence_hashes(), req.prompt_len)
            except NoFreeBlocks:
                break  # retry next step once blocks free up
            req.block_ids = alloc.block_ids
            req.cached_tokens = alloc.cached_tokens
            if self.host_pool is not None:
                # allocation may have evicted registered blocks: snapshot
                # their content BEFORE restore (or this step's prefill)
                # writes into the same ids.  With joined in-flight blocks a
                # restore would write host content into blocks their owner
                # is writing — skip it; the owner's compute is arriving.
                self._drain_offload()
                if alloc.joined_tokens == 0:
                    self._restore_from_host(req)
            req.computed_tokens = req.cached_tokens
            req.wait_upto = req.cached_tokens + alloc.joined_tokens
            self._reserve_own(req)
            req.slot = slot
            if req.submitted_at:
                req.queue_wait_s = time.perf_counter() - req.submitted_at
            req.state = (RequestState.REMOTE_PREFILL if req.remote_prefill
                         else RequestState.PREFILL)
            self.slots[slot] = req
            self._by_id[req.request_id] = req
            self._admitted.remove(req)
            self._pen_cache = None  # live request set changed
            if req.on_allocated is not None:
                try:
                    req.on_allocated(req)
                except Exception:
                    # a dying caller (closed event loop) must not take down
                    # every other request via step() -> fail_all()
                    log.exception("on_allocated callback failed for %s", req.request_id)
                    req.abort_requested = True

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

        # only the final chunk's sample is kept, so only it is masked
        extras = self._sampling_extras([req]) if final else {}
        k_cand = self._k_cand([req])
        tl = self.timeline
        tl.mark("host_build")
        up = self._up
        pb = req.computed_tokens // bs
        args = self._fwd(unified_step, (tokens, positions, bt, np.asarray([end], np.int32),
                                        slot_idx, np.asarray([take - 1], np.int32)),
                         prefix_blocks=pb)
        samp = (up(np.asarray([req.sampling.temperature], np.float32)),
                up(np.asarray([req.sampling.top_k], np.int32)),
                up(np.asarray([req.sampling.top_p], np.float32)))
        tl.mark("upload")
        if self.perf_model.wants("step"):
            begin = req.computed_tokens
            self.perf_model.offer("step", self._shapes(), tokens=take, sampled=1,
                                  pairs=visible_pairs([begin], [end]), kv_tokens=begin)
        packed = unified_step(self.model, self.cache, *args, self._gen, *samp,
                              prefix_blocks=pb, k_cand=k_cand, **extras)
        self._mark_dispatch("step")
        self.steps += 1
        sampled, lps, cids, clps = _unpack(self._read(packed))
        tl.mark("readback")
        self.prefill_steps += 1
        self.prefill_counters.record(rows=1, tokens=take)
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
        self._fire_commit_hook(req, done=False)

    def _complete_prefill(self, req, sampled, lps, cids, clps) -> None:
        # a completed prefill must not count against the next arrival: reset
        # the interleave unless another prefill is mid-flight
        if not any(
            r is not None and r is not req and r.state is RequestState.PREFILL
            for r in self.slots
        ):
            self._last_was_prefill = False
        req.state = RequestState.RUNNING
        if req.remote_decode:
            # prefill-only request: emit the first sampled token, hold the
            # blocks for transfer-out, free the slot
            self._held[req.request_id] = list(req.block_ids)
            # done=True covers ALL blocks, the partial tail block
            # _commit_prefill_blocks never reaches included
            self._fire_commit_hook(req, done=True)
            self.slots[req.slot] = None
            self._by_id.pop(req.request_id, None)
            req.state = RequestState.FINISHED
            req.finish_reason = FinishReason.STOP
            self.tokens_generated += 1
            req.emit(LLMEngineOutput(token_ids=[int(sampled[0])],
                                     finish_reason=FinishReason.STOP,
                                     cached_tokens=req.cached_tokens))
            return
        self._append_token(req, int(sampled[0]), first=True,
                           logprob=float(lps[0]), cand=(cids[0], clps[0]))

    # ------------------------------------------- token-budget ragged prefill
    def _plan_spans(self, pending, budget: int):
        """Pack prefill chunks under a token budget: ``pending`` is
        [(request, begin)] in slot order; returns ([(request, begin, take,
        final)], flat tokens used).  Each chunk takes a block-rounded span,
        and a non-final chunk ends block-aligned so the next one starts
        block-aligned."""
        bs = self.config.block_size
        plan, used = [], 0
        for req, begin in pending:
            avail = budget - used
            if avail < bs:
                break
            remaining = req.prompt_len - begin
            take = min(remaining, self.config.prefill_chunk_tokens or remaining, avail)
            if take < remaining:
                take = take // bs * bs
                if take == 0:
                    break
            plan.append((req, begin, take, take == remaining))
            used += -(-take // bs) * bs
        return plan, used

    def _prefix_bucket(self, max_pb: int) -> int:
        """The plain ragged op's cached-prefix gather bound: the rows' most
        prefix blocks, power-of-two bucketed like the JAX engine's (the
        kernel streams each row's prefix by its true start instead)."""
        pb = 0 if max_pb == 0 else 1 << (max_pb - 1).bit_length()
        return min(pb, self.config.max_blocks_per_seq)

    def _run_prefill_batch(self, reqs: list[EngineRequest]) -> None:
        """Token-budget ragged prefill: pack up to ``prefill_token_budget``
        tokens of pending prefill work (several requests' chunks, each a
        block-aligned span; padding slots are -1 / seq_id -1) onto one flat
        axis, bucketed by ``config.bucket_for``, with the row axis padded to
        a power of two, and run ONE ragged dispatch.  Only final-chunk rows'
        samples are kept; they carry their request's sampling extras."""
        cfg = self.config
        budget = cfg.prefill_token_budget
        plan, used = self._plan_spans([(r, r.computed_tokens) for r in reqs], budget)
        r_pad = 1 << max(0, (len(plan) - 1).bit_length())
        arrays = self._alloc_unified_arrays(r_pad, cfg.bucket_for(used))
        off = max_pb = 0
        for r, (req, begin, take, _final) in enumerate(plan):
            off = self._fill_prefill_span(arrays, r, off, req, begin, take)
            max_pb = max(max_pb, begin // cfg.block_size)
        (tokens, positions, slot_idx, seq_ids, bt, seq_lens, starts, roff, last_idx,
         temp, top_k, top_p, _limits) = arrays
        finals = [(r, req) for r, (req, _, _, fin) in enumerate(plan) if fin]
        final_reqs = [req for _, req in finals]
        extras = self._sampling_extras(final_reqs, rows=[r for r, _ in finals], b=r_pad)
        k_cand = self._k_cand(final_reqs)
        tl = self.timeline
        tl.mark("host_build")
        up = self._up
        pb = self._prefix_bucket(max_pb)
        args = self._fwd(ragged_prefill_step, (tokens, positions, bt, seq_lens, slot_idx, seq_ids,
                                               starts, roff, last_idx), prefix_blocks=pb)
        samp = (up(temp), up(top_k), up(top_p))
        tl.mark("upload")
        if self.perf_model.wants("prefill_ragged"):
            begins = [begin for _, begin, _, _ in plan]
            self.perf_model.offer(
                "prefill_ragged", self._shapes(), tokens=sum(t for _, _, t, _ in plan),
                sampled=len(plan), kv_tokens=sum(begins),
                pairs=visible_pairs(begins, [b + t for _, b, t, _ in plan]))
        packed = ragged_prefill_step(self.model, self.cache, *args, self._gen, *samp,
                                     prefix_blocks=pb, k_cand=k_cand, **extras)
        self._mark_dispatch("prefill_ragged")
        self.steps += 1
        if self._lookahead_enabled():
            self._overlap(self._drain_waiting)  # absorb arrivals under compute
            tl.mark("overlap")
        sampled, lps, cids, clps = _unpack(self._read(packed))
        tl.mark("readback")
        take_sum = sum(take for _, _, take, _ in plan)
        self.prefill_steps += 1
        self.prompt_tokens_computed += take_sum
        self.prefill_counters.record(rows=len(plan), tokens=take_sum, budget=budget)
        for r, (req, _, take, final) in enumerate(plan):
            req.computed_tokens += take
            self._commit_prefill_blocks(req)
            if final:
                self._complete_prefill(req, sampled[r:r + 1], lps[r:r + 1],
                                       cids[r:r + 1], clps[r:r + 1])

    # ------------------------------------------------ unified mixed dispatch
    def _run_unified(self, ready: list[EngineRequest]) -> bool:
        """ONE mixed dispatch for this turn: every RUNNING slot contributes
        a decode row (1 fresh token) on the leading row-scatter region of
        the flat axis, then the READY prefill chunks pack block-aligned
        spans into the remaining token budget.  With lookahead the dispatch
        is a fused burst of ``interactive_decode_steps`` turns, and the next
        turn's prefill operands are prebuilt while it runs.  Returns False
        when no decode row is dispatchable or no prefill chunk fits (the
        caller falls back to a pure prefill/decode turn)."""
        cfg = self.config
        bs = cfg.block_size
        # decode region: a fixed block multiple of the flat axis (one slot
        # per batch slot), so the prefill spans after it stay block-aligned
        d_region = -(-cfg.max_batch_size // bs) * bs
        budget = max(bs, cfg.prefill_token_budget - d_region)
        budget = min(budget, cfg.max_model_len - d_region)
        if budget < bs:
            return False  # the flat axis cannot fit a span past the region

        lookahead = self._lookahead_enabled()
        # mixed turns always have prefill pending, so the interactive burst
        # length applies; 1 without lookahead keeps the single-turn dispatch
        k_steps = max(1, cfg.interactive_decode_steps) if lookahead else 1
        dec: list[EngineRequest] = []
        dec_limits: list[int] = []
        for req in self.slots:
            if req is None or req.state is not RequestState.RUNNING:
                continue
            limit = self._grow_blocks(req, k_steps)
            if limit is None:
                continue  # no slot for even the current token: LENGTH
            dec.append(req)
            dec_limits.append(limit)
        if not dec:
            return False
        sel, used = self._plan_spans([(r, r.computed_tokens) for r in ready], budget)
        if not sel:
            return False

        n_dec = len(dec)
        r_pad = 1 << max(0, (n_dec + len(sel) - 1).bit_length())
        t_pad = cfg.bucket_for(d_region + used)
        # speculative-dispatch commit protocol: if last turn's overlap window
        # prebuilt exactly this plan, reuse its prefill-span arrays; decode
        # rows advance every turn and are always refilled below.  Any
        # divergence (a stop fired, an admission or finish changed the slot
        # map, a chunk resized) mismatches the key: flush and rebuild.
        arrays = None
        max_pb = 0
        if lookahead:
            spec, self._spec_next = self._spec_next, None
            if spec is not None:
                key = (tuple(r.request_id for r in dec),
                       tuple((rq.request_id, begin, take, fin) for rq, begin, take, fin in sel),
                       d_region, r_pad, t_pad)
                if spec["key"] == key:
                    arrays, max_pb = spec["arrays"], spec["max_pb"]
                    self.lookahead_counters.record_commit()
                else:
                    self.lookahead_counters.record_flush()
        if arrays is None:
            arrays = self._alloc_unified_arrays(r_pad, t_pad)
            off = d_region
            for j, (req, begin, take, _final) in enumerate(sel):
                off = self._fill_prefill_span(arrays, n_dec + j, off, req, begin, take)
                max_pb = max(max_pb, begin // bs)
        (tokens, positions, slot_idx, seq_ids, bt, seq_lens, starts, roff, last_idx,
         temp, top_k, top_p, limits) = arrays
        for r, req in enumerate(dec):
            p = req.seq.total_tokens - 1  # uncomputed tail position
            tokens[0, r] = req.seq.tokens[-1]
            positions[0, r] = p
            slot_idx[0, r] = req.block_ids[p // bs] * bs + p % bs
            seq_ids[0, r] = r
            bt[r, :len(req.block_ids)] = req.block_ids
            seq_lens[r] = p + 1
            starts[r] = p  # the full cached prefix; need NOT be block-aligned
            roff[r] = r
            last_idx[r] = r
            temp[r] = req.sampling.temperature
            top_k[r] = req.sampling.top_k
            top_p[r] = req.sampling.top_p
            limits[r] = dec_limits[r]
            max_pb = max(max_pb, -(-p // bs))

        # sampling rows: every decode row plus final-chunk prefill rows
        samp = list(enumerate(dec)) + [
            (n_dec + j, rq) for j, (rq, _, _, fin) in enumerate(sel) if fin
        ]
        samp_reqs = [rq for _, rq in samp]
        extras = self._sampling_extras(samp_reqs, rows=[r for r, _ in samp], b=r_pad)
        burst = lookahead and k_steps >= 2
        pen = self._unified_penalties(samp, r_pad, horizon=k_steps if burst else 1)
        statics = dict(row_tokens=d_region, prefix_blocks=self._prefix_bucket(max_pb))
        kw = dict(statics, k_cand=self._k_cand(samp_reqs), **extras)
        # growth allocations above may have evicted registered blocks that
        # this very dispatch writes into — offload them first
        tl = self.timeline
        tl.mark("host_build")
        self._drain_offload()
        tl.mark("kv_spill_restore")
        up = self._up
        kind = "unified_burst" if burst else "unified"
        host = (tokens, positions, bt, seq_lens, slot_idx, seq_ids, starts, roff, last_idx)
        if burst:
            args = (self.model, self.cache) + self._fwd(
                unified_burst_step, host + (limits,), num_steps=k_steps, block_size=bs, **statics)
        else:
            args = (self.model, self.cache) + self._fwd(unified_token_step, host, **statics)
        sampling = (self._gen, up(temp), up(top_k), up(top_p))
        pen = None if pen is None else tuple(up(a) for a in pen)
        tl.mark("upload")
        if self.perf_model.wants(kind):
            dec_lens = [int(seq_lens[r]) for r in range(n_dec)]
            later = self._decode_work([c + 1 for c in dec_lens], k_steps - 1) if burst else dict(
                tokens=0, sampled=0, pairs=0, kv_tokens=0)
            begins = [rq_begin for _, rq_begin, _, _ in sel]
            fresh = sum(t for _, _, t, _ in sel)
            self.perf_model.offer(
                kind, self._shapes(), steps=k_steps,
                tokens=n_dec + fresh + later["tokens"],
                sampled=len(samp) + later["sampled"],
                pairs=sum(dec_lens) + visible_pairs(begins, [b + t for _, b, t, _ in sel])
                + later["pairs"],
                kv_tokens=sum(dec_lens) - n_dec + sum(begins) + later["kv_tokens"])
        if burst:
            packed = unified_burst_step(*args, *sampling, pen, num_steps=k_steps,
                                        block_size=bs, **kw)
        else:
            packed = unified_token_step(*args, *sampling, pen, **kw)
        self._mark_dispatch(kind)
        self.steps += 1
        if lookahead:
            # overlap window: the dispatch above is enqueued — drain arrivals
            # and speculatively prebuild the NEXT turn's prefill-span operands
            # before the result read synchronises with the card
            def window():
                self._drain_waiting()
                self._spec_next = self._prebuild_next(ready, sel, dec, d_region, budget)
            self._overlap(window)
            tl.mark("overlap")
        res = self._read(packed)
        tl.mark("readback")
        if not burst:
            res = res[None]
        sampled, lps, cids, clps = _unpack(res)  # [K, R], [K, R], [K, R, C], [K, R, C]
        take_sum = sum(take for _, _, take, _ in sel)
        self.prefill_steps += 1
        self.decode_steps += k_steps
        self.prompt_tokens_computed += take_sum
        self.prefill_counters.record(rows=len(sel), tokens=take_sum, budget=budget)
        self.prefill_counters.record_unified(
            decode_rows=n_dec, prefill_tokens=take_sum,
            budget=cfg.prefill_token_budget)

        hits = mis = 0
        for r, req in enumerate(dec):
            want_lp = req.sampling.logprobs or req.sampling.top_logprobs > 0
            row_len = int(seq_lens[r])  # pre-dispatch total (p + 1)
            # turn 0, then the later turns: positions at/past the row's
            # block limit wrote no KV on the device, so only `allowed`
            # samples are real
            allowed = 1 + max(0, min(k_steps - 1, dec_limits[r] - row_len))
            consumed = 0
            for k in range(allowed):
                if req.state is not RequestState.RUNNING:
                    break  # a stop fired mid-burst: discard the tail
                self._append_token(
                    req, int(sampled[k, r]),
                    logprob=float(lps[k, r]) if want_lp else None,
                    cand=(cids[k, r], clps[k, r]) if want_lp else None,
                )
                consumed += 1
            if not burst:
                continue
            if req.state is RequestState.RUNNING and allowed < k_steps:
                # out of block-table room mid-burst: LENGTH, as in a decode burst
                self._finish_slot(req, FinishReason.LENGTH)
            if consumed < allowed:
                mis += 1  # a stop fired: the predicted tail was discarded
            else:
                hits += 1
        if burst:
            self.lookahead_counters.record_burst(k_steps, hits, mis)
        for j, (req, _, take, final) in enumerate(sel):
            r = n_dec + j
            req.computed_tokens += take
            self._commit_prefill_blocks(req)
            if final:
                self._complete_prefill(req, sampled[0, r:r + 1], lps[0, r:r + 1],
                                       cids[0, r:r + 1], clps[0, r:r + 1])
        return True

    def _alloc_unified_arrays(self, r_pad: int, t_pad: int):
        """Zero/pad-initialised operands of one ragged or unified dispatch,
        shared by the live build and :meth:`_prebuild_next`, so a committed
        speculative build is identical to a fresh one.  Padding rows keep
        seq_lens = starts = row_offsets = 0: their spans are empty."""
        m = self.config.max_blocks_per_seq
        tokens = np.zeros((1, t_pad), np.int32)
        positions = np.zeros((1, t_pad), np.int32)
        slot_idx = np.full((1, t_pad), -1, np.int32)
        seq_ids = np.full((1, t_pad), -1, np.int32)
        bt = np.zeros((r_pad, m), np.int32)
        seq_lens = np.zeros(r_pad, np.int32)
        starts = np.zeros(r_pad, np.int32)
        roff = np.zeros(r_pad, np.int32)
        last_idx = np.zeros(r_pad, np.int32)
        temp = np.zeros(r_pad, np.float32)
        top_k = np.zeros(r_pad, np.int32)
        top_p = np.ones(r_pad, np.float32)
        limits = np.zeros(r_pad, np.int32)
        return (tokens, positions, slot_idx, seq_ids, bt, seq_lens, starts, roff, last_idx,
                temp, top_k, top_p, limits)

    def _fill_prefill_span(self, arrays, r: int, off: int, rq: EngineRequest, begin: int,
                           take: int) -> int:
        """Fill dispatch row ``r`` with ``rq``'s prefill chunk ``[begin,
        begin + take)`` from flat offset ``off``; returns the next
        (block-rounded) span offset.  Safe to run speculatively: it reads
        only ``rq.prompt`` and ``rq.block_ids``, which do not change while
        the request sits in PREFILL."""
        bs = self.config.block_size
        (tokens, positions, slot_idx, seq_ids, bt, seq_lens, starts, roff, last_idx,
         temp, top_k, top_p, _limits) = arrays
        end = begin + take
        tokens[0, off:off + take] = rq.prompt[begin:end]
        pos = np.arange(begin, end, dtype=np.int32)
        positions[0, off:off + take] = pos
        bt[r, :len(rq.block_ids)] = rq.block_ids
        slot_idx[0, off:off + take] = bt[r, pos // bs] * bs + pos % bs
        seq_ids[0, off:off + take] = r
        seq_lens[r] = end
        starts[r] = begin
        roff[r] = off
        last_idx[r] = off + take - 1
        temp[r] = rq.sampling.temperature
        top_k[r] = rq.sampling.top_k
        top_p[r] = rq.sampling.top_p
        return off + -(-take // bs) * bs

    def _prebuild_next(self, ready, sel, dec, d_region: int, budget: int) -> Optional[dict]:
        """Speculatively build the NEXT unified turn's prefill-span operands
        in the overlap window.

        Prediction: this turn's chunks land (``computed_tokens`` advances by
        ``take``), every decode row survives, finals join the decode set,
        and no admission or finish changes the slot map.  The returned
        ``key`` pins that prediction; the next :meth:`_run_unified` commits
        the arrays when its plan matches and flushes them otherwise.  Only
        the prefill spans are prebuilt — decode rows are refilled every
        turn."""
        cfg = self.config
        sel_map = {rq.request_id: (take, fin) for rq, _, take, fin in sel}
        nxt = []  # (request, predicted next begin), ready order kept
        for rq in ready:
            take, fin = sel_map.get(rq.request_id, (0, False))
            if not fin:
                nxt.append((rq, rq.computed_tokens + take))
        plan, used = self._plan_spans(nxt, budget)
        if not plan:
            return None  # no prefill survives: the next turn is not mixed
        dec_ids = {r.request_id for r in dec}
        fin_ids = {rq.request_id for rq, _, _, fin in sel if fin}
        pred_dec = [r.request_id for r in self.slots
                    if r is not None and (r.request_id in dec_ids or r.request_id in fin_ids)]
        n_dec = len(pred_dec)
        r_pad = 1 << max(0, (n_dec + len(plan) - 1).bit_length())
        t_pad = cfg.bucket_for(d_region + used)
        arrays = self._alloc_unified_arrays(r_pad, t_pad)
        off = d_region
        max_pb = 0
        for j, (rq, begin, take, _fin) in enumerate(plan):
            off = self._fill_prefill_span(arrays, n_dec + j, off, rq, begin, take)
            max_pb = max(max_pb, begin // cfg.block_size)
        key = (tuple(pred_dec), tuple((rq.request_id, b, t, f) for rq, b, t, f in plan),
               d_region, r_pad, t_pad)
        return dict(key=key, arrays=arrays, max_pb=max_pb)

    def _unified_penalties(self, samp, r_pad: int, horizon: int = 1):
        """Penalty buffers for one unified dispatch, keyed by DISPATCH row
        (cf. :meth:`_penalty_buffers`, keyed by slot), or None when no
        sampling row uses penalties: (pen_tokens [R_pad, T] -1-padded,
        pen_first, freq_pen, pres_pen), and for a fused burst (``horizon``
        > 1) the per-row write cursor after pen_first, with T sized for the
        burst's appends.

        The host build is cached on (rows, shapes, live request set and
        penalty strengths): while that holds, only the tokens generated
        since the previous turn are appended.  Admission and finish drop
        the cache."""
        users = [(r, rq) for r, rq in samp
                 if rq.sampling.frequency_penalty or rq.sampling.presence_penalty]
        if not users:
            return None
        longest = max(rq.seq.total_tokens - rq.prompt_len for _, rq in users)
        need = longest if horizon <= 1 else longest + horizon
        t_cap = max(16, 1 << max(0, need - 1).bit_length())
        t_cap = min(t_cap, max(16, 1 << (self.config.max_model_len - 1).bit_length()))
        key = (r_pad, t_cap, tuple((rq.request_id, r, rq.sampling.frequency_penalty,
                                    rq.sampling.presence_penalty) for r, rq in users))
        pc = self._pen_cache
        if pc is None or pc["key"] != key:
            pc = self._pen_cache = dict(
                key=key, ptoks=np.full((r_pad, t_cap), -1, np.int32),
                pfirst=np.zeros((r_pad, t_cap), bool), freq=np.zeros(r_pad, np.float32),
                pres=np.zeros(r_pad, np.float32), seen={}, count={})
            for r, rq in users:
                pc["freq"][r] = rq.sampling.frequency_penalty
                pc["pres"][r] = rq.sampling.presence_penalty
                pc["seen"][rq.request_id] = set()
                pc["count"][rq.request_id] = 0
        ptoks, pfirst = pc["ptoks"], pc["pfirst"]
        for r, rq in users:
            gen = rq.seq.tokens[rq.prompt_len:]
            seen = pc["seen"][rq.request_id]
            n = min(len(gen), t_cap)
            for j in range(pc["count"][rq.request_id], n):
                ptoks[r, j] = gen[j]
                if gen[j] not in seen:
                    pfirst[r, j] = True
                    seen.add(gen[j])
            pc["count"][rq.request_id] = n
        if horizon <= 1:
            return ptoks, pfirst, pc["freq"], pc["pres"]
        # fused burst: the device appends past this cursor each turn
        cur = np.zeros(r_pad, np.int32)
        for r, rq in users:
            cur[r] = min(rq.seq.total_tokens - rq.prompt_len, t_cap)
        return ptoks, pfirst, cur, pc["freq"], pc["pres"]

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

    # ----------------------------------------------------- speculative decode
    @staticmethod
    def _spec_eligible(reqs) -> bool:
        """Speculation composes with plain sampling (greedy, temperature,
        top_k <= K_MAX, top_p, min_p, per-request seeds — the verify pass
        samples each position with its own noise, see
        :func:`spec_verify_step`).  Still excluded: penalties (the verify
        forward doesn't thread the generated-token buffers through accepted
        positions), logprobs (not returned per verified position),
        logit_bias, and grammar modes (mask state advances once per emitted
        token on the decode path).  top_k > K_MAX keeps the burst, as in the
        JAX engine."""
        return all(
            (r.sampling.greedy or r.sampling.top_k <= K_MAX)
            and not r.sampling.frequency_penalty
            and not r.sampling.presence_penalty
            and not r.sampling.logprobs
            and not r.sampling.top_logprobs
            and not r.sampling.logit_bias
            and not r.sampling.json_mode
            and not r.sampling.guided_choice
            and not r.sampling.guided_regex
            for r in reqs
        )

    def _try_spec_decode(self) -> bool:
        """Speculative dispatch: verify up to ``spec_tokens`` proposed
        continuations per row in ONE forward (:func:`spec_verify_step`) and
        emit the matching prefix + one bonus token.  Proposals come from the
        draft model when there is one (one draft dispatch for the batch) and
        from n-gram lookup for the rows it cannot serve.  Returns False when
        no row has a proposal, or when bursts are configured and fewer than
        half the rows propose (the caller falls back to the burst).

        The block table is sliced to the batch's live context (power-of-two
        bucketed), which is what bounds the plain op's gather; the decode
        kernel streams only each row's live blocks either way."""
        from dynamo_tpu_torch.engine.spec import propose_ngram

        cfg = self.config
        k = cfg.spec_tokens
        b, m = cfg.max_batch_size, cfg.max_blocks_per_seq
        s = k + 1
        active = [r for r in self.slots if r is not None and r.state is RequestState.RUNNING]
        if not active or not self._spec_eligible(active):
            return False

        tokens = np.zeros((b, s), np.int32)
        positions = np.zeros((b, s), np.int32)
        slot_idx = np.full((b, s), -1, np.int32)
        bt = np.zeros((b, m), np.int32)
        seq_lens = np.zeros(b, np.int32)
        limits = np.zeros(b, np.int32)
        temp = np.zeros(b, np.float32)  # inactive rows: greedy, ignored
        top_k = np.zeros(b, np.int32)
        top_p = np.ones(b, np.float32)
        props: dict[int, list[int]] = {}
        rows: list[EngineRequest] = []
        any_prop = False
        # draft-model proposals for the whole batch in one dispatch; rows
        # the draft can't serve fall back to n-gram lookup below
        draft_props = self.draft.propose(active, k, m) if self.draft is not None else {}
        for req in active:
            i = req.slot
            temp[i] = req.sampling.temperature
            top_k[i] = req.sampling.top_k
            top_p[i] = req.sampling.top_p
            p = req.seq.total_tokens - 1  # position of the uncomputed tail
            limit = self._grow_blocks(req, s)
            if limit is None:
                continue
            prop = draft_props.get(i) or propose_ngram(req.seq.tokens, cfg.spec_ngram, k)
            prop = prop[:max(0, limit - (p + 1))]  # KV positions stay in range
            props[i] = prop
            any_prop = any_prop or bool(prop)
            rows.append(req)
            row_tokens = [req.seq.tokens[-1]] + prop
            n = len(row_tokens)
            # live queries only: positions past a row's n stay 0 and its pad
            # queries' samples are discarded
            tokens[i, :n] = row_tokens
            positions[i, :n] = np.arange(p, p + n, dtype=np.int32)
            blk = positions[i, :n] // cfg.block_size
            slot_idx[i, :n] = (np.asarray(req.block_ids, np.int32)[blk] * cfg.block_size
                               + positions[i, :n] % cfg.block_size)
            bt[i, :len(req.block_ids)] = req.block_ids
            seq_lens[i] = p + n
            limits[i] = limit
        if not any_prop or not rows:
            return False
        # a speculative dispatch emits 1 token for every non-proposing row
        # (vs up to decode_steps in a burst): one repetitive request must
        # not collapse the whole batch's throughput, so speculate only when
        # proposals cover at least half the rows (single-row batches always
        # qualify — speculation is the latency lever there)
        proposing = sum(1 for r in rows if props.get(r.slot))
        if cfg.decode_steps > 1 and proposing * 2 < len(rows):
            return False

        # slice the block table to the batch's live context, pow2-bucketed
        blocks_used = max(1, -(-int(seq_lens.max()) // cfg.block_size))
        m_used = min(m, 1 << (blocks_used - 1).bit_length())
        tl = self.timeline
        tl.mark("host_build")
        self._drain_offload()
        tl.mark("kv_spill_restore")
        up = self._up
        extras = self._sampling_extras(rows, rows=[r.slot for r in rows])
        k_cand = self._k_cand(rows)
        tl.mark("host_build")
        args = self._fwd(spec_verify_step, (tokens, positions, bt[:, :m_used], seq_lens, slot_idx))
        samp = (up(temp), up(top_k), up(top_p))
        tl.mark("upload")
        if self.perf_model.wants("spec_verify"):
            ps = [r.seq.total_tokens - 1 for r in rows]
            ns = [1 + len(props.get(r.slot, [])) for r in rows]
            self.perf_model.offer("spec_verify", self._shapes(), tokens=sum(ns), sampled=sum(ns),
                                  pairs=visible_pairs(ps, [p + n for p, n in zip(ps, ns)]),
                                  kv_tokens=sum(ps))
        packed = spec_verify_step(
            self.model, self.cache, *args, self._gen, *samp, min_p=extras.get("min_p"),
            seeds=extras.get("seeds"), seed_rows=extras.get("seed_rows"), k_cand=k_cand)
        self._mark_dispatch("spec_verify")
        verified = self._read(packed)
        tl.mark("readback")
        self.steps += 1
        self.decode_steps += 1
        self.spec_steps += 1
        for req in rows:
            i = req.slot
            prop = props.get(i, [])
            # accept the proposal prefix the verify samples agree with, then
            # the bonus token from the first disagreeing (or final) position
            # — each emitted token is that position's own sample
            a = 0
            while a < len(prop) and prop[a] == int(verified[i, a]):
                a += 1
            emit = [int(verified[i, j]) for j in range(a + 1)]
            self.spec_proposed += len(prop)
            self.spec_accepted += a
            allowed = min(len(emit), int(limits[i] - (req.seq.total_tokens - 1)))
            for t in emit[:allowed]:
                if req.state is not RequestState.RUNNING:
                    break  # EOS/stop/max_tokens mid-acceptance
                self._append_token(req, t)
            if req.state is RequestState.RUNNING and allowed < len(emit):
                self._finish_slot(req, FinishReason.LENGTH)
        return True

    def _run_decode(self) -> None:
        """One decode dispatch = up to ``config.decode_steps`` tokens per
        active sequence (``interactive_decode_steps`` while prefill work is
        pending), generated on the device with one host sync per burst.
        Blocks for the whole burst are allocated up front; a sequence that
        runs out of block space stops writing KV at its ``limit`` and is
        finished at LENGTH once its allowed samples are consumed.  With
        ``spec_tokens`` a speculative verify is tried first."""
        cfg = self.config
        if cfg.spec_tokens > 0 and self._try_spec_decode():
            return
        b, m = cfg.max_batch_size, cfg.max_blocks_per_seq
        can_admit = (
            any(s is None for s in self.slots) and self.block_manager.free_blocks > 0
        ) or any(r is not None and r.abort_requested for r in self.slots)
        # REMOTE_PREFILL counts too: the disaggregated first token arrives
        # through the ops queue, processed only between dispatches
        prefill_pending = (
            ((bool(self._admitted) or not self.waiting.empty()) and can_admit)
            or any(r is not None
                   and r.state in (RequestState.PREFILL, RequestState.REMOTE_PREFILL)
                   for r in self.slots)
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
        # growth allocations above may have evicted registered blocks that
        # this very dispatch writes into — offload them first
        tl = self.timeline
        tl.mark("host_build")
        self._drain_offload()
        tl.mark("kv_spill_restore")
        pen = self._penalty_buffers(active, k_steps)
        k_cand = self._k_cand(active)
        extras = self._sampling_extras(active, rows=[r.slot for r in active])
        tl.mark("host_build")
        up = self._up
        args = self._fwd(multi_decode_step, (tokens, positions, bt, seq_lens, limits),
                         num_steps=k_steps, block_size=cfg.block_size)
        samp = (up(temp), up(top_k), up(top_p))
        pen = None if pen is None else tuple(up(a) for a in pen)
        tl.mark("upload")
        if self.perf_model.wants("decode_multi"):
            self.perf_model.offer("decode_multi", self._shapes(), **self._decode_work(
                [int(seq_lens[r.slot]) for r in active], k_steps))
        packed = multi_decode_step(self.model, self.cache, *args, self._gen, *samp, pen=pen,
                                   num_steps=k_steps, block_size=cfg.block_size, k_cand=k_cand,
                                   **extras)
        self._mark_dispatch("decode_multi")
        self.steps += 1
        if self._lookahead_enabled():
            # overlap window: absorb arrivals while the device runs the burst
            self._overlap(self._drain_waiting)
            tl.mark("overlap")
        sampled, lps, cids, clps = _unpack(self._read(packed))  # [K, B], ..., [K, B, C]
        tl.mark("readback")
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
        gkey = self._grammar_key(req)
        if gkey is not None and self._grammar is not None:
            # host mirror of the device's grammar advance (same tables, same
            # sampled token; request-relative state ids)
            req.gstate = self._tables_for(gkey).advance(*req.gstate, token)

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
            if self.draft is not None:
                self.draft.release(req.slot)
        self._pen_cache = None  # live request set changed
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

    # ------------------------------------------------- disaggregation support
    # All of these run on the engine thread (call them through run_on_step
    # from elsewhere) but the routing probes prefix_hit_tokens and
    # kv_bytes_per_block, which only read.

    def held_blocks(self, request_id: str) -> list[int]:
        """Block ids of a finished remote-decode prefill, still resident."""
        return list(self._held.get(request_id, ()))

    def release_held(self, request_id: str) -> None:
        """Transfer-out done: drop the prefill-side block references."""
        ids = self._held.pop(request_id, None)
        if ids:
            self.block_manager.release(ids)

    def register_commit_hook(self, request_id: str,
                             fn: Callable[[list[int], bool], None]) -> None:
        """Streamed handoff (llm/kv/stream.py): call ``fn(block_ids, done)``
        on the engine thread after each prefill chunk commits —
        ``block_ids`` is the CUMULATIVE list of this request's committed
        block ids, ``done=True`` on the final call (which includes the
        partial tail block).  The hook unregisters itself after that call."""
        self._commit_hooks[request_id] = fn

    def unregister_commit_hook(self, request_id: str) -> None:
        self._commit_hooks.pop(request_id, None)

    def _fire_commit_hook(self, req: EngineRequest, done: bool) -> None:
        fn = self._commit_hooks.get(req.request_id)
        if fn is None:
            return
        bs = self.config.block_size
        n = len(req.block_ids) if done else req.committed_upto // bs
        try:
            fn([int(b) for b in req.block_ids[:n]], done)
        except Exception:  # a producer's fault must not fail the engine step
            log.exception("commit hook failed for %s", req.request_id)
        if done:
            self._commit_hooks.pop(req.request_id, None)

    # ------------------------------------------------------------- KV tiers
    def _init_tiers(self, model, config: EngineConfig, cache_dtype) -> None:
        """The host-RAM offload tier and, below it, the persistent tier."""
        self.host_pool = None
        self.persist_store = None
        self._offload_thread = None
        # (device bid, seq_hash) of evicted blocks not yet snapshotted
        self._pending_offload: list[tuple[int, int]] = []
        self._persist_events: "collections.deque" = collections.deque()
        # copy timings the tier's own readings are made from (not metrics():
        # the JAX engine has no such keys): offload is timed on the
        # kv-offload thread, restore and persist load on the engine thread
        self.tier_stats = dict(offload_blocks=0, offload_bytes=0, offload_copy_s=0.0,
                               offload_store_s=0.0, restore_blocks=0, restore_bytes=0,
                               restore_copy_s=0.0, restore_wall_s=0.0, spill_bytes=0,
                               spill_s=0.0, load_bytes=0, load_s=0.0)
        if config.num_host_blocks > 0:
            if not config.enable_prefix_reuse:
                log.warning("num_host_blocks=%d ignored: host offload needs "
                            "enable_prefix_reuse=True (blocks are keyed by prefix hash)",
                            config.num_host_blocks)
            else:
                self.host_pool = HostKvPool(config.num_host_blocks,
                                            pin_memory=self.device.type == "cuda")
                pending = self._pending_offload  # the sink holds the list, not the engine
                self.block_manager.offload_sink = (
                    lambda bid, seq_hash, parent: pending.append((bid, seq_hash)))
                # async store: the engine thread only dispatches the on-card
                # gather (ordered before any overwrite of the evicted ids);
                # the device→host copy and the host store run on this
                # thread, so a request never pays another conversation's
                # offload in its own TTFT.  Each queued batch pins its
                # snapshot on the card until its copy completes, so the
                # queue is bounded by total queued BLOCKS (config budget):
                # past it a batch is stored synchronously (backpressure).
                self._offload_lock = threading.Lock()
                self._offload_closed = False
                self._offload_inflight_blocks = 0
                self._offload_q: queue.Queue = queue.Queue(maxsize=4)
                # the copy stream (a side stream that waits on the gather's
                # event) and the reused pinned staging rows it copies into
                self._offload_stream = (torch.cuda.Stream(device=self.device)
                                        if self.device.type == "cuda" else None)
                self._stage: Optional[list[torch.Tensor]] = None
                self._stage_lock = threading.Lock()
                self._offload_thread = threading.Thread(
                    target=self._offload_worker, name="kv-offload", daemon=True)
                self._offload_thread.start()
        if config.kv_persist_dir:
            if self.host_pool is None:
                log.warning("kv_persist_dir=%s ignored: the persistent tier stages through "
                            "the host pool (set num_host_blocks > 0 and keep "
                            "enable_prefix_reuse on)", config.kv_persist_dir)
            else:
                from dynamo_tpu_torch.llm.kv.persist import PersistentKvStore

                self.persist_store = PersistentKvStore(
                    config.kv_persist_dir,
                    generation=self._persist_generation(model, cache_dtype),
                    max_bytes=config.kv_persist_max_bytes,
                    ttl_s=config.kv_persist_ttl_s,
                )
                resident = self.persist_store.resident_hashes()
                if resident:
                    # announce what a restart found on disk, so the router
                    # index learns this worker's persist tier once a
                    # publisher attaches (events drain on the engine thread)
                    self._persist_events.append(
                        KvStoredEvent(block_hashes=resident, tier=TIER_PERSIST))

    @staticmethod
    def _persist_generation(model, cache_dtype) -> str:
        """Generation tag for the persistent KV tier: a stable hash of
        everything that determines block-file layout and validity — model
        architecture/dtype, cache dtype, block size.  Any change opens a
        fresh store generation and invalidates the old one.  The JAX
        engine's tag for the same config and cache dtype, so both packages
        share a directory."""
        import hashlib
        import json as _json

        mc = getattr(model, "config", None)
        if mc is not None and hasattr(mc, "__dict__"):
            ident = {k: repr(v) for k, v in sorted(vars(mc).items())}
        else:
            ident = {"model": repr(mc)}
        ident["__cache_dtype"] = str(cache_dtype)
        ident["__model_cls"] = type(model).__name__
        blob = _json.dumps(ident, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def _flush_persist_events(self) -> None:
        """Forward queued persist-tier router events (engine thread only; the
        kv-offload thread enqueues, this drains into the publisher's sink)."""
        if self.persist_store is None:
            return
        sink = self.block_manager.event_sink
        while self._persist_events:
            ev = self._persist_events.popleft()
            if sink is not None:
                sink(ev)

    def _spill_to_persist(self, hashes: list[int], blocks) -> None:
        """Mirror a host-pool store batch into the persistent tier (on the
        kv-offload thread — fsync never blocks the engine loop)."""
        t0 = time.perf_counter()
        try:
            wrote = self.persist_store.spill(hashes, blocks)
        except Exception:  # disk full etc.: the tier degrades, serving goes on
            log.exception("persist spill failed; tier continues without it")
            return
        self.tier_stats["spill_bytes"] += wrote
        self.tier_stats["spill_s"] += time.perf_counter() - t0
        if wrote:
            self._persist_events.append(KvStoredEvent(block_hashes=list(hashes),
                                                      tier=TIER_PERSIST))
        removed = self.persist_store.drain_removed()
        if removed:
            self._persist_events.append(KvRemovedEvent(block_hashes=removed, tier=TIER_PERSIST))

    def _promote_from_persist(self, hashes: list[int]) -> int:
        """Load a persist-tier prefix host-side so the ordinary host-pool
        restore picks it up; returns how many blocks were promoted."""
        t0 = time.perf_counter()
        try:
            phit = self.persist_store.match_prefix(hashes)
            if not phit:
                return 0
            blocks = self.persist_store.load(phit)
        except KeyError:
            return 0  # raced an eviction / corrupt file — plain miss
        except Exception:  # keep admission alive
            log.exception("persist restore failed; treating as miss")
            return 0
        self.tier_stats["load_bytes"] += sum(p.numel() * p.element_size()
                                             for p in flatten_blocks(blocks)[1])
        self.tier_stats["load_s"] += time.perf_counter() - t0
        with self._offload_lock:
            self.host_pool.store(phit, blocks)
        return len(phit)

    def _drain_offload(self) -> None:
        """Offload just-evicted device blocks to the host pool.

        The on-card gather MUST be enqueued before anything overwrites the
        evicted block ids: it runs on the engine thread's stream, which
        orders it before every later write into them.  The device→host
        copy and the host store run on the kv-offload thread."""
        if self.host_pool is None:
            return
        self._flush_persist_events()
        if not self._pending_offload:
            return
        pending = list(self._pending_offload)
        self._pending_offload.clear()
        with self._offload_lock:
            # re-evictions of host-resident content only need an LRU
            # refresh — skip the gather for them
            self.host_pool.touch([h for _, h in pending if h in self.host_pool])
            fresh = [(b, h) for b, h in pending if h not in self.host_pool]
        if not fresh:
            return
        bids = [b for b, _ in fresh]
        hashes = [h for _, h in fresh]
        snap = self._snapshot(bids)  # on-card, block-major
        ready = None
        if self._offload_stream is not None:
            ready = torch.cuda.Event()
            ready.record()  # on this thread's stream, after the gather
        queued = False
        with self._offload_lock:
            # flag check + enqueue are atomic with close()'s flag set, so a
            # batch can never land behind the shutdown sentinel
            budget = self.config.offload_inflight_blocks
            if not self._offload_closed and (
                self._offload_inflight_blocks + len(bids) <= budget
                # never starve: an oversized single batch may queue alone
                or self._offload_inflight_blocks == 0
            ):
                try:
                    self._offload_q.put_nowait((hashes, snap, ready))
                    self._offload_inflight_blocks += len(bids)
                    queued = True
                except queue.Full:
                    pass  # backpressure: queued snapshots pin device memory
        if not queued:
            # closed, full, or over the block budget — store synchronously so
            # no batch is lost and no further device memory is pinned
            self._store_offload_batch(hashes, snap, ready)

    def _snapshot(self, block_ids: list[int]):
        """The blocks gathered block-major, ``[n, L, 2, Bs, HkD]`` per part
        (one gather kernel a part, through the cache's ``[N, L, ...]``
        view), so the copy to the host is one contiguous memcpy a part.

        On a mesh these are the whole blocks one card would hold: every
        rank's kv heads gathered onto rank 0 (a ``("gather", ids)``
        follower operation, broadcast before any later write into the
        ids), so the host pool and the persist files hold the same blocks
        at every layout."""
        if self.mesh is not None:
            structure, parts = flatten_blocks(self.gather_blocks_device(block_ids))
            return unflatten_blocks(structure, [p.movedim(1, 0).contiguous() for p in parts])
        ids = torch.as_tensor(block_ids, dtype=torch.long, device=self.device)
        structure, parts = flatten_blocks(self.cache)
        return unflatten_blocks(structure, [p.movedim(1, 0).index_select(0, ids) for p in parts])

    def _staging(self, parts: list[torch.Tensor], n: int) -> list[torch.Tensor]:
        """``n`` reused pinned rows per part (hold ``_stage_lock``)."""
        specs = [(tuple(p.shape[1:]), p.dtype) for p in parts]
        if (self._stage is None or self._stage[0].shape[0] < n
                or [(tuple(t.shape[1:]), t.dtype) for t in self._stage] != specs):
            rows = 1 << max(4, (n - 1).bit_length())
            self._stage = [torch.empty((rows,) + shape, dtype=dt, pin_memory=True)
                           for shape, dt in specs]
        return [t[:n] for t in self._stage]

    def _store_offload_batch(self, hashes: list[int], snap, ready) -> None:
        """Copy a block-major snapshot to the host and store it (on the
        kv-offload thread, or inline under backpressure / close).

        On the card the copy runs on the offload stream, after ``ready``
        (recorded after the gather), into pinned staging rows, and this
        thread waits for it; the snapshot is referenced until then.  Then
        the three-phase store: reserve (lock), write (NO lock — the host
        memcpy must not stall the engine thread's drain/restore), publish
        (lock)."""
        t0 = time.perf_counter()
        structure, parts = flatten_blocks(snap)
        n = len(hashes)
        with self._stage_lock:
            if self._offload_stream is None:
                host = parts  # already on the host
                copy_s = 0.0
            else:
                host = self._staging(parts, n)
                s = self._offload_stream
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                with torch.cuda.stream(s):
                    s.wait_event(ready)
                    start.record(s)
                    for h, p in zip(host, parts):
                        p.record_stream(s)
                        h.copy_(p, non_blocking=True)
                    end.record(s)
                end.synchronize()
                copy_s = start.elapsed_time(end) / 1e3
            del snap, parts  # the copy has completed: the snapshot may go
            blocks = unflatten_blocks(structure, host)
            st = self.tier_stats
            st["offload_blocks"] += n
            st["offload_bytes"] += sum(h.numel() * h.element_size() for h in host)
            st["offload_copy_s"] += copy_s
            with self._offload_lock:
                hids, rows = self.host_pool.reserve(hashes, blocks)
            if hids:
                try:
                    self.host_pool.write_rows(hids, blocks, rows)
                except BaseException:
                    with self._offload_lock:
                        self.host_pool.abort(hids)  # don't leak reserved capacity
                    raise
                with self._offload_lock:
                    self.host_pool.publish(hids, [hashes[r] for r in rows])
                if self.persist_store is not None:
                    # write-through: published content spills to disk here,
                    # so a restart (or a replica pulling the coordinator
                    # index) can restore it
                    self._spill_to_persist(hashes, blocks)
            st["offload_store_s"] += time.perf_counter() - t0

    def _offload_worker(self) -> None:
        if self._offload_stream is not None:
            torch.cuda.set_device(self.device)
        while True:
            item = self._offload_q.get()
            try:
                if item is None:
                    return
                self._store_offload_batch(*item)
            except Exception:  # keep the tier alive
                log.exception("async KV offload store failed")
            finally:
                if item is not None:
                    # the snapshot is released whether or not the store
                    # succeeded — retire its blocks from the budget even on
                    # failure, else every later store degrades to sync
                    with self._offload_lock:
                        self._offload_inflight_blocks -= len(item[0])
                    item = None
                self._offload_q.task_done()

    def flush_host_offload(self) -> None:
        """Block until every queued offload store has landed (tests and
        benches that assert on host-pool contents).  Engine thread only."""
        if self.host_pool is None:
            return
        self._drain_offload()
        self._offload_q.join()

    def close(self) -> None:
        """Stop the kv-offload thread (idempotent).  Without this an
        abandoned engine's daemon thread would pin the whole instance —
        model, cache, host pool — for the process's lifetime."""
        # a profile window still open (fewer dispatches than profile_steps)
        # is closed and written
        self._maybe_profile_stop(force=True)
        t = getattr(self, "_offload_thread", None)
        if t is not None and t.is_alive():
            # flag first (under the lock _drain_offload enqueues under):
            # after this, drains store inline — nothing can land behind the
            # sentinel.  The sentinel put happens OUTSIDE the lock: it may
            # block on a full queue until the worker drains, and the worker
            # needs the lock for its store phases.
            with self._offload_lock:
                self._offload_closed = True
            self._offload_q.put(None)
            t.join(timeout=30.0)
        self._offload_thread = None
        if getattr(self, "persist_store", None) is not None:
            self.persist_store.close()
        if self.mesh is not None and not getattr(self, "_closed", False):
            self._closed = True
            try:
                self._send("close")  # the followers drop their caches
            except RuntimeError as e:  # a broken world: nobody is left to tell
                log.warning("could not tell the shard followers to close: %s", e)

    def _restore_from_host(self, req: EngineRequest) -> None:
        """Upload host-resident prefix blocks into the request's fresh device
        blocks, register them, and extend the cached prefix — a device
        cache miss turned into a host hit.  Host-pool misses fall through
        to the persistent tier: matched blocks are promoted host-side
        first, then ride the same upload/scatter/commit path."""
        bs = self.config.block_size
        dev = req.cached_tokens // bs
        max_blocks = (req.prompt_len - 1) // bs  # >=1 token must remain
        want = [b.sequence_hash for b in req.seq.blocks[dev:max_blocks]]
        if not want:
            return
        with self._offload_lock:
            host_hit = len(self.host_pool.match_prefix(want))
        promoted = 0
        if self.persist_store is not None and host_hit < len(want):
            promoted = self._promote_from_persist(want[host_hit:])
            if not promoted:
                persist_counters.record_miss()
        t0 = time.perf_counter()
        with self._offload_lock:
            # the kv-offload thread stores/evicts concurrently; a block still
            # in flight to the pool just misses here (re-prefilled).  match
            # and upload under ONE lock hold: a matched row must not be
            # evicted and rewritten before the upload has read it.
            hit = self.host_pool.match_prefix(want)
            if not hit:
                return
            # on a mesh the whole blocks travel to the followers from the
            # host (scatter_external): no upload to rank 0's card first
            if self.device.type == "cuda" and self.mesh is None:
                out = [torch.empty((len(hit),) + shape, dtype=dt, device=self.device)
                       for shape, dt in self.host_pool.part_specs()]
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                blocks = self.host_pool.gather(hit, out=out)  # async, from pinned rows
                end.record()
                end.synchronize()  # the rows are read before the lock is released
                self.tier_stats["restore_copy_s"] += start.elapsed_time(end) / 1e3
            else:
                blocks = self.host_pool.gather(hit)  # [n, L, 2, Bs, HkD] per part
        structure, parts = flatten_blocks(blocks)
        st = self.tier_stats
        st["restore_blocks"] += len(hit)
        st["restore_bytes"] += sum(p.numel() * p.element_size() for p in parts)
        st["restore_wall_s"] += time.perf_counter() - t0
        if promoted:
            restored = max(0, len(hit) - host_hit)
            if restored:
                persist_counters.record_restore(restored, restored * bs)
        target = req.block_ids[dev:dev + len(hit)]
        self.scatter_external(target, unflatten_blocks(
            structure, [p.movedim(0, 1) for p in parts]))
        for i in range(len(hit)):
            blk = req.seq.blocks[dev + i]
            self.block_manager.commit(target[i], blk.sequence_hash, blk.parent_sequence_hash,
                                      list(blk.tokens))
        req.cached_tokens += len(hit) * bs

    def gather_blocks_device(self, block_ids: list[int]):
        """Gather blocks WITHOUT leaving the device: ``[L, n, 2, Bs, HkD]``
        (a QuantKvCache of both parts for the int8 cache).  The colocated
        handoff hands this straight to the decode engine's scatter, an
        on-card copy.  Both engines' threads launch on the device's current
        stream, so the stream orders this gather before that scatter and
        before any later write into these blocks.  On a mesh the blocks of
        every rank's kv heads are gathered onto rank 0 (a collective)."""
        if self.mesh is not None:
            self._send("gather", list(block_ids))
            return gather_shard_blocks(self.model, self.cache, block_ids)
        return gather_blocks_padded(self.cache, block_ids)

    def gather_blocks_np(self, block_ids: list[int]):
        """Stage blocks to host memory for the wire: ``[L, n, 2, Bs, HkD]``
        CPU tensors (a (data, scale) pair for the int8 cache), one batched
        device-to-host copy per part into pinned memory on the card."""
        out = self.gather_blocks_device(block_ids)
        parts = tuple(out) if isinstance(out, QuantKvCache) else (out,)
        if self.device.type == "cuda":
            host = []
            for part in parts:
                buf = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
                buf.copy_(part)  # synchronous: the bytes are on the host on return
                host.append(buf)
            parts = tuple(host)
        return parts if len(parts) > 1 else parts[0]

    def scatter_external(self, block_ids: list[int], blocks,
                         request_id: Optional[str] = None) -> None:
        """Write transferred blocks into this engine's cache, in place.
        ``blocks`` mirrors the cache: one tensor or numpy array, or the int8
        cache's (data, scale) pair, on the host or on the card.

        When ``request_id`` is given (remote-prefill ingest), the write is
        validated against that request's live block ownership: if the
        request was aborted meanwhile its blocks may already belong to
        someone else, and a late write is dropped, not applied."""
        if request_id is not None:
            req = self._by_id.get(request_id)
            if (req is None or req.state is not RequestState.REMOTE_PREFILL
                    or not set(block_ids) <= set(req.block_ids)):
                log.warning("dropping stale KV write for %s (request gone or blocks reassigned)",
                            request_id)
                return
        parts = tuple(blocks) if isinstance(blocks, (tuple, list)) else (blocks,)
        if self.mesh is not None:
            # every rank keeps its own kv heads of the whole blocks: they
            # travel to the followers from the host
            parts = tuple(torch.from_numpy(np.ascontiguousarray(b)) if isinstance(b, np.ndarray)
                          else b.cpu() for b in parts)
            self._send("scatter", list(block_ids), parts)
            parts = shard_blocks(self.model, parts)
        # one upload per part (a no-op for blocks already on the card)
        parts = tuple((torch.from_numpy(np.ascontiguousarray(b)) if isinstance(b, np.ndarray)
                       else b).to(self.device) for b in parts)
        if self.cache_quant:
            if len(parts) != 2:
                raise ValueError("an int8 cache takes (data, scale) blocks")
            parts = QuantKvCache(*parts)
        elif len(parts) != 1:
            raise ValueError(f"a {self.cache.dtype} cache takes one block tensor, "
                             f"not {len(parts)} parts")
        else:
            parts = parts[0]
        scatter_blocks_inplace(self.cache, block_ids, parts)

    def complete_remote_prefill(self, request_id: str, first_token: int,
                                error: Optional[str] = None) -> None:
        """Prefill-done notification: the request's KV is now resident in
        this engine's cache; commit its blocks, append the prefill-sampled
        first token and enter decode."""
        req = self._by_id.get(request_id)
        if req is None or req.state is not RequestState.REMOTE_PREFILL:
            return  # cancelled/finished while prefill ran elsewhere
        if error is not None:
            self._finish_slot(req, FinishReason.ERROR)
            return
        req.computed_tokens = req.prompt_len
        req.state = RequestState.RUNNING
        for blk in req.seq.blocks:
            bid = req.block_ids[blk.position]
            self.block_manager.commit(bid, blk.sequence_hash, blk.parent_sequence_hash,
                                      list(blk.tokens))
        self._append_token(req, int(first_token), first=True)

    def prefix_hit_tokens(self, seq_hashes: list[int], prompt_len: int) -> int:
        """How many prompt tokens would hit the local prefix cache — the
        disagg router's prefix_hit_length input.  Read-only dict probes,
        safe from any thread; a concurrently-mutating engine can make the
        answer slightly stale, which only perturbs the routing heuristic."""
        return len(self.block_manager.match_prefix(seq_hashes, prompt_len)) * \
            self.config.block_size

    def persist_hit_blocks(self, seq_hashes: list[int]) -> int:
        """How many prompt blocks the persist tier could restore locally —
        the transfer-aware router's stream-vs-restore cost input.  0 when
        no persist tier is configured.  Same staleness caveat as
        :meth:`prefix_hit_tokens`: a heuristic input, not a guarantee."""
        if self.persist_store is None or not seq_hashes:
            return 0
        try:
            return len(self.persist_store.match_prefix(list(seq_hashes)))
        except Exception:  # a probe must never raise
            return 0

    def kv_bytes_per_block(self) -> int:
        """Wire bytes one KV block occupies (all layers, K and V, both parts
        of the int8 cache, every kv head) — the router's transfer-cost size
        input.  Read off the config, not this rank's cache, which holds only
        its own kv heads on a mesh."""
        cfg = self.model.config
        hk, bs = cfg.num_kv_heads, self.config.block_size
        row = cfg.num_layers * 2 * bs * hk * cfg.head_dim
        if not self.cache_quant:
            return row * self.cache.element_size()
        hp, sp = scale_tile(hk, bs)
        return row + cfg.num_layers * 2 * hp * sp * 4  # int8 payload + f32 scale tile
