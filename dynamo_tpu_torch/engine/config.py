"""Engine configuration: batching, cache sizing, bucketing, sharding.

The same dataclass as ``dynamo_tpu.engine.config``, so one configuration
drives either engine.  The PyTorch core serves every option of it, with
the model's cache dtype, an int8 KV cache (``cache_dtype="int8"``,
``ops/kv_quant.py``) or another float cache dtype (on the CPU: no kernel
takes one on the card, where the model itself is bfloat16 or float16
and a mixture of experts bfloat16), on one card or on the rank mesh its
model was built on (``mesh_shape`` is that mesh's (dp, tp), or (1, 1) for "whatever
the model's is"; ``sp_prefill_threshold`` needs a "data" axis above 1, as
in the JAX package), and refuses at construction what it cannot serve
(``EngineCore._check_supported``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


def default_buckets(max_len: int) -> list[int]:
    """Powers of two up to max_len (prefill padding buckets)."""
    out = []
    b = 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


@dataclass
class EngineConfig:
    # batching
    max_batch_size: int = 8           # decode slots (static shape)
    max_model_len: int = 2048
    # decode tokens generated per device dispatch (multi-step scheduling);
    # >1 amortises dispatch overhead at the cost of stop-condition
    # granularity (up to decode_steps-1 discarded samples per request)
    decode_steps: int = 1
    # chunked prefill: max prompt tokens computed per prefill dispatch
    # (0 = whole remainder in one step).  Bounding the chunk keeps decode
    # ITL flat while long prompts prefill — the scheduler alternates one
    # prefill chunk with one decode burst when both have work (the
    # reference gets this from vLLM's chunked-prefill scheduler; ours is
    # native).  Rounded down to a block multiple so resumed chunks stay
    # block-aligned for the prefill fast path.
    prefill_chunk_tokens: int = 0
    # token-budget ragged prefill: pack the prefill chunks of SEVERAL
    # pending requests into one flat-token-axis dispatch of at most this
    # many tokens (each request's chunk occupies a block-aligned span; the
    # flat axis is bucketed via bucket_for so executables stay O(log)).
    # Converts a backlog of N short prompts from N device round-trips to
    # ~ceil(total_tokens / budget) dispatches.  0 = legacy one-request-
    # per-dispatch prefill.  Rounded down to a block multiple; capped at
    # max_model_len (the largest prefill bucket).
    prefill_token_budget: int = 0
    # unified mixed prefill+decode dispatch: when BOTH phases have work,
    # run ONE token-budget ragged step per turn — decode rows (1 token
    # each) lead the flat axis, waiting prefill chunks pack into the
    # remaining prefill_token_budget.  Replaces the chunked-prefill
    # alternation (one device round-trip per phase switch) with a single
    # dispatch per turn; decode-only turns keep the multi-step burst and
    # prefill-only turns the ragged batch.  Requires a model with the
    # ragged forward path; prefill_token_budget defaults on when unset.
    # Default off until parity-gated (tests/test_unified_dispatch.py
    # pins seeded-stream parity vs the legacy paths).
    unified_token_dispatch: bool = False
    # double-buffered dispatch (lookahead scheduler): overlap next-turn
    # host scheduling with device compute.  Mixed prefill+decode turns
    # fuse interactive_decode_steps unified turns into ONE dispatch with
    # on-device stop/append (a burst needs a single trailing device_get),
    # and while the device computes, the host speculatively prebuilds
    # the NEXT turn's dispatch operands from predicted token counts
    # (every active decode row yields exactly 1 token/turn unless a stop
    # fires) — committed if the prediction held, flushed on mismatch.
    # Implies unified_token_dispatch.  Default off until parity-gated
    # (tests/test_lookahead_dispatch.py pins seeded-stream parity).
    lookahead_dispatch: bool = False
    # decode burst length while prefill work is pending (admitted/waiting
    # requests or a mid-prefill slot).  Long bursts amortise dispatch
    # overhead but make a freshly-arrived prompt wait a whole burst
    # (decode_steps * ITL ≈ 760ms at 64 steps) before its first chunk —
    # the dominant term in VERDICT r2's TTFT miss.  0 = min(8, decode_steps).
    interactive_decode_steps: int = 0
    # speculative decoding (engine/spec.py, engine/draft.py): propose up to
    # spec_tokens continuation tokens by n-gram match against the sequence
    # itself (or from a draft model) and verify them in ONE dispatch.
    # Rejection-sampled, so exact at any temperature; engages only for
    # dispatches where no active request uses penalties, logprobs,
    # logit_bias, a grammar or top_k > K_MAX.  0 = off.
    spec_tokens: int = 0
    spec_ngram: int = 3
    # draft-model speculation (engine/draft.py): block count of the
    # draft's own paged cache.  0 = same count as the target's — shrink
    # it on HBM-tight deployments (the draft cache costs
    # L_draft/L_target of the target cache at equal counts).
    draft_num_blocks: int = 0
    # sequence-parallel (ring attention) prefill: prompts at least this
    # long (with no cached prefix) prefill in ONE dispatch with the
    # sequence sharded over the mesh's "data" axis — context parallelism
    # for prompts beyond a single chip's comfort.  0 = disabled; requires
    # an engine mesh whose "data" axis is > 1.
    sp_prefill_threshold: int = 0
    # paged cache
    block_size: int = 16
    num_blocks: int = 512             # cache blocks in HBM
    num_host_blocks: int = 0          # host-RAM offload tier (0 = disabled)
    # async-offload HBM backpressure: total device blocks that may sit in
    # queued gather snapshots awaiting the device→host readback.  A batch
    # that would push the outstanding count past this budget stores
    # synchronously instead (each queued snapshot pins its blocks' HBM —
    # a burst of large evictions must not pin hundreds of MB)
    offload_inflight_blocks: int = 256
    # persistent prefix-cache tier (llm/kv/persist.py): directory for the
    # content-addressed block store.  None/"" = disabled (the default).
    # Requires num_host_blocks > 0 — spill and restore both stage through
    # the host pool.  Blocks published to the host pool spill here
    # asynchronously; host-pool misses on admission fall through to this
    # tier, so a restart (same dir) or a replicated index re-enters warm
    # prefixes as cached_tokens.
    kv_persist_dir: Optional[str] = None
    # size cap for the persistent store (LRU by last-touch at block-group
    # file granularity); 0 = unbounded
    kv_persist_max_bytes: int = 0
    # TTL for persisted block groups since last touch; 0 = no expiry
    kv_persist_ttl_s: float = 0.0
    # KV cache dtype: None = model dtype; "int8" = quantized cache with
    # per-token-per-head scales (ops/kv_quant.py) — half the KV HBM
    # footprint and decode-step KV traffic; another float dtype is cast to
    # on the write and from on the read (the plain ops; refused on the card)
    cache_dtype: Optional[str] = None
    enable_prefix_reuse: bool = True
    # force exact top-k candidate selection in the sampler (the PyTorch
    # sampler's torch.topk is always exact, so this changes nothing there)
    exact_sampling: bool = False
    # prefill
    prefill_buckets: list[int] = field(default_factory=list)
    # sharding: data/model axis sizes; 1,1 = single chip
    mesh_shape: tuple[int, int] = (1, 1)
    # profile hook: when profile_dir is set, the engine wraps the first
    # profile_steps device steps in one profiler capture written under
    # profile_dir/steps-<first step id>/
    profile_dir: Optional[str] = None
    profile_steps: int = 8
    # rng
    seed: int = 0

    def __post_init__(self):
        if not self.prefill_buckets:
            self.prefill_buckets = default_buckets(self.max_model_len)
        self.prefill_buckets = sorted(self.prefill_buckets)
        if self.interactive_decode_steps <= 0:
            self.interactive_decode_steps = min(8, max(1, self.decode_steps))
        self.interactive_decode_steps = min(
            self.interactive_decode_steps, max(1, self.decode_steps)
        )
        if self.prefill_chunk_tokens:
            # block-align the chunk so every resumed chunk starts on a block
            # boundary (required by the prefill fast path)
            self.prefill_chunk_tokens = max(
                self.block_size,
                self.prefill_chunk_tokens // self.block_size * self.block_size,
            )
        if self.lookahead_dispatch and not self.unified_token_dispatch:
            # the lookahead scheduler is a layer over unified dispatch:
            # the fused burst generalizes the unified mixed step, so the
            # flag implies it (and inherits its budget defaulting below)
            self.unified_token_dispatch = True
        if self.unified_token_dispatch and not self.prefill_token_budget:
            # the unified scheduler packs under prefill_token_budget; a
            # bare --unified-token-dispatch gets a sensible default
            # rather than silently staying on the legacy paths
            self.prefill_token_budget = min(1024, self.max_model_len)
        if self.prefill_token_budget:
            # block-align (spans in the packed axis are block multiples)
            # and cap at the largest prefill bucket — bucket_for pads the
            # flat axis, so a budget past max_model_len could never fill
            self.prefill_token_budget = max(
                self.block_size,
                self.prefill_token_budget // self.block_size * self.block_size,
            )
            self.prefill_token_budget = min(
                self.prefill_token_budget, self.max_model_len
            )

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_model_len // self.block_size)

    def bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"sequence length {n} exceeds max_model_len {self.max_model_len}")
