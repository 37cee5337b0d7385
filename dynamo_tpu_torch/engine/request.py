"""Per-request engine state machine."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.engine.grammar import INIT_STATE
from dynamo_tpu_torch.llm.protocols import (
    FinishReason,
    LLMEngineOutput,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.tokens import TokenBlockSequence

__all__ = ["RequestState", "EngineRequest", "INIT_STATE"]


class RequestState(enum.Enum):
    WAITING = "waiting"    # queued, no slot yet
    PREFILL = "prefill"    # slot assigned, prompt not fully computed
    REMOTE_PREFILL = "remote_prefill"  # slot+blocks assigned; KV arrives from a prefill worker
    RUNNING = "running"    # decoding
    FINISHED = "finished"


@dataclass
class EngineRequest:
    request_id: str
    prompt: list[int]
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stops: StopConditions = field(default_factory=StopConditions)
    # called from the engine thread with each LLMEngineOutput delta
    emit: Callable[[LLMEngineOutput], None] = lambda out: None

    # --- disaggregation flags (the JAX package's, after the vllm patch's
    # RemotePrefillParams.is_remote_prefill / is_remote_decode) ---
    # decode side: blocks are allocated up front and the request stalls in
    # REMOTE_PREFILL until a prefill worker writes KV and notifies
    remote_prefill: bool = False
    # prefill side: stop after the prefill step + first sampled token, keep
    # blocks held (not released) until the worker has transferred them out
    remote_decode: bool = False
    # called on the engine thread right after blocks are allocated (decode
    # side uses this to learn the block ids to hand to the prefill worker)
    on_allocated: Optional[Callable[["EngineRequest"], None]] = None

    state: RequestState = RequestState.WAITING
    seq: Optional[TokenBlockSequence] = None  # prompt + generated tokens
    block_ids: list[int] = field(default_factory=list)
    cached_tokens: int = 0     # prefix-cache hit (KV already resident)
    computed_tokens: int = 0   # prompt tokens whose KV is computed
    # prompt tokens whose blocks were already offered to block_manager
    # .commit — the chunked-prefill watermark (each chunk commits only the
    # blocks it completed)
    committed_upto: int = 0
    # prompt tokens [computed_tokens, wait_upto) live in blocks another
    # request is prefilling right now (joined via the reserved-block
    # registry): this request absorbs them as the owner commits instead of
    # recomputing, and takes over if the owner aborts
    wait_upto: int = 0
    # (seq_hash, block_id) reservations THIS request owns; unresolved ones
    # are dropped on finish so joiners can take over
    reserved_pairs: list = field(default_factory=list)
    generated: int = 0
    # grammar automaton state (dfa_state, depth, bit-stack)
    gstate: tuple = (INIT_STATE, 0, 0)
    slot: int = -1
    finish_reason: Optional[FinishReason] = None
    abort_requested: bool = False
    # queue-wait measurement: submit() stamps submitted_at
    # (perf_counter); _admit computes queue_wait_s at slot assignment
    submitted_at: float = 0.0
    queue_wait_s: Optional[float] = None
    # tracing context (trace_id, span_id) of the request's engine.generate
    # span (obs/tracing.py), or None when tracing is off
    trace: Optional[tuple] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_tokens(self) -> int:
        return self.seq.total_tokens if self.seq else self.prompt_len
