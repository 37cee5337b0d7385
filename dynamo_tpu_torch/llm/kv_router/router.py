"""KvRouter — the composed smart router.

The counterpart of ``dynamo_tpu/llm/kv_router/router.py``.
Given a tokenized request, hash its blocks, look up prefix overlap per
worker in the indexer, and let the scheduler pick a worker.  Exposed both
as a plain `schedule()` call and as an AsyncEngine that emits the decision
(reference kv_router.rs:66-169 wraps it the same way so it can serve a
`generate` endpoint; components/router/src/main.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import AsyncIterator, Optional, Sequence

from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler, WorkerSelector
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.tokens import sequence_hashes

__all__ = ["KvRouter", "RoutingDecision"]


@dataclass
class RoutingDecision:
    worker_id: int
    overlap_blocks: int     # prefix blocks already on that worker (device)
    overlap_tokens: int
    persist_blocks: int = 0  # prefix blocks restorable from its persist tier


class KvRouter(AsyncEngine):
    def __init__(
        self,
        block_size: int = 16,
        selector: Optional[WorkerSelector] = None,
        indexer: Optional[KvIndexer] = None,
        scheduler: Optional[KvScheduler] = None,
    ):
        self.block_size = block_size
        self.indexer = indexer or KvIndexer()
        self.scheduler = scheduler or KvScheduler(selector, block_size=block_size)

    def schedule(self, token_ids: Sequence[int]) -> RoutingDecision:
        hashes = sequence_hashes(token_ids, self.block_size)
        match = self.indexer.find_matches(hashes)
        overlaps = match.scores
        wid = self.scheduler.schedule(overlaps, len(token_ids),
                                      persist_overlaps=match.persist_scores)
        blocks = overlaps.get(wid, 0)
        return RoutingDecision(
            worker_id=wid, overlap_blocks=blocks,
            overlap_tokens=blocks * self.block_size,
            persist_blocks=match.persist_scores.get(wid, 0),
        )

    def remove_worker(self, worker_id: int) -> None:
        self.indexer.remove_worker(worker_id)
        self.scheduler.remove_worker(worker_id)

    # AsyncEngine surface (what a router service serves as its generate
    # endpoint): payload = token id list, a BackendInput,
    # or a {token_ids} dict → ONE wire-serializable decision dict.
    # {"worker_id": None} = no live workers; caller falls back to its own
    # load balancing.  In-process callers wanting the dataclass use
    # schedule() directly.
    def generate(self, request: Context) -> AsyncIterator[dict]:
        return self._run(request)

    async def _run(self, request: Context) -> AsyncIterator[dict]:
        from dynamo_tpu_torch.llm.kv_router.scheduler import AllWorkersBusy

        token_ids = request.data
        if hasattr(token_ids, "token_ids"):  # BackendInput passthrough
            token_ids = token_ids.token_ids
        elif isinstance(token_ids, dict):
            token_ids = token_ids["token_ids"]
        try:
            d = self.schedule(token_ids)
        except AllWorkersBusy:
            yield {"worker_id": None}
            return
        yield {
            "worker_id": d.worker_id,
            "overlap_blocks": d.overlap_blocks,
            "overlap_tokens": d.overlap_tokens,
        }
