"""KV block manager: pool, prefix reuse, refcounts, LRU eviction, events.

  * blocks preserve their contents when released — an unreferenced full
    block stays matchable by its sequence hash until evicted (LRU),
  * concurrent requests sharing a prefix dedupe onto the same blocks via
    refcounts, and a request whose prefix another request is still
    prefilling joins that request's reserved blocks instead of computing
    duplicates,
  * every registration/eviction emits a stored/removed event.

The manager is pure bookkeeping (no device memory) — the engine owns the
cache tensor; block ids here index its block axis.  Single-threaded by
design (called only from the engine loop).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Optional

from dynamo_tpu_torch.llm.kv.events import KvCacheEvent, KvRemovedEvent, KvStoredEvent

__all__ = ["KvBlockManager", "BlockAllocation", "NoFreeBlocks"]


class NoFreeBlocks(Exception):
    """Pool exhausted (caller should finish/preempt a request)."""


@dataclass
class BlockAllocation:
    """Result of allocating blocks for a prompt."""

    block_ids: list[int]
    cached_tokens: int  # prefix tokens whose KV is already resident
    # tokens covered by ANOTHER request's in-flight (reserved, uncommitted)
    # prefill blocks right after the cached prefix: this request references
    # those blocks but waits for the owner's commit instead of recomputing
    joined_tokens: int = 0


@dataclass
class _Block:
    ref_count: int = 0
    seq_hash: Optional[int] = None
    parent_hash: Optional[int] = None
    # content fully written (commit() ran since the last allocation)
    committed: bool = False


class KvBlockManager:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        event_sink: Optional[Callable[[KvCacheEvent], None]] = None,
        enable_prefix_reuse: bool = True,
    ):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.event_sink = event_sink
        self.enable_prefix_reuse = enable_prefix_reuse
        self._blocks = [_Block() for _ in range(num_blocks)]
        self._free: deque[int] = deque(range(num_blocks))
        # unreferenced-but-matchable blocks, oldest first (eviction order)
        self._lru: OrderedDict[int, None] = OrderedDict()
        # seq_hash -> block_id for every content-registered block
        self._table: dict[int, int] = {}
        # seq_hash -> block_id for blocks an in-flight prefill is writing
        self._reserved: dict[int, int] = {}

    # ----------------------------------------------------------------- stats
    @property
    def free_blocks(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def active_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def usage(self) -> float:
        return self.active_blocks / self.num_blocks

    # ------------------------------------------------------------ allocation
    def match_prefix(self, seq_hashes: list[int], total_tokens: int) -> list[int]:
        """Longest cached-prefix match, capped so >=1 token remains to run
        through the model."""
        if not self.enable_prefix_reuse:
            return []
        max_match = min(len(seq_hashes), (total_tokens - 1) // self.block_size)
        matched: list[int] = []
        for i in range(max_match):
            bid = self._table.get(seq_hashes[i])
            if bid is None:
                break
            matched.append(bid)
        return matched

    def allocate(self, seq_hashes: list[int], total_tokens: int) -> BlockAllocation:
        """Allocate blocks to cover ``total_tokens``, reusing any cached
        prefix whose chained hashes match ``seq_hashes`` and joining any
        in-flight reservations that continue it."""
        n_blocks = -(-total_tokens // self.block_size)  # ceil
        block_ids: list[int] = []
        cached = 0
        for bid in self.match_prefix(seq_hashes, total_tokens):
            self._acquire(bid)
            block_ids.append(bid)
            cached += self.block_size
        joined = 0
        max_match = min(len(seq_hashes), (total_tokens - 1) // self.block_size)
        while self.enable_prefix_reuse and len(block_ids) < max_match:
            bid = self._reserved.get(seq_hashes[len(block_ids)])
            if bid is None:
                break
            self._acquire(bid)
            block_ids.append(bid)
            joined += self.block_size
        try:
            while len(block_ids) < n_blocks:
                block_ids.append(self._alloc_fresh())
        except NoFreeBlocks:
            self.release(block_ids)
            raise
        return BlockAllocation(
            block_ids=block_ids, cached_tokens=cached, joined_tokens=joined
        )

    def allocate_raw(self, n: int) -> list[int]:
        """Allocate n fresh blocks (no prefix matching) — decode growth."""
        out: list[int] = []
        try:
            for _ in range(n):
                out.append(self._alloc_fresh())
        except NoFreeBlocks:
            self.release(out)
            raise
        return out

    def _alloc_fresh(self) -> int:
        if self._free:
            bid = self._free.popleft()
        elif self._lru:
            bid, _ = self._lru.popitem(last=False)  # evict oldest
            self._unregister(bid)
        else:
            raise NoFreeBlocks
        blk = self._blocks[bid]
        blk.ref_count = 1
        blk.committed = False
        return bid

    def _acquire(self, bid: int) -> None:
        blk = self._blocks[bid]
        if blk.ref_count == 0:
            self._lru.pop(bid, None)
        blk.ref_count += 1

    # ------------------------------------------------ in-flight reservations
    def reserve(self, seq_hash: int, block_id: int) -> bool:
        """Claim responsibility for computing the block with this chain
        hash.  False when the content already exists or another request is
        already computing it."""
        if not self.enable_prefix_reuse:
            return False
        if seq_hash in self._table or seq_hash in self._reserved:
            return False
        self._reserved[seq_hash] = block_id
        return True

    def unreserve(self, seq_hash: int, block_id: int) -> None:
        """Drop a reservation (owner finished before committing)."""
        if self._reserved.get(seq_hash) == block_id:
            del self._reserved[seq_hash]

    def is_reserved(self, seq_hash: int) -> bool:
        return seq_hash in self._reserved

    def block_committed(self, block_id: int) -> bool:
        """Has this block's content been fully written since allocation?"""
        return self._blocks[block_id].committed

    # ------------------------------------------------------------- lifecycle
    def commit(
        self,
        block_id: int,
        seq_hash: int,
        parent_hash: Optional[int],
        tokens: Optional[list[int]] = None,
    ) -> None:
        """A block filled with content — make it matchable and announce it.
        If the hash is already registered to another block the block stays
        private; dedupe happens at the next allocation."""
        if not self.enable_prefix_reuse:
            return
        blk = self._blocks[block_id]
        blk.committed = True
        self.unreserve(seq_hash, block_id)
        if seq_hash in self._table:
            return
        blk.seq_hash = seq_hash
        blk.parent_hash = parent_hash
        self._table[seq_hash] = block_id
        if self.event_sink:
            self.event_sink(
                KvStoredEvent(
                    block_hashes=[seq_hash],
                    parent_hash=parent_hash,
                    token_blocks=[list(tokens)] if tokens is not None else [],
                )
            )

    def release(self, block_ids: list[int]) -> None:
        """Drop one reference from each block; unreferenced blocks become
        evictable (content preserved) or free (never registered)."""
        for bid in block_ids:
            blk = self._blocks[bid]
            if blk.ref_count <= 0:
                raise ValueError(f"double free of block {bid}")
            blk.ref_count -= 1
            if blk.ref_count == 0:
                if blk.seq_hash is not None:
                    self._lru[bid] = None
                else:
                    self._free.append(bid)

    def _unregister(self, bid: int) -> None:
        blk = self._blocks[bid]
        if blk.seq_hash is not None:
            self._table.pop(blk.seq_hash, None)
            if self.event_sink:
                self.event_sink(KvRemovedEvent(block_hashes=[blk.seq_hash]))
            blk.seq_hash = None
            blk.parent_hash = None

    def lookup(self, seq_hash: int) -> Optional[int]:
        return self._table.get(seq_hash)
