"""Host-RAM KV offload tier: evicted device blocks stay reusable.

The counterpart of ``dynamo_tpu/llm/kv/host_pool.py``.  The device side
is the block gather/scatter over the paged cache's block axis
(``ops/block_copy.py``); this module owns the host side — one CPU tensor
per cache part, block-major so a block is one contiguous row, pinned when
the engine serves on the card — and the hash→row bookkeeping: LRU
eviction, chained-sequence-hash prefix matching, content-addressed dedupe.

Rows move host to host as in the JAX package, by the threaded C++ memcpy
(``dynamo_tpu_torch/native.py``): a store scatters blocks into the pool's
rows, a gather into CPU tensors gathers rows out.  A gather into tensors
on the card is one asynchronous copy per run of consecutive rows, straight
from the pinned pool (the native copy is host to host and has no part
there).

Concurrency: NOT internally synchronised.  The engine's kv-offload thread
calls ``store`` while the engine loop calls ``match_prefix``/``gather``/
``touch`` — every call site must hold ``EngineCore._offload_lock``.
"""

from __future__ import annotations

import logging
from collections import OrderedDict, deque
from typing import Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch import native
from dynamo_tpu_torch.ops.kv_quant import QuantKvCache

log = logging.getLogger("dynamo_tpu_torch.kv.host_pool")

__all__ = ["HostKvPool", "flatten_blocks", "unflatten_blocks"]


def flatten_blocks(blocks) -> tuple[str, list[torch.Tensor]]:
    """Block batch → (structure, CPU-or-device tensor parts): ``leaf`` (one
    tensor or array), ``quant`` (a QuantKvCache's data and scale) or
    ``tuple``.  numpy arrays become tensors sharing their memory."""
    def part(a):
        return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a

    if isinstance(blocks, QuantKvCache):
        return "quant", [part(blocks.data), part(blocks.scale)]
    if isinstance(blocks, (tuple, list)):
        return "tuple", [part(a) for a in blocks]
    return "leaf", [part(blocks)]


def unflatten_blocks(structure: str, parts: list):
    if structure == "leaf":
        return parts[0]
    if structure == "quant":
        return QuantKvCache(*parts)
    return tuple(parts)


def _runs(hids: Sequence[int]) -> list[tuple[int, int, int]]:
    """(first position, first row, length) of each run of consecutive rows."""
    runs: list[tuple[int, int, int]] = []
    for pos, hid in enumerate(hids):
        if runs and runs[-1][1] + runs[-1][2] == hid:
            runs[-1] = (runs[-1][0], runs[-1][1], runs[-1][2] + 1)
        else:
            runs.append((pos, hid, 1))
    return runs


class HostKvPool:
    """Fixed-capacity host pool of KV blocks keyed by sequence hash.

    The backing tensors are allocated lazily on the first ``store`` (the
    engine knows a block's host-side shape only after the first gather),
    in pinned memory when ``pin_memory`` (the engine's device is CUDA), so
    a restore uploads from the pool asynchronously.
    """

    def __init__(self, num_blocks: int, pin_memory: bool = False):
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.num_blocks = num_blocks
        self.pin_memory = pin_memory
        # the native row copies: the host library is built (or loaded) here,
        # at construction, never by a store or a gather
        self._copies = native.BlockCopies()
        # one pool tensor per cache part: [t] for a bf16/f32 cache, [data,
        # scale] for the int8 cache; the structure captured at the first
        # store lets gather() return exactly the structure store() received
        self._arrs: Optional[list[torch.Tensor]] = None
        self._structure: Optional[str] = None
        self._free: deque[int] = deque(range(num_blocks))
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # hid -> (order)
        self._hash_of: list[Optional[int]] = [None] * num_blocks
        self._table: dict[int, int] = {}  # seq_hash -> hid
        # stats
        self.stored_blocks = 0
        self.restored_blocks = 0
        self.evicted_blocks = 0
        self.dropped_blocks = 0  # capacity-cap truncations (see reserve)
        # lookup counters (block granularity): how much of each probed
        # prefix was resident vs not — the tier's effective hit rate
        self.hit_blocks = 0
        self.miss_blocks = 0

    # ------------------------------------------------------------------ state
    @property
    def resident(self) -> int:
        return len(self._table)

    @property
    def block_nbytes(self) -> int:
        if self._arrs is None:
            return 0
        return sum(a[0].numel() * a.element_size() for a in self._arrs)

    def __contains__(self, seq_hash: int) -> bool:
        return seq_hash in self._table

    # ------------------------------------------------------------------ store
    def _ensure_arrs(self, structure: str, parts: list[torch.Tensor]) -> None:
        if self._arrs is None:
            self._arrs = [torch.empty((self.num_blocks,) + tuple(p.shape[1:]), dtype=p.dtype,
                                      pin_memory=self.pin_memory) for p in parts]
            self._structure = structure
            return
        if structure != self._structure or len(parts) != len(self._arrs):
            raise ValueError(f"block structure changed: pool holds {self._structure} of "
                             f"{len(self._arrs)} parts, incoming {structure} of {len(parts)}")
        for a, p in zip(self._arrs, parts):
            if a.shape[1:] != p.shape[1:] or a.dtype != p.dtype:
                raise ValueError(f"block shape changed: pool {tuple(a.shape[1:])}/{a.dtype}"
                                 f" vs incoming {tuple(p.shape[1:])}/{p.dtype}")

    def _alloc(self) -> int:
        if self._free:
            return self._free.popleft()
        hid, _ = self._lru.popitem(last=False)  # oldest
        old = self._hash_of[hid]
        if old is not None:
            del self._table[old]
            self._hash_of[hid] = None
            self.evicted_blocks += 1
        return hid

    def reserve(self, seq_hashes: Sequence[int], blocks) -> tuple[list[int], list[int]]:
        """Store phase 1 (hold the caller's lock): LRU-refresh resident
        hashes, allocate pool rows for the fresh ones.

        Reserved rows sit in neither ``_table`` nor ``_lru``, so readers
        cannot observe them and eviction cannot reclaim them until
        :meth:`publish`.  Returns ``(hids, rows)``: the pool row for each
        fresh hash and its index into ``seq_hashes``/``blocks``.
        """
        structure, parts = flatten_blocks(blocks)
        if any(len(seq_hashes) != len(p) for p in parts):
            raise ValueError(f"{len(seq_hashes)} hashes vs {[len(p) for p in parts]} blocks")
        self._ensure_arrs(structure, parts)
        hids: list[int] = []
        rows: list[int] = []
        seen: set[int] = set()  # intra-batch dedupe (one row per hash)
        # reserved rows leave the free list AND the LRU, so a batch can
        # claim at most free+evictable rows; prefix matching walks from the
        # sequence start, so the EARLIEST blocks are the ones to keep
        cap = len(self._free) + len(self._lru)
        for i, h in enumerate(seq_hashes):
            hid = self._table.get(h)
            if hid is not None:
                self._lru.move_to_end(hid)
                continue
            if h in seen:
                continue
            if len(hids) >= cap:
                # an undersized num_host_blocks otherwise shows up only as
                # a mysteriously low hit rate
                dropped = len({x for x in seq_hashes[i:] if x not in seen and x not in self._table})
                self.dropped_blocks += dropped
                log.warning("host pool full: dropped %d of %d blocks from a store batch "
                            "(num_host_blocks=%d undersized?)", dropped, len(seq_hashes),
                            self.num_blocks)
                break
            seen.add(h)
            hids.append(self._alloc())
            rows.append(i)
        return hids, rows

    def abort(self, hids: list[int]) -> None:
        """Return reserved-but-unpublished rows to the free list (the write
        failed); without this a failed store leaks capacity."""
        self._free.extend(hids)

    def write_rows(self, hids: list[int], blocks, rows: list[int]) -> None:
        """Store phase 2 (NO lock needed — the rows are reserved, hence
        invisible and un-evictable): copy the blocks' ``rows`` into the pool
        rows ``hids``, by native memcpy.  The blocks are CPU tensors (or
        numpy arrays)."""
        _, parts = flatten_blocks(blocks)
        every = list(rows) == list(range(len(parts[0])))
        src = torch.as_tensor(rows, dtype=torch.long)
        for arr, p in zip(self._arrs, parts):
            self._copies.scatter(arr, hids, p if every else p.index_select(0, src))

    def publish(self, hids: list[int], seq_hashes: list[int]) -> int:
        """Store phase 3 (hold the lock): make written rows visible.  A hash
        a concurrent store landed first frees its row instead."""
        n = 0
        for hid, h in zip(hids, seq_hashes):
            if h in self._table:
                self._free.append(hid)
                continue
            self._table[h] = hid
            self._hash_of[hid] = h
            self._lru[hid] = None
            n += 1
        self.stored_blocks += n
        return n

    def store(self, seq_hashes: Sequence[int], blocks) -> int:
        """Offload blocks (block-major: blocks[i] belongs to seq_hashes[i];
        a QuantKvCache or tuple of block-major parts for the int8 cache).

        Already-resident hashes are refreshed in LRU order but not
        re-copied.  Returns how many new blocks were written.  The
        single-caller form of reserve/write_rows/publish.
        """
        hids, rows = self.reserve(seq_hashes, blocks)
        if not hids:
            return 0
        self.write_rows(hids, blocks, rows)
        return self.publish(hids, [seq_hashes[r] for r in rows])

    def touch(self, seq_hashes: Sequence[int]) -> None:
        """Refresh LRU order for resident hashes (no copy)."""
        for h in seq_hashes:
            hid = self._table.get(h)
            if hid is not None:
                self._lru.move_to_end(hid)

    # ------------------------------------------------------------------ fetch
    def match_prefix(self, seq_hashes: Sequence[int]) -> list[int]:
        """Longest resident prefix of ``seq_hashes`` (chained hashes commit
        to their prefix, so element-wise probing is a true prefix match)."""
        out: list[int] = []
        for h in seq_hashes:
            if h not in self._table:
                break
            out.append(h)
        self.hit_blocks += len(out)
        self.miss_blocks += len(seq_hashes) - len(out)
        return out

    def gather(self, seq_hashes: Sequence[int], out: Optional[list[torch.Tensor]] = None):
        """Fetch resident blocks (block-major) in exactly the structure
        ``store`` received: new CPU tensors, or written into ``out`` (one
        ``[n, ...]`` tensor per part).  Into CPU tensors the rows move by
        native memcpy.  Into tensors on the card each run of
        consecutive rows is one asynchronous copy on the current stream,
        from the pinned pool: the caller must keep these rows from being
        rewritten (hold the lock) until the copies have completed."""
        hids = []
        for h in seq_hashes:
            hid = self._table.get(h)
            if hid is None:
                raise KeyError(f"block {h:#x} not resident in host pool")
            self._lru.move_to_end(hid)
            hids.append(hid)
        self.restored_blocks += len(hids)
        if out is None:
            parts = [self._copies.gather(a, hids) for a in self._arrs]
        else:
            for a, o in zip(self._arrs, out):
                if o.device.type == "cpu":
                    self._copies.gather(a, hids, out=o)
                    continue
                for pos, hid, n in _runs(hids):
                    o[pos:pos + n].copy_(a[hid:hid + n], non_blocking=self.pin_memory)
            parts = list(out)
        return unflatten_blocks(self._structure, parts)

    def part_specs(self) -> list[tuple[tuple[int, ...], torch.dtype]]:
        """Each part's block shape and dtype (empty before the first store)."""
        return [(tuple(a.shape[1:]), a.dtype) for a in self._arrs or ()]

    def clear(self) -> None:
        self._table.clear()
        self._lru.clear()
        self._hash_of = [None] * self.num_blocks
        self._free = deque(range(self.num_blocks))

    def stats(self) -> dict:
        return {
            "host_blocks_resident": self.resident,
            "host_blocks_total": self.num_blocks,
            "host_blocks_stored": self.stored_blocks,
            "host_blocks_restored": self.restored_blocks,
            "host_blocks_evicted": self.evicted_blocks,
            "host_blocks_dropped": self.dropped_blocks,
            "host_blocks_hits": self.hit_blocks,
            "host_blocks_misses": self.miss_blocks,
        }
