"""Token-block sequences with chained content hashes.

A prompt is split into fixed-size blocks of token ids; each block gets a
``block_hash`` (its tokens alone) and a ``sequence_hash`` (chained through
the parent block's sequence hash), so two requests sharing a prefix produce
identical sequence hashes for the shared blocks.  The engine's block manager
keys prefix reuse on them.

Hashing is xxh3-64 over little-endian u32 token bytes with seed 1337, chained
through a u64 parent hash — the same bytes and seed as ``dynamo_tpu.tokens``,
so both packages name a block identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np
import xxhash

BLOCK_HASH_SEED = 1337

__all__ = [
    "BLOCK_HASH_SEED",
    "compute_hash",
    "compute_block_hash",
    "compute_seq_hash",
    "TokenBlock",
    "PartialTokenBlock",
    "TokenBlockSequence",
]


def _tokens_to_bytes(tokens: Sequence[int]) -> bytes:
    return np.asarray(tokens, dtype=np.uint32).tobytes()


def compute_hash(data: bytes, seed: int = BLOCK_HASH_SEED) -> int:
    """xxh3-64 of raw bytes."""
    return xxhash.xxh3_64_intdigest(data, seed=seed)


def compute_block_hash(tokens: Sequence[int]) -> int:
    """Hash of a block's tokens alone (local hash, no chaining)."""
    return compute_hash(_tokens_to_bytes(tokens))


def compute_seq_hash(parent: Optional[int], tokens: Sequence[int], salt: int = 0) -> int:
    """Chained sequence hash: the root block mixes in ``salt``, children
    mix in the parent's sequence hash."""
    prefix = np.uint64(salt if parent is None else parent).tobytes()
    return compute_hash(prefix + _tokens_to_bytes(tokens))


@dataclass(frozen=True)
class TokenBlock:
    """An immutable, complete block of ``block_size`` token ids."""

    tokens: tuple[int, ...]
    block_hash: int
    sequence_hash: int
    parent_sequence_hash: Optional[int]
    position: int  # block index within its sequence

    @staticmethod
    def build(
        tokens: Sequence[int],
        parent: Optional["TokenBlock"],
        position: int,
        salt: int = 0,
    ) -> "TokenBlock":
        parent_hash = parent.sequence_hash if parent is not None else None
        return TokenBlock(
            tokens=tuple(int(t) for t in tokens),
            block_hash=compute_block_hash(tokens),
            sequence_hash=compute_seq_hash(parent_hash, tokens, salt),
            parent_sequence_hash=parent_hash,
            position=position,
        )


@dataclass
class PartialTokenBlock:
    """Mutable tail block being filled."""

    block_size: int
    tokens: list[int] = field(default_factory=list)

    @property
    def remaining(self) -> int:
        return self.block_size - len(self.tokens)

    def push(self, token: int) -> bool:
        """Append one token; returns True when the block became full."""
        if self.remaining <= 0:
            raise ValueError("pushing into a full partial block")
        self.tokens.append(int(token))
        return self.remaining == 0


class TokenBlockSequence:
    """A growing token sequence maintaining complete blocks + a partial tail."""

    def __init__(self, tokens: Iterable[int] = (), block_size: int = 16, salt: int = 0):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self.salt = salt
        self.blocks: list[TokenBlock] = []
        self.partial = PartialTokenBlock(block_size)
        self.extend(tokens)

    @property
    def total_tokens(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial.tokens)

    @property
    def tokens(self) -> list[int]:
        out: list[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.partial.tokens)
        return out

    def sequence_hashes(self) -> list[int]:
        return [b.sequence_hash for b in self.blocks]

    def append(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the newly completed block, if any."""
        if self.partial.push(token):
            parent = self.blocks[-1] if self.blocks else None
            block = TokenBlock.build(
                self.partial.tokens, parent, position=len(self.blocks), salt=self.salt
            )
            self.blocks.append(block)
            self.partial = PartialTokenBlock(self.block_size)
            return block
        return None

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        """Append many tokens; returns all blocks completed by this call."""
        completed: list[TokenBlock] = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                completed.append(b)
        return completed

    def __len__(self) -> int:
        return self.total_tokens
