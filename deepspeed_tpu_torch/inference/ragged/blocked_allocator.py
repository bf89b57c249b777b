"""KV-block free-list allocator (copy of
``deepspeed_tpu/inference/ragged/blocked_allocator.py``).

The block table is host-side metadata handed to each step as a dense
int array, so a plain numpy free list is the right shape: zero device
traffic to allocate or free.
"""

from __future__ import annotations

import numpy as np


class BlockedAllocator:
    """Fixed pool of equal-size blocks; O(1) allocate/free via a linked
    free list (same contract as the reference: allocate(n) -> block ids,
    free(ids))."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        # _next[i] = next free block after i (linked list threaded through
        # a dense array, as in the reference)
        self._next = np.arange(1, num_blocks + 1, dtype=np.int64)
        self._head = 0
        self._free_count = num_blocks

    @property
    def free_blocks(self) -> int:
        return self._free_count

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    def allocate(self, num_blocks: int) -> np.ndarray:
        if num_blocks > self._free_count:
            raise MemoryError(
                f"requested {num_blocks} blocks, only {self._free_count} free")
        out = np.empty(num_blocks, dtype=np.int64)
        for i in range(num_blocks):
            out[i] = self._head
            self._head = self._next[self._head]
        self._free_count -= num_blocks
        return out

    def free(self, blocks) -> None:
        blocks = np.atleast_1d(np.asarray(blocks, dtype=np.int64))
        seen = set()
        for b in blocks:
            bi = int(b)
            if not 0 <= bi < self._num_blocks:
                raise ValueError(f"block id {bi} out of range")
            if bi in seen:
                raise ValueError(f"double free of block {bi}")
            seen.add(bi)
        for b in blocks:
            bi = int(b)
            self._next[bi] = self._head
            self._head = bi
        self._free_count += len(blocks)
