"""Blocked (paged) KV cache (port of
``deepspeed_tpu/inference/ragged/kv_cache.py``).

The pool is ONE device tensor per model,

    kv[L, num_blocks, block_size, 2, kv_heads, head_dim]

written in place by the runner's KV append (``inference/model_runner.py``);
the host only manages block ids (``blocked_allocator.py``). Only the
unquantized pool is ported: the int8 / int4 / fp8 rungs come with the
quantization slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch._device import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.ragged.blocked_allocator import \
    BlockedAllocator


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    kv_heads: int
    head_dim: int
    block_size: int = 16
    num_blocks: int = 256
    dtype: torch.dtype = torch.bfloat16
    # None = unquantized pool; the quantized rungs (4, 8, "fp8") are not
    # ported yet (ROADMAP queue A, item 8)
    quant_bits: Optional[object] = None

    def __post_init__(self):
        if self.quant_bits is not None:
            raise NotImplementedError(
                f"kv quant_bits={self.quant_bits!r}: quantized KV pools "
                "arrive with the quantization slice (ROADMAP queue A item "
                "8 and queue B kernel 6); use quant_bits=None")


class BlockedKVCache:
    """Device pool + host allocator (reserve/free by block count; also
    owns the device tensor).

    When a :class:`~deepspeed_tpu_torch.inference.ragged.prefix_cache.
    PrefixCache` is attached (``prefix_cache`` attr), idle cached blocks
    are parked outside the allocator free list; :meth:`reclaim` evicts
    them back under memory pressure."""

    def __init__(self, config: KVCacheConfig, device: DeviceLike = None):
        self.config = config
        self.allocator = BlockedAllocator(config.num_blocks)
        self.prefix_cache = None  # Optional[PrefixCache], attached by owner
        shape = (config.num_layers, config.num_blocks, config.block_size,
                 2, config.kv_heads, config.head_dim)
        self.data = torch.zeros(shape, dtype=config.dtype,
                                device=resolve_device(device))

    def blocks_needed(self, num_tokens: int) -> int:
        bs = self.config.block_size
        return (num_tokens + bs - 1) // bs

    def free(self, blocks) -> None:
        if len(blocks):
            self.allocator.free(blocks)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    @property
    def available_blocks(self) -> int:
        """Free blocks plus idle prefix-cached blocks reclaimable via
        :meth:`reclaim` — the admission-control capacity number."""
        extra = (self.prefix_cache.evictable_blocks
                 if self.prefix_cache is not None else 0)
        return self.allocator.free_blocks + extra

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` idle prefix-cached blocks back into the
        allocator free list; returns how many were reclaimed."""
        if n <= 0 or self.prefix_cache is None:
            return 0
        evicted = self.prefix_cache.evict(n)
        if evicted:
            self.allocator.free(np.asarray(evicted, np.int64))
        return len(evicted)
