"""Blocked (paged) KV cache (port of
``deepspeed_tpu/inference/ragged/kv_cache.py``).

The pool is ONE device tensor per model,

    kv[L, num_blocks, block_size, 2, kv_heads, head_dim]

written in place by the runner's KV append (``inference/model_runner.py``);
the host only manages block ids (``blocked_allocator.py``). A quantized
pool (``quant_bits`` 8, 4 or "fp8") holds codes instead (int8; uint8 with
two int4 values per byte and a last dim of head_dim / 2; e4m3) plus one
fp32 scale per (layer, block, row, k/v, head) vector in ``scales``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch._device import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.ragged.blocked_allocator import \
    BlockedAllocator

# numpy has no bf16 or fp8: the host copy of such a pool keeps its raw
# bytes under an integer dtype of the same width (pool-native, no
# conversion either way)
_HOST_VIEW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    kv_heads: int
    head_dim: int
    block_size: int = 16
    num_blocks: int = 256
    dtype: torch.dtype = torch.bfloat16
    # None = the unquantized pool in ``dtype``; 8 = int8 payload with one
    # fp32 scale per (layer, block, row, k/v, head) vector; 4 = packed
    # uint8 payload (two values per byte) with the same scale; "fp8" =
    # e4m3 payload with the same scale
    quant_bits: Optional[object] = None

    def __post_init__(self):
        if self.quant_bits not in (None, 4, 8, "fp8"):
            raise ValueError(f"kv quant_bits must be None, 4, 8 or 'fp8', "
                             f"got {self.quant_bits}")
        if self.quant_bits == 4 and self.head_dim % 2:
            raise ValueError(
                f"int4 KV storage packs two values per byte and needs an "
                f"even head_dim, got {self.head_dim}")

    @property
    def payload_width(self) -> int:
        """Last-dim extent of the pool payload: head_dim values, packed
        two per byte under int4."""
        return self.head_dim // 2 if self.quant_bits == 4 else self.head_dim

    @property
    def payload_dtype(self) -> torch.dtype:
        return {None: self.dtype, 8: torch.int8, 4: torch.uint8,
                "fp8": torch.float8_e4m3fn}[self.quant_bits]

    @property
    def bytes_per_block(self) -> int:
        vecs = self.num_layers * self.block_size * 2 * self.kv_heads
        if self.quant_bits is not None:
            # int8 / fp8 / packed-int4 payload + fp32 scale per head vector
            return vecs * (self.payload_width + 4)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return vecs * self.head_dim * itemsize


class BlockedKVCache:
    """Device pool + host allocator (reserve/free by block count; also
    owns the device tensors).

    When a :class:`~deepspeed_tpu_torch.inference.ragged.prefix_cache.
    PrefixCache` is attached (``prefix_cache`` attr), idle cached blocks
    are parked outside the allocator free list; :meth:`reclaim` evicts
    them back under memory pressure, into the host tier when one is
    attached (``host_tier`` attr)."""

    def __init__(self, config: KVCacheConfig, device: DeviceLike = None):
        self.config = config
        self.allocator = BlockedAllocator(config.num_blocks)
        self.prefix_cache = None  # Optional[PrefixCache], attached by owner
        self.host_tier = None     # Optional[HostKVTier], attached by owner
        shape = (config.num_layers, config.num_blocks, config.block_size,
                 2, config.kv_heads, config.payload_width)
        dev = resolve_device(device)
        self.data = torch.zeros(shape, dtype=config.payload_dtype, device=dev)
        # scales start at ones: a row never written reads back as 0 x 1.0
        self.scales = (None if config.quant_bits is None else
                       torch.ones(shape[:-1], dtype=torch.float32,
                                  device=dev))

    @property
    def quant_bits(self):
        return self.config.quant_bits

    @property
    def kv_state(self):
        """The pool as the runner's forwards take it: the bare tensor when
        unquantized, a (payload, fp32 scales) pair when ``quant_bits`` is
        set."""
        if self.scales is None:
            return self.data
        return (self.data, self.scales)

    def set_kv_state(self, state) -> None:
        """Store the pool a forward returned (inverse of :attr:`kv_state`;
        the forwards write in place, so this keeps the same tensors)."""
        if self.scales is None:
            self.data = state
        else:
            self.data, self.scales = state

    def blocks_needed(self, num_tokens: int) -> int:
        bs = self.config.block_size
        return (num_tokens + bs - 1) // bs

    # -- host-tier block I/O (ragged/kv_tier.py) -----------------------

    def _raw(self) -> torch.Tensor:
        """The payload under a dtype numpy has (bf16 and e4m3 bytes as
        int16 / uint8)."""
        view = _HOST_VIEW.get(self.data.dtype)
        return self.data if view is None else self.data.view(view)

    def read_blocks_host(self, block_ids):
        """Device -> host copy of the pool at ``block_ids``: (payload
        [L, n, bs, 2, H, W], scales [L, n, bs, 2, H] | None) as numpy, in
        the pool's own storage format (bf16 and e4m3 payloads as their raw
        bytes under int16 / uint8). For a quantized pool that IS the
        compact kv_pack format, so paging out converts nothing."""
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),
                              device=self.data.device)
        payload = self._raw()[:, idx].cpu().numpy()
        scales = (self.scales[:, idx].cpu().numpy()
                  if self.scales is not None else None)
        return payload, scales

    def write_blocks(self, block_ids, payload, scales=None) -> None:
        """Host -> device restore at ``block_ids``: the inverse of
        :meth:`read_blocks_host`, bit-exact for a pool-native payload."""
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),
                              device=self.data.device)
        raw = self._raw()
        raw[:, idx] = torch.from_numpy(np.ascontiguousarray(
            payload)).to(raw.device, raw.dtype)
        if self.scales is not None and scales is not None:
            self.scales[:, idx] = torch.from_numpy(
                np.ascontiguousarray(scales, np.float32)).to(
                    self.scales.device)

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
        allocator free list; returns how many were reclaimed. With a
        host tier attached, cold chains page OUT (contents parked in host
        memory under the same chain keys) instead of being dropped, so a
        returning session pages back in without re-prefill."""
        if n <= 0 or self.prefix_cache is None:
            return 0
        if self.host_tier is not None:
            entries = self.prefix_cache.evict_entries(n)
            if entries:
                keys = [k for k, _ in entries]
                blocks = [b for _, b in entries]
                payload, scales = self.read_blocks_host(blocks)
                self.host_tier.put_chain(keys, payload, scales)
                self.allocator.free(np.asarray(blocks, np.int64))
            return len(entries)
        evicted = self.prefix_cache.evict(n)
        if evicted:
            self.allocator.free(np.asarray(evicted, np.int64))
        return len(evicted)
