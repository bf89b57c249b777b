"""Ragged-batching state management (port of
``deepspeed_tpu/inference/ragged``)."""

from deepspeed_tpu_torch.inference.ragged.blocked_allocator import \
    BlockedAllocator
from deepspeed_tpu_torch.inference.ragged.kv_cache import (BlockedKVCache,
                                                           KVCacheConfig)
from deepspeed_tpu_torch.inference.ragged.kv_tier import (HostKVTier,
                                                          PagedSession)
from deepspeed_tpu_torch.inference.ragged.prefix_cache import PrefixCache
from deepspeed_tpu_torch.inference.ragged.ragged_batch import (
    RaggedBatch, build_ragged_batch)
from deepspeed_tpu_torch.inference.ragged.sequence import (SequenceDescriptor,
                                                           StateManager)

__all__ = [
    "BlockedAllocator",
    "BlockedKVCache",
    "HostKVTier",
    "KVCacheConfig",
    "PagedSession",
    "PrefixCache",
    "RaggedBatch",
    "SequenceDescriptor",
    "StateManager",
    "build_ragged_batch",
]
