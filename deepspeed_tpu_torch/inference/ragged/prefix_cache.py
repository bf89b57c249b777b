"""Shared-prefix KV block cache (content-hash prefix matching); port of
``deepspeed_tpu/inference/ragged/prefix_cache.py``. Every lookup, miss
and eviction also lands as a hub counter (``serve.prefix_lookups``,
``serve.prefix_misses``, ``serve.prefix_evicted_blocks``), labelled per
replica when ``metric_labels`` is given, as in JAX.

Repeated system prompts are the dominant prefill cost in production
serving: every request carries the same first N tokens, and the KV for
those tokens is identical across requests (the forward for token t
depends only on tokens <= t). *Full* KV blocks whose token content
matches a cached chain are shared by block id instead of re-prefilled.

- Keys form a hash chain: ``key_i = H(key_{i-1}, tokens[i*bs:(i+1)*bs])``
  so a block is only reusable when the ENTIRE prefix up to it matches.
- Only full, write-complete blocks are ever shared. The partial tail
  block of a prompt (and every generated-token block) is written in
  place as the sequence grows, so it is always freshly allocated per
  sequence — copy-on-write by construction.
- Per-block refcounts track live sequences holding the block. At
  refcount 0 the block moves to an LRU idle list: still cached but
  evictable, so KV-pool pressure reclaims idle cached blocks before any
  live sequence is preempted.

The cache owns no device memory: block ids index the one KV pool tensor
(kv_cache.py), and eviction is pure host bookkeeping.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _chain_key(prev_key: Optional[str], tokens: np.ndarray) -> str:
    h = hashlib.sha1()
    if prev_key is not None:
        h.update(prev_key.encode())
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.hexdigest()


class PrefixCache:
    """Content-addressed registry of full KV blocks with refcounts and
    LRU eviction of idle entries."""

    def __init__(self, block_size: int,
                 metric_labels: Optional[Dict[str, str]] = None):
        from deepspeed_tpu_torch.observability.hub import get_hub

        self.block_size = int(block_size)
        self._metric_labels = dict(metric_labels) if metric_labels else None
        self._hub = get_hub()
        self._block_of: Dict[str, int] = {}      # key -> block id
        self._refs: Dict[str, int] = {}          # key -> live holders
        self._idle: "OrderedDict[str, int]" = OrderedDict()  # LRU, ref==0
        self.stats = {"hits": 0, "hit_tokens": 0, "misses": 0,
                      "registered": 0, "evicted": 0, "conflicts": 0}

    # -- lookup / ref lifecycle ---------------------------------------

    def chain_key(self, prev_key: Optional[str], tokens) -> str:
        return _chain_key(prev_key, np.asarray(tokens, np.int32))

    def lookup(self, tokens, max_tokens: Optional[int] = None
               ) -> Tuple[List[str], List[int]]:
        """Longest cached full-block chain covering a prefix of
        ``tokens`` (capped at ``max_tokens``). Returns (keys, block ids)
        WITHOUT taking references — call :meth:`ref` to hold them."""
        toks = np.asarray(tokens, np.int32).ravel()
        bs = self.block_size
        limit = len(toks) if max_tokens is None else min(len(toks),
                                                         int(max_tokens))
        keys: List[str] = []
        blocks: List[int] = []
        prev: Optional[str] = None
        for i in range(limit // bs):
            key = _chain_key(prev, toks[i * bs:(i + 1) * bs])
            blk = self._block_of.get(key)
            if blk is None:
                break
            keys.append(key)
            blocks.append(blk)
            prev = key
        self._hub.counter_add("serve.prefix_lookups",
                              labels=self._metric_labels)
        if keys:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += len(keys) * bs
        else:
            self.stats["misses"] += 1
            self._hub.counter_add("serve.prefix_misses",
                                  labels=self._metric_labels)
        return keys, blocks

    def get(self, key: str) -> Optional[int]:
        """Block id cached under ``key`` (no ref taken), or None."""
        return self._block_of.get(key)

    def ref(self, keys: Sequence[str]) -> None:
        for key in keys:
            if key not in self._block_of:
                raise KeyError(f"prefix key {key[:12]} not cached")
            self._refs[key] = self._refs.get(key, 0) + 1
            self._idle.pop(key, None)

    def unref(self, keys: Sequence[str]) -> None:
        for key in keys:
            n = self._refs.get(key, 0) - 1
            if n < 0:
                raise ValueError(f"unref of unheld prefix key {key[:12]}")
            if n == 0:
                self._refs.pop(key)
                # most-recently-released = last evicted
                self._idle[key] = self._block_of[key]
                self._idle.move_to_end(key)
            else:
                self._refs[key] = n

    # -- registration / eviction --------------------------------------

    def register(self, key: str, block_id: int) -> bool:
        """Adopt ``block_id`` (owned and already write-complete by the
        caller's sequence) into the cache under ``key``, with one
        reference held by the caller. False when the key is already
        cached under a different block (two identical prompts prefilled
        concurrently) — the caller's block then stays private."""
        existing = self._block_of.get(key)
        if existing is not None:
            if existing != int(block_id):
                self.stats["conflicts"] += 1
                return False
            # re-register of the caller's own block: just take the ref
            self._refs[key] = self._refs.get(key, 0) + 1
            self._idle.pop(key, None)
            return True
        self._block_of[key] = int(block_id)
        self._refs[key] = 1
        self.stats["registered"] += 1
        return True

    @property
    def evictable_blocks(self) -> int:
        return len(self._idle)

    @property
    def referenced_blocks(self) -> int:
        """Distinct cached blocks currently held by live sequences."""
        return len(self._refs)

    @property
    def cached_blocks(self) -> int:
        return len(self._block_of)

    def evict(self, n: int) -> List[int]:
        """Drop up to ``n`` least-recently-idle entries; returns their
        block ids for the caller to hand back to the allocator."""
        return [blk for _, blk in self.evict_entries(n)]

    def evict_entries(self, n: int) -> List[Tuple[str, int]]:
        """Like :meth:`evict`, but returns ``(chain_key, block_id)``
        pairs: the host tier (``kv_tier.py``) needs the keys to page the
        evicted contents out instead of dropping them."""
        out: List[Tuple[str, int]] = []
        while self._idle and len(out) < n:
            key, blk = self._idle.popitem(last=False)
            del self._block_of[key]
            out.append((key, blk))
        self.stats["evicted"] += len(out)
        if out:
            self._hub.counter_add("serve.prefix_evicted_blocks", len(out),
                                  labels=self._metric_labels)
        return out

    def snapshot(self) -> Dict[str, int]:
        return dict(self.stats, cached_blocks=self.cached_blocks,
                    evictable_blocks=self.evictable_blocks,
                    referenced_blocks=len(self._refs))
