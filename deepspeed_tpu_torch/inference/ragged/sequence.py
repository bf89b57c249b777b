"""Sequence descriptors + state manager for ragged batching (port of
``deepspeed_tpu/inference/ragged/sequence.py``). Tracks each live sequence's token history, KV blocks and
scheduling state, all on the host: a step only sees the dense metadata
``ragged_batch.py`` builds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.inference.ragged.kv_cache import BlockedKVCache


@dataclasses.dataclass
class SequenceDescriptor:
    uid: int
    input_tokens: np.ndarray            # full prompt
    seen_tokens: int = 0                # tokens already in the KV cache
    kv_blocks: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=np.int64))
    generated: List[int] = dataclasses.field(default_factory=list)
    max_new_tokens: int = 64
    done: bool = False
    truncated: bool = False  # ended early (per-seq KV cap or preemption)
    # shared-prefix bookkeeping: prefix_keys[i] is the PrefixCache key of
    # kv_blocks[i] for the cache-managed head run; those blocks are
    # unref'd (not freed) at release. Always a prefix of kv_blocks.
    prefix_keys: List[str] = dataclasses.field(default_factory=list)
    # tokens already emitted to the caller before a preempt-and-requeue
    # round trip (they ride back in via input_tokens for KV recompute
    # and must still count against max_new_tokens)
    prior_generated: int = 0
    # a registration conflict (identical content cached under another
    # block) ends this seq's registrable run for good
    prefix_reg_stopped: bool = False
    # warm resume (ragged/kv_tier.py): nonzero when admission restored
    # this sequence's KV from the host tier — blocks paged in instead of
    # prefilled
    resumed_from_tier: int = 0

    @property
    def total_tokens(self) -> int:
        return len(self.input_tokens) + len(self.generated)

    @property
    def pending_prefill(self) -> int:
        """Prompt tokens not yet through the model."""
        return max(0, len(self.input_tokens) - self.seen_tokens)

    @property
    def in_decode(self) -> bool:
        return self.pending_prefill == 0 and not self.done

    @property
    def gen_budget_left(self) -> int:
        """New tokens this sequence may still emit (counts tokens
        emitted before any preemption round trip)."""
        return max(0, self.max_new_tokens
                   - self.prior_generated - len(self.generated))


class StateManager:
    """Owns live sequences + their KV blocks (tracks sequences, allocates
    KV on demand)."""

    def __init__(self, kv_cache: BlockedKVCache, max_tracked_sequences: int = 64,
                 max_blocks_per_seq: Optional[int] = None):
        self.kv_cache = kv_cache
        self.max_tracked_sequences = max_tracked_sequences
        self.max_blocks_per_seq = max_blocks_per_seq
        self.seqs: Dict[int, SequenceDescriptor] = {}

    def get_or_create(self, uid: int, tokens: np.ndarray,
                      max_new_tokens: int = 64) -> SequenceDescriptor:
        if uid in self.seqs:
            return self.seqs[uid]
        if len(self.seqs) >= self.max_tracked_sequences:
            raise RuntimeError("max_tracked_sequences exceeded")
        seq = SequenceDescriptor(uid=uid,
                                 input_tokens=np.asarray(tokens, np.int32),
                                 max_new_tokens=max_new_tokens)
        self.seqs[uid] = seq
        return seq

    def ensure_capacity(self, seq: SequenceDescriptor, new_total: int) -> bool:
        """Grow seq's block list to fit new_total tokens. False if the pool
        is exhausted (after reclaiming idle prefix-cached blocks). A
        sequence that hits the per-seq block cap is ENDED (truncated)
        rather than grown — growing past the cap would overflow the dense
        batch metadata (build_ragged_batch bucket bound)."""
        total_needed = self.kv_cache.blocks_needed(new_total)
        need = total_needed - len(seq.kv_blocks)
        if need <= 0:
            return True
        if (self.max_blocks_per_seq is not None
                and total_needed > self.max_blocks_per_seq):
            seq.done = True
            seq.truncated = True
            return False
        if need > self.kv_cache.free_blocks:
            self.kv_cache.reclaim(need - self.kv_cache.free_blocks)
        if need > self.kv_cache.free_blocks:
            return False
        new_blocks = self.kv_cache.allocator.allocate(need)
        seq.kv_blocks = np.concatenate([seq.kv_blocks, new_blocks])
        return True

    def attach_prefix(self, seq: SequenceDescriptor) -> int:
        """Seed a freshly-created sequence's block list from the prefix
        cache: the longest cached full-block chain matching its prompt
        is shared by reference and those tokens skip prefill. The final
        prompt token is always left uncached so the step still computes
        first-token logits. With a host tier attached
        (ragged/kv_tier.py) the chain walk continues PAST the device
        cache into host memory: matching paged-out blocks page back in,
        re-register, and extend the skip. Returns the number of prefill
        tokens skipped."""
        cache = self.kv_cache.prefix_cache
        if (cache is None or seq.seen_tokens or len(seq.kv_blocks)
                or len(seq.input_tokens) <= cache.block_size):
            return 0
        limit = len(seq.input_tokens) - 1
        if self.max_blocks_per_seq is not None:
            # leave room for at least one private (tail/generation) block
            limit = min(limit,
                        (self.max_blocks_per_seq - 1) * cache.block_size)
        keys, blocks = cache.lookup(seq.input_tokens, max_tokens=limit)
        tier = self.kv_cache.host_tier
        if tier is not None:
            seq.resumed_from_tier += self._page_in_chain(
                seq, cache, tier, keys, blocks, limit)
        if not keys:
            return 0
        cache.ref(keys)
        seq.kv_blocks = np.asarray(blocks, np.int64)
        seq.prefix_keys = list(keys)
        seq.seen_tokens = len(keys) * cache.block_size
        return seq.seen_tokens

    def _page_in_chain(self, seq: SequenceDescriptor, cache, tier,
                       keys: List[str], blocks: List[int],
                       limit: int) -> int:
        """Continue the prefix chain walk into the host tier: page
        matching blocks back into freshly allocated device blocks and
        register them in the prefix cache, extending ``keys``/``blocks``
        in place. Stops at the first tier miss, allocation failure, or
        registration conflict (installs happen strictly in chain order,
        so chain-prefix semantics hold). Returns the number of blocks
        paged in."""
        bs = cache.block_size
        toks = seq.input_tokens
        paged = 0
        while (len(keys) + 1) * bs <= limit:
            i = len(keys)
            key = cache.chain_key(keys[-1] if keys else None,
                                  toks[i * bs:(i + 1) * bs])
            if not tier.has_block(key):
                break
            if self.kv_cache.free_blocks < 1:
                self.kv_cache.reclaim(1)
            if self.kv_cache.free_blocks < 1:
                break  # pool under live pressure: keep what we got
            ent = tier.take_block(key)
            if ent is None:
                break
            blk = int(self.kv_cache.allocator.allocate(1)[0])
            self.kv_cache.write_blocks([blk], ent[0][:, None],
                                       None if ent[1] is None
                                       else ent[1][:, None])
            if not cache.register(key, blk):
                # identical content raced in under another block: theirs
                # wins, and lookup would have found it — stop here
                self.kv_cache.free([blk])
                break
            cache.unref([key])  # park idle; ref'd with the chain below
            keys.append(key)
            blocks.append(blk)
            paged += 1
        return paged

    def register_prefix_blocks(self, seq: SequenceDescriptor) -> None:
        """Publish seq's write-complete full prompt blocks into the
        prefix cache (idempotent; call after each step). Only blocks
        strictly before the prompt's append frontier qualify — the
        partial tail block and every generated-token block are written
        in place as the sequence grows and stay private (copy-on-write
        by construction)."""
        cache = self.kv_cache.prefix_cache
        if cache is None or seq.prefix_reg_stopped:
            return
        bs = cache.block_size
        done_tokens = min(seq.seen_tokens, len(seq.input_tokens))
        n_reg = min(len(seq.input_tokens) // bs, done_tokens // bs,
                    len(seq.kv_blocks))
        while len(seq.prefix_keys) < n_reg:
            i = len(seq.prefix_keys)
            key = cache.chain_key(seq.prefix_keys[-1] if i else None,
                                  seq.input_tokens[i * bs:(i + 1) * bs])
            if not cache.register(key, int(seq.kv_blocks[i])):
                # same content cached under another block: stop for good —
                # keys must chain over THIS seq's own block run
                seq.prefix_reg_stopped = True
                break
            seq.prefix_keys.append(key)

    def release(self, uid: int) -> None:
        seq = self.seqs.pop(uid, None)
        if seq is None:
            return
        n_shared = len(seq.prefix_keys)
        if n_shared:
            self.kv_cache.prefix_cache.unref(seq.prefix_keys)
            seq.prefix_keys = []
        if len(seq.kv_blocks) > n_shared:
            self.kv_cache.free(seq.kv_blocks[n_shared:])
        seq.kv_blocks = np.empty(0, dtype=np.int64)
