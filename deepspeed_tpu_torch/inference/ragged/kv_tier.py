"""Host-memory KV tier: page blocks out instead of evicting them (port of
``deepspeed_tpu/inference/ragged/kv_tier.py`` :48-260, numpy only;
the hub's ``serve.host_tier_*`` gauges and page counters as in JAX).

Below the device pool (``kv_cache.py``), host memory holds KV blocks in
the pool's own storage format: a quantized pool's codes and per-vector
scales (the compact ``kv_pack`` format) or an unquantized pool's raw
payload, copied as bytes, so a round trip is bit-exact by construction.

Two record kinds, one for each way KV goes cold:

* **Chains**: cold prefix-cache entries. ``BlockedKVCache.reclaim`` pages
  evicted chains here under their content-hash chain keys
  (``prefix_cache.py``), and ``StateManager.attach_prefix`` continues its
  chain walk into this tier on a device miss: matching blocks page back
  in, re-register in the prefix cache, and the request skips that much
  prefill.
* **Sessions**: paged-out live sequences (``InferenceEngineV2._page_out``
  / ``_try_page_in``): a preemption victim's full block contents
  (including the partial tail block) park here with its descriptor
  state; readmission restores the blocks and resumes *decode* directly,
  with zero prefill and a token stream identical to a never-paged run.

The tier is byte-budgeted with LRU eviction (chains first: a paged
session is a parked live request, a chain is an optimization). Spilling
either kind is safe: chains degrade to re-prefill through the ordinary
cache-miss path, sessions to the preemption requeue's prefix-recompute
path.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_CAPACITY_MB = 256


@dataclasses.dataclass
class PagedSession:
    """A live sequence parked in host memory: the descriptor state that
    rebuilds its ``SequenceDescriptor`` plus the full contents of its KV
    blocks (pool-native format, partial tail block included — restore
    is bit-exact and decode continues with zero recompute)."""

    uid: int
    input_tokens: np.ndarray
    generated: List[int]
    seen_tokens: int
    max_new_tokens: int
    prior_generated: int
    payload: np.ndarray               # [L, n_blocks, bs, 2, H, W], raw
    scales: Optional[np.ndarray]      # [L, n_blocks, bs, 2, H] | None
    admit_time: Optional[float] = None  # pending-TTFT stamp, if any
    # the request's speculation acceptance EWMA: a resumed session drafts
    # at its measured rate instead of starting cold
    spec_accept_ewma: Optional[float] = None

    @property
    def n_blocks(self) -> int:
        return int(self.payload.shape[1])

    @property
    def nbytes(self) -> int:
        n = int(self.payload.nbytes)
        if self.scales is not None:
            n += int(self.scales.nbytes)
        return n


class HostKVTier:
    """Byte-budgeted host store of paged-out KV blocks (chains by
    content-hash key, sessions by uid), LRU within each kind."""

    def __init__(self, capacity_bytes: int = DEFAULT_CAPACITY_MB << 20,
                 metric_labels: Optional[Dict[str, str]] = None):
        from deepspeed_tpu_torch.observability.hub import get_hub

        self.capacity_bytes = int(capacity_bytes)
        self._metric_labels = dict(metric_labels) if metric_labels else None
        self._hub = get_hub()
        # chain key -> (payload [L, bs, 2, H, W], scales [L, bs, 2, H]|None)
        self._chains: OrderedDict = OrderedDict()
        self._sessions: "OrderedDict[int, PagedSession]" = OrderedDict()
        self._bytes = 0
        self.stats = {"chain_blocks_out": 0, "chain_blocks_in": 0,
                      "sessions_out": 0, "sessions_in": 0,
                      "evicted_chain_blocks": 0, "evicted_sessions": 0,
                      "rejected_oversize": 0}

    def _gauges(self) -> None:
        self._hub.gauge("serve.host_tier_bytes", self._bytes,
                        labels=self._metric_labels)
        self._hub.gauge("serve.host_tier_blocks", self.total_blocks,
                        labels=self._metric_labels)
        self._hub.gauge("serve.host_tier_sessions", len(self._sessions),
                        labels=self._metric_labels)

    # -- accounting ----------------------------------------------------

    @property
    def used_bytes(self) -> int:
        return self._bytes

    @property
    def chain_blocks(self) -> int:
        return len(self._chains)

    @property
    def session_count(self) -> int:
        return len(self._sessions)

    @property
    def total_blocks(self) -> int:
        return len(self._chains) + sum(s.n_blocks
                                       for s in self._sessions.values())

    def _entry_bytes(self, payload: np.ndarray,
                     scales: Optional[np.ndarray]) -> int:
        n = int(payload.nbytes)
        if scales is not None:
            n += int(scales.nbytes)
        return n

    def _evict_to_fit(self, incoming: int) -> None:
        """Make room for ``incoming`` bytes: drop LRU chains first (they
        degrade to re-prefill), then the oldest paged sessions (they
        degrade to the requeue recompute path)."""
        while (self._bytes + incoming > self.capacity_bytes
               and self._chains):
            _, (p, s) = self._chains.popitem(last=False)
            self._bytes -= self._entry_bytes(p, s)
            self.stats["evicted_chain_blocks"] += 1
        while (self._bytes + incoming > self.capacity_bytes
               and self._sessions):
            _, sess = self._sessions.popitem(last=False)
            self._bytes -= sess.nbytes
            self.stats["evicted_sessions"] += 1

    # -- chains (cold prefix-cache entries) ----------------------------

    def put_chain(self, keys: List[str], payload: np.ndarray,
                  scales: Optional[np.ndarray]) -> None:
        """Park evicted chain blocks: ``payload`` is the pool slice
        ``[L, len(keys), bs, 2, H, W]`` in chain order (pool-native
        format, i.e. already through the kv_pack codec for quantized
        pools)."""
        for i, key in enumerate(keys):
            p = np.ascontiguousarray(payload[:, i])
            s = (np.ascontiguousarray(scales[:, i])
                 if scales is not None else None)
            nb = self._entry_bytes(p, s)
            if nb > self.capacity_bytes:
                self.stats["rejected_oversize"] += 1
                continue
            old = self._chains.pop(key, None)
            if old is not None:
                self._bytes -= self._entry_bytes(*old)
            self._evict_to_fit(nb)
            self._chains[key] = (p, s)
            self._bytes += nb
            self.stats["chain_blocks_out"] += 1
        self._hub.counter_add("serve.host_tier_pages_out", len(keys),
                              labels=self._metric_labels)
        self._gauges()

    def has_block(self, key: str) -> bool:
        return key in self._chains

    def take_block(self, key: str
                   ) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Remove and return a chain block's contents for page-in (move
        semantics: once re-registered in the device prefix cache the host
        copy is redundant; re-eviction pages it out again)."""
        ent = self._chains.pop(key, None)
        if ent is None:
            return None
        self._bytes -= self._entry_bytes(*ent)
        self.stats["chain_blocks_in"] += 1
        self._hub.counter_add("serve.host_tier_pages_in",
                              labels=self._metric_labels)
        self._gauges()
        return ent

    # -- sessions (paged-out live sequences) ---------------------------

    def put_session(self, sess: PagedSession) -> bool:
        """Park a paged-out session; False when it can never fit (the
        caller then falls back to preempt-and-requeue recompute)."""
        nb = sess.nbytes
        if nb > self.capacity_bytes:
            self.stats["rejected_oversize"] += 1
            return False
        old = self._sessions.pop(sess.uid, None)
        if old is not None:
            self._bytes -= old.nbytes
        self._evict_to_fit(nb)
        self._sessions[sess.uid] = sess
        self._bytes += nb
        self.stats["sessions_out"] += 1
        self._hub.counter_add("serve.host_tier_pages_out", sess.n_blocks,
                              labels=self._metric_labels)
        self._gauges()
        return True

    def has_session(self, uid: int) -> bool:
        return uid in self._sessions

    def peek_session(self, uid: int) -> Optional[PagedSession]:
        """Inspect a parked session without moving it (no LRU touch, no
        page-in accounting) — admission sizes its device reclaim against
        ``n_blocks`` before committing to the pop."""
        return self._sessions.get(uid)

    def pop_session(self, uid: int) -> Optional[PagedSession]:
        sess = self._sessions.pop(uid, None)
        if sess is None:
            return None
        self._bytes -= sess.nbytes
        self.stats["sessions_in"] += 1
        self._hub.counter_add("serve.host_tier_pages_in", sess.n_blocks,
                              labels=self._metric_labels)
        self._gauges()
        return sess

    # -- introspection -------------------------------------------------

    def holds_chain_prefix(self, cache, tokens) -> int:
        """How many full blocks of ``tokens``'s prefix this tier (or the
        device cache it backs) can serve without prefill — the fleet
        router's placement signal: prefer the replica already holding a
        returning session's blocks. ``cache`` is the engine's
        PrefixCache (owns the chain-key function)."""
        toks = np.asarray(tokens, np.int32).ravel()
        bs = cache.block_size
        prev: Optional[str] = None
        hits = 0
        for i in range(max(0, (len(toks) - 1) // bs)):
            key = cache.chain_key(prev, toks[i * bs:(i + 1) * bs])
            if cache.get(key) is None and key not in self._chains:
                break
            hits += 1
            prev = key
        return hits

    def snapshot(self) -> Dict[str, int]:
        return dict(self.stats, used_bytes=self._bytes,
                    capacity_bytes=self.capacity_bytes,
                    chain_blocks=len(self._chains),
                    sessions=len(self._sessions),
                    total_blocks=self.total_blocks)
