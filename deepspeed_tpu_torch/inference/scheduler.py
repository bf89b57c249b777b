"""Dynamic SplitFuse token scheduler (port of
``deepspeed_tpu/inference/scheduler.py``).

Dynamic SplitFuse composes each forward from (a) one decode token per
running sequence and (b) prompt *chunks* that fill the remaining token
budget, so every step has near-constant compute.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.ragged.sequence import (SequenceDescriptor,
                                                           StateManager)


class SplitFuseScheduler:
    def __init__(self, state: StateManager, max_tokens_per_step: int = 256,
                 max_seqs_per_step: int = 32):
        self.state = state
        self.max_tokens = max_tokens_per_step
        self.max_seqs = max_seqs_per_step
        # cumulative token mix plus the last step's occupancy.
        # prefill_starvation_steps counts steps where at least one
        # pending-prefill sequence got no chunk because budget/slots ran
        # out — sustained growth means the token budget is undersized
        # for the arrival rate.
        self.stats = {"steps": 0, "decode_tokens": 0, "prefill_tokens": 0,
                      "kv_starved_skips": 0, "prefill_starvation_steps": 0}
        self.last_scheduled_seqs = 0
        self.last_scheduled_tokens = 0
        # rotating start for the prefill scan: insertion order alone lets
        # an early long prompt re-win the tail budget every step and
        # starve later arrivals
        self._prefill_rr = 0

    def schedule(self) -> List[Tuple[SequenceDescriptor, np.ndarray, int]]:
        """Pick (seq, new_tokens, start_pos) chunks for the next step.

        Decode tokens first (latency), then prefill chunks fill the budget
        (throughput) — the SplitFuse recipe.
        """
        budget = self.max_tokens
        slots = self.max_seqs
        out: List[Tuple[SequenceDescriptor, np.ndarray, int]] = []

        # decode: the last generated (or last prompt) token advances the seq
        for seq in self.state.seqs.values():
            if budget <= 0 or slots <= 0:
                break
            if not seq.in_decode or seq.done:
                continue
            if not self.state.ensure_capacity(seq, seq.seen_tokens + 1):
                self.stats["kv_starved_skips"] += 1
                continue  # KV OOM: leave for a later step
            tok = (seq.generated[-1] if seq.generated
                   else int(seq.input_tokens[-1]))
            out.append((seq, np.asarray([tok], np.int32), seq.seen_tokens))
            self.stats["decode_tokens"] += 1
            budget -= 1
            slots -= 1

        # prefill chunks (a chunk that reaches the end of the prompt makes
        # the engine sample that step's last-token logits); the scan
        # starts at a rotating offset so budget leftovers round-robin
        # over waiting prompts instead of always feeding the oldest
        pending_seqs = [s for s in self.state.seqs.values()
                        if s.pending_prefill > 0 and not s.done]
        if pending_seqs:
            start = self._prefill_rr % len(pending_seqs)
            self._prefill_rr += 1
            pending_seqs = pending_seqs[start:] + pending_seqs[:start]
        scheduled_prefills = 0
        for seq in pending_seqs:
            if budget <= 0 or slots <= 0:
                break
            chunk = min(seq.pending_prefill, budget)
            if not self.state.ensure_capacity(seq, seq.seen_tokens + chunk):
                self.stats["kv_starved_skips"] += 1
                continue
            toks = seq.input_tokens[seq.seen_tokens:seq.seen_tokens + chunk]
            out.append((seq, toks.astype(np.int32), seq.seen_tokens))
            self.stats["prefill_tokens"] += chunk
            budget -= chunk
            slots -= 1
            scheduled_prefills += 1
        if scheduled_prefills < len(pending_seqs) and (budget <= 0
                                                       or slots <= 0):
            self.stats["prefill_starvation_steps"] += 1
        self.stats["steps"] += 1
        self.last_scheduled_seqs = len(out)
        self.last_scheduled_tokens = self.max_tokens - budget
        return out
