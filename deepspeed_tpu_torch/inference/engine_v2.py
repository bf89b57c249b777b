"""FastGen-style ragged continuous-batching engine (port of
``deepspeed_tpu/inference/engine_v2.py``, one device, no mesh).

Host-side state (StateManager / BlockedAllocator / PrefixCache /
SplitFuseScheduler) assembles dense int metadata per step
(ragged_batch.py); the runner (model_runner.py) appends KV in place and
attends through the paged kernels. ``put`` queues requests,
``serve_step`` runs one round (a multi-token greedy decode burst when
every live sequence is decoding, else one SplitFuse step), and
``generate_all`` drives rounds until every request finishes.

Not ported yet (ROADMAP queue A): speculative decoding, the host KV tier
with page-out and migration, quantized KV pools, weight-only int8, tensor
parallelism, and the tracer / metrics hub / flight recorder / journal.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch._device import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference import model_runner
from deepspeed_tpu_torch.inference.ragged import (BlockedAllocator,
                                                  BlockedKVCache,
                                                  KVCacheConfig, PrefixCache,
                                                  StateManager,
                                                  build_ragged_batch)
from deepspeed_tpu_torch.inference.scheduler import SplitFuseScheduler
from deepspeed_tpu_torch.models.transformer import TransformerLM

# latency samples kept per engine (oldest dropped first)
_LATENCY_WINDOW = 4096


@dataclasses.dataclass
class _QueuedRequest:
    """A request waiting for KV admission (FIFO). Requeued preemption
    victims carry their already-generated tokens inside ``tokens`` (for
    prefix recompute) and count them via ``prior_generated``."""
    uid: int
    tokens: np.ndarray
    max_new_tokens: int
    enqueue_time: float
    prior_generated: int = 0
    # original put() time while TTFT is still unmeasured; None once the
    # request has emitted its first token (pre-preemption)
    admit_time: Optional[float] = None


class InferenceEngineV2:
    """Serve a ``TransformerLM`` (dense, or an ``MoETransformerLM``, whose
    layers the runner sends through the MoE dispatch) with ragged
    continuous batching on one device. ``device=None`` is the card (an
    error without CUDA); the model's weights must already live on that
    device."""

    def __init__(self, model: TransformerLM, kv_blocks: int = 256,
                 kv_block_size: int = 16, max_tokens_per_step: int = 128,
                 max_seqs_per_step: int = 16, max_blocks_per_seq: int = 32,
                 decode_steps: int = 8, prefix_cache: bool = True,
                 max_queue_depth: Optional[int] = None,
                 kv_quant_bits: Optional[object] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model weights live on {model.device}, the "
                             f"engine runs on {self.device}")
        self.model, self.cfg = model, model.config
        self.params = model.params()

        kv_cfg = KVCacheConfig(
            num_layers=self.cfg.num_layers, kv_heads=self.cfg.kv_heads,
            head_dim=self.cfg.head_dim, block_size=kv_block_size,
            num_blocks=kv_blocks, dtype=self.cfg.dtype,
            quant_bits=kv_quant_bits)
        self.kv_cache = BlockedKVCache(kv_cfg, device=self.device)
        # the last block is the padding-token scratch target (the runner
        # routes padded writes there): shrink the allocator so it is
        # never handed out
        self.kv_cache.allocator = BlockedAllocator(kv_blocks - 1)
        # shared-prefix KV reuse: full blocks whose content-hash chain
        # matches a cached prefix are shared by reference and skip prefill
        if prefix_cache:
            self.kv_cache.prefix_cache = PrefixCache(kv_block_size)

        self.state = StateManager(self.kv_cache,
                                  max_tracked_sequences=4 * max_seqs_per_step,
                                  max_blocks_per_seq=max_blocks_per_seq)
        self.scheduler = SplitFuseScheduler(
            self.state, max_tokens_per_step, max_seqs_per_step)
        self.max_tokens = max_tokens_per_step
        self.max_seqs = max_seqs_per_step
        self.max_blocks_per_seq = max_blocks_per_seq
        # decode-only and planned prefill steps use the paged kernels;
        # the flag stays as a manual switch (tests flip it to compare
        # against the gather path)
        self._use_paged_kernel = True
        # "vmem" stays 0: the TPU kernel's scoped-VMEM planning rule is
        # not carried over (the Hopper prefill kernel tiles query rows)
        self.stats = {"decode_kernel_steps": 0, "prefill_kernel_steps": 0,
                      "prefill_gather_fallbacks": 0,
                      "fallback_reasons": {"vmem": 0, "padding": 0},
                      "queued": 0, "admitted": 0, "preempted": 0,
                      "preempt_reasons": {},
                      "requeued": 0, "truncated": 0,
                      "prefix_hit_tokens": 0, "burst_steps": 0}
        # TTFT is put() -> first emitted token; decode latency is the gap
        # between consecutive emitted tokens of one sequence (a burst
        # spreads its round trip evenly over the tokens it produced)
        self.latency: Dict[str, Deque[float]] = {
            "ttft_s": deque(maxlen=_LATENCY_WINDOW),
            "decode_token_s": deque(maxlen=_LATENCY_WINDOW)}
        # admission queue: put() never raises on a full KV pool — requests
        # wait FIFO here and admit as blocks free up; preemption victims
        # requeue at the FRONT with their generated tokens preserved
        self._queue: Deque[_QueuedRequest] = deque()
        self._max_queue_depth = max_queue_depth
        self._admit_time: Dict[int, float] = {}
        self._last_emit_time: Dict[int, float] = {}
        # multi-step greedy decode: one burst of `decode_steps` tokens when
        # every live sequence is in steady decode (decode_steps=1 restores
        # strict per-token SplitFuse admission)
        self.decode_steps = max(1, int(decode_steps))

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- admission ----------------------------------------------------------

    def can_schedule(self, prompt_len: int) -> bool:
        """Capacity probe: would a prompt of this length admit RIGHT NOW?
        KV blocks allocate lazily (the scheduler's ensure_capacity), so
        the free list alone over-admits — count the blocks already
        COMMITTED to live sequences: each sequence's private claim at its
        current length, plus every cache-shared block once. Idle
        prefix-cached blocks stay admissible (reclaimed on demand).
        Admission also stops at ``max_seqs_per_step`` live sequences: the
        scheduler can't run more per step, and the multi-step decode path
        requires every live sequence to fit one batch."""
        blocks = self.kv_cache.blocks_needed(prompt_len + 1)
        if (blocks > self.max_blocks_per_seq
                or len(self.state.seqs) >= self.max_seqs
                or len(self.state.seqs)
                >= self.state.max_tracked_sequences):
            return False
        committed = 0
        for s in self.state.seqs.values():
            need = self.kv_cache.blocks_needed(s.total_tokens + 1)
            committed += max(need, len(s.kv_blocks)) - len(s.prefix_keys)
        cache = self.kv_cache.prefix_cache
        if cache is not None:
            committed += cache.referenced_blocks
        return blocks + committed <= self.kv_cache.allocator.total_blocks

    def put(self, uids: List[int], tokens_list: List[np.ndarray],
            max_new_tokens: int = 64) -> None:
        """Submit new sequences (uid -> prompt tokens). Requests enter a
        FIFO waiting queue and admit as KV blocks free up — a full pool
        means backpressure, never an error. Raises ValueError only for a
        prompt that can NEVER fit (per-seq block cap / total pool), and
        RuntimeError when ``max_queue_depth`` is set and the queue is
        full."""
        now = time.perf_counter()
        for uid, toks in zip(uids, tokens_list):
            toks = np.asarray(toks, np.int32).ravel()
            blocks = self.kv_cache.blocks_needed(len(toks) + 1)
            if (blocks > self.max_blocks_per_seq
                    or blocks > self.kv_cache.allocator.total_blocks):
                raise ValueError(
                    f"uid={uid}: prompt of {len(toks)} tokens needs "
                    f"{blocks} KV blocks and can never be scheduled "
                    f"(max_blocks_per_seq={self.max_blocks_per_seq}, "
                    f"pool={self.kv_cache.allocator.total_blocks})")
            if (self._max_queue_depth is not None
                    and len(self._queue) >= self._max_queue_depth):
                raise RuntimeError(
                    f"uid={uid}: admission queue full "
                    f"(max_queue_depth={self._max_queue_depth})")
            self._queue.append(_QueuedRequest(
                uid=uid, tokens=toks, max_new_tokens=max_new_tokens,
                enqueue_time=now, admit_time=now))
            self.stats["queued"] += 1
        self._admit_from_queue()

    def _admit_from_queue(self) -> None:
        """Admit waiting requests strictly FIFO while capacity lasts.
        Strict head-of-line order keeps big prompts from starving behind
        a stream of small ones; the rotation fairness lives in the
        scheduler's prefill scan instead."""
        while self._queue and self.can_schedule(len(self._queue[0].tokens)):
            req = self._queue.popleft()
            seq = self.state.get_or_create(req.uid, req.tokens,
                                           req.max_new_tokens)
            seq.prior_generated = req.prior_generated
            skipped = self.state.attach_prefix(seq)
            if skipped:
                self.stats["prefix_hit_tokens"] += skipped
            if req.admit_time is not None:
                self._admit_time[req.uid] = req.admit_time
            self.stats["admitted"] += 1

    def _release_seq(self, uid: int) -> Optional[float]:
        """The ONE sequence-teardown path: frees state + KV and pops the
        latency maps. Returns the pending admit time, if TTFT was still
        unmeasured, for requeue to carry forward."""
        self.state.release(uid)
        admit = self._admit_time.pop(uid, None)
        self._last_emit_time.pop(uid, None)
        return admit

    def _requeue(self, seq, reason: str = "pool_exhausted") -> None:
        """Preempt-and-requeue: park the victim back at the FRONT of the
        admission queue with its generated-so-far tokens folded into the
        prompt, so readmission recomputes the prefix (often straight
        from the prefix cache) and the request continues where it
        stopped — no work is discarded and nothing is dropped."""
        tokens = np.concatenate(
            [np.asarray(seq.input_tokens, np.int32),
             np.asarray(seq.generated, np.int32)])
        if (self.kv_cache.blocks_needed(len(tokens) + 1)
                > self.max_blocks_per_seq):
            # grown to the per-seq block cap: readmission could never
            # fit, so end it instead of queueing it forever
            seq.done = True
            seq.truncated = True
            self.stats["truncated"] += 1
            self._release_seq(seq.uid)
            return
        prior = seq.prior_generated + len(seq.generated)
        admit = self._release_seq(seq.uid)
        self._queue.appendleft(_QueuedRequest(
            uid=seq.uid, tokens=tokens, max_new_tokens=seq.max_new_tokens,
            enqueue_time=time.perf_counter(), prior_generated=prior,
            admit_time=admit))
        self.stats["preempted"] += 1
        self.stats["preempt_reasons"][reason] = \
            self.stats["preempt_reasons"].get(reason, 0) + 1
        self.stats["requeued"] += 1

    # -- steps ----------------------------------------------------------------

    def step(self, temperature: float = 0.0, seed: int = 0,
             eos_token_id: Optional[int] = None) -> Dict[int, int]:
        """Run one SplitFuse step. Returns {uid: new_token} for sequences
        that produced a token this step."""
        self._admit_from_queue()
        scheduled = self.scheduler.schedule()
        self._release_finished()
        if not scheduled:
            # all live sequences starved for KV (pool exhausted mid-decode):
            # preempt the last-admitted sequence so the others can progress
            live = [s for s in self.state.seqs.values() if not s.done]
            if len(live) > 1 or (live and self._queue):
                self._requeue(live[-1])
            elif live:
                # a lone sequence the pool cannot grow for: requeueing
                # would readmit it into the same wall, so end it
                victim = live[0]
                victim.done = True
                victim.truncated = True
                self.stats["truncated"] += 1
                self._release_seq(victim.uid)
            return {}
        batch = build_ragged_batch(scheduled, self.max_tokens, self.max_seqs,
                                   self.max_blocks_per_seq)
        # steady-state decode (one token per sequence): tokens line up
        # with slots, so the compact paged-kernel path applies
        decode_only = (self._use_paged_kernel
                       and all(len(nt) == 1 for _, nt, _ in scheduled))
        seg_plan = None
        if self._use_paged_kernel and not decode_only:
            seg_plan = self._plan_prefill_segments(scheduled)
            if seg_plan is None:
                self.stats["prefill_gather_fallbacks"] += 1
            else:
                self.stats["prefill_kernel_steps"] += 1
        elif decode_only:
            self.stats["decode_kernel_steps"] += 1

        kv = self.kv_cache.data
        if seg_plan is not None:
            n_segs = seg_plan[0].shape[0]
            logits, _ = model_runner.ragged_prefill_forward(
                self.cfg, self.params, kv, *seg_plan,
                self._dev(batch.block_table[:n_segs]))
        elif decode_only:
            # compact per-slot arrays: token i belongs to slot i; pad out
            # to max_seqs (token budget may be smaller than the slot budget)
            n = batch.num_tokens
            d_tok = np.zeros(self.max_seqs, np.int32)
            d_pos = np.zeros(self.max_seqs, np.int32)
            d_tok[:n] = batch.token_ids[:n]
            d_pos[:n] = batch.token_pos[:n]
            logits, _ = model_runner.ragged_decode_forward(
                self.cfg, self.params, kv, self._dev(d_tok),
                self._dev(d_pos), self._dev(batch.block_table),
                self._dev(batch.ctx_lens))
        else:
            logits, _ = model_runner.ragged_forward(
                self.cfg, self.params, kv, self._dev(batch.token_ids),
                self._dev(batch.token_seq), self._dev(batch.token_pos),
                self._dev(batch.block_table), batch.num_tokens)

        # sample on the device and fetch only token ids (greedy) or just
        # the consumed rows (stochastic), never the full [T, V] logits
        stride = logits.shape[1] if logits.dim() == 3 else 1
        flat_idx = np.zeros(self.max_seqs, np.int64)
        consumers = []
        for slot, (seq, new_tokens, start_pos) in enumerate(scheduled):
            n = len(new_tokens)
            seq.seen_tokens = start_pos + n
            # prompt blocks the step just completed become shareable
            self.state.register_prefix_blocks(seq)
            if seq.seen_tokens < len(seq.input_tokens):
                continue  # mid-prefill: no logits consumed
            if seg_plan is not None:
                flat_idx[slot] = slot * stride + (n - 1)
            elif decode_only:
                flat_idx[slot] = slot
            else:
                flat_idx[slot] = batch.last_token_index[slot]
            consumers.append((slot, seq))

        emitted: Dict[int, int] = {}
        if consumers:
            rows = logits.reshape(-1, logits.shape[-1])[self._dev(flat_idx)]
            if temperature == 0.0:
                toks_np = torch.argmax(rows.float(), dim=-1).cpu().numpy()
            else:
                rows_np = rows.float().cpu().numpy()
            for slot, seq in consumers:
                if temperature == 0.0:
                    tok = int(toks_np[slot])
                else:
                    tok = int(_sample_np(rows_np[slot], temperature,
                                         seed + slot + seq.seen_tokens))
                seq.generated.append(tok)
                emitted[seq.uid] = tok
                if eos_token_id is not None and tok == eos_token_id:
                    seq.done = True
                if seq.gen_budget_left <= 0:
                    seq.done = True
        now = time.perf_counter()
        for uid in emitted:
            self._note_emitted(uid, 1, now)
        self._release_finished()
        return emitted

    def _plan_prefill_segments(
            self, scheduled
    ) -> Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Per-slot padded chunk layout for the paged prefill kernel, or
        None when per-segment padding would outweigh the flat layout
        (then the gather path runs). Tq is bucketed to powers of two.

        The JAX engine also sends a chunk to the gather path when the TPU
        kernel's scoped-VMEM scratch would pass 4 MB (every Tq >= 128 at
        32 heads of 128); the Hopper kernel tiles query rows and has no
        such limit, so that rule is not carried over."""
        longest = max(len(nt) for _, nt, _ in scheduled)
        tq = 8
        while tq < longest:
            tq *= 2
        S = 1  # segment-count bucket: slots are ordered, so the forward
        while S < len(scheduled):  # runs on the leading S rows only
            S *= 2
        S = min(S, self.max_seqs)
        # the padded layout materializes S*tq token rows (incl. [S,tq,V]
        # fp32 logits); cap the blowup over the flat token budget
        if S * tq > 2 * self.max_tokens:
            self.stats["fallback_reasons"]["padding"] += 1
            return None
        toks = np.zeros((S, tq), np.int32)
        pos0 = np.zeros(S, np.int32)
        nreal = np.zeros(S, np.int32)
        for slot, (seq, nt, sp) in enumerate(scheduled):
            toks[slot, :len(nt)] = nt
            pos0[slot] = sp
            nreal[slot] = len(nt)
        return self._dev(toks), self._dev(pos0), self._dev(nreal)

    def _release_finished(self) -> None:
        for seq in [s for s in self.state.seqs.values() if s.done]:
            self._release_seq(seq.uid)

    def _note_emitted(self, uid: int, n_tokens: int, now: float) -> None:
        """Fold ``n_tokens`` just-emitted tokens of ``uid`` into the
        latency samples: the first token of a request is its TTFT; later
        tokens record the gap since the previous emission."""
        admit = self._admit_time.pop(uid, None)
        last = self._last_emit_time.get(uid)
        if admit is not None:
            self.latency["ttft_s"].append(now - admit)
            n_tokens -= 1
            last = now
        if last is not None and n_tokens > 0:
            per_tok = (now - last) / n_tokens
            self.latency["decode_token_s"].extend([per_tok] * n_tokens)
        self._last_emit_time[uid] = now

    def _try_decode_burst(self, eos_token_id: Optional[int]
                          ) -> Optional[Dict[int, List[int]]]:
        """Run ``decode_steps`` greedy tokens with one host fetch.

        Applies only in steady state: every live sequence mid-decode, no
        prefill pending, and KV capacity for the whole burst (the block
        tables are frozen for its duration). Returns None when a single
        SplitFuse step should run instead."""
        live = [s for s in self.state.seqs.values() if not s.done]
        if (self.decode_steps <= 1 or not live or len(live) > self.max_seqs
                or any((not s.in_decode) or s.pending_prefill for s in live)):
            return None
        # clamp the burst to the shortest remaining budget: probing
        # capacity K tokens past a sequence that only needs 1 more would
        # trip ensure_capacity's per-seq-cap kill and truncate output
        # that per-token stepping would have finished
        K = min(self.decode_steps,
                max(1, min(s.gen_budget_left for s in live)))
        if K <= 1:
            return None
        # side-effect-free capacity probe first: per-seq cap, then total
        # pool demand (a partial grab would strand blocks and push the
        # fallback step into victim preemption)
        need_total = 0
        for s in live:
            blocks = self.kv_cache.blocks_needed(s.seen_tokens + K)
            if (self.state.max_blocks_per_seq is not None
                    and blocks > self.state.max_blocks_per_seq):
                return None  # near the per-seq cap: per-token tail
            need_total += max(0, blocks - len(s.kv_blocks))
        if need_total > self.kv_cache.free_blocks:
            return None
        for s in live:
            if not self.state.ensure_capacity(s, s.seen_tokens + K):
                raise RuntimeError("capacity probe said yes but KV block "
                                   "allocation failed")
        S = self.max_seqs
        d_tok = np.zeros(S, np.int32)
        d_pos = np.zeros(S, np.int32)
        ctx = np.zeros(S, np.int32)
        bt = np.zeros((S, self.max_blocks_per_seq), np.int32)
        for i, s in enumerate(live):
            d_tok[i] = (s.generated[-1] if s.generated
                        else int(s.input_tokens[-1]))
            d_pos[i] = s.seen_tokens
            ctx[i] = s.seen_tokens + 1
            bt[i, :len(s.kv_blocks)] = s.kv_blocks
        toks, _ = model_runner.ragged_multi_decode(
            self.cfg, self.params, self.kv_cache.data, self._dev(d_tok),
            self._dev(d_pos), self._dev(bt), self._dev(ctx), steps=K)
        toks_np = toks.cpu().numpy()  # [K, S] — one fetch per K tokens
        self.stats["decode_kernel_steps"] += K
        self.stats["burst_steps"] += 1
        emitted: Dict[int, List[int]] = {}
        for i, s in enumerate(live):
            accepted = []
            budget_left = s.gen_budget_left
            for k in range(K):
                tok = int(toks_np[k, i])
                accepted.append(tok)
                if eos_token_id is not None and tok == eos_token_id:
                    s.done = True
                    break
                if len(accepted) >= budget_left:
                    s.done = True
                    break
            s.generated.extend(accepted)
            s.seen_tokens += len(accepted)
            emitted[s.uid] = accepted
        now = time.perf_counter()
        for uid, toks_u in emitted.items():
            if toks_u:
                self._note_emitted(uid, len(toks_u), now)
        self._release_finished()
        return emitted

    def serve_step(self, temperature: float = 0.0, seed: int = 0,
                   eos_token_id: Optional[int] = None
                   ) -> Dict[int, List[int]]:
        """One serving round: admit from the waiting queue, then run a
        multi-token greedy burst (steady greedy decode) or a plain
        SplitFuse step. Returns {uid: tokens emitted this round}."""
        self._admit_from_queue()
        out: Optional[Dict[int, List[int]]] = None
        if temperature == 0.0:
            out = self._try_decode_burst(eos_token_id)
        if out is None:
            emitted = self.step(temperature, seed, eos_token_id)
            out = {uid: [tok] for uid, tok in emitted.items()}
        return out

    def generate_all(self, temperature: float = 0.0, seed: int = 0,
                     eos_token_id: Optional[int] = None,
                     max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive serve_step until every submitted sequence finishes
        (including requests still waiting in the admission queue);
        returns {uid: generated tokens}."""
        results: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if not self.state.seqs and not self._queue:
                break
            # every round makes progress: emits tokens, advances a
            # prefill, admits from the queue, or preempts a starved
            # sequence — so this loop terminates
            for uid, toks in self.serve_step(
                    temperature, seed, eos_token_id).items():
                results.setdefault(uid, []).extend(toks)
        return results

    def flush(self, uids: List[int]) -> None:
        """Drop sequences + free KV; covers queued-but-unadmitted
        requests too."""
        for uid in uids:
            self._release_seq(uid)
        drop = set(uids)
        if any(r.uid in drop for r in self._queue):
            self._queue = deque(r for r in self._queue if r.uid not in drop)


def _sample_np(logits_row: np.ndarray, temperature: float, seed: int) -> int:
    if temperature <= 0.0:
        return int(np.argmax(logits_row))
    rng = np.random.default_rng(seed)
    z = logits_row / temperature
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))
