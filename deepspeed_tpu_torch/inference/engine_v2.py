"""FastGen-style ragged continuous-batching engine (port of
``deepspeed_tpu/inference/engine_v2.py``, one device, no mesh).

Host-side state (StateManager / BlockedAllocator / PrefixCache /
SplitFuseScheduler) assembles dense int metadata per step
(ragged_batch.py); the runner (model_runner.py) appends KV in place and
attends through the paged kernels. ``put`` queues requests,
``serve_step`` runs one round (at temperature 0: a speculative verify
round when drafts are available, else a multi-token greedy decode burst
when every live sequence is decoding; else one SplitFuse step), and
``generate_all`` drives rounds until every request finishes.

Speculative decoding (``spec_decode`` / ``drafter``; ``spec_decode.py``):
each verify round runs every live sequence's [last token, drafts...]
chunk through the paged prefill kernel over its paged history
(``_plan_prefill_segments`` and ``ragged_prefill_forward``, as the
prefill steps do) and keeps the longest prefix of drafts that matches
the model's argmax chain plus one bonus token, so greedy output is
token-identical with speculation on or off. ``spec_adaptive_k`` picks
each request's draft length from its measured acceptance and the batch
occupancy.

Quantized serving: ``kv_quant_bits`` (8, 4, "fp8") stores the KV pool
as codes plus one fp32 scale per head vector; ``quantize_weights="int8"``
holds the matmul weights as int8 blocks (``weight_quant.py``);
``host_kv_tier`` pages cold prefix chains and preempted or explicitly
paged-out sessions (``page_out``) to host memory in the pool's own
format, and resumes them without re-prefill. The same knobs come in
through ``serving=ServingConfig(...)``.

Observability (JAX ``engine_v2.py:268-303``): the serving histograms
(``serve.ttft_seconds``, ``serve.decode_token_seconds``,
``serve.step_seconds``, ``serve.admission_wait_seconds``,
``serve.spec_accepted_len``), counters and gauges in the process-wide
hub at JAX's emit points, one flight record a serve step, and the
per-request tracer (``observability/request_trace.py``:
``request_trace`` takes the ``observability.request_trace`` block or a
dict; tail-sampled span timelines and SLO attribution). All of it is
host work per step and per request; none of it touches the card.
``log_summary``, ``request_traces`` and ``snapshot`` read it back.

Not ported yet (ROADMAP queue A): session migration and the handoff
wire (item 13; ``snapshot`` has no ``handoff_wire`` key), tensor
parallelism, and the journal.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch._device import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference import model_runner
from deepspeed_tpu_torch.inference.ragged import (BlockedAllocator,
                                                  BlockedKVCache, HostKVTier,
                                                  KVCacheConfig, PagedSession,
                                                  PrefixCache, StateManager,
                                                  build_ragged_batch)
from deepspeed_tpu_torch.inference.scheduler import SplitFuseScheduler
from deepspeed_tpu_torch.inference.spec_decode import PromptLookupDrafter
from deepspeed_tpu_torch.inference.weight_quant import quantize_params
from deepspeed_tpu_torch.models.transformer import TransformerLM
from deepspeed_tpu_torch.observability.clocksync import wall_time
from deepspeed_tpu_torch.observability.flight_recorder import (
    get_flight_recorder, install_crash_handlers)
from deepspeed_tpu_torch.observability.hub import get_hub
from deepspeed_tpu_torch.observability.request_trace import RequestTracer
from deepspeed_tpu_torch.utils import telemetry
from deepspeed_tpu_torch.utils.logging import log_dist

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
    # a preemption victim back in the queue (its ADMIT span is a requeue)
    requeued: bool = False
    # the victim's KV is parked in the host tier (ragged/kv_tier.py):
    # admission restores blocks and resumes decode instead of
    # re-prefilling; ``tokens`` carries the folded history anyway as the
    # fallback if the tier spills the session before readmission
    paged: bool = False


class InferenceEngineV2:
    """Serve a ``TransformerLM`` (dense, or an ``MoETransformerLM``, whose
    layers the runner sends through the MoE dispatch) with ragged
    continuous batching on one device. ``device=None`` is the card (an
    error without CUDA); the model's weights must already live on that
    device.

    ``quantize_weights="int8"`` quantizes the model's eligible weights in
    place as the engine takes them: each full-precision leaf's storage is
    released once its int8 codes exist, so the model itself can no longer
    run its own forward. ``serving`` (a ``config.ServingConfig``), when
    given, supplies ``prefix_cache``, ``decode_steps``,
    ``max_queue_depth``, ``kv_quant_bits``, ``host_kv_tier``,
    ``host_tier_mb`` and the speculation knobs (``spec_decode``,
    ``spec_k``, ``spec_ngram``, ``spec_adaptive_k``,
    ``spec_accept_alpha``) in place of the keyword arguments.

    ``spec_decode`` drafts with prompt lookup (``spec_ngram``); a
    ``drafter`` (anything with ``propose(tokens, k)``) replaces it and
    turns speculation on. ``spec_k`` is the most drafts a sequence
    verifies a round. ``request_trace`` configures the request tracer
    (the ``observability.request_trace`` block or a dict; env overrides
    as in JAX); ``metric_labels`` tags every ``serve.*`` series of this
    engine (a replica id)."""

    def __init__(self, model: TransformerLM, kv_blocks: int = 256,
                 kv_block_size: int = 16, max_tokens_per_step: int = 128,
                 max_seqs_per_step: int = 16, max_blocks_per_seq: int = 32,
                 decode_steps: int = 8, prefix_cache: bool = True,
                 max_queue_depth: Optional[int] = None,
                 kv_quant_bits: Optional[object] = None,
                 quantize_weights: Optional[str] = None,
                 host_kv_tier: bool = False, host_tier_mb: int = 256,
                 spec_decode: bool = False, spec_k: int = 4,
                 spec_ngram: int = 3, drafter: Optional[Any] = None,
                 spec_adaptive_k: bool = False,
                 spec_accept_alpha: float = 0.25,
                 serving: Optional[Any] = None,
                 request_trace: Optional[Any] = None,
                 metric_labels: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None):
        if serving is not None:
            # the config block is the source of truth for config-driven
            # deployments (its own validation already ran)
            prefix_cache = serving.prefix_cache
            decode_steps = serving.decode_steps
            max_queue_depth = serving.max_queue_depth
            kv_quant_bits = serving.kv_quant_bits
            host_kv_tier = serving.host_kv_tier
            host_tier_mb = serving.host_tier_mb
            spec_decode = serving.spec_decode
            spec_k = serving.spec_k
            spec_ngram = serving.spec_ngram
            spec_adaptive_k = serving.spec_adaptive_k
            spec_accept_alpha = serving.spec_accept_alpha
        if quantize_weights not in (None, "int8"):
            raise ValueError(f"quantize_weights supports 'int8', got "
                             f"{quantize_weights!r}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model weights live on {model.device}, the "
                             f"engine runs on {self.device}")
        self.model, self.cfg = model, model.config
        self.params = model.params()
        if quantize_weights is not None:
            # weight-only int8: each leaf's full-precision storage goes as
            # soon as its codes exist, so the two trees never coexist
            self.params = quantize_params(self.params)

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
        # per-replica metric labels: engines in one process tag their
        # serve.* series so aggregation never collapses them into one
        self._metric_labels = dict(metric_labels) if metric_labels else None
        # shared-prefix KV reuse: full blocks whose content-hash chain
        # matches a cached prefix are shared by reference and skip prefill
        if prefix_cache:
            self.kv_cache.prefix_cache = PrefixCache(
                kv_block_size, metric_labels=self._metric_labels)
        # host-memory KV tier: KV pressure PAGES blocks out (in the pool's
        # own storage format) instead of evicting them — cold prefix
        # chains and preempted sessions come back without re-prefill
        if host_kv_tier:
            self.kv_cache.host_tier = HostKVTier(
                capacity_bytes=int(host_tier_mb) << 20,
                metric_labels=self._metric_labels)

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
                      "prefix_hit_tokens": 0, "burst_steps": 0,
                      "spec_steps": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "spec_backoff_rounds": 0,
                      # verify rounds on the paged prefill kernel, and
                      # those the padding rule sent to the gather path
                      "spec_verify_kernel_rounds": 0,
                      "spec_verify_gather_fallbacks": 0,
                      "paged_out": 0, "paged_in": 0,
                      "warm_resume_tokens": 0}
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
        # speculative decoding: prompt-lookup drafts (or the caller's
        # drafter) verified a round at a time; greedy acceptance keeps the
        # stream token-identical to plain greedy
        self.spec_k = max(1, int(spec_k))
        self._drafter = drafter if drafter is not None else (
            PromptLookupDrafter(max_ngram=spec_ngram) if spec_decode
            else None)
        # adaptive draft length: each request's k from its acceptance
        # EWMA (the global one until it has its own) and the batch
        # occupancy; off is the fixed-k path
        self._spec_adaptive = bool(spec_adaptive_k)
        self._spec_alpha = float(spec_accept_alpha)
        self._spec_accept_ewma: Optional[float] = None    # global
        self._seq_accept_ewma: Dict[int, float] = {}      # per request
        self._spec_wasted_verify_tokens = 0
        # the j-th draft's expected yield is a^j: draft while a^j >= cut,
        # where the cut rises with occupancy (at full occupancy verify
        # rows crowd out real decode tokens)
        self._spec_cut_base = 0.25
        self._spec_load_gain = 3.0
        # request-latency observability: the histograms live in the
        # process-wide hub so serving percentiles land on the same
        # Prometheus page as training metrics
        self._hub = get_hub()
        lbl = self._metric_labels
        self._ttft_hist = self._hub.histogram("serve.ttft_seconds",
                                              labels=lbl)
        self._decode_hist = self._hub.histogram("serve.decode_token_seconds",
                                                labels=lbl)
        self._step_hist = self._hub.histogram("serve.step_seconds",
                                              labels=lbl)
        self._admission_hist = self._hub.histogram(
            "serve.admission_wait_seconds", labels=lbl)
        self._spec_hist = self._hub.histogram("serve.spec_accepted_len",
                                              labels=lbl)
        # serving shares the crash flight recorder: a wedged serve step
        # dumps the last admits and steps as a training hang does
        self._flight = get_flight_recorder()
        install_crash_handlers()
        # per-request span timelines, tail-sampled at FINISH; the tracer
        # registers the in-flight requests as crash-dump context
        self.tracer = RequestTracer.from_config(
            request_trace, hub=self._hub, flight=self._flight)
        self.scheduler.tracer = self.tracer
        self._burst_tokens = 0
        self._burst_capacity = 0

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
            self._hub.counter_add("serve.requests", labels=self._metric_labels)
            self.tracer.on_enqueue(uid, len(toks),
                                   queue_depth=len(self._queue))
        self._admit_from_queue()
        self._hub.gauge("serve.queue_wait_depth", len(self._queue),
                        labels=self._metric_labels)

    def _admit_from_queue(self) -> None:
        """Admit waiting requests strictly FIFO while capacity lasts.
        Strict head-of-line order keeps big prompts from starving behind
        a stream of small ones; the rotation fairness lives in the
        scheduler's prefill scan instead."""
        now = time.perf_counter()
        while self._queue and self.can_schedule(len(self._queue[0].tokens)):
            req = self._queue.popleft()
            if req.paged:
                outcome = self._try_page_in(req, now)
                if outcome == "stall":
                    # the session's blocks don't fit RIGHT NOW (live
                    # pressure): keep FIFO order and retry next round
                    self._queue.appendleft(req)
                    break
                if outcome == "resumed":
                    continue
                # tier spilled the session: fall through — ``tokens``
                # carries the folded history for prefix recompute
            seq = self.state.get_or_create(req.uid, req.tokens,
                                           req.max_new_tokens)
            seq.prior_generated = req.prior_generated
            self.tracer.on_admit(req.uid, wait_s=now - req.enqueue_time,
                                 requeued=req.requeued)
            skipped = self.state.attach_prefix(seq)
            if skipped:
                self.stats["prefix_hit_tokens"] += skipped
                self._hub.counter_add("serve.prefix_hit_tokens", skipped,
                                      labels=self._metric_labels)
                self.tracer.on_prefix_hit(req.uid, skipped)
            if req.admit_time is not None:
                self._admit_time[req.uid] = req.admit_time
            self._admission_hist.observe(now - req.enqueue_time)
            self.stats["admitted"] += 1
        self._hub.gauge("serve.queue_wait_depth", len(self._queue),
                        labels=self._metric_labels)

    def _release_seq(self, uid: int) -> Optional[float]:
        """The ONE sequence-teardown path: frees state + KV and pops the
        latency maps. Returns the pending admit time, if TTFT was still
        unmeasured, for requeue to carry forward."""
        self.state.release(uid)
        admit = self._admit_time.pop(uid, None)
        self._last_emit_time.pop(uid, None)
        self._seq_accept_ewma.pop(uid, None)
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
            self.tracer.on_finish(seq.uid, "truncated")
            self._release_seq(seq.uid)
            log_dist(f"uid={seq.uid} at per-seq KV cap on preemption: "
                     "truncated", ranks=[0])
            return
        self.tracer.on_preempt(seq.uid, reason=reason,
                               generated=len(seq.generated))
        prior = seq.prior_generated + len(seq.generated)
        admit = self._release_seq(seq.uid)
        self._queue.appendleft(_QueuedRequest(
            uid=seq.uid, tokens=tokens, max_new_tokens=seq.max_new_tokens,
            enqueue_time=time.perf_counter(), prior_generated=prior,
            admit_time=admit, requeued=True))
        self.stats["preempted"] += 1
        self.stats["preempt_reasons"][reason] = \
            self.stats["preempt_reasons"].get(reason, 0) + 1
        self.stats["requeued"] += 1
        self._count_preempted(reason)

    def _count_preempted(self, reason: str) -> None:
        self._hub.counter_add("serve.preempted", labels=self._metric_labels)
        self._hub.counter_add(f"serve.preempted_reason.{reason}",
                              labels=self._metric_labels)
        self._hub.gauge("serve.queue_wait_depth", len(self._queue),
                        labels=self._metric_labels)

    def _page_out(self, seq, reason: str = "paged_out") -> bool:
        """Preempt ``seq`` by PAGING its KV to the host tier instead of
        discarding it: block contents copy out in pool-native format (a
        byte copy, bit-exact round trip) with the descriptor state, and
        the request requeues at the queue front flagged ``paged``.
        Readmission restores the blocks and resumes *decode*: no
        re-prefill, token stream identical to a never-paged run. False
        when paging doesn't apply (no tier, mid-prefill, at the per-seq
        cap, or session oversize for the tier): the caller falls back to
        ``_requeue`` recompute."""
        tier = self.kv_cache.host_tier
        if tier is None or seq.pending_prefill or seq.seen_tokens <= 0:
            return False
        if (self.kv_cache.blocks_needed(seq.total_tokens + 1)
                > self.max_blocks_per_seq):
            return False  # could never regrow: _requeue owns truncation
        # the blocks holding real KV: a burst or rejected speculative
        # drafts may have grown the block list past the accepted
        # frontier, and those trailing blocks hold nothing to keep
        keep = self.kv_cache.blocks_needed(seq.seen_tokens)
        if keep <= 0 or keep > len(seq.kv_blocks):
            return False
        payload, scales = self.kv_cache.read_blocks_host(
            np.asarray(seq.kv_blocks[:keep], np.int64))
        sess = PagedSession(
            uid=seq.uid,
            input_tokens=np.asarray(seq.input_tokens, np.int32),
            generated=list(seq.generated),
            seen_tokens=seq.seen_tokens,
            max_new_tokens=seq.max_new_tokens,
            prior_generated=seq.prior_generated,
            payload=payload, scales=scales,
            admit_time=self._admit_time.get(seq.uid),
            spec_accept_ewma=self._seq_accept_ewma.get(seq.uid))
        if not tier.put_session(sess):
            return False
        self.tracer.on_preempt(seq.uid, reason=reason,
                               generated=len(seq.generated))
        # folded history rides in the queued request as the fallback: if
        # the tier spills the session before readmission, admission
        # degrades to the ordinary prefix-recompute path
        tokens = np.concatenate(
            [np.asarray(seq.input_tokens, np.int32),
             np.asarray(seq.generated, np.int32)])
        prior = seq.prior_generated + len(seq.generated)
        admit = self._release_seq(seq.uid)
        self._queue.appendleft(_QueuedRequest(
            uid=seq.uid, tokens=tokens, max_new_tokens=seq.max_new_tokens,
            enqueue_time=time.perf_counter(), prior_generated=prior,
            admit_time=admit, requeued=True, paged=True))
        self.stats["preempted"] += 1
        self.stats["preempt_reasons"][reason] = \
            self.stats["preempt_reasons"].get(reason, 0) + 1
        self.stats["paged_out"] += 1
        self._count_preempted(reason)
        return True

    def _try_page_in(self, req: _QueuedRequest, now: float) -> str:
        """Warm-resume a ``paged`` queued request from the host tier.
        Returns ``"resumed"`` (decode continues, zero prefill),
        ``"stall"`` (session present but the pool can't take its blocks
        this round — keep queue order, retry later), or ``"recompute"``
        (the tier spilled the session; the folded tokens re-prefill)."""
        tier = self.kv_cache.host_tier
        sess = tier.peek_session(req.uid) if tier is not None else None
        if sess is None:
            return "recompute"
        keep = sess.n_blocks
        if keep > self.kv_cache.free_blocks:
            self.kv_cache.reclaim(keep - self.kv_cache.free_blocks)
        if keep > self.kv_cache.free_blocks:
            return "stall"
        sess = tier.pop_session(req.uid)
        seq = self.state.get_or_create(sess.uid, sess.input_tokens,
                                       sess.max_new_tokens)
        seq.generated = list(sess.generated)
        seq.prior_generated = sess.prior_generated
        seq.seen_tokens = sess.seen_tokens
        blocks = self.kv_cache.allocator.allocate(keep)
        seq.kv_blocks = np.asarray(blocks, np.int64)
        self.kv_cache.write_blocks(blocks, sess.payload, sess.scales)
        seq.resumed_from_tier = keep
        if sess.spec_accept_ewma is not None:
            self._seq_accept_ewma[sess.uid] = float(sess.spec_accept_ewma)
        self.stats["paged_in"] += 1
        self.stats["admitted"] += 1
        self.stats["warm_resume_tokens"] += sess.seen_tokens
        self._hub.counter_add("serve.warm_resume_tokens", sess.seen_tokens,
                              labels=self._metric_labels)
        self.tracer.on_admit(req.uid, wait_s=now - req.enqueue_time,
                             requeued=True)
        if sess.admit_time is not None:
            self._admit_time[req.uid] = sess.admit_time
        elif req.admit_time is not None:
            self._admit_time[req.uid] = req.admit_time
        self._admission_hist.observe(now - req.enqueue_time)
        return "resumed"

    def page_out(self, uid: int) -> bool:
        """Explicitly park a live sequence's KV in the host tier (e.g. a
        session going idle between turns). The request re-enters the
        admission queue flagged ``paged`` and warm-resumes when capacity
        allows. False when paging doesn't apply — the sequence stays
        live."""
        seq = self.state.seqs.get(uid)
        if seq is None or seq.done:
            return False
        return self._page_out(seq, reason="explicit_page_out")

    def holds_prefix_blocks(self, tokens) -> int:
        """How many full prefix blocks of ``tokens`` this engine can serve
        without prefill, counting both the device prefix cache and the
        host tier behind it."""
        cache = self.kv_cache.prefix_cache
        if cache is None:
            return 0
        toks = np.asarray(tokens, np.int32).ravel()
        tier = self.kv_cache.host_tier
        if tier is not None:
            return tier.holds_chain_prefix(cache, toks)
        keys, _ = cache.lookup(toks, max_tokens=max(0, len(toks) - 1))
        return len(keys)

    # -- steps ----------------------------------------------------------------

    def step(self, temperature: float = 0.0, seed: int = 0,
             eos_token_id: Optional[int] = None) -> Dict[int, int]:
        """Run one SplitFuse step. Returns {uid: new_token} for sequences
        that produced a token this step."""
        t0 = time.perf_counter()
        self._admit_from_queue()
        scheduled = self.scheduler.schedule()
        self._release_finished()
        if not scheduled:
            # all live sequences starved for KV (pool exhausted mid-decode):
            # preempt the last-admitted sequence so the others can progress
            live = [s for s in self.state.seqs.values() if not s.done]
            if len(live) > 1 or (live and self._queue):
                # page to the host tier when one is attached (decode
                # resumes without re-prefill); recompute-requeue is the
                # fallback when paging doesn't apply
                if not self._page_out(live[-1]):
                    self._requeue(live[-1])
            elif live:
                # a lone sequence the pool cannot grow for: requeueing
                # would readmit it into the same wall, so end it
                victim = live[0]
                log_dist(
                    f"KV pool exhausted by lone uid={victim.uid}: "
                    "truncated (pool smaller than one request)", ranks=[0])
                victim.done = True
                victim.truncated = True
                self.stats["truncated"] += 1
                self.tracer.on_finish(victim.uid, "truncated")
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
                self.stats["fallback_reasons"]["padding"] += 1
                # warned once per reason, then counted (log_summary(),
                # telemetry.get())
                telemetry.count(
                    "serve.prefill_gather_fallback",
                    "padding: paged prefill fell "
                    "back to the gather path — flat-layout serve step, "
                    "no paged kernel; see log_summary()")
            else:
                self.stats["prefill_kernel_steps"] += 1
            # the share of mixed prefill steps that lost the paged kernel
            # to the gather path, per replica
            attempts = (self.stats["prefill_gather_fallbacks"]
                        + self.stats["prefill_kernel_steps"])
            self._hub.gauge(
                "serve.paged_fallback_ratio",
                self.stats["prefill_gather_fallbacks"] / max(1, attempts),
                labels=self._metric_labels)
        elif decode_only:
            self.stats["decode_kernel_steps"] += 1

        kv = self.kv_cache.kv_state
        if seg_plan is not None:
            n_segs = seg_plan[0].shape[0]
            logits, new_kv = model_runner.ragged_prefill_forward(
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
            logits, new_kv = model_runner.ragged_decode_forward(
                self.cfg, self.params, kv, self._dev(d_tok),
                self._dev(d_pos), self._dev(batch.block_table),
                self._dev(batch.ctx_lens))
        else:
            logits, new_kv = model_runner.ragged_forward(
                self.cfg, self.params, kv, self._dev(batch.token_ids),
                self._dev(batch.token_seq), self._dev(batch.token_pos),
                self._dev(batch.block_table), batch.num_tokens)
        self.kv_cache.set_kv_state(new_kv)

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
        self._step_hist.observe(now - t0)
        self._flight.record("serve_step", tokens=batch.num_tokens,
                            emitted=len(emitted),
                            wall_ms=round((now - t0) * 1000.0, 3))
        if self.tracer.enabled:
            # one PREFILL span per prompt chunk this step advanced, its
            # start backdated by the step wall (on the tracer's clock)
            wall_ms = (now - t0) * 1e3
            t_start = wall_time() - (now - t0)
            for seq, new_tokens, start_pos in scheduled:
                if start_pos < len(seq.input_tokens):
                    self.tracer.on_prefill(seq.uid, t_start, wall_ms,
                                           tokens=len(new_tokens),
                                           start_pos=start_pos)
        for uid in emitted:
            self._note_emitted(uid, 1, now)
        self._update_serve_gauges()
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
            self.tracer.on_finish(
                seq.uid, "truncated" if seq.truncated else "finished")
            self._release_seq(seq.uid)

    def _note_emitted(self, uid: int, n_tokens: int, now: float,
                      spec_overhead_ms: float = 0.0) -> None:
        """Fold ``n_tokens`` just-emitted tokens of ``uid`` into the
        latency samples and histograms: the first token of a request is
        its TTFT; later tokens record the gap since the previous
        emission. ``spec_overhead_ms`` is this request's share of a
        verify round's rejected-draft compute (its DECODE_EMIT span)."""
        self.tracer.on_emit(uid, n_tokens,
                            spec_overhead_ms=spec_overhead_ms)
        self._hub.counter_add("serve.tokens_emitted", n_tokens,
                              labels=self._metric_labels)
        admit = self._admit_time.pop(uid, None)
        last = self._last_emit_time.get(uid)
        if admit is not None:
            self.latency["ttft_s"].append(now - admit)
            self._ttft_hist.observe(now - admit)
            n_tokens -= 1
            last = now
        if last is not None and n_tokens > 0:
            per_tok = (now - last) / n_tokens
            self.latency["decode_token_s"].extend([per_tok] * n_tokens)
            for _ in range(n_tokens):
                self._decode_hist.observe(per_tok)
        self._last_emit_time[uid] = now

    def _update_serve_gauges(self) -> None:
        live = [s for s in self.state.seqs.values() if not s.done]
        lbl = self._metric_labels
        self._hub.gauge("serve.queue_depth", len(live), labels=lbl)
        self._hub.gauge("serve.queue_wait_depth", len(self._queue),
                        labels=lbl)
        self._hub.gauge("serve.pending_prefill_tokens",
                        sum(s.pending_prefill for s in live), labels=lbl)
        self._hub.gauge("serve.kv_free_blocks", self.kv_cache.free_blocks,
                        labels=lbl)
        if self.kv_cache.prefix_cache is not None:
            self._hub.gauge("serve.prefix_cached_blocks",
                            self.kv_cache.prefix_cache.cached_blocks,
                            labels=lbl)
        self._hub.gauge("serve.batch_seq_occupancy",
                        self.scheduler.last_scheduled_seqs
                        / max(1, self.max_seqs), labels=lbl)
        self._hub.gauge("serve.batch_token_occupancy",
                        self.scheduler.last_scheduled_tokens
                        / max(1, self.max_tokens), labels=lbl)
        if self._burst_capacity > 0:
            self._hub.gauge("serve.burst_efficiency",
                            self._burst_tokens / self._burst_capacity,
                            labels=lbl)

    def _try_decode_burst(self, eos_token_id: Optional[int]
                          ) -> Optional[Dict[int, List[int]]]:
        """Run ``decode_steps`` greedy tokens with one host fetch.

        Applies only in steady state: every live sequence mid-decode, no
        prefill pending, and KV capacity for the whole burst (the block
        tables are frozen for its duration). Returns None when a single
        SplitFuse step should run instead."""
        t0 = time.perf_counter()
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
        toks, new_kv = model_runner.ragged_multi_decode(
            self.cfg, self.params, self.kv_cache.kv_state, self._dev(d_tok),
            self._dev(d_pos), self._dev(bt), self._dev(ctx), steps=K)
        self.kv_cache.set_kv_state(new_kv)
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
        self._step_hist.observe(now - t0)
        # burst efficiency: tokens kept over the K x live slots computed
        self._burst_tokens += sum(len(v) for v in emitted.values())
        self._burst_capacity += K * len(live)
        for uid, toks_u in emitted.items():
            if toks_u:
                self._note_emitted(uid, len(toks_u), now)
        self._update_serve_gauges()
        self._release_finished()
        return emitted

    def _spec_round_k(self, seq, occ: float) -> int:
        """Draft length for ``seq`` this round: ``spec_k``, unless
        adaptive speculation is on. Then the j-th draft's expected yield
        is a^j (a = the request's acceptance EWMA, the global one while
        it has none) and the request drafts while a^j >= cut, where the
        cut rises with the batch occupancy ``occ``: an idle batch
        speculates hard, a full one backs off toward k = 0. Only the
        draft count changes; the accepted tokens are the argmax chain."""
        if not self._spec_adaptive:
            return self.spec_k
        cut = min(0.95, self._spec_cut_base
                  * (1.0 + self._spec_load_gain * occ))
        a = self._seq_accept_ewma.get(seq.uid, self._spec_accept_ewma)
        if a is None:
            return self.spec_k  # no signal yet: speculate optimistically
        a = min(max(a, 0.0), 0.99)
        if a <= cut:
            return 0
        return max(0, min(self.spec_k, int(math.log(cut) / math.log(a))))

    def _try_spec_step(self, eos_token_id: Optional[int]
                       ) -> Optional[Dict[int, List[int]]]:
        """One speculative greedy round: the drafter proposes up to
        ``spec_k`` tokens per sequence and ONE forward verifies them.
        Each sequence's chunk is [last real token, draft 1..k]; row j's
        argmax is the greedy token after the history and drafts[:j], so
        the longest matching draft prefix is accepted plus one bonus
        token, and every emitted token is the model's own argmax chain.

        The chunks go through the paged prefill kernel, one segment per
        sequence over its paged history (``_plan_prefill_segments``);
        the gather path runs only where that plan says the padding would
        cost too much, and is counted in
        ``stats["spec_verify_gather_fallbacks"]``. Only the greedy ids of
        the chunk rows leave the device. Returns None when a burst or a
        plain step should run instead (prefill pending, no drafts, or
        the pool cannot hold the chunks)."""
        live = [s for s in self.state.seqs.values() if not s.done]
        if (self._drafter is None or not live or len(live) > self.max_seqs
                or len(live) > self.max_tokens
                or any((not s.in_decode) or s.pending_prefill for s in live)):
            return None
        # pass 1, without side effects: propose drafts and probe capacity.
        # K/V is written for every chunk token (rejected drafts leave
        # rows past the accepted frontier that the next real token
        # overwrites), so the capacity must cover 1 + k a sequence:
        # shrink a proposal rather than trip the per-seq cap, and leave
        # the round to the plain step (which owns preemption) when the
        # pool cannot cover even the plain decode tokens
        chunks: List[np.ndarray] = []
        total = 0
        need_total = 0
        n_drafted = 0
        occ = len(live) / max(1, self.max_seqs)
        adaptive_k_sum = 0
        for s in live:
            k_round = self._spec_round_k(s, occ)
            adaptive_k_sum += k_round
            k = min(k_round, s.gen_budget_left - 1,
                    self.max_tokens - total - 1)
            drafts: List[int] = []
            if k > 0:
                drafts = list(self._drafter.propose(
                    s.input_tokens.tolist() + s.generated, k))[:k]
            while drafts and (self.kv_cache.blocks_needed(
                    s.seen_tokens + 1 + len(drafts))
                    > self.max_blocks_per_seq):
                drafts.pop()
            blocks = self.kv_cache.blocks_needed(
                s.seen_tokens + 1 + len(drafts))
            if blocks > self.max_blocks_per_seq:
                return None  # at the per-seq cap: the plain step decides
            need_total += max(0, blocks - len(s.kv_blocks))
            if drafts:
                n_drafted += 1
            t0 = (s.generated[-1] if s.generated
                  else int(s.input_tokens[-1]))
            chunks.append(np.asarray([t0] + drafts, np.int32))
            total += 1 + len(drafts)
        if n_drafted == 0:
            if self._spec_adaptive and adaptive_k_sum == 0:
                # the controller chose k = 0 across the batch (load high
                # or acceptance low): a deliberate backoff, not a miss
                self.stats["spec_backoff_rounds"] += 1
            return None  # nothing proposed: the burst path is faster
        if need_total > self.kv_cache.available_blocks:
            return None
        sched = []
        for s, chunk in zip(live, chunks):
            if not self.state.ensure_capacity(s, s.seen_tokens + len(chunk)):
                raise RuntimeError("spec capacity probe said yes but KV "
                                   "block allocation failed")
            sched.append((s, chunk, s.seen_tokens))
        t_start = time.perf_counter()
        batch = build_ragged_batch(sched, self.max_tokens, self.max_seqs,
                                   self.max_blocks_per_seq)
        kv = self.kv_cache.kv_state
        seg_plan = (self._plan_prefill_segments(sched)
                    if self._use_paged_kernel else None)
        if seg_plan is not None:
            n_segs = seg_plan[0].shape[0]
            logits, new_kv = model_runner.ragged_prefill_forward(
                self.cfg, self.params, kv, *seg_plan,
                self._dev(batch.block_table[:n_segs]))
            self.stats["spec_verify_kernel_rounds"] += 1
        else:
            logits, new_kv = model_runner.ragged_forward(
                self.cfg, self.params, kv, self._dev(batch.token_ids),
                self._dev(batch.token_seq), self._dev(batch.token_pos),
                self._dev(batch.block_table), batch.num_tokens)
            if self._use_paged_kernel:
                self.stats["spec_verify_gather_fallbacks"] += 1
        self.kv_cache.set_kv_state(new_kv)
        # the greedy id of every chunk row, 4-8 bytes a row: never the
        # [T, V] logits
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        emitted: Dict[int, List[int]] = {}
        wasted_rows: Dict[int, int] = {}
        cursor = 0
        for slot, (s, chunk, start_pos) in enumerate(sched):
            n = len(chunk)
            if seg_plan is not None:
                rows = greedy[slot, :n]
            else:
                rows = greedy[cursor:cursor + n]
                cursor += n
            emit = [int(rows[0])]
            for j in range(1, n):
                if int(chunk[j]) != emit[-1]:
                    break  # draft j left the greedy chain
                emit.append(int(rows[j]))
            self.stats["spec_proposed"] += n - 1
            self.stats["spec_accepted"] += len(emit) - 1
            # drafted / accepted counters beside the accepted-length
            # histogram, so the acceptance rate is derivable on the page
            self._hub.counter_add("serve.spec_drafted_tokens", n - 1,
                                  labels=self._metric_labels)
            self._hub.counter_add("serve.spec_accepted_tokens",
                                  len(emit) - 1, labels=self._metric_labels)
            self.tracer.on_spec(s.uid, drafted=n - 1,
                                accepted=len(emit) - 1)
            self._spec_hist.observe(len(emit) - 1)
            if n > 1:
                # measured acceptance feeds the adaptive-k controller and
                # the drafter's own counters
                rate = (len(emit) - 1) / (n - 1)
                a = self._spec_alpha
                prev = self._seq_accept_ewma.get(s.uid)
                self._seq_accept_ewma[s.uid] = (
                    rate if prev is None else a * rate + (1 - a) * prev)
                prev_g = self._spec_accept_ewma
                self._spec_accept_ewma = (
                    rate if prev_g is None else a * rate + (1 - a) * prev_g)
                note = getattr(self._drafter, "note_result", None)
                if note is not None:
                    note(n - 1, len(emit) - 1)
            # rows computed past the accepted frontier: the round's
            # wasted work (what adaptive k trims under load)
            wasted = n - len(emit)
            if wasted:
                self._spec_wasted_verify_tokens += wasted
                self._hub.counter_add("serve.spec_wasted_verify_tokens",
                                      wasted, labels=self._metric_labels)
            budget_left = s.gen_budget_left
            final: List[int] = []
            for tok in emit:
                final.append(tok)
                if eos_token_id is not None and tok == eos_token_id:
                    s.done = True
                    break
                if len(final) >= budget_left:
                    s.done = True
                    break
            s.generated.extend(final)
            s.seen_tokens = start_pos + len(final)
            emitted[s.uid] = final
            wasted_rows[s.uid] = n - len(final)
        self.stats["spec_steps"] += 1
        if self._spec_accept_ewma is not None:
            self._hub.gauge("serve.spec_accept_ewma", self._spec_accept_ewma,
                            labels=self._metric_labels)
        now = time.perf_counter()
        self._step_hist.observe(now - t_start)
        round_wall_ms = (now - t_start) * 1e3
        self._flight.record("serve_step", tokens=batch.num_tokens,
                            emitted=sum(len(v) for v in emitted.values()),
                            spec=True, wall_ms=round(round_wall_ms, 3))
        for uid, toks in emitted.items():
            if toks:
                # this request's share of the round spent on rows past
                # its accepted frontier: its decode phase's spec overhead
                self._note_emitted(
                    uid, len(toks), now,
                    spec_overhead_ms=round_wall_ms * wasted_rows[uid]
                    / max(1, batch.num_tokens))
        self._update_serve_gauges()
        self._release_finished()
        return emitted

    def serve_step(self, temperature: float = 0.0, seed: int = 0,
                   eos_token_id: Optional[int] = None
                   ) -> Dict[int, List[int]]:
        """One serving round: admit from the waiting queue, then run the
        best step for the mix: at temperature 0 a speculative verify
        round (drafts available), else a multi-token greedy burst
        (steady greedy decode); otherwise a plain SplitFuse step.
        Returns {uid: tokens emitted this round}."""
        self._admit_from_queue()
        out: Optional[Dict[int, List[int]]] = None
        if temperature == 0.0:
            out = self._try_spec_step(eos_token_id)
            if out is None:
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
        tier = self.kv_cache.host_tier
        for uid in uids:
            self.tracer.on_finish(uid, "flushed")
            self._release_seq(uid)
            if tier is not None and tier.has_session(uid):
                tier.pop_session(uid)  # flushed sessions never resume
        drop = set(uids)
        if any(r.uid in drop for r in self._queue):
            self._queue = deque(r for r in self._queue if r.uid not in drop)

    def log_summary(self) -> Dict[str, Any]:
        """Serve-path telemetry (JAX ``engine_v2.py:1442``): kernel vs
        gather-fallback step counts, with fallback reasons. A nonzero
        ``prefill_gather_fallbacks`` means prefill ran the flat gather
        path."""
        s = dict(self.stats)
        s["fallback_reasons"] = dict(self.stats["fallback_reasons"])
        s["preempt_reasons"] = dict(self.stats["preempt_reasons"])
        log_dist(f"InferenceEngineV2 summary: {s}", ranks=[0])
        return s

    def request_traces(self, last: int = 0):
        """Finished (tail-sampled) request traces — the input to
        ``slo_attribution``."""
        return self.tracer.finished(last=last)

    def snapshot(self) -> Dict[str, Any]:
        """Serving observability snapshot (JAX ``engine_v2.py:1460``):
        request-latency percentiles (TTFT, per decode token, step and
        admission wait: p50 / p95 / p99), queue and occupancy gauges, the
        kernel / fallback counters and the tracer's state. JAX's keys,
        less ``handoff_wire`` (ROADMAP queue A item 13)."""
        live = [s for s in self.state.seqs.values() if not s.done]
        out: Dict[str, Any] = {
            "ttft": self._ttft_hist.snapshot(),
            "decode_token_latency": self._decode_hist.snapshot(),
            "step_latency": self._step_hist.snapshot(),
            "admission_wait": self._admission_hist.snapshot(),
            "queue_depth": len(live),
            "queue_wait_depth": len(self._queue),
            "pending_prefill_tokens": sum(s.pending_prefill for s in live),
            "kv_free_blocks": self.kv_cache.free_blocks,
            "kv_quant_bits": self.kv_cache.quant_bits,
            "batch_seq_occupancy": (self.scheduler.last_scheduled_seqs
                                    / max(1, self.max_seqs)),
            "batch_token_occupancy": (self.scheduler.last_scheduled_tokens
                                      / max(1, self.max_tokens)),
            "scheduler": dict(self.scheduler.stats),
            "stats": dict(self.stats,
                          fallback_reasons=dict(
                              self.stats["fallback_reasons"]),
                          preempt_reasons=dict(
                              self.stats["preempt_reasons"])),
            "request_trace": self.tracer.snapshot(),
        }
        if self._burst_capacity > 0:
            out["burst_efficiency"] = (self._burst_tokens
                                       / self._burst_capacity)
        if self.kv_cache.prefix_cache is not None:
            out["prefix_cache"] = self.kv_cache.prefix_cache.snapshot()
        if self.stats["spec_proposed"] > 0:
            out["spec_drafted_tokens"] = self.stats["spec_proposed"]
            out["spec_accepted_tokens"] = self.stats["spec_accepted"]
            out["spec_acceptance_rate"] = (self.stats["spec_accepted"]
                                           / self.stats["spec_proposed"])
            out["spec_accepted_len"] = self._spec_hist.snapshot()
        if self._spec_accept_ewma is not None:
            out["spec_accept_ewma"] = self._spec_accept_ewma
        if self._spec_wasted_verify_tokens:
            out["spec_wasted_verify_tokens"] = self._spec_wasted_verify_tokens
        tier = self.kv_cache.host_tier
        if tier is not None:
            out["host_tier"] = tier.snapshot()
        if self._drafter is not None and hasattr(self._drafter, "stats"):
            out["drafter"] = dict(self._drafter.stats)
        return out


def _sample_np(logits_row: np.ndarray, temperature: float, seed: int) -> int:
    if temperature <= 0.0:
        return int(np.argmax(logits_row))
    rng = np.random.default_rng(seed)
    z = logits_row / temperature
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))
