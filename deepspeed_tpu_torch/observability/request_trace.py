"""Per-request serving traces with SLO-miss attribution (copy of
``deepspeed_tpu/observability/request_trace.py``, host-only Python).

The serving histograms (hub: ``serve.ttft_seconds`` etc.) can say p99
TTFT is 900 ms, not *why*: queue wait, prefill compute, a preemption
round trip, or a cold prefix. This module gives every serving request a
trace id and a typed span timeline — ENQUEUE, ADMIT, PREFILL (per
chunk), DECODE_EMIT, SPEC_DRAFT/SPEC_ACCEPT, PREFIX_HIT,
PREEMPT/REQUEUE, FINISH — recorded by the engine's emit points
(inference/engine_v2.py, inference/scheduler.py) into a bounded ring
with TAIL-BASED sampling: the keep/drop decision happens at FINISH,
when the request's fate is known, so every SLO violator is kept and
only a configurable random slice of the healthy bulk pays the ring
slot. Active requests cost one list append per span either way — that
is what makes the in-flight state dumpable on a crash (the tracer
registers a flight-recorder dump context).

On top sits the SLO attribution report (the serving analogue of
``observability/attribution.py``): each traced request's TTFT and e2e
wall time decompose into **queue_wait / prefill / decode / preempted /
spec_overhead** phases via a state-machine walk over the span
timeline, so the phases sum to the measured wall time by construction.
:func:`slo_attribution` aggregates the traces into a "why did p99
miss" table (dominant phase per missed request, per-phase percentiles)
rendered by :func:`slo_attribution_markdown`. Finished
traces also feed per-phase hub histograms
(``serve.phase_<name>_seconds``) so the decomposition exports through
the existing Prometheus/JSONL sinks.

Phase semantics:

- ``queue_wait`` — first ENQUEUE to first ADMIT (admission-queue wait).
- ``prefill``   — ADMIT to first emitted token while no token has been
  emitted yet (includes scheduling wait for prefill chunks — exactly
  the non-queue part of TTFT).
- ``decode``    — time between token emissions after the first token.
- ``preempted`` — PREEMPT to re-ADMIT requeue wait, plus (for requests
  preempted after their first token) the re-prefill recompute until the
  next emission: the full cost of the round trip.
- ``spec_overhead`` — the share of speculative verify rounds spent on
  rejected drafts, carved out of ``decode`` (decode + spec_overhead
  together cover the emission gaps).

Clock domains: every timestamp here comes from :func:`clocksync.
wall_time` — identical to ``time.time()`` unless a skew is injected.
A trace produced in another process (a fleet worker) lives in that
process's clock domain until :meth:`RequestTrace.rebase` shifts it by
the per-channel estimated offset; spans whose duration is smaller than
the offset estimate's uncertainty bound are flagged
``clock_uncertain=true`` rather than silently presented as ordered.

All host-side.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from deepspeed_tpu_torch.observability.clocksync import wall_time as _wall

# Typed span kinds (the on-wire vocabulary; chrome_trace.py renders one
# lane per request from these).
SPAN_KINDS = (
    "ENQUEUE", "ADMIT", "PREFILL", "DECODE_EMIT", "SPEC_DRAFT",
    "SPEC_ACCEPT", "PREFIX_HIT", "PREEMPT", "REQUEUE", "KV_STARVED",
    "ROUTE", "HANDOFF", "FAILOVER", "FINISH",
)

PHASES = ("queue_wait", "prefill", "decode", "preempted", "spec_overhead")


@dataclasses.dataclass
class Span:
    """One typed event on a request's timeline. ``ts`` is the span
    start (wall clock, same base as the flight recorder); ``dur_ms`` is
    0 for instant markers."""

    kind: str
    ts: float
    dur_ms: float = 0.0
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = {"kind": self.kind, "ts": self.ts}
        if self.dur_ms:
            d["dur_ms"] = round(self.dur_ms, 4)
        if self.fields:
            d.update(self.fields)
        return d


@dataclasses.dataclass
class RequestTrace:
    """The full lifecycle of one serving request."""

    trace_id: str
    uid: int
    prompt_tokens: int = 0
    spans: List[Span] = dataclasses.field(default_factory=list)
    enqueue_ts: float = 0.0
    first_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    status: str = "active"  # active | finished | truncated | flushed
    generated_tokens: int = 0
    prefix_hit_tokens: int = 0
    preemptions: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_overhead_ms: float = 0.0
    # set by rebase(): which process's clock produced the original
    # timestamps, the offset that was subtracted, and its uncertainty.
    # None means the trace never crossed a clock domain — to_dict emits
    # no clock keys then, keeping pre-clocksync output bit-exact.
    clock_domain: Optional[str] = None
    clock_offset_s: float = 0.0
    clock_uncertainty_s: float = 0.0

    def add(self, kind: str, ts: float, dur_ms: float = 0.0,
            **fields) -> None:
        self.spans.append(Span(kind, ts, dur_ms, fields))

    def rebase(self, offset_s: float, uncertainty_s: float = 0.0,
               domain: Optional[str] = None) -> "RequestTrace":
        """Shift every timestamp out of the producing process's clock
        domain into the caller's: ``local_ts = peer_ts - offset_s``
        (``offset_s`` = peer minus local, the
        clocksync.ClockSyncEstimator convention). Spans shorter than
        the offset's uncertainty bound get ``clock_uncertain=true`` —
        their *internal* ordering against same-domain neighbors is
        exact, but their placement against the other domain is not, and
        pretending otherwise is how misordered timelines ship. Returns
        self (ingest-path chaining)."""
        off = float(offset_s)
        unc = float(uncertainty_s)
        self.enqueue_ts -= off
        if self.first_token_ts is not None:
            self.first_token_ts -= off
        if self.finish_ts is not None:
            self.finish_ts -= off
        for s in self.spans:
            s.ts -= off
            if s.dur_ms and unc * 1e3 > s.dur_ms:
                s.fields["clock_uncertain"] = True
        self.clock_domain = domain
        self.clock_offset_s += off
        self.clock_uncertainty_s = max(self.clock_uncertainty_s, unc)
        return self

    # -- measurements --------------------------------------------------

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.enqueue_ts

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finish_ts is None:
            return None
        return self.finish_ts - self.enqueue_ts

    def phases(self, until: Optional[float] = None) -> Dict[str, float]:
        """Decompose wall time from first ENQUEUE up to ``until``
        (default: FINISH, falling back to the last span) into the five
        PHASES. The walk attributes every inter-event gap to exactly one
        phase, so ``sum(phases.values())`` equals the decomposed wall
        time by construction (spec_overhead is carved out of decode,
        never added on top)."""
        out = {p: 0.0 for p in PHASES}
        spans = sorted(self.spans, key=lambda s: s.ts)
        if not spans:
            return out
        end = until
        if end is None:
            end = (self.finish_ts if self.finish_ts is not None
                   else spans[-1].ts)
        cur = "queue_wait"
        last_ts = spans[0].ts
        emitted = False
        spec_overhead_ms = 0.0
        for sp in spans:
            ts = min(sp.ts, end)
            if ts > last_ts:
                out[cur] += ts - last_ts
                last_ts = ts
            if sp.ts > end:
                break
            if sp.kind == "ADMIT":
                cur = "prefill" if not emitted else "preempted"
            elif sp.kind == "DECODE_EMIT":
                emitted = True
                cur = "decode"
                spec_overhead_ms += float(
                    sp.fields.get("spec_overhead_ms", 0.0))
            elif sp.kind == "PREEMPT":
                cur = "preempted"
        if end > last_ts:
            out[cur] += end - last_ts
        # rejected-draft verify work is a decode sub-cost: carve it out
        # so the five phases still sum to the same wall time
        carve = min(out["decode"], spec_overhead_ms / 1e3)
        out["decode"] -= carve
        out["spec_overhead"] = carve
        return out

    def ttft_phases(self) -> Dict[str, float]:
        """The TTFT decomposition: phases up to the first emitted token
        (all zero when no token was ever emitted)."""
        if self.first_token_ts is None:
            return {p: 0.0 for p in PHASES}
        return self.phases(until=self.first_token_ts)

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "trace_id": self.trace_id,
            "uid": self.uid,
            "status": self.status,
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "preemptions": self.preemptions,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "enqueue_ts": self.enqueue_ts,
            "first_token_ts": self.first_token_ts,
            "finish_ts": self.finish_ts,
            "ttft_s": self.ttft_s,
            "e2e_s": self.e2e_s,
            "phases": {k: round(v, 6) for k, v in self.phases().items()},
            "ttft_phases": {k: round(v, 6)
                            for k, v in self.ttft_phases().items()},
            "spans": [s.to_dict() for s in self.spans],
        }
        if self.clock_domain is not None:
            d["clock_domain"] = self.clock_domain
            d["clock_offset_s"] = round(self.clock_offset_s, 9)
            d["clock_uncertainty_s"] = round(self.clock_uncertainty_s, 9)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RequestTrace":
        t = cls(trace_id=d["trace_id"], uid=int(d["uid"]),
                prompt_tokens=int(d.get("prompt_tokens", 0)),
                enqueue_ts=float(d.get("enqueue_ts", 0.0)),
                first_token_ts=d.get("first_token_ts"),
                finish_ts=d.get("finish_ts"),
                status=d.get("status", "finished"),
                generated_tokens=int(d.get("generated_tokens", 0)),
                prefix_hit_tokens=int(d.get("prefix_hit_tokens", 0)),
                preemptions=int(d.get("preemptions", 0)),
                spec_drafted=int(d.get("spec_drafted", 0)),
                spec_accepted=int(d.get("spec_accepted", 0)))
        if d.get("clock_domain") is not None:
            t.clock_domain = str(d["clock_domain"])
            t.clock_offset_s = float(d.get("clock_offset_s", 0.0))
            t.clock_uncertainty_s = float(
                d.get("clock_uncertainty_s", 0.0))
        for s in d.get("spans", []):
            fields = {k: v for k, v in s.items()
                      if k not in ("kind", "ts", "dur_ms")}
            t.spans.append(Span(s["kind"], float(s["ts"]),
                                float(s.get("dur_ms", 0.0)), fields))
        return t


class RequestTracer:
    """Emit-point sink + tail-sampled ring of finished request traces.

    Thread-safety matches the serving engine (single-threaded step
    loop); the ring swap under ``finished()`` takes a lock only because
    tooling may read it from another thread. Every ``on_*`` method is a
    cheap no-op when ``enabled`` is False.
    """

    def __init__(self, enabled: bool = True, sample_rate: float = 0.05,
                 ring_size: int = 4096,
                 slo_deadline_ms: Optional[float] = None,
                 seed: int = 0, hub=None, flight=None):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.ring_size = int(ring_size)
        self.slo_deadline_ms = slo_deadline_ms
        self._rng = random.Random(seed)
        self._active: Dict[int, RequestTrace] = {}
        self._ring: deque = deque(maxlen=max(1, self.ring_size))
        self._lock = threading.Lock()
        self._n_started = 0
        self.stats = {"started": 0, "finished": 0, "kept": 0,
                      "dropped": 0, "slo_misses": 0}
        self._hub = hub
        self._flight = flight
        # an SLO burn-rate alerter (anything with ``observe_trace(t,
        # now=)``), fed one observation per finished trace; JAX's
        # BurnRateAlerter comes with ROADMAP queue A item 14's fleet part
        self.alerter = None
        if flight is not None:
            self.attach_flight(flight)

    # -- construction helpers ------------------------------------------

    @classmethod
    def from_config(cls, cfg: Any = None, hub=None,
                    flight=None) -> "RequestTracer":
        """Build from an ``observability.request_trace`` config block
        (RequestTraceConfig, dict, or None for defaults), with env
        overrides: ``DSTPU_REQUEST_TRACE=0`` disables,
        ``DSTPU_REQ_TRACE_SAMPLE`` / ``DSTPU_REQ_TRACE_RING`` /
        ``DSTPU_REQ_TRACE_SLO_MS`` override the knobs."""
        get = (cfg.get if isinstance(cfg, dict)
               else lambda k, d=None: getattr(cfg, k, d))
        enabled = bool(get("enabled", True)) if cfg is not None else True
        sample = float(get("sample_rate", 0.05)) if cfg is not None else 0.05
        ring = int(get("ring_size", 4096)) if cfg is not None else 4096
        slo = get("slo_deadline_ms", None) if cfg is not None else None
        env = os.environ.get
        if env("DSTPU_REQUEST_TRACE") is not None:
            enabled = env("DSTPU_REQUEST_TRACE") not in ("0", "false", "")
        if env("DSTPU_REQ_TRACE_SAMPLE"):
            sample = float(env("DSTPU_REQ_TRACE_SAMPLE"))
        if env("DSTPU_REQ_TRACE_RING"):
            ring = int(env("DSTPU_REQ_TRACE_RING"))
        if env("DSTPU_REQ_TRACE_SLO_MS"):
            slo = float(env("DSTPU_REQ_TRACE_SLO_MS"))
        return cls(enabled=enabled, sample_rate=sample, ring_size=ring,
                   slo_deadline_ms=slo, hub=hub, flight=flight)

    def attach_flight(self, flight) -> None:
        """Register the in-flight request state as crash-dump context:
        a flight-recorder dump (exception/SIGTERM/watchdog) includes the
        live request timelines, so a wedged serve step shows *which*
        requests were in flight and what phase each was in."""
        self._flight = flight
        add = getattr(flight, "add_dump_context", None)
        if add is not None:
            add("requests_in_flight", self._inflight_summary)

    def _inflight_summary(self) -> List[Dict[str, Any]]:
        out = []
        for t in list(self._active.values()):
            out.append({"trace_id": t.trace_id, "uid": t.uid,
                        "status": t.status,
                        "prompt_tokens": t.prompt_tokens,
                        "generated_tokens": t.generated_tokens,
                        "preemptions": t.preemptions,
                        "age_s": round(_wall() - t.enqueue_ts, 4),
                        "last_span": (t.spans[-1].to_dict()
                                      if t.spans else None),
                        "phases": {k: round(v, 4)
                                   for k, v in t.phases(
                                       until=_wall()).items()}})
        return out

    # -- emit points ----------------------------------------------------

    def active(self, uid: int) -> Optional[RequestTrace]:
        return self._active.get(uid)

    def on_enqueue(self, uid: int, prompt_tokens: int,
                   queue_depth: int = 0) -> Optional[RequestTrace]:
        if not self.enabled:
            return None
        old = self._active.pop(uid, None)
        if old is not None:
            # uid reuse while a trace is still open (caller recycled the
            # uid without finishing): close the old one out
            self._finish_trace(old, "superseded", _wall())
        self._n_started += 1
        self.stats["started"] += 1
        now = _wall()
        t = RequestTrace(trace_id=f"req-{uid}-{self._n_started}", uid=uid,
                         prompt_tokens=int(prompt_tokens), enqueue_ts=now)
        t.add("ENQUEUE", now, prompt_tokens=int(prompt_tokens),
              queue_depth=int(queue_depth))
        self._active[uid] = t
        return t

    def on_admit(self, uid: int, wait_s: float = 0.0,
                 requeued: bool = False) -> None:
        t = self._active.get(uid) if self.enabled else None
        if t is None:
            return
        now = _wall()
        t.add("ADMIT", now, wait_s=round(wait_s, 6), requeued=bool(requeued))
        if requeued and self._hub is not None:
            # queue re-entry latency of a preemption round trip,
            # measurable end-to-end (PREEMPT span -> this ADMIT)
            self._hub.histogram("serve.requeue_wait_seconds").observe(
                wait_s)

    def on_prefix_hit(self, uid: int, tokens: int) -> None:
        t = self._active.get(uid) if self.enabled else None
        if t is None:
            return
        t.prefix_hit_tokens += int(tokens)
        t.add("PREFIX_HIT", _wall(), tokens=int(tokens))

    def on_prefill(self, uid: int, start: float, dur_ms: float,
                   tokens: int, start_pos: int) -> None:
        t = self._active.get(uid) if self.enabled else None
        if t is None:
            return
        t.add("PREFILL", start, dur_ms=dur_ms, tokens=int(tokens),
              start_pos=int(start_pos))

    def on_emit(self, uid: int, n_tokens: int,
                spec_overhead_ms: float = 0.0) -> None:
        t = self._active.get(uid) if self.enabled else None
        if t is None:
            return
        now = _wall()
        first = t.first_token_ts is None
        if first:
            t.first_token_ts = now
        t.generated_tokens += int(n_tokens)
        fields: Dict[str, Any] = {"n": int(n_tokens)}
        if first:
            fields["first"] = True
        if spec_overhead_ms > 0.0:
            fields["spec_overhead_ms"] = round(spec_overhead_ms, 4)
            t.spec_overhead_ms += spec_overhead_ms
        t.add("DECODE_EMIT", now, **fields)

    def on_spec(self, uid: int, drafted: int, accepted: int) -> None:
        t = self._active.get(uid) if self.enabled else None
        if t is None:
            return
        now = _wall()
        t.spec_drafted += int(drafted)
        t.spec_accepted += int(accepted)
        t.add("SPEC_DRAFT", now, n=int(drafted))
        t.add("SPEC_ACCEPT", now, n=int(accepted))

    def on_preempt(self, uid: int, reason: str,
                   generated: int = 0) -> None:
        t = self._active.get(uid) if self.enabled else None
        if t is None:
            return
        now = _wall()
        t.preemptions += 1
        t.add("PREEMPT", now, reason=reason, generated=int(generated))
        t.add("REQUEUE", now, reason=reason)

    def note(self, uid: int, kind: str, **fields) -> None:
        """Zero-duration marker on the request lane (e.g. the
        scheduler's KV_STARVED skips)."""
        t = self._active.get(uid) if self.enabled else None
        if t is None:
            return
        t.add(kind, _wall(), **fields)

    def on_finish(self, uid: int, status: str = "finished") -> None:
        t = self._active.pop(uid, None) if self.enabled else None
        if t is None:
            return
        self._finish_trace(t, status, _wall())

    # -- finish / sampling ----------------------------------------------

    def _finish_trace(self, t: RequestTrace, status: str,
                      now: float) -> None:
        t.finish_ts = now
        t.status = status
        t.add("FINISH", now, status=status)
        self.stats["finished"] += 1
        miss = self.is_slo_miss(t)
        if miss:
            self.stats["slo_misses"] += 1
        if self._hub is not None:
            for phase, secs in t.phases().items():
                self._hub.histogram(
                    f"serve.phase_{phase}_seconds").observe(secs)
            if t.e2e_s is not None:
                self._hub.histogram("serve.e2e_seconds").observe(t.e2e_s)
            if miss:
                self._hub.counter_add("serve.slo_misses")
        if self._flight is not None:
            self._flight.record(
                "request_finish", trace_id=t.trace_id, uid=t.uid,
                status=status, slo_miss=miss,
                ttft_ms=(round(t.ttft_s * 1e3, 3)
                         if t.ttft_s is not None else None),
                e2e_ms=(round(t.e2e_s * 1e3, 3)
                        if t.e2e_s is not None else None),
                tokens=t.generated_tokens, preemptions=t.preemptions)
        if self.alerter is not None:
            self.alerter.observe_trace(t, now=now)
        # tail-based sampling: the drop decision happens HERE, with the
        # outcome known — every violator is kept, the healthy bulk is
        # down-sampled, and a dropped trace costs nothing further
        if miss or self._rng.random() < self.sample_rate:
            with self._lock:
                self._ring.append(t)
            self.stats["kept"] += 1
        else:
            self.stats["dropped"] += 1

    def is_slo_miss(self, t: RequestTrace) -> bool:
        """A request misses the SLO when its TTFT exceeds the deadline
        (or it never produced a first token at all, given a deadline)."""
        if self.slo_deadline_ms is None:
            return False
        if t.ttft_s is None:
            return t.status != "active"
        return t.ttft_s * 1e3 > float(self.slo_deadline_ms)

    # -- access ---------------------------------------------------------

    def finished(self, last: int = 0) -> List[RequestTrace]:
        with self._lock:
            out = list(self._ring)
        return out[-last:] if last > 0 else out

    def in_flight(self) -> int:
        return len(self._active)

    def reset(self) -> None:
        """Drop ring + counters (bench warmup boundary). Active traces
        survive — requests in flight keep their timelines."""
        with self._lock:
            self._ring.clear()
        for k in self.stats:
            self.stats[k] = 0

    def snapshot(self) -> Dict[str, Any]:
        return dict(self.stats, enabled=self.enabled,
                    sample_rate=self.sample_rate,
                    ring_size=self.ring_size,
                    slo_deadline_ms=self.slo_deadline_ms,
                    ring_len=len(self._ring),
                    in_flight=len(self._active))

    def dump_jsonl(self, path: str) -> str:
        """Write every kept trace as one JSON line (the schema
        JAX package's ``tools/serve_top.py report`` consumes)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for t in self.finished():
                d = t.to_dict()
                # stamp the tracer's deadline + verdict on every line so
                # an offline reader can reproduce
                # the miss set without being told the SLO
                d["slo_deadline_ms"] = self.slo_deadline_ms
                d["slo_miss"] = self.is_slo_miss(t)
                f.write(json.dumps(d, default=str) + "\n")
        os.replace(tmp, path)
        return path


def load_traces_jsonl(path: str) -> List[RequestTrace]:
    out: List[RequestTrace] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(RequestTrace.from_dict(json.loads(line)))
            except (json.JSONDecodeError, KeyError):
                continue
    return out


# -- SLO attribution ---------------------------------------------------------


def _percentiles(vals: List[float]) -> Dict[str, float]:
    if not vals:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0}
    s = sorted(vals)

    def pct(p: float) -> float:
        if len(s) == 1:
            return s[0]
        k = (len(s) - 1) * p / 100.0
        lo = int(k)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (k - lo)

    return {"p50": round(pct(50), 6), "p99": round(pct(99), 6),
            "mean": round(sum(s) / len(s), 6)}


def slo_attribution(traces: Iterable[RequestTrace],
                    deadline_s: Optional[float] = None) -> Dict[str, Any]:
    """Aggregate finished traces into the "why did p99 miss" report.

    For every trace: TTFT + e2e phase decompositions. For every
    missed-deadline trace: the dominant TTFT phase (the answer to "what
    ate the deadline"). The report is JSON-serializable (embedded in
    a benchmark's output) and renders as a table via
    :func:`slo_attribution_markdown`."""
    traces = [t for t in traces if t.finish_ts is not None]
    rows: List[Dict[str, Any]] = []
    phase_vals: Dict[str, List[float]] = {p: [] for p in PHASES}
    miss_phase_vals: Dict[str, List[float]] = {p: [] for p in PHASES}
    dominant: Dict[str, int] = {}
    misses = 0
    for t in traces:
        ph = t.phases()
        tph = t.ttft_phases()
        miss = (deadline_s is not None and t.ttft_s is not None
                and t.ttft_s > deadline_s)
        if deadline_s is not None and t.ttft_s is None:
            miss = True  # never reached first token: worst miss
        row = {"trace_id": t.trace_id, "uid": t.uid, "status": t.status,
               "ttft_s": (round(t.ttft_s, 6)
                          if t.ttft_s is not None else None),
               "e2e_s": round(t.e2e_s, 6),
               "slo_miss": miss,
               "preemptions": t.preemptions,
               "prefix_hit_tokens": t.prefix_hit_tokens,
               "generated_tokens": t.generated_tokens,
               "phases": {k: round(v, 6) for k, v in ph.items()},
               "ttft_phases": {k: round(v, 6) for k, v in tph.items()}}
        if miss:
            misses += 1
            # dominant phase of the TTFT window: what to fix first
            dom = max(tph, key=lambda k: tph[k]) if any(
                tph.values()) else "queue_wait"
            row["dominant_phase"] = dom
            dominant[dom] = dominant.get(dom, 0) + 1
            for p in PHASES:
                miss_phase_vals[p].append(tph[p])
        for p in PHASES:
            phase_vals[p].append(ph[p])
        rows.append(row)
    return {
        "schema": "slo_attribution/v1",
        "deadline_s": deadline_s,
        "requests": len(traces),
        "slo_misses": misses,
        "phases": PHASES,
        "phase_seconds": {p: _percentiles(v)
                          for p, v in phase_vals.items()},
        "miss_ttft_phase_seconds": {p: _percentiles(v)
                                    for p, v in miss_phase_vals.items()},
        "miss_dominant_phase": dict(sorted(dominant.items(),
                                           key=lambda kv: -kv[1])),
        "ttft": _percentiles([t.ttft_s for t in traces
                              if t.ttft_s is not None]),
        "e2e": _percentiles([t.e2e_s for t in traces]),
        "requests_detail": rows,
    }


def slo_attribution_markdown(report: Dict[str, Any]) -> str:
    """Render the report as the "why did p99 miss" table."""
    lines = []
    dl = report.get("deadline_s")
    lines.append(f"## SLO attribution — {report['requests']} requests, "
                 f"{report['slo_misses']} misses"
                 + (f" (TTFT deadline {dl * 1e3:.0f} ms)"
                    if dl is not None else ""))
    lines.append("")
    lines.append("| phase | all p50 (ms) | all p99 (ms) | "
                 "miss-TTFT p50 (ms) | miss-TTFT p99 (ms) |")
    lines.append("|---|---|---|---|---|")
    for p in report["phases"]:
        a = report["phase_seconds"][p]
        m = report["miss_ttft_phase_seconds"][p]
        lines.append(f"| {p} | {a['p50'] * 1e3:.2f} | {a['p99'] * 1e3:.2f}"
                     f" | {m['p50'] * 1e3:.2f} | {m['p99'] * 1e3:.2f} |")
    dom = report.get("miss_dominant_phase") or {}
    if dom:
        lines.append("")
        lines.append("Dominant phase of missed requests: "
                     + ", ".join(f"{k} ({v})" for k, v in dom.items()))
    return "\n".join(lines)


def check_phase_closure(traces: Iterable[RequestTrace],
                        rel_tol: float = 0.05,
                        abs_tol_s: float = 0.002) -> Dict[str, Any]:
    """Regression check for the trace math: for every finished trace, the phase
    decomposition must sum to the measured e2e wall time — and the TTFT
    decomposition to the measured TTFT — within
    ``max(rel_tol * measured, abs_tol_s)``. Raises AssertionError with
    the worst offender on failure; returns a summary dict on success."""
    checked = 0
    worst = 0.0
    for t in traces:
        if t.finish_ts is None:
            continue
        e2e = t.e2e_s
        gap = abs(sum(t.phases().values()) - e2e)
        tol = max(rel_tol * e2e, abs_tol_s)
        assert gap <= tol, (
            f"{t.trace_id}: phases sum off by {gap * 1e3:.3f} ms "
            f"(e2e {e2e * 1e3:.3f} ms, tol {tol * 1e3:.3f} ms)")
        worst = max(worst, gap)
        if t.ttft_s is not None:
            tgap = abs(sum(t.ttft_phases().values()) - t.ttft_s)
            ttol = max(rel_tol * t.ttft_s, abs_tol_s)
            assert tgap <= ttol, (
                f"{t.trace_id}: TTFT phases sum off by "
                f"{tgap * 1e3:.3f} ms (ttft {t.ttft_s * 1e3:.3f} ms)")
            worst = max(worst, tgap)
        checked += 1
    return {"checked": checked, "worst_gap_ms": round(worst * 1e3, 4),
            "rel_tol": rel_tol}
