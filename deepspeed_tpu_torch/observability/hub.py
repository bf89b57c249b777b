"""Process-wide metrics hub (port of
``deepspeed_tpu/observability/hub.py``).

Every signal the runtime already produces — step timing, loss/grad-norm,
executed collective volume (utils/comms_logging), capability-fallback
counters (utils/telemetry), serving latencies (inference/engine_v2) —
flows through one registry with three export paths:

* ``record_step`` keeps a bounded in-memory history of ``StepTrace``
  rows and mirrors the headline numbers into gauges;
* a JSON-lines sink streams every row to disk as it happens;
* a Prometheus text snapshot is rewritten (atomically) on a cadence for
  textfile-collector scraping.

The hub is a singleton (``get_hub``): training engine, serving engine
and user code in one process share the registry, so one Prometheus page
shows the whole picture. Sinks attach via :meth:`configure` (config
block or ``DSTPU_METRICS_JSONL`` / ``DSTPU_METRICS_PROM`` env vars).

Compile visibility: JAX counts XLA compilations with a monitoring
listener. The port's counterpart of a compilation is a JIT build of a
kernel library (``ops/build.py``: one ``nvcc`` per CUDA source;
``ops/native/builder.py``: the host library), which reports itself and
its seconds through :func:`note_compile`. ``StepTrace.compile_events``
> 0 on a mid-run step is then a build in the middle of training, as a
silent retrace is in JAX. The fleet publisher
(``observability.run_dir`` / ``DSTPU_RUN_DIR``) is ROADMAP queue A item
14's fleet part and raises.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.observability.histogram import Histogram
from deepspeed_tpu_torch.observability.sinks import (JSONLSink, PrometheusTextSink,
                                               labeled_name,
                                               render_prometheus)
from deepspeed_tpu_torch.observability.step_trace import StepTrace
from deepspeed_tpu_torch.utils.logging import logger

# process-global compile accounting: the kernel builders report to
# module state rather than a hub instance (a build may run before any hub
# exists, and reset_hub() must not lose it)
_COMPILE_LOCK = threading.Lock()
_COMPILE_EVENTS = 0
_COMPILE_SECS = 0.0

FLEET_ITEM = ("ROADMAP queue A item 14's fleet part (the fleet publisher, "
              "aggregator and run-directory shards)")


def note_compile(seconds: float, events: int = 1) -> None:
    """Count ``events`` JIT builds that took ``seconds`` in all (the
    kernel builders call this; JAX's compile listener)."""
    global _COMPILE_EVENTS, _COMPILE_SECS
    with _COMPILE_LOCK:
        _COMPILE_EVENTS += int(events)
        _COMPILE_SECS += float(seconds)


def compile_stats() -> Dict[str, float]:
    with _COMPILE_LOCK:
        return {"events": _COMPILE_EVENTS, "secs": _COMPILE_SECS}


class MetricsHub:
    def __init__(self, step_history: int = 512):
        self._lock = threading.Lock()
        self.gauges: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.step_history: deque = deque(maxlen=step_history)
        self._jsonl: Optional[JSONLSink] = None
        self._prom: Optional[PrometheusTextSink] = None
        self._prom_every = 10  # steps between Prometheus snapshot rewrites
        self._last_comm_totals: Dict[str, float] = {}
        self._last_fallbacks: Dict[str, float] = {}
        self._last_compile = compile_stats()

    # -- configuration -------------------------------------------------
    def configure(self, obs_config=None, rank=None) -> None:
        """Attach sinks from the config block and/or env vars. Safe to
        call more than once (a second engine in the process reuses the
        already-attached sinks). A run dir (``observability.run_dir`` /
        ``DSTPU_RUN_DIR``, JAX's fleet publisher) raises
        NotImplementedError: the fleet layer is not ported."""
        run_dir = os.environ.get("DSTPU_RUN_DIR") or getattr(
            obs_config, "run_dir", None)
        if run_dir:
            raise NotImplementedError(
                f"observability.run_dir / DSTPU_RUN_DIR={run_dir!r}: "
                f"{FLEET_ITEM}")
        jsonl = os.environ.get("DSTPU_METRICS_JSONL") or getattr(
            obs_config, "jsonl_path", None)
        prom = os.environ.get("DSTPU_METRICS_PROM") or getattr(
            obs_config, "prometheus_path", None)
        hist = int(getattr(obs_config, "step_history", 0) or 0)
        every = int(getattr(obs_config, "prometheus_every_steps", 0) or 0)
        with self._lock:
            if jsonl and (self._jsonl is None or self._jsonl.path != jsonl):
                self._jsonl = JSONLSink(jsonl)
            if prom and (self._prom is None or self._prom.path != prom):
                self._prom = PrometheusTextSink(prom)
            if every > 0:
                self._prom_every = every
            if hist > 0 and hist != self.step_history.maxlen:
                self.step_history = deque(self.step_history, maxlen=hist)

    # -- primitive metrics ---------------------------------------------
    # ``labels`` composes a distinct series per label set
    # (``serve.queue_depth{replica="r0"}``) — fleet serving metrics use
    # it so aggregation never collapses N replicas into one series; the
    # Prometheus renderer understands the composed keys (sinks.py)
    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
        if labels:
            name = labeled_name(name, labels)
        with self._lock:
            self.gauges[name] = float(value)

    def counter_add(self, name: str, n: float = 1.0,
                    labels: Optional[Dict[str, str]] = None) -> None:
        if labels:
            name = labeled_name(name, labels)
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + n

    def histogram(self, name: str,
                  labels: Optional[Dict[str, str]] = None,
                  **kw) -> Histogram:
        if labels:
            name = labeled_name(name, labels)
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(name, **kw)
            return h

    # -- step traces -----------------------------------------------------
    def comm_deltas(self) -> (dict, dict):
        """(cumulative, delta-since-last-call) executed collective bytes
        by op — empty when the comms logger is disabled."""
        try:
            from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

            totals = get_comms_logger().totals()
        except Exception:
            totals = {}
        delta = {k: v - self._last_comm_totals.get(k, 0.0)
                 for k, v in totals.items()
                 if v != self._last_comm_totals.get(k, 0.0)}
        self._last_comm_totals = dict(totals)
        return totals, delta

    def compile_delta(self) -> Dict[str, float]:
        now = compile_stats()
        delta = {"events": now["events"] - self._last_compile["events"],
                 "secs": now["secs"] - self._last_compile["secs"]}
        self._last_compile = now
        return delta

    def fallback_delta(self) -> Dict[str, float]:
        """Capability-fallback counters (utils/telemetry) that moved
        since the last call — empty in the steady state, so exporting
        the delta costs nothing per step."""
        try:
            from deepspeed_tpu_torch.utils import telemetry

            now = telemetry.snapshot()
        except Exception:
            return {}
        delta = {k: v - self._last_fallbacks.get(k, 0)
                 for k, v in now.items()
                 if v != self._last_fallbacks.get(k, 0)}
        self._last_fallbacks = {k: float(v) for k, v in now.items()}
        return delta

    def record_step(self, trace: StepTrace) -> None:
        with self._lock:
            self.step_history.append(trace)
            self.gauges["train.step"] = trace.step
            self.gauges["train.step_seconds"] = trace.wall_ms / 1000.0
            for name, val in (("train.loss", trace.loss),
                              ("train.grad_norm", trace.grad_norm),
                              ("train.lr", trace.lr),
                              ("train.tokens_per_sec", trace.tokens_per_sec),
                              ("train.tokens_per_sec_per_chip",
                               trace.tokens_per_sec_per_chip),
                              ("train.mfu", trace.mfu),
                              ("train.host_gap_ms", trace.host_gap_ms)):
                if val is not None:
                    self.gauges[name] = float(val)
            self.counters["train.steps"] = \
                self.counters.get("train.steps", 0.0) + 1.0
            if trace.tokens:
                self.counters["train.tokens"] = \
                    self.counters.get("train.tokens", 0.0) + trace.tokens
            if trace.overflow:
                self.counters["train.overflow_steps"] = \
                    self.counters.get("train.overflow_steps", 0.0) + 1.0
            if trace.compile_events:
                self.counters["jit.compile_events"] = \
                    self.counters.get("jit.compile_events", 0.0) \
                    + trace.compile_events
        self.histogram("train.step_seconds").observe(trace.wall_ms / 1000.0)
        # capability downgrades land on the same dashboard as throughput:
        # moved telemetry counters mirror into hub counters (-> Prometheus
        # as dstpu_fallback_*_total) and emit one JSONL event per change
        fb = self.fallback_delta()
        for name, d in fb.items():
            self.counter_add(f"fallback.{name}", d)
        if fb:
            self.record_event("capability_fallback", step=trace.step,
                              delta=fb)
        if self._jsonl is not None:
            self._jsonl.write(trace.to_dict())
        if self._prom is not None and \
                trace.step % max(1, self._prom_every) == 0:
            self.write_prometheus()

    def record_event(self, kind: str, **fields) -> None:
        """Free-form JSONL row (watchdog reports, trace markers, ...)."""
        if self._jsonl is not None:
            self._jsonl.write(dict(fields, kind=kind))

    # -- export ----------------------------------------------------------
    def mean_mfu(self, last_n: int = 0) -> Optional[float]:
        """Mean MFU over the most recent ``last_n`` traced steps (all
        history when 0); None when no step carried an MFU."""
        with self._lock:
            rows = list(self.step_history)
        if last_n > 0:
            rows = rows[-last_n:]
        vals = [t.mfu for t in rows if t.mfu is not None]
        if not vals:
            return None
        return sum(vals) / len(vals)

    def window_mfu(self, last_n: int = 0) -> Optional[float]:
        """MFU of the most recent ``last_n`` traced steps computed the
        way a benchmark computes its window: total tokens over total wall
        time (token-weighted — a mean of per-step rates would overweight
        fast steps). None when the window carries no MFU inputs."""
        with self._lock:
            rows = list(self.step_history)
        if last_n > 0:
            rows = rows[-last_n:]
        rows = [t for t in rows
                if t.mfu is not None and t.wall_ms > 0 and t.tokens]
        if not rows:
            return None
        total_tokens = sum(t.tokens for t in rows)
        total_s = sum(t.wall_ms for t in rows) / 1000.0
        last = rows[-1]
        from deepspeed_tpu_torch.observability.roofline import mfu as _mfu

        return _mfu(total_tokens / total_s / max(1, last.n_chips),
                    last.flops_per_token, last.peak_tflops)

    def window_host_gap_ms(self, last_n: int = 0) -> Optional[float]:
        """Mean host-side gap per step over the most recent ``last_n``
        traced steps (all history when 0) — the per-window aggregate a
        benchmark reports next to tokens/s/card so host-overhead
        regressions stay visible. None when no
        step in the window carried the measurement."""
        with self._lock:
            rows = list(self.step_history)
        if last_n > 0:
            rows = rows[-last_n:]
        vals = [t.host_gap_ms for t in rows if t.host_gap_ms is not None]
        if not vals:
            return None
        return sum(vals) / len(vals)

    def snapshot(self) -> Dict[str, Any]:
        from deepspeed_tpu_torch.utils import telemetry

        with self._lock:
            out: Dict[str, Any] = {
                "gauges": dict(self.gauges),
                "counters": dict(self.counters),
                "histograms": {n: h.snapshot()
                               for n, h in self.histograms.items()},
                "fallbacks": telemetry.snapshot(),
            }
            last = self.step_history[-1] if self.step_history else None
        if last is not None:
            out["last_step"] = last.to_dict()
        return out

    def to_prometheus(self) -> str:
        from deepspeed_tpu_torch.utils import telemetry

        with self._lock:
            gauges = dict(self.gauges)
            counters = dict(self.counters)
            hists = dict(self.histograms)
        return render_prometheus(
            gauges, counters, hists,
            labeled_counters={"capability_fallback":
                              {k: float(v)
                               for k, v in telemetry.snapshot().items()}})

    def write_prometheus(self) -> None:
        if self._prom is not None:
            self._prom.write_text(self.to_prometheus())

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        self.write_prometheus()


_HUB: Optional[MetricsHub] = None
_HUB_LOCK = threading.Lock()


def get_hub() -> MetricsHub:
    global _HUB
    with _HUB_LOCK:
        if _HUB is None:
            _HUB = MetricsHub()
        return _HUB


def peek_hub() -> Optional[MetricsHub]:
    """The singleton if one exists, without creating it — for report
    paths (watchdog, crash dumps) that must not allocate mid-failure."""
    return _HUB


def reset_hub() -> None:
    """Drop the singleton (tests). Sinks on the old hub are closed."""
    global _HUB
    with _HUB_LOCK:
        if _HUB is not None:
            if _HUB._jsonl is not None:
                _HUB._jsonl.close()
        _HUB = None
