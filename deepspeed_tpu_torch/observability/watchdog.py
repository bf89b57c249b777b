"""Stall watchdog: silent hangs become actionable reports (copy of
``deepspeed_tpu/observability/watchdog.py``: the same thresholds, env
overrides and report; the report's device section reads the card's
allocator counters, ``utils/memory.device_memory_stats``).

Two failure shapes, two mechanisms:

* a step that *finishes* but takes N× the rolling-mean step time is
  flagged post-hoc by :meth:`StallWatchdog.observe` (counter + warning
  with the ratio);
* a step that *never finishes* — a wedged collective, a deadlocked host
  callback, an NFS checkpoint hang — is caught by a daemon thread: the
  engine ``arm()``s a deadline before dispatching the step and
  ``disarm()``s after it completes; if the deadline passes while armed,
  the thread dumps every Python thread's stack plus device memory stats
  to the log and the hub, exactly once per armed window.

The thread sleeps on an Event and is started lazily on first arm, so a
disabled watchdog costs nothing and an enabled one costs one mostly-
blocked daemon thread.

Env overrides (beat the config block): ``DSTPU_WATCHDOG=0`` disables,
``DSTPU_WATCHDOG_FACTOR`` and ``DSTPU_WATCHDOG_MIN_S`` tune the
threshold ``max(factor * rolling_mean_step, min_seconds)``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, Optional

from deepspeed_tpu_torch.utils.logging import logger


class StallWatchdog:
    def __init__(self, factor: float = 8.0, min_seconds: float = 30.0,
                 history: int = 64, warmup_steps: int = 5,
                 enabled: bool = True,
                 report_fn: Optional[Callable[[str], None]] = None):
        self.enabled = enabled
        self.factor = float(factor)
        self.min_seconds = float(min_seconds)
        self.warmup_steps = int(warmup_steps)
        self._durations: deque = deque(maxlen=history)
        self._report_fn = report_fn
        self.stalls = 0       # hang reports fired by the thread
        self.slow_steps = 0   # finished steps over threshold
        self._lock = threading.Lock()
        self._deadline: Optional[float] = None
        self._armed_step: Optional[int] = None
        self._fired = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stop = False

    @classmethod
    def from_config(cls, cfg, report_fn=None) -> "StallWatchdog":
        enabled = getattr(cfg, "enabled", True)
        factor = getattr(cfg, "factor", 8.0)
        min_s = getattr(cfg, "min_seconds", 30.0)
        if os.environ.get("DSTPU_WATCHDOG", "") == "0":
            enabled = False
        factor = float(os.environ.get("DSTPU_WATCHDOG_FACTOR", factor))
        min_s = float(os.environ.get("DSTPU_WATCHDOG_MIN_S", min_s))
        return cls(factor=factor, min_seconds=min_s, enabled=enabled,
                   report_fn=report_fn)

    # -- rolling statistics -------------------------------------------
    def rolling_mean(self) -> Optional[float]:
        with self._lock:
            if len(self._durations) < self.warmup_steps:
                return None
            return sum(self._durations) / len(self._durations)

    def threshold(self) -> Optional[float]:
        mean = self.rolling_mean()
        if mean is None:
            return None
        return max(self.factor * mean, self.min_seconds)

    def observe(self, duration_s: float, step: Optional[int] = None) -> bool:
        """Record a finished step; returns True if it was flagged slow."""
        if not self.enabled:
            return False
        thr = self.threshold()
        slow = thr is not None and duration_s > thr
        if slow:
            self.slow_steps += 1
            mean = self.rolling_mean() or duration_s
            logger.warning(
                f"stall watchdog: step{'' if step is None else ' ' + str(step)}"
                f" took {duration_s:.2f}s = {duration_s / max(mean, 1e-9):.1f}x"
                f" the rolling mean ({mean:.2f}s over "
                f"{len(self._durations)} steps)")
        with self._lock:
            # a flagged step does not poison the baseline: the mean keeps
            # reflecting normal steps so one hiccup can't mask the next
            if not slow:
                self._durations.append(float(duration_s))
        return slow

    # -- hang detection (armed window + daemon thread) ----------------
    def arm(self, step: Optional[int] = None, window: int = 1) -> None:
        """Arm a deadline for ``step``. ``window`` scales the deadline to
        cover a dispatch-ahead in-flight window: with K unresolved steps
        queued behind ``step`` the pipelined engine arms the OLDEST one
        with window=K, so the deadline budgets K steps of device work
        instead of flagging a healthy full pipeline as a stall."""
        if not self.enabled:
            return
        thr = self.threshold()
        if thr is None:
            return  # not enough history yet
        with self._lock:
            self._deadline = time.monotonic() + thr * max(1, int(window))
            self._armed_step = step
            self._fired = False
        self._ensure_thread()
        self._wake.set()

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None
            self._armed_step = None

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._run, name="dstpu-stall-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    def _run(self) -> None:
        poll = max(0.01, min(1.0, self.min_seconds / 10.0))
        while not self._stop:
            with self._lock:
                deadline, fired = self._deadline, self._fired
                step = self._armed_step
            if deadline is None:
                self._wake.wait()   # nothing armed: sleep until arm()
                self._wake.clear()
                continue
            now = time.monotonic()
            if not fired and now >= deadline:
                with self._lock:
                    self._fired = True
                self.stalls += 1
                self._report(step, now - deadline)
            else:
                time.sleep(min(poll, max(deadline - now, 0.0) + poll))

    # -- reporting -----------------------------------------------------
    def _report(self, step: Optional[int], overdue_s: float) -> None:
        try:
            report = self.build_report(step, overdue_s)
            logger.error(report)
            if self._report_fn is not None:
                self._report_fn(report)
        except Exception as e:  # the watchdog must never kill the run
            logger.warning(f"stall watchdog report failed: {e}")
        try:
            # the post-mortem artifact for a worker that never recovers:
            # the ring's last events survive on disk even if the process
            # is OOM-killed seconds after this fires
            from deepspeed_tpu_torch.observability.flight_recorder import \
                dump_flight_recorder

            dump_flight_recorder("watchdog", step=step,
                                 overdue_s=round(overdue_s, 3))
        except Exception:
            pass

    def build_report(self, step: Optional[int] = None,
                     overdue_s: float = 0.0) -> str:
        thr = self.threshold()
        lines = [
            "=" * 70,
            f"STALL WATCHDOG: step{'' if step is None else ' ' + str(step)} "
            f"has run {overdue_s:.1f}s past its "
            f"{0.0 if thr is None else thr:.1f}s deadline "
            f"(rolling mean {self.rolling_mean() or 0.0:.2f}s, "
            f"factor {self.factor}x)",
        ]
        try:
            from deepspeed_tpu_torch.utils.memory import device_memory_stats

            mem = device_memory_stats()
            lines.append(f"device memory: {mem if mem else 'unavailable'}")
        except Exception as e:
            lines.append(f"device memory: error ({e})")
        lines.append("python stacks:")
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in frames.items():
            name = names.get(ident, "?")
            if name == "dstpu-stall-watchdog":
                continue
            lines.append(f"--- thread {name} ({ident}) ---")
            lines.append("".join(traceback.format_stack(frame)).rstrip())
        # the last seconds before the hang: flight-recorder tail (step
        # phases, traced collectives, checkpoint/offload transitions)
        # plus the last completed StepTrace rows — together they say what
        # the worker was *doing*, where the stacks say where it is stuck
        try:
            from deepspeed_tpu_torch.observability.flight_recorder import \
                get_flight_recorder

            tail = get_flight_recorder().tail_lines(last=32)
            if tail:
                lines.append("flight recorder tail (newest last):")
                lines.append(tail)
        except Exception as e:
            lines.append(f"flight recorder: error ({e})")
        try:
            from deepspeed_tpu_torch.observability.hub import peek_hub

            hub = peek_hub()
            rows = list(hub.step_history)[-8:] if hub is not None else []
            if rows:
                lines.append("last step traces:")
                for t in rows:
                    lines.append(
                        f"  step {t.step}: wall {t.wall_ms:.1f} ms"
                        + (f", loss {t.loss:.4f}" if t.loss is not None
                           else "")
                        + (f", host_gap {t.host_gap_ms:.1f} ms"
                           if t.host_gap_ms is not None else "")
                        + (f", compiles {t.compile_events}"
                           if t.compile_events else ""))
        except Exception as e:
            lines.append(f"step traces: error ({e})")
        lines.append("=" * 70)
        return "\n".join(lines)
