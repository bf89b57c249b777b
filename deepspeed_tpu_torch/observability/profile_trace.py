"""On-demand ``torch.profiler`` capture, gated by env var (port of
``deepspeed_tpu/observability/profile_trace.py``).

``DSTPU_TRACE_STEPS=5:8`` makes the engine capture a trace of global
steps 5 through 8 (inclusive; a single number traces that one step) with
``torch.profiler.profile(activities=[CPU, CUDA])`` and write it as a
Chrome trace into ``DSTPU_TRACE_DIR`` (default ``dstpu_trace`` in the
temporary directory; JAX's ``/tmp/dstpu_trace``) — open it in Perfetto
or ``chrome://tracing``. No code change, no restart with different
flags: the window is checked against the engine's step counter at the
train_batch boundary.

Each traced step runs under a ``record_function("train_step#N")`` range
(JAX's ``StepTraceAnnotation``), and the model's region ranges
(``utils/annotate.py``: attention, mlp, norm, rope, vocab_head,
optimizer) name the kernels inside it. The finished profiler stays on
``TraceCapture.profiler`` for in-process readers
(``attribution.device_ms_by_region``).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

from deepspeed_tpu_torch.utils.logging import logger


def parse_trace_steps(spec: str) -> Optional[Tuple[int, int]]:
    """'5:8' -> (5, 8); '12' -> (12, 12); '' / malformed -> None."""
    spec = (spec or "").strip()
    if not spec:
        return None
    try:
        if ":" in spec:
            a, b = spec.split(":", 1)
            lo, hi = int(a), int(b)
        else:
            lo = hi = int(spec)
        if lo < 0 or hi < lo:
            raise ValueError(spec)
        return lo, hi
    except ValueError:
        logger.warning(
            f"DSTPU_TRACE_STEPS={spec!r} not understood (want 'N' or "
            "'LO:HI'); trace capture disabled")
        return None


class TraceCapture:
    """Start/stop ``torch.profiler`` around a step window."""

    def __init__(self, window: Optional[Tuple[int, int]] = None,
                 out_dir: Optional[str] = None):
        self.window = window
        self.out_dir = out_dir or os.environ.get(
            "DSTPU_TRACE_DIR",
            os.path.join(tempfile.gettempdir(), "dstpu_trace"))
        self.active = False
        self.done = False
        self.profiler = None    # the torch.profiler.profile of the window
        self.trace_path: Optional[str] = None
        self._step_ann = None
        self._step_ann_step: Optional[int] = None

    @classmethod
    def from_env(cls) -> "TraceCapture":
        return cls(window=parse_trace_steps(
            os.environ.get("DSTPU_TRACE_STEPS", "")))

    @property
    def enabled(self) -> bool:
        return self.window is not None and not self.done

    def on_step_begin(self, step: int) -> None:
        """Call with the 1-based index of the step about to run."""
        if not self.enabled:
            return
        lo, hi = self.window
        if not self.active and lo <= step <= hi:
            import torch
            from torch.profiler import ProfilerActivity

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            try:
                os.makedirs(self.out_dir, exist_ok=True)
                self.profiler = torch.profiler.profile(
                    activities=activities)
                self.profiler.__enter__()
                self.active = True
                logger.warning(
                    f"profiler trace started at step {step} "
                    f"(window {lo}:{hi}) -> {self.out_dir}")
            except Exception as e:
                logger.warning(f"profiler trace start failed: {e}")
                self.profiler = None
                self.done = True
                return
        if self.active:
            import torch

            # named step boundary inside the capture; under dispatch-ahead
            # the range covers the step's dispatch (ranges on one thread
            # must nest, and the step drains after the next one starts)
            self._close_step_range()
            self._step_ann = torch.autograd.profiler.record_function(
                f"train_step#{step}")
            self._step_ann.__enter__()
            self._step_ann_step = step

    def _close_step_range(self, step: Optional[int] = None) -> None:
        """Close the open step range (only ``step``'s when given)."""
        if self._step_ann is not None and step in (None,
                                                   self._step_ann_step):
            self._step_ann.__exit__(None, None, None)
            self._step_ann = None

    def wants_start(self, step: int) -> bool:
        """True when the capture starts at ``step``: the engine then
        drains the steps in flight first."""
        return (self.enabled and not self.active
                and self.window[0] <= step <= self.window[1])

    def wants_drain(self, step: int) -> bool:
        """True when ``step`` (just dispatched) ends an active window:
        the engine then drains the steps in flight, so the capture stops
        with whole steps in it and none after the window."""
        return self.active and step >= self.window[1]

    def on_step_end(self, step: int) -> None:
        """Call when ``step`` has drained (its results are on the host)."""
        self._close_step_range(step)
        if self.active and step >= self.window[1]:
            from deepspeed_tpu_torch.utils.annotate import close_open_ranges

            close_open_ranges()
            try:
                self.profiler.__exit__(None, None, None)
                self.trace_path = os.path.join(
                    self.out_dir, f"trace_steps{self.window[0]}-"
                                  f"{self.window[1]}_pid{os.getpid()}.json")
                self.profiler.export_chrome_trace(self.trace_path)
                logger.warning(
                    f"profiler trace stopped after step {step}; open "
                    f"{self.trace_path} in Perfetto or chrome://tracing")
            except Exception as e:
                logger.warning(f"profiler trace stop failed: {e}")
            self.active = False
            self.done = True   # one capture per process
