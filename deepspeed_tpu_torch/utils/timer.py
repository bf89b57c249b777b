"""Wall-clock and throughput timers (port of
``deepspeed_tpu/utils/timer.py``).

The reference's ``SynchronizedWallClockTimer`` / ``ThroughputTimer``
(deepspeed/utils/timer.py:44,199). "Synchronized" means that
``start(block=t)`` / ``stop(block=t)`` first wait for the work that
produces ``t``: a CUDA event recorded on the current stream after it,
waited on from the host (JAX's ``block_until_ready``). That waits for
the one stream and nothing else: no ``torch.cuda.synchronize()``. A CPU
tensor is ready when the call returns.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


def block_until_ready(tree) -> None:
    """Wait until the CUDA tensors of ``tree`` (a tensor, or lists,
    tuples and dicts of them) are computed: one event recorded on each
    of their devices' current streams, waited on from the host."""
    import torch

    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0
        self.records: List[float] = []

    def start(self, block=None):
        if self.started:
            return
        if block is not None:
            block_until_ready(block)
        self._start = time.perf_counter()
        self.started = True

    def stop(self, record: bool = True, block=None):
        if not self.started:
            return
        if block is not None:
            block_until_ready(block)
        self._elapsed += time.perf_counter() - self._start
        self.started = False
        if record:
            self.records.append(self._elapsed * 1000.0)
            self._elapsed = 0.0

    def record_ms(self, value_ms: float):
        """Record an externally-measured duration. The pipelined loop
        (dispatch-ahead) measures a step's wall time drain-to-drain —
        start/stop pairs cannot nest across overlapping in-flight steps,
        so the engine computes the span itself and records it here."""
        self.records.append(float(value_ms))

    def elapsed(self, reset: bool = True) -> float:
        """Milliseconds."""
        now = time.perf_counter()
        value = self._elapsed * 1000.0
        if self.started:
            value += (now - self._start) * 1000.0
        if reset:
            self._elapsed = 0.0
            if self.started:
                self._start = now  # restart so the in-flight span isn't recounted
        return value

    def mean(self) -> float:
        return sum(self.records) / len(self.records) if self.records else 0.0

    def reset(self):
        self.started = False
        self._elapsed = 0.0
        self.records = []


class SynchronizedWallClockTimer:
    """Named-timer registry (reference utils/timer.py:44)."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False, ranks: Optional[List[int]] = None):
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) / normalizer
                parts.append(f"{name}: {elapsed:.2f}")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=ranks or [0])

    def get_mean(self, names: List[str], normalizer: float = 1.0) -> Dict[str, float]:
        return {
            name: self.timers[name].mean() / normalizer
            for name in names
            if name in self.timers
        }


class ThroughputTimer:
    """Samples/sec + TFLOPS tracking (reference utils/timer.py:199)."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50, monitor_memory: bool = False):
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self._start = 0.0
        self.started = False

    def start(self):
        self.started = True
        self._start = time.perf_counter()

    def stop(self, global_step: bool = True, report_speed: bool = True,
             flops_per_sample: float = 0.0):
        if not self.started:
            return
        self.started = False
        duration = time.perf_counter() - self._start
        self.record(duration, global_step=global_step,
                    report_speed=report_speed,
                    flops_per_sample=flops_per_sample)

    def record(self, duration: float, global_step: bool = True,
               report_speed: bool = True, flops_per_sample: float = 0.0):
        """Account an externally-measured step duration (seconds). The
        dispatch-ahead loop resolves steps out of line with their
        dispatch, so start()/stop() bracketing does not apply there."""
        self.step_elapsed_time += duration
        if not global_step:
            return
        self.global_step_count += 1
        if self.global_step_count > self.start_step:
            self.total_elapsed_time += self.step_elapsed_time
            if report_speed and self.global_step_count % self.steps_per_output == 0:
                tput = self.avg_samples_per_sec()
                msg = (f"step={self.global_step_count}, "
                       f"samples/sec={tput:.2f}, "
                       f"time/step (ms)={self.step_elapsed_time * 1000:.1f}")
                if flops_per_sample:
                    tflops = tput * flops_per_sample / 1e12
                    msg += f", TFLOPS={tflops:.2f}"
                log_dist(msg, ranks=[0])
        self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        counted = self.global_step_count - self.start_step
        if counted > 0 and self.total_elapsed_time > 0:
            return counted * self.batch_size / self.total_elapsed_time
        return 0.0
