"""Per-step training trace record (copy of
``deepspeed_tpu/observability/step_trace.py``).

One ``StepTrace`` is emitted by the engine per optimizer boundary
(train_batch): wall time, loss/grad-norm/lr, token throughput, MFU,
cumulative traced communication volume, compile/retrace events, and
device memory. This is the row every sink exports and every regression
hunt greps for — the per-step analog of a benchmark's one-shot
numbers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional


@dataclasses.dataclass
class StepTrace:
    step: int
    wall_ms: float
    # throughput (global tokens across all chips; per-chip rates divide
    # by n_chips, the world size, for a tokens/s/card headline)
    tokens: Optional[int] = None
    tokens_per_sec: Optional[float] = None
    tokens_per_sec_per_chip: Optional[float] = None
    n_chips: int = 1
    # training signals
    loss: Optional[float] = None
    grad_norm: Optional[float] = None
    lr: Optional[float] = None
    loss_scale: Optional[float] = None
    overflow: bool = False
    skipped_steps: int = 0
    # model-FLOPs utilization (the benchmark formula:
    # tok/s/chip * flops_per_token / peak). ``mfu_source`` records where
    # flops_per_token came from: "model" (analytic, bench-identical) or
    # "xla" (JAX's name for a counted cost; unused by the port's engine).
    mfu: Optional[float] = None
    mfu_source: Optional[str] = None
    flops_per_token: Optional[float] = None
    peak_tflops: Optional[float] = None
    # host-side time this step spent on the device critical path before
    # dispatch (input pull/stack/transfer + jit call overhead). Under the
    # pipelined loop (performance.pipeline_depth) this is the overhead
    # the dispatch-ahead window hides; ``MetricsHub.window_host_gap_ms``
    # aggregates it per window
    host_gap_ms: Optional[float] = None
    # dispatched-but-unresolved steps in flight when this step resolved
    # (0 = blocking loop)
    inflight: int = 0
    # compile/retrace activity observed since the previous step (a
    # nonzero value mid-run is the classic silent-regression smell)
    compile_events: int = 0
    compile_secs: float = 0.0
    # cumulative traced collective volume by op (utils/comms_logging),
    # and the delta vs the previous step's snapshot
    comm_bytes_total: Optional[Dict[str, float]] = None
    comm_bytes_delta: Optional[Dict[str, float]] = None
    # device memory (utils/memory.device_memory_stats: the caching
    # allocator's counters; None on the CPU)
    device_mem: Optional[Dict[str, float]] = None
    timestamp: float = dataclasses.field(default_factory=time.time)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["kind"] = "step_trace"
        # drop Nones so JSONL rows stay compact
        return {k: v for k, v in d.items() if v is not None}
