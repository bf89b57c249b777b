"""Unified observability hub (port of ``deepspeed_tpu/observability``,
the engine part of ROADMAP queue A item 14).

One process-wide registry (``get_hub()``) collecting per-step training
traces (MFU and roofline included), serving latency histograms and
per-request traces, stall watchdog reports and capability-fallback
counters, exported through the monitor backends plus JSON-lines and
Prometheus text sinks; the crash flight recorder, the profiler capture
and the per-region attribution beside it. The fleet modules (``fleet``,
``fleet_metrics``, ``burn_rate``, ``journal``, ``chrome_trace``) come
with the fleet part of item 14 and item 13, ``quant_stats`` with item
10.
"""

from deepspeed_tpu_torch.observability.attribution import (
    REGIONS, RegionCost, attribute_step, attribution_markdown, count_step,
    device_ms_by_region)
from deepspeed_tpu_torch.observability.clocksync import (ClockSyncEstimator,
                                                         wall_time)
from deepspeed_tpu_torch.observability.flight_recorder import (
    FlightRecorder, dump_flight_recorder, get_flight_recorder,
    install_crash_handlers, reset_flight_recorder)
from deepspeed_tpu_torch.observability.histogram import Histogram
from deepspeed_tpu_torch.observability.hub import (MetricsHub, compile_stats,
                                                   get_hub, note_compile,
                                                   peek_hub, reset_hub)
from deepspeed_tpu_torch.observability.profile_trace import (
    TraceCapture, parse_trace_steps)
from deepspeed_tpu_torch.observability.request_trace import (
    PHASES, SPAN_KINDS, RequestTrace, RequestTracer, check_phase_closure,
    load_traces_jsonl, slo_attribution, slo_attribution_markdown)
from deepspeed_tpu_torch.observability.roofline import (HBM_GBPS,
                                                        PEAK_TFLOPS,
                                                        detect_hbm_gbps,
                                                        detect_peak_tflops,
                                                        mfu,
                                                        roofline_summary)
from deepspeed_tpu_torch.observability.sinks import (JSONLSink,
                                                     PrometheusTextSink,
                                                     escape_label_value,
                                                     prometheus_name,
                                                     render_prometheus)
from deepspeed_tpu_torch.observability.step_trace import StepTrace
from deepspeed_tpu_torch.observability.watchdog import StallWatchdog

__all__ = [
    "REGIONS",
    "RegionCost",
    "attribute_step",
    "attribution_markdown",
    "count_step",
    "device_ms_by_region",
    "Histogram",
    "MetricsHub",
    "get_hub",
    "peek_hub",
    "reset_hub",
    "compile_stats",
    "note_compile",
    "TraceCapture",
    "parse_trace_steps",
    "PEAK_TFLOPS",
    "HBM_GBPS",
    "detect_peak_tflops",
    "detect_hbm_gbps",
    "mfu",
    "roofline_summary",
    "JSONLSink",
    "PrometheusTextSink",
    "prometheus_name",
    "escape_label_value",
    "render_prometheus",
    "StepTrace",
    "StallWatchdog",
    "FlightRecorder",
    "get_flight_recorder",
    "reset_flight_recorder",
    "dump_flight_recorder",
    "install_crash_handlers",
    "PHASES",
    "SPAN_KINDS",
    "RequestTrace",
    "RequestTracer",
    "check_phase_closure",
    "load_traces_jsonl",
    "slo_attribution",
    "slo_attribution_markdown",
    "ClockSyncEstimator",
    "wall_time",
]
