"""The ds_config tree, trimmed to what the single-card training engine
runs (port of ``deepspeed_tpu/config/config.py``).

Parsed: the batch triple and its solver (``resolve_batch_size``),
``steps_per_print``, ``gradient_clipping``, ``seed``, the ``bf16`` and
``fp16`` blocks, ``optimizer``, ``scheduler``, the ``comms_logger``
block (``CommsLoggerConfig``), ``zero_optimization.stage``,
``.offload_optimizer``
(``OffloadOptimizerConfig``) and ``.zenflow`` (``ZenFlowBlockConfig``),
the ``moe`` block (``ep_size`` 1), the
``serving`` block (``ServingConfig``, the serving engine's knobs), the
``sparse_attention`` block (``SparseAttentionConfig``), the
``kernels`` block (``KernelsConfig``), the ``checkpoint`` and
``resilience`` blocks (``CheckpointConfig``, ``ResilienceConfig``) and
the ``performance`` block (``PerformanceConfig``), the
``observability`` block (``ObservabilityConfig`` with its
``watchdog`` and ``request_trace`` blocks), the ``monitor`` block
(``MonitorConfig``; the top-level ``tensorboard`` / ``csv_monitor`` /
``wandb`` / ``comet`` blocks hoisted into it) and the
``wall_clock_breakdown`` / ``memory_breakdown`` / ``dump_state``
switches. A
block or switch of the JAX schema that this package does not run raises
``NotImplementedError`` naming its ROADMAP item: nothing the JAX engine
would act on is silently ignored.
Keys that neither schema knows are ignored with a warning, as the JAX
config does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

_A = "ROADMAP queue A item"
# top-level blocks of the JAX schema this package does not run yet
UNPORTED_BLOCKS = {
    "tensor_parallel": f"{_A} 11 (tensor parallelism)",
    "sequence_parallel": f"{_A} 11 (sequence parallelism)",
    "pipeline": f"{_A} 11 (pipeline parallelism)",
    "activation_checkpointing": f"{_A} 11 (activation checkpointing "
                                "policies; the model's `remat` switch "
                                "recomputes every layer)",
    "flops_profiler": f"{_A} 16 (profiling)",
    "compile": f"{_A} 16 (compile passes)",
    "elasticity": f"{_A} 16 (elasticity)",
    "data_efficiency": f"{_A} 16 (data pipeline)",
}
_FLEET = f"{_A} 14's fleet part (the fleet publisher and aggregator)"
_FLEET_SERVING = f"{_A} 13 (the serving fleet)"
# zero_optimization keys: accepted at their "off" values only
ZERO_SWITCHES = {
    "offload_param": (None, f"{_A} 11 (offload_param streams the layers "
                            "with runtime/param_stream.py)"),
    "zero_quantized_weights": (False, f"{_A} 10 (ZeRO++)"),
    "zero_quantized_gradients": (False, f"{_A} 10 (ZeRO++)"),
    "zero_quantized_allreduce": (False, f"{_A} 10 (ZeRO++)"),
    "zero_hpz_partition_size": (1, f"{_A} 10 (ZeRO++)"),
    "mics_shard_size": (-1, f"{_A} 10 (ZeRO++ MiCS)"),
    "mics_hierarchical_params_gather": (False, f"{_A} 10 (ZeRO++ MiCS)"),
}
# zero_optimization tuning knobs that JAX parses and never reads (XLA
# schedules and fuses its collectives; ``param_persistence_threshold``
# feeds only the compile passes, ROADMAP queue A item 16): accepted at any
# world size, with no effect, as there
ZERO_NOOP_KEYS = ("reduce_bucket_size", "allgather_bucket_size",
                  "overlap_comm", "contiguous_gradients", "reduce_scatter",
                  "round_robin_gradients", "sub_group_size",
                  "log_trace_cache_warnings", "model_persistence_threshold",
                  "param_persistence_threshold")
_DEPRECATED = {"train_micro_batch_size_per_gpu":
               "train_micro_batch_size_per_chip"}


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"config {what} is not ported to deepspeed_tpu_torch yet: {item}")


def _offload_off(block) -> bool:
    return block is None or (isinstance(block, dict)
                             and block.get("device", "none") in ("none", None))


@dataclass
class OptimizerConfig:
    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CommsLoggerConfig:
    """The ``comms_logger`` block (reference utils/comms_logging.py:67):
    ``comm.configure`` arms the comms logger, which records every
    executed collective (op, input bytes, mesh axis); ``prof_ops``
    limits it to the named ops. ``debug`` is accepted, as in JAX."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: list = field(default_factory=list)


@dataclass
class BF16Config:
    enabled: bool = True


@dataclass
class FP16Config:
    enabled: bool = False
    loss_scale: float = 0.0  # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0


@dataclass
class OffloadOptimizerConfig:
    """``zero_optimization.offload_optimizer`` (reference
    runtime/zero/offload_config.py:52), with JAX's fields and checks.
    ``device`` cpu keeps the fp32 masters and moments on the host, nvme
    in files under ``nvme_path`` (``runtime/offload.py``);
    ``buffer_count`` staging buffers stream the gradients to the host,
    page-locked where ``pin_memory``; ``grad_transfer_dtype`` bf16 halves
    the device->host bytes. ``pipeline_read``, ``pipeline_write`` and
    ``ratio`` are accepted and have no effect, as in JAX."""

    device: str = "none"  # none | cpu | nvme
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    grad_transfer_dtype: str = "fp32"  # fp32 | bf16
    ratio: float = 1.0

    def validate(self) -> None:
        if self.device not in ("none", "cpu", "nvme"):
            raise ValueError(
                f"offload_optimizer.device must be none|cpu|nvme, "
                f"got {self.device!r}")
        if self.device == "nvme" and not self.nvme_path:
            raise ValueError(
                "offload_optimizer.device='nvme' requires nvme_path "
                "(otherwise state would silently stay in host RAM)")
        if self.grad_transfer_dtype not in ("fp32", "bf16"):
            raise ValueError(
                f"offload_optimizer.grad_transfer_dtype must be fp32|bf16, "
                f"got {self.grad_transfer_dtype!r}")
        if self.buffer_count < 1:
            raise ValueError("offload_optimizer.buffer_count must be >= 1, "
                             f"got {self.buffer_count}")


@dataclass
class ZenFlowBlockConfig:
    """``zero_optimization.zenflow`` (reference
    runtime/zenflow/zenflow_config.py), with JAX's fields and checks:
    the top ``topk_ratio`` of each leaf's coordinates update on the card
    every step, the rest in a host pass every ``update_interval`` steps,
    overlapped with training where ``overlap_step``; ``workers`` threads
    split the host pass across leaves (``runtime/zenflow.py``)."""

    topk_ratio: float = 0.01
    update_interval: int = 4
    select_interval: int = 16
    overlap_step: bool = True
    workers: int = 1

    def validate(self) -> None:
        if self.workers < 1:
            raise ValueError(f"zenflow.workers must be >= 1, got "
                             f"{self.workers}")
        if not 0.0 < self.topk_ratio <= 1.0:
            raise ValueError(
                f"zenflow.topk_ratio must be in (0, 1], got "
                f"{self.topk_ratio}")
        if self.update_interval < 1 or self.select_interval < 1:
            raise ValueError("zenflow intervals must be >= 1")


@dataclass
class ZeroConfig:
    """Stages 0-3 shard the fp32 masters and moments, then the gradients,
    then the params over the ranks of a process group (``runtime/zero``);
    on one process without a group they are the same math.
    ``offload_optimizer`` moves the optimizer to the host
    (``OffloadOptimizerConfig``); ``zenflow`` splits it between the card
    and the host (``ZenFlowBlockConfig``; it needs the cpu tier, which
    the engine checks, as JAX's does)."""

    stage: int = 0
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    zenflow: Optional[ZenFlowBlockConfig] = None

    @property
    def offload_device(self) -> str:
        """"cpu" | "nvme" | "none"."""
        off = self.offload_optimizer
        return "none" if off is None else (off.device or "none")

    def validate(self) -> None:
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(
                f"zero_optimization.stage must be 0-3, got {self.stage}")
        if self.offload_optimizer is not None:
            self.offload_optimizer.validate()
        if self.zenflow is not None:
            self.zenflow.validate()


@dataclass
class MoEConfig:
    """The JAX ``moe`` block. The engine applies ``impl`` to an MoE
    model's config; the other fields are the model zoo's defaults, as in
    the JAX engine. ``ep_size`` must be 1 (the expert all-to-all across
    ranks is ROADMAP queue A item 9)."""

    enabled: bool = False
    ep_size: int = 1
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    top_k: int = 2
    drop_tokens: bool = True
    use_rts: bool = False
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.0
    impl: str = "auto"  # auto | grouped | einsum

    def validate(self) -> None:
        if self.enabled and self.ep_size > 1:
            raise _unported(
                f"moe.ep_size={self.ep_size}",
                f"{_A} 9 (the ep > 1 all-to-all dispatch), over the ranks "
                f"of item 5")
        if self.impl not in ("auto", "grouped", "einsum"):
            raise ValueError(f"moe.impl must be auto, grouped or einsum, "
                             f"got {self.impl!r}")


@dataclass
class ServingConfig:
    """Serving-engine knobs (``inference/engine_v2.py``), with the JAX
    ``ServingConfig`` defaults and validation.

    Admission: ``put`` never raises on a full KV pool; requests wait in
    a FIFO queue, and ``max_queue_depth`` (default unbounded) restores
    fail-fast backpressure. ``prefix_cache`` shares full KV blocks
    across requests whose prompt prefixes match by content hash.
    ``decode_steps`` is the steady-state multi-token decode burst length
    (1 restores per-token SplitFuse admission). ``kv_quant_bits`` stores
    KV blocks as codes with one fp32 scale per head vector: 8 (int8), 4
    (two values per byte) or "fp8" (e4m3); None keeps the unquantized
    pool. ``host_kv_tier`` attaches a ``host_tier_mb`` host-memory tier
    below the device pool (``ragged/kv_tier.py``): KV pressure pages
    cold prefix chains and preempted sessions out in pool-native format
    instead of discarding them.

    ``spec_decode`` turns on speculative decoding with prompt-lookup
    drafts (``spec_ngram``), at most ``spec_k`` drafts a sequence a
    round; ``spec_adaptive_k`` picks each request's draft length from
    its acceptance EWMA (``spec_accept_alpha``) and the batch occupancy.
    The fleet's ``handoff_wire`` (other than "auto") and ``router`` raise
    (ROADMAP queue A item 13)."""

    max_queue_depth: Optional[int] = None
    prefix_cache: bool = True
    spec_decode: bool = False
    spec_k: int = 4
    spec_ngram: int = 3
    decode_steps: int = 8
    kv_quant_bits: Optional[Any] = None
    handoff_wire: str = "auto"
    host_kv_tier: bool = False
    host_tier_mb: int = 256
    spec_adaptive_k: bool = False
    spec_accept_alpha: float = 0.25
    router: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(
                f"serving.max_queue_depth must be >= 1 (or null for "
                f"unbounded), got {self.max_queue_depth}")
        for name, lo in (("spec_k", 1), ("spec_ngram", 1),
                         ("decode_steps", 1), ("host_tier_mb", 1)):
            if getattr(self, name) < lo:
                raise ValueError(
                    f"serving.{name} must be >= {lo}, got "
                    f"{getattr(self, name)}")
        if self.kv_quant_bits not in (None, 4, 8, "fp8"):
            raise ValueError(
                f"serving.kv_quant_bits must be null, 4, 8 or \"fp8\", "
                f"got {self.kv_quant_bits}")
        if self.handoff_wire not in ("auto", "raw", "int8", "int4",
                                     "fp8"):
            raise ValueError(
                f"serving.handoff_wire must be one of auto/raw/int8/"
                f"int4/fp8, got {self.handoff_wire!r}")
        if not (0.0 < self.spec_accept_alpha <= 1.0):
            raise ValueError(
                f"serving.spec_accept_alpha must be in (0, 1], got "
                f"{self.spec_accept_alpha}")
        if self.handoff_wire != "auto":
            raise _unported(f"serving.handoff_wire={self.handoff_wire!r}",
                            f"{_A} 13 (serving fleet and its KV wire)")
        if self.router is not None:
            raise _unported("block 'serving.router'",
                            f"{_A} 13 (serving fleet)")


@dataclass
class PerformanceConfig:
    """The pipelined training loop (JAX ``PerformanceConfig``).

    ``pipeline_depth`` is the number of dispatched, not yet resolved
    ``train_batch`` steps the engine keeps in flight before it waits
    (dispatch-ahead): 0 is the blocking loop. The
    ``DSTPU_DISPATCH_AHEAD`` environment variable overrides it.
    ``prefetch_depth`` bounds the background input prefetcher's buffer
    (``runtime/prefetch.py``); 0 turns it off, and 0 is the port's
    default (JAX's is 2): the prefetcher is asked for, and until then a
    checkpoint's data cursor keeps the loader's own state.
    ``param_prefetch_depth`` and ``overlap_depth`` (the streamed layer
    stack, ROADMAP queue A item 11) and ``fp8_mlp`` (item 10) raise when
    set."""

    pipeline_depth: int = 0
    prefetch_depth: int = 0
    param_prefetch_depth: Optional[int] = None
    fp8_mlp: bool = False
    overlap_depth: Optional[int] = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.pipeline_depth < 0:
            raise ValueError(
                f"performance.pipeline_depth must be >= 0, got "
                f"{self.pipeline_depth}")
        if self.prefetch_depth < 0:
            raise ValueError(
                f"performance.prefetch_depth must be >= 0, got "
                f"{self.prefetch_depth}")
        if self.param_prefetch_depth is not None \
                and self.param_prefetch_depth < 1:
            raise ValueError(
                f"performance.param_prefetch_depth must be >= 1, got "
                f"{self.param_prefetch_depth}")
        if self.overlap_depth is not None and self.overlap_depth < 0:
            raise ValueError(
                f"performance.overlap_depth must be >= 0, got "
                f"{self.overlap_depth}")
        if self.fp8_mlp:
            raise _unported("performance.fp8_mlp=True",
                            f"{_A} 10 (fp8 MLP, ops/fp_quantizer.py)")
        for name in ("param_prefetch_depth", "overlap_depth"):
            if getattr(self, name) is not None:
                raise _unported(f"performance.{name}",
                                f"{_A} 11 (the streamed layer stack, "
                                "runtime/param_stream.py)")


@dataclass
class SparseAttentionConfig:
    """The ``sparse_attention`` block (reference runtime/config.py:250-
    410): dense | fixed | variable | bigbird | bslongformer modes, mapped
    onto the layouts of ``ops/blocksparse_attention.py`` by its
    ``from_config``."""

    mode: str = "fixed"
    block: int = 128
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    local_window_blocks: Any = field(default_factory=lambda: [4])
    global_block_indices: Any = field(default_factory=lambda: [0])
    attention: str = "unidirectional"  # causal; or "bidirectional"

    def validate(self) -> None:
        if self.mode not in ("dense", "fixed", "variable", "bigbird",
                             "bslongformer"):
            raise ValueError(
                f"sparse_attention.mode must be dense|fixed|variable|"
                f"bigbird|bslongformer, got {self.mode!r}")
        if self.attention not in ("unidirectional", "bidirectional"):
            raise ValueError(
                f"sparse_attention.attention must be unidirectional|"
                f"bidirectional, got {self.attention!r}")


@dataclass
class KernelsConfig:
    """The ``kernels`` block, with the JAX schema and validation. The
    port acts on ``blocksparse_block`` (0 follows
    ``sparse_attention.block``: the engine builds the layout at that
    block), ``dispatch`` ("auto": ``impl="auto"`` follows the measured
    kernel table, then the heuristic; "heuristic": the heuristic alone)
    and ``table_path`` (the kernel table to read; None:
    ``ops/kernel_table.table_path()``); ``initialize`` installs the block
    with ``ops.attention.set_kernel_config``. The geometry knobs
    (``flash_block_*``, ``pages_per_compute_block``, ``gmm_block_*``) are
    validated and not used, as the kernels accept their block arguments:
    the Hopper kernels fix their own tiles. A geometry value other than
    the JAX default warns that it has no effect, so JAX configs load and
    nothing set is dropped unseen."""

    flash_block_q: int = 0
    flash_block_k: int = 0
    pages_per_compute_block: int = 1
    gmm_block_m: int = 512
    gmm_block_n: int = 1024
    gmm_block_k: int = 512
    blocksparse_block: int = 0  # 0 = follow sparse_attention.block
    dispatch: str = "auto"  # auto (win/loss table) | heuristic
    table_path: Optional[str] = None

    def validate(self) -> None:
        for name in ("flash_block_q", "flash_block_k", "gmm_block_m",
                     "gmm_block_n", "gmm_block_k", "blocksparse_block"):
            v = getattr(self, name)
            if v < 0 or (v and v & (v - 1)):
                raise ValueError(
                    f"kernels.{name} must be 0 (auto) or a power of "
                    f"two, got {v}")
        if self.pages_per_compute_block < 1:
            raise ValueError(
                f"kernels.pages_per_compute_block must be >= 1, got "
                f"{self.pages_per_compute_block}")
        if self.dispatch not in ("auto", "heuristic"):
            raise ValueError(
                f"kernels.dispatch must be auto|heuristic, got "
                f"{self.dispatch!r}")
        for f in dataclasses.fields(self):
            if f.name in ("blocksparse_block", "dispatch", "table_path"):
                continue
            v = getattr(self, f.name)
            if v != f.default:
                warnings.warn(
                    f"kernels.{f.name}={v!r} has no effect here: the "
                    f"Hopper kernels fix their own tiles")


@dataclass
class CheckpointConfig:
    """The ``checkpoint`` block (reference runtime/config.py:439-471).
    ``async_save`` selects the decoupled checkpoint engine;
    ``tag_validation`` (Ignore | Warn | Fail) decides what a load onto
    another mesh than the save's does after its warning (the state is
    resharded); ``use_node_local_storage`` has no effect (every rank
    writes its own blocks under one directory).
    ``parallel_write_pipeline`` selects the Fast engine (the payload
    through the pipelined AIO writer); with ``async_save`` as well, the
    decoupled engine wins, with a warning (as in JAX).
    ``load_universal`` raises (ROADMAP queue A item 16)."""

    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    async_save: bool = False

    def validate(self) -> None:
        if self.load_universal:
            raise _unported("checkpoint.load_universal=True",
                            f"{_A} 16 (universal checkpoints)")


@dataclass
class ResilienceConfig:
    """The ``resilience`` block, with the JAX schema and validation.

    ``preemption_guard`` installs a SIGTERM listener on the engine: the
    first signal forces an emergency checkpoint at the next GAS boundary
    within ``preemption_save_deadline_s``, into ``emergency_save_dir``
    (default: the directory of the last ``save_checkpoint``); a second
    signal escalates to immediate shutdown. ``manifest`` writes a
    per-tag manifest (per-file sizes and crc32, data cursor) at publish
    and validates it at load, falling back to the previous good tag;
    ``manifest_checksums`` controls the crc32 pass at load. The
    deadlines and retries (``init_timeout_s`` through ``jitter``) bound
    the multi-process control-plane operations of ``comm``: the
    rendezvous, the barrier and the cross-process asserts."""

    enabled: bool = True
    preemption_guard: bool = True
    preemption_save_deadline_s: float = 60.0
    emergency_save_dir: Optional[str] = None
    manifest: bool = True
    manifest_checksums: bool = True
    init_timeout_s: Optional[float] = None
    collective_timeout_s: Optional[float] = None
    max_retries: int = 2
    backoff_base_s: float = 1.0
    backoff_max_s: float = 30.0
    jitter: float = 0.25

    def validate(self) -> None:
        if self.preemption_save_deadline_s <= 0:
            raise ValueError(
                f"resilience.preemption_save_deadline_s must be > 0, got "
                f"{self.preemption_save_deadline_s}")
        if self.max_retries < 0:
            raise ValueError(
                f"resilience.max_retries must be >= 0, got "
                f"{self.max_retries}")
        for name in ("backoff_base_s", "backoff_max_s", "jitter"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"resilience.{name} must be >= 0, got "
                    f"{getattr(self, name)}")
        for name in ("init_timeout_s", "collective_timeout_s"):
            val = getattr(self, name)
            if val is not None and val <= 0:
                raise ValueError(
                    f"resilience.{name} must be > 0 (or null for "
                    f"unbounded), got {val}")


@dataclass
class WatchdogConfig:
    """Stall watchdog (observability/watchdog.py): a step exceeding
    ``max(factor * rolling_mean_step_time, min_seconds)`` triggers a
    report with Python stacks and device memory stats. Env overrides:
    DSTPU_WATCHDOG=0, DSTPU_WATCHDOG_FACTOR, DSTPU_WATCHDOG_MIN_S."""

    enabled: bool = True
    factor: float = 8.0
    min_seconds: float = 30.0


@dataclass
class RequestTraceConfig:
    """Per-request serving traces (observability/request_trace.py): every
    request records a typed span timeline; at FINISH a tail-based
    sampler keeps every SLO violator (TTFT > ``slo_deadline_ms``) plus a
    ``sample_rate`` random slice of the rest in a ``ring_size`` ring.
    Env overrides: DSTPU_REQUEST_TRACE=0, DSTPU_REQ_TRACE_SAMPLE,
    DSTPU_REQ_TRACE_RING, DSTPU_REQ_TRACE_SLO_MS."""

    enabled: bool = True
    sample_rate: float = 0.05
    ring_size: int = 4096
    slo_deadline_ms: Optional[float] = None

    def validate(self) -> None:
        if not 0.0 <= self.sample_rate <= 1.0:
            raise ValueError(
                f"observability.request_trace.sample_rate must be in "
                f"[0, 1], got {self.sample_rate}")
        if self.ring_size < 1:
            raise ValueError(
                f"observability.request_trace.ring_size must be >= 1, "
                f"got {self.ring_size}")
        if self.slo_deadline_ms is not None and self.slo_deadline_ms <= 0:
            raise ValueError(
                f"observability.request_trace.slo_deadline_ms must be "
                f"> 0 (or null), got {self.slo_deadline_ms}")


@dataclass
class ClockSyncConfig:
    """The fleet's per-channel clock sync (JAX's fields and defaults).
    Parsed; a value other than its default raises, naming ROADMAP queue
    A item 13: the channels it syncs are the serving fleet's."""

    enabled: bool = True
    rounds: int = 8
    resync_seconds: float = 5.0
    k: int = 5
    window: int = 32
    min_samples: int = 3

    def validate(self) -> None:
        _defaults_only(self, "observability.clock_sync", _FLEET_SERVING)


@dataclass
class JournalConfig:
    """The fleet's black-box journal (JAX's fields and defaults; off by
    default). Parsed; a value other than its default raises, naming
    ROADMAP queue A item 13."""

    enabled: bool = False
    dir: str = "dstpu_journal"
    max_mb: float = 64.0

    def validate(self) -> None:
        _defaults_only(self, "observability.journal", _FLEET_SERVING)


def _defaults_only(block, name: str, item: str) -> None:
    for f in dataclasses.fields(block):
        value = getattr(block, f.name)
        if value != f.default:
            raise _unported(f"{name}.{f.name}={value!r}", item)


@dataclass
class ObservabilityConfig:
    """The ``observability`` block (JAX's schema; the hub is on by
    default). Per-step ``StepTrace`` rows flow to the process-wide hub
    (observability/hub.py); ``jsonl_path`` / ``prometheus_path`` stream
    them to disk (env: DSTPU_METRICS_JSONL / DSTPU_METRICS_PROM), the
    Prometheus page every ``prometheus_every_steps`` steps;
    ``step_history`` bounds the in-memory rows. ``xla_cost_analysis``
    (JAX's name; env DSTPU_ROOFLINE=1) turns on the engine's roofline
    after step 2, from the counted step (observability/attribution.py).
    ``flight_events`` sizes the crash flight recorder's ring (0
    disables it). ``watchdog`` and ``request_trace`` are their blocks.
    Not ported: ``run_dir`` (the fleet publisher; ``publish_every_steps``
    and ``stale_after_seconds`` are its knobs, accepted and unused as in
    a JAX run without a run dir), ``quant_stats`` (ROADMAP queue A item
    10), ``clock_sync`` and ``journal`` (item 13)."""

    enabled: bool = True
    quant_stats: bool = False
    jsonl_path: Optional[str] = None
    prometheus_path: Optional[str] = None
    prometheus_every_steps: int = 10
    step_history: int = 512
    xla_cost_analysis: bool = False
    run_dir: Optional[str] = None
    publish_every_steps: int = 1
    stale_after_seconds: float = 30.0
    flight_events: int = 4096
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    request_trace: RequestTraceConfig = field(
        default_factory=RequestTraceConfig)
    clock_sync: ClockSyncConfig = field(default_factory=ClockSyncConfig)
    journal: JournalConfig = field(default_factory=JournalConfig)

    @classmethod
    def from_dict(cls, data) -> "ObservabilityConfig":
        data = dict(data or {})
        subs = {"watchdog": WatchdogConfig,
                "request_trace": RequestTraceConfig,
                "clock_sync": ClockSyncConfig, "journal": JournalConfig}
        for name, klass in subs.items():
            data[name] = _block(klass, data.get(name),
                                f"observability.{name}")
        return _block(cls, data, "observability")

    def validate(self) -> None:
        self.request_trace.validate()
        self.clock_sync.validate()
        self.journal.validate()
        if self.flight_events < 0:
            raise ValueError(
                f"observability.flight_events must be >= 0, got "
                f"{self.flight_events}")
        if self.publish_every_steps < 1:
            raise ValueError(
                f"observability.publish_every_steps must be >= 1, got "
                f"{self.publish_every_steps}")
        if self.run_dir:
            raise _unported(f"observability.run_dir={self.run_dir!r}",
                            _FLEET)
        if self.quant_stats:
            raise _unported("observability.quant_stats=True",
                            f"{_A} 10 (ZeRO++'s quantization telemetry)")


@dataclass
class MonitorBackendConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJob"
    team: Optional[str] = None
    project: Optional[str] = None
    group: Optional[str] = None


@dataclass
class MonitorConfig:
    """The ``monitor`` block (reference deepspeed/monitor/config.py;
    ``monitor/monitor.MonitorMaster``). The reference's top-level
    ``tensorboard`` / ``csv_monitor`` / ``wandb`` / ``comet`` blocks are
    hoisted into it, as JAX does."""

    tensorboard: MonitorBackendConfig = field(
        default_factory=MonitorBackendConfig)
    csv_monitor: MonitorBackendConfig = field(
        default_factory=MonitorBackendConfig)
    wandb: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    comet: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    jsonl: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)

    @classmethod
    def from_dict(cls, data, top) -> "MonitorConfig":
        data = dict(data or {})
        for name in ("tensorboard", "csv_monitor", "wandb", "comet"):
            if top.get(name) is not None:
                data[name] = top[name]
        return _block(cls, {
            k: _block(MonitorBackendConfig, v, f"monitor.{k}")
            if isinstance(v, dict) or v is None else v
            for k, v in data.items()}, "monitor")


def _block(klass, data, name):
    """A dataclass block from a dict (None means defaults); unknown keys
    warn, as the JAX ConfigModel does."""
    if data is None:
        return klass()
    if not isinstance(data, dict):
        raise TypeError(f"config block '{name}' must be a dict, got "
                        f"{type(data).__name__}")
    known = {f.name for f in dataclasses.fields(klass)}
    for key in sorted(set(data) - known):
        warnings.warn(f"{klass.__name__}: ignoring unknown config key "
                      f"'{key}'")
    return klass(**{k: v for k, v in data.items() if k in known})


@dataclass
class Config:
    """Top-level config. Build with :func:`load_config`; solve the batch
    triple with :meth:`resolve_batch_size`."""

    train_batch_size: Any = None
    train_micro_batch_size_per_chip: Any = None
    gradient_accumulation_steps: Any = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    # parsed as JAX parses them; nothing in JAX's engine reads them (its
    # gradient reductions are XLA's), and the port's reduce in the
    # gradient's own dtype and divide once after the sum
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    communication_data_type: Optional[str] = None
    seed: int = 42
    bf16: BF16Config = field(default_factory=BF16Config)
    fp16: FP16Config = field(default_factory=FP16Config)
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    comms_logger: CommsLoggerConfig = field(
        default_factory=CommsLoggerConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    sparse_attention: Optional[SparseAttentionConfig] = None
    kernels: KernelsConfig = field(default_factory=KernelsConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    performance: PerformanceConfig = field(
        default_factory=PerformanceConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    monitor: MonitorConfig = field(default_factory=MonitorConfig)
    # JAX's switches: the timers' log line every steps_per_print, the
    # memory breadcrumbs at init, and dump_state (parsed; JAX reads it
    # nowhere either)
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    dump_state: bool = False

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "Config":
        data = dict(data or {})
        for old, new in _DEPRECATED.items():
            if old in data:
                data.setdefault(new, data.pop(old))
        for name, item in UNPORTED_BLOCKS.items():
            if data.get(name) is not None:
                raise _unported(f"block '{name}'", item)
        zero = dict(data.get("zero_optimization") or {})
        for name, (off, item) in ZERO_SWITCHES.items():
            value = zero.pop(name, off)
            if not (_offload_off(value) if name == "offload_param"
                    else value == off):
                raise _unported(f"zero_optimization.{name}={value!r}", item)
        for name in ZERO_NOOP_KEYS:
            zero.pop(name, None)
        if zero.get("offload_optimizer") is not None:
            off = zero["offload_optimizer"]
            if isinstance(off, dict) and off.get("device") is None:
                off = dict(off, device="none")
            zero["offload_optimizer"] = _block(
                OffloadOptimizerConfig, off,
                "zero_optimization.offload_optimizer")
        if zero.get("zenflow") is not None:
            zero["zenflow"] = _block(ZenFlowBlockConfig, zero["zenflow"],
                                     "zero_optimization.zenflow")
        blocks = {"bf16", "fp16", "optimizer", "scheduler",
                  "zero_optimization", "moe", "comms_logger", "serving",
                  "sparse_attention", "kernels", "checkpoint", "resilience",
                  "performance", "observability", "monitor"}
        monitors = {"tensorboard", "csv_monitor", "wandb", "comet"}
        scalars = {f.name for f in dataclasses.fields(cls)} - blocks
        known = (scalars | blocks | monitors
                 | set(UNPORTED_BLOCKS))
        for key in sorted(set(data) - known):
            warnings.warn(f"Config: ignoring unknown config key '{key}'")
        cfg = cls(
            **{k: data[k] for k in scalars if k in data},
            bf16=_block(BF16Config, data.get("bf16"), "bf16"),
            fp16=_block(FP16Config, data.get("fp16"), "fp16"),
            optimizer=(None if data.get("optimizer") is None else
                       _block(OptimizerConfig, data["optimizer"],
                              "optimizer")),
            scheduler=(None if data.get("scheduler") is None else
                       _block(SchedulerConfig, data["scheduler"],
                              "scheduler")),
            zero_optimization=_block(ZeroConfig, zero, "zero_optimization"),
            moe=_block(MoEConfig, data.get("moe"), "moe"),
            comms_logger=_block(CommsLoggerConfig, data.get("comms_logger"),
                                "comms_logger"),
            serving=_block(ServingConfig, data.get("serving"), "serving"),
            sparse_attention=(None if data.get("sparse_attention") is None
                              else _block(SparseAttentionConfig,
                                          data["sparse_attention"],
                                          "sparse_attention")),
            kernels=_block(KernelsConfig, data.get("kernels"), "kernels"),
            checkpoint=_block(CheckpointConfig, data.get("checkpoint"),
                              "checkpoint"),
            resilience=_block(ResilienceConfig, data.get("resilience"),
                              "resilience"),
            performance=_block(PerformanceConfig, data.get("performance"),
                               "performance"),
            observability=ObservabilityConfig.from_dict(
                data.get("observability")),
            monitor=MonitorConfig.from_dict(data.get("monitor"), data))
        cfg.validate()
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        """The config as nested dicts (the checkpoint's metadata.json)."""
        return dataclasses.asdict(self)

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.fp16.enabled:
            return torch.float16
        if self.bf16.enabled:
            return torch.bfloat16
        return torch.float32

    def validate(self) -> None:
        if self.fp16.enabled and self.bf16.enabled:
            # bf16 defaults on, so an explicit fp16 wins (as in JAX)
            self.bf16.enabled = False
        if self.gradient_clipping < 0:
            raise ValueError("gradient_clipping must be >= 0")
        self.zero_optimization.validate()
        self.moe.validate()
        if self.sparse_attention is not None:
            self.sparse_attention.validate()
        self.kernels.validate()
        self.checkpoint.validate()
        self.resilience.validate()
        self.observability.validate()

    def resolve_batch_size(self, dp_world_size: int) -> None:
        """Solve train_batch = micro x GAS x dp (the JAX solver,
        including its errors); mutates the config in place."""
        def given(v):
            return None if v is None or v == "auto" else v

        tb = given(self.train_batch_size)
        mb = given(self.train_micro_batch_size_per_chip)
        gas = given(self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ValueError(
                    f"Inconsistent batch config: train_batch_size={tb} != "
                    f"micro({mb}) * gas({gas}) * dp({dp_world_size})")
        elif tb is not None and mb is not None:
            if tb % (mb * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size={tb} not divisible by micro*dp="
                    f"{mb * dp_world_size}")
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            if tb % (gas * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size={tb} not divisible by gas*dp="
                    f"{gas * dp_world_size}")
            mb = tb // (gas * dp_world_size)
        elif mb is not None:
            gas = gas if gas is not None else 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            mb = max(1, tb // dp_world_size)
            gas = tb // (mb * dp_world_size)
            if tb != mb * gas * dp_world_size:
                raise ValueError(
                    f"train_batch_size={tb} not divisible by "
                    f"dp={dp_world_size}")
        elif gas is not None:
            mb = 1
            tb = mb * gas * dp_world_size
        else:
            mb, gas = 1, 1
            tb = dp_world_size
        self.train_batch_size = int(tb)
        self.train_micro_batch_size_per_chip = int(mb)
        self.gradient_accumulation_steps = int(gas)
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")


def load_config(config) -> Config:
    """Accept a path to JSON, a dict, an existing Config, or None."""
    if config is None:
        return Config.from_dict({})
    if isinstance(config, Config):
        return config
    if isinstance(config, str):
        if not os.path.exists(config):
            raise FileNotFoundError(f"config file not found: {config}")
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise TypeError(
            f"config must be a path, dict, or Config; got {type(config)}")
    return Config.from_dict(config)


__all__ = ["Config", "OptimizerConfig", "SchedulerConfig", "CommsLoggerConfig",
           "BF16Config",
           "FP16Config", "OffloadOptimizerConfig", "ZenFlowBlockConfig",
           "ZeroConfig", "MoEConfig", "ServingConfig",
           "SparseAttentionConfig", "KernelsConfig", "CheckpointConfig",
           "ResilienceConfig", "PerformanceConfig", "ObservabilityConfig",
           "WatchdogConfig", "RequestTraceConfig", "ClockSyncConfig",
           "JournalConfig", "MonitorConfig", "MonitorBackendConfig",
           "load_config"]
