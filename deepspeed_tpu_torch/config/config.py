"""The ds_config tree, trimmed to what the single-card training engine
runs (port of ``deepspeed_tpu/config/config.py``).

Parsed: the batch triple and its solver (``resolve_batch_size``),
``steps_per_print``, ``gradient_clipping``, ``seed``, the ``bf16`` and
``fp16`` blocks, ``optimizer``, ``scheduler``,
``zero_optimization.stage`` and the ``moe`` block (``ep_size`` 1). A
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
    "sparse_attention": "ROADMAP queue B item 9 (block-sparse attention)",
    "kernels": f"{_A} 3 (kernel registry and table)",
    "performance": f"{_A} 4 (dispatch-ahead, input prefetch, fp8 MLP)",
    "checkpoint": f"{_A} 6 (checkpoint and resilience)",
    "resilience": f"{_A} 6 (checkpoint and resilience)",
    "serving": f"{_A} 8 and 13 (serving configuration)",
    "observability": f"{_A} 14 (observability)",
    "monitor": f"{_A} 14 (observability)",
    "comms_logger": f"{_A} 14 (observability)",
    "flops_profiler": f"{_A} 16 (profiling)",
    "tensorboard": f"{_A} 14 (observability)",
    "csv_monitor": f"{_A} 14 (observability)",
    "wandb": f"{_A} 14 (observability)",
    "comet": f"{_A} 14 (observability)",
    "compile": f"{_A} 16 (compile passes)",
    "elasticity": f"{_A} 16 (elasticity)",
    "data_efficiency": f"{_A} 16 (data pipeline)",
}
# top-level switches of the JAX schema: accepted at their defaults only
UNPORTED_SWITCHES = {
    "wall_clock_breakdown": (False, f"{_A} 14 (observability)"),
    "memory_breakdown": (False, f"{_A} 14 (observability)"),
    "dump_state": (False, f"{_A} 14 (observability)"),
    "prescale_gradients": (False, f"{_A} 5 (ZeRO and communication)"),
    "gradient_predivide_factor": (1.0, f"{_A} 5 (ZeRO and communication)"),
    "communication_data_type": (None, f"{_A} 5 (ZeRO and communication)"),
}
# zero_optimization keys: accepted at their "off" values only
ZERO_SWITCHES = {
    "offload_param": (None, f"{_A} 12 (offload)"),
    "offload_optimizer": (None, f"{_A} 12 (offload)"),
    "zenflow": (None, f"{_A} 12 (offload)"),
    "zero_quantized_weights": (False, f"{_A} 10 (ZeRO++)"),
    "zero_quantized_gradients": (False, f"{_A} 10 (ZeRO++)"),
    "zero_quantized_allreduce": (False, f"{_A} 10 (ZeRO++)"),
    "zero_hpz_partition_size": (1, f"{_A} 10 (ZeRO++)"),
    "mics_shard_size": (-1, f"{_A} 10 (ZeRO++ MiCS)"),
    "mics_hierarchical_params_gather": (False, f"{_A} 10 (ZeRO++ MiCS)"),
}
# zero_optimization tuning knobs with no effect on one card (they bound
# bucketing and persistence across ranks)
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
class ZeroConfig:
    """Stages 0-3 are the same math on one card (the JAX engine's stages
    are shardings over ranks; sharding is ROADMAP queue A item 5)."""

    stage: int = 0

    def validate(self) -> None:
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(
                f"zero_optimization.stage must be 0-3, got {self.stage}")


@dataclass
class MoEConfig:
    """The JAX ``moe`` block. The engine applies ``impl`` to an MoE
    model's config; the other fields are the model zoo's defaults, as in
    the JAX engine. On one card ``ep_size`` must be 1."""

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
    seed: int = 42
    bf16: BF16Config = field(default_factory=BF16Config)
    fp16: FP16Config = field(default_factory=FP16Config)
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "Config":
        data = dict(data or {})
        for old, new in _DEPRECATED.items():
            if old in data:
                data.setdefault(new, data.pop(old))
        for name, item in UNPORTED_BLOCKS.items():
            if data.get(name) is not None:
                raise _unported(f"block '{name}'", item)
        for name, (default, item) in UNPORTED_SWITCHES.items():
            if data.get(name, default) != default:
                raise _unported(f"'{name}={data[name]!r}'", item)
        zero = dict(data.get("zero_optimization") or {})
        for name, (off, item) in ZERO_SWITCHES.items():
            value = zero.pop(name, off)
            if not (_offload_off(value) if off is None else value == off):
                raise _unported(f"zero_optimization.{name}={value!r}", item)
        for name in ZERO_NOOP_KEYS:
            zero.pop(name, None)
        blocks = {"bf16", "fp16", "optimizer", "scheduler",
                  "zero_optimization", "moe"}
        scalars = {f.name for f in dataclasses.fields(cls)} - blocks
        known = (scalars | blocks
                 | set(UNPORTED_BLOCKS) | set(UNPORTED_SWITCHES))
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
            moe=_block(MoEConfig, data.get("moe"), "moe"))
        cfg.validate()
        return cfg

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


__all__ = ["Config", "OptimizerConfig", "SchedulerConfig", "BF16Config",
           "FP16Config", "ZeroConfig", "MoEConfig", "load_config"]
