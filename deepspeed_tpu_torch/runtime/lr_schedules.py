"""Learning-rate schedules (port of
``deepspeed_tpu/runtime/lr_schedules.py``): the same five families with
the same config names and params, as ``step -> lr`` functions on Python
floats (the engine evaluates them on the host once per step).

  LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR, WarmupCosineLR
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[float], float]  # step -> lr


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    def schedule(step):
        s = step / lr_range_test_step_size
        if lr_range_test_staircase:
            s = math.floor(s)
        return lr_range_test_min_lr * (1.0 + s * lr_range_test_step_rate)

    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0,
              decay_lr_rate: float = 0.0,
              cycle_first_stair_count: int = 0,
              cycle_second_stair_count: Optional[int] = None,
              **_unused) -> Schedule:
    second = cycle_second_step_size or cycle_first_step_size

    def schedule(step):
        step = float(step)
        up = _clip(step / cycle_first_step_size, 0.0, 1.0)
        down = _clip((step - cycle_first_step_size) / second, 0.0, 1.0)
        in_cycle = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (up - down)
        post = step - (cycle_first_step_size + second)
        if post <= 0:
            return in_cycle
        if decay_step_size > 0:
            return cycle_min_lr / (1.0 + post / decay_step_size
                                   * decay_lr_rate)
        return cycle_min_lr

    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000,
              warmup_type: str = "log", **_unused) -> Schedule:
    def schedule(step):
        frac = _clip((float(step) + 1.0) / warmup_num_steps, 0.0, 1.0)
        if warmup_type == "log":
            gamma = math.log(frac * (math.e - 1.0) + 1.0)
        else:
            gamma = frac
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001,
                    warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_unused) -> Schedule:
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def schedule(step):
        step = float(step)
        if step < warmup_num_steps:
            return warm(step)
        decay = _clip((total_num_steps - step)
                      / max(total_num_steps - warmup_num_steps, 1.0),
                      0.0, 1.0)
        return warmup_max_lr * decay

    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.01,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001, **_unused) -> Schedule:
    def schedule(step):
        step = float(step)
        if step < warmup_num_steps:
            ratio = warmup_min_ratio + (1.0 - warmup_min_ratio) * _clip(
                step / max(warmup_num_steps, 1), 0.0, 1.0)
        else:
            progress = _clip((step - warmup_num_steps)
                             / max(total_num_steps - warmup_num_steps, 1.0),
                             0.0, 1.0)
            ratio = cos_min_ratio + (1.0 - cos_min_ratio) * 0.5 * (
                1.0 + math.cos(math.pi * progress))
        return warmup_max_lr * ratio

    return schedule


_FACTORIES = {
    "LRRangeTest": lr_range_test,
    "OneCycle": one_cycle,
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
}


def get_lr_schedule(scheduler_config, base_lr: float = 0.001
                    ) -> Optional[Schedule]:
    """Build a schedule from the config block (None when there is none)."""
    if scheduler_config is None or scheduler_config.type is None:
        return None
    name = scheduler_config.type
    if name not in _FACTORIES:
        raise ValueError(
            f"unknown scheduler '{name}'; valid: {sorted(_FACTORIES)}")
    params = dict(scheduler_config.params or {})
    if name in ("WarmupLR", "WarmupDecayLR", "WarmupCosineLR"):
        params.setdefault("warmup_max_lr", base_lr)
    return _FACTORIES[name](**params)
