"""Dynamic loss scaling for fp16 (port of
``deepspeed_tpu/runtime/loss_scaler.py``). bf16 training does not need
it; it engages only when ``fp16.enabled`` is set.

The same state transition as the JAX one, on host values: scale the loss
up, unscale the grads, detect inf/nan, and on overflow skip the update
and halve the scale (not below ``min_loss_scale``); after
``loss_scale_window`` clean steps, double it. A static ``loss_scale``
never moves.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float
    good_steps: int


def init_loss_scale(config) -> LossScaleState:
    """From the fp16 config block."""
    if config.loss_scale and config.loss_scale > 0:
        return LossScaleState(float(config.loss_scale), 0)  # static
    return LossScaleState(float(2.0 ** config.initial_scale_power), 0)


def has_overflow(grads: Iterable[torch.Tensor]) -> bool:
    """True when any gradient holds an inf or nan (one host read)."""
    flags = [~torch.isfinite(g).all() for g in grads]
    return bool(torch.stack(flags).any()) if flags else False


def update_loss_scale(state: LossScaleState, overflow: bool, config
                      ) -> LossScaleState:
    if config.loss_scale and config.loss_scale > 0:
        return state  # static scaling never adjusts
    if overflow:
        return LossScaleState(max(state.scale / 2.0, config.min_loss_scale),
                              0)
    if state.good_steps + 1 >= config.loss_scale_window:
        return LossScaleState(state.scale * 2.0, 0)
    return LossScaleState(state.scale, state.good_steps + 1)
