"""Single-card training engine (port of ``deepspeed_tpu/runtime/engine.py``).

``initialize(model=..., config=...)`` returns the JAX package's 4-tuple
(engine, optimizer view, dataloader, lr schedule). ``Engine.train_batch``
pulls ``gradient_accumulation_steps`` microbatches (dicts of numpy arrays,
moved to the engine's device), back-propagates ``loss * scale / gas``
through each, then applies one optimizer step: the fp16 loss-scale
overflow skip, the global-norm clip and AdamW on the fp32 masters, and
the compute params recast from them. An ``MoETransformerLM`` trains the
same way; its loss is the LM loss plus the routers' aux loss, and the
config's ``moe.impl`` is applied to its config, as the JAX engine does.

The engine takes its fp32 masters from the model's current tensors (a
model built in fp32 shares them, so its parameters follow training) and
keeps compute-dtype params (``config.compute_dtype``) that require grad;
the model's forward runs in that dtype. ZeRO stages 0-3 are accepted and
are the same math at world size 1; sharding over ranks is ROADMAP queue
A item 5.

Not ported yet (ROADMAP queue A item 4 and later): dispatch-ahead, the
input prefetcher, the dataloader, the ``forward`` / ``backward`` /
``step`` micro-step API, checkpoints, and the watchdog, flight
recorder, observability hub and chaos hooks.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch._device import DeviceLike, resolve_device
from deepspeed_tpu_torch.config.config import Config, load_config
from deepspeed_tpu_torch.models import moe_transformer
from deepspeed_tpu_torch.models.transformer import loss_fn
from deepspeed_tpu_torch.runtime.loss_scaler import (has_overflow,
                                                     init_loss_scale,
                                                     update_loss_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.optimizer import (
    apply_mixed_precision_update, get_base_optimizer, init_mixed_precision,
    leaves, tree_map)

logger = logging.getLogger(__name__)


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, collate_fn=None,
               config=None, config_params=None, device: DeviceLike = None):
    """Reference-parity entry point. ``model`` is a ``TransformerLM`` or
    an ``MoETransformerLM`` (``models/zoo.get_model``); ``device``
    defaults to the card.
    Returns (engine, optimizer_view, dataloader, lr_schedule); the
    dataloader is None (not ported yet)."""
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    for name, value, item in (
            ("optimizer", optimizer, "a client optimizer"),
            ("model_parameters", model_parameters,
             "a (loss_fn, params) model"),
            ("training_data", training_data, "the dataloader"),
            ("lr_scheduler", lr_scheduler, "a client LR scheduler"),
            ("collate_fn", collate_fn, "the dataloader")):
        if value is not None:
            raise NotImplementedError(
                f"initialize({name}=...): {item} is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP queue A item 4)")
    config = config if config is not None else config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    engine = Engine(model, load_config(config), device=device)
    return engine, engine.optimizer, None, engine.lr_schedule


class _OptimizerView:
    """``optimizer.param_groups[0]["lr"]``, read-only."""

    def __init__(self, engine: "Engine"):
        self._engine = engine

    @property
    def param_groups(self) -> List[Dict[str, float]]:
        return [{"lr": self._engine.get_lr()[0]}]


class Engine:
    """Owns the compute params, the fp32 masters and optimizer state, and
    the loss scale; runs one fused training step per ``train_batch``."""

    def __init__(self, model, config: Config, device: DeviceLike = None):
        if not (hasattr(model, "params") and hasattr(model, "config")):
            raise TypeError("Engine needs a TransformerLM (models/zoo."
                            "get_model); other models are not ported yet")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model's weights live on {model.device}, "
                             f"the engine runs on {self.device}: move the "
                             "model or pass device=")
        self.model = model
        self.config = config
        config.resolve_batch_size(1)  # one card: world size 1
        self.micro_batch_size = config.train_micro_batch_size_per_chip
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.train_batch_size = config.train_batch_size
        self.compute_dtype = config.compute_dtype
        over = {"dtype": self.compute_dtype}
        if isinstance(model.config, moe_transformer.MoETransformerConfig):
            self._loss_fn = moe_transformer.loss_fn
            if config.moe.impl != "auto":
                over["moe_impl"] = config.moe.impl
        else:
            self._loss_fn = loss_fn
        self.model_config = dataclasses.replace(model.config, **over)

        self.lr_schedule = get_lr_schedule(config.scheduler,
                                           base_lr=self._config_lr())
        self.tx, self._base_lr = get_base_optimizer(config.optimizer,
                                                    self.lr_schedule)
        self.opt_state = init_mixed_precision(model.params(), self.tx)
        cdt = self.compute_dtype
        with torch.no_grad():
            self.params = tree_map(
                lambda m: m.to(cdt, copy=True).requires_grad_(),
                self.opt_state.master)
        self.loss_scale_state = init_loss_scale(config.fp16)

        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0
        self._last_grad_norm: Optional[torch.Tensor] = None
        self.last_metrics: Dict[str, Any] = {}
        n_params = sum(p.numel() for _, p in leaves(self.params))
        logger.info(
            f"engine ready: {n_params / 1e6:.1f}M params, zero_stage="
            f"{config.zero_optimization.stage}, micro="
            f"{self.micro_batch_size}, gas="
            f"{self.gradient_accumulation_steps}, dtype={cdt}, "
            f"device={self.device}")

    def _config_lr(self) -> float:
        opt = self.config.optimizer
        if opt is not None and "lr" in (opt.params or {}):
            return opt.params["lr"]
        return 1e-3

    # -- data --------------------------------------------------------------
    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A microbatch (numpy arrays, or tensors) on the engine's device."""
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def _next_microbatches(self, data_iter, n: int):
        out = []
        for i in range(n):
            try:
                out.append(next(data_iter))
            except StopIteration:
                if i == 0:
                    raise  # clean end-of-data at a boundary
                raise RuntimeError(
                    f"data iterator exhausted mid-gradient-accumulation "
                    f"(got {i} of {n} microbatches)") from None
        return [self._to_device(b) for b in out]

    # -- training ------------------------------------------------------------
    def train_batch(self, data_iter) -> torch.Tensor:
        """One training step over ``gradient_accumulation_steps``
        microbatches from ``data_iter``. Returns the mean microbatch loss
        (a 0-dim fp32 tensor on the device)."""
        gas = self.gradient_accumulation_steps
        batches = self._next_microbatches(data_iter, gas)
        fp16 = self.config.fp16.enabled
        scale = self.loss_scale_state.scale if fp16 else 1.0
        losses, model_metrics = [], []
        for mb in batches:
            loss, aux = self._loss_fn(self.model_config, self.params, mb)
            (loss * scale / gas).backward()
            losses.append(loss.detach())
            model_metrics.append(aux)
        grads = tree_map(lambda p: p.grad, self.params)
        overflow = has_overflow(g for _, g in leaves(grads)) if fp16 else False
        lr = self.get_lr()[0]
        gnorm = apply_mixed_precision_update(
            self.opt_state, grads, self.tx, self.params,
            grad_clip=self.config.gradient_clipping,
            grad_scale=scale if fp16 else None, skip=overflow)
        for _, p in leaves(self.params):
            p.grad = None
        if fp16:
            self.loss_scale_state = update_loss_scale(
                self.loss_scale_state, overflow, self.config.fp16)
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        self.skipped_steps += int(overflow)
        self._last_grad_norm = gnorm
        mean_loss = torch.stack(losses).mean()
        self.last_metrics = {"loss": mean_loss, "grad_norm": gnorm, "lr": lr,
                             "loss_scale": self.loss_scale_state.scale,
                             "overflow": overflow}
        # the model's own metrics (an MoE loss's lm_loss and aux_loss),
        # averaged over the microbatches
        for key in model_metrics[0]:
            if key not in self.last_metrics:
                self.last_metrics[key] = torch.stack(
                    [m[key].detach().float() for m in model_metrics]).mean()
        if self.global_steps % self.config.steps_per_print == 0:
            logger.info(f"step={self.global_steps}, loss={float(mean_loss):.4f}, "
                        f"lr={lr:.3e}, grad_norm={float(gnorm):.3f}")
        return mean_loss

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        loss, _aux = self._loss_fn(self.model_config, self.params,
                                   self._to_device(batch))
        return loss

    # -- state accessors -----------------------------------------------------
    @property
    def optimizer(self) -> _OptimizerView:
        return _OptimizerView(self)

    @property
    def loss_scale(self) -> float:
        return self.loss_scale_state.scale

    def get_lr(self) -> List[float]:
        """The LR of the next update (the schedule at the count of
        updates applied so far)."""
        return [self.tx.lr_at(self.opt_state.count)]

    def get_global_grad_norm(self) -> Optional[torch.Tensor]:
        return self._last_grad_norm


__all__ = ["initialize", "Engine"]
