"""Single-card training engine (port of ``deepspeed_tpu/runtime/engine.py``).

``initialize(model=..., config=...)`` returns the JAX package's 4-tuple
(engine, optimizer view, dataloader, lr schedule); with
``training_data`` the dataloader is a ``DeepSpeedDataLoader`` at the
micro batch size. ``Engine.train_batch`` pulls
``gradient_accumulation_steps`` microbatches (dicts of numpy arrays,
moved to the engine's device; from the dataloader when no iterator is
given), back-propagates each one's loss, then applies one optimizer
step: the fp16 loss-scale overflow skip, the global-norm clip and AdamW
on the fp32 masters, and the compute params recast from them. The
micro-step API does the same in the user's loop: ``loss =
engine(batch)`` (``forward``, keeping the autograd graph),
``engine.backward(loss)`` (back-propagated into the accumulated grads)
and ``engine.step()`` (the update, at the accumulation boundary only).
Gradient accumulation follows JAX's order at GAS > 1: each
microbatch's ``loss * scale`` is back-propagated, and a hook on each
parameter (``register_post_accumulate_grad_hook``) folds the
compute-dtype gradient into an fp32 accumulator as ``g.float() *
(1/gas)`` and frees it at once, so a bf16 run accumulates in fp32 (as
JAX's ``backward``) for ~4 bytes a parameter, less the freed
compute-dtype grads. At GAS 1 ``loss * scale`` goes into ``p.grad``.
An ``MoETransformerLM`` trains the same way; its loss is the LM loss plus
the routers' aux loss, and the config's ``moe.impl`` is applied to its
config, as the JAX engine does.

The ``sparse_attention`` block builds its layout (at
``kernels.blocksparse_block`` when that is set) and installs it for
``attn_impl="blocksparse"``; an engine without the block clears any
layout a previous engine installed. The ``kernels`` block (the dispatch
policy and the kernel table's path) goes into the same process-global
dispatcher (``ops.attention.set_kernel_config``, JAX
``engine.py:212``).

The engine takes its fp32 masters from the model's current tensors (a
model built in fp32 shares them, so its parameters follow training) and
keeps compute-dtype params (``config.compute_dtype``) that require grad;
the model's forward runs in that dtype.

ZeRO across ranks (``comm``, ``parallel/topology``,
``runtime/sharding`` and ``runtime/zero``): ``initialize`` joins the
job's process group (``comm.init_distributed``: NCCL on the card, gloo
on the CPU) and builds JAX's default mesh, fsdp = world at stage >= 1,
dp = world at stage 0; the batch triple is solved against the
data-parallel size and each rank's data iterator yields its own rows.
Stage 1 steps each rank's block of the fp32 masters and moments (the
``embed`` dim of each leaf over the fsdp ranks) and all-gathers the
updated compute params; stage 2 reduce-scatters each gradient as it is
ready (the fp32 accumulators of GAS > 1 are blocks too); stage 3 keeps
the compute params as blocks and gathers each layer at its use
(``sharding.param_fetch``), its gradient reduce-scattered in the
backward. The global-norm clip sums each rank's part and all-reduces
one fp32 scalar; fp16's overflow decision is agreed across ranks; the
loss is averaged over the ranks. Without a process group (one process)
the engine runs as before, with no collective. At world size > 1 the
optimizer offload tiers, ZenFlow, MoE models, a client optimizer or a
non-elementwise optimizer at stage >= 1, and mesh axes other than dp
and fsdp raise ``NotImplementedError`` naming their ROADMAP item.

ZeRO-Offload (``zero_optimization.offload_optimizer``, device cpu or
nvme; ``runtime/offload.py``): only the compute-dtype params and their
grads live on the card. The fp32 masters and the optimizer moments live
on the host (or on a local disk) and the native CPU optimizer steps them
(adam, adamw, lion, adagrad, as in JAX), with the LR from the schedule
at the update count. The grads then accumulate in ``p.grad`` in the
compute dtype at GAS > 1 (``loss * scale / gas`` back-propagated per
microbatch, JAX's offload numerics; no fp32 accumulators on the card),
on both APIs. ``offload_states`` / ``reload_states`` empty and refill
the card storage of the params and the device optimizer's state.

ZenFlow (``zero_optimization.zenflow`` beside the cpu tier;
``runtime/zenflow.py``) takes the host optimizer's place: the engine
builds only the ZenFlow optimizer, whose fp32 masters come from the
model's fp32 tensors leaf by leaf. Each update takes one coefficient for
the unscaling and the clip (the fp32 global norm on the card), rounds it
to the grads' dtype and multiplies the grads by it; an fp16 step with a
non-finite norm is skipped without counting an update. The LR comes from
the schedule at the update count.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``,
``checkpoint/state.py``) and the resilience layer follow the JAX engine:
a data cursor in every checkpoint (``resume_data_iter``), the chaos
injector's step and input hooks (armed only by ``DSTPU_CHAOS``), a
finished async save published at the next GAS boundary, and the
``PreemptionGuard``: after a preemption notice the next GAS boundary
lands an emergency checkpoint and sets ``preempted``. A checkpoint saved
inside an accumulation window holds the state of the last update, as in
JAX: the fp32 accumulators are not state, and the cursor counts whole
windows, so a resume replays the window's microbatches.

The JAX engine's ``set_lr``, ``zero_grad``, ``no_sync``, ``train`` /
``eval`` and ``register_post_step_hook`` behave as there (hooks run at
every ``global_steps`` increment, on both APIs, an fp16 step that skipped
its update included).

A ``(loss_fn, params)`` pair trains as a model does
(``initialize(model=loss_fn, model_parameters=params)``;
``loss_fn(params, batch)`` returns a loss or ``(loss, aux)``): the engine
keeps fp32 masters and compute-dtype copies of its leaves, by tree path,
as for a zoo model. A client optimizer (``initialize(optimizer=...)``, a
``torch.optim.Optimizer`` over the model's fp32 parameters, or a callable
``params -> Optimizer``) steps the fp32 masters in the configured
optimizer's place; the loss scaling, the clip and the accumulation stay
the engine's, and its ``state_dict`` is the checkpoint's optimizer
payload. A client LR scheduler is stored and returned, as JAX does.

The pipelined loop (the ``performance`` block): with ``pipeline_depth``
K (or ``DSTPU_DISPATCH_AHEAD``) up to K ``train_batch`` steps stay in
flight and each step's host reads (the skipped-step count, logging) run
when it drains; K = 0 is the blocking loop, which waits for each step.
``synchronize()`` drains the window, and checkpoints, ``eval_batch``,
``offload_states`` and ``module_state_dict`` drain first. With
``prefetch_depth`` > 0 an iterator passed to ``train_batch`` a second
time is handed to a ``PrefetchingIterator`` (``runtime/prefetch.py``)
whose worker pulls the next boundaries and starts their copies to the
card on a side stream.

Observability (the ``observability`` block, on by default; JAX
``engine.py:432-479``): the wall-clock and throughput timers, the
monitor backends (``monitor``), the process-wide metrics hub, the stall
watchdog, the crash flight recorder (with its crash handlers) and the
``DSTPU_TRACE_STEPS`` profiler capture. Each ``train_batch`` step leaves
``step_entry`` / ``step_dispatch`` / ``step_drain`` records in the
flight ring, and when it drains a ``StepTrace`` row goes to the hub:
tokens, tokens/s, MFU (``flops_per_token`` over the card's peak,
``observability/roofline.py``), loss, grad norm, lr, loss scale, comm
and kernel-build deltas and the allocator's counters. The row is built
from host values only: at the end of each step, before its event is
recorded, the loss and grad norm are copied into pinned host memory
without blocking, and the drain reads them after the event; nothing in
the row waits on the card. The watchdog is armed around the blocking
step and, under dispatch-ahead, around the window in flight.
``roofline()`` classifies the counted step (``observability/
attribution.count_step``). ``wall_clock_breakdown`` logs the timers
every ``steps_per_print`` steps (and makes the micro-step API's timers
wait for the card, as JAX's always do), ``memory_breakdown`` logs the
memory breadcrumbs at init. The micro-step API takes the timers and the
flight records; as in JAX it emits no step row.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch._device import DeviceLike, resolve_device
from deepspeed_tpu_torch.checkpoint.state import (CheckpointIO,
                                                  module_state_keys)
from deepspeed_tpu_torch.config.config import (Config, OptimizerConfig,
                                               load_config)
from deepspeed_tpu_torch.models import moe_transformer
from deepspeed_tpu_torch.models import transformer as tf_model
from deepspeed_tpu_torch.models.convert import fp32_tree
from deepspeed_tpu_torch.models.transformer import loss_fn
from deepspeed_tpu_torch.ops import attention as attn_ops
from deepspeed_tpu_torch.ops.blocksparse_attention import \
    from_config as sparse_from_config
from deepspeed_tpu_torch.parallel import topology as topo
from deepspeed_tpu_torch.resilience import resume
from deepspeed_tpu_torch.resilience.chaos import get_chaos_injector
from deepspeed_tpu_torch.resilience.policy import (_DeadlineExpired,
                                                   run_with_deadline)
from deepspeed_tpu_torch.resilience.preemption import PreemptionGuard
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.loss_scaler import (has_overflow,
                                                     init_loss_scale,
                                                     update_loss_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.offload import HostOffloadOptimizer
from deepspeed_tpu_torch.runtime import sharding
from deepspeed_tpu_torch.runtime.optimizer import (
    SGD, Adagrad, Adam, Lion, MixedPrecisionState, apply_client_update,
    apply_mixed_precision_update, get_base_optimizer, global_norm,
    init_mixed_precision, leaves, set_leaf, tree_map)
from deepspeed_tpu_torch.runtime.prefetch import (PrefetchingIterator,
                                                  map_batch, to_device_async,
                                                  wait_ready)
from deepspeed_tpu_torch.runtime.zenflow import (ZenFlowConfig,
                                                 ZenFlowOptimizer)
from deepspeed_tpu_torch.runtime.zero import ZeroPartition
from deepspeed_tpu_torch.utils import memory as mem_util
from deepspeed_tpu_torch.utils import memspace
from deepspeed_tpu_torch.utils.logging import process_rank
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER,
                                             FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER,
                                             TRAIN_BATCH_TIMER,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer)

logger = logging.getLogger(__name__)
_A = "ROADMAP queue A item"
# the optimizers whose step is elementwise, so a rank can step its block
# of the masters alone (Lamb's trust ratio, Adafactor's factored moments
# and Muon's Newton-Schulz read whole leaves)
ELEMENTWISE_OPTIMIZERS = (Adam, SGD, Lion, Adagrad)


def _on_mesh(method):
    """Run an engine method with the engine's mesh as the global one (two
    engines in one process each set it at init; the collectives read
    it, in the backward too)."""
    def wrapper(self, *args, **kwargs):
        with topo.use_mesh(self.mesh):
            return method(self, *args, **kwargs)

    wrapper.__name__ = method.__name__
    wrapper.__doc__ = method.__doc__
    return wrapper


def _map_with_path(fn, tree, prefix: str = ""):
    return {k: (_map_with_path(fn, v, f"{prefix}/{k}")
                if isinstance(v, dict) else fn(f"{prefix}/{k}", v))
            for k, v in tree.items()}


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mesh=None,
               topology=None, dist_init_required: Optional[bool] = None,
               collate_fn=None, config=None, config_params=None,
               device: DeviceLike = None):
    """Reference-parity entry point. ``model`` is a ``TransformerLM`` or
    an ``MoETransformerLM`` (``models/zoo.get_model``), or a ``loss_fn``
    with its ``model_parameters`` (a dict tree of tensors or numpy
    arrays; ``loss_fn(params, batch)`` returns a loss or ``(loss,
    aux)``); ``device`` defaults to the card. The job's process group is
    joined first (``comm.init_distributed``; nothing for one process);
    ``mesh`` (``parallel/topology.build_mesh``) or ``topology`` (its
    sizes) replace the default mesh. ``optimizer`` is a client
    optimizer (a ``torch.optim.Optimizer`` over the model's fp32
    parameters, or a callable ``params -> Optimizer``) and
    ``lr_scheduler`` a client LR scheduler, stored and returned as JAX
    does. ``training_data`` (with an optional ``collate_fn``) builds the
    returned dataloader.
    Returns (engine, optimizer_view, dataloader, lr_scheduler)."""
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    config = config if config is not None else config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    comm.init_distributed(dist_init_required=dist_init_required,
                          device=resolve_device(device))
    engine = Engine(model, load_config(config), device=device, mesh=mesh,
                    topology=topology, training_data=training_data,
                    collate_fn=collate_fn,
                    model_parameters=model_parameters,
                    client_optimizer=optimizer, lr_scheduler=lr_scheduler)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


class _FnModel:
    """A bare ``(loss_fn, params)`` pair in the model protocol the engine
    reads (JAX ``_FnModel``): ``params()`` gives the leaves as fp32
    tensors on the engine's device (a leaf that already is one is used as
    it is, so a client optimizer built over it steps the masters; others
    are copied), ``loss`` returns ``(loss, aux)``."""

    config = None

    def __init__(self, loss_fn: Callable, params, device: torch.device):
        if not isinstance(params, dict):
            raise TypeError("model_parameters must be a dict tree of "
                            "tensors or numpy arrays, got "
                            f"{type(params).__name__}")
        self._loss_fn = loss_fn
        self.device = device
        self._params = fp32_tree(params, device)

    def params(self) -> Dict[str, Any]:
        return self._params

    def loss(self, params, batch):
        out = self._loss_fn(params, batch)
        return out if isinstance(out, tuple) else (out, {})

    def train(self, mode: bool = True) -> "_FnModel":
        return self


class _InflightStep:
    """One dispatched, not yet drained step: its event on the compute
    stream and what its deferred host reads need. ``host`` holds the
    loss and the grad norm in host memory (pinned, filled by a
    non-blocking copy ordered before the event on a card; the tensors
    themselves on the CPU)."""

    __slots__ = ("step", "lr", "loss_scale", "overflow", "event", "host",
                 "samples", "tokens", "host_ms", "host_t0", "sync")

    def __init__(self, step, lr, loss_scale, overflow, event, host,
                 samples, tokens=None, host_ms=None, host_t0=None,
                 sync=True):
        self.step = step
        self.lr = lr
        self.loss_scale = loss_scale
        self.overflow = overflow
        self.event = event
        self.host = host
        self.samples = samples
        self.tokens = tokens
        self.host_ms = host_ms
        self.host_t0 = host_t0
        self.sync = sync

    def values(self):
        """(loss, grad norm) as floats. On a card the pinned copies land
        when the step's event completes, so this waits on it (a no-op
        for a drained step)."""
        if self.event is not None:
            self.event.synchronize()
        return float(self.host[0]), float(self.host[1])


class _OptimizerView:
    """``optimizer.param_groups[0]["lr"]``, read-only."""

    def __init__(self, engine: "Engine"):
        self._engine = engine

    @property
    def param_groups(self) -> List[Dict[str, float]]:
        return [{"lr": self._engine.get_lr()[0]}]


class Engine:
    """Owns the compute params, the fp32 masters and optimizer state, and
    the loss scale; runs one fused training step per ``train_batch``, or
    the same step through ``forward`` / ``backward`` / ``step``."""

    def __init__(self, model, config: Config, device: DeviceLike = None,
                 mesh=None, topology=None, training_data=None,
                 collate_fn=None, model_parameters=None,
                 client_optimizer=None, lr_scheduler=None):
        self.device = resolve_device(device)
        if callable(model) and not hasattr(model, "params"):
            if model_parameters is None:
                raise ValueError("a (loss_fn, params) model needs "
                                 "model_parameters")
            model = _FnModel(model, model_parameters, self.device)
        if not (hasattr(model, "params") and hasattr(model, "config")):
            raise TypeError("Engine needs a TransformerLM (models/zoo."
                            "get_model) or a (loss_fn, params) pair")
        if model.device != self.device:
            raise ValueError(f"the model's weights live on {model.device}, "
                             f"the engine runs on {self.device}: move the "
                             "model or pass device=")
        self.model = model
        self.config = config
        mem_util.configure(config.memory_breakdown)
        mem_util.see_memory_usage("engine init: before model setup",
                                  device=self.device)
        self._client_optimizer_present = client_optimizer is not None
        # the mesh (JAX engine.py:161-167): the ranks over the named axes
        self.mesh = mesh if mesh is not None else \
            self._default_mesh(topology)
        topo.set_global_mesh(self.mesh)
        self.dp_world_size = topo.get_data_parallel_world_size(self.mesh)
        config.resolve_batch_size(self.dp_world_size)
        self.plan = sharding.make_sharding_plan(config, self.mesh)
        comm.configure(config)
        self.micro_batch_size = config.train_micro_batch_size_per_chip
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.train_batch_size = config.train_batch_size
        self.compute_dtype = config.compute_dtype
        over = {"dtype": self.compute_dtype}
        if isinstance(model, _FnModel):
            self._loss_fn = lambda _cfg, params, batch: model.loss(params,
                                                                   batch)
        elif isinstance(model.config, moe_transformer.MoETransformerConfig):
            self._loss_fn = moe_transformer.loss_fn
            if config.moe.impl != "auto":
                over["moe_impl"] = config.moe.impl
        else:
            self._loss_fn = loss_fn
        self.model_config = (None if model.config is None else
                             dataclasses.replace(model.config, **over))
        self._install_sparse_layout()
        # the dispatch policy and table path for impl="auto"
        attn_ops.set_kernel_config(self.config.kernels)

        # a client optimizer steps the masters in the configured
        # optimizer's place; as in JAX it then has no schedule of the
        # engine's, and ``lr_scheduler`` is the client's, returned as is
        self._client_opt = None
        self.lr_schedule = (None if self._client_optimizer_present else
                            get_lr_schedule(config.scheduler,
                                            base_lr=self._config_lr()))
        self.lr_scheduler = lr_scheduler or self.lr_schedule
        cdt = self.compute_dtype
        zero = config.zero_optimization
        # ZeRO across ranks: on a process group (any world size)
        self._zero: Optional[ZeroPartition] = None
        self._fetch: Optional[sharding.LayerFetch] = None
        if self.mesh.distributed:
            self._check_world(model)
        if self.mesh.distributed and \
                zero.offload_device not in ("cpu", "nvme"):
            logical = self._logical_axes(model)
            self._zero = ZeroPartition(self.plan, self.mesh, logical,
                                       zero.stage)
            self._zero.check(model.params())
            if any(d is not None for d in self._zero.param_dim.values()):
                self._fetch = sharding.LayerFetch(logical)
        if zero.zenflow is not None and zero.offload_device != "cpu":
            raise ValueError(
                "zero_optimization.zenflow requires "
                "offload_optimizer.device='cpu' (ZenFlow keeps masters "
                "host-resident; the NVMe swap tier does not apply), got "
                f"device={zero.offload_device!r}")
        self._offload: Optional[HostOffloadOptimizer] = None
        self._zenflow: Optional[ZenFlowOptimizer] = None
        self._post_step_hooks: List = []
        if zero.offload_device in ("cpu", "nvme"):
            if self._client_optimizer_present:
                raise ValueError(
                    "a client optimizer steps the card's fp32 masters; "
                    "zero_optimization.offload_optimizer steps host masters "
                    "with the native optimizer of the optimizer block: "
                    "pass one or the other")
            self.tx, self.opt_state = None, None
            self._zenflow = self._maybe_build_zenflow(model)
            if self._zenflow is None:
                self._init_offload(model)
        elif self._client_optimizer_present:
            self._init_client_optimizer(model, client_optimizer)
        else:
            self.tx, self._base_lr = get_base_optimizer(config.optimizer,
                                                        self.lr_schedule)
            if self._zero is not None:
                self._init_zero_state(model)
            else:
                self.opt_state = init_mixed_precision(model.params(),
                                                      self.tx)
                with torch.no_grad():
                    self.params = tree_map(
                        lambda m: m.to(cdt, copy=True).requires_grad_(),
                        self.opt_state.master)
        self.loss_scale_state = init_loss_scale(config.fp16)
        self._offloaded_states: Optional[list] = None
        # GAS > 1: fp32 accumulators, one per parameter, filled by the
        # hooks during backward and dropped after each update (with the
        # optimizer offloaded the grads accumulate in p.grad instead);
        # ZeRO's reduce-scattered gradient blocks at GAS 1
        self._grad_acc: Dict[torch.Tensor, torch.Tensor] = {}
        self._grad_shards: Dict[torch.Tensor, torch.Tensor] = {}
        self._scatter_dims: Dict[torch.Tensor, int] = {}
        if self._zero is not None:
            for path, p in leaves(self.params):
                d = self._zero.scatter_dim(path)
                if d is not None:
                    self._scatter_dims[p] = d
        if (self.gradient_accumulation_steps > 1 or self._scatter_dims) \
                and not self._host_tier:
            # the hooks hold the engine weakly: a bound method would make a
            # cycle (engine -> params -> hook -> engine) that keeps the
            # card's memory until the garbage collector runs
            ref = weakref.ref(self)

            def fold(p: torch.Tensor) -> None:
                engine = ref()
                if engine is not None:  # else the engine is gone
                    engine._on_grad(p)

            for _, p in leaves(self.params):
                p.register_post_accumulate_grad_hook(fold)

        self._init_observability()
        self._init_resilience()
        self._init_pipelining()
        self._ckpt_io = CheckpointIO(self)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._last_grad_norm: Optional[torch.Tensor] = None
        self.last_metrics: Dict[str, Any] = {}
        # micro-step path: the last forward's loss and model metrics, and
        # the (loss, metrics) of each backward since the last update
        self._pending: Optional[tuple] = None
        self._micro_losses: List[tuple] = []
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = DeepSpeedDataLoader(
                training_data, batch_size=self.micro_batch_size,
                collate_fn=collate_fn)
        n_params = sum(p.numel() for _, p in leaves(model.params()))
        # every rank must have resolved the same geometry (reference
        # assert_ints_same_as_other_ranks at ZeRO init)
        comm.assert_same_across_processes(
            "engine_init", [
                self.micro_batch_size, self.gradient_accumulation_steps,
                self.train_batch_size, config.zero_optimization.stage,
                n_params] + [f"{a}={s}" for a, s in self.mesh.shape.items()])
        logger.info(
            f"engine ready: {n_params / 1e6:.1f}M params, zero_stage="
            f"{config.zero_optimization.stage}, dp={self.dp_world_size}, "
            f"micro="
            f"{self.micro_batch_size}, gas="
            f"{self.gradient_accumulation_steps}, dtype={cdt}, "
            f"device={self.device}")
        mem_util.see_memory_usage("engine init: ready", device=self.device)

    def _default_mesh(self, topology):
        """JAX's default mesh (``engine.py:654-679``) over the world's
        ranks: fsdp = world at stage >= 1, dp = world at stage 0 (ep
        from the moe block; pp, tp and sp blocks raise at the config)."""
        if topology is not None:
            return topo.build_mesh(topology)
        cfg = self.config
        sizes = dict(ep=cfg.moe.ep_size if cfg.moe.enabled else 1)
        if cfg.zero_optimization.stage >= 1:
            sizes.update(fsdp=-1, dp=1)
        else:
            sizes.update(dp=-1, fsdp=1)
        return topo.build_mesh(topo.TopologyConfig(**sizes))

    def _check_world(self, model) -> None:
        """What does not run across ranks yet raises, naming its item."""
        world = comm.get_world_size()
        if world <= 1:
            return
        zero = self.config.zero_optimization
        if zero.offload_device in ("cpu", "nvme") or zero.zenflow is not None:
            raise NotImplementedError(
                f"zero_optimization.offload_optimizer / zenflow at world "
                f"size {world}: the host optimizer tiers run on one rank; "
                f"across ranks they are {_A} 5's leftover (JAX config C, "
                "ZenFlow on the fsdp mesh)")
        if isinstance(getattr(model, "config", None),
                      moe_transformer.MoETransformerConfig):
            raise NotImplementedError(
                f"an MoE model at world size {world}: {_A} 9 (MoE across "
                "ranks: the expert all-to-all and the router's losses over "
                "the global batch)")
        for axis, item in (("pp", 11), ("sp", 11), ("tp", 11), ("ep", 9)):
            if self.mesh.shape[axis] > 1:
                raise NotImplementedError(
                    f"mesh axis {axis}={self.mesh.shape[axis]}: {_A} "
                    f"{item}")
        if zero.stage >= 1 and self._client_optimizer_present:
            raise NotImplementedError(
                f"a client optimizer at ZeRO stage {zero.stage} and world "
                f"size {world}: it steps whole tensors, the ranks hold "
                f"blocks of the masters ({_A} 5's leftover)")

    def _logical_axes(self, model) -> Dict[str, Any]:
        """The model's logical axes (JAX's ``logical_axes``); a ``(loss_fn,
        params)`` pair takes JAX's fallback: dim 0 is the embed dim."""
        if isinstance(model, _FnModel):
            return tree_map(lambda p: tuple("embed" if i == 0 else None
                                            for i in range(p.dim())),
                            model.params())
        if isinstance(model.config, moe_transformer.MoETransformerConfig):
            return moe_transformer.logical_axes(model.config)
        return tf_model.logical_axes(model.config)

    @torch.no_grad()
    def _init_zero_state(self, model) -> None:
        """ZeRO's state on a process group: this rank's block of each fp32
        master (and the moments beside it) and the compute params, full
        or (stage 3) this rank's block. At one fsdp rank a block is the
        whole leaf: an fp32 model then shares its tensors with the
        masters, as without a process group."""
        zero = self._zero
        if zero.fsdp_n > 1 and not isinstance(self.tx,
                                              ELEMENTWISE_OPTIMIZERS):
            raise NotImplementedError(
                f"optimizer {type(self.tx).__name__} at ZeRO stage "
                f"{zero.stage} over {zero.fsdp_n} ranks: its step reads "
                f"whole leaves, the ranks hold blocks ({_A} 5's leftover)")
        src = model.params()

        def master(path, p):
            blk = zero.block(path, p.detach(), "opt")
            return blk.clone() if blk.shape != p.shape else blk

        self.opt_state = init_mixed_precision(_map_with_path(master, src),
                                              self.tx)
        self.params = _map_with_path(
            lambda path, p: zero.block(path, p.detach(), "param").to(
                self.compute_dtype, copy=True).contiguous().requires_grad_(),
            src)

    def shard_batch(self, batch, leading_dims: int = 1):
        """This process's batch on the engine's device (JAX
        ``engine.py:1098``): as in JAX's multi-process contract, each
        rank's data iterator yields the rank's own rows, which
        ``topology.batch_sharding(mesh).take`` cuts from a global batch."""
        return self._to_device(batch)

    def _model_loss(self, batch):
        """The model's (loss, aux) on ``batch``; at stage 3 under the fetch
        hook (a ``(loss_fn, params)`` model gathers its whole tree)."""
        if self._fetch is None:
            return self._loss_fn(self.model_config, self.params, batch)
        if isinstance(self.model, _FnModel):
            return self._loss_fn(self.model_config,
                                 self._fetch.tree(self.params), batch)
        with sharding.param_fetch(self._fetch):
            return self._loss_fn(self.model_config, self.params, batch)

    def _compute_params(self, src):
        with torch.no_grad():
            self.params = tree_map(
                lambda t: t.detach().to(self.compute_dtype,
                                        copy=True).requires_grad_(), src)

    def _init_client_optimizer(self, model, client_optimizer) -> None:
        """The client-optimizer branch (JAX ``engine.py:314-315``, where
        it is an optax transform): fp32 masters (a leaf of the model that
        already is an fp32 tensor is its own master), compute copies, and
        the client's ``torch.optim.Optimizer`` over the masters."""
        self.tx, self._base_lr = None, None
        masters = tree_map(lambda p: p if p.dtype == torch.float32
                           else p.detach().float(), model.params())
        self.opt_state = MixedPrecisionState(master=masters)
        flat = [m for _, m in leaves(masters)]
        if isinstance(client_optimizer, torch.optim.Optimizer):
            own = {id(m) for m in flat}
            for group in client_optimizer.param_groups:
                if any(id(p) not in own for p in group["params"]):
                    raise ValueError(
                        "the client optimizer must be built over the "
                        "model's fp32 parameters (the engine's masters); "
                        "for a model in another dtype, or numpy "
                        "model_parameters, pass a callable params -> "
                        "torch.optim.Optimizer")
            self._client_opt = client_optimizer
        elif callable(client_optimizer):
            self._client_opt = client_optimizer(flat)
            if not isinstance(self._client_opt, torch.optim.Optimizer):
                raise TypeError("the client optimizer callable must return "
                                "a torch.optim.Optimizer, got "
                                f"{type(self._client_opt).__name__}")
        else:
            raise TypeError("a client optimizer is a torch.optim.Optimizer "
                            "or a callable params -> Optimizer, got "
                            f"{type(client_optimizer).__name__}")
        self._compute_params(masters)

    def _init_pipelining(self) -> None:
        """The ``performance`` block (JAX ``engine.py:520-541``):
        dispatch-ahead of ``pipeline_depth`` steps (the
        ``DSTPU_DISPATCH_AHEAD`` environment variable wins) and the input
        prefetcher's depth."""
        perf = self.config.performance
        env_depth = os.environ.get("DSTPU_DISPATCH_AHEAD", "")
        self._dispatch_ahead = (int(env_depth) if env_depth != ""
                                else int(perf.pipeline_depth))
        self._prefetch_depth = int(perf.prefetch_depth)
        self._inflight: deque = deque()  # _InflightStep, oldest first
        self._prefetcher: Optional[PrefetchingIterator] = None
        self._prefetch_source = None  # the data_iter the prefetcher owns
        self._copy_stream = None      # the prefetcher's side stream
        if self._dispatch_ahead > 0:
            logger.info(f"pipelined loop: dispatch-ahead depth "
                        f"{self._dispatch_ahead}, input prefetch depth "
                        f"{self._prefetch_depth}")

    def _share_masters(self, src, master_of) -> None:
        """An fp32 model on the card: each leaf rebound to its host master
        (its card copy freed), so that it follows training."""
        with torch.no_grad():
            for path, leaf in leaves(src):
                master = master_of(path)
                if leaf.dtype == torch.float32 and \
                        leaf.device != master.device:
                    leaf.data = master.view(leaf.shape)

    def _maybe_build_zenflow(self, model) -> Optional[ZenFlowOptimizer]:
        """The ``zero_optimization.zenflow`` block (JAX
        ``engine.py:1446-1478``): ZenFlow in the host optimizer's place,
        with the optimizer block's lr, betas, eps and weight decay (0.0
        unless set, under adamw too, as in JAX). None without the
        block."""
        zf = self.config.zero_optimization.zenflow
        if zf is None:
            return None
        ocfg = self.config.optimizer
        p = dict((ocfg.params or {}) if ocfg else {})
        cfg = ZenFlowConfig(
            topk_ratio=zf.topk_ratio, update_interval=zf.update_interval,
            select_interval=zf.select_interval,
            overlap_step=zf.overlap_step, workers=zf.workers,
            betas=tuple(p.get("betas", (0.9, 0.999))),
            eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0))
        src = model.params()
        self._compute_params(src)
        zen = ZenFlowOptimizer(src, cfg, lr=self._config_lr(),
                               device=self.device)
        self._base_lr = zen.lr
        self._share_masters(src, zen.full_fp32_param)
        return zen

    def _init_offload(self, model) -> None:
        """The ZeRO-Offload branch (JAX ``engine.py:744-841``): the
        compute-dtype params on the card, the fp32 masters and moments on
        the host or the NVMe tier (``runtime/offload.py``), stepped by the
        native CPU optimizer. An fp32 model on the card then shares its
        tensors with the host masters on the cpu tier (its card copy is
        freed, and it follows training, as the device path shares them);
        on the nvme tier the model's tensors stay as they are."""
        off = self.config.zero_optimization.offload_optimizer
        ocfg = self.config.optimizer
        src = model.params()
        self._compute_params(src)
        self._offload = HostOffloadOptimizer(
            src, optimizer_name=(ocfg.type if ocfg else "adamw") or "adamw",
            optimizer_params=dict((ocfg.params or {}) if ocfg else {}),
            grad_clip=self.config.gradient_clipping,
            nvme_path=off.nvme_path if off.device == "nvme" else None,
            buffer_count=off.buffer_count, pin_memory=off.pin_memory,
            grad_transfer_dtype=off.grad_transfer_dtype)
        self._base_lr = self._offload.lr
        if self._offload.tier == "cpu":
            self._share_masters(src, self._offload.masters.get)

    def _init_observability(self) -> None:
        """The timers, the monitor, the hub, the watchdog, the flight
        recorder and the profiler capture (JAX ``engine.py:432-479``).
        A sink that cannot open warns and the step goes on without it;
        a block the port does not run raises."""
        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size,
            steps_per_output=self.config.steps_per_print)
        self.monitor = self._build_monitor()
        self.hub = None
        self.watchdog = None
        self.flight = None
        self._trace_capture = None
        self._last_drain_t: Optional[float] = None
        self._flops_per_token: Optional[float] = None
        self._peak: Optional[tuple] = None
        self._roofline_cost: Optional[Dict[str, float]] = None
        self._last_batch_shape: Optional[tuple] = None
        self._obs_cfg = self.config.observability
        if not self._obs_cfg.enabled:
            return
        from deepspeed_tpu_torch.observability import (StallWatchdog,
                                                       TraceCapture, get_hub)
        from deepspeed_tpu_torch.observability import flight_recorder as fr

        ref = weakref.ref(self)  # a bound method would keep the engine

        def on_stall(report: str) -> None:
            engine = ref()
            if engine is not None:
                engine._on_stall_report(report)

        try:
            self.hub = get_hub()
            self.hub.configure(self._obs_cfg, rank=process_rank())
            self.watchdog = StallWatchdog.from_config(
                self._obs_cfg.watchdog, report_fn=on_stall)
            self._trace_capture = TraceCapture.from_env()
        except NotImplementedError:
            raise
        except Exception as e:  # a sink that cannot open
            logger.warning(f"observability hub disabled: {e}")
        self.flight = fr.get_flight_recorder()
        self.flight.configure(capacity=self._obs_cfg.flight_events,
                              rank=process_rank())
        if not self.flight.enabled:
            self.flight = None
        else:
            fr.install_crash_handlers()

    def _monitor_events(self, events) -> None:
        """The monitor backends' events; a backend that cannot write (a
        full disk) warns and the monitor goes off, the step goes on."""
        if self.monitor is None:
            return
        try:
            self.monitor.write_events(events)
        except OSError as e:
            logger.warning(f"monitor disabled after a write error: {e}")
            self.monitor = None

    def _build_monitor(self):
        from deepspeed_tpu_torch.monitor.monitor import MonitorMaster

        master = MonitorMaster(self.config.monitor)
        return master if master.enabled else None

    def _init_resilience(self) -> None:
        """The resilience block (JAX ``engine.py:481-512``):
        PreemptionGuard (SIGTERM -> emergency checkpoint at the next GAS
        boundary) and the chaos injector, armed only when DSTPU_CHAOS is
        set."""
        self.preempted = False
        self.loaded_data_cursor = None  # manifest cursor from last load
        self._last_save_dir = None      # emergency-save fallback target
        self._last_data_iter = None     # data_cursor loader-state source
        rcfg = self.config.resilience
        inj = get_chaos_injector()
        self._chaos = inj if inj.armed else None
        self._preempt_guard = None
        if rcfg.enabled and rcfg.preemption_guard:
            self._preempt_guard = PreemptionGuard(
                save_deadline_s=rcfg.preemption_save_deadline_s)
            self._preempt_guard.install()

    def _install_sparse_layout(self) -> None:
        """The ``sparse_attention`` block into the process-global
        dispatcher (JAX ``engine.py:177-206``), or clear it."""
        scfg = self.config.sparse_attention
        if scfg is None:
            # a previous engine in this process may have installed a
            # layout into the process-global dispatcher — clear it
            attn_ops.set_sparse_config(None)
            return
        kblk = self.config.kernels.blocksparse_block
        if kblk and kblk != scfg.block:
            # kernels.blocksparse_block overrides the layout block
            scfg = dataclasses.replace(scfg, block=kblk)
        attn_ops.set_sparse_config(sparse_from_config(scfg))
        if getattr(self.model_config, "attn_impl", None) != "blocksparse":
            logger.warning(
                "sparse_attention configured but the model's attn_impl "
                "is not 'blocksparse' — dense attention will run; set "
                "attn_impl='blocksparse' on the model config to activate "
                "the layout")
        if scfg.attention == "bidirectional":
            logger.warning(
                "sparse_attention.attention='bidirectional': causality "
                "comes from the model (the LM stack is causal); the "
                "layout is applied either way")

    def _config_lr(self) -> float:
        opt = self.config.optimizer
        if opt is not None and "lr" in (opt.params or {}):
            return opt.params["lr"]
        return 1e-3

    # -- data --------------------------------------------------------------
    def _to_device(self, batch: Any) -> Any:
        """A microbatch (a tree of dicts, lists, tuples and namedtuples
        over numpy arrays or tensors; ``None`` stays ``None``) on the
        engine's device."""
        return map_batch(batch, lambda t: t.to(self.device))

    def _pull_microbatches(self, data_iter, n: int) -> list:
        """``n`` microbatches from ``data_iter``, as they come."""
        out = []
        for i in range(n):
            if self._chaos is not None:
                self._chaos.on_input_batch()
            try:
                out.append(next(data_iter))
            except StopIteration:
                if i == 0:
                    raise  # clean end-of-data at a boundary
                raise RuntimeError(
                    f"data iterator exhausted mid-gradient-accumulation "
                    f"(got {i} of {n} microbatches)") from None
        return out

    def _next_microbatches(self, data_iter, n: int):
        return [self._to_device(b)
                for b in self._pull_microbatches(data_iter, n)]

    def _next_batches(self, data_iter):
        """One boundary's microbatches on the device, through the
        background prefetcher when the caller streams (JAX
        ``engine.py:1130-1151``): an iterator seen for the first time is
        pulled synchronously (a one-shot ``iter([batch])`` must not be
        consumed ahead of the caller); the SAME iterator passed again is
        a stream and goes to a ``PrefetchingIterator`` whose worker pulls
        the next boundaries and starts their copies to the card."""
        gas = self.gradient_accumulation_steps
        if self._prefetch_depth <= 0:
            return self._next_microbatches(data_iter, gas)
        if data_iter is self._prefetch_source:
            if self._prefetcher is None:
                self._prefetcher = PrefetchingIterator(
                    self._producer(data_iter), depth=self._prefetch_depth,
                    name="train-input")
            batches, event = next(self._prefetcher)
            return wait_ready(batches, event)
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        self._prefetch_source = data_iter
        return self._next_microbatches(data_iter, gas)

    def _producer(self, data_iter):
        """The prefetch worker's producer: one boundary pulled, and its
        copies to the card started on the side stream. It holds the
        engine weakly, so a worker never keeps an engine alive."""
        gas = self.gradient_accumulation_steps
        device = self.device
        if device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        stream = self._copy_stream
        ref = weakref.ref(self)

        def produce():
            engine = ref()
            if engine is None:
                raise StopIteration
            raw = engine._pull_microbatches(data_iter, gas)
            del engine
            return to_device_async(raw, device, stream)

        return produce

    # -- training ------------------------------------------------------------
    def _loss_scale(self) -> float:
        return self.loss_scale_state.scale if self.config.fp16.enabled \
            else 1.0

    @property
    def _host_tier(self) -> bool:
        """The optimizer is offloaded (the host tier or ZenFlow)."""
        return self._offload is not None or self._zenflow is not None

    def _backward_scale(self) -> float:
        """What each microbatch's loss is multiplied by before backward:
        the loss scale, over GAS when the optimizer is offloaded (there
        the grads accumulate in p.grad in the compute dtype, as JAX's
        offload step differentiates ``sum(loss * scale / gas)``)."""
        if self._host_tier:
            return self._loss_scale() / self.gradient_accumulation_steps
        return self._loss_scale()

    @torch.no_grad()
    def _on_grad(self, p: torch.Tensor) -> None:
        """Post-accumulate hook: a gradient that shards while its param
        does not (ZeRO stage 2) is reduce-scattered to this rank's block
        at once and the full one freed; at GAS > 1 the (block of the)
        gradient folds into its fp32 accumulator."""
        dim = self._scatter_dims.get(p)
        if dim is None:
            if self.gradient_accumulation_steps > 1:
                self._fold_grad(p)
            return
        g = comm.reduce_scatter(p.grad, "fsdp", scatter_dim=dim)
        p.grad = None
        if self.gradient_accumulation_steps > 1:
            self._fold(p, g)
        elif p in self._grad_shards:
            self._grad_shards[p].add_(g)
        else:
            self._grad_shards[p] = g

    @torch.no_grad()
    def _fold_grad(self, p: torch.Tensor) -> None:
        """GAS > 1: ``p.grad`` into p's fp32 accumulator, then freed."""
        g = p.grad
        p.grad = None
        self._fold(p, g)

    @torch.no_grad()
    def _fold(self, p: torch.Tensor, g: torch.Tensor) -> None:
        """``g`` (the gradient of one microbatch's ``loss * scale``,
        compute dtype) into p's fp32 accumulator as ``g.float() *
        (1/gas)``: the product and the sum each round once, as JAX's
        ``acc + g * (1/gas)``."""
        g = g.float().mul_(1.0 / self.gradient_accumulation_steps)
        acc = self._grad_acc.get(p)
        if acc is None:
            self._grad_acc[p] = g
        else:
            acc.add_(g)

    @_on_mesh
    def train_batch(self, data_iter=None) -> torch.Tensor:
        """One training step over ``gradient_accumulation_steps``
        microbatches from ``data_iter`` (default: a fresh pass over the
        dataloader). Returns the mean microbatch loss (a 0-dim fp32
        tensor on the device)."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch needs data_iter or "
                                 "training_data")
            data_iter = iter(self.training_dataloader)
        self._last_data_iter = data_iter  # data_cursor loader-state source
        depth = self._effective_depth()
        if self._trace_capture is not None and \
                self._trace_capture.wants_start(self.global_steps + 1):
            # the capture starts with nothing in flight: it holds whole
            # steps of its window and nothing before
            self.synchronize()
        host_t0 = time.perf_counter()
        if depth == 0:
            self.timers(TRAIN_BATCH_TIMER).start()
            self.tput_timer.start()
        batches = self._next_batches(data_iter)
        ids = batches[0].get("input_ids") if hasattr(batches[0], "get") \
            else None
        if ids is not None and ids.dim() == 2:
            self._last_batch_shape = (ids.shape[0], ids.shape[1] - 1)
        step_no = self.global_steps + 1
        if self._chaos is not None:
            self._chaos.on_step(step_no)
        if self.flight is not None:
            self.flight.record("step_entry", step=step_no,
                               inflight=len(self._inflight))
        if self._trace_capture is not None:
            self._trace_capture.on_step_begin(step_no)
        if depth == 0 and self.watchdog is not None:
            # armed until the step's event is waited on: a wedged step
            # fires a stack / memory report
            self.watchdog.arm(step_no)
        micro = []
        for mb in batches:
            loss, aux = self._model_loss(mb)
            (loss * self._backward_scale()).backward()
            micro.append((loss.detach(), aux))
        return self._apply_update(micro, depth=depth, host_t0=host_t0,
                                  tokens=_batch_tokens(batches))

    def _effective_depth(self) -> int:
        """The dispatch-ahead window for the next step (JAX
        ``engine.py:1162-1175``): the host optimizer tiers read the grads
        inside the step, and post-step hooks expect a settled engine, so
        both take the blocking loop."""
        if self._dispatch_ahead <= 0 or self._host_tier \
                or self._post_step_hooks:
            return 0
        return self._dispatch_ahead

    def _drain_one(self) -> None:
        """Resolve the oldest in-flight step: wait for its event, then run
        its deferred host reads and emit its trace row (JAX
        ``engine.py:1242-1286``)."""
        entry = self._inflight.popleft()
        if entry.event is not None:
            entry.event.synchronize()
        if self._trace_capture is not None:
            # a capture that ends here stops and writes its trace inside
            # the step's span, so the rows' walls still add up to the
            # run's wall
            self._trace_capture.on_step_end(entry.step)
        if entry.sync:
            # the blocking loop: the timers' start / stop pair
            self._after_step_host(entry)
            self.timers(TRAIN_BATCH_TIMER).stop()
            wall_ms = self._last_step_wall_ms()
            if self.watchdog is not None:
                self.watchdog.disarm()
                self.watchdog.observe(wall_ms / 1000.0, entry.step)
            self._last_drain_t = time.perf_counter()
        else:
            resolved_t = time.perf_counter()
            # drain-to-drain span ~ this step's device time once the
            # window is full; during fill it degrades to dispatch->done
            base = (entry.host_t0 if self._last_drain_t is None
                    else max(self._last_drain_t, entry.host_t0))
            wall_ms = (resolved_t - base) * 1000.0
            self._last_drain_t = resolved_t
            self._after_step_host(entry, wall_s=wall_ms / 1000.0)
            self.timers(TRAIN_BATCH_TIMER).record_ms(wall_ms)
            if self.watchdog is not None:
                self.watchdog.observe(wall_ms / 1000.0, entry.step)
                if self._inflight:
                    self.watchdog.arm(self._inflight[0].step,
                                      window=len(self._inflight))
                else:
                    self.watchdog.disarm()
        if self.flight is not None:
            self.flight.record("step_drain", step=entry.step,
                               wall_ms=round(wall_ms, 3),
                               inflight=len(self._inflight))
        if self.hub is not None:
            self._emit_step_trace(entry, wall_ms,
                                  inflight=len(self._inflight))

    def _after_step_host(self, entry: _InflightStep,
                         wall_s: Optional[float] = None) -> None:
        """A step's host reads (JAX ``engine.py:1659``): its
        skipped-update count, the throughput timer, its log line, the
        monitor's events and the timers' breakdown. Under dispatch-ahead
        they run when the step drains; ``wall_s`` set means the span was
        measured drain to drain."""
        self.skipped_steps += int(entry.overflow)
        if wall_s is None:
            self.tput_timer.stop(global_step=True)
        else:
            self.tput_timer.record(wall_s)
        loss, gnorm = entry.values()
        if entry.step % self.config.steps_per_print == 0:
            logger.info(f"step={entry.step}, loss={loss:.4f}, "
                        f"lr={entry.lr:.3e}, grad_norm={gnorm:.3f}")
        self._monitor_events([
            ("Train/Samples/train_loss", loss, entry.samples),
            ("Train/Samples/lr", entry.lr, entry.samples)])
        if self.config.wall_clock_breakdown and \
                entry.step % self.config.steps_per_print == 0:
            self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER,
                             STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER])

    def synchronize(self) -> "Engine":
        """Drain every dispatched, not yet resolved ``train_batch`` step
        (JAX ``engine.py:1288``): wait for each and run its deferred host
        reads. The engine calls it before checkpoints, ``eval_batch``,
        ``offload_states`` and ``module_state_dict``; call it before
        reading the counters mid-run. A no-op in the blocking loop."""
        while self._inflight:
            self._drain_one()
        return self

    def _apply_update(self, micro: List[tuple],
                      depth: Optional[int] = None,
                      host_t0: Optional[float] = None,
                      tokens: Optional[int] = None) -> torch.Tensor:
        """The optimizer step on the accumulated grads; ``micro`` holds
        each microbatch's (loss, model metrics). Returns the mean loss.
        ``depth`` (``train_batch``) is the dispatch-ahead window: the
        step joins it and the oldest steps past ``depth`` drain (0 waits
        for this one); None (the micro-step API) runs the host reads at
        once. ``host_t0`` and ``tokens`` (``train_batch``) are the step's
        start on the host clock and its trained tokens."""
        fp16 = self.config.fp16.enabled
        scale = self._loss_scale()
        lr = self.get_lr()[0]
        if self._offload is not None:
            gnorm, overflow = self._offload.step(
                tree_map(lambda p: p.grad, self.params), self.params, lr=lr,
                grad_scale=scale if fp16 else None, skip_on_nonfinite=fp16)
            gnorm = torch.tensor(gnorm, dtype=torch.float32)
        elif self._zenflow is not None:
            gnorm, overflow = self._zenflow_apply(scale if fp16 else None,
                                                  lr)
        else:
            if self.gradient_accumulation_steps > 1:
                grads = tree_map(lambda p: self._grad_acc.get(p),
                                 self.params)
            else:
                grads = tree_map(lambda p: self._grad_shards.get(p, p.grad),
                                 self.params)
            kw = {}
            if self._zero is not None:
                grads = self._zero_grads(grads)
            overflow = has_overflow(g for _, g in leaves(grads)) \
                if fp16 else False
            if self._zero is not None:
                if fp16:  # no rank skips a step another takes
                    overflow = comm.any_process(overflow)
                kw = dict(gnorm=global_norm(
                    grads, scale if fp16 else None,
                    include=self._zero.owned,
                    reduce=self._zero.norm_reduce),
                    publish=self._zero.publish)
            kw.update(grad_clip=self.config.gradient_clipping,
                      grad_scale=scale if fp16 else None, skip=overflow)
            if self._client_opt is not None:
                gnorm = apply_client_update(self.opt_state, grads,
                                            self._client_opt, self.params,
                                            **kw)
            else:
                gnorm = apply_mixed_precision_update(
                    self.opt_state, grads, self.tx, self.params, **kw)
        for _, p in leaves(self.params):
            p.grad = None
        self._grad_acc = {}
        self._grad_shards = {}
        if fp16:
            self.loss_scale_state = update_loss_scale(
                self.loss_scale_state, overflow, self.config.fp16)
        self._last_grad_norm = gnorm
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        for hook in self._post_step_hooks:
            hook(self)
        mean_loss = torch.stack([loss for loss, _ in micro]).mean()
        if self._zero is not None:  # the mean over the data ranks
            mean_loss = comm.all_reduce(mean_loss, topo.BATCH_AXES,
                                        op="mean")
        self.last_metrics = {"loss": mean_loss, "grad_norm": gnorm, "lr": lr,
                             "loss_scale": self.loss_scale_state.scale,
                             "overflow": overflow}
        # the model's own metrics (an MoE loss's lm_loss and aux_loss),
        # averaged over the microbatches
        for key in micro[0][1]:
            if key not in self.last_metrics:
                self.last_metrics[key] = torch.stack(
                    [aux[key].detach().float() for _, aux in micro]).mean()
        host = self._to_host((mean_loss, gnorm))
        event = None
        if self.device.type == "cuda":
            # what the host reads of ``host`` wait on: the drain under
            # dispatch-ahead, ``values()`` on the micro-step API
            event = torch.cuda.Event()
            event.record()
        sync = depth is None or depth == 0
        entry = _InflightStep(
            self.global_steps, lr, self.loss_scale_state.scale, overflow,
            event, host, self.global_samples, tokens=tokens,
            host_ms=(None if host_t0 is None
                     else (time.perf_counter() - host_t0) * 1000.0),
            host_t0=host_t0, sync=sync)
        if self.flight is not None and host_t0 is not None:
            self.flight.record("step_dispatch", step=entry.step,
                               host_ms=round(entry.host_ms, 3))
        if depth is None:
            self._after_step_host(entry)
        else:
            self._inflight.append(entry)
            if not sync and self.watchdog is not None:
                # one deadline budgets the whole window in flight (the
                # oldest step's, scaled by the window): between calls the
                # window stays armed, so a wedged step still fires
                self.watchdog.arm(self._inflight[0].step,
                                  window=len(self._inflight))
            if self._trace_capture is not None and \
                    self._trace_capture.wants_drain(entry.step):
                depth = 0  # the capture ends with whole steps in it
            while len(self._inflight) > depth:
                self._drain_one()
        # the GAS boundary: publish a finished async save, then land an
        # emergency checkpoint after a preemption notice (JAX
        # engine.py:1217,1233-1238)
        self._ckpt_io.maybe_commit()
        if (self._preempt_guard is not None
                and self._preempt_guard.should_checkpoint()):
            self._emergency_checkpoint()
        return mean_loss

    def _to_host(self, tensors) -> torch.Tensor:
        """The 0-dim ``tensors`` as one fp32 host vector: on a card a
        pinned buffer filled by non-blocking copies (ordered on the
        compute stream before the step's event; read after it), on the
        CPU the values themselves."""
        if self.device.type != "cuda":
            return torch.stack([t.detach().float().reshape(())
                                for t in tensors])
        buf = torch.empty(len(tensors), dtype=torch.float32, pin_memory=True)
        for i, t in enumerate(tensors):
            buf[i].copy_(t.detach().reshape(()), non_blocking=True)
        return buf

    def _zero_grads(self, grads):
        """The accumulated gradients reduced over the data ranks (means,
        in place) and cut to this rank's master blocks."""
        flat = dict(leaves(grads))
        self._zero.reduce(flat)
        out: Dict[str, Any] = {}
        for path, g in flat.items():
            set_leaf(out, path, self._zero.opt_grad(path, g))
        return out

    @torch.no_grad()
    def _zenflow_apply(self, scale: Optional[float], lr: float):
        """The ZenFlow branch of the offloaded step (JAX
        ``_offload_apply``): one coefficient applies the unscaling and
        the clip, rounded to the grads' dtype; the fp32 norm stays on the
        card unless fp16 needs the overflow decision. Returns (grad norm,
        overflow)."""
        grads = tree_map(lambda p: p.grad, self.params)
        gnorm = global_norm(grads)
        if scale and scale != 1.0:
            gnorm = gnorm / scale
        coef = torch.tensor(1.0 / (scale or 1.0), dtype=torch.float32,
                            device=gnorm.device)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            clip_t = torch.tensor(clip, dtype=torch.float32,
                                  device=gnorm.device)
            coef = coef * torch.clamp(clip_t / (gnorm + 1e-6), max=1.0)
        overflow = bool(self.config.fp16.enabled
                        and not torch.isfinite(gnorm))
        if overflow:
            return gnorm, True
        if (clip and clip > 0) or (scale and scale != 1.0):
            for _, g in leaves(grads):
                g.mul_(coef.to(g.dtype))
        self._zenflow.step(grads, self.params, lr=lr)
        return gnorm, False

    def _emergency_checkpoint(self) -> None:
        """Preemption-notice path: save and force-commit, bounded by
        ``resilience.preemption_save_deadline_s``. Sets ``preempted`` so
        the training loop can exit cleanly; a torn save is harmless (no
        manifest => auto-resume falls back to the previous good tag)."""
        guard = self._preempt_guard
        save_dir = (self.config.resilience.emergency_save_dir
                    or self._last_save_dir)
        self.preempted = True
        if save_dir is None:
            logger.error(
                "resilience: preemption notice but no checkpoint dir is "
                "known (no prior save_checkpoint and no "
                "resilience.emergency_save_dir) — exiting WITHOUT an "
                "emergency save")
            return
        t0 = time.perf_counter()

        def _save():
            self.save_checkpoint(save_dir)
            self._ckpt_io.commit_pending()  # async engines: force durable

        try:
            run_with_deadline(_save, guard.save_deadline_s,
                              name="preempt_save")
        except _DeadlineExpired:
            logger.error(
                f"resilience: emergency checkpoint blew its "
                f"{guard.save_deadline_s:g}s deadline — exiting with the "
                "save incomplete (manifest validation will reject it and "
                "resume from the previous good tag)")
            return
        logger.warning(
            f"resilience: emergency checkpoint committed to {save_dir} "
            f"in {time.perf_counter() - t0:.2f}s; engine.preempted=True — "
            "stop training and exit")

    # -- micro-step API (JAX engine.py:1387-1445) ---------------------------
    @_on_mesh
    def forward(self, batch) -> torch.Tensor:
        """One microbatch's loss (this rank's rows), keeping the autograd
        graph for :meth:`backward`."""
        self.timers(FORWARD_GLOBAL_TIMER).start()
        loss, aux = self._model_loss(self._to_device(batch))
        self._pending = (loss, aux)
        self.timers(FORWARD_GLOBAL_TIMER).stop(block=self._timer_block(loss))
        return loss

    __call__ = forward

    @_on_mesh
    def backward(self, loss: Optional[torch.Tensor] = None,
                 retain_graph: bool = False) -> torch.Tensor:
        """Back-propagate ``loss`` (default: the last ``forward``'s) into
        the accumulated grads."""
        if self._pending is None:
            raise RuntimeError("backward() called without a prior forward()")
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        pending_loss, aux = self._pending
        self._pending = None
        loss = pending_loss if loss is None else loss
        (loss * self._backward_scale()).backward(retain_graph=retain_graph)
        self._micro_losses.append((loss.detach(), aux))
        self.micro_steps += 1
        self.timers(BACKWARD_GLOBAL_TIMER).stop(
            block=self._timer_block(loss))
        return loss

    def _timer_block(self, t: torch.Tensor):
        """What the micro-step timers wait for: ``t`` under
        ``wall_clock_breakdown`` (JAX's timers always block), else
        nothing (host time, no wait)."""
        return t if self.config.wall_clock_breakdown else None

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps == 0

    @_on_mesh
    def step(self) -> None:
        """Apply the update at the accumulation boundary; a no-op
        elsewhere."""
        if not self.is_gradient_accumulation_boundary():
            return
        if not self._micro_losses:
            raise RuntimeError("step() called without accumulated gradients")
        self.timers(STEP_GLOBAL_TIMER).start()
        if self.flight is not None:
            self.flight.record("step_entry", step=self.global_steps + 1,
                               inflight=0, api="micro")
        micro, self._micro_losses = self._micro_losses, []
        loss = self._apply_update(micro)
        if self.flight is not None:
            self.flight.record("step_drain", step=self.global_steps,
                               api="micro")
        self.timers(STEP_GLOBAL_TIMER).stop(block=self._timer_block(loss))

    @_on_mesh
    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """The loss of this rank's rows (averaged over the data ranks on
        a process group, as JAX's global loss)."""
        self.synchronize()
        loss, _aux = self._model_loss(self._to_device(batch))
        if self._zero is not None:
            loss = comm.all_reduce(loss, topo.BATCH_AXES, op="mean")
        return loss

    # -- state accessors -----------------------------------------------------
    @property
    def optimizer(self) -> _OptimizerView:
        return _OptimizerView(self)

    @property
    def loss_scale(self) -> float:
        return self.loss_scale_state.scale

    @property
    def update_count(self) -> int:
        """Updates applied so far (the LR schedule's position)."""
        if self._zenflow is not None:
            return self._zenflow.steps
        return (self._offload.count if self._offload is not None
                else self.opt_state.count)

    def get_lr(self) -> List[float]:
        """The LR of the next update (the schedule at the count of
        updates applied so far)."""
        if self._host_tier:
            return [float(self.lr_schedule(self.update_count))
                    if self.lr_schedule is not None else self._base_lr]
        if self._client_opt is not None:
            return [float(self._client_opt.param_groups[0]["lr"])]
        return [self.tx.lr_at(self.opt_state.count)]

    def set_lr(self, lr: float) -> None:
        """Override the LR (JAX ``engine.py:1867``, the reference's
        ``param_groups[0]['lr'] = x``): it becomes the base LR and the
        optimizer block's ``lr``; a configured schedule is dropped, with
        JAX's warning. The optimizer's state is kept. Raises with a
        client optimizer, as JAX does (``engine.py:1883``)."""
        if self._client_optimizer_present:
            raise NotImplementedError(
                "set_lr: the engine cannot re-point a client optimizer's "
                "lr; set its param_groups' lr or rebuild the optimizer and "
                "the engine")
        self._base_lr = float(lr)
        if self.lr_schedule is not None:
            logger.warning("set_lr/param_groups override disables the "
                           "configured lr schedule")
            self.lr_schedule = None
        if self.config.optimizer is None:
            self.config.optimizer = OptimizerConfig(
                type="adamw", params={"lr": float(lr)})
        self.config.optimizer.params = dict(
            self.config.optimizer.params or {}, lr=float(lr))
        if self.tx is not None:
            self.tx, _ = get_base_optimizer(self.config.optimizer, None)

    def zero_grad(self) -> None:
        """Drop the micro-step accumulation (JAX ``engine.py:2053``): the
        grads and losses of the backwards since the last update."""
        for _, p in leaves(self.params):
            p.grad = None
        self._grad_acc = {}
        self._grad_shards = {}
        self._micro_losses = []

    def no_sync(self):
        """A context manager that defers the data-parallel gradient sync
        (JAX ``engine.py:1982``): the sync already waits for the
        accumulation boundary (stages 0-1), or is the per-microbatch
        reduce-scatter that ZeRO 2-3 cannot defer."""
        return contextlib.nullcontext()

    def train(self, mode: bool = True) -> "Engine":
        """The module's train / eval mode (JAX ``engine.py:2001``); the
        zoo's models have no mode-dependent layer."""
        self.model.train(mode)
        return self

    def eval(self) -> "Engine":
        return self.train(False)

    def register_post_step_hook(self, fn):
        """``fn(engine)`` runs at every ``global_steps`` increment (JAX
        ``engine.py:1626``), in the order registered."""
        self._post_step_hooks.append(fn)
        return fn

    @torch.no_grad()
    def full_grad(self, path: str) -> Optional[torch.Tensor]:
        """The gradient of leaf ``path`` accumulated since the last update
        (the micro-step path), reduced over the data ranks as the update
        will see it; None when there is none. Collective on a process
        group: every rank calls it."""
        p = self.params
        for k in path.strip("/").split("/"):
            p = p[k]
        g = (self._grad_acc.get(p) if self.gradient_accumulation_steps > 1
             else self._grad_shards.get(p, p.grad))
        if g is None or self._zero is None:
            return g
        zero = self._zero
        with topo.use_mesh(self.mesh):
            if zero.grad_dim.get(path) is None:
                g = comm.all_reduce(g, topo.BATCH_AXES)
            else:
                if self.mesh.shape["dp"] > 1:
                    g = comm.all_reduce(g, "dp")
                g = zero.full(path, g, "grad")
        return g / zero.dp_n if zero.dp_n > 1 else g

    def get_global_grad_norm(self) -> Optional[torch.Tensor]:
        return self._last_grad_norm

    # -- observability (JAX engine.py:1702-1860) ---------------------------
    def _last_step_wall_ms(self) -> float:
        records = self.timers(TRAIN_BATCH_TIMER).records
        return records[-1] if records else 0.0

    def _on_stall_report(self, report: str) -> None:
        if self.hub is not None:
            self.hub.counter_add("train.stalls")
            self.hub.record_event("stall_report", step=self.global_steps,
                                  report=report)

    def _model_flops_per_token(self) -> Optional[float]:
        if self._flops_per_token is None:
            fn = getattr(self.model, "flops_per_token", None)
            self._flops_per_token = float(fn()) if callable(fn) else 0.0
        return self._flops_per_token or None

    def _peaks(self) -> tuple:
        """(bf16 peak TFLOP/s, HBM GB/s) of the engine's device, looked
        up once (None for a card not in the table)."""
        if self._peak is None:
            from deepspeed_tpu_torch.observability import roofline as rl

            self._peak = (rl.detect_peak_tflops(self.device),
                          rl.detect_hbm_gbps(self.device))
        return self._peak

    def _emit_step_trace(self, entry: _InflightStep, wall_ms: float,
                         inflight: int = 0) -> None:
        """The step's ``StepTrace`` row into the hub (JAX
        ``engine.py:1740-1802``), from host values only. A sink that
        fails warns and the step goes on."""
        from deepspeed_tpu_torch.observability import StepTrace
        from deepspeed_tpu_torch.observability.roofline import mfu

        dt = wall_ms / 1000.0
        tokens = entry.tokens
        n_chips = max(1, comm.get_world_size())
        tps = tokens / dt if (tokens and dt > 0) else None
        tps_chip = tps / n_chips if tps else None
        mfu_val = fpt = peak = None
        if tps_chip:
            fpt = self._model_flops_per_token()
            peak = self._peaks()[0]
            if fpt and peak:
                mfu_val = mfu(tps_chip, fpt, peak)
        loss, gnorm = entry.values()
        comm_total, comm_delta = self.hub.comm_deltas()
        compile_d = self.hub.compile_delta()
        trace = StepTrace(
            step=entry.step, wall_ms=wall_ms, tokens=tokens,
            tokens_per_sec=tps, tokens_per_sec_per_chip=tps_chip,
            n_chips=n_chips, loss=loss, grad_norm=gnorm, lr=float(entry.lr),
            loss_scale=float(entry.loss_scale),
            overflow=bool(entry.overflow), skipped_steps=self.skipped_steps,
            mfu=mfu_val, mfu_source="model" if mfu_val else None,
            flops_per_token=fpt, peak_tflops=peak,
            host_gap_ms=entry.host_ms, inflight=inflight,
            compile_events=int(compile_d["events"]),
            compile_secs=compile_d["secs"],
            comm_bytes_total=comm_total or None,
            comm_bytes_delta=comm_delta or None,
            device_mem=mem_util.device_memory_stats(self.device))
        self.hub.record_step(trace)
        if entry.step % self.config.steps_per_print == 0:
            events = [("Train/Samples/step_seconds", dt, entry.samples)]
            if tps is not None:
                events.append(("Train/Samples/tokens_per_sec", tps,
                               entry.samples))
            if mfu_val is not None:
                events.append(("Train/Samples/mfu", mfu_val, entry.samples))
            self._monitor_events(events)
        if self._roofline_cost is None and entry.step >= 2 and (
                os.environ.get("DSTPU_ROOFLINE", "") == "1"
                or self._obs_cfg.xla_cost_analysis):
            try:
                self.roofline()
            except Exception as e:  # observability must never fail a step
                logger.warning(f"roofline failed: {e}")
                self._roofline_cost = {}

    def roofline(self, step_seconds: Optional[float] = None
                 ) -> Dict[str, Any]:
        """Classify the train step against the card's roofline (JAX
        ``engine.py:1804``). JAX lowers and compiles the step once more
        for XLA's cost analysis; the port counts the step on the meta
        device (``attribution.count_step``: every op's FLOPs and bytes,
        the flash kernels' work by formula, the remat recompute, GAS
        microbatches and the optimizer), once, cached. Opt-in via
        ``observability.xla_cost_analysis`` (JAX's key) or
        ``DSTPU_ROOFLINE=1`` (then it runs once, after step 2). Needs one
        prior ``train_batch`` for the batch shape; counts a dense
        ``TransformerLM`` (another model raises). ``step_seconds``
        defaults to the mean of the last 8 step walls (JAX: the last
        one)."""
        from deepspeed_tpu_torch.observability import roofline as rl
        from deepspeed_tpu_torch.observability.attribution import count_step

        if not self._roofline_cost:
            if self._last_batch_shape is None:
                raise RuntimeError(
                    "roofline() needs one prior train_batch() (the batch "
                    "shape comes from it)")
            cfg = self.model_config
            if not isinstance(cfg, tf_model.TransformerConfig) or \
                    isinstance(cfg, moe_transformer.MoETransformerConfig):
                raise NotImplementedError(
                    "roofline() counts a dense TransformerLM step; "
                    f"{type(self.model).__name__} is not counted")
            micro, seq = self._last_batch_shape
            gas = self.gradient_accumulation_steps
            self._roofline_cost = count_step(
                cfg, micro, seq, gas=gas,
                grad_bytes_per_param=4 if gas > 1 else
                torch.empty((), dtype=self.compute_dtype).element_size(),
                device_type=self.device.type)
        if step_seconds is None:
            # drain-to-drain walls add up over a window, not one by one
            # (under dispatch-ahead a step that drains with another reads
            # near 0): the mean of the last 8, the first step's warm-up
            # left out where there are more
            records = self.timers(TRAIN_BATCH_TIMER).records
            recent = (records[1:] if len(records) > 1 else records)[-8:]
            step_seconds = (sum(recent) / len(recent) / 1000.0
                            if recent and sum(recent) > 0 else None)
        peak, hbm = self._peaks()
        if not peak or not hbm:
            raise RuntimeError(
                f"roofline(): no peak rates for {self.device} "
                "(observability/roofline.py)")
        summary = rl.roofline_summary(self._roofline_cost, peak, hbm,
                                      step_seconds=step_seconds)
        if self.hub is not None:
            self.hub.record_event("roofline", step=self.global_steps,
                                  **summary)
            self.hub.gauge("train.arithmetic_intensity",
                           summary["arithmetic_intensity"])
            if "hw_flops_utilization" in summary:
                self.hub.gauge("train.hw_flops_utilization",
                               summary["hw_flops_utilization"])
        return summary

    # -- checkpoints (JAX engine.py:2010-2105) ---------------------------
    def module_state_dict(self) -> Dict[str, np.ndarray]:
        """Host copy of the compute params: ``"."``-joined tree path ->
        numpy array (the JAX engine's keys for the same model; bf16
        leaves come back as fp32, numpy having no bf16)."""
        self.synchronize()
        with topo.use_mesh(self.mesh):
            full = {k: (t if self._zero is None else self._zero.full(
                        "/" + k.replace(".", "/"), t.detach(), "param"))
                    for k, t in module_state_keys(self.params).items()}
        return {k: (t.detach().float() if t.dtype == torch.bfloat16
                    else t.detach()).cpu().numpy()
                for k, t in full.items()}

    @torch.no_grad()
    def load_module_state_dict(self, state_dict, strict: bool = True):
        """Inverse of :meth:`module_state_dict`: each array into its fp32
        master and the compute param, in place (the JAX engine sets the
        params only, and its next update recasts them from the masters).
        ``strict`` raises KeyError on missing AND unexpected keys."""
        own = module_state_keys(self.params)
        missing = sorted(set(own) - set(state_dict))
        unexpected = sorted(set(state_dict) - set(own))
        if strict and (missing or unexpected):
            raise KeyError(
                f"missing keys: {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''}; unexpected keys: "
                f"{unexpected[:5]}{'...' if len(unexpected) > 5 else ''}")
        masters = (None if self._host_tier
                   else module_state_keys(self.opt_state.master))
        for key, p in own.items():
            if key not in state_dict:
                continue
            value = torch.as_tensor(np.asarray(state_dict[key],
                                               dtype=np.float32))
            path = "/" + key.replace(".", "/")
            if self._host_tier:
                (self._zenflow or self._offload).set_full_fp32_param(
                    path, value)
                p.copy_(value)
            elif self._zero is not None:
                with topo.use_mesh(self.mesh):
                    masters[key].copy_(self._zero.block(path, value))
                    p.copy_(self._zero.block(path, value, "param"))
            else:
                masters[key].copy_(value)
                p.copy_(masters[key])

    # -- state offload between phases (JAX engine.py:1913-1978) ---------
    OFFLOAD_STATE_KINDS = frozenset({"lp_params", "hp_params",
                                     "optim_states", "lp_grads",
                                     "contiguous_grad_buffer"})

    @torch.no_grad()
    def offload_states(self, include=None, device: str = "cpu",
                       pin_memory: bool = True, non_blocking: bool = False):
        """Move the engine's card-resident state to host memory, freeing
        the card's bytes (reference engine.offload_states engine.py:5573).
        ``include`` limits the set: "lp_params" / "hp_params" (the
        compute params) and "optim_states" (the device optimizer's
        masters and moments; an offloaded optimizer's already live on
        the host); gradients hold no buffer between steps. Each tensor
        keeps its identity (hooks, the model's shared masters): its card
        storage is emptied and refilled by ``reload_states``."""
        if device != "cpu":
            raise ValueError("offload_states supports device='cpu' only")
        self.synchronize()
        include = set(include or ("lp_params", "optim_states"))
        unknown = include - self.OFFLOAD_STATE_KINDS
        if unknown:
            raise ValueError(f"unknown offload_states entries {unknown}")
        tensors = []
        if include & {"lp_params", "hp_params"}:
            tensors += [t for _, t in leaves(self.params)]
        if "optim_states" in include and self.opt_state is not None:
            st = self.opt_state
            tensors += [t for tree in (st.master,
                                       *st.named_trees().values())
                        for _, t in leaves(tree)]
        out = list(self._offloaded_states or [])
        for t in tensors:
            store = t.untyped_storage()
            if t.device.type == "cpu" or store.nbytes() == 0:
                continue  # on the host already, or shares a storage moved
            host = (memspace.put(t.detach(), "pinned_host") if pin_memory
                    else t.detach().to("cpu"))
            out.append((t, host, store.nbytes()))
            store.resize_(0)
        self._offloaded_states = out

    @torch.no_grad()
    def reload_states(self, non_blocking: bool = False):
        """Inverse of :meth:`offload_states`: every tensor moved gets its
        card storage and bytes back, in place."""
        if self._offloaded_states is None:
            return
        for t, host, nbytes in self._offloaded_states:
            t.untyped_storage().resize_(nbytes)
            t.copy_(host, non_blocking=non_blocking)
        self._offloaded_states = None

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest: bool = True):
        self._last_save_dir = save_dir  # emergency-save fallback target
        self.synchronize()
        return self._ckpt_io.save(save_dir, tag=tag,
                                  client_state=client_state,
                                  save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None,
                        load_module_strict: bool = True,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True):
        """Returns (checkpoint dir, client_state), or (None, None) when
        ``load_dir`` has no ``latest``. The LR schedule's position comes
        back with the optimizer's update count."""
        return self._ckpt_io.load(
            load_dir, tag=tag, load_optimizer_states=load_optimizer_states)

    def resume_data_iter(self, data_iter, source=None):
        """Position ``data_iter`` at the first microbatch the checkpoint
        never consumed, using the data cursor of the last
        ``load_checkpoint`` (no-op on a fresh run). ``source`` names the
        loader (e.g. a ``RepeatingLoader``) whose ``load_state_dict``
        restores its epoch."""
        return resume.resume_data_iter(data_iter, self.loaded_data_cursor,
                                       source=source)


def _batch_tokens(batches) -> Optional[int]:
    """Trained tokens in one boundary (JAX ``_batch_tokens``): each
    microbatch's ``input_ids`` [B, S+1] trains B x S next-token
    positions (the count a benchmark divides by); None when the batch
    has no such array."""
    total = 0
    for mb in batches:
        ids = mb.get("input_ids") if hasattr(mb, "get") else None
        if ids is None:
            return None
        shape = tuple(ids.shape)
        if len(shape) < 2 or shape[-1] < 2:
            return None
        total += int(np.prod(shape[:-1])) * (shape[-1] - 1)
    return total


__all__ = ["initialize", "Engine"]
