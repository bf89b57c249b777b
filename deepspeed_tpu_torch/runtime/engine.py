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
the engine runs as before, with no collective. An MoE model's experts
split over the ``ep`` ranks (``moe.ep_size``): each rank holds E/ep of
every expert stack, a dense gradient reduces over every token rank and an
expert gradient over the dp x fsdp ranks that share the expert. Lamb,
Adafactor and Muon step their blocks with the whole leaf's norms, means
and (Muon) matrices (``optimizer.MasterBlocks``); a client optimizer steps
whole masters on every rank from the gathered gradient blocks; the
optimizer offload tiers and ZenFlow step each rank's blocks on the host
(below). At tp, pp or ep > 1 the whole-leaf optimizers, and at tp, sp,
pp or ep > 1 the host tiers, raise ``NotImplementedError`` naming ROADMAP
queue A item 17. A client optimizer steps whole masters at every mesh:
the reduced gradient blocks are gathered whole over fsdp, ep, tp and pp
(every rank steps the whole tree, as JAX's optax transform sees it under
GSPMD) and each rank keeps its part of the update. With
``performance.overlap_depth`` > 0 at stage 3 the
layer stack runs through JAX's resident overlap stream
(``param_stream.resident_layers_prefetch``: the per-layer fsdp gather
issued ``overlap_depth`` layers ahead, the per-layer reduce-scatter in
the backward), the remat'd loop's values in another order.

Sequence parallelism (``sequence_parallel.size``, or a mesh with an sp
axis): each rank's batch is its rows and its block of the sequence,
cut after the next-token shift (``topology.batch_sharding``; the
engine's own dataloader is cut so). At init the engine composes
``parallel/auto_sp``'s plan onto the model's config under JAX's opt-in
rule (``self.sp_plan``). The model's loss is the mean over the global
tokens on every sp rank, every gradient sums over the sp ranks, and
the clip's norm counts each leaf on sp rank 0.

Pipeline parallelism (``pipeline.stages``, or a pp mesh axis): each
rank holds its stage's L / PP layers of the stacked layer leaves and
the model runs ``parallel/pipeline.pipelined_layers`` under the
``pipeline`` block's microbatches, window and schedule. Every stage
computes the same loss; the engine back-propagates the last stage's
(the others' backward carries zeros, so their collectives still run),
sums the gradients of the leaves every stage holds over pp, and the
clip's norm sums the stages' layers and counts a replicated leaf once.
``offload_param`` at pp raises JAX's error, and so do the 1-bit
optimizers (JAX's manual-dp region does not nest its pipeline's).

Tensor parallelism (``tensor_parallel.autotp_size``, or a mesh with a
tp axis): each rank holds its tp slice of every leaf ``TP_RULES``
shards (heads, kv heads, the MLP width, the vocab; ZeRO's fsdp blocks
are blocks of that slice) and the model issues the tp collectives
(``runtime/sharding.py``). The ranks of one tp group read the same
batch rows (``topology.batch_sharding`` and the dataloader count data
ranks only), the loss is averaged over the data ranks, and the clip's
norm sums the tp-sharded leaves over tp and a replicated leaf once. An
MoE model's experts split their FFN width over tp.

ZeRO++ (JAX ``engine.py:293-420``), armed by JAX's rules on every
mesh: the stage 1-2 step where it applies (AdamW, no fp16, MoE,
offload, client optimizer or hpZ / MiCS, no fsdp, sp, ep or pp ranks;
the default mesh is then dp = world, tp beside it): the ZeRO step over
``runtime/zeropp.FlatPartition`` (qgZ / qwZ / qar over dp on JAX's flat
layout of whole leaves, the update ``zeropp.adamw``); qwZ's int8 gather
at stage 3 (not with MoE, counted in ``zeropp.qwz_disabled``) of the
rank's tp slice, inside the pipeline's stages too; qgZ's quantized
reduction at stages 2-3 with fsdp > 1 and no pp (``runtime/qgz.py``,
the sp ranks' gradients summed full width first; below that it warns
and counts ``zeropp.qgz_disabled``), under which the engine sets the MoE
model's ``moe_impl="einsum"`` and ``group_stats`` and expert gradients
reduce over ep with the quantized wire; hpZ / MiCS as fsdp = the group,
dp = the replicas, the other axes beside them. Flags no part can carry
warn and the standard step runs. The 1-bit optimizers
(``runtime/onebit.py``) replace the optimizer block's; at tp each rank
steps its slice with the whole leaf's compression scale and norms, at
sp the gradients sum over the sp ranks first. The ZeRO++ and 1-bit
steps run on ``train_batch`` only; both take ``set_lr`` without a
rebuild.
``performance.fp8_mlp`` reaches the model's ``fp8_mlp``.

ZeRO-Offload (``zero_optimization.offload_optimizer``, device cpu or
nvme; ``runtime/offload.py``): only the compute-dtype params and their
grads live on the card. The fp32 masters and the optimizer moments live
on the host (or on a local disk) and the native CPU optimizer steps them
(adam, adamw, lion, adagrad, as in JAX), with the LR from the schedule
at the update count. The grads then accumulate in ``p.grad`` in the
compute dtype at GAS > 1 (``loss * scale / gas`` back-propagated per
microbatch, JAX's offload numerics; no fp32 accumulators on the card),
on both APIs. ``offload_states`` / ``reload_states`` empty and refill
the card storage of the params and the device optimizer's state. Across
ranks (dp x fsdp) each rank's host tier holds its ZeRO blocks (the NVMe
tier one swap directory a rank): at the boundary the accumulated
gradients are reduced over the data ranks (stage 2's reduce-scatter
runs then; qgZ's int8 wire where it is on) and cut to the rank's blocks
on the card before they cross to the host, the norm counts each block
once, and the updated compute-dtype blocks are all-gathered at stages
1-2 (stage 3's params are the blocks).

ZeRO-Infinity's param tier (``zero_optimization.offload_param`` beside
the cpu or nvme optimizer tier; ``runtime/param_stream.py``): the
model's stacked layer subtrees (``host_param_paths``, else ``layers``)
live in pinned host memory in the compute dtype, the model streams them
a layer at a time (``performance.param_prefetch_depth`` layers ahead,
bridged onto the model's config; ``overlap_depth`` is the stage-3
overlap below, with no effect on one card), their fp32
gradients land on the host inside the backward, and the host optimizer
writes the updated stack in place. Without the host optimizer it raises,
and ZenFlow falls back to the blocking offload step, as in JAX. Across
ranks the host stack holds the stage's param blocks: at stage 3 each
fetched layer is gathered over fsdp on the card and its gradient
reduce-scattered back before it lands. The
``activation_checkpointing`` block configures
``runtime/activation_checkpointing``, as JAX's engine does, and its
policy and ``cpu_checkpointing``, resolved at build, are pinned on the
engine's model config (``remat_policy``), so that another engine's block
does not change what this one's remat'd layers keep.

ZenFlow (``zero_optimization.zenflow`` beside the cpu tier;
``runtime/zenflow.py``) takes the host optimizer's place: the engine
builds only the ZenFlow optimizer, whose fp32 masters come from the
model's fp32 tensors leaf by leaf. Each update takes one coefficient for
the unscaling and the clip (the fp32 global norm on the card), rounds it
to the grads' dtype and multiplies the grads by it; an fp16 step with a
non-finite norm is skipped without counting an update. The LR comes from
the schedule at the update count. Across ranks ZenFlow steps the rank's
blocks of the reduced gradients (its selection JAX's global top-k, the
ranks' candidates merged) and the blocks are gathered as offload's.

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
from deepspeed_tpu_torch.parallel import pipeline as pipeline_mod
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
from deepspeed_tpu_torch.runtime import activation_checkpointing as act_ckpt
from deepspeed_tpu_torch.runtime import param_stream
from deepspeed_tpu_torch.runtime import sharding
from deepspeed_tpu_torch.runtime.optimizer import (
    SGD, Adagrad, Adam, Lion, MasterBlocks, MixedPrecisionState,
    apply_client_update, apply_mixed_precision_update, get_base_optimizer,
    global_norm, init_mixed_precision, leaves, set_leaf, tree_map)
from deepspeed_tpu_torch.runtime.prefetch import (PrefetchingIterator,
                                                  map_batch, to_device_async,
                                                  wait_ready)
from deepspeed_tpu_torch.runtime.zenflow import (LeafBlock, ZenFlowConfig,
                                                 ZenFlowOptimizer)
from deepspeed_tpu_torch.runtime.zero import ZeroPartition
from deepspeed_tpu_torch.runtime import onebit as onebit_mod
from deepspeed_tpu_torch.runtime import zeropp as zeropp_mod
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
# and Muon's Newton-Schulz read whole leaves: they take ``MasterBlocks``)
ELEMENTWISE_OPTIMIZERS = (Adam, SGD, Lion, Adagrad)


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
        # the 1-bit optimizers (runtime/onebit.py) take the optimizer
        # block's place (JAX engine.py:293-302)
        self._onebit = onebit_mod.onebit_name(config) in \
            onebit_mod.ONEBIT_OPTIMIZERS
        if self._onebit:
            onebit_mod.validate_onebit_config(config)
        # the mesh (JAX engine.py:161-167): the ranks over the named axes
        self.mesh = mesh if mesh is not None else \
            self._default_mesh(topology)
        self._pp_last = self.mesh.axis_index("pp") == \
            self.mesh.shape["pp"] - 1
        topo.set_global_mesh(self.mesh)
        self.dp_world_size = topo.get_data_parallel_world_size(self.mesh)
        config.resolve_batch_size(self.dp_world_size)
        self.plan = sharding.make_sharding_plan(config, self.mesh)
        comm.configure(config)
        self._init_zeropp_flags(config)
        act_ckpt.configure(config.activation_checkpointing)
        self.micro_batch_size = config.train_micro_batch_size_per_chip
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.train_batch_size = config.train_batch_size
        self.compute_dtype = config.compute_dtype
        over = {"dtype": self.compute_dtype}
        if isinstance(model, _FnModel) or not isinstance(
                model, tf_model.TransformerLM):
            # a (loss_fn, params) pair, or a model of its own (the
            # host_param_paths protocol): its loss on the engine's params
            self._loss_fn = lambda _cfg, params, batch: model.loss(params,
                                                                   batch)
        elif isinstance(model.config, moe_transformer.MoETransformerConfig):
            self._loss_fn = moe_transformer.loss_fn
            if config.moe.impl != "auto":
                over["moe_impl"] = config.moe.impl
            if self._qgz_stage3:
                over.update(self._qgz_moe_dispatch(
                    over.get("moe_impl", model.config.moe_impl)))
        else:
            self._loss_fn = loss_fn
        # the performance block's streamed-stack knobs reach the model's
        # config (JAX engine.py:223-246)
        perf = config.performance
        mfields = ({f.name for f in dataclasses.fields(model.config)}
                   if dataclasses.is_dataclass(model.config) else set())
        if perf.param_prefetch_depth is not None and \
                "prefetch_depth" in mfields:
            over["prefetch_depth"] = int(perf.param_prefetch_depth)
        if perf.fp8_mlp and "fp8_mlp" in mfields:
            over["fp8_mlp"] = True
        if perf.overlap_depth is not None and "overlap_depth" in mfields:
            # JAX's stage-3 resident overlap (engine.py:223-246); it acts
            # under a ZeRO-3 fetch over fsdp ranks only
            over["overlap_depth"] = int(perf.overlap_depth)
        if "remat_policy" in mfields:
            # resolved here, once: a later configure() (another engine's)
            # does not change what this engine's steps keep
            over["remat_policy"] = act_ckpt.engine_policy(
                config.activation_checkpointing, model.config.remat_policy)
        self.model_config = (None if model.config is None else
                             dataclasses.replace(model.config, **over))
        self.sp_plan = self._plan_sequence_parallel()
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
        # ZeRO across ranks: on a process group (any world size); the
        # ZeRO++ stage 1-2 step's flat partition at any mesh, as JAX's
        # step quantizes at every axis size
        self._zero: Optional[ZeroPartition] = None
        self._fetch: Optional[sharding.LayerFetch] = None
        if self.mesh.distributed:
            self._check_world(model)
        # the 1-bit step reduces its own gradients (runtime/onebit.py);
        # at tp its leaves are cut as ZeRO's are
        self._quant_step = None
        self._onebit_part: Optional[ZeroPartition] = None
        if self._zeropp:
            self._zero = zeropp_mod.FlatPartition(
                self.plan, self.mesh, self._logical_axes(model), zero.stage,
                model.params(), qg=zero.zero_quantized_gradients,
                qw=zero.zero_quantized_weights,
                qar=zero.zero_quantized_allreduce,
                full_shapes=self._full_shapes(model))
        elif self.mesh.distributed and not self._onebit:
            logical = self._logical_axes(model)
            self._zero = ZeroPartition(self.plan, self.mesh, logical,
                                       zero.stage, qgz=self._qgz_stage3,
                                       full_shapes=self._full_shapes(model))
            self._zero.check(model.params())
            stage3 = any(d is not None
                         for d in self._zero.param_dim.values())
            experts = self._zero.qgz_experts()
            if stage3 or experts:
                self._fetch = sharding.LayerFetch(
                    logical, qwz_bits=8 if self._qwz_stage3 else None,
                    qgz=self._zero.qgz_of if self._qgz_stage3 else None,
                    experts=self._zero.expert_gather_of if experts else None,
                    stage3=stage3)
        if zero.zenflow is not None and zero.offload_device != "cpu":
            raise ValueError(
                "zero_optimization.zenflow requires "
                "offload_optimizer.device='cpu' (ZenFlow keeps masters "
                "host-resident; the NVMe swap tier does not apply), got "
                f"device={zero.offload_device!r}")
        self._offload: Optional[HostOffloadOptimizer] = None
        self._zenflow: Optional[ZenFlowOptimizer] = None
        self._post_step_hooks: List = []
        # offload_param: the model's stacked subtrees that stream from the
        # host (the host_param_paths protocol, else TransformerLM's layers)
        self._param_host_offload = zero.offload_param_device != "none"
        proto = getattr(model, "host_param_paths", None)
        self._host_param_paths = (tuple(proto) if proto is not None
                                  else ("layers",))
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
        elif self._onebit:
            self._init_quant_step(model)
        else:
            if self._zeropp:
                self._base_lr = self._config_lr()
                self.tx = zeropp_mod.adamw(
                    dict((config.optimizer.params or {})
                         if config.optimizer else {}),
                    self.lr_schedule, self._base_lr)
            else:
                self.tx, self._base_lr = get_base_optimizer(
                    config.optimizer, self.lr_schedule)
            if self._zero is not None:
                self._init_zero_state(model)
            else:
                self.opt_state = init_mixed_precision(model.params(),
                                                      self.tx)
                with torch.no_grad():
                    self.params = tree_map(
                        lambda m: m.to(cdt, copy=True).requires_grad_(),
                        self.opt_state.master)
        self._setup_param_host_offload()
        self.loss_scale_state = init_loss_scale(config.fp16)
        self._offloaded_states: Optional[list] = None
        # GAS > 1: fp32 accumulators, one per parameter, filled by the
        # hooks during backward and dropped after each update (with the
        # optimizer offloaded the grads accumulate in p.grad instead);
        # ZeRO's reduce-scattered gradient blocks at GAS 1
        self._grad_acc: Dict[torch.Tensor, torch.Tensor] = {}
        self._grad_shards: Dict[torch.Tensor, torch.Tensor] = {}
        # a host tier's compute-dtype blocks of the params it gathers
        self._blk_bufs: Dict[str, torch.Tensor] = {}
        self._scatter_dims: Dict[torch.Tensor, int] = {}
        if self._zero is not None and not self._host_tier:
            # the host tiers reduce the accumulated gradient once, at the
            # boundary, before it crosses to the host
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
        self._init_quant_stats()
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
        ranks: dp = world for the ZeRO++ stage 1-2 step, fsdp = the group
        and dp = the replicas under hpZ / MiCS, else fsdp = world at
        stage >= 1 and dp = world at stage 0 (pp from the pipeline block,
        sp from the sequence_parallel block, ep from the moe block, tp
        from the tensor_parallel block's ``autotp_size``, as JAX's
        ``engine.py:658-661``)."""
        if topology is not None:
            return topo.build_mesh(topology)
        cfg = self.config
        sizes = dict(pp=cfg.pipeline.stages, sp=cfg.sequence_parallel.size,
                     ep=cfg.moe.ep_size if cfg.moe.enabled else 1,
                     tp=cfg.tensor_parallel.size)
        z = cfg.zero_optimization
        hpz, mics = z.zero_hpz_partition_size, z.mics_shard_size
        group = hpz if hpz > 1 else (mics if mics > 0 else 0)
        if self._zeropp_applicable(cfg) and not self._onebit:
            # the quantized-collective step shards its masters over dp
            sizes.update(dp=-1, fsdp=1)
        elif z.stage >= 1 and group > 1:
            # hpZ and MiCS: shard within a group of ranks, replicate
            # across the groups
            sizes.update(fsdp=group, dp=-1)
        elif z.stage >= 1:
            sizes.update(fsdp=-1, dp=1)
        else:
            sizes.update(dp=-1, fsdp=1)
        return topo.build_mesh(topo.TopologyConfig(**sizes))

    def _zeropp_applicable(self, config) -> bool:
        """The ZeRO++ stage 1-2 step's preconditions (JAX
        ``engine.py:623-660``; the 1-bit exclusion is checked by the
        callers): fp16, MoE, offload, a client optimizer, hpZ / MiCS and
        optimizers other than Adam(W) take the standard path, and so do
        meshes with fsdp, sp, ep or pp ranks (qgZ's stage 2-3 reduction
        serves those)."""
        z = config.zero_optimization
        opt = ((config.optimizer.type if config.optimizer else "")
               or "adamw").lower().replace("_", "").replace("-", "")
        mesh = getattr(self, "mesh", None)
        return (zeropp_mod.zeropp_enabled(config)
                and z.offload_device == "none"
                and not config.fp16.enabled
                and not config.moe.enabled
                and not self._client_optimizer_present
                and config.sequence_parallel.size == 1
                and config.pipeline.stages == 1
                and z.zero_hpz_partition_size <= 1
                and z.mics_shard_size <= 0
                and (mesh is None or all(mesh.shape.get(a, 1) == 1 for a in
                                         ("fsdp", "sp", "ep", "pp")))
                and opt in ("adam", "adamw", "fusedadam", "fusedadamw"))

    def _init_zeropp_flags(self, config) -> None:
        """Which ZeRO++ parts arm, with JAX's warnings and telemetry
        (``engine.py:342-420``): the stage 1-2 step; qwZ's int8 stage-3
        gather (not with MoE); qgZ's quantized reduction at stages 2-3
        (fsdp > 1, no pp)."""
        from deepspeed_tpu_torch.utils import telemetry

        zq = config.zero_optimization
        self._zeropp = self._zeropp_applicable(config) and not self._onebit
        self._qwz_stage3 = (zq.stage == 3 and zq.zero_quantized_weights
                            and not config.moe.enabled)
        if zq.stage == 3 and zq.zero_quantized_weights \
                and not self._qwz_stage3:
            telemetry.count("zeropp.qwz_disabled", "moe")
            logger.warning("ZeRO++ qwZ stage-3 is inert for this config "
                           "(moe) — layer gathers stay full-width bf16")
        if self._qwz_stage3:
            logger.info("ZeRO++ qwZ: stage-3 int8 quantized parameter "
                        "all-gather enabled (fsdp axis)")
        shape = self.mesh.shape
        self._qgz_stage3 = (zq.stage >= 2 and zq.zero_quantized_gradients
                            and shape.get("pp", 1) <= 1
                            and shape.get("fsdp", 1) > 1)
        if self._qgz_stage3:
            logger.info(
                "ZeRO++ qgZ: stage-3 quantized gradient reduction enabled "
                f"(int8 over fsdp={shape['fsdp']}"
                + (f", int8 expert-grads over ep={shape['ep']}"
                   if shape.get("ep", 1) > 1 else "")
                + (f", int4 over dp={shape['dp']}"
                   if shape.get("dp", 1) > 1 else "") + ")")
        elif zq.stage == 3 and zq.zero_quantized_gradients:
            telemetry.count("zeropp.qgz_disabled",
                            "config outside qgZ support matrix")
            logger.warning(
                "ZeRO++ qgZ at stage 3 requires no optimizer offload, "
                "no pp axis, and fsdp > 1 — this config fails that, so "
                "gradients reduce at full width")
        if (zq.zero_quantized_weights or zq.zero_quantized_gradients) \
                and not self._zeropp and not self._qwz_stage3 \
                and not self._qgz_stage3:
            logger.warning(
                "ZeRO++ flags (qwZ/qgZ) are wired for: stage 1-2 with "
                "adam/adamw (no client optimizer), bf16, no optimizer "
                "offload, no MoE, no sp/pp axes (tp composes), no "
                "hpZ/MiCS grouping, no 1-bit optimizer; or stage-3 "
                "zero_quantized_weights/zero_quantized_gradients (dense "
                "models). This config fails those, so the quantized path "
                "is disabled and the standard step runs")

    def _qgz_moe_dispatch(self, impl: str) -> Dict[str, Any]:
        """The MoE layers' dispatch under qgZ (JAX ``parallel/moe.py``'s
        ``_grouped_unsupported_reason``): qgZ reduces one gradient a
        group of batch ranks, so the layers dispatch by einsum over the
        whole expert stack and each group's loss reads its own routing
        statistics; even an explicit "grouped" steps aside, counted
        once as ``moe.grouped_fallback``."""
        from deepspeed_tpu_torch.utils import telemetry

        if impl != "einsum":
            reason = ("token axes reduce per group (qgZ): grouped "
                      "dispatch uses the einsum path")
            telemetry.count("moe.grouped_fallback", reason)
            logger.info(f"moe_impl={impl!r}: {reason}")
        return {"moe_impl": "einsum", "group_stats": True}

    @torch.no_grad()
    def _init_quant_step(self, model) -> None:
        """The 1-bit step: fp32 masters replicated over the data ranks
        (this rank's tp slices at tp > 1) and each rank's error
        feedback, over compute params the step writes."""
        cfg = self.config
        self.tx, self.opt_state = None, None
        src = model.params()
        if self.mesh.shape["tp"] > 1:
            # the model runs its tp slices: the masters are those slices,
            # and the step reads the whole leaf's scale and norms over tp
            part = ZeroPartition(self.plan, self.mesh,
                                 self._logical_axes(model), 0,
                                 full_shapes=self._full_shapes(model))
            self._onebit_part = part
            src = _map_with_path(lambda path, p: part.tp(path, p.detach()),
                                 src)
        self._compute_params(src)
        opt = onebit_mod.parse_onebit_params(
            onebit_mod.onebit_name(cfg),
            cfg.optimizer.params if cfg.optimizer else {})
        self._base_lr = float(opt["lr"])
        self.lr_schedule = get_lr_schedule(cfg.scheduler,
                                           base_lr=self._base_lr)
        self.lr_scheduler = self.lr_schedule
        masters = {path: p.detach().float().clone()
                   for path, p in leaves(src)}
        part = self._onebit_part
        self._quant_step = onebit_mod.OneBitStep(
            masters, opt, self.lr_schedule, cfg.gradient_clipping,
            tp_sharded=(None if part is None else
                        {path for path in masters if path in part.tp_dim}))

    def _check_world(self, model) -> None:
        """What does not run across ranks yet raises, naming its item;
        what JAX refuses raises JAX's error."""
        world = comm.get_world_size()
        if world <= 1:
            return
        zero = self.config.zero_optimization
        pp = self.mesh.shape["pp"]
        if pp > 1 and zero.offload_param_device != "none":
            # JAX's refusal (engine.py:1505-1507), before the tiers'
            raise ValueError("offload_param does not compose with the "
                             "pipeline-parallel layer path yet")
        if pp > 1 and self._onebit:
            # JAX's 1-bit step is a shard_map manual over dp around the
            # whole loss, and the pipeline's stage region (its own
            # shard_map, manual over pp) does not nest in it
            raise ValueError(
                f"1-bit optimizers at pp={pp}: the 1-bit step's region is "
                "manual over dp around the whole loss and the pipeline's "
                "stage region does not nest in it (JAX: the context mesh "
                "should match the mesh passed to shard_map)")
        host = zero.offload_device in ("cpu", "nvme") or \
            zero.zenflow is not None
        wide = {a: self.mesh.shape[a] for a in ("tp", "sp", "pp", "ep")
                if self.mesh.shape[a] > 1}
        if host and wide:
            raise NotImplementedError(
                f"zero_optimization.offload_optimizer / zenflow at "
                + ", ".join(f"{a}={n}" for a, n in wide.items())
                + ": the host optimizer tiers run on dp x fsdp meshes; "
                f"the tp / sp / pp / ep leftovers are {_A} 17")

    @staticmethod
    def _full_shapes(model) -> Optional[Dict[str, tuple]]:
        """Each leaf's whole shape by ``/a/b`` path (a model built as one
        tp rank's slice holds less), or None for a model without
        ``param_shapes``."""
        shapes = getattr(model, "param_shapes", None)
        if shapes is None or getattr(model, "config", None) is None:
            return None
        return tf_model.leaf_shapes(shapes(model.config))

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
        if not isinstance(self.tx, ELEMENTWISE_OPTIMIZERS):
            # tp, pp and ep cut leaves outside ZeRO's fsdp blocks (sp
            # ranks hold the same leaves)
            wide = {a: n for a in ("tp", "pp", "ep")
                    if (n := self.mesh.shape[a]) > 1}
            if wide:
                raise NotImplementedError(
                    f"optimizer {type(self.tx).__name__} with "
                    + ", ".join(f"{a}={n}" for a, n in wide.items())
                    + f": its step reads whole leaves; over dp x fsdp it "
                    f"runs, the tp / pp / ep leftovers are {_A} 17")
            if zero.fsdp_n > 1:
                # its norms and means sum the ranks' parts (JAX's global
                # semantics under GSPMD)
                self.tx.blocks = MasterBlocks(zero.opt_dim, zero.fsdp_n)
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
        hook (a ``(loss_fn, params)`` model gathers its whole tree), under
        the pipeline block's schedule."""
        pcfg = self.config.pipeline
        with pipeline_mod.schedule_defaults(pcfg.microbatches, pcfg.window,
                                            pcfg.schedule):
            if self._fetch is None:
                return self._loss_fn(self.model_config, self.params, batch)
            if isinstance(self.model, _FnModel):
                return self._loss_fn(self.model_config,
                                     self._fetch.tree(self.params), batch)
            with sharding.param_fetch(self._fetch):
                return self._loss_fn(self.model_config, self.params, batch)

    def _plan_sequence_parallel(self):
        """JAX's sequence-parallel planner at init (``engine.py:247-285``):
        with an sp axis > 1, opted in (the model's ``sequence_parallel``
        or ``sequence_parallel.size`` > 1) and ``auto_plan`` on, the
        plan is composed onto the model's config; returns it (or
        None)."""
        sp_cfg = self.config.sequence_parallel
        mcfg = self.model_config
        if not (sp_cfg.auto_plan and mcfg is not None
                and hasattr(mcfg, "num_heads")
                and self.mesh.shape["sp"] > 1
                and (getattr(mcfg, "sequence_parallel", False)
                     or sp_cfg.size > 1)):
            return None
        from deepspeed_tpu_torch.parallel.auto_sp import \
            plan_sequence_parallel
        from deepspeed_tpu_torch.utils.logging import log_dist

        budget = sp_cfg.hbm_budget_gb
        plan = plan_sequence_parallel(
            mcfg.max_seq_len, mcfg.num_heads,
            getattr(mcfg, "num_kv_heads", None), self.mesh,
            int(budget * 2 ** 30) if budget else None,
            head_dim=mcfg.head_dim, hidden_size=mcfg.hidden_size,
            batch_size=self.config.train_micro_batch_size_per_chip or 1,
            dtype_bytes=torch.empty((), dtype=mcfg.dtype).element_size())
        new = plan.apply(mcfg)
        if new is not mcfg:
            self.model_config = new
            log_dist("sp planner: " + "; ".join(plan.reasons), ranks=[0])
        return plan

    def _compute_params(self, src):
        """The compute-dtype params from ``src`` (this rank's blocks at
        ZeRO stage 3); under ``offload_param`` the streamed subtrees go
        straight to pinned host memory (never whole on the card)."""
        with torch.no_grad():
            hosted = {k for k in self._host_param_paths if k in src} \
                if self._param_host_offload else set()
            zero = self._zero

            def card(path, t):
                if zero is not None:  # this rank's stage-3 block
                    t = zero.block(path, t.detach(), "param")
                return t.detach().to(self.compute_dtype,
                                     copy=True).contiguous().requires_grad_()

            def blocks(k, v):  # this rank's stage-3 blocks of a subtree
                return v if zero is None else _map_with_path(
                    lambda path, t: zero.block(path, t.detach(), "param"),
                    v, f"/{k}")

            self.params = {
                k: (tree_map(lambda t: t.requires_grad_(),
                             param_stream.pin_to_host(blocks(k, v),
                                                      self.compute_dtype))
                    if k in hosted else
                    card(f"/{k}", v) if isinstance(v, torch.Tensor) else
                    _map_with_path(card, v, f"/{k}"))
                for k, v in src.items()}

    def _setup_param_host_offload(self) -> None:
        """ZeRO-Infinity's param tier (JAX ``engine.py:1480-1545``): the
        model's stacked layer subtrees live in pinned host memory, in the
        compute dtype, and the model streams them a layer at a time
        (``runtime/param_stream.py``); their gradients land on the host,
        where the host optimizer steps them and writes the stack back in
        place. Requires the host optimizer tier."""
        if not self._param_host_offload:
            return
        pcfg = self.config.zero_optimization.offload_param
        if pcfg.device == "nvme":
            logger.warning("offload_param.device='nvme': layer params are "
                           "held in pinned host RAM (the NVMe tier applies "
                           "to optimizer state); proceeding with cpu "
                           "placement")
        if self._offload is None:
            raise ValueError(
                "offload_param requires offload_optimizer (the ZeRO-"
                "Infinity pairing): add zero_optimization."
                "offload_optimizer.device='cpu'")
        if self.mesh.shape.get("pp", 1) > 1:
            raise ValueError("offload_param does not compose with the "
                             "pipeline-parallel layer path yet")
        mcfg = self.model_config
        if getattr(self.model, "host_param_paths", None) is not None:
            # the protocol: the model streams its declared subtrees when
            # its param_host_offload flag is on
            self.model.param_host_offload = True
        elif mcfg is not None and hasattr(mcfg, "param_host_offload"):
            updates = {"param_host_offload": True}
            if not mcfg.remat:
                logger.warning("offload_param requires per-layer remat to "
                               "keep the stack off the card; enabling remat")
                updates["remat"] = True
            self.model_config = dataclasses.replace(mcfg, **updates)
        else:
            raise ValueError(
                "offload_param needs a model that supports streaming: "
                "either config.param_host_offload (TransformerLM family) "
                "or the host_param_paths protocol "
                "(runtime/param_stream.py)")
        logger.info("offload_param: layer params pinned to host memory; "
                    "the step streams one layer at a time")

    def _init_client_optimizer(self, model, client_optimizer) -> None:
        """The client-optimizer branch (JAX ``engine.py:314-315``, where
        it is an optax transform): fp32 masters (a leaf of the model that
        already is an fp32 tensor is its own master), compute copies, and
        the client's ``torch.optim.Optimizer`` over the masters. Across
        ranks the masters stay whole on every rank (the optimizer steps
        whole tensors, as at world size 1; a model built as a tp slice or
        as one stage's layers is gathered whole first) and the compute
        params are the rank's blocks of its tp and pp slices."""
        self.tx, self._base_lr = None, None
        src = model.params()
        zero = self._zero
        if zero is not None and (zero.tp_n > 1 or zero.pp_n > 1):
            with torch.no_grad():
                src = _map_with_path(zero.whole, src)
        masters = tree_map(lambda p: p if p.dtype == torch.float32
                           else p.detach().float(), src)
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
        if self._param_host_offload:
            logger.warning("zenflow does not compose with offload_param "
                           "streaming; falling back to the blocking "
                           "offload step")
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
        blocks, gather = None, None
        zero = self._zero
        if zero is not None and zero.fsdp_n > 1:
            blocks = {path: LeafBlock(tuple(p.shape), zero.opt_dim.get(path),
                                      zero.fsdp_index, zero.fsdp_n)
                      for path, p in leaves(src)}

            def gather(t):
                return comm.all_gather(t.contiguous(), "fsdp", gather_dim=0)

        zen = ZenFlowOptimizer(self._opt_blocks(src), cfg,
                               lr=self._config_lr(), device=self.device,
                               blocks=blocks, gather=gather)
        self._base_lr = zen.lr
        if self._whole_blocks:
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
            self._opt_blocks(src),
            optimizer_name=(ocfg.type if ocfg else "adamw") or "adamw",
            optimizer_params=dict((ocfg.params or {}) if ocfg else {}),
            grad_clip=self.config.gradient_clipping,
            nvme_path=off.nvme_path if off.device == "nvme" else None,
            buffer_count=off.buffer_count, pin_memory=off.pin_memory,
            grad_transfer_dtype=off.grad_transfer_dtype,
            rank=comm.get_rank())
        self._base_lr = self._offload.lr
        if self._offload.tier == "cpu" and self._whole_blocks:
            self._share_masters(src, self._offload.masters.get)

    @property
    def _whole_blocks(self) -> bool:
        """Every master block is its whole leaf (no process group, or one
        fsdp rank)."""
        return self._zero is None or self._zero.fsdp_n == 1

    def _opt_blocks(self, src):
        """This rank's master block of each leaf of ``src`` (a view; the
        tree itself without a ZeRO partition)."""
        if self._zero is None:
            return src
        return _map_with_path(
            lambda path, p: self._zero.block(path, p.detach(), "opt"), src)

    def _master_blocks_of_params(self):
        """This rank's master block of each compute param (a re-seed)."""
        if self._zero is None:
            return self.params
        return _map_with_path(self._zero.master_of_param, self.params)

    def _host_blocks(self, fill: bool = False):
        """The compute-dtype tree a host tier writes its updated blocks
        into: a param that is its own block (stage 3, or a leaf that does
        not shard) itself, else a card buffer of this rank's block that
        ``_publish_blocks`` gathers into the param (``fill``: holding the
        param's current values first, for ZenFlow's in-place update)."""
        zero = self._zero
        if zero is None:
            return self.params
        bufs = self._blk_bufs

        def blk(path, p):
            d = zero.opt_dim.get(path)
            if zero.param_dim.get(path) is not None or d is None \
                    or zero.fsdp_n == 1:
                return p
            if path not in bufs:
                bufs[path] = torch.empty_like(
                    zero.block(path, p.detach(), "opt"),
                    memory_format=torch.contiguous_format)
            if fill:
                bufs[path].copy_(zero.block(path, p.detach(), "opt"))
            return bufs[path]

        return _map_with_path(blk, self.params)

    @torch.no_grad()
    def _publish_blocks(self, blocks) -> None:
        """Each param from the updated blocks (ZeRO stages 1-2: the
        all-gather of the compute-dtype blocks over fsdp)."""
        flat = dict(leaves(blocks))
        for path, p in leaves(self.params):
            b = flat[path]
            if b is not p:  # a host stack's blocks gather on the card
                p.copy_(comm.all_gather(b.to(self.device), "fsdp",
                                        gather_dim=self._zero.opt_dim[path]))

    def _init_quant_stats(self) -> None:
        """ZeRO++'s quantization telemetry (JAX ``engine.py:590-615``):
        with qwZ or qgZ on, an init-time ``quant.*`` sample of the params
        when collection is configured, else one warning that the error
        and the wire bytes go unmeasured."""
        z = self.config.zero_optimization
        if not (z.zero_quantized_weights or z.zero_quantized_gradients):
            return
        from deepspeed_tpu_torch.observability import quant_stats
        from deepspeed_tpu_torch.utils.logging import warning_once

        if quant_stats.collection_configured(self.config.observability):
            quant_stats.install_engine_collector(self)
        else:
            warning_once(
                "ZeRO++ quantization (zero_quantized_weights/"
                "zero_quantized_gradients) is enabled but no quant.* "
                "collection is configured — quantization error and wire "
                "bytes are unmeasured. Set observability.quant_stats=true.")

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
        offload step differentiates ``sum(loss * scale / gas)``). On a pp
        mesh, 0 on every stage but the last: each stage computes the same
        loss, and the last one's backward is the loss's (the others'
        still run the pipeline's collectives)."""
        if not self._pp_last:
            return 0.0
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

    @topo.on_mesh
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
            if self.mesh.shape["sp"] > 1:  # this rank's sequence blocks
                cut = topo.BatchSlice(0, 1, self.mesh.axis_index("sp"),
                                      self.mesh.shape["sp"])
                data_iter = map(cut.take, data_iter)
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
            gnorm, overflow = self._offload_step(scale if fp16 else None, lr)
        elif self._zenflow is not None:
            gnorm, overflow = self._zenflow_apply(scale if fp16 else None,
                                                  lr)
        elif self._quant_step is not None:
            acc = self.gradient_accumulation_steps > 1
            grads = {path: (self._grad_acc.get(p) if acc else p.grad)
                     for path, p in leaves(self.params)}
            gnorm = self._quant_step.step(grads, self.params)
            overflow = False
        else:
            if self.gradient_accumulation_steps > 1:
                grads = tree_map(lambda p: self._grad_acc.get(p),
                                 self.params)
            else:
                grads = tree_map(lambda p: self._grad_shards.get(p, p.grad),
                                 self.params)
            kw = {}
            if self._zero is not None:
                # the gradients live in ``grads`` alone from here, which
                # the reduction consumes (the flat step frees each as its
                # block replaces it)
                for _, p in leaves(self.params):
                    p.grad = None
                self._grad_shards, self._grad_acc = {}, {}
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
                if self._zero is not None:
                    grads, kw["publish"] = self._client_whole(grads)
                gnorm = apply_client_update(self.opt_state, grads,
                                            self._client_opt, self.params,
                                            **kw)
            else:
                gnorm = apply_mixed_precision_update(
                    self.opt_state, grads, self.tx, self.params, **kw)
        for _, p in leaves(self.params):
            p.grad = None
            param_stream.clear_host_grad(p)
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
        if self.mesh.distributed:  # the mean over the data ranks
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

    def _client_whole(self, grads):
        """A client optimizer across ranks steps whole leaves on every
        rank: the reduced gradient blocks gathered whole, and a publish
        that cuts each updated master to the param's block."""
        zero = self._zero
        with torch.no_grad():
            whole = _map_with_path(lambda path, g: zero.full(path, g),
                                   grads)

        def publish(path, master, param):
            param.copy_(zero.block(path, master, "param"))

        return whole, publish

    def _offload_step(self, scale: Optional[float], lr: float):
        """The host tier's update (JAX ``_offload_apply``): across ranks
        the accumulated gradients are reduced over the data ranks and cut
        to this rank's blocks on the card (qgZ's quantized wire where it
        is on) before they cross to the host, the norm counts each block
        once, and the updated compute-dtype blocks are gathered as the
        stage gathers them. Returns (grad norm, overflow)."""
        fp16 = self.config.fp16.enabled
        grads = tree_map(self._grad_of, self.params)
        if self._zero is None:
            gnorm, overflow = self._offload.step(
                grads, self.params, lr=lr, grad_scale=scale,
                skip_on_nonfinite=fp16)
            return torch.tensor(gnorm, dtype=torch.float32), overflow
        zero = self._zero
        grads = self._zero_grads(grads)
        blocks = self._host_blocks()
        gnorm, overflow = self._offload.step(
            grads, blocks, lr=lr, grad_scale=scale, skip_on_nonfinite=fp16,
            include=zero.owned,
            reduce=lambda sq: zero.norm_reduce(sq.to(self.device)))
        if not overflow:
            self._publish_blocks(blocks)
        return torch.tensor(gnorm, dtype=torch.float32), overflow

    @staticmethod
    def _grad_of(p: torch.Tensor) -> Optional[torch.Tensor]:
        """``p.grad``, or a streamed stack's fp32 host gradient
        (``runtime/param_stream.py``)."""
        return p.grad if p.grad is not None else param_stream.host_grad(p)

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
        in place) and cut to this rank's master blocks. On a pp mesh a
        leaf the stage did not use (a middle stage's embedding) has no
        gradient: zeros stand in, as every rank joins each reduction."""
        flat = dict(leaves(grads))
        grads.clear()  # the caller's tree: ``flat`` holds the gradients
        nccl = comm.get_backend() == "nccl"
        for path, g in flat.items():
            if g is None:
                flat[path] = self._no_grad(path)
                continue
            if nccl and g.device.type == "cpu":
                # a streamed stack's host gradient: NCCL reduces card
                # tensors only
                g = flat[path] = g.to(self.device)
            if self._host_tier:
                # the host tiers keep whole gradients through the window:
                # stage 2's reduce-scatter runs once, at the boundary
                d = self._zero.scatter_dim(path)
                if d is not None:
                    flat[path] = comm.reduce_scatter(g, "fsdp",
                                                     scatter_dim=d)
        self._zero.reduce(flat)
        out: Dict[str, Any] = {}
        for path, g in flat.items():
            set_leaf(out, path, self._zero.opt_grad(path, g))
        return out

    def _no_grad(self, path: str) -> torch.Tensor:
        """Zeros of the shape ``path``'s accumulated gradient has (its
        stage-2 block where it scatters)."""
        p = self.params
        for k in path.strip("/").split("/"):
            p = p[k]
        dt = torch.float32 if self.gradient_accumulation_steps > 1 \
            else p.dtype
        z = torch.zeros(p.shape, dtype=dt, device=p.device)
        d = self._scatter_dims.get(p)
        return sharding.shard_of(z, d).contiguous() if d is not None else z

    @torch.no_grad()
    def _zenflow_apply(self, scale: Optional[float], lr: float):
        """The ZenFlow branch of the offloaded step (JAX
        ``_offload_apply``): one coefficient applies the unscaling and
        the clip, rounded to the grads' dtype; the fp32 norm stays on the
        card unless fp16 needs the overflow decision. Returns (grad norm,
        overflow)."""
        grads = tree_map(lambda p: p.grad, self.params)
        zero = self._zero
        if zero is None:
            gnorm = global_norm(grads)
        else:  # this rank's blocks of the reduced grads
            grads = self._zero_grads(grads)
            gnorm = global_norm(grads, include=zero.owned,
                                reduce=zero.norm_reduce)
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
        if zero is None:
            self._zenflow.step(grads, self.params, lr=lr)
        else:
            blocks = self._host_blocks(fill=True)
            self._zenflow.step(grads, blocks, lr=lr)
            self._publish_blocks(blocks)
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
    @topo.on_mesh
    def forward(self, batch) -> torch.Tensor:
        """One microbatch's loss (this rank's rows), keeping the autograd
        graph for :meth:`backward`."""
        if self._onebit or self._zeropp:
            raise RuntimeError(
                "the 1-bit and ZeRO++ stage 1-2 steps run on the "
                "train_batch() path only; use engine.train_batch(...)")
        self.timers(FORWARD_GLOBAL_TIMER).start()
        loss, aux = self._model_loss(self._to_device(batch))
        self._pending = (loss, aux)
        self.timers(FORWARD_GLOBAL_TIMER).stop(block=self._timer_block(loss))
        return loss

    __call__ = forward

    @topo.on_mesh
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

    @topo.on_mesh
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

    @topo.on_mesh
    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """The loss of this rank's rows (averaged over the data ranks on
        a process group, as JAX's global loss)."""
        self.synchronize()
        loss, _aux = self._model_loss(self._to_device(batch))
        if self.mesh.distributed:
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
        if self._quant_step is not None:
            return self._quant_step.state.step
        return (self._offload.count if self._offload is not None
                else self.opt_state.count)

    def get_lr(self) -> List[float]:
        """The LR of the next update (the schedule at the count of
        updates applied so far)."""
        if self._host_tier or self._quant_step is not None:
            return [float(self.lr_schedule(self.update_count))
                    if self.lr_schedule is not None else self._base_lr]
        if self._client_opt is not None:
            return [float(self._client_opt.param_groups[0]["lr"])]
        return [self.tx.lr_at(self.opt_state.count)]

    def set_lr(self, lr: float) -> None:
        """Override the LR (JAX ``engine.py:1867``, the reference's
        ``param_groups[0]['lr'] = x``): it becomes the base LR and the
        optimizer block's ``lr``; a configured schedule is dropped, with
        JAX's warning. The optimizer and its state are kept, with the new
        LR in place of the old (so the ZeRO++ step keeps its AdamW). Raises
        with a client optimizer, as JAX does (``engine.py:1883``). The
        1-bit step takes the LR as an override."""
        if self._quant_step is not None:
            self._quant_step.lr_override = float(lr)
            self._base_lr = float(lr)
            if self.lr_schedule is not None:
                logger.warning("set_lr override disables the configured "
                               "lr schedule for the runtime-lr step")
                self.lr_schedule = None
                self._quant_step.lr_schedule = None
            return
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
            self.tx = dataclasses.replace(self.tx, lr=float(lr))

    def zero_grad(self) -> None:
        """Drop the micro-step accumulation (JAX ``engine.py:2053``): the
        grads and losses of the backwards since the last update."""
        for _, p in leaves(self.params):
            p.grad = None
            param_stream.clear_host_grad(p)
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
                g = comm.all_reduce(g, zero._with_sp(topo.BATCH_AXES))
                for axis, dims in (("tp", zero.tp_dim), ("pp", zero.pp_dim)):
                    d = dims.get(path)
                    if d is not None:  # this rank's slice made whole
                        g = comm.all_gather(g.contiguous(), axis,
                                            gather_dim=d)
            else:
                axes = zero._with_sp("dp")
                if self.mesh.axis_size(axes) > 1:
                    g = comm.all_reduce(g, axes)
                g = zero.full(path, g, "grad")
            if zero.pp_n > 1 and path not in zero.pp_dim:
                g = comm.all_reduce(g, "pp")
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
        part = self._zero or self._onebit_part
        with topo.use_mesh(self.mesh):
            full = {k: (t if part is None else part.full(
                        "/" + k.replace(".", "/"), t.detach(), "param"))
                    for k, t in module_state_keys(self.params).items()}
        # a copy: on the CPU ``.numpy()`` would alias the live params
        return {k: np.array((t.detach().float() if t.dtype == torch.bfloat16
                             else t.detach()).cpu().numpy(), copy=True)
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
        masters = (None if self._host_tier or self._quant_step is not None
                   else module_state_keys(self.opt_state.master))
        for key, p in own.items():
            if key not in state_dict:
                continue
            value = torch.as_tensor(np.asarray(state_dict[key],
                                               dtype=np.float32))
            path = "/" + key.replace(".", "/")
            if self._host_tier:
                tier = self._zenflow or self._offload
                if self._zero is not None:
                    with topo.use_mesh(self.mesh):
                        tier.set_full_fp32_param(
                            path, self._zero.block(path, value))
                        p.copy_(self._zero.block(path, value, "param"))
                else:
                    tier.set_full_fp32_param(path, value)
                    p.copy_(value)
            elif self._zero is not None:
                with topo.use_mesh(self.mesh):
                    # a client optimizer's masters are whole leaves
                    masters[key].copy_(
                        value if self._client_opt is not None
                        else self._zero.block(path, value))
                    p.copy_(self._zero.block(path, value, "param"))
            elif self._quant_step is not None:
                part = self._onebit_part
                p.copy_(value if part is None else part.tp(path, value))
            else:
                masters[key].copy_(value)
                p.copy_(masters[key])
        if self._quant_step is not None:
            self.reseed_quant_masters(moments=False)

    @torch.no_grad()
    def reseed_quant_masters(self, moments: bool = True) -> None:
        """The 1-bit step's fp32 masters from the compute params (after a
        load of the params alone); ``moments`` also zeroes the moments
        and the error feedback."""
        qs = self._quant_step
        for path, p in leaves(self.params):
            qs.state.master[path].copy_(p.float())
            if moments:
                for tree in (qs.state.m, qs.state.v, qs.state.error):
                    tree[path].zero_()

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
