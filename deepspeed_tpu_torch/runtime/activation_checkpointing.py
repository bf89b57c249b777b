"""Activation checkpointing: which activations a remat'd layer keeps
(port of ``deepspeed_tpu/runtime/activation_checkpointing.py``).

Reference: ``deepspeed/runtime/activation_checkpointing/checkpointing.py``
(``checkpoint()`` :948, ``partition_activations`` :377, CPU
checkpointing, RNG tracking :124, ``configure()`` :1029).

Each knob and its counterpart here:

  * ``checkpoint()`` and the policies -> ``torch.utils.checkpoint.
    checkpoint(use_reentrant=False, context_fn=...)``. The two contexts
    are this module's dispatch modes: in the forward ``_SaveMode`` keeps
    the outputs of the ops the policy saves, and in the backward's
    recompute ``_ReplayMode`` hands them back instead of running the op
    again; every other op is recomputed. The autograd graph of the
    recompute is built as without a policy, so the checkpoint's own
    saved-tensor bookkeeping is unchanged.
  * The policies of JAX's ``POLICIES``: ``nothing_saveable`` recomputes
    everything; ``dots_saveable`` keeps the matmul outputs (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``) and ``dots_with_no_batch_dims_
    saveable`` those without a batch dim (``mm``, ``addmm``); the named
    policies keep the tensors the layer names with
    :func:`checkpoint_name` (``qkv_proj``, ``attn_kernel_out``,
    ``attn_out``, ``mlp_out``); ``none`` / ``everything`` run the layer
    without remat.
  * A named tensor is the last matmul, or the last flash forward,
    issued inside its ``checkpoint_name`` region: the region saves its
    output and recomputes the rest, as JAX's ``checkpoint_name`` names a
    value. The flash forward is the dispatcher operator
    ``dstpu::flash_fwd`` (``ops/flash_attention.FLASH_FWD_OP``): one op
    that a policy keeps whole (its ``o`` and ``lse``) or launches again.
  * An engine resolves its block's policy and ``cpu_checkpointing`` once,
    onto its model's ``remat_policy`` (:func:`engine_policy`): a later
    :func:`configure`, another engine's, does not change what its steps
    keep. The module-level settings serve the direct
    :func:`checkpoint` API and a model without an engine.
  * ``cpu_checkpointing`` and ``offload_dots_host`` -> the saved outputs
    go to pinned host memory on the card's copy stream
    (``utils/memspace.py``) and come back to the card in the recompute.
    They never pass through saved-tensor hooks, so they compose with the
    checkpoint's own hooks.
  * ``partition_activations`` -> JAX's ``_partition_constraint``: at
    tp > 1 the checkpointed call's first tensor argument (the residual
    stream) enters the checkpoint as this rank's 1/tp of its last dim
    (``sharding.tp_slice``, whose backward all-gathers the gradient) and
    is all-gathered inside it, so the checkpoint keeps the slice and the
    recompute gathers again; a last dim that does not divide stays
    whole. The identity at tp = 1.
  * ``contiguous_memory_optimization`` -> accepted, no effect (the
    caching allocator packs the recompute's buffers), with JAX's log
    line.
  * RNG tracking -> :func:`model_parallel_rng` seeds a ``torch.Generator``
    per tp rank; the recompute of a non-reentrant checkpoint restores
    the RNG state, so dropout replays bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import defaultdict
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from deepspeed_tpu_torch.ops.flash_attention import FLASH_FWD_OP
from deepspeed_tpu_torch.runtime import sharding
from deepspeed_tpu_torch.utils import memspace
from deepspeed_tpu_torch.utils.logging import logger

# remat policy registry (config activation_checkpointing.policy), JAX's
POLICIES = {
    "nothing_saveable": "nothing_saveable",
    "dots_saveable": "dots_saveable",
    "dots_with_no_batch_dims_saveable": "dots_with_no_batch_dims_saveable",
    "offload_dots_host": "offload_dots_host",
    "none": "everything",
    "everything": "everything",
    "save_qkv_proj": ("names", ("qkv_proj",)),
    "save_attn_out": ("names", ("attn_out",)),
    "save_qkv_attn_out": ("names", ("qkv_proj", "attn_kernel_out",
                                    "attn_out")),
    "save_attn_mlp": ("names", ("qkv_proj", "attn_kernel_out", "attn_out",
                                "mlp_out")),
}

_GLOBAL_CONFIG: dict = {}

_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm.default, _aten.addmm.default,
                   _aten.bmm.default, _aten.baddbmm.default))
_DOTS_NO_BATCH = frozenset((_aten.mm.default, _aten.addmm.default))
# the ops whose output a checkpoint_name region names: the matmuls and
# the flash forward
_NAMEABLE = _DOTS | {FLASH_FWD_OP}


@dataclasses.dataclass(frozen=True)
class SavePolicy:
    """What a checkpointed call keeps: matmul outputs (``dots``: None,
    "all" or "no_batch"), the named tensors of ``names``, in pinned host
    memory when ``offload``."""

    dots: Optional[str] = None
    names: Tuple[str, ...] = ()
    offload: bool = False

    def saves_op(self, func) -> bool:
        if self.dots == "all":
            return func in _DOTS
        return self.dots == "no_batch" and func in _DOTS_NO_BATCH


# a full recompute, as a value an engine pins on its model's config
SAVE_NOTHING = SavePolicy()


def configure(config=None, partition_activations: Optional[bool] = None,
              cpu_checkpointing: Optional[bool] = None,
              contiguous_memory_optimization: Optional[bool] = None,
              number_checkpoints: Optional[int] = None,
              synchronize_checkpoint_boundary: Optional[bool] = None,
              profile: Optional[bool] = None,
              policy: Optional[str] = None):
    """Reference ``configure`` (checkpointing.py:1029): the module-level
    defaults from an ``ActivationCheckpointingConfig`` or keyword
    overrides. Returns the resulting settings."""
    global _GLOBAL_CONFIG
    if config is not None:
        _GLOBAL_CONFIG = {
            "partition_activations": getattr(config, "partition_activations",
                                             False),
            "cpu_checkpointing": getattr(config, "cpu_checkpointing", False),
            "policy": getattr(config, "policy", "nothing_saveable"),
        }
        if getattr(config, "contiguous_memory_optimization", False):
            logger.info("activation checkpointing: "
                        "contiguous_memory_optimization is inherent in "
                        "the caching allocator (no-op)")
    for k, v in [("partition_activations", partition_activations),
                 ("cpu_checkpointing", cpu_checkpointing),
                 ("policy", policy)]:
        if v is not None:
            _GLOBAL_CONFIG[k] = v
    return dict(_GLOBAL_CONFIG)


def is_configured() -> bool:
    return bool(_GLOBAL_CONFIG)


def resolve_policy(name=None, cpu_checkpointing: bool = False):
    """Policy name -> a :class:`SavePolicy`, or the sentinels None (save
    nothing: full recompute) and ``"everything"`` (no remat). The
    module-level settings fill in what the call leaves out; a policy
    already resolved (:func:`engine_policy`) is returned as it is."""
    if isinstance(name, SavePolicy):
        return None if name == SAVE_NOTHING else name
    return _resolve(name or _GLOBAL_CONFIG.get("policy", "nothing_saveable"),
                    bool(cpu_checkpointing
                         or _GLOBAL_CONFIG.get("cpu_checkpointing")))


def engine_policy(block, model_policy=None):
    """What an engine's model keeps, resolved from its own settings
    alone: the model's ``remat_policy`` (a name wins over the block), else
    the ``activation_checkpointing`` block's policy, with the block's
    ``cpu_checkpointing``. Returns a :class:`SavePolicy`
    (:data:`SAVE_NOTHING` for a full recompute) or ``"everything"``."""
    if isinstance(model_policy, SavePolicy):
        return model_policy
    resolved = _resolve(
        model_policy or getattr(block, "policy", "nothing_saveable"),
        bool(getattr(block, "cpu_checkpointing", False)))
    return SAVE_NOTHING if resolved is None else resolved


def _resolve(name: str, offload: bool):
    canonical = POLICIES.get(name)
    if canonical is None:
        raise ValueError(f"unknown activation checkpointing policy "
                         f"'{name}' (choose from {sorted(POLICIES)})")
    if canonical == "everything":
        return "everything"  # remat explicitly disabled: offload n/a
    if isinstance(canonical, tuple) and canonical[0] == "names":
        # the host-offload request holds for named saves too
        return SavePolicy(names=canonical[1], offload=offload)
    if offload:
        canonical = "offload_dots_host"
    if canonical == "nothing_saveable":
        return None
    if canonical == "offload_dots_host":
        return SavePolicy(dots="no_batch", offload=True)
    return SavePolicy(dots="all" if canonical == "dots_saveable"
                      else "no_batch")


# -- the dispatch modes ------------------------------------------------------

_TLS = threading.local()


def _stack(attr: str) -> list:
    s = getattr(_TLS, attr, None)
    if s is None:
        s = []
        setattr(_TLS, attr, s)
    return s


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the tensor computed inside the block (JAX's
    ``checkpoint_name``): a policy that lists ``name`` keeps the last
    matmul or flash forward output of the block. A no-op outside a
    checkpointed call."""
    frames = _stack("frames")
    frame = frames[-1] if frames else None
    if frame is None:
        yield
        return
    frame.open_region(name)
    try:
        yield
    finally:
        frame.close_region()


class _Entry:
    """One recorded op of a checkpointed forward: its saved outputs
    (None: recompute it)."""

    __slots__ = ("saved", "on_host")

    def __init__(self):
        self.saved = None
        self.on_host = False


class _Frame:
    """The record of one checkpointed call: per op, in issue order, what
    the forward kept."""

    def __init__(self, policy: SavePolicy):
        self.policy = policy
        self.entries = defaultdict(list)
        self.counts = defaultdict(int)
        self.regions: List[list] = []  # [name, last candidate entry]

    # forward
    def open_region(self, name: str) -> None:
        self.regions.append([name, None, None])

    def close_region(self) -> None:
        name, entry, out = self.regions.pop()
        if entry is not None and name in self.policy.names:
            self._keep(entry, out)

    def record(self, key, out, candidate: bool) -> None:
        entry = _Entry()
        self.entries[key].append(entry)
        if self.policy.saves_op(key):
            self._keep(entry, out)
        elif candidate and self.regions:
            # the region's output so far: its last matmul or flash forward
            self.regions[-1][1:] = [entry, out]

    def _keep(self, entry: _Entry, out) -> None:
        if not self.policy.offload:
            entry.saved = tree_map(
                lambda t: t.detach() if isinstance(t, torch.Tensor) else t,
                out)
            return
        entry.on_host = True
        entry.saved = tree_map(
            lambda t: (_Hosted(memspace.offload(t), t.device)
                       if isinstance(t, torch.Tensor) else t), out)

    # recompute
    def take(self, key) -> Optional[_Entry]:
        i = self.counts[key]
        self.counts[key] += 1
        entries = self.entries.get(key)
        if entries is None or i >= len(entries):
            raise RuntimeError(
                f"activation checkpointing: the recompute issued {key} "
                f"#{i}, which the forward did not (a nondeterministic or "
                "state-dependent recompute)")
        return entries[i]

    @staticmethod
    def restore(entry: _Entry):
        if not entry.on_host:
            return entry.saved
        return tree_map(lambda x: x.back() if isinstance(x, _Hosted) else x,
                        entry.saved)


class _Hosted:
    """A saved output in pinned host memory (its copy in flight on the
    copy stream), and the card it goes back to."""

    __slots__ = ("transfer", "device")

    def __init__(self, transfer: memspace.Transfer, device: torch.device):
        self.transfer, self.device = transfer, device

    def back(self) -> torch.Tensor:
        # the copy down and the copy up share the copy stream: in order
        return memspace.fetch(self.transfer.tensor, self.device).wait()


def _aliases(func) -> bool:
    """A view / in-place op (its outputs alias an input), or an op
    without a schema: run as is, never recorded."""
    schema = getattr(func, "_schema", None)
    return schema is None or any(r.alias_info is not None
                                 for r in schema.returns)


class _SaveMode(TorchDispatchMode):
    def __init__(self, frame: _Frame):
        super().__init__()
        self.frame = frame

    def __enter__(self):
        _stack("frames").append(self.frame)
        return super().__enter__()

    def __exit__(self, *exc):
        _stack("frames").pop()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # an op's own aten calls (the flash forward's plain version) run
        # below this handler, unseen
        out = func(*args, **(kwargs or {}))
        if not _aliases(func):
            self.frame.record(func, out, candidate=func in _NAMEABLE)
        return out


class _ReplayMode(TorchDispatchMode):
    def __init__(self, frame: _Frame):
        super().__init__()
        self.frame = frame

    def __enter__(self):
        self.frame.counts.clear()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _aliases(func):
            return func(*args, **(kwargs or {}))
        entry = self.frame.take(func)
        if entry.saved is None:
            return func(*args, **(kwargs or {}))
        return self.frame.restore(entry)


class _Contexts:
    """``context_fn`` of one checkpointed call: a fresh frame, its
    forward and recompute modes."""

    def __init__(self, policy: SavePolicy):
        self.policy = policy

    def __call__(self):
        frame = _Frame(self.policy)
        return _SaveMode(frame), _ReplayMode(frame)


def _remat(function: Callable, resolved) -> Callable:
    """``function`` under the resolved policy's checkpoint."""
    if resolved == "everything":
        return function
    if resolved is None:
        def inner(*args, **kwargs):
            return torch.utils.checkpoint.checkpoint(
                function, *args, use_reentrant=False, **kwargs)
        return inner
    contexts = _Contexts(resolved)

    def inner(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            function, *args, use_reentrant=False, context_fn=contexts,
            **kwargs)
    return inner


def checkpoint_wrapper(function: Callable,
                       policy: Optional[str] = None,
                       partition_activations: Optional[bool] = None,
                       cpu_checkpointing: bool = False) -> Callable:
    """``function`` wrapped with the configured remat behavior."""
    resolved = resolve_policy(policy, cpu_checkpointing)
    part = (_GLOBAL_CONFIG.get("partition_activations", False)
            if partition_activations is None else partition_activations)
    inner = _remat(function, resolved)
    if not part:
        return inner

    def gathered(i):
        def fn(*args, **kwargs):
            args = list(args)
            args[i] = sharding.tp_gather(args[i])
            return function(*args, **kwargs)
        return fn

    def wrapped(*args, **kwargs):
        # JAX's _partition_constraint on the first array argument (the
        # residual stream): the identity at tp = 1 or when its last dim
        # does not divide
        i = next((j for j, a in enumerate(args)
                  if isinstance(a, torch.Tensor)), None)
        n = sharding.tp_size()
        if i is None or n == 1 or args[i].dim() < 1 or \
                args[i].shape[-1] % n:
            return inner(*args, **kwargs)
        args = list(args)
        args[i] = sharding.tp_slice(args[i])
        return _remat(gathered(i), resolved)(*args, **kwargs)

    return wrapped


def checkpoint(function: Callable, *args, **kwargs) -> Any:
    """Reference-parity direct call (checkpointing.py:948): run
    ``function(*args)`` under the configured remat policy."""
    return checkpoint_wrapper(function)(*args, **kwargs)


def model_parallel_rng(seed: int, axis: str = "tp",
                       device=None) -> torch.Generator:
    """A ``torch.Generator`` of its own for each rank of ``axis`` (the
    tracker's model-parallel stream, checkpointing.py:124): ``seed``
    folded with the rank's index on the axis (0 without a mesh)."""
    from deepspeed_tpu_torch.parallel import topology

    mesh = topology._GLOBAL_MESH
    index = mesh.axis_index(axis) if mesh is not None else 0
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed((int(seed) * 1_000_003 + index) % (1 << 63))
    return gen


__all__ = ["POLICIES", "SavePolicy", "configure", "is_configured",
           "resolve_policy", "engine_policy", "SAVE_NOTHING",
           "checkpoint_name",
           "checkpoint_wrapper", "checkpoint", "model_parallel_rng"]
