"""Logical-axis sharding rules: the ZeRO stages as shardings over ranks
(port of the ZeRO part of ``deepspeed_tpu/runtime/sharding.py``).

Every parameter leaf carries a tuple of logical axis names
(``models/transformer.logical_axes``); a rule table maps logical axes to
mesh axes by the configured ZeRO stage, as in JAX:

  stage 0: params, grads and optimizer state replicated over the data
           axes (the grads all-reduced);
  stage 1: the fp32 masters and the moments shard over ``fsdp``;
  stage 2: + the gradients (reduce-scatter instead of all-reduce);
  stage 3: + the parameters (all-gathered at each use).

The rule is ``("embed", "fsdp")``: a leaf shards along its ``embed``
dim, wherever that dim sits (``[L, embed, heads, hd]`` for wq, the last
dim of wo, dim 1 of the ``[vocab, embed]`` table), and rank r holds the
r-th block, the shard JAX's device r holds on an fsdp mesh. A leaf
without an ``embed`` dim stays replicated.

JAX lets GSPMD insert the collectives from sharding constraints. Here
they are explicit: ``fsdp_gather_slice`` gathers a layer's shards
through an autograd Function whose backward reduce-scatters that layer's
gradient back to the shards (JAX's ``fsdp_scatter_grads``, which is
therefore no function of its own here, nor is ``gathered_layer_spec``:
the gathered leaf is simply whole). The model calls it through the fetch
hook (``param_fetch`` / ``active_fetch``) inside each remat'd layer, so
the recompute gathers again, as DeepSpeed's stage 3 re-fetches. The
engine installs the hook at stage 3.

ZeRO++ at stage 3 (qwZ): under an armed ``qwz_context`` the gather moves
int8 codes and fp32 scales (``quantized_param_fetch``: the B6 quantize
on this rank's shard, both gathered over fsdp, the 6b dequantize), with
the straight-through backward (the reduce-scatter, or qgZ's quantized
reduction when the fetch carries one). ``qwz_sequence_barrier`` is the
identity: an eager program issues each gather where the code stands.
hpZ and MiCS build fsdp = the group and dp = the replicas
(``make_sharding_plan`` keeps the state sharded over the fsdp group).

Tensor parallelism (``TP_RULES``: heads, kv heads, the MLP width and
the vocab over ``tp``): where JAX lets GSPMD insert the collectives, the
port issues them through autograd Functions, Megatron's pair:
``tp_copy`` (the identity; the backward all-reduces) before a
column-parallel projection and ``tp_reduce`` (the all-reduce; the
backward is the identity) after a row-parallel one. ``tp_gather`` makes
vocab-sharded logits whole, ``vocab_parallel_lookup`` is JAX's masked
local gather and all-reduce, ``vocab_parallel_nll`` the cross-entropy of
vocab-sharded logits (the max and the sum all-reduced, never the logits
gathered), and ``tp_local`` a leaf's tp slice.

Not ported, with their reasons: the GSPMD-only context
managers ``disable_constraints`` / ``manual_axes`` / ``vmapped_axes``,
``constrain_activation``, ``named_sharding`` and ``effective_dtype`` have
no eager counterpart: there is no partitioner to steer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import topology

logger = logging.getLogger(__name__)

# Logical axis vocabulary used by the model zoo.
LOGICAL_AXES = (
    "batch", "seq", "embed", "mlp", "heads", "kv_heads", "head_dim",
    "vocab", "layers", "expert", "norm", "stack",
)

# Tensor-parallel rule table (AutoTP analog): column-parallel dims.
TP_RULES: Tuple[Tuple[str, Any], ...] = (
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("mlp", "tp"),
    ("vocab", "tp"),
)

# Fully-sharded-data-parallel rule: shard the embed (d_model) dim.
FSDP_RULES: Tuple[Tuple[str, Any], ...] = (("embed", "fsdp"),)

# Expert parallel: experts shard over ep.
EP_RULES: Tuple[Tuple[str, Any], ...] = (("expert", "ep"),)

# Pipeline: the stacked-layer dim shards over pp.
PP_RULES: Tuple[Tuple[str, Any], ...] = (("layers", "pp"),)

# Activation rules.
ACT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp", "ep")),
    ("seq", "sp"),
)

Spec = Tuple[Any, ...]  # JAX's PartitionSpec as a tuple: None | axis | axes


def spec_from_logical(logical_axes: Sequence[Optional[str]],
                      rules: Sequence[Tuple[str, Any]]) -> Spec:
    """Map a tuple of logical axis names to a spec (a tuple, JAX's
    ``PartitionSpec`` entries). The first matching rule wins per dim; a
    mesh axis already used by an earlier dim is skipped; trailing
    ``None`` entries are dropped."""
    used: set = set()
    out = []
    for name in logical_axes:
        entry: Any = None
        if name is not None:
            for lname, maxes in rules:
                if lname != name:
                    continue
                cand = (maxes,) if isinstance(maxes, str) else tuple(maxes)
                cand = tuple(a for a in cand if a not in used)
                if cand:
                    entry = cand[0] if len(cand) == 1 else cand
                    used.update(cand)
                break
        out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map_axes(fn, tree, path: str = ""):
    """``fn(path, axes)`` over a logical-axes tree (leaves are tuples,
    paths the port's ``/a/b``)."""
    if _is_axes_leaf(tree):
        return fn(path, tree)
    return {k: _map_axes(fn, v, f"{path}/{k}") for k, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Per-role rule tables for one (config, mesh) pair."""

    mesh: Any
    param_rules: Tuple[Tuple[str, Any], ...]
    grad_rules: Tuple[Tuple[str, Any], ...]
    opt_rules: Tuple[Tuple[str, Any], ...]
    act_rules: Tuple[Tuple[str, Any], ...] = ACT_RULES

    def param_spec(self, logical_axes) -> Spec:
        return spec_from_logical(logical_axes, self.param_rules)

    def grad_spec(self, logical_axes) -> Spec:
        return spec_from_logical(logical_axes, self.grad_rules)

    def opt_spec(self, logical_axes) -> Spec:
        return spec_from_logical(logical_axes, self.opt_rules)

    # tree-level helpers ----------------------------------------------------
    def param_shardings(self, spec_tree):
        # z3-leaf-marked paths keep params replicated over the data axes
        return _map_axes(lambda path, ax: z3_leaf_spec(
            path, self.param_spec(ax)), spec_tree)

    def grad_shardings(self, spec_tree):
        return _map_axes(lambda _p, ax: self.grad_spec(ax), spec_tree)

    def opt_shardings(self, spec_tree):
        return _map_axes(lambda _p, ax: self.opt_spec(ax), spec_tree)


# ---------------------------------------------------------------------------
# z3 leaf modules (reference deepspeed/utils/z3_leaf_module.py:149)
# ---------------------------------------------------------------------------
# Params under a marked subtree stay replicated over the data axes (fetched
# as one unit, never partitioned), while their grads and optimizer state
# shard as before. Patterns are substrings of the param path, in either
# the port's form (``/layers/moe``) or JAX's keystr (``['layers']['moe']``).

_Z3_LEAF_PATTERNS: list = []
_DATA_AXES = ("dp", "fsdp")


def set_z3_leaf_modules(patterns) -> list:
    """Mark param-path substrings as leaf units. Returns the active
    pattern list."""
    if isinstance(patterns, str):
        patterns = [patterns]
    for p in patterns:
        if p not in _Z3_LEAF_PATTERNS:
            _Z3_LEAF_PATTERNS.append(p)
    return list(_Z3_LEAF_PATTERNS)


def unset_z3_leaf_modules(patterns=None) -> list:
    if patterns is None:
        _Z3_LEAF_PATTERNS.clear()
    else:
        for p in ([patterns] if isinstance(patterns, str) else patterns):
            if p in _Z3_LEAF_PATTERNS:
                _Z3_LEAF_PATTERNS.remove(p)
    return list(_Z3_LEAF_PATTERNS)


def get_z3_leaf_modules() -> list:
    return list(_Z3_LEAF_PATTERNS)


def _keystr(path: str) -> str:
    """``/layers/attn/wq`` -> JAX's ``['layers']['attn']['wq']``."""
    return "".join(f"['{k}']" for k in path.strip("/").split("/"))


def z3_leaf_spec(path: str, spec: Spec) -> Spec:
    """Strip the data axes from ``spec`` when ``path`` matches a leaf
    pattern."""
    if not _Z3_LEAF_PATTERNS:
        return spec
    forms = (path, _keystr(path)) if path.startswith("/") else (path,)
    if not any(p in f for p in _Z3_LEAF_PATTERNS for f in forms):
        return spec
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, str):
            out.append(None if entry in _DATA_AXES else entry)
        else:
            kept = tuple(a for a in entry if a not in _DATA_AXES)
            out.append(kept[0] if len(kept) == 1 else (kept or None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def make_sharding_plan(config, mesh) -> ShardingPlan:
    """Compile the config's ZeRO choices into rule tables (JAX's). Under
    hpZ / MiCS the mesh is fsdp = group, dp = replicas, and the state
    shards over the group (JAX's hpZ splits it over dp x fsdp as well:
    the same values, held ``dp`` times)."""
    stage = config.zero_optimization.stage
    base: list = list(TP_RULES) + list(EP_RULES) + list(PP_RULES)
    param_rules = list(base)
    if stage >= 3:
        param_rules += list(FSDP_RULES)
    grad_rules = list(base)
    if stage >= 2:
        grad_rules += list(FSDP_RULES)
    opt_rules = list(base)
    if stage >= 1:
        opt_rules += list(FSDP_RULES)
    from deepspeed_tpu_torch.runtime.zeropp import zeropp_enabled

    # the ZeRO++ stage 1-2 step shards its masters over dp itself
    if stage >= 1 and mesh.shape["fsdp"] == 1 and mesh.shape["dp"] > 1 \
            and not zeropp_enabled(config):
        logger.warning(
            "ZeRO stage >= 1 configured but mesh fsdp axis is 1; state will "
            "not shard. Put your data-parallel degree on the fsdp axis "
            "(TopologyConfig(fsdp=-1)) to enable partitioning.")
    return ShardingPlan(mesh=mesh, param_rules=tuple(param_rules),
                        grad_rules=tuple(grad_rules),
                        opt_rules=tuple(opt_rules))


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim of ``spec`` that shards over mesh axis ``axis``, or
    None."""
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if axis in axes:
            return d
    return None


def fsdp_dim(spec: Spec) -> Optional[int]:
    """The dim of ``spec`` that shards over ``fsdp``, or None."""
    return axis_dim(spec, "fsdp")


def shard_of(t: torch.Tensor, dim: Optional[int], axis: str = "fsdp"
             ) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axis`` (a view;
    ``t`` itself when ``dim`` is None or the axis has one rank)."""
    if dim is None:
        return t
    n = comm.axis_size(axis)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, comm.axis_index(axis) * size, size)


# ---------------------------------------------------------------------------
# stage 3: the gather at use and the gradient scatter
# ---------------------------------------------------------------------------


def _gathers(axis: str = "fsdp") -> bool:
    """Whether fsdp collectives communicate (JAX's passthrough when no
    mesh is set or fsdp is 1)."""
    mesh = topology._GLOBAL_MESH
    return mesh is not None and mesh.issues(axis)


def _scatter_back(grad, dim, axis, qgz):
    """A gathered leaf's gradient back to this rank's block: the exact
    reduce-scatter (summed over the ranks), or qgZ's quantized reduction
    (the mean over the data ranks)."""
    if qgz is not None:
        return qgz(grad).to(grad.dtype)
    return comm.reduce_scatter(grad, axis, scatter_dim=dim)


class _FsdpGather(torch.autograd.Function):
    """Forward: all-gather a shard along ``dim``; backward: reduce-scatter
    the full gradient back to this rank's block (summed over ranks)."""

    @staticmethod
    def forward(ctx, shard, dim, axis, qgz):
        ctx.dim, ctx.axis, ctx.qgz = dim, axis, qgz
        return comm.all_gather(shard, axis, gather_dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_back(grad, ctx.dim, ctx.axis, ctx.qgz), None, None, \
            None


# ---------------------------------------------------------------------------
# ZeRO++ qwZ: the int8 stage-3 gather
# ---------------------------------------------------------------------------

_QWZ_BITS: Optional[int] = None
QWZ_BLOCK = 128


def configure_qwz(bits: Optional[int]) -> None:
    """Arm / disarm the quantized stage-3 fetch (int8 only, as in JAX)."""
    global _QWZ_BITS
    if bits is not None and bits != 8:
        raise ValueError(f"qwZ stage-3 fetch supports int8 only, got {bits}")
    _QWZ_BITS = bits


class qwz_context:
    """Scoped qwZ arming: ``with qwz_context(8): model.loss(...)``."""

    def __init__(self, bits: Optional[int]):
        self._bits = bits

    def __enter__(self):
        global _QWZ_BITS
        self._prev = _QWZ_BITS
        configure_qwz(self._bits)

    def __exit__(self, *a):
        global _QWZ_BITS
        _QWZ_BITS = self._prev
        return False


def qwz_active() -> bool:
    return _QWZ_BITS is not None


def qwz_sequence_barrier(weight, value):
    """JAX orders a qwZ fetch after ``value`` on its CPU simulator; an
    eager program issues each gather where the code stands: the
    identity."""
    return weight, value


def qwz_plan(shape, spec: Spec, mesh) -> Optional[Tuple[int, int]]:
    """(the dim that carries the quantization blocks, the block) of a
    stage-3 leaf under qwZ, or None when the exact gather runs: no fsdp
    dim, no other dim, or no block > 1 tiles the chosen dim (JAX's
    ``quantized_param_fetch`` rule: the last unsharded dim, else the
    last non-fsdp one)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))

    def has_fsdp(e):
        return e == "fsdp" or (isinstance(e, tuple) and "fsdp" in e)

    if not any(has_fsdp(e) for e in entries):
        return None
    candidates = [i for i, e in enumerate(entries) if not has_fsdp(e)]
    if not candidates:
        return None
    unsharded = [i for i in candidates if entries[i] is None]
    ax = unsharded[-1] if unsharded else candidates[-1]
    div = 1
    for a in (() if entries[ax] is None else
              (entries[ax],) if isinstance(entries[ax], str)
              else entries[ax]):
        div *= mesh.shape.get(a, 1)
    n = shape[ax]
    if n % max(div, 1):
        return None
    block = math.gcd(n // max(div, 1), QWZ_BLOCK)
    return (ax, block) if block > 1 else None


class _QwzGather(torch.autograd.Function):
    """qwZ: this rank's shard quantized along ``ax`` (B6), int8 codes and
    fp32 scales all-gathered along ``dim``, dequantized (6b) to the
    shard's dtype. The backward is straight through: the gradient goes
    back as the exact gather's does. Nothing full-width is saved."""

    @staticmethod
    def forward(ctx, shard, dim, axis, ax, block, qgz):
        from deepspeed_tpu_torch.ops.quantization import (dequantize,
                                                          quantize_blockwise)

        ctx.dim, ctx.axis, ctx.qgz = dim, axis, qgz
        moved = shard.movedim(ax, -1).contiguous()
        d = dim if dim < ax else dim - 1  # the fsdp dim after the move
        q, s = quantize_blockwise(moved, bits=8, block=block)
        sg = comm.all_gather(s, axis, gather_dim=d, log_name="qwz_scales")
        qg = comm.all_gather(q, axis, gather_dim=d,
                             log_name="qwz_param_fetch")
        nb = s.shape[-1]
        out = dequantize(qg.reshape(*qg.shape[:-1], nb, block), sg,
                         shard.dtype)
        return out.reshape(qg.shape).movedim(-1, ax)

    @staticmethod
    def backward(ctx, grad):
        return (_scatter_back(grad.contiguous(), ctx.dim, ctx.axis,
                              ctx.qgz),
                None, None, None, None, None)


def quantized_param_fetch(x: torch.Tensor, logical_axes, path: str = "",
                          qgz=None) -> torch.Tensor:
    """qwZ stage-3 fetch of one shard ``x`` (JAX's function of the same
    name): the int8 gather over fsdp when qwZ is armed, the mesh has
    fsdp ranks and the leaf's rule gives a block; else the exact gather
    (``gather_leaf``)."""
    rules = TP_RULES + EP_RULES + PP_RULES + FSDP_RULES
    spec = z3_leaf_spec(path, spec_from_logical(logical_axes, rules))
    dim = fsdp_dim(spec)
    if dim is None or not _gathers():
        return x
    plan = None
    if _QWZ_BITS is not None:
        # JAX's rule reads the global shape: this rank's shard times the
        # ranks of every axis its dims split over (fsdp, and tp for the
        # rank's tp slice)
        mesh = topology._GLOBAL_MESH
        entries = list(spec) + [None] * (x.dim() - len(spec))
        full = [n * math.prod(mesh.shape.get(a, 1) for a in
                              ((e,) if isinstance(e, str) else (e or ())))
                for n, e in zip(x.shape, entries)]
        plan = qwz_plan(full, spec, mesh)
    if plan is None:
        return _FsdpGather.apply(x, dim, "fsdp", qgz)
    return _QwzGather.apply(x, dim, "fsdp", plan[0], plan[1], qgz)


# ---------------------------------------------------------------------------
# qgZ's groups: each rank's gradient is its group's
# ---------------------------------------------------------------------------
# JAX's qgZ takes one gradient per batch-shard group (a vmap), and its MoE
# layers then dispatch by einsum over the whole expert stack (a shard_map
# cannot map a vmapped axis), with each group's own routing statistics.
# The engine resolves that dispatch onto the model's config (``moe_impl``
# and ``group_stats``); under ep the fetch gathers each expert leaf whole,
# and its backward reduces the group's gradient over every expert with
# qgZ's levels (the ep level onto the expert dim: ``runtime/qgz.py`` level
# 2).


class _ExpertGather(torch.autograd.Function):
    """An expert leaf's block (its E/ep experts, and its fsdp shard at
    stage 3) gathered whole: over fsdp, then over ep along the expert
    dim. The backward reduces the whole gradient with ``reduce`` (qgZ's
    levels, the mean over the data ranks as this rank's block) and, where
    the param is whole over fsdp (stage 2), gathers the block back (fp32,
    exact) to the param's shape."""

    @staticmethod
    def forward(ctx, t, fdim, edim, reduce, regather):
        ctx.reduce, ctx.regather = reduce, regather
        out = t
        if fdim is not None:
            out = comm.all_gather(out, "fsdp", gather_dim=fdim)
        return comm.all_gather(out.contiguous(), "ep", gather_dim=edim)

    @staticmethod
    def backward(ctx, g):
        blk = ctx.reduce(g.contiguous())
        if ctx.regather is not None:
            blk = comm.all_gather(blk.contiguous(), "fsdp",
                                  gather_dim=ctx.regather,
                                  log_name="qgz_regather")
        return blk.to(g.dtype), None, None, None, None


def gather_leaf(t: torch.Tensor, dim: Optional[int],
                axis: str = "fsdp") -> torch.Tensor:
    """The full leaf from this rank's shard ``t`` (``dim`` None: ``t``);
    its gradient flows back reduce-scattered."""
    if dim is None or not _gathers(axis):
        return t
    return _FsdpGather.apply(t, dim, axis, None)


def _walk_with_logical(params, logical, fn, path=""):
    if _is_axes_leaf(logical):
        return fn(params, logical, path)
    return {k: _walk_with_logical(params[k], logical[k], fn, f"{path}/{k}")
            for k in params}


def fsdp_gather_slice(layer_tree: Any, logical_tree: Any,
                      prefix: str = "/layers", qgz=None, experts=None,
                      stage3: bool = True) -> Any:
    """The stage-3 fetch hook (JAX's ``fsdp_gather_slice`` with its
    ``fsdp_scatter_grads`` as the backward): one layer's shards gathered
    along each leaf's ``embed`` dim, whose backward reduce-scatters the
    layer's gradient to the shards (int8 under qwZ; qgZ's reduction when
    ``qgz(path, axes)`` gives one). The port's layer loop has already
    unbound the ``[L, ...]`` stack into per-layer views, so
    ``layer_tree`` is layer i's and ``logical_tree`` its per-layer axes
    (the ``"layers"`` dim dropped); ``prefix`` is the layer tree's path,
    for the z3 leaf patterns. ``experts(path, axes)`` (qgZ's groups under
    ep) gives an expert leaf's whole-stack gather (fsdp dim, expert dim,
    reduce, regather dim), or None; ``stage3`` False gathers nothing
    else (a stage-2 fetch of the expert leaves only)."""
    if not _gathers():
        return layer_tree

    def fetch(t, axes, path):
        plan = None if experts is None else experts(path, axes)
        if plan is not None:
            return _ExpertGather.apply(t, *plan)
        if not stage3:
            return t
        return quantized_param_fetch(
            t, axes, path, None if qgz is None else qgz(path, axes))

    return _walk_with_logical(layer_tree, logical_tree, fetch, prefix)


def _layer_dim(axes, path: str) -> Optional[int]:
    """The fsdp dim of one layer's leaf at stage 3 (its z3 rule
    applied), or None where it stays whole."""
    rules = TP_RULES + EP_RULES + PP_RULES + FSDP_RULES
    return fsdp_dim(z3_leaf_spec(path, spec_from_logical(axes, rules)))


def fsdp_gather_layer(stack_tree: Any, i: Optional[int],
                      logical_tree: Any, prefix: str = "/layers") -> Any:
    """The overlap engine's ``fetch`` at stage 3 (JAX
    ``fsdp_gather_slice``, ``runtime/sharding.py:665``): layer ``i`` of
    the resident ``[L, ...]`` block stack (``i`` None: ``stack_tree`` is
    one layer's blocks already) gathered whole over fsdp, with no
    autograd record (``fsdp_scatter_grads`` is its backward).
    ``logical_tree`` holds the per-layer axes (the ``"layers"`` dim
    dropped)."""
    def one(t, axes, path):
        dim = _layer_dim(axes, path)
        x = t if i is None else t[i]
        if dim is None or not _gathers():
            return x.detach()
        return comm.all_gather(x.detach().contiguous(), "fsdp",
                               gather_dim=dim)

    with torch.no_grad():
        return _walk_with_logical(stack_tree, logical_tree, one, prefix)


def fsdp_scatter_grads(grads: Any, logical_tree: Any, qgz=None,
                       prefix: str = "/layers") -> Any:
    """The overlap engine's ``grad_sink`` at stage 3 (JAX
    ``fsdp_scatter_grads``, ``runtime/sharding.py:701``): one layer's
    gradient reduce-scattered back to this rank's blocks (qgZ's reduction
    where ``qgz(path, axes)`` gives one), as the stage-3 gather's
    backward does; a leaf that stays whole keeps its gradient."""
    def one(g, axes, path):
        dim = _layer_dim(axes, path)
        if dim is None or not _gathers():
            return g
        return _scatter_back(g, dim, "fsdp",
                             None if qgz is None else qgz(path, axes))

    with torch.no_grad():
        return _walk_with_logical(grads, logical_tree, one, prefix)


class LayerFetch:
    """The stage-3 fetch hook the model's layer loop calls: ``layer``
    gathers one layer's shards, ``leaf`` one top-level leaf at its use
    (the embeddings, the final norm, the LM head). ``qwz_bits`` arms the
    int8 gather around each fetch (JAX arms it around the engine's own
    trace); ``qgz(path, axes)`` gives a leaf's quantized gradient
    reduction, or None."""

    def __init__(self, logical_tree: Dict[str, Any],
                 qwz_bits: Optional[int] = None, qgz=None, experts=None,
                 stage3: bool = True):
        self.logical = logical_tree
        self.qwz_bits = qwz_bits
        self.qgz = qgz
        self.experts = experts
        self.stage3 = stage3
        self._cache: Dict[Any, torch.Tensor] = {}  # one forward's leaves
        # a (loss_fn, params) tree need not have a layer stack
        self.layer_axes = _map_axes(lambda _p, ax: ax[1:],
                                    logical_tree.get("layers", {}))

    def _red(self, path, axes):
        return None if self.qgz is None else self.qgz(path, axes)

    def layer(self, layer_tree):
        with qwz_context(self.qwz_bits):
            return fsdp_gather_slice(layer_tree, self.layer_axes,
                                     qgz=self.qgz, experts=self.experts,
                                     stage3=self.stage3)

    def leaf(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """A top-level leaf gathered once a forward (a tied embedding's
        two uses share one gather, so its gradient reduces once, as
        JAX's does)."""
        if not self.stage3:
            return t
        key = (path, id(t))
        if key in self._cache:
            return self._cache[key]
        node = self.logical
        for k in path.strip("/").split("/"):
            node = node[k]
        # JAX quantizes the LM head's fetch, not the embeddings' lookup
        bits = self.qwz_bits if path.strip("/") == "unembed/kernel" \
            else None
        with qwz_context(bits):
            out = quantized_param_fetch(t, node, path, self._red(path, node))
        self._cache[key] = out
        return out

    def tree(self, params):
        """Every leaf of a params tree gathered (a ``(loss_fn, params)``
        model, whose layer loop has no hook)."""
        return _walk_with_logical(
            params, self.logical,
            lambda t, axes, path: quantized_param_fetch(
                t, axes, path, self._red(path, axes)))


_FETCH: Optional[LayerFetch] = None


@contextlib.contextmanager
def param_fetch(fetch: Optional[LayerFetch]):
    """Install ``fetch`` as the model's fetch hook for the duration of a
    forward. The layer loop captures it when the forward starts, so the
    remat recompute in the backward gathers again with it."""
    global _FETCH
    prev, _FETCH = _FETCH, fetch
    if fetch is not None:
        fetch._cache.clear()
    try:
        yield fetch
    finally:
        _FETCH = prev
        if fetch is not None:
            fetch._cache.clear()


def active_fetch() -> Optional[LayerFetch]:
    return _FETCH


def fetched(fetch: Optional[LayerFetch], params: Dict[str, Any],
            path: str) -> torch.Tensor:
    """The leaf at ``path`` of ``params``, gathered when a fetch hook is
    on."""
    node = params
    for k in path.strip("/").split("/"):
        node = node[k]
    return node if fetch is None else fetch.leaf(path, node)


# ---------------------------------------------------------------------------
# tensor parallelism: the collectives GSPMD inserts for the TP_RULES specs
# ---------------------------------------------------------------------------
# JAX places the heads, the MLP width and the vocab over tp and lets XLA
# insert the collectives. An eager program writes them (Megatron's
# column / row pair): a column-parallel projection takes its replicated
# input through ``tp_copy`` (the identity; its backward sums the ranks'
# partial input gradients), a row-parallel one gives a partial sum that
# ``tp_reduce`` all-reduces (its backward is the identity: the gradient
# of a replicated value is the same on every rank). Each is a no-op
# where the mesh has no tp ranks.

TP = "tp"


def tp_size() -> int:
    """The tp ranks of the global mesh when its tp collectives
    communicate (1 otherwise: the model then holds whole leaves)."""
    mesh = topology._GLOBAL_MESH
    if mesh is None or mesh.shape.get(TP, 1) == 1 or not mesh.issues(TP):
        return 1
    return mesh.shape[TP]


def tp_index() -> int:
    return topology._GLOBAL_MESH.axis_index(TP) if tp_size() > 1 else 0


class _TpCopy(torch.autograd.Function):
    """Into the tp region: the identity; the backward all-reduces."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.contiguous(), TP, log_name="tp_copy_grad")


class _TpReduce(torch.autograd.Function):
    """Out of the tp region: the all-reduce; the backward is the
    identity."""

    @staticmethod
    def forward(ctx, x):
        return comm.all_reduce(x.contiguous(), TP, log_name="tp_reduce")

    @staticmethod
    def backward(ctx, g):
        return g


class _TpGather(torch.autograd.Function):
    """The ranks' slices of the last dim all-gathered; the backward
    keeps this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-1]
        return comm.all_gather(x.contiguous(), TP, gather_dim=-1,
                               log_name="tp_gather")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, tp_index() * ctx.n, ctx.n).contiguous()


class _TpSlice(torch.autograd.Function):
    """This rank's slice of a replicated tensor's last dim; the backward
    all-gathers the ranks' gradient slices."""

    @staticmethod
    def forward(ctx, x):
        n = x.shape[-1] // tp_size()
        return x.narrow(-1, tp_index() * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g.contiguous(), TP, gather_dim=-1,
                               log_name="tp_slice_grad")


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """A replicated input entering a column-parallel op."""
    return _TpCopy.apply(x) if tp_size() > 1 else x


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel op's partial sums, summed over the tp ranks."""
    return _TpReduce.apply(x) if tp_size() > 1 else x


def tp_gather(x: torch.Tensor) -> torch.Tensor:
    """Vocab-sharded logits (the last dim) made whole on every rank."""
    return _TpGather.apply(x) if tp_size() > 1 else x


def tp_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's 1/tp of a replicated tensor's last dim (JAX's rule:
    a dim that does not divide stays whole)."""
    n = tp_size()
    if n == 1 or x.shape[-1] % n:
        return x
    return _TpSlice.apply(x)


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor,
                          axis: str = TP,
                          vocab: Optional[int] = None) -> torch.Tensor:
    """Embedding lookup on a vocab-sharded table (JAX
    ``runtime/sharding.py:549``): each rank gathers the ids of its own
    vocab rows, zeroes the others and the all-reduce assembles the row
    each token hit. The ids are clamped to [0, V) first, as XLA's gather
    clamps. The backward is the masked scatter-add into this rank's
    rows. ``table`` is this rank's [V/tp, H] rows; with no tp ranks, or
    a whole table (``vocab`` rows: a vocab that does not divide stays
    whole), the plain gather."""
    if axis != TP:
        raise ValueError(f"vocab_parallel_lookup shards over tp, got "
                         f"axis {axis!r}")
    n = tp_size()
    if n <= 1 or table.shape[0] == vocab:
        return table[ids.long()]
    shard = table.shape[0]
    V = shard * n
    ids = ids.long().clamp(0, V - 1)
    local = ids - tp_index() * shard
    valid = (local >= 0) & (local < shard)
    rows = table[torch.where(valid, local, torch.zeros_like(local))]
    rows = rows * valid[..., None].to(rows.dtype)
    return tp_reduce(rows)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """The cross-entropy (logsumexp - gold) of vocab-sharded fp32 logits
    [..., V/tp] without gathering them: the max and the sum of the
    exponentials all-reduced over tp, the gold logit from the rank that
    holds it. Whole logits (no tp ranks) take ``logsumexp`` as before."""
    labels = labels.long()
    if tp_size() == 1:
        logz = torch.logsumexp(logits, dim=-1)
        return logz - torch.gather(logits, -1, labels[..., None])[..., 0]
    shard = logits.shape[-1]
    m = comm.all_reduce(logits.detach().amax(dim=-1), TP, op="max",
                        log_name="tp_ce_max")
    s = tp_reduce(torch.exp(logits - m[..., None]).sum(dim=-1))
    logz = torch.log(s) + m
    local = labels - tp_index() * shard
    valid = (local >= 0) & (local < shard)
    gold = torch.gather(logits, -1, torch.where(
        valid, local, torch.zeros_like(local))[..., None])[..., 0]
    gold = tp_reduce(gold * valid.to(gold.dtype))
    return logz - gold


# ---------------------------------------------------------------------------
# sequence parallelism: each sp rank holds its block of the sequence
# ---------------------------------------------------------------------------
# A token-wise op needs nothing; attention exchanges over sp
# (``parallel/ulysses.py``, ``parallel/ring_attention.py``) and the loss
# sums each rank's part. Every sp rank's loss is then the whole one, and
# each rank's gradients are its part of the whole gradient: the engine
# sums them over sp, so ``sp_sum``'s backward is the identity.

SP = "sp"


def fsdp_size() -> int:
    """The fsdp ranks of the global mesh when its fsdp collectives
    communicate (1 otherwise)."""
    mesh = topology._GLOBAL_MESH
    if mesh is None or mesh.shape.get("fsdp", 1) == 1 or \
            not mesh.issues("fsdp"):
        return 1
    return mesh.shape["fsdp"]


def sp_size() -> int:
    """The sp ranks of the global mesh when its sp collectives
    communicate (1 otherwise)."""
    mesh = topology._GLOBAL_MESH
    if mesh is None or mesh.shape.get(SP, 1) == 1 or not mesh.issues(SP):
        return 1
    return mesh.shape[SP]


def sp_index() -> int:
    return topology._GLOBAL_MESH.axis_index(SP) if sp_size() > 1 else 0


class _SpSum(torch.autograd.Function):
    """A per-rank partial sum summed over sp; the backward is the
    identity (each rank's gradient is its part, summed by the engine)."""

    @staticmethod
    def forward(ctx, x):
        return comm.all_reduce(x.contiguous(), SP, log_name="sp_loss_sum")

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherSum(torch.autograd.Function):
    """This rank's block all-gathered over ``axes`` along ``dim``; the
    backward reduce-scatters (sums the ranks' cotangents of the whole and
    keeps this rank's block), as each rank's cotangent is its part of the
    whole one."""

    @staticmethod
    def forward(ctx, x, axes, dim, log_name):
        ctx.axes, ctx.dim, ctx.log_name = axes, dim, log_name
        return comm.all_gather(x.contiguous(), axes, gather_dim=dim,
                               log_name=log_name)

    @staticmethod
    def backward(ctx, g):
        return comm.reduce_scatter(g.contiguous(), ctx.axes,
                                   scatter_dim=ctx.dim,
                                   log_name=ctx.log_name + "_grad"), \
            None, None, None


def gather_sum(x: torch.Tensor, axes, dim: int,
               log_name: str = "gather") -> torch.Tensor:
    """``x``'s blocks over ``axes`` made whole along ``dim`` (``_GatherSum``;
    the identity where the axes have no ranks)."""
    if not axes or comm.axis_size(axes) == 1:
        return x
    return _GatherSum.apply(x, axes, dim, log_name)


def sp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the sp ranks (the identity without them)."""
    return _SpSum.apply(x) if sp_size() > 1 else x


def tp_local(t, dim: Optional[int], full: int, n: int, index: int):
    """This rank's tp slice of a leaf along ``dim`` (a view): ``t``
    itself when it is already the slice (``full / n`` long there) or
    ``dim`` is None."""
    if dim is None or n == 1 or t.shape[dim] * n == full != t.shape[dim]:
        return t
    if t.shape[dim] != full or full % n:
        raise ValueError(f"a leaf of shape {tuple(t.shape)}: dim {dim} is "
                         f"neither {full} nor its 1/{n} slice")
    size = full // n
    return t.narrow(dim, index * size, size)


__all__ = ["fsdp_size", "fsdp_gather_layer", "fsdp_scatter_grads",
           "LOGICAL_AXES", "TP_RULES", "FSDP_RULES", "EP_RULES", "PP_RULES",
           "ACT_RULES", "spec_from_logical", "ShardingPlan",
           "make_sharding_plan", "set_z3_leaf_modules",
           "unset_z3_leaf_modules", "get_z3_leaf_modules", "z3_leaf_spec",
           "fsdp_dim", "shard_of", "gather_leaf", "fsdp_gather_slice",
           "LayerFetch", "param_fetch", "active_fetch", "fetched",
           "QWZ_BLOCK", "configure_qwz", "qwz_context",
           "qwz_active", "qwz_sequence_barrier", "qwz_plan",
           "quantized_param_fetch", "tp_size", "tp_index", "tp_copy",
           "tp_reduce", "tp_gather", "tp_slice", "vocab_parallel_lookup",
           "vocab_parallel_nll", "axis_dim", "tp_local", "sp_size",
           "sp_index", "sp_sum", "gather_sum"]
