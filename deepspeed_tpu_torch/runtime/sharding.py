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

Not ported, with their reasons: the qwZ parts (``qwz_context``,
``quantized_param_fetch``, ``qwz_sequence_barrier``) go with ROADMAP
queue A item 10; ``vocab_parallel_lookup`` with item 11 (tensor
parallelism); the GSPMD-only context managers ``disable_constraints`` /
``manual_axes`` / ``vmapped_axes``, ``constrain_activation``,
``named_sharding`` and ``effective_dtype`` have no eager counterpart:
there is no partitioner to steer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
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
    """Compile the config's ZeRO choices into rule tables (JAX's; the
    hpZ branch needs ``zero_hpz_partition_size`` > 1, which the config
    refuses: ROADMAP queue A item 10)."""
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
    if stage >= 1 and mesh.shape["fsdp"] == 1 and mesh.shape["dp"] > 1:
        logger.warning(
            "ZeRO stage >= 1 configured but mesh fsdp axis is 1; state will "
            "not shard. Put your data-parallel degree on the fsdp axis "
            "(TopologyConfig(fsdp=-1)) to enable partitioning.")
    return ShardingPlan(mesh=mesh, param_rules=tuple(param_rules),
                        grad_rules=tuple(grad_rules),
                        opt_rules=tuple(opt_rules))


def fsdp_dim(spec: Spec) -> Optional[int]:
    """The dim of ``spec`` that shards over ``fsdp``, or None."""
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if "fsdp" in axes:
            return d
    return None


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


class _FsdpGather(torch.autograd.Function):
    """Forward: all-gather a shard along ``dim``; backward: reduce-scatter
    the full gradient back to this rank's block (summed over ranks)."""

    @staticmethod
    def forward(ctx, shard, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return comm.all_gather(shard, axis, gather_dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter(grad, ctx.axis, scatter_dim=ctx.dim), \
            None, None


def gather_leaf(t: torch.Tensor, dim: Optional[int],
                axis: str = "fsdp") -> torch.Tensor:
    """The full leaf from this rank's shard ``t`` (``dim`` None: ``t``);
    its gradient flows back reduce-scattered."""
    if dim is None or not _gathers(axis):
        return t
    return _FsdpGather.apply(t, dim, axis)


def _walk_with_logical(params, logical, fn, path=""):
    if _is_axes_leaf(logical):
        return fn(params, logical, path)
    return {k: _walk_with_logical(params[k], logical[k], fn, f"{path}/{k}")
            for k in params}


def _param_dim(path: str, axes) -> Optional[int]:
    """The dim a stage-3 param shards along (the full rules; a z3 leaf
    keeps its param whole)."""
    rules = TP_RULES + EP_RULES + PP_RULES + FSDP_RULES
    return fsdp_dim(z3_leaf_spec(path, spec_from_logical(axes, rules)))


def fsdp_gather_slice(layer_tree: Any, logical_tree: Any,
                      prefix: str = "/layers") -> Any:
    """The stage-3 fetch hook (JAX's ``fsdp_gather_slice`` with its
    ``fsdp_scatter_grads`` as the backward): one layer's shards gathered
    along each leaf's ``embed`` dim through ``_FsdpGather``, whose
    backward reduce-scatters the layer's gradient to the shards. The
    port's layer loop has already unbound the ``[L, ...]`` stack into
    per-layer views, so ``layer_tree`` is layer i's and
    ``logical_tree`` its per-layer axes (the ``"layers"`` dim dropped);
    ``prefix`` is the layer tree's path, for the z3 leaf patterns."""
    if not _gathers():
        return layer_tree
    return _walk_with_logical(
        layer_tree, logical_tree,
        lambda t, axes, path: gather_leaf(t, _param_dim(path, axes)),
        prefix)


class LayerFetch:
    """The stage-3 fetch hook the model's layer loop calls: ``layer``
    gathers one layer's shards, ``leaf`` one top-level leaf at its use
    (the embeddings, the final norm, the LM head)."""

    def __init__(self, logical_tree: Dict[str, Any]):
        self.logical = logical_tree
        # a (loss_fn, params) tree need not have a layer stack
        self.layer_axes = _map_axes(lambda _p, ax: ax[1:],
                                    logical_tree.get("layers", {}))

    def layer(self, layer_tree):
        return fsdp_gather_slice(layer_tree, self.layer_axes)

    def leaf(self, path: str, t: torch.Tensor) -> torch.Tensor:
        node = self.logical
        for k in path.strip("/").split("/"):
            node = node[k]
        return gather_leaf(t, _param_dim(path, node))

    def tree(self, params):
        """Every leaf of a params tree gathered (a ``(loss_fn, params)``
        model, whose layer loop has no hook)."""
        return _walk_with_logical(
            params, self.logical,
            lambda t, axes, path: gather_leaf(t, _param_dim(path, axes)))


_FETCH: Optional[LayerFetch] = None


@contextlib.contextmanager
def param_fetch(fetch: Optional[LayerFetch]):
    """Install ``fetch`` as the model's fetch hook for the duration of a
    forward. The layer loop captures it when the forward starts, so the
    remat recompute in the backward gathers again with it."""
    global _FETCH
    prev, _FETCH = _FETCH, fetch
    try:
        yield fetch
    finally:
        _FETCH = prev


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


__all__ = ["LOGICAL_AXES", "TP_RULES", "FSDP_RULES", "EP_RULES", "PP_RULES",
           "ACT_RULES", "spec_from_logical", "ShardingPlan",
           "make_sharding_plan", "set_z3_leaf_modules",
           "unset_z3_leaf_modules", "get_z3_leaf_modules", "z3_leaf_spec",
           "fsdp_dim", "shard_of", "gather_leaf", "fsdp_gather_slice",
           "LayerFetch", "param_fetch", "active_fetch", "fetched"]
