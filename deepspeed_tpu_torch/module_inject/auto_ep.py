"""AutoEP: expert parallelism for HF-style MoE parameter trees (port of
``deepspeed_tpu/module_inject/auto_ep.py``).

Reference: ``deepspeed/module_inject/auto_ep.py:273`` detects a stock HF
MoE model's router and experts, converts a ModuleList of per-expert
weights to the grouped (stacked) layout and partitions it over the
expert-parallel group. Two mechanical parts, as in JAX: ``
stack_expert_modulelist`` restacks ``experts.<i>.<leaf>`` entries into
fused ``[E, ...]`` tensors (the grouped-GEMM layout), and ``AutoEP``
classifies paths into specs (expert stacks shard E over ``ep``, their
matrix dims follow AutoTP's policy; routers replicate). ``ep_model_init``
places this rank's E/ep slice of each expert stack (one process is one
rank; JAX puts each device's shard).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.module_inject.auto_tp import (SEP, AutoTP,
                                                       _divisible, _shape,
                                                       _walk)

logger = logging.getLogger(__name__)

# path fragments marking the expert container and the router
_EXPERT_PATTERNS = [r"experts"]
_ROUTER_PATTERNS = [r"\bgate\b", r"router", r"gate_proj\b.*router"]


class AutoEPPreset:
    """Architecture preset: where the experts and the router live."""

    def __init__(self, expert_patterns=None, router_patterns=None):
        self.expert_patterns = list(expert_patterns or _EXPERT_PATTERNS)
        self.router_patterns = list(router_patterns or _ROUTER_PATTERNS)


PRESETS: Dict[str, AutoEPPreset] = {
    "default": AutoEPPreset(),
    "mixtral": AutoEPPreset([r"block_sparse_moe\.experts", r"experts"],
                            [r"block_sparse_moe\.gate\b"]),
    "qwen2_moe": AutoEPPreset([r"mlp\.experts", r"experts"],
                              [r"mlp\.gate\b", r"shared_expert_gate"]),
}


def _is_int_keyed(d: dict) -> bool:
    return len(d) > 0 and all(isinstance(k, str) and k.isdigit() for k in d)


def _stack(xs):
    if all(isinstance(x, torch.Tensor) for x in xs):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return _stack(trees)


def stack_expert_modulelist(params, preset: Optional[AutoEPPreset] = None):
    """Restack ``experts.{0..E-1}.<leaf>`` dicts into fused ``[E, ...]``
    tensors (numpy or torch, as given); fused trees pass through.
    Returns a new tree."""
    preset = preset or PRESETS["default"]

    def walk(tree, prefix=""):
        if not isinstance(tree, dict):
            return tree
        if (_is_int_keyed(tree)
                and any(re.search(p, prefix) for p in preset.expert_patterns)
                and all(isinstance(v, dict) for v in tree.values())):
            order = sorted(tree, key=int)
            return _stack_trees([walk(tree[k], f"{prefix}{SEP}{k}")
                                 for k in order])
        return {k: walk(v, f"{prefix}{SEP}{k}" if prefix else str(k))
                for k, v in tree.items()}

    return walk(params)


class AutoEP:
    """Classify the paths of a (restacked) MoE tree into ep x tp specs."""

    def __init__(self, ep_axis: str = "ep", tp_axis: str = "tp",
                 preset: str = "default", tp_policy: Optional[str] = None):
        self.ep_axis = ep_axis
        self.preset = PRESETS.get(preset.lower())
        if self.preset is None:
            logger.warning(f"AutoEP: no preset '{preset}', using default")
            self.preset = PRESETS["default"]
        self.autotp = AutoTP(tp_axis=tp_axis, policy=tp_policy)

    def _is_expert(self, path: str) -> bool:
        return any(re.search(p, path) for p in self.preset.expert_patterns)

    def _is_router(self, path: str) -> bool:
        return any(re.search(p, path) for p in self.preset.router_patterns)

    def spec_for(self, path: str, shape: Tuple[int, ...]):
        if self._is_router(path):
            return (None,) * len(shape)  # the router replicates
        if self._is_expert(path) and len(shape) >= 2:
            # the leading E dim over ep; the matrix dims by AutoTP
            return (self.ep_axis, *self.autotp.spec_for(path, shape[1:]))
        return self.autotp.spec_for(path, shape)

    def infer_specs(self, params) -> Any:
        return _walk(params, lambda path, leaf: self.spec_for(
            path, _shape(leaf)))


def ep_model_init(params, mesh=None, ep_size: int = 0,
                  preset: str = "default", dtype=None):
    """Restack an HF MoE tree and keep this rank's share: each expert
    stack's E/ep experts of this rank's ep index (tp dims stay whole:
    ``auto_tp.tp_model_init`` cuts those). Returns (local tree of torch
    tensors, specs). An expert count that does not divide ep replicates, with a
    warning, as in JAX."""
    from deepspeed_tpu_torch.parallel import topology as topo

    if mesh is None:
        if ep_size <= 0:
            raise ValueError("ep_model_init needs mesh or ep_size")
        mesh = topo.build_mesh(topo.TopologyConfig(ep=ep_size, dp=-1))
    preset = preset.lower()
    if preset not in PRESETS:
        logger.warning(f"AutoEP: no preset '{preset}', using default")
        preset = "default"
    stacked = stack_expert_modulelist(params, PRESETS[preset])
    specs = AutoEP(preset=preset).infer_specs(stacked)
    ep, index = mesh.shape.get("ep", 1), mesh.axis_index("ep")

    def place(path, x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        spec = _lookup(specs, path)
        if dtype is not None:
            t = t.to(dtype)
        if not _divisible(tuple(t.shape), spec, mesh):
            logger.warning(f"AutoEP: shape {tuple(t.shape)} not divisible "
                           f"for spec {spec}; replicating")
            return t
        if spec and spec[0] == "ep" and ep > 1:
            n = t.shape[0] // ep
            return t[index * n:(index + 1) * n].clone()
        return t

    local = _walk(stacked, place)
    logger.info(f"AutoEP over ep={ep} (preset={preset})")
    return local, specs


def _lookup(tree, path: str):
    node = tree
    for k in path.split(SEP):
        node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
    return node


__all__ = ["AutoEPPreset", "PRESETS", "AutoEP", "stack_expert_modulelist",
           "ep_model_init"]
