"""Optimizer construction and mixed-precision master weights (port of
``deepspeed_tpu/runtime/optimizer.py``).

``get_base_optimizer`` maps the config's optimizer name (case and
``_`` ignored, as in JAX) to an :class:`Adam` with optax's numerics:
``adam`` / ``adamw`` and their aliases. Params it has no use for warn
and are ignored, as in JAX. Other optimizers raise, naming the ROADMAP
item.

``MixedPrecisionState`` holds fp32 masters and fp32 Adam moments;
``apply_mixed_precision_update`` is one optimizer step with the JAX
function's order: unscale by the loss scale, the global grad norm, the
clip ``min(1, clip / (gnorm + 1e-6))``, the Adam update (bias-corrected
``m_hat / (sqrt(v_hat) + eps)``, decoupled weight decay on every leaf —
optax applies no mask here), and the compute params recast from the
masters. Unlike the JAX function it updates the masters, the moments
and the compute params IN PLACE and casts the gradients to fp32 one
leaf at a time: at 8-layer Llama-3-8B the full fp32 gradient tree alone
would be 11 GB.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch

logger = logging.getLogger(__name__)

ADAM_ALIASES = {"adam", "fusedadam", "cpuadam"}
ADAMW_ALIASES = {"adamw", "fusedadamw"}
# optimizers of the JAX package that wait for a later item
UNPORTED_OPTIMIZERS = {
    "sgd", "momentum", "lion", "fusedlion", "cpulion", "adagrad",
    "cpuadagrad", "lamb", "fusedlamb", "adafactor", "muon", "onebitadam",
    "onebitlamb", "zerooneadam",
}

Tree = Dict[str, Any]


def leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in sorted key order, the order JAX flattens a dict
    tree in (global norms sum the leaves in this order)."""
    for key in sorted(tree):
        node, path = tree[key], f"{prefix}/{key}"
        if isinstance(node, dict):
            yield from leaves(node, path)
        else:
            yield path, node


def tree_map(fn: Callable, tree: Tree) -> Tree:
    return {k: (tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


@dataclass
class Adam:
    """optax ``adam`` / ``adamw``: scale_by_adam (eps outside the sqrt),
    weight decay added to the grads first (adam, L2) or to the update
    after (adamw, decoupled), then scale by -lr. ``lr`` is a float or a
    ``step -> lr`` schedule evaluated at the update count."""

    lr: Union[float, Callable[[int], float]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    decoupled: bool = True

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)


def get_base_optimizer(opt_config, lr_schedule: Optional[Callable] = None
                       ) -> Tuple[Adam, float]:
    """Name -> optimizer. Returns (optimizer, base_lr)."""
    if opt_config is None:
        from deepspeed_tpu_torch.config.config import OptimizerConfig

        opt_config = OptimizerConfig(type="adamw", params={})
    name = opt_config.type.lower().replace("_", "")
    p = dict(opt_config.params or {})
    lr = p.pop("lr", 1e-3)
    betas = p.pop("betas", (0.9, 0.999))
    eps = p.pop("eps", 1e-8)
    weight_decay = p.pop("weight_decay",
                         0.01 if name in ADAMW_ALIASES else 0.0)
    p.pop("torch_adam", None)
    p.pop("adam_w_mode", None)
    if p:  # DeepSpeed-style keys optax has no use for (bias_correction, ...)
        logger.warning(f"optimizer '{opt_config.type}': ignoring params "
                       f"{sorted(p)}")
    if name in UNPORTED_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer '{opt_config.type}' is not ported to "
            "deepspeed_tpu_torch yet: ROADMAP queue A item 4 (other "
            "optimizers: lion, lamb, adafactor, muon, 1-bit)")
    if name not in ADAM_ALIASES | ADAMW_ALIASES:
        raise ValueError(f"unknown optimizer type '{opt_config.type}'")
    tx = Adam(lr=lr_schedule if lr_schedule is not None else lr,
              b1=float(betas[0]), b2=float(betas[1]), eps=float(eps),
              weight_decay=float(weight_decay),
              decoupled=name in ADAMW_ALIASES)
    return tx, lr


@dataclass
class MixedPrecisionState:
    """fp32 masters and Adam moments (same tree as the params), and the
    count of updates applied (the optax state's ``count``)."""

    master: Tree
    mu: Tree
    nu: Tree
    count: int = 0


def init_mixed_precision(params: Tree, tx: Adam) -> MixedPrecisionState:
    """fp32 masters from ``params`` (a leaf already fp32 is used as it
    is, not copied: the caller's tensors then follow the updates) and
    zero moments."""
    del tx
    master = tree_map(lambda p: p.detach().float(), params)
    return MixedPrecisionState(master=master,
                               mu=tree_map(torch.zeros_like, master),
                               nu=tree_map(torch.zeros_like, master))


@torch.no_grad()
def global_norm(grads: Tree, grad_scale: Optional[float] = None
                ) -> torch.Tensor:
    """fp32 global L2 norm of the (unscaled) grads, leaf by leaf."""
    total = None
    for _, g in leaves(grads):
        g32 = g.float()
        if grad_scale is not None:
            g32 = g32 / grad_scale
        sq = torch.sum(g32 * g32)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_mixed_precision_update(state: MixedPrecisionState, grads: Tree,
                                 tx: Adam, params: Optional[Tree] = None,
                                 grad_clip: float = 0.0,
                                 grad_scale: Optional[float] = None,
                                 skip: bool = False) -> torch.Tensor:
    """One optimizer step, in place. ``grads`` is a tree like the masters
    in any float type; ``params`` (optional) are the compute-dtype
    params, recast from the updated masters. ``grad_scale`` divides the
    grads (loss-scale unscaling); ``skip`` (an overflow step) leaves
    everything unchanged. Returns the global grad norm (fp32, 0-dim)."""
    gnorm = global_norm(grads, grad_scale)
    if skip:
        return gnorm
    clip = None
    if grad_clip and grad_clip > 0:
        clip = torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0)
    t = state.count + 1
    lr = tx.lr_at(state.count)
    dev = gnorm.device
    # optax computes 1 - b**t in fp32
    bc1 = 1.0 - torch.tensor(tx.b1, dtype=torch.float32, device=dev) ** t
    bc2 = 1.0 - torch.tensor(tx.b2, dtype=torch.float32, device=dev) ** t
    flat_p = dict(leaves(params)) if params is not None else {}
    flat_g = dict(leaves(grads))
    flat_m, flat_v = dict(leaves(state.mu)), dict(leaves(state.nu))
    for path, master in leaves(state.master):
        g = flat_g[path].float()
        if grad_scale is not None:
            g = g / grad_scale
        if clip is not None:
            g = g * clip
        if not tx.decoupled and tx.weight_decay:
            g = g + tx.weight_decay * master
        mu, nu = flat_m[path], flat_v[path]
        mu.mul_(tx.b1).add_(g, alpha=1.0 - tx.b1)
        nu.mul_(tx.b2).addcmul_(g, g, value=1.0 - tx.b2)
        denom = (nu / bc2).sqrt_().add_(tx.eps)
        update = (mu / bc1).div_(denom)
        if tx.decoupled and tx.weight_decay:
            update.add_(master, alpha=tx.weight_decay)
        master.add_(update, alpha=-lr)
        if path in flat_p:
            flat_p[path].copy_(master)
    state.count = t
    return gnorm
