"""Optimizer construction and mixed-precision master weights (port of
``deepspeed_tpu/runtime/optimizer.py``).

``get_base_optimizer`` maps the config's optimizer name (case and
``_`` ignored, as in JAX) to an :class:`Optimizer` with the numerics of
the optax transform JAX builds: ``adam`` / ``adamw`` (:class:`Adam`),
``sgd`` / ``momentum``, ``lion``, ``adagrad``, ``lamb``, ``adafactor``
and their aliases, and ``muon`` (``runtime/muon.py``), with JAX's
argument mapping (the config's betas and eps, weight decay 0.01 for
adamw and 0.0 for the rest) and optax's defaults beyond it. Params it
has no use for warn and are ignored, as in JAX. The 1-bit optimizers
raise, naming their ROADMAP item.

``MixedPrecisionState`` holds fp32 masters and the optimizer's state
trees; ``apply_mixed_precision_update`` is one optimizer step with the
JAX function's order: unscale by the loss scale, the global grad norm,
the clip ``min(1, clip / (gnorm + 1e-6))``, the optimizer's update on
each leaf (optax applies no mask here), and the compute params recast
from the masters. Unlike the JAX function it updates the masters, the
state and the compute params IN PLACE and casts the gradients to fp32
one leaf at a time: at 8-layer Llama-3-8B the full fp32 gradient tree
alone would be 11 GB.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch.utils.annotate import trace_range

logger = logging.getLogger(__name__)

ADAM_ALIASES = {"adam", "fusedadam", "cpuadam"}
ADAMW_ALIASES = {"adamw", "fusedadamw"}
LION_ALIASES = {"lion", "fusedlion", "cpulion"}
ADAGRAD_ALIASES = {"adagrad", "cpuadagrad"}
LAMB_ALIASES = {"lamb", "fusedlamb"}
# optimizers of the JAX package that wait for a later item (the 1-bit
# family compresses the gradient exchange across ranks)
UNPORTED_OPTIMIZERS = {"onebitadam", "onebitlamb", "zerooneadam"}
NORM_CHUNK = 1 << 26

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


def set_leaf(tree: Tree, path: str, value) -> None:
    """Put ``value`` at ``path`` (``/a/b``) in ``tree``, making dicts."""
    keys = path.strip("/").split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclass
class Optimizer:
    """One optax transform as per-leaf steps on fp32 masters. ``lr`` is a
    float or a ``step -> lr`` schedule evaluated at the update count.
    ``init_leaf`` gives a leaf's state tensors by name (a leaf may have
    none, or other names than its neighbours); ``update_leaf`` applies
    one step to a master in place, given its fp32 gradient, its state,
    the update number ``t`` (1 at the first) and the step's lr."""

    lr: Union[float, Callable[[int], float]]

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init_leaf(self, path: str, master: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        return {}

    def update_leaf(self, path: str, master: torch.Tensor, g: torch.Tensor,
                    st: Dict[str, torch.Tensor], t: int, lr: float) -> None:
        raise NotImplementedError


@dataclass
class Adam(Optimizer):
    """optax ``adam`` / ``adamw``: scale_by_adam (eps outside the sqrt),
    weight decay added to the grads first (adam, L2) or to the update
    after (adamw, decoupled), then scale by -lr."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    decoupled: bool = True

    def init_leaf(self, path, master):
        return {"mu": torch.zeros_like(master),
                "nu": torch.zeros_like(master)}

    def update_leaf(self, path, master, g, st, t, lr):
        dev = master.device
        # optax computes 1 - b**t in fp32
        bc1 = 1.0 - _f32(self.b1, dev) ** t
        bc2 = 1.0 - _f32(self.b2, dev) ** t
        if not self.decoupled and self.weight_decay:
            g = g + self.weight_decay * master
        mu, nu = st["mu"], st["nu"]
        mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        denom = (nu / bc2).sqrt_().add_(self.eps)
        update = (mu / bc1).div_(denom)
        if self.decoupled and self.weight_decay:
            update.add_(master, alpha=self.weight_decay)
        master.add_(update, alpha=-lr)


@dataclass
class SGD(Optimizer):
    """optax ``sgd``: with ``momentum`` the trace ``g + momentum * t``
    (not Nesterov), then scale by -lr. JAX passes momentum 0.0 for
    ``sgd``, whose trace is the gradient itself, so it keeps no state."""

    momentum: float = 0.0

    def init_leaf(self, path, master):
        return {"mu": torch.zeros_like(master)} if self.momentum else {}

    def update_leaf(self, path, master, g, st, t, lr):
        if self.momentum:
            g = st["mu"].mul_(self.momentum).add_(g)
        master.add_(g * -lr)


@dataclass
class Lion(Optimizer):
    """optax ``lion``: sign((1 - b1) g + b1 m) plus weight decay times
    the master, scaled by -lr; then m = (1 - b2) g + b2 m."""

    b1: float = 0.9
    b2: float = 0.99
    weight_decay: float = 0.0

    def init_leaf(self, path, master):
        return {"mu": torch.zeros_like(master)}

    def update_leaf(self, path, master, g, st, t, lr):
        mu = st["mu"]
        upd = torch.sign(g * (1.0 - self.b1) + mu * self.b1)
        mu.copy_(g * (1.0 - self.b2) + mu * self.b2)
        if self.weight_decay:
            upd = upd + master * self.weight_decay
        master.add_(upd.mul_(-lr))


@dataclass
class Adagrad(Optimizer):
    """optax ``adagrad``: the sum of squares from optax's initial 0.1,
    the gradient times rsqrt(sum + eps) (0 where the sum is 0), scaled by
    -lr."""

    eps: float = 1e-7
    INITIAL_ACCUMULATOR = 0.1

    def init_leaf(self, path, master):
        return {"nu": torch.full_like(master, self.INITIAL_ACCUMULATOR)}

    def update_leaf(self, path, master, g, st, t, lr):
        nu = st["nu"]
        nu.copy_(g * g + nu)
        inv = torch.where(nu > 0, torch.rsqrt(nu + self.eps),
                          torch.zeros_like(nu))
        master.add_((inv * g).mul_(-lr))


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


@dataclass
class Lamb(Optimizer):
    """optax ``lamb``: scale_by_adam, weight decay, then each leaf's
    update scaled by the trust ratio ||master|| / ||update|| (1 where
    either norm is 0), scaled by -lr."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.0

    def init_leaf(self, path, master):
        return {"mu": torch.zeros_like(master),
                "nu": torch.zeros_like(master)}

    def update_leaf(self, path, master, g, st, t, lr):
        dev = master.device
        mu, nu = st["mu"], st["nu"]
        mu.copy_(g * (1.0 - self.b1) + mu * self.b1)
        nu.copy_(g * g * (1.0 - self.b2) + nu * self.b2)
        mu_hat = mu / (1.0 - _f32(self.b1, dev) ** t)
        nu_hat = nu / (1.0 - _f32(self.b2, dev) ** t)
        upd = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.weight_decay:
            upd = upd + master * self.weight_decay
        p_norm, u_norm = _safe_norm(master), _safe_norm(upd)
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        master.add_((upd * ratio).mul_(-lr))


# optax adafactor's min_dim_size_to_factor (JAX passes only the lr)
MIN_DIM_TO_FACTOR = 128


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (second largest dim, largest dim) of a
    leaf of 2 or more dims whose second largest is at least
    ``MIN_DIM_TO_FACTOR``, else None (numpy's argsort, as optax)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


@dataclass
class Adafactor(Optimizer):
    """optax ``adafactor`` at its defaults (JAX passes only the lr):
    factored second moments (a row and a column accumulator on leaves
    whose two largest dims are at least ``MIN_DIM_TO_FACTOR``, a full one
    elsewhere) with the decay 1 - t^-0.8, the update clipped to block RMS
    1, scaled by lr and by the master's RMS (at least 1e-3), then
    negated."""

    DECAY_RATE = 0.8
    CLIPPING_THRESHOLD = 1.0
    EPS = 1e-30

    def init_leaf(self, path, master):
        dims = factored_dims(tuple(master.shape))
        if dims is None:
            return {"v": torch.zeros_like(master)}
        d1, d0 = dims
        shape = list(master.shape)
        row = [n for i, n in enumerate(shape) if i != d0]
        col = [n for i, n in enumerate(shape) if i != d1]
        return {"v_row": master.new_zeros(row), "v_col": master.new_zeros(col)}

    def update_leaf(self, path, master, g, st, t, lr):
        dev = master.device
        # optax's _decay_rate_pow at the pre-update count t - 1, in fp32
        decay = 1.0 - _f32(float(t), dev) ** (-self.DECAY_RATE)
        keep = 1.0 - decay
        grad_sqr = g * g + self.EPS
        dims = factored_dims(tuple(master.shape))
        if dims is not None:
            d1, d0 = dims
            v_row = decay * st["v_row"] + keep * grad_sqr.mean(dim=d0)
            v_col = decay * st["v_col"] + keep * grad_sqr.mean(dim=d1)
            st["v_row"].copy_(v_row)
            st["v_col"].copy_(v_col)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        else:
            v = decay * st["v"] + keep * grad_sqr
            st["v"].copy_(v)
            u = g * v ** -0.5
        rms = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms / self.CLIPPING_THRESHOLD, min=1.0)
        u = u * lr
        rms = torch.sqrt(torch.mean(master * master))
        u = u * torch.clamp(rms, min=1e-3)  # safe_root_mean_squares
        master.add_(u.neg_())


def get_base_optimizer(opt_config, lr_schedule: Optional[Callable] = None
                       ) -> Tuple[Optimizer, float]:
    """Name -> optimizer, with the JAX package's argument mapping (the
    config's betas and eps, weight decay 0.01 for adamw and 0.0 for the
    rest) and optax's own defaults beyond it. Returns (optimizer,
    base_lr)."""
    if opt_config is None:
        from deepspeed_tpu_torch.config.config import OptimizerConfig

        opt_config = OptimizerConfig(type="adamw", params={})
    name = opt_config.type.lower().replace("_", "")
    p = dict(opt_config.params or {})
    lr = p.pop("lr", 1e-3)
    lr_arg = lr_schedule if lr_schedule is not None else lr
    betas = p.pop("betas", (0.9, 0.999))
    b1, b2 = float(betas[0]), float(betas[1])
    eps = float(p.pop("eps", 1e-8))
    weight_decay = float(p.pop("weight_decay",
                               0.01 if name in ADAMW_ALIASES else 0.0))
    p.pop("torch_adam", None)
    p.pop("adam_w_mode", None)
    muon_extra = {k: p.pop(k) for k in
                  ("ns_steps", "nesterov", "adam_b1", "adam_b2")
                  if k in p} if name == "muon" else {}
    if p:  # DeepSpeed-style keys optax has no use for (bias_correction, ...)
        logger.warning(f"optimizer '{opt_config.type}': ignoring params "
                       f"{sorted(p)}")
    if name in UNPORTED_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer '{opt_config.type}' is not ported to "
            "deepspeed_tpu_torch yet: ROADMAP queue A item 10 (the 1-bit "
            "optimizers compress the gradient exchange across ranks)")
    if name in ADAMW_ALIASES | ADAM_ALIASES:
        tx = Adam(lr=lr_arg, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                  decoupled=name in ADAMW_ALIASES)
    elif name in ("sgd", "momentum"):
        tx = SGD(lr=lr_arg, momentum=b1 if name == "momentum" else 0.0)
    elif name in LION_ALIASES:
        tx = Lion(lr=lr_arg, b1=b1, b2=b2, weight_decay=weight_decay)
    elif name in ADAGRAD_ALIASES:
        tx = Adagrad(lr=lr_arg, eps=eps)
    elif name in LAMB_ALIASES:
        tx = Lamb(lr=lr_arg, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    elif name == "adafactor":
        tx = Adafactor(lr=lr_arg)
    elif name == "muon":
        from deepspeed_tpu_torch.runtime.muon import Muon

        tx = Muon(lr=lr_arg, beta=b1, weight_decay=weight_decay,
                  ns_steps=int(muon_extra.get("ns_steps", 5)),
                  nesterov=bool(muon_extra.get("nesterov", True)),
                  adam_b1=float(muon_extra.get("adam_b1", 0.9)),
                  adam_b2=float(muon_extra.get("adam_b2", 0.999)),
                  adam_eps=eps)
    else:
        raise ValueError(f"unknown optimizer type '{opt_config.type}'")
    return tx, lr


@dataclass
class MixedPrecisionState:
    """fp32 masters, the optimizer's state trees (``mu`` and ``nu`` for
    the Adam family; ``extra`` holds other names, such as Adafactor's
    ``v_row``, ``v_col`` and ``v``; a tree may cover only some leaves),
    and the count of updates applied (the optax state's ``count``)."""

    master: Tree
    mu: Tree = field(default_factory=dict)
    nu: Tree = field(default_factory=dict)
    count: int = 0
    extra: Dict[str, Tree] = field(default_factory=dict)

    def named_trees(self) -> Dict[str, Tree]:
        """Every non-empty state tree by name."""
        out = {"mu": self.mu, "nu": self.nu, **self.extra}
        return {k: v for k, v in out.items() if v}

    def leaf_state(self, path: str) -> Dict[str, torch.Tensor]:
        out = {}
        for name, tree in self.named_trees().items():
            node = tree
            for k in path.strip("/").split("/"):
                node = node.get(k) if isinstance(node, dict) else None
            if node is not None:
                out[name] = node
        return out


def _init_state(master: Tree, tx: Optimizer) -> MixedPrecisionState:
    state = MixedPrecisionState(master=master)
    for path, m in leaves(master):
        for name, t in tx.init_leaf(path, m).items():
            if name in ("mu", "nu"):
                set_leaf(getattr(state, name), path, t)
            else:
                set_leaf(state.extra.setdefault(name, {}), path, t)
    return state


def init_mixed_precision(params: Tree, tx: Optimizer) -> MixedPrecisionState:
    """fp32 masters from ``params`` (a leaf already fp32 is used as it
    is, not copied: the caller's tensors then follow the updates) and
    the optimizer's initial state."""
    return _init_state(tree_map(lambda p: p.detach().float(), params), tx)


@torch.no_grad()
def reset_optimizer_state(state: MixedPrecisionState, tx: Optimizer) -> None:
    """The optimizer's initial state and count 0, in place, for the
    current masters (a checkpoint loaded without its optimizer state)."""
    for path, master in leaves(state.master):
        st = state.leaf_state(path)
        for name, t in tx.init_leaf(path, master).items():
            st[name].copy_(t)  # one leaf's fresh state at a time
    state.count = 0


@torch.no_grad()
def global_norm(grads: Tree, grad_scale: Optional[float] = None,
                include: Optional[Callable[[str], bool]] = None,
                reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
                = None) -> torch.Tensor:
    """fp32 global L2 norm of the (unscaled) grads, leaf by leaf, in
    chunks of ``NORM_CHUNK`` elements (an fp32 copy of one chunk at a
    time). Across ranks (ZeRO), ``include`` picks the leaves this rank
    counts and ``reduce`` sums the ranks' fp32 sums of squares."""
    total = None
    for path, g in leaves(grads):
        if include is not None and not include(path):
            continue
        for part in g.detach().reshape(-1).split(NORM_CHUNK):
            g32 = part.float()
            if grad_scale is not None:
                g32 = g32 / grad_scale
            sq = torch.sum(g32 * g32)
            total = sq if total is None else total + sq
    if total is None:
        dev = next((g.device for _, g in leaves(grads)), None)
        total = torch.zeros((), dtype=torch.float32, device=dev)
    if reduce is not None:
        total = reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def apply_mixed_precision_update(state: MixedPrecisionState, grads: Tree,
                                 tx: Optimizer, params: Optional[Tree] = None,
                                 grad_clip: float = 0.0,
                                 grad_scale: Optional[float] = None,
                                 skip: bool = False,
                                 gnorm: Optional[torch.Tensor] = None,
                                 publish: Optional[Callable] = None
                                 ) -> torch.Tensor:
    """One optimizer step, in place. ``grads`` is a tree like the masters
    in any float type; ``params`` (optional) are the compute-dtype
    params, recast from the updated masters (by ``publish(path, master,
    param)`` where given: ZeRO's gather). ``grad_scale`` divides the
    grads (loss-scale unscaling); ``skip`` (an overflow step) leaves
    everything unchanged; ``gnorm`` is the global norm when the caller
    computed it (across ranks). Returns the global grad norm (fp32,
    0-dim). The step runs in the "optimizer" profiler range."""
    with trace_range("optimizer"):
        return _mixed_precision_update(state, grads, tx, params, grad_clip,
                                       grad_scale, skip, gnorm, publish)


def _mixed_precision_update(state, grads, tx, params, grad_clip, grad_scale,
                            skip, gnorm, publish):
    if gnorm is None:
        gnorm = global_norm(grads, grad_scale)
    if skip:
        return gnorm
    clip = None
    if grad_clip and grad_clip > 0:
        clip = torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0)
    t = state.count + 1
    lr = tx.lr_at(state.count)
    flat_p = dict(leaves(params)) if params is not None else {}
    flat_g = dict(leaves(grads))
    for path, master in leaves(state.master):
        g = flat_g[path].float()
        if grad_scale is not None:
            g = g / grad_scale
        if clip is not None:
            g = g * clip
        tx.update_leaf(path, master, g, state.leaf_state(path), t, lr)
        if path in flat_p:
            if publish is not None:
                publish(path, master, flat_p[path])
            else:
                flat_p[path].copy_(master)
    state.count = t
    return gnorm


@torch.no_grad()
def apply_client_update(state: MixedPrecisionState, grads: Tree,
                        opt: "torch.optim.Optimizer",
                        params: Optional[Tree] = None,
                        grad_clip: float = 0.0,
                        grad_scale: Optional[float] = None,
                        skip: bool = False,
                        gnorm: Optional[torch.Tensor] = None,
                        publish: Optional[Callable] = None) -> torch.Tensor:
    """``apply_mixed_precision_update`` with a client
    ``torch.optim.Optimizer`` over the masters in ``tx``'s place: each
    master's fp32 gradient (unscaled and clipped by the engine, as there)
    goes into its ``.grad``, the optimizer steps once, and the compute
    params are recast from the masters. Returns the global grad norm.
    The step runs in the "optimizer" profiler range."""
    with trace_range("optimizer"):
        return _client_update(state, grads, opt, params, grad_clip,
                              grad_scale, skip, gnorm, publish)


def _client_update(state, grads, opt, params, grad_clip, grad_scale, skip,
                   gnorm, publish):
    if gnorm is None:
        gnorm = global_norm(grads, grad_scale)
    if skip:
        return gnorm
    clip = None
    if grad_clip and grad_clip > 0:
        clip = torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0)
    flat_g = dict(leaves(grads))
    masters = list(leaves(state.master))
    for path, master in masters:
        g = flat_g[path].float()
        if grad_scale is not None:
            g = g / grad_scale
        if clip is not None:
            g = g * clip
        master.grad = g
    opt.step()
    flat_p = dict(leaves(params)) if params is not None else {}
    for path, master in masters:
        master.grad = None
        if path in flat_p:
            if publish is not None:
                publish(path, master, flat_p[path])
            else:
                flat_p[path].copy_(master)
    state.count += 1
    return gnorm
