"""1-bit compressed-communication optimizers: OnebitAdam, ZeroOneAdam and
OnebitLamb (port of ``deepspeed_tpu/runtime/onebit.py``).

Reference: deepspeed/runtime/fp16/onebit/{adam.py:14, zoadam.py:14,
lamb.py:16} with the compressed all-reduce of runtime/comm/nccl.py
(sign-compress with a per-tensor scale and per-rank error feedback).

Algorithm (1-bit Adam, Tang et al.): a full-precision warmup runs Adam;
at ``freeze_step`` the variance freezes and from then on only the
momentum is exchanged, sign-compressed with error feedback. As in JAX
the exchange is the mean over the ``dp`` ranks of ``sign(x) * scale``
(no packed-bit wire); the gradient's other data axes (``fsdp``, ``ep``)
are reduced exactly first, as JAX's GSPMD does outside its manual-dp
region. Masters and moments are replicated (ZeRO stage <= 1); the error
feedback buffer is each rank's own.

In JAX only dp is manual: tp and sp stay under GSPMD, so the per-tensor
compression scale, the update's norm and Lamb's trust ratio read whole
leaves, and the loss is the whole sequence's. Here a tp rank holds its
slice of a tp-sharded leaf (``tp_sharded``): the scale's sum of |c| and
its element count, and the squares of the norms, are summed over tp (a
replicated leaf counted once). An sp rank's gradient is its sequence
block's part, summed over the sp ranks first (exactly, as GSPMD does).
The error feedback stays each dp rank's (of its tp slice).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Set

import torch

from deepspeed_tpu_torch import comm

logger = logging.getLogger(__name__)

ONEBIT_OPTIMIZERS = ("onebitadam", "zerooneadam", "onebitlamb")


def _f32(x: float, device) -> torch.Tensor:
    """An fp32 scalar filled on ``device`` (no host copy, so no sync)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _leaf(tree, path: str):
    node = tree
    for k in path.strip("/").split("/"):
        node = node[k]
    return node


def onebit_name(config) -> str:
    """The optimizer block's type, normalized ("" without a block)."""
    opt = config.optimizer
    return ((opt.type if opt else "") or "").lower().replace(
        "_", "").replace("-", "")


def parse_onebit_params(name: str, params: Dict) -> Dict:
    p = dict(params or {})
    out = {
        "kind": name,
        "lr": p.pop("lr", 1e-3),
        "betas": tuple(p.pop("betas", (0.9, 0.999))),
        "eps": p.pop("eps", 1e-8),
        "weight_decay": p.pop("weight_decay", 0.0),
        "freeze_step": p.pop("freeze_step", 100),
        # zerooneadam: variance refresh interval during compression
        "var_update_interval": p.pop("var_update_interval", 16),
        # onebitlamb: trust-ratio clamp
        "max_coeff": p.pop("max_coeff", 10.0),
        "min_coeff": p.pop("min_coeff", 0.01),
    }
    p.pop("cuda_aware", None)
    p.pop("comm_backend_name", None)
    return out


def validate_onebit_config(cfg) -> None:
    if cfg.zero_optimization.stage > 1:
        raise ValueError(
            f"1-bit optimizers require ZeRO stage <= 1 (reference "
            f"onebit/adam.py constraint), got stage="
            f"{cfg.zero_optimization.stage}")
    if cfg.zero_optimization.offload_device != "none":
        raise ValueError("1-bit optimizers are incompatible with "
                         "optimizer offload")


class OneBitState:
    """fp32 masters, momentum, variance (frozen after ``freeze_step``),
    this rank's error feedback (trees by ``/a/b`` path) and the step."""

    def __init__(self, master: Dict[str, torch.Tensor]):
        self.master = master
        self.m = {k: torch.zeros_like(v) for k, v in master.items()}
        self.v = {k: torch.zeros_like(v) for k, v in master.items()}
        self.error = {k: torch.zeros_like(v) for k, v in master.items()}
        self.step = 0

    def named_trees(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"master": self.master, "m": self.m, "v": self.v,
                "error": self.error}


class OneBitStep:
    """One engine's 1-bit update over its compute params (updated in
    place from the fp32 masters)."""

    def __init__(self, master: Dict[str, torch.Tensor], opt: Dict,
                 lr_schedule: Optional[Callable], grad_clip: float,
                 tp_sharded: Optional[Set[str]] = None):
        self.opt = opt
        # the paths whose masters are this rank's tp slices
        self.tp_sharded = frozenset(tp_sharded or ())
        self.kind = opt["kind"]
        self.b1, self.b2 = (float(b) for b in opt["betas"])
        self.eps, self.wd = float(opt["eps"]), float(opt["weight_decay"])
        self.freeze_step = int(opt["freeze_step"])
        self.base_lr = float(opt["lr"])
        self.lr_schedule = lr_schedule
        self.grad_clip = grad_clip
        self.lr_override: Optional[float] = None
        self.state = OneBitState(master)

    def lr_at(self, step: int) -> float:
        if self.lr_override is not None:
            return self.lr_override
        if self.lr_schedule is not None:
            return float(self.lr_schedule(step))
        return self.base_lr

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], params) -> torch.Tensor:
        """One update from this rank's gradients (by path, unreduced).
        Returns the norm of the update (JAX's ``grad_norm`` here)."""
        st, b1, b2 = self.state, self.b1, self.b2
        step = st.step
        warm = step < self.freeze_step
        m_new, g_avg = {}, {}
        for path, g in grads.items():
            g = g.float()
            if comm.axis_size("sp") > 1:  # the sequence blocks' parts
                g = comm.all_reduce(g, "sp")
            for ax in ("fsdp", "ep"):  # the exact, GSPMD-side reduce
                g = comm.all_reduce(g, ax, op="mean")
            if warm:
                ga = comm.all_reduce(g, "dp", op="mean")
                g_avg[path] = ga
                m_new[path] = b1 * st.m[path] + (1 - b1) * ga
            else:
                c_in = b1 * st.m[path] + (1 - b1) * g + st.error[path]
                if path in self.tp_sharded:  # the whole leaf's mean
                    total = comm.all_reduce(torch.sum(torch.abs(c_in)),
                                            "tp")
                    scale = total / float(c_in.numel() *
                                          comm.axis_size("tp"))
                else:
                    scale = torch.mean(torch.abs(c_in))
                comp = torch.sign(c_in) * scale
                m_new[path] = comm.all_reduce(comp, "dp", op="mean")
                st.error[path] = c_in - comp
        for path in grads:
            v = st.v[path]
            if warm:
                ga = g_avg[path]
                st.v[path] = b2 * v + (1 - b2) * ga * ga
            elif self.kind == "zerooneadam" and \
                    step % self.opt["var_update_interval"] == 0:
                mm = m_new[path]
                st.v[path] = b2 * v + (1 - b2) * mm * mm
        lr = self.lr_at(step)
        dev = next(iter(st.master.values())).device
        t = _f32(float(step) + 1.0, dev)
        bc1 = 1 - torch.pow(_f32(b1, dev), t)
        bc2 = 1 - torch.pow(_f32(b2, dev), t)
        updates = {}
        for path, master in st.master.items():
            u = (m_new[path] / bc1) / (torch.sqrt(st.v[path] / bc2)
                                       + self.eps)
            if self.wd:
                u = u + self.wd * master
            updates[path] = u
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        sq_tp = torch.zeros((), dtype=torch.float32, device=dev)
        for path, u in updates.items():
            (sq_tp if path in self.tp_sharded else sq).add_(torch.sum(u * u))
        if self.tp_sharded:
            sq = sq + comm.all_reduce(sq_tp, "tp")
        gnorm = torch.sqrt(sq)
        coef = _f32(1.0, dev)
        if self.grad_clip:
            coef = torch.clamp(self.grad_clip / (gnorm + 1e-6), max=1.0)
        lr_t = _f32(lr, dev)
        for path, master in st.master.items():
            u = updates[path]
            if self.kind == "onebitlamb":
                sums = torch.stack([torch.sum(master * master),
                                    torch.sum(u * u)])
                if path in self.tp_sharded:
                    sums = comm.all_reduce(sums, "tp")
                wn, un = torch.sqrt(sums[0]), torch.sqrt(sums[1])
                ratio = torch.where(un > 0, wn / (un + 1e-12),
                                    torch.ones_like(un))
                ratio = torch.clamp(ratio, self.opt["min_coeff"],
                                    self.opt["max_coeff"])
                master.sub_(lr_t * coef * ratio * u)
            else:
                master.sub_(lr_t * coef * u)
            st.m[path] = m_new[path]
            _leaf(params, path).copy_(master)
        st.step += 1
        return gnorm


__all__ = ["ONEBIT_OPTIMIZERS", "onebit_name", "parse_onebit_params",
           "validate_onebit_config", "OneBitState", "OneBitStep"]
