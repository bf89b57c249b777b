"""The engine's ZeRO bookkeeping across ranks: which dim of each leaf
shards, and the collectives of one step (JAX's engine lets GSPMD insert
them from ``runtime/sharding.py``'s shardings; here they are explicit).

A leaf's shard dim comes from the plan's spec for its role: the fp32
master and its moments (stage >= 1), the gradient (stage >= 2) and the
compute param (stage 3). Rank r holds block r of that dim over the
``fsdp`` axis. Per step:

  * a leaf whose gradient shards but whose param does not (stage 2, or a
    z3 leaf at stage 3) is reduce-scattered as its gradient is ready,
    each microbatch (the engine's post-accumulate hook);
  * a sharded param (stage 3) is all-gathered at each use and its
    gradient reduce-scattered in the backward (``sharding.gather_leaf``);
  * every other gradient is all-reduced over the data axes at the
    accumulation boundary;
  * the sums become means (divided by the data-parallel size), the
    global norm sums each rank's part and all-reduces one fp32 scalar,
    each rank steps its block of the masters, and the compute params
    are rebuilt: a sharded param copies its master block, a full one
    all-gathers the cast blocks.

At world size 1 on a one-rank group these collectives all run (and are
the identity), so each stage's numbers equal stage 0's bit for bit.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel.topology import BATCH_AXES
from deepspeed_tpu_torch.runtime.optimizer import leaves
from deepspeed_tpu_torch.runtime.sharding import fsdp_dim, shard_of

logger = logging.getLogger(__name__)

FSDP = "fsdp"


class ZeroPartition:
    """Per-leaf shard dims (by the params tree's ``/a/b`` paths) and the
    step's collectives for one engine on a process group."""

    def __init__(self, plan, mesh, logical_tree: Dict[str, Any],
                 stage: int):
        self.mesh = mesh
        self.stage = stage
        self.fsdp_n = mesh.axis_size(FSDP)
        self.fsdp_index = mesh.axis_index(FSDP)
        self.dp_n = mesh.axis_size(BATCH_AXES)

        def dims(tree):
            return {path: fsdp_dim(spec) for path, spec in leaves(tree)}

        self.param_dim = dims(plan.param_shardings(logical_tree))
        self.grad_dim = dims(plan.grad_shardings(logical_tree))
        self.opt_dim = dims(plan.opt_shardings(logical_tree))

    # -- layout ---------------------------------------------------------------
    def check(self, params) -> None:
        """Every sharded dim splits evenly over the fsdp ranks (JAX
        refuses an uneven sharding too)."""
        for path, p in leaves(params):
            d = self.opt_dim.get(path)
            if d is not None and p.shape[d] % self.fsdp_n:
                raise ValueError(
                    f"ZeRO stage {self.stage}: leaf {path} of shape "
                    f"{tuple(p.shape)} does not split over {self.fsdp_n} "
                    f"fsdp ranks along its embed dim {d}")

    def block(self, path: str, t: torch.Tensor, role: str = "opt"
              ) -> torch.Tensor:
        """This rank's block of a full leaf for ``role`` (opt, grad or
        param): a view, or ``t`` where the role does not shard."""
        return shard_of(t, getattr(self, f"{role}_dim").get(path))

    def scatter_dim(self, path: str) -> Optional[int]:
        """The dim to reduce-scatter a full gradient along as it is
        ready: its gradient shards and its param does not."""
        if self.param_dim.get(path) is None:
            return self.grad_dim.get(path)
        return None

    # -- the step -------------------------------------------------------------
    @torch.no_grad()
    def reduce(self, grads: Dict[str, torch.Tensor]) -> None:
        """The gradients' sums over the data ranks as means, in place:
        a full gradient all-reduced over the data axes, a shard (already
        summed over fsdp) over dp where dp has ranks."""
        for path, g in grads.items():
            if self.grad_dim.get(path) is None:
                comm.all_reduce(g, BATCH_AXES, out=g)
            elif self.mesh.shape["dp"] > 1:
                comm.all_reduce(g, "dp", out=g)
            if self.dp_n > 1:
                g.div_(self.dp_n)

    def opt_grad(self, path: str, g: torch.Tensor) -> torch.Tensor:
        """The part of a reduced gradient this rank's master block takes."""
        if self.grad_dim.get(path) is None:
            return self.block(path, g, "opt")
        return g

    def owned(self, path: str) -> bool:
        """Whether this rank counts ``path`` in the global norm: its
        block of a sharded leaf, or a replicated leaf on fsdp rank 0."""
        return self.opt_dim.get(path) is not None and self.fsdp_n > 1 \
            or self.fsdp_index == 0

    def norm_reduce(self, sq: torch.Tensor) -> torch.Tensor:
        """The ranks' sums of squares summed (one fp32 scalar)."""
        return comm.all_reduce(sq, FSDP, out=sq)

    @torch.no_grad()
    def publish(self, path: str, master: torch.Tensor,
                param: torch.Tensor) -> None:
        """The compute param from its updated master block: copied where
        the param is the same block, all-gathered (cast first) where the
        param is full."""
        d = self.opt_dim.get(path)
        if self.param_dim.get(path) is not None or d is None:
            param.copy_(master)
            return
        param.copy_(comm.all_gather(master.to(param.dtype), FSDP,
                                    gather_dim=d))

    def full(self, path: str, t: torch.Tensor, role: str = "opt"
             ) -> torch.Tensor:
        """The full leaf from each rank's ``role`` block (collective:
        every rank calls it)."""
        d = getattr(self, f"{role}_dim").get(path)
        if d is None:
            return t
        return comm.all_gather(t.contiguous(), FSDP, gather_dim=d)


__all__ = ["ZeroPartition"]
