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

With expert parallelism (ep > 1) each rank holds the E/ep experts of its
ep index in every role (the expert dim of an expert leaf, from the
plan's ``EP_RULES``, is never gathered): an expert gradient, already
summed over the ep ranks by the dispatch's all-to-all backward, reduces
over the dp x fsdp ranks that share the expert; a dense gradient over
every token rank, dp x fsdp x ep; both become means over all of them.

With tensor parallelism (tp > 1) every role of a leaf that ``TP_RULES``
shards (heads, kv heads, the MLP width, the vocab) is this rank's tp
slice first: the fsdp block is a block of that slice, and the data-axis
reductions run within the ranks of one tp index (the groups of
``BATCH_AXES`` never span tp). The global norm sums a tp-sharded leaf's
squares over tp as well and counts a replicated leaf once (tp index 0).

With sequence parallelism (sp > 1) every sp rank holds the same
params and computes its part of each gradient (its sequence block's):
the data-axis reductions sum over the sp ranks too (the groups of
``BATCH_AXES`` + sp), without dividing, and the global norm counts a
leaf on sp rank 0. With pipeline parallelism (pp > 1) each rank holds
its stage's L / PP layers of every stacked layer leaf (dim 0 over pp,
``PP_RULES``; ZeRO's fsdp blocks are blocks of that slice); a stage's
layer gradients are its own, while a leaf every stage holds (the
embedding, the final norm, the LM head) sums over pp, where only the
stages that use it contributed (the engine back-propagates the last
stage's loss: the head's gradient comes from the last stage, the
embedding's from the first). The global norm sums the stages' squares
and counts a replicated leaf on pp rank 0.

Under ZeRO++'s qgZ (stages 2-3, fsdp > 1) a gradient reduces with a
quantized wire (``runtime/qgz.reduce_leaf``): at stage 2 the full
gradients accumulate (fp32 at GAS > 1) and each is reduced once at the
boundary, as JAX reduces its per-group gradients once a step; at stage
3 the gather's backward reduces each microbatch's layer gradient.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel.topology import BATCH_AXES
from deepspeed_tpu_torch.runtime.optimizer import leaves
from deepspeed_tpu_torch.runtime.sharding import (axis_dim, fsdp_dim,
                                                  shard_of, tp_local)
from deepspeed_tpu_torch.runtime import qgz as qgz_mod

logger = logging.getLogger(__name__)

FSDP = "fsdp"
EXPERT_REDUCE = ("dp", "fsdp")


class ZeroPartition:
    """Per-leaf shard dims (by the params tree's ``/a/b`` paths) and the
    step's collectives for one engine on a process group."""

    # the optimizer state's blocks are views of the full leaves that the
    # checkpoint writes by block (``runtime/zeropp.FlatPartition``'s are
    # each rank's own)
    per_rank_state = False

    def __init__(self, plan, mesh, logical_tree: Dict[str, Any],
                 stage: int, qgz: bool = False,
                 full_shapes: Optional[Dict[str, tuple]] = None):
        self.mesh = mesh
        self.plan = plan
        self.stage = stage
        self.qgz = qgz
        self.fsdp_n = mesh.axis_size(FSDP)
        self.fsdp_index = mesh.axis_index(FSDP)
        self.dp_n = mesh.axis_size(BATCH_AXES)
        self.ep_n = mesh.axis_size("ep")
        self.ep_index = mesh.axis_index("ep")
        self.dp_index = mesh.axis_index("dp")
        self.tp_n = mesh.axis_size("tp")
        self.tp_index = mesh.axis_index("tp")
        self.sp_n = mesh.axis_size("sp")
        self.sp_index = mesh.axis_index("sp")
        self.pp_n = mesh.axis_size("pp")
        self.pp_index = mesh.axis_index("pp")

        def dims(tree):
            return {path: fsdp_dim(spec) for path, spec in leaves(tree)}

        self.param_dim = dims(plan.param_shardings(logical_tree))
        self.grad_spec = dict(leaves(plan.grad_shardings(logical_tree)))
        self.grad_dim = {p: fsdp_dim(s) for p, s in self.grad_spec.items()}
        self.opt_dim = dims(plan.opt_shardings(logical_tree))
        self.ep_dim = {path: axis_dim(spec, "ep") for path, spec in
                       leaves(plan.param_shardings(logical_tree))}
        # the tp dim of each leaf and its whole length (``full_shapes``:
        # the model's leaf shapes before any slicing)
        self.tp_dim: Dict[str, Optional[int]] = {}
        self.tp_full: Dict[str, int] = {}
        # the same for the stacked layer dim over pp
        self.pp_dim: Dict[str, Optional[int]] = {}
        self.pp_full: Dict[str, int] = {}
        for axis, n, dims, full in (("tp", self.tp_n, self.tp_dim,
                                     self.tp_full),
                                    ("pp", self.pp_n, self.pp_dim,
                                     self.pp_full)):
            if n == 1:
                continue
            for path, spec in leaves(plan.param_shardings(logical_tree)):
                d = axis_dim(spec, axis)
                if d is not None:
                    dims[path] = d
                    full[path] = full_shapes[path][d]

    # -- layout ---------------------------------------------------------------
    def check(self, params) -> None:
        """Every sharded dim splits evenly over the tp, ep and fsdp ranks
        (JAX refuses an uneven sharding too)."""
        for path, p in leaves(params):
            t = self.tp_dim.get(path)
            if t is not None and self.tp_full[path] % self.tp_n:
                raise ValueError(
                    f"tp={self.tp_n} does not divide dim {t} "
                    f"({self.tp_full[path]}) of leaf {path}")
            if path in self.pp_dim and self.pp_full[path] % self.pp_n:
                raise AssertionError(
                    f"num_layers {self.pp_full[path]} must divide pp "
                    f"{self.pp_n}")
            p = self.tp(path, p)
            e = self.ep_dim.get(path)
            if e is not None and p.shape[e] % self.ep_n:
                raise ValueError(
                    f"leaf {path} of shape {tuple(p.shape)}: its "
                    f"{p.shape[e]} experts do not split over {self.ep_n} "
                    "ep ranks")
            d = self.opt_dim.get(path)
            if d is not None and p.shape[d] % self.fsdp_n:
                raise ValueError(
                    f"ZeRO stage {self.stage}: leaf {path} of shape "
                    f"{tuple(p.shape)} does not split over {self.fsdp_n} "
                    f"fsdp ranks along its embed dim {d}")

    def block(self, path: str, t: torch.Tensor, role: str = "opt"
              ) -> torch.Tensor:
        """This rank's block of a full leaf for ``role`` (opt, grad or
        param): a view, or ``t`` where the role does not shard; an expert
        leaf's experts are this rank's E/ep first."""
        return shard_of(self.experts(path, self.tp(path, t)),
                        getattr(self, f"{role}_dim").get(path))

    def tp(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's stage and tp slice of a leaf (a view; ``t`` where
        it is the slice already or the leaf is replicated over pp and
        tp)."""
        t = tp_local(t, self.pp_dim.get(path), self.pp_full.get(path, 0),
                     self.pp_n, self.pp_index)
        return tp_local(t, self.tp_dim.get(path), self.tp_full.get(path, 0),
                        self.tp_n, self.tp_index)

    def whole(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from a model's slice of it (a model built as one
        tp rank's slice, or one stage's layers: gathered over tp and pp;
        collective), or ``t`` itself where it is whole already."""
        for axis, dims, full in (("tp", self.tp_dim, self.tp_full),
                                 ("pp", self.pp_dim, self.pp_full)):
            d = dims.get(path)
            if d is not None and t.shape[d] != full[path]:
                t = comm.all_gather(t.contiguous(), axis, gather_dim=d)
        return t

    def master_of_param(self, path: str, p: torch.Tensor) -> torch.Tensor:
        """This rank's master block from its compute param (a re-seed):
        the same block at stage 3, else the param's opt block (its
        experts are this rank's already)."""
        if self.param_dim.get(path) is not None:
            return p
        return shard_of(p, self.opt_dim.get(path))

    def experts(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's E/ep experts of a full expert leaf (a view)."""
        return shard_of(t, self.ep_dim.get(path), "ep")

    def scatter_dim(self, path: str) -> Optional[int]:
        """The dim to reduce-scatter a full gradient along as it is
        ready: its gradient shards and its param does not (never under
        qgZ, which reduces the accumulated gradient once)."""
        if self.param_dim.get(path) is None and not self.qgz:
            return self.grad_dim.get(path)
        return None

    # -- qgZ ------------------------------------------------------------------
    def _qgz_reduce(self, g: torch.Tensor, spec) -> torch.Tensor:
        exp_dim = next((d for d, e in enumerate(spec)
                        if e == "ep" or (isinstance(e, tuple) and "ep" in e)),
                       None)
        return qgz_mod.reduce_leaf(g, spec, self.mesh,
                                   part_dim=fsdp_dim(spec), exp_dim=exp_dim)

    def expert_gather_of(self, path: str, axes):
        """Under qgZ's groups on an ep mesh: an expert leaf's whole-stack
        gather for the fetch (its param's fsdp dim, its expert dim, the
        reduction of its whole gradient, the dim its stage-2 block is
        gathered back along), or None for other leaves."""
        spec = self.plan.param_spec(axes)
        edim = axis_dim(spec, "ep")
        if edim is None:
            return None
        fdim = fsdp_dim(spec)
        gspec = self.plan.grad_spec(axes)
        gdim = fsdp_dim(gspec)

        def reduce(g):
            return qgz_mod.reduce_leaf(g, gspec, self.mesh, part_dim=gdim,
                                       exp_dim=edim, experts_local=False)

        return fdim, edim, reduce, (gdim if fdim is None else None)

    def qgz_experts(self) -> bool:
        """Whether qgZ's groups reduce the expert leaves in the fetch."""
        return self.qgz and self.ep_n > 1

    def qgz_of(self, path: str, axes):
        """The stage-3 gather's backward for a leaf under qgZ: its
        layer gradient reduced with the quantized wire to this rank's
        block (the mean over the data ranks)."""
        spec = self.plan.grad_spec(axes)
        return lambda g: self._qgz_reduce(g, spec)

    # -- the step -------------------------------------------------------------
    def _with_sp(self, axes):
        """``axes`` and sp, when sp has ranks."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return axes + ("sp",) if self.sp_n > 1 else axes

    @torch.no_grad()
    def reduce(self, grads: Dict[str, torch.Tensor]) -> None:
        """The gradients' sums over the data ranks as means, in place:
        a full gradient all-reduced over the data axes, a shard (already
        summed over fsdp) over dp where dp has ranks; both summed over sp
        too, and a leaf every stage holds over pp. Under qgZ a full
        gradient is replaced by its quantized reduction (this rank's
        block); a stage-3 shard is already the mean."""
        for path, g in grads.items():
            if self.qgz:
                expert = self.qgz_experts() and \
                    self.ep_dim.get(path) is not None
                if self.param_dim.get(path) is None and not expert:
                    grads[path] = self._qgz_reduce(g, self.grad_spec[path])
                continue
            if self.grad_dim.get(path) is None:
                axes = EXPERT_REDUCE if self.ep_dim.get(path) is not None \
                    else BATCH_AXES
                comm.all_reduce(g, self._with_sp(axes), out=g)
            else:  # summed over fsdp already: the other data axes
                axes = self._with_sp("dp" if self.ep_dim.get(path)
                                     is not None else ("dp", "ep"))
                if self.mesh.axis_size(axes) > 1:
                    comm.all_reduce(g, axes, out=g)
            if self.pp_n > 1 and path not in self.pp_dim:
                comm.all_reduce(g, "pp", out=g)
            if self.dp_n > 1:
                g.div_(self.dp_n)

    def opt_grad(self, path: str, g: torch.Tensor) -> torch.Tensor:
        """The part of a reduced gradient this rank's master block takes
        (a reduced expert gradient holds this rank's experts already, and
        every gradient its tp and pp slices: only the fsdp block is
        cut)."""
        if self.grad_dim.get(path) is None:
            return shard_of(g, self.opt_dim.get(path))
        if self.qgz_experts() and self.ep_dim.get(path) is not None \
                and self.param_dim.get(path) is None:
            return shard_of(g, self.opt_dim.get(path))
        return g

    def owned(self, path: str) -> bool:
        """Whether this rank counts ``path`` in the global norm: its
        block of a sharded leaf, or a replicated leaf on fsdp rank 0
        (with ep ranks: a dense leaf on ep rank 0 and dp rank 0, an
        expert leaf on every ep rank; with tp ranks: a tp-sharded leaf
        on every tp rank, a replicated one on tp rank 0; on sp rank 0;
        with pp ranks: a stage's layers on their stage, a leaf every
        stage holds on pp rank 0)."""
        mine = self.opt_dim.get(path) is not None and self.fsdp_n > 1 \
            or self.fsdp_index == 0
        if self.tp_n > 1 and self.tp_dim.get(path) is None:
            mine = mine and self.tp_index == 0
        if self.pp_n > 1 and path not in self.pp_dim:
            mine = mine and self.pp_index == 0
        mine = mine and self.sp_index == 0
        if self.ep_n == 1:
            return mine
        return mine and self.dp_index == 0 and (
            self.ep_dim.get(path) is not None or self.ep_index == 0)

    def norm_reduce(self, sq: torch.Tensor) -> torch.Tensor:
        """The ranks' sums of squares summed (one fp32 scalar): over the
        data ranks, then over tp, sp and pp."""
        comm.all_reduce(sq, FSDP if self.ep_n == 1 else BATCH_AXES, out=sq)
        for axis, n in (("tp", self.tp_n), ("sp", self.sp_n),
                        ("pp", self.pp_n)):
            if n > 1:
                comm.all_reduce(sq, axis, out=sq)
        return sq

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
        if d is not None:
            t = comm.all_gather(t.contiguous(), FSDP, gather_dim=d)
        e = self.ep_dim.get(path)
        if e is not None and self.ep_n > 1:
            t = comm.all_gather(t.contiguous(), "ep", gather_dim=e)
        d = self.tp_dim.get(path)
        if d is not None:
            t = comm.all_gather(t.contiguous(), "tp", gather_dim=d)
        d = self.pp_dim.get(path)
        if d is not None:
            t = comm.all_gather(t.contiguous(), "pp", gather_dim=d)
        return t


__all__ = ["ZeroPartition"]
