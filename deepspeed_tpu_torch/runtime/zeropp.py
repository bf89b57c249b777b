"""The ZeRO++ stage 1-2 step: quantized gradient reduce (qgZ), quantized
weight all-gather (qwZ) and the quantized all-reduce (qar) over the
``dp`` ranks (port of ``deepspeed_tpu/runtime/zeropp.py``).

Reference: ZeRO++ (docs/_tutorials/zeropp.md), ``all_to_all_quant_reduce``
(runtime/comm/coalesced_collectives.py:31) and the quantized weight
all-gather. The step is the engine's ZeRO step (``runtime/zero.py``'s
``ZeroPartition``: its ``reduce`` and ``publish`` around the optimizer's
AdamW) over ``FlatPartition``, whose collectives are the quantized ones.
Per step and per parameter leaf, after the backward:

  this rank's gradient, flattened, padded to a multiple of dp x 256 and
  viewed as [rows, 256] -> the quantized mean-reducing scatter
  (``ops/quantization.quantized_psum_scatter``: int8 codes and fp32
  scales all-to-all, dequantized and summed in fp32 in rank order), or
  with qar the quantized all-reduce and this rank's rows of it, or with
  neither the exact reduce-scatter -> AdamW (``runtime/optimizer.Adam``)
  on this rank's flat block of the fp32 master -> the block all-gathered
  (int8 under qwZ) back into the compute param.

The master layout is JAX's flat one: each leaf flattened and padded, rank
r holds the r-th of dp equal contiguous blocks (JAX's ``[dp, shard]``
array, ``P('dp')`` on dim 0). ZeRO's own layout (a block of the leaf's
embed dim over fsdp) would not do: the quantize blocks are rows of 256
of the flat padded leaf, so only this layout quantizes the same values
as JAX, code for code. The quantize and the dequantize are the B6 / 6b
kernels on the card (``ops/quantization.LAUNCHES``).

At tp > 1 the layout stays JAX's (``build_zeropp_step``: "the flat [dp,
shard] master layout keeps optimizer state replicated over tp, and the
per-leaf flatten regathers tp-sharded grads"): every tp rank steps the
same flat blocks of the whole leaf, whose ranges each collective takes
are read from the ranks' tp slices of the gradient (``TpSlices``), and
each rank writes its tp slice of the gathered ranges into its param. So
the quantization blocks are JAX's blocks of the whole leaf, and the
clip's norm (a sum over the dp blocks of whole leaves) is the same on
every tp rank. Each collective takes at most CHUNK_ELEMS elements
(``flat_chunks``), so no whole leaf is held at once.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.quantization import (quantized_all_gather,
                                                  quantized_all_reduce,
                                                  quantized_psum_scatter)
from deepspeed_tpu_torch.runtime.optimizer import Adam, leaves
from deepspeed_tpu_torch.runtime.zero import ZeroPartition

logger = logging.getLogger(__name__)

QUANT_BLOCK = 256
DP = "dp"
QUANT_BITS = 8
# the elements of all dp blocks one collective call of the step takes
CHUNK_ELEMS = 1 << 25


def _pad_len(n: int, dp: int) -> int:
    unit = dp * QUANT_BLOCK
    return int(math.ceil(n / unit)) * unit


def flat_block(t: torch.Tensor, dp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` in JAX's layout: the r-th of dp
    equal contiguous blocks of the flat padded leaf (a fresh tensor)."""
    n = t.numel()
    shard = _pad_len(n, dp) // dp
    out = torch.zeros(shard, dtype=t.dtype, device=t.device)
    lo, hi = rank * shard, min((rank + 1) * shard, n)
    if hi > lo:
        out[:hi - lo] = t.detach().reshape(-1)[lo:hi]
    return out


def flat_chunks(n: int, dp: int):
    """The row ranges ``[a, b)`` of each rank's ``[rows, 256]`` block of a
    leaf of ``n`` elements that one collective call of the step takes:
    at most CHUNK_ELEMS elements of all dp blocks a call, so that no
    whole-leaf fp32 buffer exists (a 128256 x 4096 vocab leaf is 2.1 GB
    in fp32). Each row is its own quantization block and each element
    sums over the ranks in rank order, so the chunks give the values of
    one call over the leaf."""
    rows = _pad_len(n, dp) // QUANT_BLOCK // dp
    step = max(1, CHUNK_ELEMS // (dp * QUANT_BLOCK))
    return [(a, min(a + step, rows)) for a in range(0, rows, step)]


def _rank_ranges(n: int, dp: int, a: int, b: int):
    """(rank, lo, hi): the flat range of the leaf that rows ``[a, b)`` of
    each rank's block hold (empty past the leaf's end: the padding)."""
    rows = _pad_len(n, dp) // QUANT_BLOCK // dp
    return [(d, (d * rows + a) * QUANT_BLOCK,
             min((d * rows + b) * QUANT_BLOCK, n)) for d in range(dp)]


class TpSlices:
    """Flat ranges of a whole leaf read from, and written to, this rank's
    tp slice of it (the leaf split along ``dim`` over the tp ranks, rank
    r holding block r), so that the flat step's chunks never hold the
    whole leaf. Viewed as [outer, tp, run], the whole leaf's row o is
    every rank's row o of its [outer, run] slice in rank order; with one
    outer row the slices are contiguous runs of the whole."""

    def __init__(self, shape, dim: int, tp: int, index: int):
        self.outer = math.prod(shape[:dim])
        self.run = shape[dim] // tp * math.prod(shape[dim + 1:])
        self.row = self.run * tp
        self.tp, self.index = tp, index

    def read(self, local: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """The whole leaf's flat ``[lo, hi)`` from each rank's slice
        ``local`` (collective over tp): its owner's broadcast where the
        slices are runs, else the covering rows all-gathered."""
        loc = local.reshape(self.outer, self.run)
        if self.outer == 1:
            out = torch.empty(hi - lo, dtype=local.dtype, device=local.device)
            for r in range(lo // self.run, (hi - 1) // self.run + 1):
                a, b = max(lo, r * self.run), min(hi, (r + 1) * self.run)
                part = (loc[0, a - r * self.run:b - r * self.run]
                        if r == self.index else out[a - lo:b - lo])
                out[a - lo:b - lo] = comm.broadcast(part, "tp", root=r,
                                                    log_name="zpp_tp_read")
            return out
        o0, o1 = lo // self.row, -(-hi // self.row)
        rows = comm.all_gather(loc[o0:o1], "tp", tiled=False,
                               log_name="zpp_tp_read")
        return rows.transpose(0, 1).reshape(-1)[lo - o0 * self.row:
                                                 hi - o0 * self.row]

    def write(self, local: torch.Tensor, lo: int, hi: int,
              vals: torch.Tensor) -> None:
        """This rank's part of the whole leaf's flat ``[lo, hi)`` set to
        ``vals`` in its slice ``local`` (contiguous), cast to its dtype."""
        loc = local.view(self.outer, self.run)
        if self.outer == 1:
            base = self.index * self.run
            a, b = max(lo, base), min(hi, base + self.run)
            if b > a:
                loc[0, a - base:b - base] = vals[a - lo:b - lo]
            return
        o0, o1 = lo // self.row, -(-hi // self.row)
        rows = torch.empty(o1 - o0, self.tp, self.run, dtype=local.dtype,
                           device=local.device)
        rows[:, self.index] = loc[o0:o1]
        rows.view(-1)[lo - o0 * self.row:hi - o0 * self.row] = vals
        loc[o0:o1] = rows[:, self.index]


class FlatPartition(ZeroPartition):
    """ZeRO's step over the dp ranks in JAX's flat ZeRO++ layout: every
    role's dim is None (the param and its gradient are whole; the opt
    block is a flat [shard] slice), the gradients reduce with qgZ / qar
    (or exactly, under qwZ alone) and the masters publish with qwZ's
    int8 gather (or the exact one). Each rank's optimizer state is its
    own (``per_rank_state``: the checkpoint writes it under the rank)."""

    per_rank_state = True

    def __init__(self, plan, mesh, logical_tree, stage: int, params,
                 qg: bool, qw: bool, qar: bool,
                 full_shapes: Optional[Dict[str, tuple]] = None):
        super().__init__(plan, mesh, logical_tree, stage,
                         full_shapes=full_shapes)
        for dims in (self.param_dim, self.grad_dim, self.opt_dim):
            dims.update(dict.fromkeys(dims))
        self.dp, self.rank = mesh.axis_size(DP), mesh.axis_index(DP)
        self.qg, self.qw, self.qar = qg, qw, qar
        # the whole leaves' shapes (a model built as a tp slice holds less)
        self.shapes = {path: tuple(full_shapes[path] if full_shapes
                                   else p.shape)
                       for path, p in leaves(params)}
        logger.info(
            f"ZeRO++ step: dp={self.dp}, "
            + (f"qar=int{QUANT_BITS}" if qar
               else (f"qgZ=int{QUANT_BITS}" if qg else "qgZ=off"))
            + (f", qwZ=int{QUANT_BITS}" if qw else ", qwZ=off"))

    def _slices(self, path: str, t: torch.Tensor) -> Optional[TpSlices]:
        """The tp layout of ``t`` where it is this rank's tp slice of its
        leaf, else None (``t`` is whole)."""
        d = self.tp_dim.get(path)
        if d is None or tuple(t.shape) == self.shapes[path]:
            return None
        return TpSlices(self.shapes[path], d, self.tp_n, self.tp_index)

    def block(self, path: str, t: torch.Tensor, role: str = "opt"
              ) -> torch.Tensor:
        """This rank's flat [shard] block of a leaf (role opt, from the
        whole leaf; a fresh tensor), or its tp slice (param and grad are
        whole over the data ranks)."""
        if role != "opt":
            return self.tp(path, t)
        tps = self._slices(path, t)
        if tps is None:
            return flat_block(t, self.dp, self.rank)
        n = math.prod(self.shapes[path])  # the block read from the slices
        shard = _pad_len(n, self.dp) // self.dp
        out = torch.zeros(shard, dtype=t.dtype, device=t.device)
        lo, hi = self.rank * shard, min((self.rank + 1) * shard, n)
        if hi > lo:
            out[:hi - lo] = tps.read(t.detach(), lo, hi)
        return out

    def master_of_param(self, path: str, p: torch.Tensor) -> torch.Tensor:
        return self.block(path, p)

    @torch.no_grad()
    def reduce(self, grads: Dict[str, torch.Tensor]) -> None:
        """Each full gradient (this rank's tp slice of it) replaced by this
        rank's flat block of the whole leaf's mean over the dp ranks
        (fp32)."""
        for path, g in grads.items():
            n = math.prod(self.shapes[path])
            tps = self._slices(path, g)
            src = g.reshape(-1)
            out = torch.empty(_pad_len(n, self.dp) // self.dp,
                              dtype=torch.float32, device=g.device)
            for a, b in flat_chunks(n, self.dp):
                # rows [a, b) of every rank's block, rank 0's first
                flat = torch.zeros(self.dp, (b - a) * QUANT_BLOCK,
                                   dtype=torch.float32, device=g.device)
                for d, lo, hi in _rank_ranges(n, self.dp, a, b):
                    if hi > lo:
                        flat[d, :hi - lo] = (src[lo:hi] if tps is None else
                                             tps.read(g, lo, hi))
                flat = flat.view(-1, QUANT_BLOCK)
                if self.qar:
                    full = quantized_all_reduce(flat, DP, bits=QUANT_BITS,
                                                block=QUANT_BLOCK)
                    red = full[self.rank * (b - a):(self.rank + 1) * (b - a)]
                elif self.qg:
                    red = quantized_psum_scatter(flat, DP, bits=QUANT_BITS,
                                                 block=QUANT_BLOCK,
                                                 log_name="qgz_dp")
                else:  # qwZ alone: the exact reduce
                    red = comm.reduce_scatter(flat, DP, scatter_dim=0)
                    red = red / torch.full((), float(self.dp),
                                           dtype=torch.float32,
                                           device=red.device)
                out[a * QUANT_BLOCK:b * QUANT_BLOCK] = red.reshape(-1)
            grads[path] = out

    def opt_grad(self, path: str, g: torch.Tensor) -> torch.Tensor:
        return g

    def owned(self, path: str) -> bool:
        return True

    def norm_reduce(self, sq: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(sq, DP, out=sq)

    @torch.no_grad()
    def publish(self, path: str, master: torch.Tensor,
                param: torch.Tensor) -> None:
        """The compute param (this rank's tp slice) from every rank's
        updated flat block: the int8 gather of the fp32 blocks under qwZ,
        else the exact gather of the blocks cast first."""
        n = math.prod(self.shapes[path])
        tps = self._slices(path, param)
        dst = param.view(-1)
        for a, b in flat_chunks(n, self.dp):
            blk = master[a * QUANT_BLOCK:b * QUANT_BLOCK]
            if self.qw:
                got = quantized_all_gather(
                    blk.reshape(-1, QUANT_BLOCK), DP, bits=QUANT_BITS,
                    block=QUANT_BLOCK, log_name="qwz_dp")
            else:
                got = comm.all_gather(blk.to(param.dtype), DP, gather_dim=0)
            got = got.reshape(self.dp, -1)
            for d, lo, hi in _rank_ranges(n, self.dp, a, b):
                if hi <= lo:
                    continue
                if tps is None:
                    dst[lo:hi] = got[d, :hi - lo]
                else:
                    tps.write(param, lo, hi, got[d, :hi - lo])

    def full(self, path: str, t: torch.Tensor, role: str = "opt"
             ) -> torch.Tensor:
        if role != "opt":
            return self.whole(path, t)
        shape = self.shapes[path]
        f = comm.all_gather(t.contiguous(), DP, gather_dim=0)
        return f[:math.prod(shape)].reshape(shape)


def _bias_correction(b: float, t: int, device) -> torch.Tensor:
    """``1 - b ** t`` in fp32 with JAX's float exponent (``b **
    step.astype(float32)``): the power rounded once to fp32, then the
    fp32 subtraction. The optimizer's integer power rounds each product
    (optax's count is an integer) and parts from it at t = 3, b = 0.999."""
    p = np.float32(np.float64(np.float32(b)) ** t)
    return torch.tensor(np.float32(1.0) - p, device=device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The fp32 square root, correctly rounded as XLA's: PyTorch's CPU
    fp32 ``sqrt`` parts from it in the last place on about a sixth of
    values, so on the CPU it is taken in fp64 and rounded once (the card's
    ``sqrtf`` is exact)."""
    if x.device.type == "cpu":
        return x.double().sqrt_().float()
    return x.sqrt()


class ZeroppAdam(Adam):
    """The AdamW of JAX's ZeRO++ step, in its own expression order
    (``deepspeed_tpu/runtime/zeropp.py`` ``_local_step_inner``):

      m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
      master -= lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * master)

    XLA's CPU compile rewrites ``a / b / c`` to ``a / (b * c)`` and
    contracts each ``x * y + z`` whose product feeds an add into one
    fused multiply-add on the left product, so each step here is the
    same single rounding: ``torch.add(z, y, alpha=x)`` is that FMA
    (vectorised on the CPU, contracted by nvcc on the card). Optax's
    order, which ``Adam`` follows, fuses the other product of the moment
    updates and rounds the bias correction's power in steps."""

    def update_leaf(self, path, master, g, st, t, lr):
        """The update of one flat block, CHUNK_ELEMS elements at a time
        (elementwise: the same values; a vocab leaf's temporaries stay
        small)."""
        dev = master.device
        bc1 = _bias_correction(self.b1, t, dev)
        bc2 = _bias_correction(self.b2, t, dev)
        flat = [x.view(-1) for x in (master, g.reshape(-1), st["mu"],
                                     st["nu"])]
        for a in range(0, flat[0].numel(), CHUNK_ELEMS):
            m, gc, mu, nu = (x[a:a + CHUNK_ELEMS] for x in flat)
            mu.copy_(torch.add(gc * (1.0 - self.b1), mu, alpha=self.b1))
            nu.copy_(torch.add(gc * (1.0 - self.b2) * gc, nu,
                               alpha=self.b2))
            denom = _sqrt(nu / bc2).add_(self.eps).mul_(bc1)
            update = torch.add(mu / denom, m, alpha=self.weight_decay)
            m.add_(update, alpha=-lr)


def adamw(opt_params: Dict, lr_schedule: Optional[Callable],
          base_lr: float) -> Adam:
    """JAX's ZeRO++ update as the optimizer's AdamW: decoupled weight
    decay (0.01 unless given, whichever of Adam and AdamW the block
    names), the block's betas and eps, and the LR at the count the
    update takes the step to (JAX's ``lr_schedule(step + 1)``)."""
    b1, b2 = (float(b) for b in opt_params.get("betas", (0.9, 0.999)))
    lr = (float(base_lr) if lr_schedule is None
          else (lambda count: lr_schedule(count + 1)))
    return ZeroppAdam(lr=lr, b1=b1, b2=b2,
                      eps=float(opt_params.get("eps", 1e-8)),
                      weight_decay=float(opt_params.get("weight_decay",
                                                        0.01)),
                      decoupled=True)


def zeropp_enabled(config) -> bool:
    z = config.zero_optimization
    return (z.stage in (1, 2)
            and (z.zero_quantized_gradients or z.zero_quantized_weights
                 or z.zero_quantized_allreduce))


__all__ = ["QUANT_BLOCK", "CHUNK_ELEMS", "FlatPartition", "TpSlices",
           "ZeroppAdam", "adamw", "flat_block", "flat_chunks",
           "zeropp_enabled"]
