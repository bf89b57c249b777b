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


def _pad_len(n: int, dp: int) -> int:
    unit = dp * QUANT_BLOCK
    return int(math.ceil(n / unit)) * unit


def flat_padded(t: torch.Tensor, dp: int, dtype=None) -> torch.Tensor:
    """``t`` flattened and zero-padded to a multiple of dp x 256."""
    n = t.numel()
    f = torch.zeros(_pad_len(n, dp), dtype=dtype or t.dtype,
                    device=t.device)
    f[:n] = t.detach().reshape(-1)
    return f


def flat_block(t: torch.Tensor, dp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` in JAX's layout: the r-th of dp
    equal contiguous blocks of the flat padded leaf (a fresh tensor)."""
    f = flat_padded(t, dp)
    shard = f.numel() // dp
    return f[rank * shard:(rank + 1) * shard].clone()


class FlatPartition(ZeroPartition):
    """ZeRO's step over the dp ranks in JAX's flat ZeRO++ layout: every
    role's dim is None (the param and its gradient are whole; the opt
    block is a flat [shard] slice), the gradients reduce with qgZ / qar
    (or exactly, under qwZ alone) and the masters publish with qwZ's
    int8 gather (or the exact one). Each rank's optimizer state is its
    own (``per_rank_state``: the checkpoint writes it under the rank)."""

    per_rank_state = True

    def __init__(self, plan, mesh, logical_tree, stage: int, params,
                 qg: bool, qw: bool, qar: bool):
        super().__init__(plan, mesh, logical_tree, stage)
        for dims in (self.param_dim, self.grad_dim, self.opt_dim):
            dims.update(dict.fromkeys(dims))
        self.dp, self.rank = mesh.axis_size(DP), mesh.axis_index(DP)
        self.qg, self.qw, self.qar = qg, qw, qar
        self.shapes = {path: tuple(p.shape) for path, p in leaves(params)}
        logger.info(
            f"ZeRO++ step: dp={self.dp}, "
            + (f"qar=int{QUANT_BITS}" if qar
               else (f"qgZ=int{QUANT_BITS}" if qg else "qgZ=off"))
            + (f", qwZ=int{QUANT_BITS}" if qw else ", qwZ=off"))

    def block(self, path: str, t: torch.Tensor, role: str = "opt"
              ) -> torch.Tensor:
        """This rank's flat [shard] block of a full leaf (role opt; a
        fresh tensor), or ``t`` (param and grad are whole)."""
        return flat_block(t, self.dp, self.rank) if role == "opt" else t

    def master_of_param(self, path: str, p: torch.Tensor) -> torch.Tensor:
        return self.block(path, p)

    @torch.no_grad()
    def reduce(self, grads: Dict[str, torch.Tensor]) -> None:
        """Each full gradient replaced by this rank's flat block of the
        mean over the dp ranks (fp32)."""
        for path, g in grads.items():
            flat = flat_padded(g, self.dp, torch.float32).reshape(
                -1, QUANT_BLOCK)
            if self.qar:
                full = quantized_all_reduce(flat, DP, bits=QUANT_BITS,
                                            block=QUANT_BLOCK)
                rows = flat.shape[0] // self.dp
                red = full[self.rank * rows:(self.rank + 1) * rows]
            elif self.qg:
                red = quantized_psum_scatter(flat, DP, bits=QUANT_BITS,
                                             block=QUANT_BLOCK,
                                             log_name="qgz_dp")
            else:  # qwZ alone: the exact reduce
                red = comm.reduce_scatter(flat, DP, scatter_dim=0)
                red = red / torch.full((), float(self.dp),
                                       dtype=torch.float32,
                                       device=red.device)
            grads[path] = red.reshape(-1)

    def opt_grad(self, path: str, g: torch.Tensor) -> torch.Tensor:
        return g

    def owned(self, path: str) -> bool:
        return True

    def norm_reduce(self, sq: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(sq, DP, out=sq)

    @torch.no_grad()
    def publish(self, path: str, master: torch.Tensor,
                param: torch.Tensor) -> None:
        """The compute param from every rank's updated flat block: the
        int8 gather of the fp32 blocks under qwZ, else the exact gather
        of the blocks cast first."""
        if self.qw:
            full = quantized_all_gather(
                master.reshape(-1, QUANT_BLOCK), DP, bits=QUANT_BITS,
                block=QUANT_BLOCK, log_name="qwz_dp").reshape(-1)
        else:
            full = comm.all_gather(master.to(param.dtype), DP, gather_dim=0)
        param.copy_(full[:param.numel()].reshape(param.shape))

    def full(self, path: str, t: torch.Tensor, role: str = "opt"
             ) -> torch.Tensor:
        if role != "opt":
            return t
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
        dev = master.device
        bc1 = _bias_correction(self.b1, t, dev)
        bc2 = _bias_correction(self.b2, t, dev)
        mu, nu = st["mu"], st["nu"]
        mu.copy_(torch.add(g * (1.0 - self.b1), mu, alpha=self.b1))
        nu.copy_(torch.add(g * (1.0 - self.b2) * g, nu, alpha=self.b2))
        denom = _sqrt(nu / bc2).add_(self.eps).mul_(bc1)
        update = torch.add(mu / denom, master, alpha=self.weight_decay)
        master.add_(update, alpha=-lr)


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


__all__ = ["QUANT_BLOCK", "FlatPartition", "ZeroppAdam", "adamw",
           "flat_block", "flat_padded", "zeropp_enabled"]
