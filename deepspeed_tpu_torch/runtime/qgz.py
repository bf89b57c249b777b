"""ZeRO++ qgZ at stages 2-3: the gradient reduction with a quantized wire
(port of ``deepspeed_tpu/runtime/qgz.py``).

Reference: ``all_to_all_quant_reduce`` (runtime/comm/coalesced_collectives
.py:31) reduces gradients with a hierarchical quantized all-to-all, int8
within a node and int4 across nodes. JAX computes one gradient per batch
shard group (a ``vmap`` over the batch) and reduces the group axis with
the wire quantized; here each rank's gradient is its group's, and the
levels are explicit collectives over the mesh axes:

  1. ``fsdp`` at ``bits1`` (int8): quantize this rank's gradient along its
     last dim (B6), all-to-all codes and scales so that each rank gets
     its block of the partitioned dim from every fsdp peer, dequantize
     (6b) and sum them in fp32 in rank order;
  2. ``ep`` at ``bits1`` onto the expert-stacked dim of an expert leaf
     whose gradient still covers every expert (the einsum dispatch);
  3. the remaining replica axes (``dp``, and ``ep`` for dense leaves) at
     ``bits2`` (int4 by default, packed two to a byte) onto the
     partitioned dim, then the sub-blocks all-gathered in fp32 back to
     the fsdp block.

On an sp mesh the sp ranks' gradients are summed exactly first (each
holds its sequence block's part of the group's gradient). At tp each
rank reduces its tp slice, with JAX's block of the whole leaf. The sum
is divided by the number of groups G = dp x fsdp x ep. A leaf
with no partitioned dim, or whose last dim cannot be blocked (1-D norm
scales and biases), reduces exactly in fp32. The result is this rank's
block of the gradient along the fsdp-partitioned dim: the engine's
stage 2-3 gradient shard, the mean over the data ranks.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.quantization import (dequantize, pack_int4,
                                                  quantize_blockwise)
from deepspeed_tpu_torch.parallel.topology import BATCH_AXES

QGZ_BLOCK = 256
# the group axes a rank's gradient is whole over (the model axes, tp and
# pp, cut the leaf itself)
_DATA_AXES = ("dp", "fsdp", "ep")


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def leaf_block(shape: Sequence[int], spec, mesh) -> int:
    """The quantization block along the last dim: blocks must tile within
    every sharding of that dim (JAX's rule on the global shape); <= 1
    means exact. ``shape`` is this rank's gradient, whole over the data
    axes and its tp slice of a tp-sharded dim, so only the data axes of
    the last dim's sharding divide it further."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    div = 1
    for a in _axes_of(entries[-1]) if entries else ():
        if a in _DATA_AXES:
            div *= mesh.shape.get(a, 1)
    last = shape[-1]
    return math.gcd(last // div, QGZ_BLOCK) if last % max(div, 1) == 0 \
        else 1


def _move(box: list, axis, target: int, bits: int, block: int,
          tag: str) -> Optional[torch.Tensor]:
    """One level: quantize the gradient ``box`` holds along its last dim
    (taken out of the box and dropped once quantized, so that its fp32
    buffer is gone before the exchange's), all-to-all the codes and
    scales over ``axis`` splitting ``target`` (block j to rank j),
    dequantize and sum the sources in rank order (fp32). Returns this
    rank's block of ``target``, unnormalized; None (the gradient left in
    the box) when ``target`` does not split over the axis at block
    granularity."""
    g = box[0]
    n = comm.axis_size(axis)
    last = g.dim() - 1
    nb = g.shape[-1] // block
    if (target == last and nb % n) or g.shape[target] % n:
        return None
    shape = g.shape
    box.clear()
    q, s = quantize_blockwise(g, bits=bits, block=block)
    del g
    if bits == 4:
        q = pack_int4(q)
    w = block // 2 if bits == 4 else block
    qb = q.reshape(*q.shape[:-1], nb, w)
    qt = comm.all_to_all(qb, axis, split_dim=target, concat_dim=0,
                         log_name=f"qgz_{tag}_int{bits}")
    st = comm.all_to_all(s, axis, split_dim=target, concat_dim=0,
                         log_name=f"qgz_{tag}_scales")
    vals = dequantize(qt, st, torch.float32)      # [n * piece..., block]
    piece = list(shape)
    if target == last:
        piece[last] //= n
        vals = vals.reshape(n, *piece[:-1], nb // n, block)
    else:
        piece[target] //= n
        vals = vals.reshape(n, *piece[:-1], nb, block)
    acc = vals[0].clone()
    for r in range(1, n):
        acc += vals[r]
    return acc.reshape(piece)


def _gather_sum(g: torch.Tensor, axis, bits: int, block: int,
                tag: str) -> torch.Tensor:
    """A level whose target cannot split: every rank gathers every peer's
    codes and scales and sums them in rank order (the same values, more
    wire)."""
    n = comm.axis_size(axis)
    q, s = quantize_blockwise(g, bits=bits, block=block)
    if bits == 4:
        q = pack_int4(q)
    nb = g.shape[-1] // block
    qb = q.reshape(*q.shape[:-1], nb, q.shape[-1] // nb)
    qg = comm.all_gather(qb, axis, tiled=False, gather_dim=0,
                         log_name=f"qgz_{tag}_int{bits}")
    sg = comm.all_gather(s, axis, tiled=False, gather_dim=0,
                         log_name=f"qgz_{tag}_scales")
    vals = dequantize(qg, sg, torch.float32).reshape(n, *g.shape)
    acc = vals[0].clone()
    for r in range(1, n):
        acc += vals[r]
    return acc


def reduce_leaf(g: torch.Tensor, spec, mesh, *, part_dim: Optional[int],
                exp_dim: Optional[int] = None, experts_local: bool = True,
                bits1: int = 8, bits2: Optional[int] = 4) -> torch.Tensor:
    """This rank's gradient ``g`` (its group's, full width) reduced over
    the data ranks: the mean, as this rank's block of ``part_dim`` over
    fsdp (the whole mean where ``part_dim`` is None). ``spec`` is the
    leaf's gradient spec (the block rule); ``exp_dim`` the expert dim of
    an expert leaf, reduced at level 2 unless the gradient already holds
    only this rank's experts (``experts_local``: the all-to-all
    dispatch summed the ep peers' rows exactly in its backward)."""
    sizes = mesh.shape
    dp, fsdp, ep = (sizes.get(a, 1) for a in ("dp", "fsdp", "ep"))
    G = dp * fsdp * ep
    given, g = g, g.float()
    if sizes.get("sp", 1) > 1:
        # the sp ranks' parts of the group's gradient, summed full width
        # (JAX reduces sp inside each group's backward): only the data
        # axes' wire is quantized; in place unless ``g`` is the caller's
        g = comm.all_reduce(g, "sp", out=None if g is given else g)
    block = leaf_block(tuple(g.shape), spec, mesh)
    denom = torch.full((), float(G), dtype=torch.float32, device=g.device)
    if part_dim is None or block <= 1:
        red = comm.all_reduce(g, BATCH_AXES) / denom
        if part_dim is not None and fsdp > 1:
            size = red.shape[part_dim] // fsdp
            red = red.narrow(part_dim, mesh.axis_index("fsdp") * size,
                             size).contiguous()
        return red
    if fsdp > 1:
        box = [g]
        del g
        g = _move(box, "fsdp", part_dim, bits1, block, "fsdp")
    if ep > 1 and exp_dim is not None and not experts_local:
        g = _move([g], "ep", exp_dim, bits1, block, "ep")
        rem = ("dp",)
    elif ep > 1 and exp_dim is not None:
        rem = ("dp",)
    else:
        rem = ("dp", "ep")
    rem = tuple(a for a in rem if sizes.get(a, 1) > 1)
    if rem and bits2:
        axis = rem[0] if len(rem) == 1 else rem
        moved = _move([g], axis, part_dim, bits2, block, "+".join(rem))
        if moved is None:
            g = _gather_sum(g, axis, bits2, block, "+".join(rem))
        else:
            g = comm.all_gather(moved / denom, axis, gather_dim=part_dim,
                                log_name="qgz_regather")
            return g
    elif rem:
        g = comm.all_reduce(g, rem[0] if len(rem) == 1 else rem)
    return g / denom


__all__ = ["QGZ_BLOCK", "leaf_block", "reduce_leaf"]
