"""Ring attention: blockwise context parallelism over the sp ranks (port
of ``deepspeed_tpu/parallel/ring_attention.py``).

Each sp rank keeps its query block and passes its K / V block (and its
segment-id block) around the ring, one hop a step, merging each block's
partial attention into an exact online softmax
(``parallel/_blockwise.py``, shared with FPDT). Causality comes from the
global positions, so sp may exceed the head count (Ulysses' limit).
JAX runs a ``lax.scan`` of ``ppermute`` hops inside a shard_map; here
the hop is ``PPermute``, an autograd Function whose backward is the
inverse permutation, and each step's block goes under a non-reentrant
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``), so the backward
keeps one [S/p x S/p] block a step alive, not p of them. Every rank
issues the same hops in the same order (the last step's hop, whose
blocks no step reads, is left out on every rank).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.utils.checkpoint

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import _blockwise as bw
from deepspeed_tpu_torch.runtime import sharding


class PPermute(torch.autograd.Function):
    """``comm.ppermute`` over ``axis`` (JAX ``lax.ppermute``); the
    backward sends each cotangent back along the inverse pairs."""

    @staticmethod
    def forward(ctx, x, axis, perm, log_name):
        ctx.axis, ctx.log_name = axis, log_name
        ctx.inverse = [(d, s) for s, d in perm]
        return comm.ppermute(x, axis, perm, log_name=log_name)

    @staticmethod
    def backward(ctx, g):
        return (comm.ppermute(g.contiguous(), ctx.axis, ctx.inverse,
                              log_name=ctx.log_name + "_grad"),
                None, None, None)


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Sequence[int]],
             log_name: Optional[str] = None) -> torch.Tensor:
    """The differentiable ppermute (a rank no pair sends to gets
    zeros)."""
    return PPermute.apply(x.contiguous(), axis, [tuple(p) for p in perm],
                          log_name or "ppermute")


def _ring_attn_local(q, k, v, seg, *, axis: str, causal: bool,
                     s_global: int):
    """This rank's query block against every rank's K / V block: q, k, v
    [B, S/p, N, D], ``seg`` [B, S/p] or None."""
    p_size = comm.axis_size(axis)
    me = comm.axis_index(axis)
    s_loc = q.shape[1]
    dev = q.device
    q_pos = me * s_loc + torch.arange(s_loc, device=dev)
    B, _, N, D = q.shape
    o_acc, m_acc, l_acc = bw.init_accumulators(B, N, s_loc, D, device=dev)
    perm = [(i, (i + 1) % p_size) for i in range(p_size)]
    k_blk, v_blk, seg_blk = k, v, seg
    for step in range(p_size):
        kv_idx = (me - step) % p_size
        k_pos = kv_idx * s_loc + torch.arange(s_loc, device=dev)
        blk = torch.utils.checkpoint.checkpoint(
            bw.block_attn_partial, q, k_blk, v_blk, q_pos, k_pos, causal,
            s_global, seg, seg_blk, use_reentrant=False)
        o_acc, m_acc, l_acc = bw.online_merge(o_acc, m_acc, l_acc, blk)
        if step == p_size - 1:
            break
        k_blk = ppermute(k_blk, axis, perm, "ring_attention_kv")
        v_blk = ppermute(v_blk, axis, perm, "ring_attention_kv")
        if seg is not None:
            seg_blk = comm.ppermute(seg_blk.contiguous(), axis, perm,
                                    log_name="ring_attention_seg")
    return bw.finalize(o_acc, l_acc, q.dtype)


def ring_attention(q, k, v, causal: bool = True, axis: str = "sp",
                   segment_ids: Optional[torch.Tensor] = None,
                   seq_len: Optional[int] = None) -> torch.Tensor:
    """Context-parallel attention on this rank's sequence block: q, k, v
    [B, S/p, N, D] (kv heads already repeated), ``segment_ids`` [B, S/p]
    (the block rotates with its K / V). ``seq_len`` is the valid global
    length when the sequence was padded to the ring size (keys past it
    are masked, as JAX masks its padding; ``topology.batch_sharding``
    pads at the end, which causal attention never reads). Without sp
    ranks on ``axis`` it is dense attention, counted as
    ``ring_attention.dense_fallback``."""
    from deepspeed_tpu_torch.ops.attention import multi_head_attention

    if axis != sharding.SP or sharding.sp_size() == 1:
        from deepspeed_tpu_torch.utils import telemetry

        telemetry.count(
            "ring_attention.dense_fallback",
            f"no mesh axis '{axis}' > 1 — running dense attention")
        return multi_head_attention(q, k, v, causal=causal,
                                    segment_ids=segment_ids)
    p_size = sharding.sp_size()
    s_global = q.shape[1] * p_size if seq_len is None else int(seq_len)
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        if seq_len is not None:
            # padded keys are masked by position already; -1 also keeps
            # them out of any real segment
            pos = comm.axis_index(axis) * q.shape[1] + torch.arange(
                q.shape[1], device=seg.device)
            seg = torch.where(pos[None, :] < s_global, seg,
                              torch.full_like(seg, -1))
    return _ring_attn_local(q, k, v, seg, axis=axis, causal=causal,
                            s_global=s_global)


__all__ = ["ring_attention", "PPermute", "ppermute"]
