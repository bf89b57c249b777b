"""Shared blockwise-attention numerics for FPDT chunked attention
(``parallel/fpdt.py``; port of ``deepspeed_tpu/parallel/_blockwise.py``,
which ring attention shares in JAX).

One implementation of the flash-attention online softmax: a partial
block compute producing unnormalized (o, m, l) statistics, and the
rescale-and-merge of partials into a running accumulator.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class BlockStats(NamedTuple):
    o: torch.Tensor      # [B,N,Sq,D] fp32 unnormalized weighted values
    m: torch.Tensor      # [B,N,Sq] fp32 row max (0 where row fully masked)
    l: torch.Tensor      # [B,N,Sq] fp32 row sum (0 where row fully masked)
    valid: torch.Tensor  # [B,N,Sq] bool: any unmasked key in this block


def block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               s_valid: int) -> torch.Tensor:
    """[Sq, Sk] bool: keys at positions >= ``s_valid`` (padding) are
    always masked, and later keys too when ``causal``."""
    mask = k_pos[None, :] < s_valid
    if causal:
        return mask & (k_pos[None, :] <= q_pos[:, None])
    return mask.expand(q_pos.shape[0], k_pos.shape[0])


def block_attn_partial(q, k, v, q_pos, k_pos, causal: bool, s_valid: int,
                       seg_q: Optional[torch.Tensor] = None,
                       seg_k: Optional[torch.Tensor] = None) -> BlockStats:
    """One Q-block x KV-block partial attention in fp32.

    q: [B,Sq,N,D]; k, v: [B,Sk,N,D]; q_pos / k_pos: global positions of
    the rows / keys. seg_q / seg_k: optional [B,Sq] / [B,Sk] packed
    segment ids (cross-segment pairs masked)."""
    d = q.shape[-1]
    scores = torch.einsum("bqnd,bknd->bnqk", q, k).float()
    scores = scores / math.sqrt(d)
    mask = block_mask(q_pos, k_pos, causal, s_valid)[None, None]
    if seg_q is not None:
        mask = mask & (seg_q[:, None, :, None] == seg_k[:, None, None, :])
    scores = torch.where(mask, scores, float("-inf"))
    m = torch.amax(scores, dim=-1)
    valid = torch.isfinite(m)
    m_safe = torch.where(valid, m, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    l = torch.where(valid, p.sum(dim=-1), 0.0)
    o = torch.einsum("bnqk,bknd->bnqd", p, v.float())
    return BlockStats(o, m_safe, l, valid)


def online_merge(o_acc, m_acc, l_acc, blk: BlockStats
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge a block's partial stats into the running accumulator
    (o_acc fp32 [B,N,Sq,D]; m_acc fp32 [B,N,Sq] init -inf; l_acc 0)."""
    m_new = torch.maximum(m_acc, torch.where(blk.valid, blk.m,
                                             float("-inf")))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.where(torch.isfinite(m_acc), torch.exp(m_acc - m_safe),
                        0.0)
    beta = torch.where(blk.valid, torch.exp(blk.m - m_safe), 0.0)
    o_acc = o_acc * alpha[..., None] + blk.o * beta[..., None]
    l_acc = l_acc * alpha + blk.l * beta
    return o_acc, m_new, l_acc


def init_accumulators(B: int, N: int, Sq: int, D: int,
                      device=None):
    return (torch.zeros((B, N, Sq, D), dtype=torch.float32, device=device),
            torch.full((B, N, Sq), float("-inf"), dtype=torch.float32,
                       device=device),
            torch.zeros((B, N, Sq), dtype=torch.float32, device=device))


def finalize(o_acc, l_acc, dtype) -> torch.Tensor:
    """Normalize and restore [B,Sq,N,D] layout in the caller's dtype."""
    out = o_acc / torch.clamp(l_acc[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(dtype)


__all__ = ["BlockStats", "block_mask", "block_attn_partial", "online_merge",
           "init_accumulators", "finalize"]
