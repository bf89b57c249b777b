"""Attention ops: the dense reference path and the flash kernel dispatch
(port of ``deepspeed_tpu/ops/attention.py``).

``impl="auto"`` launches the hand-written flash kernels for CUDA tensors
and takes the dense path for CPU tensors, which is what the JAX package
does off the TPU. The JAX cost table, its ``FLASH_MIN_SEQ`` crossover and
its block-size heuristics are v5e measurements and are not carried over;
the registry and table port is ROADMAP queue A item 3.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -1e30


def repeat_kv_heads(q, k, v):
    """Repeat KV heads up to q's head count (contiguous: q head h reads
    kv head h // group, the flash kernels' GQA map)."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def xla_attention(q, k, v, causal: bool = True,
                  segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense attention, the JAX ``xla_attention`` with its cast points:
    q: [B, S, Nq, D]; k, v: [B, S, Nkv, D]. Scores come out of the
    product in q's type, are cast to fp32 and divided by sqrt(D); the
    softmax runs in fp32 and its probabilities are cast back before the
    product with V. (The name keeps the JAX ``impl`` vocabulary.)"""
    k, v = repeat_kv_heads(q, k, v)
    dt = q.dtype
    d = q.shape[-1]
    scores = torch.einsum("bqnd,bknd->bnqk", q, k).float()
    scores = scores / math.sqrt(d)
    Sq, Sk = scores.shape[-2], scores.shape[-1]
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        scores = scores.masked_fill(~(kpos <= qpos), NEG_INF)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = scores.masked_fill(~same[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def multi_head_attention(q, k, v, causal: bool = True, impl: str = "auto",
                         segment_ids: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Dispatching entry point used by the model. ``impl``: "flash"
    (the kernels; their plain versions on CPU tensors), "xla" (the dense
    path), "auto" (flash for CUDA tensors, dense for CPU tensors).
    "blocksparse" is not ported yet."""
    if impl == "blocksparse":
        raise NotImplementedError(
            "attn_impl='blocksparse' needs the block-sparse kernel "
            "(ROADMAP queue B item 9, blocksparse_attention.py "
            "_sparse_fwd_kernel), not ported yet")
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    raise ValueError(f"unknown attention impl {impl!r}; known: auto, flash, "
                     "xla")


__all__ = ["repeat_kv_heads", "xla_attention", "multi_head_attention"]
