"""Attention ops: the dense reference path, the flash kernel dispatch
and the block-sparse dispatch (port of ``deepspeed_tpu/ops/attention.py``).

``impl="auto"`` launches the hand-written flash kernels for CUDA tensors
of a dtype and head dim the kernels are built for (``auto_impl``), and
takes the dense path everywhere else: for CPU tensors, which is what the
JAX package does off the TPU, and for head dims such as 16 or 32, which
JAX's ``auto`` also serves densely. The choice is made from the shape,
before any launch. The JAX cost table, its ``FLASH_MIN_SEQ`` crossover and
its block-size heuristics are v5e measurements and are not carried over;
the registry and table port is ROADMAP queue A item 3.

``impl="blocksparse"`` reads the layout that ``set_sparse_config``
installed (the engine installs the config's ``sparse_attention`` block).
It routes by gradient: where autograd records (grad mode on and q, k or
v requiring grad) it runs the differentiable masked form, as JAX does
everywhere; otherwise it launches the block-sparse kernel, which JAX
keeps for its no-grad fast path (``blocksparse_attention.py:303-304``).
Both compute the same function.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import blocksparse_attention as bsa
from deepspeed_tpu_torch.ops.flash_attention import (HEAD_DIMS,
                                                     flash_attention)

NEG_INF = -1e30

# the process-global layout for impl="blocksparse" (a SparsityConfig)
_SPARSE_CONFIG = None


def set_sparse_config(sparsity) -> None:
    """Install the layout for impl='blocksparse' (the engine wires the
    ds_config sparse_attention block here; None clears it)."""
    global _SPARSE_CONFIG
    _SPARSE_CONFIG = sparsity


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


def auto_impl(device_type: str, dtype: torch.dtype, head_dim: int) -> str:
    """What ``impl="auto"`` runs: "flash" on the card for fp32 or bf16 at
    a head dim the flash kernels are built for (``HEAD_DIMS``), "xla"
    (the dense path) for everything else. Pure in its arguments."""
    if (device_type == "cuda" and dtype in (torch.float32, torch.bfloat16)
            and head_dim in HEAD_DIMS):
        return "flash"
    return "xla"


def multi_head_attention(q, k, v, causal: bool = True, impl: str = "auto",
                         segment_ids: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Dispatching entry point used by the model. ``impl``: "flash"
    (the kernels; their plain versions on CPU tensors; raises on a shape
    the kernels do not take), "xla" (the dense path), "auto"
    (``auto_impl``: flash for CUDA tensors the kernels take, else dense),
    "blocksparse" (the installed layout: the masked form under autograd,
    else the block-sparse kernel)."""
    if impl == "blocksparse":
        if _SPARSE_CONFIG is None:
            raise ValueError(
                "attn_impl='blocksparse' needs a sparse_attention config "
                "block (or ops.attention.set_sparse_config)")
        if segment_ids is not None:
            raise NotImplementedError(
                "blocksparse attention does not take segment_ids")
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            k, v = repeat_kv_heads(q, k, v)  # the masked form is MHA-only
            return bsa.blocksparse_attention(q, k, v, _SPARSE_CONFIG,
                                             causal=causal)
        return bsa.blocksparse_attention_kernel(q, k, v, _SPARSE_CONFIG,
                                                causal=causal)
    if impl == "auto":
        impl = auto_impl(q.device.type, q.dtype, q.shape[-1])
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    raise ValueError(f"unknown attention impl {impl!r}; known: auto, flash, "
                     "xla, blocksparse")


__all__ = ["repeat_kv_heads", "xla_attention", "auto_impl",
           "multi_head_attention", "set_sparse_config"]
