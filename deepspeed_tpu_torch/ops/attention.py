"""Attention ops: the dense reference path, the flash kernel dispatch
and the block-sparse dispatch (port of ``deepspeed_tpu/ops/attention.py``).

``impl="auto"`` follows JAX's guard order (``auto_decision``): (1) the
compat probe (``ops/registry.py``: on a CUDA tensor a card without sm_90
or nvcc raises); (2) the measured win/loss table
(``ops/kernel_table.py``, written by ``tools/kernel_bench.py``): a
measured win runs the flash kernel, a measured loss runs
``xla_attention``; (3) for unmeasured buckets the heuristic
``auto_impl``: flash for CUDA tensors of a dtype and head dim the kernels
are built for, the dense path elsewhere (CPU tensors, as JAX off the TPU,
and head dims such as 16 or 32, which JAX's ``auto`` also serves
densely). A CUDA tensor of a dtype or head dim the kernels do not take
never reaches the table. JAX's ``FLASH_MIN_SEQ`` crossover and its block
heuristics are v5e measurements and are not carried over; nor is its
"flash unavailable -> XLA" route: on the card a kernel that does not
build raises, so ``flash_fallbacks`` stays 0. ``kernels.dispatch =
"heuristic"`` (``set_kernel_config``) skips the table. Each new
decision is published to the observability hub (``_export_dispatch``). A measured loss
on a CUDA tensor is also counted apart (``dispatch_stats()
["card_losses"]``): ``chip_smoke.py`` fails a main-path phase that
routed one, so a kernel that loses its bucket on the card shows as a
failure to be fixed, never as a silent route to the dense path.

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
from deepspeed_tpu_torch.ops import kernel_table, registry
from deepspeed_tpu_torch.ops.flash_attention import (HEAD_DIMS,
                                                     flash_attention)

NEG_INF = -1e30

# the process-global layout for impl="blocksparse" (a SparsityConfig)
_SPARSE_CONFIG = None
# the installed ``kernels`` config block (dispatch policy, table path);
# None = table dispatch at the default path
_KERNEL_CONFIG = None
# impl="auto" outcomes: the kernel or the dense path; flash_fallbacks is
# JAX's wanted-flash-but-unavailable count, 0 here (no such route);
# card_losses counts the CUDA calls that a measured loss sent dense
_DISPATCH_STATS = {"kernel": 0, "xla": 0, "flash_fallbacks": 0,
                   "card_losses": 0}
# auto_decision's memo: (device, dtype, bucket, table path, heuristic) ->
# decision, for one installed config and one kernel_table generation
_DECISIONS: dict = {}
_DECISIONS_GEN = None


def set_sparse_config(sparsity) -> None:
    """Install the layout for impl='blocksparse' (the engine wires the
    ds_config sparse_attention block here; None clears it)."""
    global _SPARSE_CONFIG
    _SPARSE_CONFIG = sparsity


def set_kernel_config(kernels) -> None:
    """Install the ds_config ``kernels`` block (the engine does at init):
    ``dispatch`` ("auto": the table; "heuristic": ``auto_impl`` alone) and
    ``table_path`` (None: ``kernel_table.table_path()``)."""
    global _KERNEL_CONFIG
    _KERNEL_CONFIG = kernels
    _DECISIONS.clear()


def dispatch_stats() -> dict:
    """Copy of the impl="auto" dispatch counters."""
    return dict(_DISPATCH_STATS)


def flash_fallback_ratio() -> float:
    """Share of flash-worthy dispatches that lost the kernel (JAX's
    metric; 0 here, where an unavailable kernel raises)."""
    fb = _DISPATCH_STATS["flash_fallbacks"]
    return fb / max(1, _DISPATCH_STATS["kernel"] + fb)


def _reset_dispatch_stats() -> None:
    for key in _DISPATCH_STATS:
        _DISPATCH_STATS[key] = 0


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


def auto_decision(device_type: str, dtype: torch.dtype, seq: int,
                  head_dim: int, causal: bool) -> registry.DispatchDecision:
    """The ``impl="auto"`` decision, JAX's guard order: the compat probe,
    the measured table, ``auto_impl`` for unmeasured buckets. A CUDA
    tensor of a dtype or head dim the kernels do not take goes to the
    dense path before the table is read (no measurement can exist).
    The decision past ``auto_impl`` is memoised per (device, dtype,
    bucket, table path, heuristic); the memo goes with
    ``set_kernel_config`` and ``kernel_table.invalidate_cache``."""
    global _DECISIONS_GEN
    heuristic = auto_impl(device_type, dtype, head_dim) == "flash"
    kcfg = _KERNEL_CONFIG
    path = getattr(kcfg, "table_path", None) or kernel_table.table_path()
    bucket = kernel_table.attention_bucket(seq, head_dim, causal)
    if _DECISIONS_GEN != kernel_table.generation():
        _DECISIONS.clear()
        _DECISIONS_GEN = kernel_table.generation()
    key = (device_type, dtype, bucket, path, heuristic)
    decision = _DECISIONS.get(key)
    if decision is None:
        decision = _DECISIONS[key] = _decide(device_type, dtype, bucket,
                                             head_dim, heuristic, path, kcfg)
        _export_dispatch("attention", decision.source, decision.reason,
                         bucket)
    return decision


def _export_dispatch(region: str, source: str, reason: str,
                     bucket: str) -> None:
    """Publish a new decision to the observability hub (JAX
    ``attention.py:171-187``): the ``kernel.<region>.pallas`` gauge (JAX's
    name; 1.0 when the hand kernel runs), the flash fallback ratio and
    one ``kernel_dispatch`` event. JAX exports once per compiled program;
    the port decides per call and exports once per memoised decision, so
    the calls that hit the memo cost no hub traffic. Never creates a
    hub."""
    from deepspeed_tpu_torch.observability.hub import peek_hub

    hub = peek_hub()
    if hub is None:
        return
    hub.gauge(f"kernel.{region}.pallas", 1.0 if source == "kernel" else 0.0)
    hub.gauge("kernel.flash_fallback_ratio", flash_fallback_ratio())
    hub.record_event("kernel_dispatch", region=region, source=source,
                     reason=reason, bucket=bucket)


def _decide(device_type, dtype, bucket, head_dim, heuristic, path, kcfg
            ) -> registry.DispatchDecision:
    if device_type == "cuda" and not heuristic:
        return registry.DispatchDecision(
            "xla_attention", "xla",
            f"flash kernels take float32 or bfloat16 at head dim "
            f"{HEAD_DIMS}, got {dtype} at {head_dim}")
    if kcfg is not None and getattr(kcfg, "dispatch", "auto") == "heuristic":
        return registry.DispatchDecision(
            op_name="flash_attention" if heuristic else "xla_attention",
            source="kernel" if heuristic else "xla",
            reason="kernels.dispatch=heuristic")
    return registry.dispatch_op(
        "flash_attention", bucket, "xla_attention", default_use=heuristic,
        table_path=path, device_type=device_type)


def multi_head_attention(q, k, v, causal: bool = True, impl: str = "auto",
                         segment_ids: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Dispatching entry point used by the model. ``impl``: "flash"
    (the kernels; their plain versions on CPU tensors; raises on a shape
    the kernels do not take), "xla" (the dense path), "auto"
    (``auto_decision``: the probe, the measured table, then
    ``auto_impl``), "blocksparse" (the installed layout: the masked form
    under autograd, else the block-sparse kernel)."""
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
        decision = auto_decision(q.device.type, q.dtype, q.shape[1],
                                 q.shape[-1], causal)
        _DISPATCH_STATS[decision.source] += 1
        if q.device.type == "cuda" and decision.source == "xla" and \
                decision.ratio is not None:
            _DISPATCH_STATS["card_losses"] += 1
        impl = "flash" if decision.source == "kernel" else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    raise ValueError(f"unknown attention impl {impl!r}; known: auto, flash, "
                     "xla, blocksparse")


__all__ = ["repeat_kv_heads", "xla_attention", "auto_impl",
           "auto_decision", "multi_head_attention", "set_sparse_config",
           "set_kernel_config", "dispatch_stats", "flash_fallback_ratio"]
