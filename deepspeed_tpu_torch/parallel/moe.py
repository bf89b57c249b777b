"""Mixture-of-Experts on one card: top-k routing and the dropless
grouped-GEMM dispatch (port of ``deepspeed_tpu/parallel/moe.py``).

Ported: ``GateConfig``, ``compute_capacity``, ``moe_ffn`` with
``impl="auto"`` / ``"grouped"``, ``moe_ffn_dropless`` without a mesh,
and its core (``_dropless_shard_core`` with ep = tp = 1), whose expert
FFN runs three grouped matmuls (``ops/grouped_matmul.gmm``, the
hand-written Hopper kernels on CUDA tensors).

Not ported (ROADMAP queue A item 9): ``top_k_gating`` and the
capacity-padded ``impl="einsum"`` dispatch, the ep > 1 all-to-all
dispatch and tp-split experts; each raises ``NotImplementedError``.

Deliberate differences from the JAX core, each the same function:
- no padding of the sorted rows to a multiple of 128 (a TPU tile rule;
  the padding rows carry zero weight);
- the combine gathers each token's k rows back through the inverse of
  the sort and sums them over k in a fixed order, where JAX scatter-adds
  the sorted rows: the CUDA scatter-add is atomic, and its order, so its
  rounding, would change from run to run for k > 2;
- expert counts come from ``scatter_add_`` (``torch.bincount`` on CUDA
  reads its maximum back to the host).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.grouped_matmul import gmm

_A9 = "ROADMAP queue A item 9"


@dataclasses.dataclass(frozen=True)
class GateConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    drop_tokens: bool = True
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.0


def compute_capacity(tokens_per_group: int, cfg: GateConfig,
                     train: bool = True) -> int:
    """Reference _capacity (sharded_moe.py:91)."""
    factor = cfg.capacity_factor if train else cfg.eval_capacity_factor
    cap = int(tokens_per_group * factor * cfg.top_k / cfg.num_experts)
    cap = max(cap, cfg.min_capacity)
    if not cfg.drop_tokens:
        cap = tokens_per_group  # worst case: everyone to one expert
    return min(cap, tokens_per_group * cfg.top_k)


def top_k_gating(logits, cfg: GateConfig, capacity: int):
    raise NotImplementedError(
        f"top_k_gating (the capacity-padded einsum dispatch) is not ported "
        f"to deepspeed_tpu_torch yet: {_A9}")


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates and their expert ids, ties to the lower id
    first (``lax.top_k``'s order; ``torch.topk`` promises none): the
    first k of a stable descending sort."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(sorted_x: torch.Tensor, group_sizes: torch.Tensor,
                expert_params: Dict[str, torch.Tensor], activation: str,
                dt: torch.dtype) -> torch.Tensor:
    """Grouped-GEMM expert FFN over rows sorted by expert."""
    wi, wo = expert_params["wi"].to(dt), expert_params["wo"].to(dt)
    if activation == "swiglu":
        wg = expert_params["wg"].to(dt)
        hidden = F.silu(gmm(sorted_x, wg, group_sizes)) \
            * gmm(sorted_x, wi, group_sizes)
    else:  # jax.nn.gelu's default is the tanh approximation
        hidden = F.gelu(gmm(sorted_x, wi, group_sizes), approximate="tanh")
    return gmm(hidden, wo, group_sizes)


def _dropless_shard_core(x: torch.Tensor, router_w: torch.Tensor,
                         expert_params: Dict[str, torch.Tensor],
                         cfg: GateConfig, activation: str, *, ep: int = 1,
                         tp: int = 1, train: bool = True
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dropless dispatch on one card: rows sort by expert and run through
    the whole expert stack. Returns (out [B, S, H] in x's type, routing
    statistics)."""
    if ep > 1 or tp > 1:
        raise NotImplementedError(
            f"the dropless dispatch with ep={ep}, tp={tp} (the all-to-all "
            f"dispatch and tp-split experts) is not ported to "
            f"deepspeed_tpu_torch yet: {_A9}")
    del train  # only the capacity of the ep > 1 dispatch depends on it
    B, S, H = x.shape
    E, k = cfg.num_experts, cfg.top_k
    if expert_params["wi"].shape[0] != E:
        raise ValueError(f"expected {E} experts, got "
                         f"{expert_params['wi'].shape[0]}")
    dt = x.dtype
    dev = x.device
    logits = torch.matmul(x, router_w.to(dt))                # [B, S, E]
    gates = torch.softmax(logits.float(), dim=-1)
    top_vals, top_idx = top_k(gates, k)
    weights = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                     min=1e-9)

    tokens = B * S
    m0 = tokens * k
    flat_x = x.reshape(tokens, H)
    flat_expert = top_idx.reshape(-1)                        # [m0]
    flat_w = weights.reshape(-1)                             # fp32
    token_idx = torch.arange(tokens, device=dev).repeat_interleave(k)

    ones = torch.ones(m0, dtype=torch.int32, device=dev)
    group_sizes = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, flat_expert, ones)
    first = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, top_idx[..., 0].reshape(-1), ones[:tokens])
    stats = {
        "me": gates.mean(dim=(0, 1)),                            # [E]
        "ce": first.float() / tokens,
        "zsq": (torch.logsumexp(logits.float(), dim=-1) ** 2).mean()[None],
        "expert_load": group_sizes.float() / max(tokens, 1),
        "ep_dropped_frac": torch.zeros(1, device=dev),
        "dispatch_digest_mismatch": torch.zeros(1, device=dev),
    }

    order = torch.argsort(flat_expert, stable=True)          # [m0]
    sorted_x = flat_x[token_idx[order]]                      # [m0, H]
    expert_out = _expert_ffn(sorted_x, group_sizes, expert_params,
                             activation, dt)
    contrib = expert_out.float() * flat_w[order][:, None]
    # combine in fp32: each token's k rows back in (token, choice) order
    # through the inverse permutation, summed over k in that order; one
    # cast back at the end
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(m0, device=dev)
    out = contrib[inverse].reshape(tokens, k, H).sum(dim=1)
    return out.to(dt).reshape(B, S, H), stats


def _aux_from_stats(stats: Dict[str, torch.Tensor], cfg: GateConfig
                    ) -> Dict[str, torch.Tensor]:
    """Same aux-loss formulas as the JAX top_k_gating, from routing
    statistics."""
    E = cfg.num_experts
    aux = {"l_aux": torch.sum(stats["me"] * stats["ce"]) * E,
           "expert_load": stats["expert_load"]}
    if cfg.z_loss_weight:
        aux["l_zloss"] = stats["zsq"][0]
    for key in ("ep_dropped_frac", "dispatch_digest_mismatch"):
        if key in stats:
            aux[key] = stats[key][0]
    return aux


def moe_ffn_dropless(x: torch.Tensor, router_w: torch.Tensor,
                     expert_params: Dict[str, torch.Tensor], cfg: GateConfig,
                     activation: str = "swiglu", train: bool = True
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dropless MoE FFN via grouped GEMMs: exactly top_k expert FFNs per
    token, no capacity padding, FLOPs independent of routing imbalance.
    One card, no mesh (the JAX ``mesh is None`` branch)."""
    out, stats = _dropless_shard_core(x, router_w, expert_params, cfg,
                                      activation, train=train)
    return out, _aux_from_stats(stats, cfg)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor,
            expert_params: Dict[str, torch.Tensor], cfg: GateConfig,
            activation: str = "swiglu", train: bool = True,
            impl: str = "auto"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full MoE FFN block. x: [B, S, H]; router_w: [H, E];
    expert_params: wi/wo(/wg) with leading expert dim [E, ...].

    ``impl``: "auto" and "grouped" take the dropless grouped path (on
    one card nothing makes "auto" fall back); "einsum" raises."""
    if impl in ("auto", "grouped"):
        return moe_ffn_dropless(x, router_w, expert_params, cfg,
                                activation=activation, train=train)
    if impl == "einsum":
        raise NotImplementedError(
            f"moe_ffn(impl='einsum'), the capacity-padded dispatch, is not "
            f"ported to deepspeed_tpu_torch yet: {_A9}")
    raise ValueError(f"unknown moe impl {impl!r}; known: auto, grouped, "
                     "einsum")


__all__ = ["GateConfig", "compute_capacity", "top_k_gating", "top_k",
           "moe_ffn", "moe_ffn_dropless"]
