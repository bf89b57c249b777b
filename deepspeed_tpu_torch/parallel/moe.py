"""Mixture-of-Experts: top-k gating, the capacity-padded einsum dispatch
and the dropless grouped-GEMM dispatch, on one card or expert-parallel
over the ``ep`` ranks (port of ``deepspeed_tpu/parallel/moe.py``).

``top_k_gating`` and ``moe_ffn(impl="einsum")`` are JAX's GShard
formulation (capacity-padded dispatch and combine as einsums). The
dropless path's expert FFN runs three grouped matmuls
(``ops/grouped_matmul.gmm``, the hand-written Hopper kernels on CUDA
tensors). Across ranks one process is one rank and its ``x`` is its own
tokens (the engine hands each data rank its rows, JAX's shard of the
token axes); with ep > 1 each rank holds E/ep experts and rows travel to
their owner rank and back by two ``all_to_all`` calls over the ep group,
with a static per-(source, destination) budget (``_ep_capacity``);
overflow rows drop with zero weight and the combine weights renormalize
over the kept rows. The routing statistics (and so the router's aux
losses) are averaged over the token ranks, the unweighted mean JAX takes
over its shards; their gradient flows back to every rank's own gates.
The einsum path under ep gathers the expert stack over ep (its backward
reduce-scatters the expert gradients back). ``global_tokens=True`` takes
JAX's whole batch instead and places the tokens as JAX's shard_map does
(batch, then sequence; ``moe.grouped_replicated_tokens`` counts the
axes that place nothing). With tp > 1 every expert's FFN width splits
over tp (each rank holds F/tp of ``wi`` / ``wg`` / ``wo``): the ranks
route the same tokens, the rows enter the experts through
``sharding.tp_copy`` and the combine weights too (each rank's weight
gradient is a partial sum), the fp32 combine is all-reduced over tp
(JAX ``moe.py:415``) and ``dispatch_digest_mismatch`` says whether the
tp ranks routed alike (JAX's order-sensitive digest, ``:326-338``).

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

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.grouped_matmul import gmm
from deepspeed_tpu_torch.runtime import sharding

TOKEN_AXES = ("dp", "fsdp", "ep")


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


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot; an index outside [0, n) gives zeros (jax.nn.one_hot)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k_gating(logits: torch.Tensor, cfg: GateConfig, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Dict[str, torch.Tensor]]:
    """Generalized top-k gate (the reference's top1/top2/topk).

    logits: [G, S, E] (G = groups = batch dim). Returns (combine weights
    [G, S, E, C] fp32, dispatch mask [G, S, E, C] bool, aux dict). Each
    round picks every token's best remaining expert; earlier tokens win
    capacity slots and round k = 0 wins over k = 1 (the reference's
    sequential locations, sharded_moe.py:375)."""
    G, S, E = logits.shape
    gates = torch.softmax(logits.float(), dim=-1)
    combine = torch.zeros((G, S, E, capacity), dtype=torch.float32,
                          device=logits.device)
    counts = torch.zeros((G, E), dtype=torch.int32, device=logits.device)
    remaining = gates
    denom = torch.zeros((G, S), dtype=torch.float32, device=logits.device)
    picks = []
    for _ in range(cfg.top_k):
        idx = torch.argmax(remaining, dim=-1)                   # [G, S]
        picks.append(idx)
        gate_val = torch.gather(gates, -1, idx[..., None])[..., 0]
        onehot = _one_hot(idx, E)                               # [G, S, E]
        pos_in_exp = torch.cumsum(onehot, dim=1) - onehot
        pos = (torch.gather(pos_in_exp, -1, idx[..., None])[..., 0]
               + torch.gather(counts, 1, idx).float())
        keep = pos < capacity
        gate_kept = torch.where(keep, gate_val, torch.zeros_like(gate_val))
        denom = denom + gate_kept
        pos_oh = _one_hot(pos.long(), capacity)                 # [G, S, C]
        combine = combine + (gate_kept[..., None, None]
                             * onehot[..., :, None] * pos_oh[..., None, :])
        counts = counts + torch.sum(onehot * keep[..., None].float(),
                                    dim=1).to(torch.int32)
        remaining = remaining * (1.0 - onehot)
    combine = combine / torch.clamp(denom[..., None, None], min=1e-9)
    dispatch = combine > 0.0
    me = gates.mean(dim=(0, 1))
    ce = _one_hot(picks[0], E).mean(dim=(0, 1))
    aux: Dict[str, torch.Tensor] = {"l_aux": torch.sum(me * ce) * E}
    if cfg.z_loss_weight:
        aux["l_zloss"] = (torch.logsumexp(logits.float(), dim=-1) ** 2
                          ).mean()
    aux["expert_load"] = counts.float().mean(dim=0) / max(S, 1)
    return combine, dispatch, aux


class _AllToAll(torch.autograd.Function):
    """JAX's tiled ``all_to_all`` over an axis (dim 0 split and
    concatenated); its adjoint is the same exchange."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return comm.all_to_all(x, axis, split_dim=0, concat_dim=0,
                               log_name="moe_all_to_all")

    @staticmethod
    def backward(ctx, g):
        return comm.all_to_all(g.contiguous(), ctx.axis, split_dim=0,
                               concat_dim=0,
                               log_name="moe_all_to_all_grad"), None


class _TokenMean(torch.autograd.Function):
    """The mean of a statistic over the token ranks; every rank's loss
    reads the mean, so the adjoint averages the ranks' gradients (each
    rank's gates get the whole loss's gradient, which the engine's mean
    over the ranks then weighs as JAX's global mean does)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return comm.all_reduce(x, axis, op="mean", log_name="moe_stats")

    @staticmethod
    def backward(ctx, g):
        g = comm.all_reduce(g.contiguous(), ctx.axis, op="mean",
                            log_name="moe_stats_grad")
        if "sp" in ctx.axis:
            # the engine sums the gradients over sp (each sp rank's is its
            # part) where it averages them over the data ranks
            g = g / _mesh().shape["sp"]
        return g, None


class _GatherExperts(torch.autograd.Function):
    """This rank's E/ep experts of a stack gathered whole over ep (dim 0);
    the gradient reduce-scatters back to this rank's experts (summed over
    the ep ranks)."""

    @staticmethod
    def forward(ctx, w):
        return comm.all_gather(w.contiguous(), "ep", gather_dim=0)

    @staticmethod
    def backward(ctx, g):
        return comm.reduce_scatter(g.contiguous(), "ep", scatter_dim=0)


def _mesh():
    from deepspeed_tpu_torch.parallel import topology

    return topology._GLOBAL_MESH


def _mesh_sizes() -> Dict[str, int]:
    mesh = _mesh()
    return dict(mesh.shape) if mesh is not None else {}


def _stat_axes(sizes: Dict[str, int]) -> Tuple[str, ...]:
    """The token ranks the routing statistics average over: the data
    axes with ranks, and the sp ranks (each holds a sequence block)."""
    if sharding.sp_size() > 1:
        return tuple(TOKEN_AXES) + ("sp",)
    return tuple(a for a in TOKEN_AXES if sizes.get(a, 1) > 1)


# data axes whose ranks hold the same tokens (a pipeline microbatch that
# does not split over them): the dropless dispatch places its tokens
# over them by the sequence, as JAX's dispatch places a batch that its
# token axes cannot split
_REPLICATED: Tuple[str, ...] = ()


@contextlib.contextmanager
def replicated_tokens(axes):
    """Within: ``axes``' ranks hold the same tokens (``parallel/
    pipeline.py``'s microbatches)."""
    global _REPLICATED
    prev, _REPLICATED = _REPLICATED, tuple(axes)
    try:
        yield
    finally:
        _REPLICATED = prev


def _seq_placement(S: int, axes, sizes: Dict[str, int]):
    """(the axes of ``axes`` the sequence splits over, greedy in JAX's
    order, the others)."""
    seq, prod = [], 1
    for a in TOKEN_AXES:
        sz = sizes.get(a, 1)
        if a in axes and sz > 1 and S % (prod * sz) == 0:
            seq.append(a)
            prod *= sz
    return tuple(seq), tuple(a for a in axes if a not in seq)


def _grouped_unsupported_reason(cfg: GateConfig) -> Optional[str]:
    """Why the grouped path cannot run on the current mesh (None: it
    can): experts that do not divide over ep. JAX's other reason, qgZ's
    per-group gradients on a mesh with token ranks, is the engine's: it
    resolves ``moe_impl="einsum"`` and ``group_stats`` onto the model's
    config at build (``runtime/engine.py``)."""
    ep = _mesh_sizes().get("ep", 1)
    if ep > 1 and cfg.num_experts % ep:
        return f"num_experts={cfg.num_experts} not divisible by ep={ep}"
    return None


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


def _ep_capacity(m0: int, ep: int, cfg: GateConfig, train: bool) -> int:
    """Static per-(source, destination) row budget of the expert
    all-to-all. drop_tokens=False: the true worst case (every local row
    to one owner). With drop_tokens the capacity pools at the owner's
    level; the rounding up to 128 rows is JAX's, and it decides which
    rows drop, so it is kept."""
    if cfg.drop_tokens:
        factor = cfg.capacity_factor if train else cfg.eval_capacity_factor
        cap = int(-(-factor * m0 // ep))                    # ceil
        cap = max(cap, cfg.min_capacity)
        cap = min(cap, m0)
    else:
        cap = m0
    return ((cap + 127) // 128) * 128


def _sum_over_k(t: torch.Tensor, tokens: int, k: int) -> torch.Tensor:
    """[tokens * k, ...] rows (each token's k rows adjacent) summed over
    k in order: a fixed fold where JAX scatter-adds."""
    t = t.reshape(tokens, k, *t.shape[1:])
    acc = t[:, 0]
    for j in range(1, k):
        acc = acc + t[:, j]
    return acc


def _dropless_shard_core(x: torch.Tensor, router_w: torch.Tensor,
                         expert_params: Dict[str, torch.Tensor],
                         cfg: GateConfig, activation: str, *, ep: int = 1,
                         tp: int = 1, train: bool = True
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The dispatch of this rank's tokens: with ep = 1 rows sort by
    expert and run through the whole (local) expert stack; with ep > 1
    ``expert_params`` hold this rank's E/ep experts and rows travel to
    their owner's rank and back (the reference's dispatch / combine pair,
    sharded_moe.py:589-685). With tp > 1 the experts hold this rank's
    F/tp and the combine is summed over tp. Returns (out [B, S, H] in x's
    type, routing statistics)."""
    B, S, H = x.shape
    E, k = cfg.num_experts, cfg.top_k
    e_loc = E // ep
    if expert_params["wi"].shape[0] != e_loc:
        raise ValueError(f"expected {e_loc} experts per ep rank, got "
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
    if tp > 1:
        stats["dispatch_digest_mismatch"] = _digest_mismatch(flat_expert)
        # the experts see this rank's F/tp: the rows and the combine
        # weights enter the tp region (their gradients are partial sums)
        flat_x = sharding.tp_copy(flat_x)
        flat_w = sharding.tp_copy(flat_w)

    if ep > 1:
        out = _ep_dispatch(flat_x, flat_expert, flat_w, token_idx,
                           expert_params, cfg, activation, ep, train, stats)
        return sharding.tp_reduce(out).to(dt).reshape(B, S, H), stats

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
    out = sharding.tp_reduce(out)  # the F/tp partials (fp32)
    return out.to(dt).reshape(B, S, H), stats


_DIGEST_MUL = 2654435761
_DIGEST_ADD = 12345


def _digest_mismatch(flat_expert: torch.Tensor) -> torch.Tensor:
    """1.0 where the tp ranks' routing digests differ, else 0.0 ([1]
    fp32): JAX's uint32 sum of ``expert * (row * 2654435761 + 12345)``,
    its max against its min over tp."""
    rows = torch.arange(flat_expert.numel(), device=flat_expert.device)
    weight = (rows * _DIGEST_MUL + _DIGEST_ADD) % (1 << 32)
    dig = ((flat_expert.long() * weight).sum() % (1 << 32)).reshape(1)
    hi = comm.all_reduce(dig, "tp", op="max", log_name="moe_digest")
    lo = comm.all_reduce(dig, "tp", op="min", log_name="moe_digest")
    return (hi != lo).float()


def _ep_dispatch(flat_x, flat_expert, flat_w, token_idx, expert_params,
                 cfg: GateConfig, activation: str, ep: int, train: bool,
                 stats) -> torch.Tensor:
    """The ep > 1 branch of JAX's ``_dropless_shard_core``: packed send
    buffers [ep * cap, H] with local-expert tags (0 = a padding slot),
    rows filling each destination's budget in row order, two all-to-alls
    over ep around the local grouped-GEMM FFN. Returns [tokens, H] fp32."""
    tokens, H = flat_x.shape
    k = cfg.top_k
    m0 = tokens * k
    dt, dev = flat_x.dtype, flat_x.device
    e_loc = cfg.num_experts // ep
    dest = torch.div(flat_expert, e_loc, rounding_mode="floor")
    cap = _ep_capacity(m0, ep, cfg, train)
    oh = (dest[:, None] == torch.arange(ep, device=dev)[None, :]).to(
        torch.int64)
    pos = torch.gather(torch.cumsum(oh, dim=0) - oh, 1, dest[:, None])[:, 0]
    keep = pos < cap
    pos_c = torch.clamp(pos, max=cap - 1)
    kf = keep.to(dt)
    keep_f = keep.float()
    # the combine weights renormalized over each token's kept rows
    kept_mass = _sum_over_k(flat_w * keep_f, tokens, k)
    flat_w = flat_w * keep_f / torch.clamp(kept_mass[token_idx], min=1e-9)
    slot = dest * cap + pos_c
    rows_x = flat_x[token_idx] * kf[:, None]                 # [m0, H]
    send_x = torch.zeros((ep * cap, H), dtype=dt, device=dev).index_add(
        0, slot, rows_x)
    tag = (flat_expert % e_loc + 1) * keep
    send_tag = torch.zeros(ep * cap, dtype=torch.int64,
                           device=dev).index_add_(0, slot, tag)
    recv_x = _AllToAll.apply(send_x, "ep")
    recv_tag = comm.all_to_all(send_tag, "ep", split_dim=0, concat_dim=0,
                               log_name="moe_all_to_all_tags")
    m_rows = ep * cap
    valid = recv_tag > 0
    local_e = torch.where(valid, recv_tag - 1,
                          torch.full_like(recv_tag, e_loc - 1))
    order = torch.argsort(local_e, stable=True)
    sorted_x = recv_x[order]
    group_sizes = torch.zeros(e_loc, dtype=torch.int32,
                              device=dev).scatter_add_(
        0, local_e, torch.ones(m_rows, dtype=torch.int32, device=dev))
    expert_out = _expert_ffn(sorted_x, group_sizes, expert_params,
                             activation, dt)             # [m_rows, H]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(m_rows, device=dev)
    unsorted = expert_out[inverse]
    back = _AllToAll.apply(unsorted, "ep")
    out_rows = back[slot] * kf[:, None]                      # [m0, H]
    contrib = out_rows.float() * flat_w[:, None]
    stats["ep_dropped_frac"] = ((~keep).sum().float() / max(m0, 1))[None]
    return _sum_over_k(contrib, tokens, k)


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


_STAT_KEYS = ("me", "ce", "zsq", "expert_load", "ep_dropped_frac",
              "dispatch_digest_mismatch")


def token_placement(B: int, S: int, sizes: Dict[str, int]):
    """JAX's placement of a [B, S] batch on the token axes: (the axes the
    batch dim shards over, the axes the sequence dim shards over, the
    axes with ranks that place nothing: their ranks hold copies)."""
    batch_axes, prod = [], 1
    for a in TOKEN_AXES:
        sz = sizes.get(a, 1)
        if sz > 1 and B % (prod * sz) == 0:
            batch_axes.append(a)
            prod *= sz
    seq_axes, sprod = [], 1
    for a in TOKEN_AXES:
        sz = sizes.get(a, 1)
        if sz > 1 and a not in batch_axes and S % (sprod * sz) == 0:
            seq_axes.append(a)
            sprod *= sz
    placed = set(batch_axes) | set(seq_axes)
    unplaced = [a for a in TOKEN_AXES
                if sizes.get(a, 1) > 1 and a not in placed]
    return tuple(batch_axes), tuple(seq_axes), tuple(unplaced)


def _slice_tokens(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    mesh = _mesh()
    if not axes:
        return x
    n = mesh.axis_size(axes)
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axes) * size, size)


class _GatherTokens(torch.autograd.Function):
    """The token shards back into the global batch (tiled all-gather);
    the adjoint keeps this rank's slice of the gradient, summed over the
    ranks that hold the same tokens."""

    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return comm.all_gather(x.contiguous(), axes, gather_dim=dim,
                               log_name="moe_tokens")

    @staticmethod
    def backward(ctx, g):
        return _slice_tokens(g, ctx.axes, ctx.dim).contiguous(), None, None


def moe_ffn_dropless(x: torch.Tensor, router_w: torch.Tensor,
                     expert_params: Dict[str, torch.Tensor], cfg: GateConfig,
                     activation: str = "swiglu", train: bool = True,
                     global_tokens: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dropless MoE FFN via grouped GEMMs: exactly top_k expert FFNs per
    token, no capacity padding, FLOPs independent of routing imbalance.

    Without a mesh (or one rank) it is JAX's ``mesh is None`` branch.
    On a mesh, ``x`` is this rank's tokens and the experts are this
    rank's E/ep (JAX's shard_map body), and the routing statistics are
    averaged over the token ranks. ``global_tokens=True``: ``x`` is the
    whole batch on every rank; the rank takes JAX's shard of it (batch
    axes first, then the sequence), and the output is the whole batch
    again."""
    mesh = _mesh()
    sizes = _mesh_sizes()
    ep, tp = sizes.get("ep", 1), sizes.get("tp", 1)
    axes = _stat_axes(sizes)
    if mesh is None or (not axes and tp == 1):
        out, stats = _dropless_shard_core(x, router_w, expert_params, cfg,
                                          activation, train=train)
        return out, _aux_from_stats(stats, cfg)
    if ep > 1 and cfg.num_experts % ep:
        raise ValueError(
            f"moe_ffn_dropless: num_experts={cfg.num_experts} must divide "
            f"over ep={ep}")
    batch_axes = seq_axes = ()
    if global_tokens:
        batch_axes, seq_axes, unplaced = token_placement(
            x.shape[0], x.shape[1], sizes)
        if unplaced:
            from deepspeed_tpu_torch.utils import telemetry

            telemetry.count(
                "moe.grouped_replicated_tokens",
                f"batch {x.shape[0]}x{x.shape[1]} not shardable over all "
                f"token axes { {a: sizes.get(a, 1) for a in TOKEN_AXES} }")
        x = _slice_tokens(_slice_tokens(x, batch_axes, 0), seq_axes, 1)
    elif _REPLICATED:
        seq_axes, unplaced = _seq_placement(x.shape[1], _REPLICATED, sizes)
        if unplaced:
            from deepspeed_tpu_torch.utils import telemetry

            telemetry.count(
                "moe.grouped_replicated_tokens",
                f"batch {x.shape[0]}x{x.shape[1]} not shardable over all "
                f"token axes { {a: sizes.get(a, 1) for a in TOKEN_AXES} }")
        x = _slice_tokens(x, seq_axes, 1)
    out, stats = _dropless_shard_core(x, router_w, expert_params, cfg,
                                      activation, ep=ep, tp=tp, train=train)
    if axes:
        stats = {key: _TokenMean.apply(v, axes) for key, v in stats.items()}
    if global_tokens:
        if seq_axes:
            out = _GatherTokens.apply(out, seq_axes, 1)
        if batch_axes:
            out = _GatherTokens.apply(out, batch_axes, 0)
    elif seq_axes:  # each rank's part of the copies' cotangent
        out = sharding.gather_sum(out, seq_axes, 1, "moe_tokens")
    return out, _aux_from_stats(stats, cfg)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor,
            expert_params: Dict[str, torch.Tensor], cfg: GateConfig,
            activation: str = "swiglu", train: bool = True,
            impl: str = "auto", group_stats: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full MoE FFN block. x: [B, S, H]; router_w: [H, E];
    expert_params: wi/wo(/wg) with leading expert dim [E, ...].

    ``impl``: "einsum" is the capacity-padded GShard dispatch (drops
    overflow tokens, pads underflow: fixed E x C FLOPs); "grouped" the
    dropless grouped-GEMM path; "auto" the grouped path wherever it runs
    (everywhere but E % ep != 0, where it falls back to einsum with a
    ``moe.grouped_fallback`` count; "grouped" raises there).
    ``group_stats``: the einsum path's loss reads this batch group's own
    routing statistics, not their mean over the token ranks (the engine
    sets it, with "einsum", under qgZ's per-group gradients)."""
    if impl not in ("auto", "grouped", "einsum"):
        raise ValueError(f"unknown moe impl {impl!r}; known: auto, "
                         "grouped, einsum")
    if impl in ("auto", "grouped"):
        reason = _grouped_unsupported_reason(cfg)
        if reason is None:
            return moe_ffn_dropless(x, router_w, expert_params, cfg,
                                    activation=activation, train=train)
        if impl == "grouped":
            raise ValueError(
                f"moe_ffn: impl='grouped' is unsupported on this mesh: "
                f"{reason} (use impl='auto' to allow the einsum fallback)")
        from deepspeed_tpu_torch.utils import telemetry

        telemetry.count("moe.grouped_fallback", reason)
    return _moe_ffn_einsum(x, router_w, expert_params, cfg, activation,
                           train, group_stats)


def _moe_ffn_einsum(x, router_w, expert_params, cfg: GateConfig,
                    activation: str, train: bool, group_stats: bool):
    """JAX's capacity-padded dispatch: [B, S, H] x [B, S, E, C] ->
    [B, E, C, H], the expert FFN as einsums, the combine back. Under ep
    the expert stack is gathered over the ep ranks (the gradient
    reduce-scatters back to each rank's E/ep)."""
    dt = x.dtype
    S = x.shape[1]
    logits = torch.einsum("bsh,he->bse", x, router_w.to(dt))
    capacity = compute_capacity(S, cfg, train=train)
    combine, dispatch, aux = top_k_gating(logits, cfg, capacity)
    # at tp > 1 the experts hold F/tp: their input and the combine
    # weights enter the tp region, the combine leaves it summed
    dispatched = sharding.tp_copy(
        torch.einsum("bsh,bsec->bech", x, dispatch.to(dt)))
    ep = _mesh_sizes().get("ep", 1)

    def expert(name):
        w = expert_params[name]
        if w.shape[0] != cfg.num_experts and ep > 1:
            w = _GatherExperts.apply(w)
        return w.to(dt)

    wi, wo = expert("wi"), expert("wo")
    if activation == "swiglu":
        wg = expert("wg")
        gate = torch.einsum("bech,ehf->becf", dispatched, wg)
        up = torch.einsum("bech,ehf->becf", dispatched, wi)
        hidden = F.silu(gate) * up
    else:
        hidden = F.gelu(torch.einsum("bech,ehf->becf", dispatched, wi),
                        approximate="tanh")
    expert_out = torch.einsum("becf,efh->bech", hidden, wo)
    out = sharding.tp_reduce(torch.einsum(
        "bech,bsec->bsh", expert_out, sharding.tp_copy(combine.to(dt))))
    token_ranks = _stat_axes(_mesh_sizes())
    if token_ranks and not group_stats:
        # the gate's statistics over the token ranks, JAX's global batch
        gates = torch.softmax(logits.float(), dim=-1)
        stats = {"me": gates.mean(dim=(0, 1)),
                 "ce": _one_hot(torch.argmax(gates, dim=-1),
                                cfg.num_experts).mean(dim=(0, 1)),
                 "zsq": (torch.logsumexp(logits.float(), dim=-1) ** 2
                         ).mean()[None],
                 "expert_load": aux["expert_load"]}
        stats = {key: _TokenMean.apply(v, token_ranks)
                 for key, v in stats.items()}
        aux = _aux_from_stats(stats, cfg)
    return out, aux


__all__ = ["GateConfig", "compute_capacity", "top_k_gating", "top_k",
           "moe_ffn", "moe_ffn_dropless", "token_placement", "TOKEN_AXES",
           "replicated_tokens"]
