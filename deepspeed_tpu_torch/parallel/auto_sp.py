"""AutoSP: sequence-parallel planning, Ulysses x ring x FPDT (port of
``deepspeed_tpu/parallel/auto_sp.py``; pure functions, the same
decisions on the same inputs).

``detect_sp_strategy`` picks Ulysses when the query and KV heads divide
over sp, else the ring; ``auto_wrap_model_for_sp`` turns a zoo model's
``sequence_parallel`` on with that strategy; ``plan_sequence_parallel``
composes the strategy, the FPDT chunk count of the local shard, the
host-KV spill against an HBM budget and an ``overlap_depth`` hint into
an :class:`SPPlan`, whose ``apply`` changes only the config fields still
at their defaults. The engine applies the plan at init under JAX's
opt-in rule (an sp axis > 1, and the model's ``sequence_parallel`` or
``sequence_parallel.size`` > 1, unless ``auto_plan`` is False). A plan
that spills the KV to the host together with sp asks for FPDT over the
sp ranks, which the model refuses (``parallel/fpdt.py``'s ``_A11_SP``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

from deepspeed_tpu_torch.utils.logging import log_dist, logger


def detect_sp_strategy(num_heads: int, num_kv_heads: Optional[int],
                       sp_size: int) -> Optional[str]:
    """'ulysses' | 'ring' | None (sp off). The head-scatter all-to-all
    needs heads divisible by (or at least ≥) sp; GQA KV heads bound it
    (reference uneven_heads_all2all handles remainders — here the ring
    path covers that regime outright)."""
    if sp_size <= 1:
        return None
    kv = num_kv_heads or num_heads
    if num_heads % sp_size == 0 and kv % sp_size == 0:
        return "ulysses"
    # heads indivisible by (or fewer than) sp: ulysses would pad or
    # starve ranks of heads — ring shards the sequence dim instead
    return "ring"


def auto_wrap_model_for_sp(model, mesh=None, force: Optional[str] = None):
    """Enable sequence parallelism on a zoo model when the mesh has an sp
    axis (reference auto_wrap_model_for_sp sequence/auto_sp.py:42).

    Returns the model (a new instance when the config changed). ``force``
    overrides the detected strategy ('ulysses'/'ring').
    """
    from deepspeed_tpu_torch.parallel import topology

    mesh = mesh or topology._GLOBAL_MESH
    sp = int(mesh.shape.get("sp", 1)) if mesh is not None else 1
    cfg = getattr(model, "config", None)
    if cfg is None or not hasattr(cfg, "num_heads"):
        logger.warning("auto_sp: model has no head config; left unchanged")
        return model
    strategy = force or detect_sp_strategy(
        cfg.num_heads, getattr(cfg, "num_kv_heads", None), sp)
    if strategy is None:
        if getattr(cfg, "sequence_parallel", False):
            cfg = dataclasses.replace(cfg, sequence_parallel=False)
            return _with_config(model, cfg)
        return model
    new_cfg = dataclasses.replace(cfg, sequence_parallel=True,
                                  sp_mode=strategy)
    log_dist(f"auto_sp: sp={sp} heads={cfg.num_heads}/"
             f"{getattr(cfg, 'num_kv_heads', None) or cfg.num_heads} → "
             f"{strategy}", ranks=[0])
    return _with_config(model, new_cfg)


def _with_config(model, cfg):
    """A model object on ``cfg`` holding ``model``'s weights (JAX's model
    objects hold no weights, so there a new instance of the config
    suffices)."""
    new = copy.copy(model)
    new.config = cfg
    return new


# ---------------------------------------------------------------------------
# the unified long-context planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SPPlan:
    """A composed sequence-parallel plan.

    ``strategy`` is the sp attention mechanism ('ulysses' | 'ring' |
    None when sp is off); ``attn_chunks`` the FPDT q-chunk count (0 =
    unchunked); ``fpdt_host_kv`` whether the KV tile stacks spill to
    pinned host memory (utils/memspace.py — identity placement on
    single-memory backends); ``overlap_depth_hint`` how many chunk
    stages of host-KV streaming the overlap engine should pin behind
    compute (0 = no hint). ``reasons`` carries the human-readable
    decision trail for logs and the bench JSON line.
    """

    strategy: Optional[str]
    sp_degree: int
    attn_chunks: int
    fpdt_host_kv: bool
    fpdt_host_residual: bool = False
    overlap_depth_hint: int = 0
    reasons: Tuple[str, ...] = ()

    def apply(self, cfg):
        """Compose the plan onto a TransformerConfig, conservatively:
        only fields still at their defaults change, so an explicit user
        choice (sp_mode, attn_chunks, fpdt_host_kv, overlap_depth) is
        never overridden. Returns a new config (or ``cfg`` unchanged)."""
        updates = {}
        if self.strategy is not None \
                and not getattr(cfg, "sequence_parallel", False):
            updates["sequence_parallel"] = True
            updates["sp_mode"] = self.strategy
        if self.attn_chunks > 1 \
                and getattr(cfg, "attn_chunks", 0) in (0, 1):
            updates["attn_chunks"] = self.attn_chunks
        if self.fpdt_host_kv and not getattr(cfg, "fpdt_host_kv", False):
            updates["fpdt_host_kv"] = True
        if self.overlap_depth_hint \
                and not getattr(cfg, "overlap_depth", 0) \
                and hasattr(cfg, "overlap_depth"):
            updates["overlap_depth"] = self.overlap_depth_hint
        if not updates:
            return cfg
        return dataclasses.replace(cfg, **updates)


def _sp_degree_of(mesh) -> int:
    """sp degree from a Mesh, a bare int (bench/CLI convenience — plan
    for a simulated degree without building a device mesh), or None."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return max(1, int(mesh))
    shape = getattr(mesh, "shape", None)
    if shape is None:
        return 1
    return int(dict(shape).get("sp", 1))


def _pick_chunks(s_loc: int, target_tokens: int) -> int:
    """Smallest power-of-2 chunk count dividing ``s_loc`` whose chunk
    length is ≤ ``target_tokens`` — power-of-2 so the grid keeps
    dividing under further sp resharding, and a divisor of s_loc so the
    sp composition stays pad-free."""
    c = 1
    while s_loc // c > target_tokens and s_loc % (c * 2) == 0:
        c *= 2
    return c


# With no HBM budget given, chunk so one q-chunk stays at most this many
# tokens — the regime where the [C × kv_tile] fp32 score block (not the
# residual) stops dominating peak memory.
_DEFAULT_CHUNK_TOKENS = 4096


def plan_sequence_parallel(seq_len: int, num_heads: int,
                           num_kv_heads: Optional[int], mesh=None,
                           hbm_budget: Optional[int] = None, *,
                           head_dim: int = 128,
                           hidden_size: Optional[int] = None,
                           batch_size: int = 1,
                           dtype_bytes: int = 2) -> SPPlan:
    """Compose a long-context plan for one step shape.

    ``mesh`` may be a device Mesh (sp degree read from its 'sp' axis),
    a bare int degree, or None. ``hbm_budget`` is per-chip bytes
    available for activations; None plans without spill pressure (the
    deterministic no-budget plan). Pure function — no device access.

    Decision order: (1) sp degree and strategy from the mesh and head
    layout (`detect_sp_strategy`); (2) FPDT chunk count so one chunk's
    fp32 score block fits the budget slice (power-of-2 divisor of the
    LOCAL shard — the sp composition is pad-free); (3) host-KV spill
    when the full-sequence KV stacks at kv_heads width would eat more
    than a quarter of the budget; (4) overlap_depth hint = chunk stages
    the overlap engine can pin the host KV stream behind.
    """
    sp = _sp_degree_of(mesh)
    kv = num_kv_heads or num_heads
    hidden = hidden_size or num_heads * head_dim
    strategy = detect_sp_strategy(num_heads, num_kv_heads, sp)
    s_loc = -(-seq_len // sp)
    reasons = []
    if strategy is None:
        reasons.append(f"sp={sp}: sequence parallelism off")
    else:
        reasons.append(
            f"sp={sp} heads={num_heads}/{kv} → {strategy} "
            + ("(head-scatter divides)" if strategy == "ulysses"
               else "(heads indivisible by sp → ring)"))

    # (2) chunk grid — local shard, pad-free divisors only
    if hbm_budget is not None:
        # one chunk's score block is B·N·C² fp32; budget a sixteenth
        target = max(int((hbm_budget
                          / (16.0 * 4.0 * batch_size * num_heads)) ** 0.5),
                     256)
    else:
        target = _DEFAULT_CHUNK_TOKENS
    chunks = _pick_chunks(s_loc, target)

    # (3) host-KV spill: the composed path's device transient is the
    # sp-gathered full-S KV at kv_heads width; spill when it crowds HBM
    kv_bytes = 2 * batch_size * seq_len * kv * head_dim * dtype_bytes
    spill = hbm_budget is not None and kv_bytes > hbm_budget // 4
    if spill:
        reasons.append(
            f"KV stacks {kv_bytes / 2**30:.2f} GiB > budget/4 "
            f"(budget {hbm_budget / 2**30:.2f} GiB) → fpdt_host_kv")
        if chunks < 2:
            if sp <= 1 or s_loc % 2 == 0:
                chunks = 2  # the fpdt path needs ≥ 2 q chunks
            else:
                spill = False
                reasons.append(
                    f"local shard {s_loc} has no even chunk grid — "
                    "cannot stream host KV pad-free under sp; spill off")
    elif hbm_budget is not None:
        reasons.append(
            f"KV stacks {kv_bytes / 2**30:.2f} GiB fit on device "
            "(no spill)")
    if chunks > 1:
        reasons.append(
            f"attn_chunks={chunks} (local shard {s_loc} → "
            f"{s_loc // chunks}-token chunks ≤ target {target})")

    if spill:
        from deepspeed_tpu_torch.utils import memspace

        if not memspace.memories_supported():
            reasons.append(
                "host spill degrades to device placement on this "
                "single-memory backend (a CPU build) — placement semantics "
                "and numerics preserved")

    # (4) overlap interplay: each q chunk's KV refetch is a pinnable
    # stage for the overlap engine, like the param-stream ring
    overlap_hint = min(4, chunks) if spill and chunks > 1 else 0
    if overlap_hint:
        reasons.append(
            f"overlap_depth={overlap_hint}: pin host-KV chunk streams "
            "behind per-chunk attention compute")

    residual_bytes = batch_size * s_loc * hidden * dtype_bytes
    if hbm_budget is not None and residual_bytes > hbm_budget // 4:
        reasons.append(
            f"NOTE: per-layer residual {residual_bytes / 2**30:.2f} GiB "
            "also crowds the budget — consider fpdt_host_residual "
            "(single-chip only; does not compose with sp)")

    return SPPlan(strategy=strategy, sp_degree=sp,
                  attn_chunks=chunks if chunks > 1 else 0,
                  fpdt_host_kv=spill,
                  overlap_depth_hint=overlap_hint,
                  reasons=tuple(reasons))
