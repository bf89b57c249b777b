"""Quantization-error and wire-bytes telemetry for ZeRO++, the engine
part (port of ``deepspeed_tpu/observability/quant_stats.py``).

The closed-form error metrics (``snr_db``, ``max_rel_error``: the
blockwise peak relative error, <= 0.5/qmax for round-to-nearest;
``scale_summary``), the quantize / dequantize replica of the runtime
math (``qdq_blockwise``), the wire-bytes model (``wire_bytes``: the
integer payload plus one fp32 scale a block, shared with
``observability/attribution.attribute_quant_step``), the per-region
measures (``measure_*`` on real tensors), the export (``quant.*`` hub
gauges and counters, one ``quant_stats`` event, a flight-recorder dump
context), ``collection_configured`` (``observability.quant_stats``), the engine's init-time collector and the
acceptance gates. The quant bench (``run_quant_bench`` and its helpers)
goes with ROADMAP queue A item 15's ``tools/quant_sweep.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import torch

from deepspeed_tpu_torch.runtime.optimizer import leaves as _tree_leaves

# the regions every quantized path reports under (quant.<region>.*)
QUANT_REGIONS = ("qwz_param_fetch", "qgz_grad_reduce", "hpz_partition",
                 "fp8_mlp", "kv_cache", "kv_wire", "qar")

# int8 blockwise RTN peak-rel-error bound is 0.5/127 ~= 0.00394; int4 is
# 0.5/7 ~= 0.0714; fp8 e4m3 has 3 mantissa bits -> rel step 2^-4 with
# round-to-nearest half that. The two-level qgZ composition stacks G
# int8 errors plus one int4 re-quantization of a partial sum, so its
# gate sits at ~2x the int4 bound. A corrupted scale (injection) lands
# at ~0.25 rel err — beyond every gate by construction.
DEFAULT_GATES: Dict[str, Dict[str, float]] = {
    "qwz_param_fetch": {"min_snr_db": 30.0, "max_rel_err": 0.005},
    "qgz_grad_reduce": {"min_snr_db": 15.0, "max_rel_err": 0.15},
    "fp8_mlp": {"min_snr_db": 18.0, "max_rel_err": 0.05},
    # hpZ changes which link the gather rides, never the values
    "hpz_partition": {"bit_exact": True},
    # int8 KV blocks: one scale per head_dim vector, so the RTN bound is
    # the plain int8 one (0.5/127)
    "kv_cache": {"min_snr_db": 30.0, "max_rel_err": 0.005},
    # the handoff wire may run int4 (0.5/7 ~= 0.0714 bound)
    "kv_wire": {"min_snr_db": 18.0, "max_rel_err": 0.08},
    # quantized all-reduce stacks two int8 hops (scatter + gather);
    # real grad tensors carry many near-zero blocks whose clamped
    # scales dominate the worst-case element, so the rel-err bound is
    # looser than the single-hop paths
    "qar": {"min_snr_db": 25.0, "max_rel_err": 0.03},
}

def _f32(x) -> torch.Tensor:
    """A flattened fp32 host copy of a tensor or array."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t.detach().float().reshape(-1).cpu()


# -- fault injection (the gate-trip demo) -----------------------------------
# corrupt_scale: multiply the first block's scale by 64 before
# quantizing — the dequantized block lands on a 64x-coarser grid, so
# max_rel_error jumps ~0.004 -> ~0.25 and every SNR gate fails. Armed
# by set_injection().
_INJECT: Optional[str] = None
INJECTION_MODES = ("corrupt_scale",)


def set_injection(mode: Optional[str]) -> None:
    global _INJECT
    if mode is not None and mode not in INJECTION_MODES:
        raise ValueError(f"unknown quant injection {mode!r} "
                         f"(choose from {INJECTION_MODES})")
    _INJECT = mode


# -- closed-form error metrics ----------------------------------------------


def snr_db(ref, approx) -> float:
    """Signal-to-noise ratio in dB: 10*log10(sum ref^2 / sum err^2).

    inf when the error is exactly zero (bit-exact path); -inf when the
    reference is zero but the approximation is not.
    """
    r = _f32(ref)
    e = _f32(approx) - r
    sig = float(torch.sum(r * r))
    noise = float(torch.sum(e * e))
    if noise == 0.0:
        return float("inf")
    if sig == 0.0:
        return float("-inf")
    return 10.0 * math.log10(sig / noise)


def max_rel_error(ref, approx, block: int = 0) -> float:
    """Blockwise peak relative error: max over blocks of
    (max |err| in block) / (max |ref| in block).

    This is the quantity symmetric round-to-nearest bounds in closed
    form: |err| <= scale/2 = max|ref|/(2*qmax) per block, so int8 RTN
    satisfies max_rel_error <= 0.5/127 exactly — the gates assert it.
    ``block`` 0 treats the whole tensor as one block. All-zero blocks
    contribute 0 (the runtime clamps their scale to 1 and emits zeros).
    """
    r = _f32(ref)
    e = torch.abs(_f32(approx) - r)
    n = r.numel()
    b = int(block) if block and n % int(block) == 0 else n
    if not n:
        return 0.0
    ra = torch.abs(r.reshape(-1, b)).amax(dim=1)
    ea = e.reshape(-1, b).amax(dim=1)
    safe = torch.where(ra > 0, ra, torch.ones_like(ra))
    rel = torch.where(ra > 0, ea / safe, torch.zeros_like(ra))
    return float(rel.max())


def scale_summary(scales) -> Dict[str, float]:
    """Distribution summary of the blockwise scales: min/max/mean plus
    the fraction of blocks whose scale was clamped to 1.0 (all-zero
    blocks — a high fraction means the block size is wasted on
    padding/dead weights)."""
    s = _f32(scales)
    if s.numel() == 0:
        return {"n_blocks": 0, "min": 0.0, "max": 0.0, "mean": 0.0,
                "clamped_frac": 0.0}
    return {"n_blocks": int(s.numel()),
            "min": float(s.min()), "max": float(s.max()),
            "mean": float(s.mean()),
            "clamped_frac": float((s == 1.0).float().mean())}


# -- quantize/dequantize replicas of the runtime math -----------------------


def qdq_blockwise(x, block: int, bits: int = 8):
    """Blockwise symmetric quantize→dequantize of a flattened tensor —
    the same math ``sharding.quantized_param_fetch`` (int8, QWZ_BLOCK)
    and ``qgz._quant`` (int8/int4, QGZ_BLOCK) trace, run eagerly for
    measurement. Returns (dequantized fp32 [n], scales fp32 [n_blocks]).

    The effective block is gcd(n, block), mirroring the runtime's
    must-tile rule; block <= 1 falls back to the exact path (identity,
    no scales) exactly as the runtime does for unblockable leaves.
    Honors the armed fault injection (see :func:`set_injection`).
    """
    f = _f32(x)
    n = int(f.numel())
    b = math.gcd(n, int(block)) if block else 0
    if b <= 1 or n == 0:
        return f, torch.zeros((0,), dtype=torch.float32)
    qmax = float(2 ** (int(bits) - 1) - 1)
    fb = f.reshape(n // b, b)
    s = torch.abs(fb).amax(dim=1) / torch.tensor(qmax)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    if _INJECT == "corrupt_scale":
        s = s.clone()
        s[0] *= 64.0
    q = torch.round(fb / s[:, None])  # int8 / int4 values, exact in fp32
    deq = (q * s[:, None]).reshape(-1)
    return deq, s


def wire_bytes(n_elems: int, bits: int, block: int,
               scale_bytes: int = 4) -> int:
    """Bytes one quantized tensor puts on the wire: the integer payload
    plus one fp32 scale per block (the runtime gathers/reshards scales
    alongside the payload). ``block`` <= 1 means the exact path — the
    caller should charge full-precision bytes instead."""
    if block <= 1:
        return n_elems * 4  # exact fp32 fallback path
    payload = math.ceil(n_elems * bits / 8)
    return payload + (n_elems // block) * scale_bytes


# -- per-region stats --------------------------------------------------------


@dataclasses.dataclass
class QuantRegionStats:
    """One quantized region's error + byte accounting."""

    region: str
    snr_db: Optional[float]          # None for bit-exact regions
    max_rel_err: float
    logical_bytes: int               # full-precision bytes the wire replaces
    wire_bytes: int                  # quantized payload + scales
    n_elements: int
    bits: int
    block: int
    scales: Dict[str, float] = dataclasses.field(default_factory=dict)
    bit_exact: bool = False
    note: str = ""

    @property
    def compression(self) -> float:
        return (self.logical_bytes / self.wire_bytes
                if self.wire_bytes else 1.0)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["compression"] = round(self.compression, 3)
        if self.snr_db is not None and math.isfinite(self.snr_db):
            d["snr_db"] = round(self.snr_db, 2)
        d["max_rel_err"] = (round(self.max_rel_err, 6)
                            if math.isfinite(self.max_rel_err)
                            else self.max_rel_err)
        return d


def _sample_leaves(tree, cap_elements: int) -> List[Any]:
    """Flattened >=2-D leaves, largest first, until ``cap_elements``
    total — bounded measurement cost on multi-billion-param trees.
    1-D leaves (norm scales, biases) ride the runtime's exact path and
    carry no quantization error to measure."""
    leaves = [x for _, x in _tree_leaves(tree)
              if hasattr(x, "ndim") and x.ndim >= 2]
    leaves.sort(key=lambda x: -x.numel())
    out, total = [], 0
    for x in leaves:
        if total >= cap_elements:
            break
        out.append(x)
        total += int(x.numel())
    return out


def measure_region(region: str, tensors: Sequence[Any], *, block: int,
                   bits: int = 8, full_bytes_per_elem: int = 2,
                   cap_elements: int = 1 << 22,
                   note: str = "") -> QuantRegionStats:
    """Quantize each tensor with the region's blockwise math and fold
    the error/byte accounting into one :class:`QuantRegionStats`."""
    sig = noise = 0.0
    worst_rel = 0.0
    n_elems = 0
    all_scales: List[Any] = []
    budget = int(cap_elements)
    for t in tensors:
        f = _f32(t)
        if budget <= 0:
            break
        if f.numel() > budget:
            f = f[: (budget // max(block, 1)) * max(block, 1) or budget]
        budget -= int(f.numel())
        deq, s = qdq_blockwise(f, block, bits)
        err = deq - f
        sig += float(torch.sum(f * f))
        noise += float(torch.sum(err * err))
        worst_rel = max(worst_rel, max_rel_error(f, deq, block))
        n_elems += int(f.numel())
        if s.numel():
            all_scales.append(s)
    if noise == 0.0:
        snr = float("inf")
    elif sig == 0.0:
        snr = float("-inf")
    else:
        snr = 10.0 * math.log10(sig / noise)
    scales = (scale_summary(torch.cat(all_scales))
              if all_scales else scale_summary(torch.zeros((0,))))
    return QuantRegionStats(
        region=region, snr_db=snr, max_rel_err=worst_rel,
        logical_bytes=n_elems * full_bytes_per_elem,
        wire_bytes=wire_bytes(n_elems, bits, block),
        n_elements=n_elems, bits=bits, block=block, scales=scales,
        note=note)


def measure_param_fetch(params, *, cap_elements: int = 1 << 22
                        ) -> QuantRegionStats:
    """qwZ region: int8/QWZ_BLOCK error on the model's real parameters
    (the tensors the stage-3 all-gather actually moves)."""
    from deepspeed_tpu_torch.runtime.sharding import QWZ_BLOCK

    return measure_region(
        "qwz_param_fetch", _sample_leaves(params, cap_elements),
        block=QWZ_BLOCK, bits=8, full_bytes_per_elem=2,
        cap_elements=cap_elements,
        note="int8 blockwise param all-gather wire (vs bf16)")


def measure_grad_reduce(grad_groups: Sequence[Any], *, bits1: int = 8,
                        bits2: Optional[int] = 4,
                        cap_elements: int = 1 << 22) -> QuantRegionStats:
    """qgZ region: two-level quantized group reduction error on REAL
    per-group gradients — each group's grad quantizes at ``bits1``
    (the fsdp all-to-all wire), partial sums re-quantize at ``bits2``
    (the dp level) when more than two groups, and the result compares
    against the exact fp32 group mean. Mirrors ``qgz._reduce_leaf``'s
    level structure without needing a multi-device mesh."""
    from deepspeed_tpu_torch.runtime.qgz import QGZ_BLOCK

    groups = list(grad_groups)
    if not groups:
        raise ValueError("measure_grad_reduce needs >= 1 gradient group")
    flats = [[t for _, t in _tree_leaves(g)] if isinstance(g, dict)
             else list(g) for g in groups]
    n_leaves = len(flats[0])
    sig = noise = 0.0
    worst_rel = 0.0
    n_elems = 0
    all_scales: List[Any] = []
    budget = int(cap_elements)
    # level split mirroring the mesh factorization: fsdp groups reduce
    # at bits1; when >2 groups the second half plays the dp level and
    # its partial sum re-quantizes at bits2 (the int4 hop)
    two_level = bits2 is not None and len(groups) > 2
    half = (len(groups) + 1) // 2 if two_level else len(groups)
    for i in range(n_leaves):
        leaves = [_f32(f[i]) for f in flats]
        size = int(leaves[0].numel())
        if budget <= 0:
            continue
        if torch.as_tensor(flats[0][i]).ndim < 2:
            continue  # 1-D leaves ride the exact path in the runtime
        budget -= size
        exact = sum(leaves) / len(leaves)
        acc = torch.zeros_like(leaves[0])
        lvl2: List[Any] = []
        for gi, leaf in enumerate(leaves):
            deq, s = qdq_blockwise(leaf, QGZ_BLOCK, bits1)
            if s.numel():
                all_scales.append(s)
            if two_level and gi >= half:
                lvl2.append(deq)
            else:
                acc = acc + deq
        if lvl2:
            partial = sum(lvl2)
            deq2, s2 = qdq_blockwise(partial, QGZ_BLOCK, bits2)
            if s2.numel():
                all_scales.append(s2)
            acc = acc + deq2
        approx = acc / len(leaves)
        err = approx - exact
        sig += float(torch.sum(exact * exact))
        noise += float(torch.sum(err * err))
        worst_rel = max(worst_rel,
                        max_rel_error(exact, approx, QGZ_BLOCK))
        n_elems += size
    if noise == 0.0:
        snr = float("inf")
    elif sig == 0.0:
        snr = float("-inf")
    else:
        snr = 10.0 * math.log10(sig / noise)
    scales = (scale_summary(torch.cat(all_scales))
              if all_scales else scale_summary(torch.zeros((0,))))
    # wire: every group's int8 payload crosses the fsdp a2a; the dp
    # level re-ships the partial at bits2 — per-chip accounting matches
    # attribute_quant_step's closed form
    wire = len(groups) * wire_bytes(n_elems, bits1, QGZ_BLOCK)
    if two_level:
        wire += wire_bytes(n_elems, int(bits2), QGZ_BLOCK)
    return QuantRegionStats(
        region="qgz_grad_reduce", snr_db=snr, max_rel_err=worst_rel,
        logical_bytes=len(groups) * n_elems * 4,
        wire_bytes=wire, n_elements=n_elems, bits=bits1, block=QGZ_BLOCK,
        scales=scales,
        note=(f"int{bits1} group a2a"
              + (f" + int{bits2} second level" if two_level else "")
              + f" over {len(groups)} groups (vs fp32 reduce)"))


def measure_fp8_mlp(params, *, cap_elements: int = 1 << 22
                    ) -> QuantRegionStats:
    """fp8 MLP region: e4m3 per-tensor quantization error on the real
    weight matrices the opt-in fp8 GEMMs (ops/fp_quantizer
    fp8_matmul_ste) would quantize."""
    from deepspeed_tpu_torch.ops.fp_quantizer import _FMT_MAX

    tensors = _sample_leaves(params, cap_elements)
    sig = noise = 0.0
    worst_rel = 0.0
    n_elems = 0
    for t in tensors:
        f = _f32(t)
        amax = torch.abs(f).max()
        s = torch.where(amax > 0, amax / torch.tensor(_FMT_MAX["e4m3"]),
                        torch.ones_like(amax))
        if _INJECT == "corrupt_scale":
            s = s * 64.0
        deq = (f / s).to(torch.float8_e4m3fn).float() * s
        sig += float(torch.sum(f * f))
        noise += float(torch.sum((deq - f) ** 2))
        worst_rel = max(worst_rel, max_rel_error(f, deq))
        n_elems += int(f.numel())
    if noise == 0.0:
        snr = float("inf")
    elif sig == 0.0:
        snr = float("-inf")
    else:
        snr = 10.0 * math.log10(sig / noise)
    return QuantRegionStats(
        region="fp8_mlp", snr_db=snr, max_rel_err=worst_rel,
        logical_bytes=n_elems * 2, wire_bytes=n_elems + 4 * len(tensors),
        n_elements=n_elems, bits=8, block=0,
        note="e4m3 per-tensor MLP GEMM operands (vs bf16)")


def hpz_partition_stats(n_params: int, partition_size: int
                        ) -> QuantRegionStats:
    """hpZ region: a byte-accounting row, not an error row — the
    secondary partition changes which link the gather rides (intra-slice
    ICI at fsdp=k vs inter-slice DCN), never the gathered values. The
    region exists so the gate table can assert bit-exactness and the
    sweep table can show the link flip."""
    k = max(int(partition_size), 1)
    b = int(n_params) * 2  # bf16 gather bytes per pass
    return QuantRegionStats(
        region="hpz_partition", snr_db=None, max_rel_err=0.0,
        logical_bytes=b, wire_bytes=b, n_elements=int(n_params),
        bits=16, block=0, bit_exact=True,
        note=(f"secondary partition k={k}: gather stays intra-slice "
              "(ICI)" if k > 1
              else "k=1: gather spans the full fsdp group"))


def measure_kv_cache(kv_tensors: Sequence[Any], head_dim: int, *,
                     bits: int = 8, cap_elements: int = 1 << 22
                     ) -> QuantRegionStats:
    """kv_cache region: int8 per-head-vector error on REAL K/V tensors
    (one fp32 scale per head_dim vector — the pool layout of
    ``BlockedKVCache`` with ``quant_bits=8``)."""
    st = measure_region(
        "kv_cache", kv_tensors, block=int(head_dim), bits=bits,
        full_bytes_per_elem=2, cap_elements=cap_elements,
        note=f"int{bits} KV blocks, scale per head_dim={head_dim} vector "
             "(vs bf16 pool)")
    return st


def measure_kv_wire(block_data, head_dim: int, *, bits: int = 4,
                    cap_elements: int = 1 << 22) -> QuantRegionStats:
    """kv_wire region: error + byte accounting of quantizing bf16 handoff
    blocks for the disagg wire at ``bits`` (int4 packs two values per
    byte, the <=0.35x-of-bf16 mode)."""
    st = measure_region(
        "kv_wire", [block_data], block=int(head_dim), bits=bits,
        full_bytes_per_elem=2, cap_elements=cap_elements,
        note=f"int{bits} handoff wire, scale per head_dim={head_dim} "
             "vector (vs bf16 block payload)")
    return st


def measure_qar(grad_groups: Sequence[Any], *, bits: int = 8,
                block: int = 256, cap_elements: int = 1 << 22
                ) -> QuantRegionStats:
    """qar region: EQuARX-style quantized all-reduce error on REAL
    per-rank gradients — each rank's contribution quantizes at ``bits``
    for the reduce-scatter hop, the fp32-accumulated mean re-quantizes
    for the all-gather hop, and the result compares against the exact
    fp32 mean (mirrors ``quantized_all_reduce``'s two wire hops without
    needing a multi-device mesh)."""
    groups = list(grad_groups)
    if not groups:
        raise ValueError("measure_qar needs >= 1 gradient group")
    flats = [[t for _, t in _tree_leaves(g)] if isinstance(g, dict)
             else list(g) for g in groups]
    sig = noise = 0.0
    worst_rel = 0.0
    n_elems = 0
    all_scales: List[Any] = []
    budget = int(cap_elements)
    for i in range(len(flats[0])):
        if budget <= 0:
            break
        if torch.as_tensor(flats[0][i]).ndim < 2:
            continue  # 1-D leaves ride the exact path in the runtime
        leaves = [_f32(f[i]) for f in flats]
        budget -= int(leaves[0].numel())
        exact = sum(leaves) / len(leaves)
        # hop 1: per-rank quantize, fp32 accumulate (reduce-scatter wire)
        acc = torch.zeros_like(leaves[0])
        for leaf in leaves:
            deq, s = qdq_blockwise(leaf, block, bits)
            acc = acc + deq
            if s.numel():
                all_scales.append(s)
        mean = acc / len(leaves)
        # hop 2: the reduced shard re-quantizes for the all-gather wire
        approx, s2 = qdq_blockwise(mean, block, bits)
        if s2.numel():
            all_scales.append(s2)
        err = approx - exact
        sig += float(torch.sum(exact * exact))
        noise += float(torch.sum(err * err))
        worst_rel = max(worst_rel, max_rel_error(exact, approx, block))
        n_elems += int(leaves[0].numel())
    if noise == 0.0:
        snr = float("inf")
    elif sig == 0.0:
        snr = float("-inf")
    else:
        snr = 10.0 * math.log10(sig / noise)
    scales = (scale_summary(torch.cat(all_scales))
              if all_scales else scale_summary(torch.zeros((0,))))
    # wire per chip: one int payload + scales out (scatter) and the
    # world's reduced shards back in (gather) — 2x one tensor's wire
    return QuantRegionStats(
        region="qar", snr_db=snr, max_rel_err=worst_rel,
        logical_bytes=2 * n_elems * 4,
        wire_bytes=2 * wire_bytes(n_elems, bits, block),
        n_elements=n_elems, bits=bits, block=block, scales=scales,
        note=(f"int{bits} all-reduce (scatter+gather hops) over "
              f"{len(groups)} ranks (vs fp32 all-reduce)"))


# -- warn-once ----------------------------------------------------------------

_WARNED: set = set()


def warn_once(key: str, msg: str) -> None:
    """Log ``msg`` at WARNING level once per process per ``key`` — the
    shared warn-once used by the serving quant paths (e.g. a handoff
    shipping full-precision blocks into a quantized cache)."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    import logging

    logging.getLogger(__name__).warning(msg)


# -- export: hub gauges/counters, JSONL event, flight-recorder context ------

_LAST_SNAPSHOT: Dict[str, Any] = {}
_DUMP_CONTEXT_REGISTERED = False


def last_snapshot() -> Dict[str, Any]:
    """The newest published stats (what the flight recorder embeds)."""
    return dict(_LAST_SNAPSHOT)


def publish(stats: Sequence[QuantRegionStats], hub=None, step=None) -> None:
    """Export region stats as ``quant.*`` hub metrics + one JSONL event
    and stamp them into the flight-recorder dump context (registered
    once; every subsequent crash dump carries the latest snapshot)."""
    global _DUMP_CONTEXT_REGISTERED
    if hub is None:
        from deepspeed_tpu_torch.observability.hub import get_hub

        hub = get_hub()
    rows = []
    for st in stats:
        p = f"quant.{st.region}"
        if st.snr_db is not None and math.isfinite(st.snr_db):
            hub.gauge(f"{p}.snr_db", st.snr_db)
        hub.gauge(f"{p}.max_rel_err", st.max_rel_err)
        hub.gauge(f"{p}.compression", st.compression)
        hub.counter_add(f"{p}.wire_bytes", st.wire_bytes)
        hub.counter_add(f"{p}.logical_bytes", st.logical_bytes)
        if st.scales.get("n_blocks"):
            hub.gauge(f"{p}.scale_clamped_frac",
                      st.scales["clamped_frac"])
        rows.append(st.to_dict())
    hub.record_event("quant_stats", step=step, regions=rows)
    _LAST_SNAPSHOT.clear()
    _LAST_SNAPSHOT.update({"step": step, "regions": rows})
    try:
        from deepspeed_tpu_torch.observability.flight_recorder import \
            get_flight_recorder

        rec = get_flight_recorder()
        if not _DUMP_CONTEXT_REGISTERED:
            rec.add_dump_context("quant_stats", last_snapshot)
            _DUMP_CONTEXT_REGISTERED = True
        rec.record("quant_stats", regions=len(rows))
    except Exception:
        pass


def collection_configured(obs_cfg=None) -> bool:
    """Is quant.* collection on (the ``observability.quant_stats``
    flag)? The warn-once in engine init fires when quantization runs
    without it."""
    return bool(getattr(obs_cfg, "quant_stats", False))


def install_engine_collector(engine, cap_elements: int = 1 << 21) -> None:
    """One-shot init-time collection for an engine running quantized
    paths: sampled qwZ param-fetch error on the engine's real params,
    published as ``quant.*`` metrics + dump context. Gradients are
    measured by the bench arm (they need a real step); this collector
    makes sure a training run with qwZ/qgZ on always has at least the
    param-side error + wire bytes on the dashboard."""
    params = getattr(engine, "params", None)
    if params is None:
        return
    stats = [measure_param_fetch(params, cap_elements=cap_elements)]
    zq = getattr(getattr(engine, "_config", None) or
                 getattr(engine, "config", None), "zero_optimization",
                 None)
    if zq is not None and getattr(zq, "zero_hpz_partition_size", 1) > 1:
        stats.append(hpz_partition_stats(
            stats[0].n_elements, zq.zero_hpz_partition_size))
    publish(stats, hub=getattr(engine, "hub", None))


# -- acceptance gates --------------------------------------------------------


def evaluate_gates(stats: Sequence[QuantRegionStats],
                   gates: Optional[Dict[str, Dict[str, float]]] = None
                   ) -> (bool, List[Dict[str, Any]]):
    """Check each region against its gate; returns (ok, violations).
    Regions without a gate entry pass; gated regions missing from
    ``stats`` are NOT violations (the path may be off this run)."""
    gates = DEFAULT_GATES if gates is None else gates
    violations: List[Dict[str, Any]] = []
    for st in stats:
        g = gates.get(st.region)
        if not g:
            continue
        if g.get("bit_exact") and not st.bit_exact:
            violations.append({"region": st.region, "gate": "bit_exact",
                               "limit": True, "observed": st.bit_exact})
        if "min_snr_db" in g and st.snr_db is not None \
                and st.snr_db < g["min_snr_db"]:
            violations.append({"region": st.region, "gate": "min_snr_db",
                               "limit": g["min_snr_db"],
                               "observed": round(st.snr_db, 2)})
        if "max_rel_err" in g and st.max_rel_err > g["max_rel_err"]:
            violations.append({"region": st.region, "gate": "max_rel_err",
                               "limit": g["max_rel_err"],
                               "observed": round(st.max_rel_err, 6)})
    return (not violations), violations



__all__ = ["QUANT_REGIONS", "DEFAULT_GATES", "set_injection",
           "snr_db", "max_rel_error", "scale_summary",
           "qdq_blockwise", "wire_bytes", "QuantRegionStats",
           "measure_region", "measure_param_fetch", "measure_grad_reduce",
           "measure_fp8_mlp", "hpz_partition_stats", "measure_kv_cache",
           "measure_kv_wire", "measure_qar", "warn_once", "last_snapshot",
           "publish", "collection_configured", "install_engine_collector",
           "evaluate_gates"]
