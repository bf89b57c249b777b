"""Per-region roofline attribution for a training step (port of
``deepspeed_tpu/observability/attribution.py``).

Splits the step's cost into the five buckets of JAX's table: **attn**,
**mlp**, **vocab_head**, **optimizer**, **param_fetch**.

The three compute buckets are counted, not modeled. JAX compiles
grad-of-sum closures of its block functions on abstract inputs and reads
XLA's cost analysis. The port runs the same closures over its own
functions (``models.transformer._layer`` / ``_layer_mlp`` / the
final-norm + unembed + cross-entropy tail) forward and backward on the
**meta** device, at full width, under a counting ``TorchDispatchMode``:

- FLOPs are ``torch.utils.flop_counter``'s formulas for each aten op
  (the matmuls; elementwise ops count none, as there);
- bytes are each aten op's input and output bytes (a broadcast operand
  counted once), which is what eager execution moves: the port runs one
  kernel an op where XLA fuses;
- the hand kernels are reached through ``ctypes``, so no dispatch mode
  sees them: on meta tensors each kernel wrapper on the counted path
  (the flash forward and both backward kernels) reports its work by
  formula to the active counter (:func:`report_kernel`) and returns
  empty outputs. At the causal shape the formula counts the tiles the
  kernel computes: the key tiles up to the diagonal.

Meta tensors hold no storage, so a full-width pass costs no memory on
the card or the host. The attn bucket is the full-block cost minus the
MLP-half cost, as in JAX. The counts differ from XLA's by design: they
equal the analytic matmul count (plus the flash kernels' own work where
XLA's CPU path computes every tile); ROADMAP C records the ratios.

The two non-compute buckets are JAX's analytic transfer models:

- ``optimizer``: fused-Adam traffic — reads master+m+v (12 B/param) +
  the grad, writes master+m+v + the compute-dtype cast.
- ``param_fetch``: the per-layer param bytes x layers x (fwd + bwd) that
  a layer-streaming run would move over the host link
  (``DSTPU_FETCH_GBPS``, default the H100's PCIe Gen5 x16 link at its
  nominal 64 GB/s a direction). The port keeps its params resident
  (``offload_param`` is ROADMAP queue A item 11), so the row reports the
  floor a stream would need.

:func:`device_ms_by_region` reads a ``torch.profiler`` capture of the
model's region ranges (``utils/annotate.py``) and gives the card's time
by region, the measured side of the same table.

The long-context tier (``attribute_longctx_step``) and the quantized-comm
attribution (``attribute_quant_step``) raise, naming ROADMAP queue A
items 11 and 10.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from deepspeed_tpu_torch.observability.roofline import roofline_summary

REGIONS = ("attn", "mlp", "vocab_head", "optimizer", "param_fetch")

# Transfer (DMA) regions: their roofline time is bytes/bandwidth on the
# link they ride, not flops/bytes against HBM.
DMA_REGIONS = frozenset({"param_fetch", "sp_comm", "host_kv_stream",
                         "grad_reduce"})

# the H100's host link: PCIe Gen5 x16, nominal GB/s a direction
_DEFAULT_FETCH_GBPS = 64.0

# the region ranges of utils/annotate.py -> attribution's rows (norm and
# rope are rows of their own on the measured side; JAX folds them into
# the blocks that call them)
RANGE_ROWS = {"attention": "attn", "mlp": "mlp", "vocab_head": "vocab_head",
              "optimizer": "optimizer", "norm": "norm", "rope": "rope"}


def _dma_gbps(region: str, fetch_gbps: Optional[float] = None) -> float:
    """Bandwidth a DMA region's bytes divide by (the host link)."""
    return (fetch_gbps if fetch_gbps is not None
            else float(os.environ.get("DSTPU_FETCH_GBPS",
                                      _DEFAULT_FETCH_GBPS)))


@dataclasses.dataclass
class RegionCost:
    region: str
    flops: float            # total for the step (already x num_layers)
    bytes_accessed: float
    note: str = ""
    overlapped: bool = False  # traffic hidden behind compute when true
    # DMA regions only: pin the link this region's bytes divide by; None
    # falls back to the region-name default in _dma_gbps
    gbps: Optional[float] = None
    link: Optional[str] = None

    @property
    def intensity(self) -> float:
        if self.bytes_accessed <= 0:
            return float("inf")
        return self.flops / self.bytes_accessed

    def to_dict(self) -> Dict[str, Any]:
        return {**dataclasses.asdict(self),
                "arithmetic_intensity": (
                    None if self.bytes_accessed <= 0
                    else round(self.intensity, 3))}


# ---------------------------------------------------------------------------
# the counting pass
# ---------------------------------------------------------------------------

# ops that move no data (allocation, aliasing)
_NO_DATA = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "detach", "alias", "lift_fresh",
                      "_to_copy_meta_noop"})

_ACTIVE: Optional["WorkCounter"] = None


def _moved_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` an op reads or writes: a broadcast (stride-0) dim
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class WorkCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op it sees, plus what the
    hand kernels report (:func:`report_kernel`). ``devices`` collects the
    device type of every tensor an op produced and ``host_bytes`` the
    bytes of those that are not on the meta device (a remat's saved RNG
    state is a small CPU tensor): a meta pass allocates no card memory
    and next to no host memory."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernels: Dict[str, int] = {}
        self.devices: set = set()
        self.host_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pkt = func._overloadpacket
        for t in _tensors(out):
            self.devices.add(t.device.type)
            if t.device.type != "meta":
                self.host_bytes += t.numel() * t.element_size()
        if pkt in flop_registry:
            self.flops += float(flop_registry[pkt](*args, **kwargs,
                                                   out_val=out))
        if not func.is_view and pkt.__name__ not in _NO_DATA:
            self.bytes += float(sum(_moved_bytes(t) for t in
                                    _tensors((args, kwargs))))
            self.bytes += float(sum(_moved_bytes(t) for t in _tensors(out)))
        return out

    def __enter__(self):
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return super().__exit__(*exc)

    def check_meta(self) -> None:
        """Raise unless the pass ran on the meta device: nothing on the
        card, under a MiB on the host."""
        if "cuda" in self.devices or self.host_bytes > (1 << 20):
            raise RuntimeError(
                f"the counting pass allocated outside the meta device: "
                f"{sorted(self.devices)}, {self.host_bytes} host bytes")

    def cost(self) -> Dict[str, float]:
        return {"flops": self.flops + self.kernel_flops,
                "bytes_accessed": self.bytes + self.kernel_bytes}


def report_kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand kernel's work on a meta pass (its wrapper calls this in
    place of a launch). Raises when no counter is active: meta tensors
    reach the kernel wrappers only under one."""
    if _ACTIVE is None:
        raise RuntimeError(
            f"{name}: meta tensors reach the kernel wrappers only inside "
            "observability.attribution's counting pass")
    _ACTIVE.kernel_flops += float(flops)
    _ACTIVE.kernel_bytes += float(nbytes)
    _ACTIVE.kernels[name] = _ACTIVE.kernels.get(name, 0) + 1


def _meta_leaf(shape, dtype, grad=True) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _meta_tree(tree, dtype, grad=True):
    return {k: (_meta_tree(v, dtype, grad) if isinstance(v, dict)
                else _meta_leaf(v, dtype, grad)) for k, v in tree.items()}


def _tree_leaves(tree) -> List[torch.Tensor]:
    return list(_tensors(tree))


def _grad_cost(fn, *args) -> Dict[str, float]:
    """Forward + backward of ``sum(fn(*args).float())`` on meta tensors
    under a fresh counter (JAX: compile grad-of-sum, read the cost)."""
    with WorkCounter() as wc:
        out = fn(*args)
        if isinstance(out, tuple):
            out = out[0]
        total = out.float().sum()
        wrt = [t for t in _tree_leaves(args) if t.requires_grad]
        torch.autograd.grad(total, wrt, allow_unused=True)
    wc.check_meta()
    return wc.cost()


def counted_config(cfg, device_type: str = "cuda"):
    """``cfg`` as the card runs it: ``attn_impl="auto"`` resolved to the
    route ``ops.attention.auto_impl`` takes on ``device_type`` (flash on
    the card for bf16 at head dim 64 / 128), and no remat (each closure
    is one forward and one backward, as JAX's)."""
    from deepspeed_tpu_torch.ops import attention as attn_ops

    impl = cfg.attn_impl
    if impl == "auto":
        impl = attn_ops.auto_impl(device_type, cfg.dtype, cfg.head_dim)
    return dataclasses.replace(cfg, attn_impl=impl, remat=False)


def _per_layer_shapes(cfg) -> Dict[str, Any]:
    from deepspeed_tpu_torch.models.transformer import param_shapes

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items()}
        shape, _init = node
        return tuple(shape[1:])

    return strip(param_shapes(cfg)["layers"])


def _tree_bytes(shapes, itemsize: int) -> int:
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return math.prod(node) * itemsize
    return int(walk(shapes))


def _head_fn(cfg):
    """Final norm + the LM head's loss (``transformer.lm_head_loss``)."""
    from deepspeed_tpu_torch.models import transformer as tf

    def head(hidden, final_norm, unembed, labels):
        params = {"final_norm": final_norm}
        if cfg.tie_embeddings:
            params["embed"] = {"tokens": unembed}
        else:
            params["unembed"] = {"kernel": unembed}
        normed = tf.final_norm_of(cfg, params, hidden, None)
        loss, _ = tf.lm_head_loss(cfg, params, normed, labels, None)
        return loss

    return head


def attribute_step(cfg, micro_batch: int, seq: int, *,
                   fetch_gbps: Optional[float] = None,
                   optimizer: str = "adamw",
                   optimizer_on_host: Optional[bool] = None,
                   grad_bytes_per_param: int = 2,
                   device_type: str = "cuda") -> List[RegionCost]:
    """Count/model the five region costs for one fwd+bwd+update step.

    ``cfg`` is a ``TransformerConfig`` (its ``dtype`` the compute dtype);
    the compute regions run at [micro_batch, seq, hidden] activations on
    the meta device and scale by ``num_layers``. ``device_type`` picks
    the attention route of ``attn_impl="auto"`` (the card's by
    default)."""
    from deepspeed_tpu_torch.models import transformer as tf

    cfg = counted_config(cfg, device_type)
    dt = cfg.dtype
    H, L = cfg.hidden_size, cfg.num_layers
    x = _meta_leaf((micro_batch, seq, H), dt)
    labels = torch.empty((micro_batch, seq), dtype=torch.int64,
                         device="meta")
    layer_shapes = _per_layer_shapes(cfg)
    lp = _meta_tree(layer_shapes, dt)
    rope = None
    if cfg.pos_emb == "rope":
        pos = torch.empty((1, seq), dtype=torch.int64, device="meta")
        rope = tf.rope_tables(pos, cfg.head_dim, cfg.rope_theta)

    layer_cost = _grad_cost(
        lambda lp_, x_: tf._layer(cfg, x_, lp_, rope), lp, x)
    attn_in = _meta_leaf((micro_batch, seq, H), dt)
    mlp_cost = _grad_cost(
        lambda lp_, x_, a_: tf._layer_mlp(cfg, x_, a_, lp_), lp, x, attn_in)
    norm_shapes = {k: (H,) for k in (("scale", "bias")
                                     if cfg.norm == "layernorm"
                                     else ("scale",))}
    final_norm = _meta_tree(norm_shapes, dt)
    unembed = _meta_leaf((cfg.vocab_size, H) if cfg.tie_embeddings
                         else (H, cfg.vocab_size), dt)
    head_cost = _grad_cost(_head_fn(cfg), x, final_norm, unembed, labels)

    regions = [
        RegionCost(
            "attn",
            max(0.0, (layer_cost["flops"] - mlp_cost["flops"])) * L,
            max(0.0, (layer_cost["bytes_accessed"]
                      - mlp_cost["bytes_accessed"])) * L,
            note="block minus MLP-half, x num_layers"
                 + (", flash kernels (causal tiles to the diagonal)"
                    if cfg.attn_impl == "flash" else "")),
        RegionCost(
            "mlp", mlp_cost["flops"] * L,
            mlp_cost["bytes_accessed"] * L,
            note=f"{str(dt).replace('torch.', '')} GEMMs, x num_layers"),
        RegionCost(
            "vocab_head", head_cost["flops"],
            head_cost["bytes_accessed"],
            note="untiled logits"),
    ]

    # -- optimizer: analytic fused-Adam traffic -------------------------
    n_params = cfg.num_params()
    model_bytes = torch.empty((), dtype=dt).element_size()
    if optimizer.lower() in ("adam", "adamw"):
        opt_reads = 12 + grad_bytes_per_param    # master+m+v + grad
        opt_writes = 12 + model_bytes            # master+m+v + cast
    else:                                        # sgd-class
        opt_reads = 4 + grad_bytes_per_param
        opt_writes = 4 + model_bytes
    on_host = bool(optimizer_on_host)
    regions.append(RegionCost(
        "optimizer", float(n_params) * 4,        # ~4 flop/param update
        float(n_params) * (opt_reads + opt_writes),
        note=("host-RAM traffic (offload_optimizer)" if on_host
              else "HBM traffic"),
        overlapped=False))

    # -- param_fetch: layer streaming over the host link ----------------
    # (the fp32 params, as JAX's abstract tree holds them)
    layer_bytes = _tree_bytes(layer_shapes, 4)
    regions.append(RegionCost(
        "param_fetch", 0.0,
        float(layer_bytes) * L * 2,              # fwd + bwd passes
        note="params resident (no streaming)",
        overlapped=True))
    return regions


def count_step(cfg, micro_batch: int, seq: int, gas: int = 1,
               optimizer: str = "adamw", grad_bytes_per_param: int = 4,
               device_type: str = "cuda") -> Dict[str, float]:
    """The counted cost of one whole train step of a dense
    ``TransformerLM`` (the engine's ``roofline()``; JAX's compiled-step
    cost analysis): ``gas`` times the model's loss forward and backward
    at [micro_batch, seq] on the meta device, every layer and the remat
    recompute included as the engine runs them, plus the optimizer row
    of :func:`attribute_step` (fp32 accumulated grads by default)."""
    from deepspeed_tpu_torch.models import transformer as tf

    run_cfg = cfg
    if cfg.attn_impl == "auto":
        from deepspeed_tpu_torch.ops import attention as attn_ops

        run_cfg = dataclasses.replace(cfg, attn_impl=attn_ops.auto_impl(
            device_type, cfg.dtype, cfg.head_dim))
    params = _meta_tree(_shape_tree(tf.param_shapes(run_cfg)),
                        run_cfg.dtype)
    batch = {"input_ids": torch.empty((micro_batch, seq + 1),
                                      dtype=torch.int64, device="meta")}
    with WorkCounter() as wc:
        loss, _ = tf.loss_fn(run_cfg, params, batch)
        torch.autograd.grad(loss, _tree_leaves(params))
    wc.check_meta()
    cost = wc.cost()
    n = float(cfg.num_params())
    model_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    if optimizer.lower() in ("adam", "adamw"):
        opt_bytes = n * (12 + grad_bytes_per_param + 12 + model_bytes)
    else:
        opt_bytes = n * (4 + grad_bytes_per_param + 4 + model_bytes)
    return {"flops": cost["flops"] * gas + 4.0 * n,
            "bytes_accessed": cost["bytes_accessed"] * gas + opt_bytes,
            "kernel_calls": dict(wc.kernels)}


def _shape_tree(shapes):
    return {k: (_shape_tree(v) if isinstance(v, dict) else tuple(v[0]))
            for k, v in shapes.items()}


def attribute_longctx_step(*args, **kwargs) -> List[RegionCost]:
    """JAX's analytic long-context tier (sequence-parallel collectives,
    FPDT's host-KV stream): not ported."""
    raise NotImplementedError(
        "attribute_longctx_step: ROADMAP queue A item 11 (sequence "
        "parallelism and FPDT's host-KV stream are not ported)")


def attribute_quant_step(*args, **kwargs) -> List[RegionCost]:
    """JAX's quantized-comm attribution (qwZ / qgZ / hpZ): not ported."""
    raise NotImplementedError(
        "attribute_quant_step: ROADMAP queue A item 10 (ZeRO++'s "
        "quantized collectives are not ported)")


# ---------------------------------------------------------------------------
# the measured side: device time by region range
# ---------------------------------------------------------------------------


def device_ms_by_region(prof, ranges=tuple(RANGE_ROWS),
                        family=None) -> Dict[str, Any]:
    """The card's kernel time in a ``torch.profiler`` capture, by the
    innermost region range (``utils/annotate.py``) around the op that
    launched each kernel; kernels outside every range are ``other``.
    Returns {"ms": {range: ms}, "kernels": {range: count}}, and with
    ``family`` (kernel name -> family name) also {"by_family": {range:
    {family: ms}}}."""
    from torch.autograd import DeviceType

    ms: Dict[str, float] = {r: 0.0 for r in (*ranges, "other")}
    count: Dict[str, int] = {r: 0 for r in ms}
    fams: Dict[str, Dict[str, float]] = {r: {} for r in ms}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        node, region = e, "other"
        while node is not None:
            if node.name in ranges:
                region = node.name
                break
            node = node.cpu_parent
        for k in e.kernels:
            ms[region] += k.duration / 1e3
            count[region] += 1
            if family is not None:
                f = family(k.name)
                fams[region][f] = fams[region].get(f, 0.0) + k.duration / 1e3
    out = {"ms": ms, "kernels": count}
    if family is not None:
        out["by_family"] = fams
    return out


# ---------------------------------------------------------------------------
# Exposed-vs-hidden split (JAX's overlap engine schedule)
# ---------------------------------------------------------------------------
# With overlap_depth = k, the transfer of one stage (a layer's fwd or bwd)
# can hide behind up to k stages of compute before the consumer needs it.
# The split is the analytic form of that schedule: per-stage transfer time
# clipped by the k-stage compute window; k = 0 reports fully exposed.


def overlap_split_ms(transfer_ms: float, stage_ms: float,
                     overlap_depth: int, stages: int) -> Dict[str, float]:
    """Split a transfer's roofline time into hidden vs exposed ms under
    the staged overlap schedule.

    ``transfer_ms`` total transfer time for the step; ``stage_ms`` the
    compute time of ONE scheduling stage (a layer's fwd or bwd);
    ``stages`` how many stages the transfer is spread across (2 x layers
    for a per-layer stream); ``overlap_depth`` k = how many stages of
    compute each stage's transfer may hide behind. k=0 -> fully
    exposed."""
    total = max(float(transfer_ms), 0.0)
    n = max(int(stages), 1)
    k = max(int(overlap_depth), 0)
    per_stage = total / n
    hidden_per = min(per_stage, k * max(float(stage_ms), 0.0))
    hidden = hidden_per * n
    exposed = total - hidden
    return {"total_ms": total, "hidden_ms": hidden, "exposed_ms": exposed,
            "hidden_frac": 0.0 if total <= 0 else hidden / total}


def split_exposed_hidden(regions: List[RegionCost], *,
                         peak_tflops: float, hbm_gbps: float,
                         fetch_gbps: Optional[float] = None,
                         overlap_depth: int = 0,
                         num_layers: int = 1) -> List[Dict[str, Any]]:
    """Per-region exposed/hidden attribution: compute regions are fully
    exposed (they ARE the step); transfer regions (``DMA_REGIONS``)
    split by :func:`overlap_split_ms` against the per-layer compute
    window."""
    ms: Dict[str, float] = {}
    for r in regions:
        if r.region in DMA_REGIONS:
            bw = r.gbps or _dma_gbps(r.region, fetch_gbps)
            ms[r.region] = r.bytes_accessed / (bw * 1e9) * 1e3
        else:
            compute_ms = r.flops / (peak_tflops * 1e12) * 1e3
            mem_ms = r.bytes_accessed / (hbm_gbps * 1e9) * 1e3
            ms[r.region] = max(compute_ms, mem_ms)
    stages = 2 * max(int(num_layers), 1)  # fwd + bwd stage per layer
    stage_ms = (ms.get("attn", 0.0) + ms.get("mlp", 0.0)) / stages
    out = []
    for r in regions:
        if r.region in DMA_REGIONS:
            split = overlap_split_ms(ms[r.region], stage_ms,
                                     overlap_depth, stages)
            out.append({"region": r.region, "kind": "dma",
                        "bytes": r.bytes_accessed, **split})
        else:
            total = ms[r.region]
            out.append({"region": r.region, "kind": "compute",
                        "bytes": r.bytes_accessed, "total_ms": total,
                        "hidden_ms": 0.0, "exposed_ms": total,
                        "hidden_frac": 0.0})
    return out


def attribution_markdown(regions: List[RegionCost], peak_tflops: float,
                         hbm_gbps: float,
                         fetch_gbps: Optional[float] = None,
                         title: str = "Per-region roofline attribution",
                         overlap_depth: Optional[int] = None,
                         num_layers: int = 1) -> str:
    """Render the region table. Passing ``overlap_depth`` adds
    exposed/hidden ms columns from :func:`split_exposed_hidden` (same
    rows, wider table)."""
    fetch = fetch_gbps
    with_split = overlap_depth is not None
    split_by: Dict[str, Dict[str, Any]] = {}
    if with_split:
        split_by = {s["region"]: s for s in split_exposed_hidden(
            regions, peak_tflops=peak_tflops, hbm_gbps=hbm_gbps,
            fetch_gbps=fetch, overlap_depth=int(overlap_depth),
            num_layers=num_layers)}
    extra_hdr = " exposed ms | hidden ms |" if with_split else ""
    extra_sep = "---|---|" if with_split else ""
    lines = [f"### {title}", "",
             "| region | GFLOPs | GB moved | F/B | bound | "
             f"roofline ms |{extra_hdr} notes |",
             f"|---|---|---|---|---|---|{extra_sep}---|"]
    for r in regions:
        if r.region in DMA_REGIONS:
            bw = r.gbps or _dma_gbps(r.region, fetch)
            ms = r.bytes_accessed / (bw * 1e9) * 1e3
            bound = r.link or "host-link"
        else:
            summ = roofline_summary(
                {"flops": r.flops, "bytes_accessed": r.bytes_accessed},
                peak_tflops, hbm_gbps)
            bound = summ["bound"]
            compute_ms = r.flops / (peak_tflops * 1e12) * 1e3
            mem_ms = r.bytes_accessed / (hbm_gbps * 1e9) * 1e3
            ms = max(compute_ms, mem_ms)
        inten = ("—" if r.bytes_accessed <= 0 or r.flops <= 0
                 else f"{r.flops / r.bytes_accessed:.1f}")
        note = r.note + (" (overlapped)" if r.overlapped else "")
        extra = ""
        if with_split:
            s = split_by[r.region]
            extra = (f" {s['exposed_ms']:,.2f} | "
                     f"{s['hidden_ms']:,.2f} |")
        lines.append(
            f"| {r.region} | {r.flops / 1e9:,.1f} | "
            f"{r.bytes_accessed / 1e9:,.2f} | {inten} | {bound} | "
            f"{ms:,.2f} |{extra} {note} |")
    lines.append("")
    lines.append(
        "Roofline ms = max(flops/peak, bytes/HBM-bw) per region in "
        "isolation; overlapped rows stream behind compute and bound "
        "throughput only if their bandwidth floor is missed."
        + ((" Exposed/hidden split: overlap_depth="
            f"{int(overlap_depth)} staged schedule "
            "(observability/attribution.py overlap_split_ms).")
           if with_split else ""))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI: python -m deepspeed_tpu_torch.observability.attribution --layers 8
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="dstpu-attribution",
        description="count per-region closures at a given shape on the "
                    "meta device and print the roofline attribution table")
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=None,
                    help="vocabulary size (default: the preset's)")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--overlap-depth", type=int, default=None,
                    help="add exposed/hidden ms columns for the overlap "
                         "schedule at this stage depth (0 = unstaged)")
    ap.add_argument("--peak-tflops", type=float, default=None)
    ap.add_argument("--hbm-gbps", type=float, default=None)
    ap.add_argument("--json", action="store_true",
                    help="emit the raw region dicts instead of markdown")
    args = ap.parse_args(argv)

    from deepspeed_tpu_torch.models.zoo import get_config
    from deepspeed_tpu_torch.observability.roofline import (
        HBM_GBPS, PEAK_TFLOPS)

    over = {"num_layers": args.layers, "max_seq_len": args.seq,
            "dtype": torch.bfloat16}
    if args.vocab is not None:
        over["vocab_size"] = args.vocab
    cfg = get_config(args.model, **over)
    # the card the table is for (the pass itself needs no card)
    peak = args.peak_tflops or PEAK_TFLOPS["h100 80gb hbm3"]
    hbm = args.hbm_gbps or HBM_GBPS["h100 80gb hbm3"]
    regions = attribute_step(cfg, args.micro, args.seq)
    if args.json:
        payload: Any = [r.to_dict() for r in regions]
        if args.overlap_depth is not None:
            payload = {"regions": payload,
                       "overlap_depth": args.overlap_depth,
                       "split": split_exposed_hidden(
                           regions, peak_tflops=peak, hbm_gbps=hbm,
                           overlap_depth=args.overlap_depth,
                           num_layers=cfg.num_layers)}
        print(json.dumps(payload, indent=2))
    else:
        shape = (f"{args.model} {args.layers}L vocab {cfg.vocab_size:,} "
                 f"seq {args.seq} micro {args.micro}")
        print(attribution_markdown(
            regions, peak, hbm,
            title=f"Per-region roofline attribution — {shape}",
            overlap_depth=args.overlap_depth,
            num_layers=cfg.num_layers))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
