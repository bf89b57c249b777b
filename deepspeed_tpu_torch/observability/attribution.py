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
  nominal 64 GB/s a direction); ``offload_param`` streams them
  (``runtime/param_stream.py``), a resident run's row is the floor a
  stream would need.

:func:`device_ms_by_region` reads a ``torch.profiler`` capture of the
model's region ranges (``utils/annotate.py``) and gives the card's time
by region, the measured side of the same table.

The long-context tier (``attribute_longctx_step``) is JAX's analytic
model (its sequence-parallel rows are formulas: nothing runs across
cards); so is the quantized-comm tier (``attribute_quant_step``: the
stage-3 param gather and the gradient reduction under qwZ / qgZ / qar /
hpZ, their bytes a card and their link mix, JAX's formulas; the links
default to an HGX H100 node's).
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
        if func.namespace == "dstpu":
            return out  # a kernel's operator: it reports its own work
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


def attribute_longctx_step(*, seq_len: int, hidden_size: int,
                           num_heads: int,
                           num_kv_heads: Optional[int] = None,
                           head_dim: Optional[int] = None,
                           num_layers: int = 1, batch_size: int = 1,
                           sp: int = 1, strategy: Optional[str] = None,
                           attn_chunks: int = 0,
                           fpdt_host_kv: bool = False,
                           dtype_bytes: int = 2) -> List[RegionCost]:
    """JAX's analytic costs of the long-context regions of one forward
    and backward, per card: **attn** (causal 6 B S^2 H / sp FLOPs; q, out
    and the per-chunk KV rereads), **sp_comm** (the sequence-parallel
    collectives of ``strategy`` over ``sp`` ranks: Ulysses' 4
    all-to-alls, ring's sp - 1 KV hops, FPDT's KV all-gather and
    reduce-scatter; zero at sp 1) and **host_kv_stream** (FPDT's host KV:
    the K/V stacks down once, then the causal average of (chunks + 1) / 2
    stacks up a pass, twice for the backward). Zero-cost regions are
    still emitted."""
    kv = num_kv_heads or num_heads
    D = head_dim or hidden_size // num_heads
    H = hidden_size
    B, S, L = batch_size, seq_len, num_layers
    p = max(int(sp), 1)
    db = dtype_bytes

    attn_flops = 6.0 * B * float(S) * S * H / p * L
    kv_bytes = 2.0 * B * S * kv * D * db          # full K+V stacks
    chunks = max(int(attn_chunks), 1)
    attn_bytes = (2.0 * B * (S / p) * num_heads * D * db
                  + chunks * kv_bytes / p) * L

    if p > 1:
        frac = (p - 1) / p
        if strategy == "ulysses" and chunks <= 1:
            per_layer = (2.0 * B * S * num_heads * D
                         + 2.0 * B * S * kv * D) * db * frac
            note = "ulysses: 4 all-to-alls/layer (q,out + k,v @ GQA width)"
        elif strategy == "ring" and chunks <= 1:
            per_layer = kv_bytes * frac
            note = f"ring: {p - 1} ppermute KV hops/layer"
        else:
            per_layer = kv_bytes * frac
            note = ("fpdt+sp: KV all-gather fwd / reduce-scatter bwd "
                    "per layer")
        sp_bytes = per_layer * 2 * L              # fwd + bwd
    else:
        sp_bytes, note = 0.0, "sp=1: no sequence-parallel collectives"
    regions = [
        RegionCost("attn", attn_flops, attn_bytes,
                   note=f"causal, per chip (S/sp={S // p} query rows), "
                        "x num_layers"),
        RegionCost("sp_comm", 0.0, sp_bytes, note=note, overlapped=True),
    ]
    if fpdt_host_kv:
        hk_bytes = kv_bytes * (1.0 + (chunks + 1) / 2.0) * 2 * L
        hk_note = (f"D2H once + causal-avg H2D over {chunks} chunks, "
                   "x2 bwd, x num_layers")
    else:
        hk_bytes, hk_note = 0.0, "KV resident on device (no spill)"
    regions.append(RegionCost("host_kv_stream", 0.0, hk_bytes,
                              note=hk_note, overlapped=True))
    return regions


# the quantized-collective tier (ZeRO++): the per-card bytes of the
# stage-3 param gather and the gradient reduction, their link mix set by
# the factorization hpZ controls. Analytic, as in JAX. The default links
# are an HGX H100 node's: NVLink 4 at 450 GB/s a direction (900 GB/s
# total a card), and one 400 Gb/s NDR InfiniBand port a card between
# nodes (50 GB/s); ``attribute_quant_step``'s arguments override them.
_DEFAULT_ICI_GBPS = 450.0
_DEFAULT_DCN_GBPS = 50.0


def _wire_ratio(bits: int, block: int, full_bytes: float) -> float:
    """(int payload + fp32 scale per block) / full-precision bytes."""
    return (bits / 8.0 + 4.0 / block) / full_bytes


def attribute_quant_step(cfg, *, qwz: bool = False, qgz: bool = False,
                         qar: bool = False, hpz: int = 1,
                         n_chips: int = 16, slice_size: int = 8,
                         ici_gbps: float = _DEFAULT_ICI_GBPS,
                         dcn_gbps: float = _DEFAULT_DCN_GBPS
                         ) -> List[RegionCost]:
    """Per-chip analytic costs of the two quantized-collective regions
    for one fwd+bwd step of ``cfg`` on ``n_chips`` cards arranged in
    slices of ``slice_size`` (a node: link "ici" is the intra-node
    NVLink, "dcn" the inter-node network; JAX's names):

    - **param_fetch** — the stage-3 per-layer param all-gather: each
      chip receives (g-1)/g of every layer's params, fwd + bwd, where
      g is the gather group (hpZ partition k when set, else all
      chips). qwZ turns the bf16 wire into int8 payload + one fp32
      scale per QWZ_BLOCK ((1+4/128)/2 ≈ 0.52×); hpZ keeps the group
      intra-slice so the bytes ride ICI instead of DCN.
    - **grad_reduce** — the qgZ reduction: level 1 moves every
      gradient element once over the fsdp group ((g1-1)/g1 of the fp32
      wire); when hpZ splits the mesh a second level reduces partial
      sums over the dp axis across slices. qgZ quantizes level 1 to
      int8 and the inter-slice level to int4, each + fp32 scales per
      QGZ_BLOCK. ``qar`` replaces the reduce entirely with the
      EQuARX-style quantized all-reduce: an int8 reduce-scatter plus an
      int8 all-gather over the full dp axis, each hop moving (N-1)/N of
      the gradient wire + fp32 scales per QUANT_BLOCK (qar and qgZ are
      mutually exclusive, mirroring ZeroConfig.validate).

    Each region's ``gbps``/``link`` pin the byte-weighted effective
    bandwidth of its level mix, so the roofline ms reflects the link
    flip, not just the byte shrink."""
    from deepspeed_tpu_torch.runtime.qgz import QGZ_BLOCK
    from deepspeed_tpu_torch.runtime.sharding import QWZ_BLOCK

    ici, dcn = float(ici_gbps), float(dcn_gbps)
    N = max(int(n_chips), 1)
    S = max(min(int(slice_size), N), 1)
    k = max(int(hpz), 1)
    L = cfg.num_layers

    layer_elems = _tree_bytes(_per_layer_shapes(cfg), 1)
    n_params = cfg.num_params()

    # -- param_fetch: per-layer all-gather, fwd + bwd -------------------
    g = k if k > 1 else N
    frac = (g - 1) / g if g > 1 else 0.0
    fetch_full = 2.0 * layer_elems * frac * L * 2     # bf16 wire
    w_ratio = _wire_ratio(8, QWZ_BLOCK, 2.0) if qwz else 1.0
    fetch_bytes = fetch_full * w_ratio
    fetch_link = "ici" if (k > 1 and k <= S) or N <= S else "dcn"
    fetch_gbps_eff = ici if fetch_link == "ici" else dcn
    fetch_note = (
        ("int8+scales all-gather" if qwz else "bf16 all-gather")
        + f" over g={g} ({fetch_link.upper()})"
        + (f", hpZ k={k} keeps it intra-slice" if k > 1 else ""))

    if qar and qgz:
        raise ValueError("qar and qgz are mutually exclusive (both own "
                         "the gradient wire)")

    # -- grad_reduce: qgZ level structure -------------------------------
    g1 = k if k > 1 else N
    dp = N // g1 if k > 1 else 1
    l1_link = "ici" if g1 <= S else "dcn"
    l1_frac = (g1 - 1) / g1 if g1 > 1 else 0.0
    l1_ratio = _wire_ratio(8, QGZ_BLOCK, 4.0) if qgz else 1.0
    l1_bytes = 4.0 * n_params * l1_frac * l1_ratio
    l2_frac = (dp - 1) / dp if dp > 1 else 0.0
    l2_ratio = _wire_ratio(4, QGZ_BLOCK, 4.0) if qgz else 1.0
    l2_bytes = 4.0 * n_params * l2_frac * l2_ratio
    l1_ms = l1_bytes / ((ici if l1_link == "ici" else dcn) * 1e9) * 1e3
    l2_ms = l2_bytes / (dcn * 1e9) * 1e3
    red_bytes = l1_bytes + l2_bytes
    red_ms = l1_ms + l2_ms
    red_gbps = (red_bytes / (red_ms * 1e6)) if red_ms > 0 else ici
    red_link = (l1_link if dp <= 1
                else f"{l1_link}+dcn")
    red_note = (
        (f"int8 level1 over fsdp={g1} ({l1_link.upper()})" if qgz
         else f"fp32 reduce over fsdp={g1} ({l1_link.upper()})")
        + ((f" + {'int4' if qgz else 'fp32'} level2 over dp={dp} (DCN)")
           if dp > 1 else ""))

    if qar:
        # qar overrides the level structure: one flat int8 all-reduce
        # (reduce-scatter + all-gather) over the full dp axis; fp32
        # scales per QUANT_BLOCK on both hops
        from deepspeed_tpu_torch.runtime.zeropp import QUANT_BLOCK
        ar_frac = (N - 1) / N if N > 1 else 0.0
        ar_ratio = _wire_ratio(8, QUANT_BLOCK, 4.0)
        red_link = "ici" if N <= S else "dcn"
        ar_gbps = ici if red_link == "ici" else dcn
        red_bytes = 2.0 * 4.0 * n_params * ar_frac * ar_ratio
        red_ms = red_bytes / (ar_gbps * 1e9) * 1e3
        red_gbps = ar_gbps
        red_note = (f"qar: int8 reduce-scatter + int8 all-gather over "
                    f"dp={N} ({red_link.upper()})")

    return [
        RegionCost("param_fetch", 0.0, fetch_bytes, note=fetch_note,
                   overlapped=True, gbps=fetch_gbps_eff,
                   link=fetch_link),
        RegionCost("grad_reduce", 0.0, red_bytes, note=red_note,
                   overlapped=False, gbps=red_gbps, link=red_link),
    ]


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
