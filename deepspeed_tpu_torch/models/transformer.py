"""Decoder-only transformer LM (port of
``deepspeed_tpu/models/transformer.py``).

Carried over: the configuration's architecture fields, the parameter
tree, the norm, the rotary embedding, the activations, and the training
forward — ``apply_hidden`` / ``apply`` / ``loss_fn`` on a ``params``
dict, with the JAX cast points (activations in ``cfg.dtype``, each weight
``.to(dt)`` at use, fp32 logits). The serving forwards live in
``inference/model_runner.py``, as in the JAX package.

``TransformerLM`` is an ``nn.Module`` whose parameters keep the JAX
tree's names and its stacked ``[L, ...]`` layer layout
(``layers.attn.wq`` is ``[L, hidden, heads, head_dim]``), so the runner
reads ``params["layers"]["attn"]["wq"][l]`` exactly where the JAX runner
scans over the same leaf.

The JAX layer scan is a Python loop here; ``remat`` wraps each layer in
``runtime/activation_checkpointing.checkpoint_wrapper`` under
``remat_policy`` (None: the configured ``activation_checkpointing.policy``,
by default ``nothing_saveable``; an engine pins its own, resolved at
build), and the layer names its ``qkv_proj``,
``attn_kernel_out``, ``attn_out`` and ``mlp_out`` tensors for the named
policies. The long-context branches run as in JAX: ``tiled_mlp`` and
``tiled_logits`` (``parallel/tiled_compute.py``; the tiled loss fuses the
final norm, the unembed and the cross-entropy a tile at a time),
``attn_chunks`` (FPDT chunked attention), ``fpdt_host_kv`` (K/V tiles in
pinned host memory, the rest of the block fused per chunk) and
``fpdt_host_residual`` (the residual stream as host chunks between
layers: ``apply_hidden_hosted`` / ``hosted_logits_loss``), all in
``parallel/fpdt.py``. ``param_host_offload`` (set by the engine from
``zero_optimization.offload_param``) streams the layer stack from pinned
host memory (``runtime/param_stream.py``): by default with
``prefetch_depth`` layers in flight on a copy stream, or, with
``serialize_fetch``, a fetch inside each remat'd layer. ``fp8_mlp`` runs
the MLP's products in e4m3 with straight-through gradients
(``ops/fp_quantizer.fp8_matmul_ste``).

Tensor parallelism: on a mesh whose tp collectives communicate
(``runtime/sharding.tp_size() > 1``) each leaf is this rank's slice
under JAX's ``TP_RULES`` (``nh/tp`` query and ``nkv/tp`` kv heads, the
MLP width and the vocab over tp), and the forward issues the
collectives GSPMD would insert: q/k/v and the MLP's gate/up are
column-parallel (``sharding.tp_copy`` on their input), ``wo`` and the
MLP's down row-parallel (``sharding.tp_reduce`` after them, before any
bias), the embedding is ``vocab_parallel_lookup`` and the losses take
the vocab-sharded logits through ``vocab_parallel_nll``; ``apply``
gathers them whole. The FPDT host paths and the streamed stack stay on
one tp rank.

Sequence parallelism (``sequence_parallel``, an sp mesh axis whose
collectives communicate): each rank's batch is its block of the
sequence, cut after the next-token shift (``topology.batch_sharding``),
its positions start at ``sp_index * S_local`` (rope and learned
positions), the KV heads are repeated to the query count before the sp
attention (JAX's ``repeat_kv_heads``), and ``_attention`` dispatches as
JAX's does: ``sp_mode="ring"`` to ``parallel/ring_attention``, else
Ulysses (``parallel/ulysses``, whose local attention is the flash
kernels or FPDT's chunks). The loss is the mean over the global tokens:
each rank's NLL sum and token count summed over sp (``sharding.sp_sum``).
FPDT's host KV over the sp ranks raises (ROADMAP queue A item 11's
leftover), the hosted residual with sp raises JAX's error.

Pipeline parallelism (a pp mesh axis): the layer stack runs as
``parallel/pipeline.pipelined_layers`` over this stage's L / PP layers
(the stage recomputed in the backward, as JAX's is).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from deepspeed_tpu_torch._device import DeviceLike, resolve_device
from deepspeed_tpu_torch.ops.attention import (multi_head_attention,
                                               repeat_kv_heads)
from deepspeed_tpu_torch.parallel import pipeline, topology
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.runtime import sharding
from deepspeed_tpu_torch.utils.annotate import region

_A11 = "ROADMAP queue A item 11"
_A17 = "ROADMAP queue A item 17"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture switches covering the GPT-2/Llama families (the
    JAX ``TransformerConfig``'s fields this package runs; ``dtype`` is
    the compute and storage type of the weights, and the activations'
    type in the forward)."""

    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # None = MHA; < num_heads = GQA
    ffn_size: Optional[int] = None  # None = 4*hidden (gelu) or 8/3*hidden (swiglu)
    max_seq_len: int = 1024
    pos_emb: str = "learned"  # learned | rope | none
    norm: str = "layernorm"  # layernorm | rmsnorm
    activation: str = "gelu"  # gelu (exact erf) | gelu_tanh | swiglu | relu
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    use_biases: bool = False
    # Falcon-style parallel residual: x + attn(ln1(x)) + mlp(ln2(x))
    parallel_block: bool = False
    # recompute each layer in the backward (activation checkpointing)
    remat: bool = True
    # a policy name (runtime/activation_checkpointing.POLICIES); None
    # defers to the module's configured policy. A name here wins over an
    # engine's activation_checkpointing.policy; the engine pins the
    # resolved policy (a SavePolicy) on its copy of the config
    remat_policy: Optional[Any] = None
    attn_impl: str = "auto"  # auto | xla | flash | blocksparse (ops/attention)
    # sp attention over the sp mesh axis: ulysses (all-to-all) | ring
    sequence_parallel: bool = False
    sp_mode: str = "ulysses"
    # FPDT chunked attention: query chunks, 0/1 = off
    attn_chunks: int = 0
    # FPDT host KV: the K/V tiles in pinned host memory (attn_chunks,
    # at least 2, chunks)
    fpdt_host_kv: bool = False
    # FPDT hosted residual: the residual stream as host chunks between
    # layers (needs fpdt_host_kv and the sequential block; the loss goes
    # through loss_fn)
    fpdt_host_residual: bool = False
    # ALST tiled compute: sequence tiles, 0/1 = off
    tiled_logits: int = 0
    tiled_mlp: int = 0
    fp8_mlp: bool = False
    # ZeRO-Infinity streaming of the layer stack (the engine sets it from
    # zero_optimization.offload_param)
    param_host_offload: bool = False
    # the streamed stack: layers in flight ahead of the compute on the copy
    # stream (the engine sets it from performance.param_prefetch_depth);
    # serialize_fetch fetches each layer inside its remat'd step on the
    # compute stream instead (no overlap: the control the stream is
    # measured against)
    prefetch_depth: int = 2
    serialize_fetch: bool = False
    # JAX's stage-3 resident overlap (the engine sets it from
    # performance.overlap_depth): under a ZeRO-3 fetch hook over fsdp
    # ranks the layer stack runs through the overlap engine, layer i + k's
    # gather issued before layer i's compute (0: the remat'd loop)
    overlap_depth: int = 0

    def __post_init__(self):
        if self.sp_mode not in ("ulysses", "ring"):
            raise ValueError(
                f"sp_mode must be ulysses|ring, got {self.sp_mode!r}")
        if self.fpdt_host_residual:
            if not self.fpdt_host_kv:
                raise ValueError(
                    "fpdt_host_residual requires fpdt_host_kv (the "
                    "residual stack rides the same chunk grid as the "
                    "KV tiles)")
            if self.parallel_block:
                raise ValueError(
                    "fpdt_host_residual requires the fused sequential "
                    "block (attention+MLP per chunk); parallel_block "
                    "is not chunk-fusable this way")
            if self.sequence_parallel:
                raise ValueError(
                    "fpdt_host_residual does not compose with "
                    "sequence_parallel: the residual lives as a host "
                    "chunk stack, which cannot also be sharded over sp")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn(self) -> int:
        if self.ffn_size:
            return self.ffn_size
        if self.activation == "swiglu":
            d = int(8 * self.hidden_size / 3)
            return 256 * ((d + 255) // 256)
        return 4 * self.hidden_size

    def flops_per_token(self) -> float:
        """Approximate training FLOPs/token (fwd+bwd ~ 6 N params + the
        attention term at ``max_seq_len``), as the JAX config counts."""
        attn = 12 * self.num_layers * self.hidden_size * self.max_seq_len
        return 6 * self.num_params() + attn

    def num_params(self) -> int:
        h, L, f, v = self.hidden_size, self.num_layers, self.ffn, self.vocab_size
        hd, nh, nkv = self.head_dim, self.num_heads, self.kv_heads
        attn = h * nh * hd + 2 * h * nkv * hd + nh * hd * h
        mlp = (3 if self.activation == "swiglu" else 2) * h * f
        norm_width = 2 * h if self.norm == "layernorm" else h
        per_layer = attn + mlp + 2 * norm_width
        emb = v * h + (0 if self.tie_embeddings else v * h)
        pos = self.max_seq_len * h if self.pos_emb == "learned" else 0
        return L * per_layer + emb + pos + norm_width


def act_fn(name: str):
    """Activation by config name ("gelu" is the exact erf form,
    "gelu_tanh"/"gelu_new" the tanh approximation)."""
    if name == "relu":
        return F.relu
    if name in ("gelu_tanh", "gelu_new"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"unknown activation {name!r}")


@region("norm")
def _norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str,
          eps: float) -> torch.Tensor:
    """LayerNorm / RMSNorm computed in fp32 and cast back to x's type."""
    x32 = x.float()
    if kind == "rmsnorm":
        rms = torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
        out = x32 / rms * p["scale"].float()
    else:
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) / torch.sqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """fp32 (cos, sin) of the rotary angles, [..., 1, head_dim // 2]
    (broadcast over heads); with :func:`apply_rope`, the JAX ``_rope``.
    A forward computes them once and every layer's q and k reuse them."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


@region("rope")
def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x [..., heads, head_dim] (math in fp32, cast
    back to x's type)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The JAX ``init_params`` tree layout as shapes, with each leaf's
    init scale: ("normal", std) or ("ones",) / ("zeros",)."""
    h, L, f = cfg.hidden_size, cfg.num_layers, cfg.ffn
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim

    def dense(*shape, std=None):
        # without std: a stacked layer leaf [L, fan_in, ...] at the JAX
        # _dense_init default 1/sqrt(fan_in) of the per-layer leaf
        return (shape, ("normal", std if std is not None
                        else 1.0 / math.sqrt(shape[1])))

    attn = {
        "wq": dense(L, h, nh, hd),
        "wk": dense(L, h, nkv, hd),
        "wv": dense(L, h, nkv, hd),
        "wo": dense(L, nh, hd, h, std=1.0 / math.sqrt(nh * hd)),
    }
    if cfg.use_biases:
        attn.update(bq=((L, nh, hd), ("zeros",)),
                    bk=((L, nkv, hd), ("zeros",)),
                    bv=((L, nkv, hd), ("zeros",)),
                    bo=((L, h), ("zeros",)))
    mlp = {"wi": dense(L, h, f), "wo": dense(L, f, h)}
    if cfg.activation == "swiglu":
        mlp["wg"] = dense(L, h, f)
    if cfg.use_biases:
        mlp.update(bi=((L, f), ("zeros",)), bo=((L, h), ("zeros",)))
    tree: Dict[str, Any] = {
        "embed": {"tokens": dense(cfg.vocab_size, h, std=0.02)},
        "layers": {
            "attn": attn,
            "mlp": mlp,
            "ln1": {"scale": ((L, h), ("ones",))},
            "ln2": {"scale": ((L, h), ("ones",))},
        },
        "final_norm": {"scale": ((h,), ("ones",))},
    }
    if cfg.norm == "layernorm":
        tree["layers"]["ln1"]["bias"] = ((L, h), ("zeros",))
        tree["layers"]["ln2"]["bias"] = ((L, h), ("zeros",))
        tree["final_norm"]["bias"] = ((h,), ("zeros",))
    if cfg.pos_emb == "learned":
        tree["embed"]["positions"] = dense(cfg.max_seq_len, h, std=0.01)
    if not cfg.tie_embeddings:
        tree["unembed"] = {"kernel": dense(h, cfg.vocab_size, std=0.02)}
    return tree


def _is_leaf(node) -> bool:
    return isinstance(node, tuple)


def logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Logical axis names per param leaf (JAX's; they drive the ZeRO
    sharding, ``runtime/sharding.py``)."""
    axes: Dict[str, Any] = {
        "embed": {"tokens": ("vocab", "embed")},
        "layers": {
            "attn": {
                "wq": ("layers", "embed", "heads", "head_dim"),
                "wk": ("layers", "embed", "kv_heads", "head_dim"),
                "wv": ("layers", "embed", "kv_heads", "head_dim"),
                "wo": ("layers", "heads", "head_dim", "embed"),
            },
            "mlp": {
                "wi": ("layers", "embed", "mlp"),
                "wo": ("layers", "mlp", "embed"),
            },
            "ln1": {"scale": ("layers", "embed")},
            "ln2": {"scale": ("layers", "embed")},
        },
        "final_norm": {"scale": ("embed",)},
    }
    if cfg.norm == "layernorm":
        axes["layers"]["ln1"]["bias"] = ("layers", "embed")
        axes["layers"]["ln2"]["bias"] = ("layers", "embed")
        axes["final_norm"]["bias"] = ("embed",)
    if cfg.use_biases:
        axes["layers"]["attn"]["bq"] = ("layers", "heads", "head_dim")
        axes["layers"]["attn"]["bk"] = ("layers", "kv_heads", "head_dim")
        axes["layers"]["attn"]["bv"] = ("layers", "kv_heads", "head_dim")
        axes["layers"]["attn"]["bo"] = ("layers", "embed")
        axes["layers"]["mlp"]["bi"] = ("layers", "mlp")
        axes["layers"]["mlp"]["bo"] = ("layers", "embed")
    if cfg.pos_emb == "learned":
        axes["embed"]["positions"] = ("seq", "embed")
    if cfg.activation == "swiglu":
        axes["layers"]["mlp"]["wg"] = ("layers", "embed", "mlp")
    if not cfg.tie_embeddings:
        axes["unembed"] = {"kernel": ("embed", "vocab")}
    return axes


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., h] contracted with w [h, *out] -> [..., *out]."""
    out = torch.matmul(x, w.reshape(w.shape[0], -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _attention(q, k, v, cfg: TransformerConfig, causal: bool = True):
    """The attention op (JAX's dispatch): under ``sequence_parallel`` the
    ring (already blockwise: ``attn_chunks`` adds nothing there) or
    Ulysses; else FPDT chunked attention with ``attn_chunks`` > 1, else
    ``multi_head_attention``."""
    if cfg.sequence_parallel:
        if cfg.sp_mode == "ring":
            from deepspeed_tpu_torch.parallel.ring_attention import \
                ring_attention

            return ring_attention(q, k, v, causal=causal)
        from deepspeed_tpu_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, causal=causal, impl=cfg.attn_impl,
                                 attn_chunks=cfg.attn_chunks)
    if cfg.attn_chunks > 1:
        from deepspeed_tpu_torch.parallel.fpdt import chunked_attention

        return chunked_attention(q, k, v, causal=causal,
                                 q_chunks=cfg.attn_chunks)
    return multi_head_attention(q, k, v, causal=causal, impl=cfg.attn_impl)


def _fpdt_post_fn(cfg: TransformerConfig, layer_params):
    """The fused block tail of the fpdt paths, per chunk: residual add,
    ln2 and the MLP."""
    ap = layer_params["attn"]
    dt = cfg.dtype

    def post_fn(x_chunk, attn_chunk):
        if cfg.use_biases:
            attn_chunk = attn_chunk + ap["bo"].to(dt)
        xc = x_chunk + attn_chunk
        return xc + _mlp(cfg, _norm(xc, layer_params["ln2"], cfg.norm,
                                    cfg.norm_eps), layer_params["mlp"])

    return post_fn


def _one_tp_rank(what: str) -> None:
    """A branch that runs on whole heads raises at tp > 1."""
    if sharding.tp_size() > 1:
        raise NotImplementedError(
            f"{what} at tp={sharding.tp_size()} is not ported yet: a TP "
            "leftover listed under ROADMAP queue A's A11 TP entry (the "
            "FPDT host paths and the streamed stack run whole heads)")


def _layer(cfg: TransformerConfig, x, layer_params, rope):
    """One transformer block; x [B, S, H] in cfg.dtype. ``rope`` is the
    forward's (cos, sin) tables or None."""
    x = x.to(cfg.dtype)
    if cfg.fpdt_host_kv:
        _one_tp_rank("fpdt_host_kv")
        if cfg.sequence_parallel and sharding.sp_size() > 1:
            from deepspeed_tpu_torch.parallel.fpdt import _A11_SP

            raise NotImplementedError(
                f"fpdt_host_kv with sequence_parallel at sp="
                f"{sharding.sp_size()}: {_A11_SP}")
        return _fpdt_layer(cfg, x, layer_params, rope)
    attn = _attention_half(cfg, x, layer_params, rope)
    return _layer_mlp(cfg, x, attn, layer_params)


@region("attention")
def _fpdt_layer(cfg: TransformerConfig, x, layer_params, rope):
    """The host-KV block (JAX ``_layer``'s ``fpdt_host_kv`` branch): q, k,
    v and the context never exist at full S on the card, ln1 and (for the
    sequential block) the residual add and the MLP run per chunk."""
    from deepspeed_tpu_torch.parallel.fpdt import fpdt_attention_block

    ap = layer_params["attn"]
    fuse_mlp = not cfg.parallel_block and "mlp" in layer_params
    res = fpdt_attention_block(
        x, ap, rope, num_heads=cfg.num_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim, q_chunks=max(cfg.attn_chunks, 2),
        causal=True, use_biases=cfg.use_biases,
        norm_fn=lambda t: _norm(t, layer_params["ln1"], cfg.norm,
                                cfg.norm_eps),
        post_fn=_fpdt_post_fn(cfg, layer_params) if fuse_mlp else None)
    if fuse_mlp:
        return res
    attn = res
    if cfg.use_biases:
        attn = attn + ap["bo"].to(cfg.dtype)
    return _layer_mlp(cfg, x, attn, layer_params)


@region("attention")
def _attention_half(cfg: TransformerConfig, x, layer_params, rope):
    """The attention half of the block: norm, the q / k / v projections,
    rope, attention and the output projection (the residual add is the
    MLP half's)."""
    ap = layer_params["attn"]
    dt = cfg.dtype
    y = sharding.tp_copy(_norm(x, layer_params["ln1"], cfg.norm,
                               cfg.norm_eps))
    qkv = []
    for name in ("q", "k", "v"):
        with ac.checkpoint_name("qkv_proj"):
            t = _proj(y, ap[f"w{name}"].to(dt))
            if cfg.use_biases:
                t = t + ap[f"b{name}"].to(dt)
        qkv.append(t)
    q, k, v = qkv
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    if cfg.sequence_parallel or cfg.attn_chunks > 1:
        # the sp and chunked paths split on the head axis and need equal
        # q / kv head counts; the flash kernels read grouped KV natively
        k, v = repeat_kv_heads(q, k, v)
    with ac.checkpoint_name("attn_kernel_out"):
        attn = _attention(q, k, v, cfg)
    wo = ap["wo"].to(dt)
    with ac.checkpoint_name("attn_out"):
        attn = torch.matmul(attn.reshape(*attn.shape[:-2], -1),
                            wo.reshape(-1, wo.shape[-1]))
    # row-parallel: this rank's heads give a partial sum
    attn = sharding.tp_reduce(attn)
    if cfg.use_biases:
        attn = attn + ap["bo"].to(dt)
    return attn


@region("mlp")
def _layer_mlp(cfg: TransformerConfig, x, attn, layer_params):
    """Residual add and the MLP half of the block (sequential, or
    Falcon's parallel block where both branches read the pre-attention
    residual)."""
    mp = layer_params["mlp"]
    if not cfg.parallel_block:
        x = x + attn
    if cfg.tiled_mlp > 1:
        # position-wise, so the sequence is chunked (ALST TiledMLP): ln2
        # runs inside the tile too, so its fp32 intermediate is tile-sized
        from deepspeed_tpu_torch.parallel.tiled_compute import tiled_mlp

        out = tiled_mlp(lambda t: _mlp(cfg, _norm(
            t, layer_params["ln2"], cfg.norm, cfg.norm_eps), mp), x,
            cfg.tiled_mlp)
    else:
        out = _mlp(cfg, _norm(x, layer_params["ln2"], cfg.norm,
                              cfg.norm_eps), mp)
    if cfg.parallel_block:
        return x + attn + out
    return x + out


def _mlp(cfg: TransformerConfig, y, mp):
    """The MLP on its normed input (``mlp_out`` names its output); under
    ``fp8_mlp`` its three products run in fp8 with straight-through
    gradients (JAX's ``fp8_matmul_ste``)."""
    dt = cfg.dtype
    y = sharding.tp_copy(y)
    if cfg.fp8_mlp:
        from deepspeed_tpu_torch.ops.fp_quantizer import fp8_matmul_ste

        def matmul(a, w):
            return fp8_matmul_ste(a, w.to(dt), out_dtype=dt)
    else:
        def matmul(a, w):
            return torch.matmul(a, w.to(dt))
    if cfg.activation == "swiglu":
        z = F.silu(matmul(y, mp["wg"])) * matmul(y, mp["wi"])
    else:
        pre = matmul(y, mp["wi"])
        if cfg.use_biases:
            pre = pre + mp["bi"].to(dt)
        z = act_fn(cfg.activation)(pre)
    with ac.checkpoint_name("mlp_out"):
        out = matmul(z, mp["wo"])
    out = sharding.tp_reduce(out)  # row-parallel over the MLP width
    if cfg.use_biases:
        out = out + mp["bo"].to(dt)
    return out


def _unstack_layers(layers: Dict[str, Any], num_layers: int):
    """The stacked ``[L, ...]`` layer tree as L trees of views. One
    ``unbind`` per leaf, so the backward stacks each leaf's L gradients
    once instead of scattering every layer's into a full-size zero
    tensor. A leaf that is neither a tensor nor a dict (a weight-only
    int8 ``QuantizedTensor``) is indexed per layer, and dequantizes at
    its use (``.to(dt)``)."""
    def walk(node):
        if isinstance(node, torch.Tensor):
            return torch.unbind(node, 0)
        if hasattr(node, "items"):
            return {k: walk(v) for k, v in node.items()}
        return tuple(node[l] for l in range(num_layers))

    def pick(node, l):
        if isinstance(node, tuple):
            return node[l]
        return {k: pick(v, l) for k, v in node.items()}

    views = walk(layers)
    return [pick(views, l) for l in range(num_layers)]


def fetched_layer(fetch, fn, cfg, x, layer_params, *args):
    """``fn(cfg, x, layer_params, *args)`` on the layer's gathered
    leaves when a ZeRO-3 fetch hook is on (``runtime/sharding.py``); a
    remat'd layer runs this whole, so its recompute gathers again."""
    if fetch is not None:
        layer_params = fetch.layer(layer_params)
    return fn(cfg, x, layer_params, *args)


def embed_tokens(cfg, params, tokens, positions, fetch):
    """The token (and learned position) embeddings in cfg.dtype, each
    table gathered at its use under a fetch hook."""
    dt = cfg.dtype
    table = sharding.fetched(fetch, params, "/embed/tokens").to(dt)
    if sharding.tp_size() > 1:  # the vocab rows shard over tp
        x = sharding.vocab_parallel_lookup(table, tokens,
                                           vocab=cfg.vocab_size)
    else:
        x = F.embedding(tokens.long(), table)
    if cfg.pos_emb == "learned":
        x = x + sharding.fetched(fetch, params, "/embed/positions").to(
            dt)[positions.long()]
    return x


def final_norm_of(cfg, params, x, fetch):
    return _norm(x, {k: sharding.fetched(fetch, params, f"/final_norm/{k}")
                     for k in params["final_norm"]}, cfg.norm, cfg.norm_eps)


def unembed(cfg, params, x, fetch):
    """fp32 logits of the hidden states (the LM head gathered at its use
    under a fetch hook); at tp > 1 this rank's vocab slice of them
    (``sharding.tp_gather`` makes them whole)."""
    x = sharding.tp_copy(x)
    if cfg.tie_embeddings:
        table = sharding.fetched(fetch, params, "/embed/tokens")
        return torch.matmul(x, table.to(cfg.dtype).t()).float()
    kernel = sharding.fetched(fetch, params, "/unembed/kernel")
    return torch.matmul(x, kernel.to(cfg.dtype)).float()


def apply_hidden(cfg: TransformerConfig, params: Dict[str, Any],
                 tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 final_norm: bool = True) -> torch.Tensor:
    """Forward pass up to (and including, unless ``final_norm=False``)
    the final norm: tokens [B, S] -> hidden [B, S, H] in cfg.dtype. Under
    a ZeRO-3 fetch hook (``sharding.active_fetch``) each layer gathers
    its leaves inside the layer (JAX's ``streamed_layers_prefetch(fetch=
    fsdp_gather_slice, grad_sink=fsdp_scatter_grads)``), and the
    embeddings and the final norm are gathered at their use."""
    B, S = tokens.shape
    if cfg.fpdt_host_residual:
        raise ValueError(
            "fpdt_host_residual: use apply_hidden_hosted / the loss path "
            "(apply_hidden would build the full-S buffer this mode "
            "removes)")
    if positions is None:
        positions = local_positions(cfg, S, tokens.device)
    fetch = sharding.active_fetch()
    x = embed_tokens(cfg, params, tokens, positions, fetch)
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos_emb == "rope" else None)
    if pipeline.pipeline_enabled(topology._GLOBAL_MESH):
        # pp > 1: the stack as a microbatched stage pipeline (each stage
        # recomputed in the backward, as JAX's is)
        x = pipeline.pipelined_layers(
            lambda c, lp: fetched_layer(fetch, _layer, cfg, c, lp, rope),
            params["layers"], x)
    elif cfg.param_host_offload:
        _one_tp_rank("offload_param")
        x = _streamed_stack(cfg, params["layers"], x, rope)
    elif cfg.overlap_depth and fetch is not None and fetch.stage3 and \
            sharding.fsdp_size() > 1:
        x = _overlapped_stack(cfg, params["layers"], x, rope, fetch)
    else:
        step = (ac.checkpoint_wrapper(fetched_layer, policy=cfg.remat_policy)
                if cfg.remat else fetched_layer)
        for layer_params in _unstack_layers(params["layers"],
                                            cfg.num_layers):
            x = step(fetch, _layer, cfg, x, layer_params, rope)
    if not final_norm:
        return x
    return final_norm_of(cfg, params, x, fetch)


def local_positions(cfg: TransformerConfig, S: int, device) -> torch.Tensor:
    """[1, S] positions of this rank's tokens: its sequence block's under
    sp (from ``sp_index * S``), else 0..S-1. A sequence-parallel mesh
    needs the model's ``sequence_parallel`` (its attention exchanges the
    blocks)."""
    pos = torch.arange(S, device=device)[None, :]
    if sharding.sp_size() > 1:
        if not cfg.sequence_parallel:
            raise ValueError(
                f"an sp mesh axis of {sharding.sp_size()} ranks gives each "
                "rank a block of the sequence: the model needs "
                "sequence_parallel=True (the sequence_parallel block's "
                "auto_plan sets it)")
        pos = pos + sharding.sp_index() * S
    return pos


def _streamed_stack(cfg: TransformerConfig, layers, x, rope):
    """ZeRO-Infinity streaming of the host layer stack (JAX
    ``apply_hidden``'s ``param_host_offload`` branch): the prefetch
    streamer (``prefetch_depth`` layers in flight, a per-layer recompute:
    ``nothing_saveable``), or, with ``serialize_fetch``, a fetch inside
    each remat'd layer on the compute stream."""
    from deepspeed_tpu_torch.runtime import param_stream

    fetch = sharding.active_fetch()
    whole = sink = None
    if fetch is not None and fetch.stage3 and sharding.fsdp_size() > 1:
        # a host stack of ZeRO-3 blocks: each fetched layer gathered over
        # fsdp, its gradient reduce-scattered back before it lands
        if cfg.serialize_fetch:
            raise NotImplementedError(
                "offload_param's serialize_fetch with a ZeRO-3 stack over "
                f"fsdp ranks: the prefetch stream runs it ({_A17})")
        axes = fetch.layer_axes
        whole = lambda tree: sharding.fsdp_gather_layer(  # noqa: E731
            tree, None, axes)
        sink = lambda tree: sharding.fsdp_scatter_grads(  # noqa: E731
            tree, axes, fetch.qgz)
    if not cfg.serialize_fetch:
        if cfg.remat and ac.resolve_policy(cfg.remat_policy) is not None:
            from deepspeed_tpu_torch.utils.logging import warning_once

            warning_once(
                "offload_param prefetch streaming remats per layer "
                f"(nothing_saveable); remat_policy={cfg.remat_policy!r} "
                "does not apply to the streamed stack")
        return param_stream.streamed_layers_prefetch(
            lambda xx, lp: _layer(cfg, xx, lp, rope), layers, x,
            length=cfg.num_layers, prefetch_depth=cfg.prefetch_depth,
            whole=whole, sink=sink)
    return param_stream.scan_streamed(
        lambda xx, lp: _layer(cfg, xx, lp, rope), x, layers,
        length=cfg.num_layers, remat=cfg.remat,
        remat_policy=cfg.remat_policy, device=x.device)


def _overlapped_stack(cfg: TransformerConfig, layers, x, rope, fetch):
    """JAX's stage-3 resident overlap (``models/transformer.py:831-850``):
    the overlap engine over the resident block stack, the per-layer fsdp
    gather as its fetch (``overlap_depth`` layers ahead) and the
    per-layer reduce-scatter as its gradient sink, per-layer
    recompute."""
    from deepspeed_tpu_torch.runtime import param_stream

    if fetch.qwz_bits is not None or fetch.experts is not None:
        raise NotImplementedError(
            "performance.overlap_depth with qwZ's int8 gather or qgZ's "
            f"expert groups: the remat'd layer loop runs them ({_A17})")
    axes = fetch.layer_axes
    return param_stream.resident_layers_prefetch(
        lambda xx, lp: _layer(cfg, xx, lp, rope), layers, x,
        fetch=lambda stack, i: sharding.fsdp_gather_layer(stack, i, axes),
        grad_sink=lambda g: sharding.fsdp_scatter_grads(g, axes, fetch.qgz),
        length=cfg.num_layers, prefetch_depth=cfg.overlap_depth)


def apply_hidden_hosted(cfg: TransformerConfig, params: Dict[str, Any],
                        tokens: torch.Tensor,
                        positions: Optional[torch.Tensor] = None):
    """The ``fpdt_host_residual`` forward: tokens [B, S] -> the residual
    stream as a tuple of host chunks [B, C, H] (the padded sequence on
    the chunk grid; no final norm: the hosted loss fuses it a chunk at a
    time). The card holds one chunk (and one KV tile) at a time.

    Returns (chunks, S, C)."""
    from deepspeed_tpu_torch.parallel import fpdt

    _one_tp_rank("fpdt_host_residual")
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(S, device=dev)[None, :]
    positions = positions.expand(B, S)
    T = max(cfg.attn_chunks, 2)
    C = -(-S // T)
    Sp = T * C
    fetch = sharding.active_fetch()
    if fetch is not None:
        raise NotImplementedError(
            "fpdt_host_residual with a ZeRO-3 fetch across ranks: "
            f"{_A11}'s multi-card part")
    tokens_p = torch.nn.functional.pad(tokens, (0, Sp - S))
    pos_p = torch.nn.functional.pad(positions, (0, Sp - S))
    # the embedding, chunk by chunk, each chunk straight to the host
    x_t = tuple(fpdt.to_host(embed_tokens(
        cfg, params, tokens_p[:, t * C:(t + 1) * C],
        pos_p[:, t * C:(t + 1) * C], None)) for t in range(T))
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos_emb == "rope" else None)
    if "mlp" not in params["layers"]:
        raise ValueError("fpdt_host_residual needs the fused sequential "
                         "block (mlp present, parallel_block off)")
    layers = params["layers"]
    if cfg.param_host_offload:
        from deepspeed_tpu_torch.runtime import param_stream

        slices = [param_stream.fetch_layer(lp, dev) for lp in
                  param_stream.host_layers(layers, cfg.num_layers)]
    else:
        slices = _unstack_layers(layers, cfg.num_layers)
    for lp in slices:
        x_t = fpdt.fpdt_hosted_layer(
            x_t, lp, rope, seq_len=S, q_chunks=T, num_heads=cfg.num_heads,
            kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
            use_biases=cfg.use_biases, norm_kind=cfg.norm,
            norm_eps=cfg.norm_eps, activation=cfg.activation, device=dev)
    return x_t, S, C


def _hosted_chunk_nll(cfg, params, host, lbl, m, device):
    from deepspeed_tpu_torch.parallel.fpdt import to_device

    h = _norm(to_device(host, device), params["final_norm"], cfg.norm,
              cfg.norm_eps)
    logits = unembed(cfg, params, h, None)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lbl.long()[..., None])[..., 0]
    return ((logz - gold) * m).sum(), m.sum()


@region("vocab_head")
def hosted_logits_loss(cfg: TransformerConfig, params, x_t, labels, mask,
                       S: int, C: int):
    """Fused final norm + unembed + cross-entropy over the host residual
    chunks (the hosted twin of ``tiled_logits_loss``; each chunk is
    fetched again in its recompute). Returns (masked nll sum, mask
    total)."""
    B = labels.shape[0]
    dev = labels.device
    Sp = len(x_t) * C
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=dev)
    labels_p = torch.nn.functional.pad(labels, (0, Sp - S))
    mask_p = torch.nn.functional.pad(mask.float(), (0, Sp - S))
    nll_sum = torch.zeros((), dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for t, host in enumerate(x_t):
        a, b = torch.utils.checkpoint.checkpoint(
            _hosted_chunk_nll, cfg, params, host,
            labels_p[:, t * C:(t + 1) * C], mask_p[:, t * C:(t + 1) * C],
            dev, use_reentrant=False)
        nll_sum = nll_sum + a
        total = total + b
    return nll_sum, total


def apply(cfg: TransformerConfig, params: Dict[str, Any],
          tokens: torch.Tensor,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward pass: tokens [B, S] -> logits [B, S, V] float32."""
    if cfg.fpdt_host_residual:
        # small-shape path: the hosted chunks assembled on the card (the
        # long-context use goes through loss_fn)
        from deepspeed_tpu_torch.parallel.fpdt import to_device

        x_t, S, _ = apply_hidden_hosted(cfg, params, tokens, positions)
        x = torch.cat([to_device(c, tokens.device) for c in x_t],
                      dim=1)[:, :S]
        x = final_norm_of(cfg, params, x, None)
    else:
        x = apply_hidden(cfg, params, tokens, positions)
    return sharding.tp_gather(unembed(cfg, params, x,
                                      sharding.active_fetch()))


def loss_fn(cfg: TransformerConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross-entropy. batch: {input_ids [B, S]} or
    {input_ids, labels, loss_mask}, as tensors on the model's device."""
    inputs, labels, mask = lm_batch(batch)
    if cfg.fpdt_host_residual:
        # the residual lives on the host; the loss fuses the final norm,
        # the unembed and the cross-entropy per fetched chunk
        x_t, S, C = apply_hidden_hosted(cfg, params, inputs)
        return _mean_loss(*hosted_logits_loss(cfg, params, x_t, labels,
                                              mask, S, C))
    if cfg.tiled_logits > 1:
        # neither the [B, S, V] logits nor the [B, S, H] fp32 normed
        # hidden exist: the final norm runs inside each tile
        hidden = apply_hidden(cfg, params, inputs, final_norm=False)
        return _mean_loss(*tiled_lm_loss(cfg, params, hidden, labels,
                                         mask))
    hidden = apply_hidden(cfg, params, inputs)
    return lm_head_loss(cfg, params, hidden, labels, mask)


def lm_batch(batch: Dict[str, torch.Tensor]):
    """(inputs, labels, fp32 loss mask or None) of a causal-LM batch:
    {input_ids [B, S + 1]} shifted, or {input_ids, labels, loss_mask} as
    given. Under sp each rank's batch is its sequence block, cut after
    the shift (``topology.batch_sharding``), so it carries labels."""
    tokens = batch["input_ids"]
    if "labels" in batch:
        inputs, labels = tokens, batch["labels"]
    elif sharding.sp_size() > 1:
        raise ValueError(
            "under sequence parallelism each rank's batch is its block of "
            "the sequence after the next-token shift ({input_ids, labels}"
            "): cut it with topology.batch_sharding(mesh).take or "
            "parallel.ulysses.UlyssesSPDataLoaderAdapter")
    else:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.float()
        if mask.shape[1] == tokens.shape[1] and "labels" not in batch:
            mask = mask[:, 1:]
    return inputs, labels, mask


def _mean_loss(nll_sum, total):
    # under sp the global tokens' sums (each rank's part summed)
    nll_sum, total = sharding.sp_sum(nll_sum), sharding.sp_sum(total)
    total = torch.clamp(total, min=1.0)
    loss = nll_sum / total
    return loss, {"loss": loss, "ntokens": total}


@region("vocab_head")
def tiled_lm_loss(cfg: TransformerConfig, params: Dict[str, Any], hidden,
                  labels, mask):
    """``tiled_logits_loss`` on the hidden states before the final norm:
    (masked nll sum, mask total)."""
    from deepspeed_tpu_torch.parallel.tiled_compute import tiled_logits_loss

    fetch = sharding.active_fetch()
    fnorm = {k: sharding.fetched(fetch, params, f"/final_norm/{k}")
             for k in params["final_norm"]}
    if cfg.tie_embeddings:
        table = sharding.fetched(fetch, params, "/embed/tokens").to(cfg.dtype)
        transpose = True
    else:
        table = sharding.fetched(fetch, params, "/unembed/kernel").to(
            cfg.dtype)
        transpose = False
    return tiled_logits_loss(
        hidden, table, labels, mask, cfg.tiled_logits,
        transpose_unembed=transpose,
        tile_transform=lambda h: _norm(h, fnorm, cfg.norm, cfg.norm_eps))


@region("vocab_head")
def lm_head_loss(cfg: TransformerConfig, params: Dict[str, Any], hidden,
                 labels, mask):
    """The LM head and the cross-entropy on the final-normed hidden
    states: (loss, {"loss", "ntokens"}); ``mask`` None counts every
    position."""
    logits = unembed(cfg, params, hidden, sharding.active_fetch())
    # at tp > 1 over the vocab-sharded logits (never gathered)
    nll = sharding.vocab_parallel_nll(logits, labels)
    if mask is None:
        mask = torch.ones_like(nll)
    # the mean over the global tokens: under sp each rank's sums summed
    total = torch.clamp(sharding.sp_sum(mask.sum()), min=1.0)
    loss = sharding.sp_sum((nll * mask).sum()) / total
    return loss, {"loss": loss, "ntokens": total}


class TransformerLM(nn.Module):
    """Weights of one dense decoder in the JAX tree layout, with the
    JAX model protocol (``apply``, ``loss``, ``flops_per_token``) on a
    ``params`` tree.

    ``seed`` initialises every leaf from a seeded ``torch.Generator`` on
    ``device`` at the JAX init's scales (normal leaves are drawn in fp32
    one layer at a time, then stored in ``cfg.dtype``); ``seed=None``
    leaves the storage uninitialised for a loader to fill
    (``models/convert.py``). The two frameworks' generators give
    different numbers from the same seed: parity tests carry the JAX
    weights across instead.

    ``tp=(index, size)`` builds one tp rank's model: each leaf that
    ``TP_RULES`` shards is drawn whole from the same seeded stream (so
    every rank's slices come from one model) and only this rank's slice
    is kept, so no rank holds the whole model; ``self.tp`` records it.
    ``pp=(stage, stages)`` likewise keeps one pipeline stage's
    ``L / stages`` layers of each stacked layer leaf (``self.pp``).
    """

    def __init__(self, config: TransformerConfig, *, device: DeviceLike = None,
                 seed: Optional[int] = 0,
                 tp: Optional[Tuple[int, int]] = None,
                 pp: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.config = config
        self.tp = tuple(tp) if tp is not None and tp[1] > 1 else None
        self.pp = tuple(pp) if pp is not None and pp[1] > 1 else None
        dev = resolve_device(device)
        gen = None
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        self._tp_specs = (None if self.tp is None else
                          tp_dims(self.logical_axes(config)))
        self.tree = self._build(self.param_shapes(config), dev, gen)

    param_shapes = staticmethod(param_shapes)
    logical_axes = staticmethod(logical_axes)

    def _build(self, node, dev, gen, path=""):
        if _is_leaf(node):
            shape, init = node
            keep = None if self.tp is None else self._tp_specs.get(path)
            if keep is not None and shape[keep] % self.tp[1]:
                raise ValueError(f"tp={self.tp[1]} does not divide dim "
                                 f"{keep} of leaf {path} {tuple(shape)}")
            t = torch.empty(shape, dtype=self.config.dtype, device=dev)
            if gen is not None:
                _init_leaf(t, init, gen)
            if keep is not None:  # this rank's slice, the rest freed
                n = shape[keep] // self.tp[1]
                t = t.narrow(keep, self.tp[0] * n, n).clone()
            if self.pp is not None and path.startswith("/layers/"):
                if shape[0] % self.pp[1]:
                    raise AssertionError(f"num_layers {shape[0]} must "
                                         f"divide pp {self.pp[1]}")
                n = shape[0] // self.pp[1]  # this stage's layers
                t = t.narrow(0, self.pp[0] * n, n).clone()
            return nn.Parameter(t, requires_grad=False)
        children = {k: self._build(v, dev, gen, f"{path}/{k}")
                    for k, v in node.items()}
        if all(isinstance(c, nn.Parameter) for c in children.values()):
            return nn.ParameterDict(children)
        # a node with both leaves and subtrees (the MoE ``layers.moe``:
        # router beside experts) registers its leaves on the ModuleDict
        mod = nn.ModuleDict({k: c for k, c in children.items()
                             if not isinstance(c, nn.Parameter)})
        for k, c in children.items():
            if isinstance(c, nn.Parameter):
                mod.register_parameter(k, c)
        return mod

    @property
    def device(self) -> torch.device:
        return self.tree["embed"]["tokens"].device

    def params(self) -> Dict[str, Any]:
        """The parameter tree as nested dicts of tensors (the runner's
        ``params`` argument, the JAX tree's counterpart)."""
        def walk(mod):
            if isinstance(mod, nn.ParameterDict):
                return dict(mod.items())
            tree = {k: walk(v) for k, v in mod.items()}
            tree.update(mod.named_parameters(recurse=False))
            return tree
        return walk(self.tree)

    # The JAX model protocol. ``apply`` replaces nn.Module.apply (which
    # walks submodules): here, as in the JAX package, it is the forward.
    def apply(self, params: Dict[str, Any], tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return apply(self.config, params, tokens, positions)

    def loss(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return loss_fn(self.config, params, batch)

    def flops_per_token(self) -> float:
        return self.config.flops_per_token()

    def num_params(self) -> int:
        return self.config.num_params()


def tp_dims(axes, path: str = "") -> Dict[str, int]:
    """``/a/b`` path -> the dim ``TP_RULES`` shard over tp, for the leaves
    of a logical-axes tree that shard at all."""
    if _is_leaf(axes):
        d = sharding.axis_dim(sharding.spec_from_logical(
            axes, sharding.TP_RULES), "tp")
        return {} if d is None else {path: d}
    out: Dict[str, int] = {}
    for k, v in axes.items():
        out.update(tp_dims(v, f"{path}/{k}"))
    return out


def leaf_shapes(shapes, path: str = "") -> Dict[str, Tuple[int, ...]]:
    """``/a/b`` path -> the whole shape, of a ``param_shapes`` tree."""
    if _is_leaf(shapes):
        return {path: tuple(shapes[0])}
    out: Dict[str, Tuple[int, ...]] = {}
    for k, v in shapes.items():
        out.update(leaf_shapes(v, f"{path}/{k}"))
    return out


@torch.no_grad()
def _init_leaf(t: torch.Tensor, init, gen: torch.Generator) -> None:
    kind = init[0]
    if kind == "ones":
        t.fill_(1.0)
    elif kind == "zeros":
        t.zero_()
    else:
        std = init[1]
        # draw per leading slice in fp32: a stacked [L, h, ffn] leaf at
        # 8B would otherwise need a multi-GB fp32 temporary
        rows = t if t.dim() > 2 else t[None]
        for part in rows:
            tmp = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                              device=t.device)
            part.copy_(tmp.mul_(std))
