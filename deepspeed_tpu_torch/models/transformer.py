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
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
default ``nothing_saveable`` policy. The pipeline, FPDT, host-offload,
overlap, qwZ, tiled and fp8 branches are not ported: their config
switches raise ``NotImplementedError`` naming their ROADMAP item.
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
from deepspeed_tpu_torch.ops.attention import multi_head_attention
from deepspeed_tpu_torch.runtime import sharding

# JAX config switches of branches this package does not run yet: field ->
# (the values that mean "off", what to port first)
_A11 = "ROADMAP queue A item 11"
_UNPORTED_SWITCHES = {
    "sequence_parallel": ((False,), f"{_A11} (Ulysses / ring attention)"),
    "attn_chunks": ((0, 1), f"{_A11} (FPDT chunked attention)"),
    "fpdt_host_kv": ((False,), f"{_A11} (FPDT host KV)"),
    "fpdt_host_residual": ((False,), f"{_A11} (FPDT hosted residual)"),
    "tiled_logits": ((0, 1), f"{_A11} (tiled logits, tiled_compute.py)"),
    "tiled_mlp": ((0, 1), f"{_A11} (tiled MLP, tiled_compute.py)"),
    "fp8_mlp": ((False,), "ROADMAP queue A item 10 (fp8 MLP, "
                          "ops/fp_quantizer.py)"),
    "param_host_offload": ((False,), f"{_A11} (parameter offload, "
                                     "runtime/param_stream.py)"),
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture switches covering the GPT-2/Llama families (the
    JAX ``TransformerConfig``'s fields this package runs; ``dtype`` is
    the compute and storage type of the weights, and the activations'
    type in the forward). Switches of unported branches exist so that
    setting them raises instead of being ignored."""

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
    # recompute each layer in the backward (torch.utils.checkpoint)
    remat: bool = True
    attn_impl: str = "auto"  # auto | xla | flash | blocksparse (ops/attention)
    sequence_parallel: bool = False
    attn_chunks: int = 0
    fpdt_host_kv: bool = False
    fpdt_host_residual: bool = False
    tiled_logits: int = 0
    tiled_mlp: int = 0
    fp8_mlp: bool = False
    param_host_offload: bool = False

    def __post_init__(self):
        for name, (off, item) in _UNPORTED_SWITCHES.items():
            value = getattr(self, name)
            if value not in off:
                raise NotImplementedError(
                    f"TransformerConfig.{name}={value!r} is not ported to "
                    f"deepspeed_tpu_torch yet: {item}")

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
    """The plain attention branch (sequence parallelism and chunked
    attention raise at config construction)."""
    return multi_head_attention(q, k, v, causal=causal, impl=cfg.attn_impl)


def _layer(cfg: TransformerConfig, x, layer_params, rope):
    """One transformer block; x [B, S, H] in cfg.dtype. ``rope`` is the
    forward's (cos, sin) tables or None."""
    ap = layer_params["attn"]
    dt = cfg.dtype
    x = x.to(dt)
    y = _norm(x, layer_params["ln1"], cfg.norm, cfg.norm_eps)
    q = _proj(y, ap["wq"].to(dt))
    k = _proj(y, ap["wk"].to(dt))
    v = _proj(y, ap["wv"].to(dt))
    if cfg.use_biases:
        q = q + ap["bq"].to(dt)
        k = k + ap["bk"].to(dt)
        v = v + ap["bv"].to(dt)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    attn = _attention(q, k, v, cfg)
    wo = ap["wo"].to(dt)
    attn = torch.matmul(attn.reshape(*attn.shape[:-2], -1),
                        wo.reshape(-1, wo.shape[-1]))
    if cfg.use_biases:
        attn = attn + ap["bo"].to(dt)
    return _layer_mlp(cfg, x, attn, layer_params)


def _layer_mlp(cfg: TransformerConfig, x, attn, layer_params):
    """Residual add and the MLP half of the block (sequential, or
    Falcon's parallel block where both branches read the pre-attention
    residual)."""
    mp = layer_params["mlp"]
    dt = cfg.dtype
    if not cfg.parallel_block:
        x = x + attn
    y = _norm(x, layer_params["ln2"], cfg.norm, cfg.norm_eps)
    if cfg.activation == "swiglu":
        z = F.silu(torch.matmul(y, mp["wg"].to(dt))) * torch.matmul(
            y, mp["wi"].to(dt))
    else:
        pre = torch.matmul(y, mp["wi"].to(dt))
        if cfg.use_biases:
            pre = pre + mp["bi"].to(dt)
        z = act_fn(cfg.activation)(pre)
    out = torch.matmul(z, mp["wo"].to(dt))
    if cfg.use_biases:
        out = out + mp["bo"].to(dt)
    if cfg.parallel_block:
        return x + attn + out
    return x + out


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
    x = F.embedding(tokens.long(),
                    sharding.fetched(fetch, params, "/embed/tokens").to(dt))
    if cfg.pos_emb == "learned":
        x = x + sharding.fetched(fetch, params, "/embed/positions").to(
            dt)[positions.long()]
    return x


def final_norm_of(cfg, params, x, fetch):
    return _norm(x, {k: sharding.fetched(fetch, params, f"/final_norm/{k}")
                     for k in params["final_norm"]}, cfg.norm, cfg.norm_eps)


def unembed(cfg, params, x, fetch):
    """fp32 logits of the hidden states (the LM head gathered at its use
    under a fetch hook)."""
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
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :]
    fetch = sharding.active_fetch()
    x = embed_tokens(cfg, params, tokens, positions, fetch)
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos_emb == "rope" else None)
    for layer_params in _unstack_layers(params["layers"], cfg.num_layers):
        if cfg.remat:
            x = torch.utils.checkpoint.checkpoint(
                fetched_layer, fetch, _layer, cfg, x, layer_params, rope,
                use_reentrant=False)
        else:
            x = fetched_layer(fetch, _layer, cfg, x, layer_params, rope)
    if not final_norm:
        return x
    return final_norm_of(cfg, params, x, fetch)


def apply(cfg: TransformerConfig, params: Dict[str, Any],
          tokens: torch.Tensor,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward pass: tokens [B, S] -> logits [B, S, V] float32."""
    x = apply_hidden(cfg, params, tokens, positions)
    return unembed(cfg, params, x, sharding.active_fetch())


def loss_fn(cfg: TransformerConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross-entropy. batch: {input_ids [B, S]} or
    {input_ids, labels, loss_mask}, as tensors on the model's device."""
    tokens = batch["input_ids"]
    if "labels" in batch:
        inputs, labels = tokens, batch["labels"]
    else:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.float()
        if mask.shape[1] == tokens.shape[1] and "labels" not in batch:
            mask = mask[:, 1:]
    logits = apply(cfg, params, inputs)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    total = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / total
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
    """

    def __init__(self, config: TransformerConfig, *, device: DeviceLike = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        gen = None
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        self.tree = self._build(self.param_shapes(config), dev, gen)

    param_shapes = staticmethod(param_shapes)

    def _build(self, node, dev, gen):
        if _is_leaf(node):
            shape, init = node
            t = torch.empty(shape, dtype=self.config.dtype, device=dev)
            if gen is not None:
                _init_leaf(t, init, gen)
            return nn.Parameter(t, requires_grad=False)
        children = {k: self._build(v, dev, gen) for k, v in node.items()}
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
