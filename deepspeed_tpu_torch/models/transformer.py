"""Decoder-only transformer LM for serving (port of
``deepspeed_tpu/models/transformer.py``).

Only what the ragged serving path reads is carried over: the
configuration's architecture fields, the parameter tree, the norm, the
rotary embedding and the activations. The forward itself lives in
``inference/model_runner.py``, as in the JAX package.

``TransformerLM`` is an ``nn.Module`` whose parameters keep the JAX
tree's names and its stacked ``[L, ...]`` layer layout
(``layers.attn.wq`` is ``[L, hidden, heads, head_dim]``), so the runner
reads ``params["layers"]["attn"]["wq"][l]`` exactly where the JAX runner
scans over the same leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture switches covering the GPT-2/Llama families (the
    serving fields of the JAX ``TransformerConfig``; ``dtype`` is the
    compute and storage type of the weights)."""

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


class TransformerLM(nn.Module):
    """Serving weights of one dense decoder in the JAX tree layout.

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
        self.tree = self._build(param_shapes(config), dev, gen)

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
        return nn.ModuleDict(children)

    @property
    def device(self) -> torch.device:
        return self.tree["embed"]["tokens"].device

    def params(self) -> Dict[str, Any]:
        """The parameter tree as nested dicts of tensors (the runner's
        ``params`` argument, the JAX tree's counterpart)."""
        def walk(mod):
            return {k: (walk(v) if isinstance(v, (nn.ModuleDict,
                                                  nn.ParameterDict))
                        else v) for k, v in mod.items()}
        return walk(self.tree)


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
