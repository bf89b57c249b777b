"""Mixture-of-Experts transformer LM, the Mixtral / Qwen-MoE family
(port of ``deepspeed_tpu/models/moe_transformer.py``).

The dense model's attention, norm and rope (``models/transformer.py``,
so training attention goes through the flash kernels) with the FFN
swapped for ``parallel/moe.py``'s dropless grouped-GEMM dispatch. The
parameter tree is the JAX one: ``layers.moe.router`` [L, h, E] and
``layers.moe.experts.{wi, wg}`` [L, E, h, f] / ``wo`` [L, E, f, h] in
place of ``layers.mlp``.

``apply`` returns (logits, the summed aux loss); ``remat`` wraps each
layer in ``torch.utils.checkpoint`` as the dense model does. The
pipeline and ``param_host_offload`` branches are not ported: a pipeline
config block and the ``param_host_offload`` switch raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.parallel.moe import GateConfig, moe_ffn
from deepspeed_tpu_torch.runtime import sharding
from deepspeed_tpu_torch.utils.annotate import region


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig(tf.TransformerConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    drop_tokens: bool = True
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.0
    # "auto" | "grouped" (dropless grouped-GEMM); "einsum" is not ported
    moe_impl: str = "auto"

    def __post_init__(self):
        super().__post_init__()
        if self.moe_impl == "einsum":
            raise NotImplementedError(
                "moe_impl='einsum' (the capacity-padded dispatch) is not "
                "ported to deepspeed_tpu_torch yet: ROADMAP queue A item 9")
        if self.moe_impl not in ("auto", "grouped"):
            raise ValueError(f"unknown moe_impl {self.moe_impl!r}; known: "
                             "auto, grouped, einsum")

    @property
    def gate(self) -> GateConfig:
        return GateConfig(
            num_experts=self.num_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            eval_capacity_factor=self.eval_capacity_factor,
            min_capacity=self.min_capacity, drop_tokens=self.drop_tokens,
            aux_loss_weight=self.aux_loss_weight,
            z_loss_weight=self.z_loss_weight)

    def num_params(self) -> int:
        h, L, f, v = self.hidden_size, self.num_layers, self.ffn, self.vocab_size
        nh, nkv, hd = self.num_heads, self.kv_heads, self.head_dim
        attn = h * nh * hd + 2 * h * nkv * hd + nh * hd * h
        expert = (3 if self.activation == "swiglu" else 2) * h * f
        router = h * self.num_experts
        norm_width = 2 * h if self.norm == "layernorm" else h
        per_layer = attn + self.num_experts * expert + router + 2 * norm_width
        emb = v * h + (0 if self.tie_embeddings else v * h)
        pos = self.max_seq_len * h if self.pos_emb == "learned" else 0
        return L * per_layer + emb + pos + norm_width

    def active_params(self) -> int:
        """Params touched per token (top_k of num_experts)."""
        h, L, f = self.hidden_size, self.num_layers, self.ffn
        expert = (3 if self.activation == "swiglu" else 2) * h * f
        return self.num_params() - L * (self.num_experts - self.top_k) * expert

    def flops_per_token(self) -> float:
        return 6 * self.active_params() + \
            12 * self.num_layers * self.hidden_size * self.max_seq_len


def param_shapes(cfg: MoETransformerConfig) -> Dict[str, Any]:
    """The JAX MoE ``init_params`` tree as shapes and init scales: the
    dense tree with ``layers.mlp`` replaced by router + stacked experts."""
    tree = tf.param_shapes(cfg)
    h, L, f, E = cfg.hidden_size, cfg.num_layers, cfg.ffn, cfg.num_experts
    experts = {"wi": ((L, E, h, f), ("normal", 1.0 / math.sqrt(h))),
               "wo": ((L, E, f, h), ("normal", 1.0 / math.sqrt(f)))}
    if cfg.activation == "swiglu":
        experts["wg"] = ((L, E, h, f), ("normal", 1.0 / math.sqrt(h)))
    del tree["layers"]["mlp"]
    tree["layers"]["moe"] = {
        "router": ((L, h, E), ("normal", 1.0 / math.sqrt(h))),
        "experts": experts,
    }
    return tree


def logical_axes(cfg: MoETransformerConfig) -> Dict[str, Any]:
    """Logical axis names per param leaf (JAX's): the dense model's, with
    the router and the expert stacks in the MLP's place."""
    axes = tf.logical_axes(cfg)
    moe = {
        "router": ("layers", "embed", None),
        "experts": {
            "wi": ("layers", "expert", "embed", "mlp"),
            "wo": ("layers", "expert", "mlp", "embed"),
        },
    }
    if cfg.activation == "swiglu":
        moe["experts"]["wg"] = ("layers", "expert", "embed", "mlp")
    axes["layers"]["moe"] = moe
    del axes["layers"]["mlp"]
    return axes


def _moe_layer(cfg: MoETransformerConfig, x, layer_params, rope,
               train: bool):
    """Transformer block with the MoE FFN. Returns (x, l_aux fp32)."""
    ap = layer_params["attn"]
    dt = cfg.dtype
    x = x.to(dt)
    y = tf._norm(x, layer_params["ln1"], cfg.norm, cfg.norm_eps)
    q = tf._proj(y, ap["wq"].to(dt))
    k = tf._proj(y, ap["wk"].to(dt))
    v = tf._proj(y, ap["wv"].to(dt))
    if rope is not None:
        q = tf.apply_rope(q, *rope)
        k = tf.apply_rope(k, *rope)
    attn = tf._attention(q, k, v, cfg)
    wo = ap["wo"].to(dt)
    x = x + torch.matmul(attn.reshape(*attn.shape[:-2], -1),
                         wo.reshape(-1, wo.shape[-1]))

    y = tf._norm(x, layer_params["ln2"], cfg.norm, cfg.norm_eps)
    out, aux = _moe_mlp(cfg, y, layer_params, train)
    l_aux = aux["l_aux"] * cfg.aux_loss_weight
    if cfg.z_loss_weight:
        l_aux = l_aux + aux["l_zloss"] * cfg.z_loss_weight
    return x + out, l_aux


@region("mlp")
def _moe_mlp(cfg: MoETransformerConfig, y, layer_params, train: bool):
    """The MoE FFN of a block on its normed input: (out, aux)."""
    return moe_ffn(y, layer_params["moe"]["router"],
                   layer_params["moe"]["experts"], cfg.gate,
                   activation=cfg.activation, train=train,
                   impl=cfg.moe_impl)


def apply(cfg: MoETransformerConfig, params: Dict[str, Any],
          tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
          train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] fp32, total aux loss fp32);
    under a ZeRO-3 fetch hook each layer gathers its leaves, as the dense
    model's ``apply_hidden`` does."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :]
    fetch = sharding.active_fetch()
    x = tf.embed_tokens(cfg, params, tokens, positions, fetch)
    rope = (tf.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos_emb == "rope" else None)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer_params in tf._unstack_layers(params["layers"], cfg.num_layers):
        if cfg.remat:
            x, l_aux = torch.utils.checkpoint.checkpoint(
                tf.fetched_layer, fetch, _moe_layer, cfg, x, layer_params,
                rope, train, use_reentrant=False)
        else:
            x, l_aux = tf.fetched_layer(fetch, _moe_layer, cfg, x,
                                        layer_params, rope, train)
        aux_total = aux_total + l_aux
    x = tf.final_norm_of(cfg, params, x, fetch)
    return tf.unembed(cfg, params, x, fetch), aux_total


def loss_fn(cfg: MoETransformerConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross-entropy (a plain mean over every next token) plus
    the aux loss; batch: {input_ids [B, S]}."""
    tokens = batch["input_ids"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, aux_loss = apply(cfg, params, inputs, train=True)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (logz - gold).mean()
    total = nll + aux_loss
    return total, {"loss": total, "lm_loss": nll, "aux_loss": aux_loss,
                   "ntokens": torch.tensor(float(labels.numel()),
                                           device=tokens.device)}


class MoETransformerLM(tf.TransformerLM):
    """Weights of one MoE decoder in the JAX tree layout, with the JAX
    model protocol (``apply``, ``loss``, ``flops_per_token``)."""

    param_shapes = staticmethod(param_shapes)

    def apply(self, params: Dict[str, Any], tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits, _ = apply(self.config, params, tokens, positions, train=False)
        return logits

    def loss(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return loss_fn(self.config, params, batch)


__all__ = ["MoETransformerConfig", "MoETransformerLM", "apply", "loss_fn",
           "logical_axes", "param_shapes"]
