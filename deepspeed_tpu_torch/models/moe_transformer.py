"""Mixture-of-Experts transformer LM, the Mixtral / Qwen-MoE family
(port of ``deepspeed_tpu/models/moe_transformer.py``).

The dense model's attention, norm and rope (``models/transformer.py``,
so training attention goes through the flash kernels) with the FFN
swapped for ``parallel/moe.py``'s dispatch (dropless grouped-GEMM, or
the capacity-padded einsum under ``moe_impl="einsum"``); on an ep mesh
each rank's expert stacks hold its E/ep experts. The
parameter tree is the JAX one: ``layers.moe.router`` [L, h, E] and
``layers.moe.experts.{wi, wg}`` [L, E, h, f] / ``wo`` [L, E, f, h] in
place of ``layers.mlp``.

``apply`` returns (logits, the summed aux loss); ``remat`` wraps each
layer in ``torch.utils.checkpoint`` as the dense model does. With
``param_host_offload`` (the engine's ``offload_param``) the layer stack,
experts included, streams from pinned host memory a layer at a time
(``runtime/param_stream.py``), as in JAX. At tp > 1 the attention is
the dense model's column / row pair and each rank holds F/tp of every
expert (``parallel/moe.py`` all-reduces the combine). Under
``sequence_parallel`` the KV heads are repeated before the sp attention
(JAX's ``repeat_kv_heads``), each rank routes its own sequence block's
tokens (the routing statistics averaged over the sp ranks too, as JAX's
sequence-sharded dispatch averages its shards'), and the LM loss is the
mean over the global tokens. On a pp mesh the layer stack runs as
``parallel/pipeline.pipelined_layers`` with the aux loss threaded
through the stages and averaged over the microbatches (JAX's
``with_aux``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.ops.attention import repeat_kv_heads
from deepspeed_tpu_torch.parallel import pipeline, topology
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
    # "auto" | "grouped" (dropless grouped-GEMM) | "einsum" (capacity-
    # padded GShard dispatch)
    moe_impl: str = "auto"
    # each batch group's own routing statistics (moe_ffn's group_stats)
    group_stats: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.moe_impl not in ("auto", "grouped", "einsum"):
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
    y = sharding.tp_copy(tf._norm(x, layer_params["ln1"], cfg.norm,
                                  cfg.norm_eps))
    q = tf._proj(y, ap["wq"].to(dt))
    k = tf._proj(y, ap["wk"].to(dt))
    v = tf._proj(y, ap["wv"].to(dt))
    if rope is not None:
        q = tf.apply_rope(q, *rope)
        k = tf.apply_rope(k, *rope)
    if cfg.sequence_parallel or cfg.attn_chunks > 1:
        # the head-split paths need equal q / kv head counts; the plain
        # path keeps KV grouped for the GQA-native flash kernels
        k, v = repeat_kv_heads(q, k, v)
    attn = tf._attention(q, k, v, cfg)
    wo = ap["wo"].to(dt)
    x = x + sharding.tp_reduce(torch.matmul(
        attn.reshape(*attn.shape[:-2], -1), wo.reshape(-1, wo.shape[-1])))

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
                   impl=cfg.moe_impl, group_stats=cfg.group_stats)


def apply(cfg: MoETransformerConfig, params: Dict[str, Any],
          tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
          train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] fp32, total aux loss fp32);
    under a ZeRO-3 fetch hook each layer gathers its leaves, as the dense
    model's ``apply_hidden`` does. At tp > 1 the logits are this rank's
    vocab slice (``sharding.tp_gather`` makes them whole)."""
    B, S = tokens.shape
    if positions is None:
        positions = tf.local_positions(cfg, S, tokens.device)
    fetch = sharding.active_fetch()
    x = tf.embed_tokens(cfg, params, tokens, positions, fetch)
    rope = (tf.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos_emb == "rope" else None)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if pipeline.pipeline_enabled(topology._GLOBAL_MESH):
        # pp > 1: the stage pipeline threading the aux loss through the
        # stages (each stage recomputed in the backward)
        x, aux_total = pipeline.pipelined_layers(
            lambda c, lp: tf.fetched_layer(fetch, _moe_layer, cfg, c, lp,
                                           rope, train),
            params["layers"], x, with_aux=True)
        x = tf.final_norm_of(cfg, params, x, fetch)
        return tf.unembed(cfg, params, x, fetch), aux_total
    if cfg.param_host_offload:
        # ZeRO-Infinity streaming of the expert stack (JAX's branch): a
        # fetch inside each remat'd layer, so the card holds one layer's
        # experts at a time and the recompute fetches again
        from deepspeed_tpu_torch.runtime import param_stream

        def streamed(x, lp):
            return _moe_layer(cfg, x, param_stream.fetch_layer(
                lp, tokens.device), rope, train)

        tf._one_tp_rank("offload_param")
        for lp in param_stream.host_layers(params["layers"], cfg.num_layers):
            if cfg.remat:
                x, l_aux = torch.utils.checkpoint.checkpoint(
                    streamed, x, lp, use_reentrant=False)
            else:
                x, l_aux = streamed(x, lp)
            aux_total = aux_total + l_aux
        x = tf.final_norm_of(cfg, params, x, fetch)
        return tf.unembed(cfg, params, x, fetch), aux_total
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
    the aux loss; batch: {input_ids [B, S]} (under sp each rank's
    sequence block after the shift, {input_ids, labels}; the mean is
    over the global tokens)."""
    tokens = batch["input_ids"]
    inputs, labels, _ = tf.lm_batch({k: v for k, v in batch.items()
                                     if k != "loss_mask"})
    logits, aux_loss = apply(cfg, params, inputs, train=True)
    count = torch.tensor(float(labels.numel()), device=tokens.device)
    if sharding.sp_size() > 1:
        count = sharding.sp_sum(count)
        nll = sharding.sp_sum(
            sharding.vocab_parallel_nll(logits, labels).sum()) / count
    else:
        nll = sharding.vocab_parallel_nll(logits, labels).mean()
    total = nll + aux_loss
    return total, {"loss": total, "lm_loss": nll, "aux_loss": aux_loss,
                   "ntokens": count}


class MoETransformerLM(tf.TransformerLM):
    """Weights of one MoE decoder in the JAX tree layout, with the JAX
    model protocol (``apply``, ``loss``, ``flops_per_token``)."""

    param_shapes = staticmethod(param_shapes)
    logical_axes = staticmethod(logical_axes)

    def apply(self, params: Dict[str, Any], tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits, _ = apply(self.config, params, tokens, positions, train=False)
        return sharding.tp_gather(logits)

    def loss(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return loss_fn(self.config, params, batch)


__all__ = ["MoETransformerConfig", "MoETransformerLM", "apply", "loss_fn",
           "logical_axes", "param_shapes"]
