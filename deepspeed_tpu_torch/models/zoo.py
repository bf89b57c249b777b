"""Model zoo presets (port of ``deepspeed_tpu/models/zoo.py``): the
dense GPT-2 / Llama / Mistral / Qwen2 / Phi-3 / OPT / Falcon presets and
the Mixtral / Qwen2-MoE presets (``models/moe_transformer.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from deepspeed_tpu_torch._device import DeviceLike
from deepspeed_tpu_torch.models.moe_transformer import (MoETransformerConfig,
                                                        MoETransformerLM)
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)


def _gpt2(h, L, heads, vocab=50257, ctx=1024):
    return TransformerConfig(
        vocab_size=vocab, hidden_size=h, num_layers=L, num_heads=heads,
        max_seq_len=ctx, pos_emb="learned", norm="layernorm",
        activation="gelu_tanh", tie_embeddings=True)


def _llama(h, L, heads, kv_heads, ffn, vocab=128256, ctx=8192,
           theta=500000.0):
    return TransformerConfig(
        vocab_size=vocab, hidden_size=h, num_layers=L, num_heads=heads,
        num_kv_heads=kv_heads, ffn_size=ffn, max_seq_len=ctx, pos_emb="rope",
        norm="rmsnorm", activation="swiglu", tie_embeddings=False,
        rope_theta=theta, norm_eps=1e-5)


CONFIGS = {
    "gpt2-125m": _gpt2(768, 12, 12),
    "gpt2-350m": _gpt2(1024, 24, 16),
    "gpt2-1.3b": _gpt2(2048, 24, 16),
    "llama3-8b": _llama(4096, 32, 32, 8, 14336),
    "llama3-70b": _llama(8192, 80, 64, 8, 28672),
    "llama2-7b": _llama(4096, 32, 32, 32, 11008, vocab=32000, ctx=4096,
                        theta=10000.0),
    "mistral-7b": _llama(4096, 32, 32, 8, 14336, vocab=32000, ctx=8192,
                         theta=10000.0),
    "qwen2-7b": _llama(3584, 28, 28, 4, 18944, vocab=152064, ctx=8192,
                       theta=1000000.0),
    "phi3-mini": _llama(3072, 32, 32, 32, 8192, vocab=32064, ctx=4096,
                        theta=10000.0),
    "opt-1.3b": TransformerConfig(
        vocab_size=50272, hidden_size=2048, num_layers=24, num_heads=32,
        ffn_size=8192, max_seq_len=2048, pos_emb="learned",
        norm="layernorm", activation="relu", tie_embeddings=True),
    "opt-6.7b": TransformerConfig(
        vocab_size=50272, hidden_size=4096, num_layers=32, num_heads=32,
        ffn_size=16384, max_seq_len=2048, pos_emb="learned",
        norm="layernorm", activation="relu", tie_embeddings=True),
    "falcon-7b": TransformerConfig(
        vocab_size=65024, hidden_size=4544, num_layers=32, num_heads=71,
        num_kv_heads=1, ffn_size=18176, max_seq_len=2048, pos_emb="rope",
        norm="layernorm", activation="gelu", tie_embeddings=True,
        rope_theta=10000.0),
    "tiny": TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2,
                              num_heads=4, max_seq_len=128),
}


def _moe(h, L, heads, kv, ffn, E, k, vocab, ctx, theta):
    return MoETransformerConfig(
        vocab_size=vocab, hidden_size=h, num_layers=L, num_heads=heads,
        num_kv_heads=kv, ffn_size=ffn, max_seq_len=ctx, pos_emb="rope",
        norm="rmsnorm", activation="swiglu", tie_embeddings=False,
        rope_theta=theta, num_experts=E, top_k=k)


CONFIGS.update({
    "mixtral-8x7b": _moe(4096, 32, 32, 8, 14336, E=8, k=2, vocab=32000,
                         ctx=32768, theta=1000000.0),
    "qwen2-moe-a14b": _moe(3584, 28, 28, 4, 2560, E=64, k=8, vocab=151936,
                           ctx=8192, theta=1000000.0),
    "tiny-moe": MoETransformerConfig(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
        max_seq_len=128, pos_emb="rope", norm="rmsnorm",
        activation="swiglu", remat=False, num_experts=4, top_k=2),
})


def get_config(name: str, **overrides) -> TransformerConfig:
    """A preset's config (an ``MoETransformerConfig`` for the MoE ones),
    optionally with fields overridden."""
    if name not in CONFIGS:
        raise ValueError(f"unknown model '{name}'; known: {sorted(CONFIGS)}")
    return dataclasses.replace(CONFIGS[name], **overrides)


def get_model(name: str, *, device: DeviceLike = None,
              seed: Optional[int] = 0, **overrides) -> TransformerLM:
    """Instantiate a preset with weights drawn from ``seed`` on
    ``device`` (the card unless the caller says otherwise), optionally
    overriding config fields (e.g. ``dtype=torch.float32``,
    ``num_layers=2``); a ``MoETransformerLM`` for the MoE presets."""
    cfg = get_config(name, **overrides)
    cls = MoETransformerLM if isinstance(cfg, MoETransformerConfig) \
        else TransformerLM
    return cls(cfg, device=device, seed=seed)


__all__ = ["CONFIGS", "get_config", "get_model"]
