"""Domino: a tensor-parallel layer whose collectives can hide behind
compute (port of ``deepspeed_tpu/parallel/domino.py``).

The layer splits the batch into ``num_chunks`` slices whose chains do
not depend on each other: while one chunk's all-reduce (after the
row-parallel product) is on the wire, the next chunk's column-parallel
products can run. The weights are whole on entry; each tp rank takes
JAX's blocks of them (``wqkv`` and ``w1`` by columns, ``wo`` and ``w2``
by rows) and the layer issues the collectives GSPMD would:
``sharding.tp_copy`` into each column-parallel product,
``sharding.tp_reduce`` after each row-parallel one. The attention is
plain einsum attention on the local heads, as in JAX (no kernel).
Without tp ranks the layer is the single-device function.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.runtime import sharding


def _layer_norm(x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _chunk_attention(q, k, v, causal: bool):
    """Plain attention on [b, s, n, d] (JAX's cast points: the scores in
    q's type, the softmax in fp32)."""
    d = q.shape[-1]
    scores = torch.einsum("bsnd,btnd->bnst", q, k) / math.sqrt(d)
    if causal:
        s, t = scores.shape[-2:]
        mask = torch.tril(torch.ones((s, t), dtype=torch.bool,
                                     device=q.device))
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


def domino_layer_params(gen: torch.Generator, hidden: int, ffn: int,
                        num_heads: int, dtype=torch.bfloat16,
                        device=None) -> Dict[str, torch.Tensor]:
    """Weights for one Domino layer ([in, out] layout) at JAX's scales,
    drawn from ``gen`` (the two frameworks' generators give different
    numbers: parity tests carry JAX's weights across)."""
    dev = gen.device if device is None else torch.device(device)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * std).to(dtype)

    s = hidden ** -0.5
    return {"wqkv": normal((hidden, 3 * hidden), s),
            "wo": normal((hidden, hidden), s),
            "w1": normal((hidden, ffn), s),
            "w2": normal((ffn, hidden), ffn ** -0.5)}


def _local(w: torch.Tensor, dim: int) -> torch.Tensor:
    """This tp rank's block of a whole weight along ``dim``."""
    n = sharding.tp_size()
    size = w.shape[dim] // n
    return w.narrow(dim, sharding.tp_index() * size, size)


def _local_layer(params, x, *, num_heads: int, num_chunks: int,
                 causal: bool):
    """x [B_loc, S, H] whole hidden; the weights this rank's blocks."""
    hd = x.shape[-1] // num_heads
    n_local = params["wqkv"].shape[1] // 3 // hd
    chunks = torch.chunk(x, num_chunks, dim=0)
    attn_out: List[torch.Tensor] = []
    for cx in chunks:
        y = sharding.tp_copy(_layer_norm(cx))
        qkv = y @ params["wqkv"]  # column-parallel: [b, s, 3 H / tp]
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        q = q.reshape(*q.shape[:2], n_local, hd)
        k = k.reshape(*k.shape[:2], n_local, hd)
        v = v.reshape(*v.shape[:2], n_local, hd)
        o = _chunk_attention(q, k, v, causal)
        o = o.reshape(*o.shape[:2], n_local * hd)
        attn_out.append(cx + sharding.tp_reduce(o @ params["wo"]))
    out = []
    for cx in attn_out:
        y = sharding.tp_copy(_layer_norm(cx))
        h = F.gelu(y @ params["w1"], approximate="tanh")  # column-parallel
        out.append(cx + sharding.tp_reduce(h @ params["w2"]))
    return torch.cat(out, dim=0)


def domino_transformer_layer(params, x, *, num_heads: int,
                             num_chunks: int = 2, causal: bool = True,
                             tp_axis: str = "tp",
                             mesh=None) -> torch.Tensor:
    """One TP transformer layer with the Domino chunked schedule.

    params: ``domino_layer_params``' whole weights; x: this rank's rows
    [B_loc, S, H] (the tp ranks of one data index read the same rows).
    ``mesh`` defaults to the global one."""
    from deepspeed_tpu_torch.parallel import topology

    if tp_axis != sharding.TP:
        raise ValueError(f"domino shards over tp, got axis {tp_axis!r}")
    mesh = mesh or topology._GLOBAL_MESH
    if mesh is None or mesh.shape.get(tp_axis, 1) == 1 or \
            not mesh.issues(tp_axis):
        return _single_device_layer(params, x, num_heads=num_heads,
                                    causal=causal)
    with topology.use_mesh(mesh):
        local = {"wqkv": _local(params["wqkv"], 1),
                 "wo": _local(params["wo"], 0),
                 "w1": _local(params["w1"], 1),
                 "w2": _local(params["w2"], 0)}
        return _local_layer(local, x, num_heads=num_heads,
                            num_chunks=num_chunks, causal=causal)


def _single_device_layer(params, x, *, num_heads: int, causal: bool):
    hd = x.shape[-1] // num_heads
    y = _layer_norm(x)
    qkv = y @ params["wqkv"]
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    q = q.reshape(*q.shape[:2], num_heads, hd)
    k = k.reshape(*k.shape[:2], num_heads, hd)
    v = v.reshape(*v.shape[:2], num_heads, hd)
    o = _chunk_attention(q, k, v, causal).reshape(x.shape)
    x = x + o @ params["wo"]
    y = _layer_norm(x)
    return x + F.gelu(y @ params["w1"], approximate="tanh") @ params["w2"]


class DominoTransformer:
    """A stack of Domino layers (reference ``DominoTransformer``)."""

    def __init__(self, num_layers: int, hidden: int, ffn: int,
                 num_heads: int, num_chunks: int = 2, causal: bool = True,
                 dtype=torch.bfloat16):
        self.num_layers = num_layers
        self.hidden = hidden
        self.ffn = ffn
        self.num_heads = num_heads
        self.num_chunks = num_chunks
        self.causal = causal
        self.dtype = dtype

    def init(self, gen: torch.Generator) -> List[Dict[str, Any]]:
        return [domino_layer_params(gen, self.hidden, self.ffn,
                                    self.num_heads, self.dtype)
                for _ in range(self.num_layers)]

    def apply(self, params, x, mesh=None) -> torch.Tensor:
        for layer in params:
            x = domino_transformer_layer(
                layer, x, num_heads=self.num_heads,
                num_chunks=self.num_chunks, causal=self.causal, mesh=mesh)
        return x

    __call__ = apply


__all__ = ["domino_layer_params", "domino_transformer_layer",
           "DominoTransformer"]
