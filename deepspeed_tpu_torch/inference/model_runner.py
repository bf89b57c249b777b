"""Ragged paged-KV forwards over the ``TransformerLM`` parameter tree
(port of ``deepspeed_tpu/inference/model_runner.py``).

Plain functions on tensors: (cfg, params, kv_data, metadata) ->
(logits, kv_data). ``params`` is ``TransformerLM.params()``, the JAX tree
layout with layers stacked on dim 0; the JAX ``lax.scan`` over layers is
a Python loop over ``params["layers"][...][l]`` here.

The KV append writes the pool IN PLACE (``index_put_`` on
``kv_data[l]``) and the functions return the same tensor: JAX's
functional ``.at[].set`` needs a second pool for the updated copy, which
at 8B serving sizes is gigabytes this port does not spend.

Padded tokens write to the scratch block (the pool's last block id,
which the engine's allocator never hands out). Duplicate write indices
only ever hit that block, so the unspecified order of duplicate writes
is harmless.

Attention in ``ragged_prefill_forward`` and ``ragged_decode_forward``
goes through the hand-written paged kernels (``ops/paged_attention.py``);
``ragged_forward`` is the JAX package's own plain gather path, computed
outside any kernel with the same cast points. A layer that holds
``moe`` (``MoETransformerLM``) runs its FFN through the dropless MoE
dispatch (``parallel/moe.py``, the grouped-matmul kernels) on every
path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    _norm, _proj, act_fn,
                                                    apply_rope, rope_tables)
from deepspeed_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                     paged_prefill_attention)
from deepspeed_tpu_torch.parallel.moe import moe_ffn

Params = Dict[str, Any]


def _layer(params: Params, l: int) -> Params:
    """Views of layer ``l``'s leaves (the scan body's ``layer_params``)."""
    def walk(node):
        if isinstance(node, torch.Tensor):
            return node[l]
        return {k: walk(v) for k, v in node.items()}
    return walk(params["layers"])


def _rope_of(cfg: TransformerConfig, positions):
    """The forward's rotary tables, computed once for every layer."""
    if cfg.pos_emb != "rope":
        return None
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _qkv(cfg: TransformerConfig, layer_params, y, rope):
    """Project y [..., H] to q/k/v with rope applied. Returns q [.., nh, hd],
    k/v [.., nkv, hd] (GQA heads NOT repeated — cache stays small)."""
    ap = layer_params["attn"]
    q = _proj(y, ap["wq"])
    k = _proj(y, ap["wk"])
    v = _proj(y, ap["wv"])
    if cfg.use_biases:
        q = q + ap["bq"]
        k = k + ap["bk"]
        v = v + ap["bv"]
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    return q, k, v


def _mlp(cfg: TransformerConfig, layer_params, x):
    if "moe" in layer_params:
        return _moe_mlp(cfg, layer_params, x)
    mp = layer_params["mlp"]
    y = _norm(x, layer_params["ln2"], cfg.norm, cfg.norm_eps)
    if cfg.activation == "swiglu":
        z = F.silu(torch.matmul(y, mp["wg"])) * torch.matmul(y, mp["wi"])
    else:
        pre = torch.matmul(y, mp["wi"])
        if cfg.use_biases:
            pre = pre + mp["bi"]
        z = act_fn(cfg.activation)(pre)
    out = torch.matmul(z, mp["wo"])
    if cfg.use_biases:
        out = out + mp["bo"]
    return x + out


def _moe_mlp(cfg, layer_params, x):
    """MoE FFN for the serving runners. Token dropping is off: serving
    routes every token (capacity = tokens)."""
    y = _norm(x, layer_params["ln2"], cfg.norm, cfg.norm_eps)
    flat = y[None] if y.dim() == 2 else y  # [1, T, H] / [S, Tq, H]
    gate = dataclasses.replace(cfg.gate, drop_tokens=False)
    out, _aux = moe_ffn(flat, layer_params["moe"]["router"],
                        layer_params["moe"]["experts"], gate,
                        activation=cfg.activation, train=False,
                        impl=cfg.moe_impl)
    return x + (out[0] if y.dim() == 2 else out)


def _attn_out(cfg: TransformerConfig, layer_params, attn):
    """attn [..., nh, hd] -> [..., H] through wo (+ bo)."""
    wo = layer_params["attn"]["wo"]
    out = torch.matmul(attn.reshape(*attn.shape[:-2], -1),
                       wo.reshape(-1, wo.shape[-1]))
    if cfg.use_biases:
        out = out + layer_params["attn"]["bo"]
    return out


def _residual(cfg: TransformerConfig, layer_params, x, attn):
    if cfg.parallel_block:  # Falcon: both branches read pre-attn x
        return _mlp(cfg, layer_params, x) + attn
    return _mlp(cfg, layer_params, x + attn)


def _embed(cfg: TransformerConfig, params, ids, positions):
    x = F.embedding(ids.long(), params["embed"]["tokens"])
    if cfg.pos_emb == "learned":
        x = x + params["embed"]["positions"][positions.long()]
    return x


def _unembed(cfg: TransformerConfig, params, x):
    x = _norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"]["tokens"].t())
    else:
        logits = torch.matmul(x, params["unembed"]["kernel"])
    return logits.float()


def _append_kv(kv_layer, page, offset, k, v) -> None:
    """In-place KV append: token i's K/V land at (page[i], offset[i])."""
    kv_layer[page, offset] = torch.stack([k, v], dim=-3).to(kv_layer.dtype)


# ---------------------------------------------------------------------------
# ragged paged-KV path: plain gather attention
# ---------------------------------------------------------------------------


@torch.no_grad()
def ragged_forward(cfg: TransformerConfig, params: Params,
                   kv_data: torch.Tensor, token_ids: torch.Tensor,
                   token_seq: torch.Tensor, token_pos: torch.Tensor,
                   block_table: torch.Tensor, num_tokens
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ragged step over flat tokens (plain gather attention).

    kv_data     [L, num_blocks, bs, 2, nkv, hd]
    token_ids   [T] int32 (padded); token_seq [T] slot ids; token_pos [T]
    block_table [S, Bm]; num_tokens scalar (true T, rest is padding)

    Returns (logits [T, V] fp32, kv_data). A query at position p attends
    cache rows 0..p of its sequence; this step's append lands before the
    attention reads.
    """
    T = token_ids.shape[0]
    Smax, Bm = block_table.shape
    nb, bs = kv_data.shape[1], kv_data.shape[2]
    dt = cfg.dtype
    nkv, hd = cfg.kv_heads, cfg.head_dim
    g = cfg.num_heads // nkv
    dev = token_ids.device
    is_real = torch.arange(T, device=dev) < int(num_tokens)
    seq = token_seq.long()
    pos = token_pos.long()
    bt = block_table.long()

    x = _embed(cfg, params, token_ids, pos)
    rope = _rope_of(cfg, pos)
    page = bt[seq, (pos // bs).clamp(max=Bm - 1)]
    page = torch.where(is_real, page, nb - 1)
    offset = torch.where(is_real, pos % bs, bs - 1)

    max_ctx = Bm * bs
    key_pos = torch.arange(max_ctx, device=dev)
    mask = key_pos[None, None, None, :] <= pos[:, None, None, None]
    sqrt_hd = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        kv_layer = kv_data[l]
        y = _norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, y, rope)  # q [T,nh,hd] k/v [T,nkv,hd]
        _append_kv(kv_layer, page, offset, k, v)
        # each slot's pages gathered dense: [S, Lmax, 2, nkv, hd]
        gathered = kv_layer[bt].reshape(Smax, max_ctx, 2, nkv, hd)
        k_seq = gathered[:, :, 0][seq]  # [T, Lmax, nkv, hd]
        v_seq = gathered[:, :, 1][seq]
        qg = q.reshape(T, nkv, g, hd)
        scores = torch.einsum("tkgd,tmkd->tkgm", qg, k_seq) / sqrt_hd
        scores = torch.where(mask, scores.float(),
                             torch.full((), -1e30, device=dev))
        probs = torch.softmax(scores, dim=-1).to(dt)
        attn = torch.einsum("tkgm,tmkd->tkgd", probs, v_seq)
        attn = _attn_out(cfg, lp, attn.reshape(T, nkv * g, hd))
        x = _residual(cfg, lp, x, attn)
    return _unembed(cfg, params, x), kv_data


# ---------------------------------------------------------------------------
# segmented prefill path: paged prefill kernel
# ---------------------------------------------------------------------------


@torch.no_grad()
def ragged_prefill_forward(cfg: TransformerConfig, params: Params,
                           kv_data: torch.Tensor, seg_tokens: torch.Tensor,
                           seg_pos0: torch.Tensor, seg_nreal: torch.Tensor,
                           block_table: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill chunks, one segment per sequence slot.

    Each segment s runs ``nreal[s]`` new tokens at absolute positions
    pos0[s].. through the paged cache; padded rows (qi >= nreal) and dead
    segments (nreal == 0) write to the scratch page and emit garbage
    logits the engine never reads.

    seg_tokens [S, Tq] int32; seg_pos0/seg_nreal [S] int32;
    block_table [S, Bm] int32. Returns (logits [S, Tq, V] fp32, kv_data).
    """
    S, Tq = seg_tokens.shape
    Bm = block_table.shape[1]
    nb, bs = kv_data.shape[1], kv_data.shape[2]
    dt = cfg.dtype
    dev = seg_tokens.device

    qi = torch.arange(Tq, device=dev)[None, :]          # [1, Tq]
    pos = seg_pos0.long()[:, None] + qi                 # [S, Tq]
    real = qi < seg_nreal.long()[:, None]               # [S, Tq]
    ctx_lens = (seg_pos0 + seg_nreal).to(torch.int32)   # [S]

    x = _embed(cfg, params, seg_tokens, pos)            # [S, Tq, H]
    rope = _rope_of(cfg, pos)
    page = torch.gather(block_table.long(), 1, (pos // bs).clamp(max=Bm - 1))
    page = torch.where(real, page, nb - 1)
    offset = torch.where(real, pos % bs, bs - 1)

    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        kv_layer = kv_data[l]
        y = _norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, y, rope)  # q [S, Tq, nh, hd]
        _append_kv(kv_layer, page, offset, k, v)
        attn = paged_prefill_attention(q.to(dt).contiguous(), kv_layer,
                                       block_table, seg_pos0, ctx_lens)
        x = _residual(cfg, lp, x, _attn_out(cfg, lp, attn.to(dt)))
    return _unembed(cfg, params, x), kv_data


# ---------------------------------------------------------------------------
# decode-only ragged path: paged decode kernel
# ---------------------------------------------------------------------------


@torch.no_grad()
def ragged_decode_forward(cfg: TransformerConfig, params: Params,
                          kv_data: torch.Tensor, token_ids: torch.Tensor,
                          token_pos: torch.Tensor, block_table: torch.Tensor,
                          context_lens: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: exactly one new token per live slot. Dead slots
    have context_lens == 0: their K/V writes go to the scratch page and
    their attention output is zero.

    kv_data      [L, num_blocks, bs, 2, nkv, hd]
    token_ids    [S] int32;  token_pos [S];  block_table [S, Bm] int32
    context_lens [S] int32 = token_pos + 1 for live slots, 0 for dead

    Returns (logits [S, V] fp32, kv_data).
    """
    S = token_ids.shape[0]
    Bm = block_table.shape[1]
    nb, bs = kv_data.shape[1], kv_data.shape[2]
    dt = cfg.dtype
    dev = token_ids.device
    alive = context_lens > 0
    pos = token_pos.long()

    x = _embed(cfg, params, token_ids, pos)  # [S, H]
    rope = _rope_of(cfg, pos)
    page = block_table.long()[torch.arange(S, device=dev),
                              (pos // bs).clamp(max=Bm - 1)]
    page = torch.where(alive, page, nb - 1)
    offset = torch.where(alive, pos % bs, bs - 1)

    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        kv_layer = kv_data[l]
        y = _norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, y, rope)  # q [S, nh, hd]
        _append_kv(kv_layer, page, offset, k, v)
        attn = paged_decode_attention(q.to(dt).contiguous(), kv_layer,
                                      block_table, context_lens)
        x = _residual(cfg, lp, x, _attn_out(cfg, lp, attn.to(dt)))
    return _unembed(cfg, params, x), kv_data


@torch.no_grad()
def ragged_multi_decode(cfg: TransformerConfig, params: Params,
                        kv_data: torch.Tensor, token_ids: torch.Tensor,
                        token_pos: torch.Tensor, block_table: torch.Tensor,
                        context_lens: torch.Tensor, *, steps: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` greedy decode steps with the argmax fed back on the
    device: no host sync inside the loop, so the host pays one fetch per
    ``steps`` tokens (the caller's ``.cpu()`` of the result).

    The caller must have allocated KV blocks for ``steps`` more tokens
    per live slot (the block tables are fixed for the whole burst) and
    trims tokens past eos/max_new_tokens on the host; dead slots
    (context_lens == 0) stay dead.

    Returns (tokens [steps, S] int32 on the device, kv_data).
    """
    tok, pos, ctx = token_ids, token_pos, context_lens
    toks = []
    for _ in range(steps):
        logits, kv_data = ragged_decode_forward(
            cfg, params, kv_data, tok, pos, block_table, ctx)
        # torch.argmax returns the first maximum, as jnp.argmax does
        nxt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        alive = ctx > 0
        nxt = torch.where(alive, nxt, torch.zeros_like(nxt))
        toks.append(nxt)
        tok = nxt
        pos = pos + 1
        ctx = torch.where(alive, ctx + 1, torch.zeros_like(ctx))
    return torch.stack(toks), kv_data
