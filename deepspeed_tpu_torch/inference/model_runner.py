"""Inference forwards over the ``TransformerLM`` parameter tree (port of
``deepspeed_tpu/inference/model_runner.py``): the dense-cache forward of
the v1 engine (``forward_with_cache``) and the ragged paged-KV forwards
of the v2 engine.

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

A quantized pool comes as the (payload, fp32 scales) pair of
``BlockedKVCache.kv_state``. Every forward then appends first and reads
after, so each token attends the dequantized value of its own K/V, as
in JAX, in one launch a layer (``ops/quantization.kv_append_dequantize``:
the quantize-on-append of every token's K and V, then the dequantize).
The decode and prefill forwards dequantize the whole layer pool into one
scratch tensor in the compute dtype, allocated once per forward and
reused by every layer, and run the paged kernels on it; the gather path
dequantizes only the block table's pages. Weights go through ``_weight``,
which dequantizes a ``QuantizedTensor`` (weight-only int8,
``inference/weight_quant.py``) one layer's slice at a time.

Attention in ``ragged_prefill_forward`` and ``ragged_decode_forward``
goes through the hand-written paged kernels (``ops/paged_attention.py``);
``ragged_forward`` is the JAX package's own plain gather path, computed
outside any kernel with the same cast points. A layer that holds
``moe`` (``MoETransformerLM``) runs its FFN through the dropless MoE
dispatch (``parallel/moe.py``, the grouped-matmul kernels) on every
path.

Tensor parallelism (JAX's ``_tp_shard_map``): on a mesh whose tp
collectives communicate the params are this rank's tp slice and the pool
holds ``nkv/tp`` kv heads; the paged kernels run on the local q and kv
heads, ``wo`` and the MLP's down are followed by the all-reduce
(``sharding.tp_reduce``), the embedding is the vocab-parallel lookup and
the logits come back whole (``sharding.tp_gather``), so every rank picks
the same token. ``gather_logits=False`` leaves them vocab-sharded for a
caller that gathers only the rows it reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch.inference.weight_quant import QuantizedTensor
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    _norm, _proj, act_fn,
                                                    apply_rope, rope_tables)
from deepspeed_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                     paged_prefill_attention)
from deepspeed_tpu_torch.ops.quantization import kv_append_dequantize
from deepspeed_tpu_torch.parallel.moe import moe_ffn
from deepspeed_tpu_torch.runtime import sharding
from deepspeed_tpu_torch.utils.annotate import range_pop, range_push, region

Params = Dict[str, Any]


def _layer(params: Params, l: int) -> Params:
    """Views of layer ``l``'s leaves (the scan body's ``layer_params``);
    a ``QuantizedTensor`` leaf gives layer ``l``'s codes and scales."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node[l]
    return walk(params["layers"])


def _weight(w, dtype: torch.dtype):
    """The one read of a matmul weight: a ``QuantizedTensor`` is
    dequantized to the compute dtype here, at each use."""
    return w.to(dtype) if isinstance(w, QuantizedTensor) else w


def _kv_parts(kv_state):
    """Split the pool the forwards take: a bare tensor (unquantized)
    yields (data, None); a (payload, fp32 scales) pair yields both."""
    if isinstance(kv_state, (tuple, list)):
        return kv_state[0], kv_state[1]
    return kv_state, None


def _kv_bits(kv_layer) -> object:
    """Storage width of a quantized pool, from its payload dtype: int8
    holds one value per byte (8), uint8 two packed int4 values (4),
    float8_e4m3fn the fp8 rung ("fp8")."""
    if kv_layer.dtype == torch.float8_e4m3fn:
        return "fp8"
    return 4 if kv_layer.dtype == torch.uint8 else 8


def _rope_of(cfg: TransformerConfig, positions):
    """The forward's rotary tables, computed once for every layer."""
    if cfg.pos_emb != "rope":
        return None
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


@region("attention")
def _qkv(cfg: TransformerConfig, layer_params, y, rope):
    """Project y [..., H] to q/k/v with rope applied. Returns q [.., nh, hd],
    k/v [.., nkv, hd] (GQA heads NOT repeated — cache stays small)."""
    ap = layer_params["attn"]
    q = _proj(y, _weight(ap["wq"], y.dtype))
    k = _proj(y, _weight(ap["wk"], y.dtype))
    v = _proj(y, _weight(ap["wv"], y.dtype))
    if cfg.use_biases:
        q = q + ap["bq"]
        k = k + ap["bk"]
        v = v + ap["bv"]
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    return q, k, v


@region("mlp")
def _mlp(cfg: TransformerConfig, layer_params, x):
    if "moe" in layer_params:
        return _moe_mlp(cfg, layer_params, x)
    mp = layer_params["mlp"]
    y = _norm(x, layer_params["ln2"], cfg.norm, cfg.norm_eps)
    dt = y.dtype
    if cfg.activation == "swiglu":
        z = (F.silu(torch.matmul(y, _weight(mp["wg"], dt)))
             * torch.matmul(y, _weight(mp["wi"], dt)))
    else:
        pre = torch.matmul(y, _weight(mp["wi"], dt))
        if cfg.use_biases:
            pre = pre + mp["bi"]
        z = act_fn(cfg.activation)(pre)
    out = sharding.tp_reduce(torch.matmul(z, _weight(mp["wo"], dt)))
    if cfg.use_biases:
        out = out + mp["bo"]
    return x + out


@region("mlp")
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


@region("attention")
def _attn_out(cfg: TransformerConfig, layer_params, attn):
    """attn [..., nh, hd] -> [..., H] through wo (+ bo)."""
    wo = _weight(layer_params["attn"]["wo"], attn.dtype)
    out = sharding.tp_reduce(torch.matmul(
        attn.reshape(*attn.shape[:-2], -1), wo.reshape(-1, wo.shape[-1])))
    if cfg.use_biases:
        out = out + layer_params["attn"]["bo"]
    return out


def _residual(cfg: TransformerConfig, layer_params, x, attn):
    if cfg.parallel_block:  # Falcon: both branches read pre-attn x
        return _mlp(cfg, layer_params, x) + attn
    return _mlp(cfg, layer_params, x + attn)


def _embed(cfg: TransformerConfig, params, ids, positions):
    if sharding.tp_size() > 1:
        x = sharding.vocab_parallel_lookup(params["embed"]["tokens"], ids,
                                           vocab=cfg.vocab_size)
    else:
        x = F.embedding(ids.long(), params["embed"]["tokens"])
    if cfg.pos_emb == "learned":
        x = x + params["embed"]["positions"][positions.long()]
    return x


@region("vocab_head")
def _unembed(cfg: TransformerConfig, params, x, gather: bool = True):
    """fp32 logits; at tp > 1 this rank's vocab slice, all-gathered
    whole unless ``gather`` is False."""
    x = _norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"]["tokens"].t())
    else:
        logits = torch.matmul(x, _weight(params["unembed"]["kernel"],
                                         x.dtype))
    logits = logits.float()
    return sharding.tp_gather(logits) if gather else logits


def _append_kv(kv_layer, page, offset, k, v) -> None:
    """In-place KV append: token i's K/V land at (page[i], offset[i])."""
    kv_layer[page, offset] = torch.stack([k, v], dim=-3).to(kv_layer.dtype)


def _append_and_read(kv_layer, kv_sc, page, offset, k, v, scratch):
    """Append this step's K/V to one layer's pool and return the pool
    the paged kernels read: the pool itself when unquantized; else, in
    one launch, the codes appended and the whole layer dequantized into
    ``scratch`` (compute dtype)."""
    if kv_sc is None:
        _append_kv(kv_layer, page, offset, k, v)
        return kv_layer
    return kv_append_dequantize(kv_layer, kv_sc, page, offset,
                                k.contiguous(), v.contiguous(),
                                _kv_bits(kv_layer), scratch)


def _scratch_pool(cfg: TransformerConfig, kv_data, kv_scales, lead=None):
    """One layer's pool in the compute dtype (or, with ``lead``, the
    pages of a [S, Bm] block table), the dequantize target that every
    layer of a forward reuses (None for an unquantized pool)."""
    if kv_scales is None:
        return None
    nb, bs, _, nkv, _ = kv_data.shape[1:]
    return torch.empty((*(lead or (nb,)), bs, 2, nkv, cfg.head_dim),
                       dtype=cfg.dtype, device=kv_data.device)


# ---------------------------------------------------------------------------
# dense-cache path (v1 engine)
# ---------------------------------------------------------------------------


def init_dense_cache(cfg: TransformerConfig, batch: int, max_len: int,
                     dtype=None, device=None) -> torch.Tensor:
    """cache: [L, B, max_len, 2, kv_heads, head_dim] zeros in ``dtype``
    (default ``cfg.dtype``) on ``device`` (default the card); at tp > 1
    this rank's ``kv_heads / tp``."""
    return torch.zeros((cfg.num_layers, batch, max_len, 2,
                        cfg.kv_heads // sharding.tp_size(), cfg.head_dim),
                       dtype=dtype or cfg.dtype,
                       device=resolve_device(device))


@torch.no_grad()
def forward_with_cache(cfg: TransformerConfig, params: Params,
                       tokens: torch.Tensor, cache: torch.Tensor,
                       start_pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] starting at absolute position ``start_pos``; returns
    (logits [B, S, V] fp32, cache). Works for prefill (S = prompt length,
    start_pos = 0) and decode (S = 1).

    This step's K/V are written IN PLACE at cache rows [start_pos,
    start_pos + S) before attention reads them; the returned cache is the
    same tensor. Attention is JAX's dense masked form over all max_len
    rows, a query at position p seeing rows 0..p: scores in the compute
    dtype divided by sqrt(head_dim) in that dtype, fp32 softmax,
    probabilities cast back before the product with V. GQA heads are
    grouped, not repeated (q head h reads kv head h // group, as
    ``jnp.repeat`` does)."""
    B, S = tokens.shape
    L, _, max_len, _, nkv, hd = cache.shape
    if start_pos + S > max_len:
        raise ValueError(f"rows [{start_pos}, {start_pos + S}) do not fit "
                         f"a cache of {max_len}")
    dt = cfg.dtype
    g = cfg.num_heads // cfg.kv_heads
    dev = tokens.device
    positions = start_pos + torch.arange(S, device=dev)[None, :]  # [1, S]

    x = _embed(cfg, params, tokens, positions)  # [B, S, H]
    rope = _rope_of(cfg, positions)
    key_pos = torch.arange(max_len, device=dev)
    mask = key_pos[None, None, None, None, :] <= \
        positions[:, None, None, :, None]  # [1, 1, 1, S, max_len]
    sqrt_hd = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)
    for l in range(L):
        lp = _layer(params, l)
        kv_layer = cache[l]  # [B, max_len, 2, nkv, hd]
        y = _norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, y, rope)  # q [B, S, nh, hd]
        kv_layer[:, start_pos:start_pos + S] = torch.stack(
            [k, v], dim=2).to(kv_layer.dtype)
        k_all = kv_layer[:, :, 0].to(dt)  # [B, max_len, nkv, hd]
        v_all = kv_layer[:, :, 1].to(dt)
        qg = q.reshape(B, S, nkv, g, hd)
        scores = torch.einsum("bskgd,bmkd->bkgsm", qg, k_all) / sqrt_hd
        scores = torch.where(mask, scores.float(),
                             torch.full((), -1e30, device=dev))
        probs = torch.softmax(scores, dim=-1).to(dt)
        attn = torch.einsum("bkgsm,bmkd->bskgd", probs, v_all)
        attn = _attn_out(cfg, lp, attn.reshape(B, S, nkv * g, hd))
        x = _residual(cfg, lp, x, attn)
    return _unembed(cfg, params, x), cache


# ---------------------------------------------------------------------------
# ragged paged-KV path: plain gather attention
# ---------------------------------------------------------------------------


@torch.no_grad()
def ragged_forward(cfg: TransformerConfig, params: Params,
                   kv_data: torch.Tensor, token_ids: torch.Tensor,
                   token_seq: torch.Tensor, token_pos: torch.Tensor,
                   block_table: torch.Tensor, num_tokens,
                   gather_logits: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ragged step over flat tokens (plain gather attention).

    kv_data     [L, num_blocks, bs, 2, nkv, hd] — or, for a quantized
                pool, the (payload, fp32 scales [L, nb, bs, 2, nkv]) pair
                of ``BlockedKVCache.kv_state``
    token_ids   [T] int32 (padded); token_seq [T] slot ids; token_pos [T]
    block_table [S, Bm]; num_tokens scalar (true T, rest is padding)

    Returns (logits [T, V] fp32, kv_data). A query at position p attends
    cache rows 0..p of its sequence; this step's append lands before the
    attention reads.
    """
    kv_state = kv_data
    kv_data, kv_scales = _kv_parts(kv_state)
    T = token_ids.shape[0]
    Smax, Bm = block_table.shape
    nb, bs = kv_data.shape[1], kv_data.shape[2]
    dt = cfg.dtype
    nkv, hd = kv_data.shape[4], cfg.head_dim  # this rank's kv heads
    g = cfg.num_heads // cfg.kv_heads
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
    # the quantized pool: only the table's pages are dequantized
    scratch = _scratch_pool(cfg, kv_data, kv_scales, lead=(Smax, Bm))
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        kv_layer = kv_data[l]
        y = _norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, y, rope)  # q [T,nh,hd] k/v [T,nkv,hd]
        if kv_scales is None:
            _append_kv(kv_layer, page, offset, k, v)
            gathered = kv_layer[bt]
        else:
            gathered = kv_append_dequantize(
                kv_layer, kv_scales[l], page, offset,
                k.contiguous(), v.contiguous(), _kv_bits(kv_layer), scratch,
                block_table=bt)
        # each slot's pages gathered dense: [S, Lmax, 2, nkv, hd]
        gathered = gathered.reshape(Smax, max_ctx, 2, nkv, hd)
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
    return _unembed(cfg, params, x, gather_logits), kv_state


# ---------------------------------------------------------------------------
# segmented prefill path: paged prefill kernel
# ---------------------------------------------------------------------------


@torch.no_grad()
def ragged_prefill_forward(cfg: TransformerConfig, params: Params,
                           kv_data: torch.Tensor, seg_tokens: torch.Tensor,
                           seg_pos0: torch.Tensor, seg_nreal: torch.Tensor,
                           block_table: torch.Tensor,
                           gather_logits: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill chunks, one segment per sequence slot.

    Each segment s runs ``nreal[s]`` new tokens at absolute positions
    pos0[s].. through the paged cache; padded rows (qi >= nreal) and dead
    segments (nreal == 0) write to the scratch page and emit garbage
    logits the engine never reads.

    seg_tokens [S, Tq] int32; seg_pos0/seg_nreal [S] int32;
    block_table [S, Bm] int32; kv_data as in :func:`ragged_forward`.
    Returns (logits [S, Tq, V] fp32, kv_data).
    """
    kv_state = kv_data
    kv_data, kv_scales = _kv_parts(kv_state)
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

    scratch = _scratch_pool(cfg, kv_data, kv_scales)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        y = _norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, y, rope)  # q [S, Tq, nh, hd]
        rng = range_push("attention")  # None unless a profiler is on
        kv_read = _append_and_read(
            kv_data[l], None if kv_scales is None else kv_scales[l], page,
            offset, k, v, scratch)
        attn = paged_prefill_attention(q.to(dt).contiguous(), kv_read,
                                       block_table, seg_pos0, ctx_lens)
        range_pop(rng)
        x = _residual(cfg, lp, x, _attn_out(cfg, lp, attn.to(dt)))
    return _unembed(cfg, params, x, gather_logits), kv_state


# ---------------------------------------------------------------------------
# decode-only ragged path: paged decode kernel
# ---------------------------------------------------------------------------


@torch.no_grad()
def ragged_decode_forward(cfg: TransformerConfig, params: Params,
                          kv_data: torch.Tensor, token_ids: torch.Tensor,
                          token_pos: torch.Tensor, block_table: torch.Tensor,
                          context_lens: torch.Tensor,
                          gather_logits: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: exactly one new token per live slot. Dead slots
    have context_lens == 0: their K/V writes go to the scratch page and
    their attention output is zero.

    kv_data      [L, num_blocks, bs, 2, nkv, hd], or the quantized pair
                 (see :func:`ragged_forward`)
    token_ids    [S] int32;  token_pos [S];  block_table [S, Bm] int32
    context_lens [S] int32 = token_pos + 1 for live slots, 0 for dead

    Returns (logits [S, V] fp32, kv_data).
    """
    kv_state = kv_data
    kv_data, kv_scales = _kv_parts(kv_state)
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

    scratch = _scratch_pool(cfg, kv_data, kv_scales)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        y = _norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, y, rope)  # q [S, nh, hd]
        rng = range_push("attention")  # None unless a profiler is on
        kv_read = _append_and_read(
            kv_data[l], None if kv_scales is None else kv_scales[l], page,
            offset, k, v, scratch)
        attn = paged_decode_attention(q.to(dt).contiguous(), kv_read,
                                      block_table, context_lens)
        range_pop(rng)
        x = _residual(cfg, lp, x, _attn_out(cfg, lp, attn.to(dt)))
    return _unembed(cfg, params, x, gather_logits), kv_state


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
