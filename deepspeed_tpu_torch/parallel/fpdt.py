"""FPDT-style chunked attention with host-resident K/V and the hosted
residual stream, on one card (port of ``deepspeed_tpu/parallel/fpdt.py``).

Reference: sequence/fpdt_layer.py --- ``_FPDTGPUOffloadingAttentionImpl_``
(:545) processes the sequence in chunks, double-buffering chunk
activations through pinned host memory; chunked FFN / logits (:1126,
:1207) cap the rest of the activation footprint.

  * ``chunked_attention``: a loop over query chunks, each scanning KV
    tiles with the online softmax of ``parallel/_blockwise.py``, each
    chunk and each tile block recomputed in the backward
    (``torch.utils.checkpoint``): the live score block is one [chunk x
    kv_tile] instead of [S x S]. As in JAX these are plain tensor ops;
    with one chunk it is ``multi_head_attention`` (the flash kernels).
  * ``fpdt_attention_block`` (``fpdt_host_kv``): the K/V build projects
    each sequence tile at kv_heads width and moves it to pinned host
    memory; each query chunk projects its queries and streams the K/V
    tiles back a tile at a time (``_StreamAttn``, whose backward
    recomputes the probabilities from the saved logsumexp, JAX's custom
    VJP), and the rest of the block (residual add, ln2, MLP) fuses into
    the chunk. Tile copies run on the card's copy stream
    (``utils/memspace.py``), one tile ahead of the compute, with events;
    the host never waits inside the loop except for the gradient tiles
    a backward hands to autograd.
  * ``fpdt_hosted_layer`` (``fpdt_host_residual``): the residual stream
    itself is a tuple of host chunks between layers, and the whole block
    is one ``autograd.Function`` with JAX's two-pass backward (pass A
    chunk by chunk: the tail's and the queries' VJPs and dq; pass B tile
    by tile: dk / dv from every later chunk and the K/V build's VJP).

The ``sp_axis`` composition (FPDT over the sequence-parallel ranks)
raises: ROADMAP queue A item 11's sp part. JAX's ``DSTPU_FPDT_BISECT``
debug modes, which deliberately compute wrong gradients, are not
ported, nor is ``fpdt_attention_block(hosted=True)``, which only its
``oldpath`` bisect mode reaches.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from deepspeed_tpu_torch.parallel._blockwise import (block_attn_partial,
                                                     block_mask, finalize,
                                                     init_accumulators,
                                                     online_merge)
from deepspeed_tpu_torch.runtime.optimizer import leaves, set_leaf
from deepspeed_tpu_torch.utils import memspace

_A11_SP = ("ROADMAP queue A item 11's sp part (FPDT over the "
           "sequence-parallel ranks)")


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------


def _chunk_vs_kv_tiles(q, k_tiles, v_tiles, q_pos0: int, causal: bool,
                       s_kv: int, kv_tile: int):
    """One Q chunk against all KV tiles with the online softmax; each
    tile's block is recomputed in the backward (without it the backward
    keeps every tile's [C, kv_tile] probabilities: the O(S^2) memory this
    path exists to avoid)."""
    B, C, N, D = q.shape
    q_pos = q_pos0 + torch.arange(C, device=q.device)
    o, m, l = init_accumulators(B, N, C, D, device=q.device)
    for t, (k_t, v_t) in enumerate(zip(k_tiles, v_tiles)):
        k_pos = t * kv_tile + torch.arange(kv_tile, device=q.device)
        blk = torch.utils.checkpoint.checkpoint(
            block_attn_partial, q, k_t, v_t, q_pos, k_pos, causal, s_kv,
            use_reentrant=False)
        o, m, l = online_merge(o, m, l, blk)
    return finalize(o, l, q.dtype)


def _pad_seq(x: torch.Tensor, to: int) -> torch.Tensor:
    S = x.shape[1]
    if to == S:
        return x
    shape = list(x.shape)
    shape[1] = to - S
    return torch.cat([x, x.new_zeros(shape)], dim=1)


def chunked_attention(q, k, v, causal: bool = True, q_chunks: int = 4,
                      kv_tile: Optional[int] = None, impl: str = "auto"):
    """Exact attention with O(chunk x kv_tile) score memory.

    q, k, v: [B, S, N, D] with equal head counts (callers repeat GQA KV
    first). ``q_chunks``: query chunks, each recomputed in the backward;
    ``kv_tile``: KV tile length (default the chunk length). One chunk
    is ``multi_head_attention(impl=impl)``."""
    B, S, N, D = q.shape
    if q_chunks <= 1:
        from deepspeed_tpu_torch.ops.attention import multi_head_attention

        return multi_head_attention(q, k, v, causal=causal, impl=impl)
    pad_q = (-S) % q_chunks
    Sp = S + pad_q
    kv_tile = kv_tile or max(Sp // q_chunks, 1)
    Skv = S + (-S) % kv_tile
    C = Sp // q_chunks
    q = _pad_seq(q, Sp)
    k_tiles = torch.split(_pad_seq(k, Skv), kv_tile, dim=1)
    v_tiles = torch.split(_pad_seq(v, Skv), kv_tile, dim=1)

    def run(q_c, q_pos0, *kv):
        T = len(kv) // 2
        return _chunk_vs_kv_tiles(q_c, kv[:T], kv[T:], q_pos0, causal, S,
                                  kv_tile)

    outs = [torch.utils.checkpoint.checkpoint(
        run, q_c, i * C, *k_tiles, *v_tiles, use_reentrant=False)
        for i, q_c in enumerate(torch.split(q, C, dim=1))]
    out = torch.cat(outs, dim=1)
    return out[:, :S] if pad_q else out


# ---------------------------------------------------------------------------
# host <-> card moves under autograd
# ---------------------------------------------------------------------------


class _ToHost(torch.autograd.Function):
    """A card tensor into pinned host memory (the copy in flight on the
    copy stream, which every later fetch of it also uses); the backward
    brings the host gradient back to the card."""

    @staticmethod
    def forward(ctx, t):
        ctx.device = t.device
        return memspace.offload(t).tensor

    @staticmethod
    def backward(ctx, g):
        return memspace.fetch(g.contiguous(), ctx.device).wait()


class _ToDevice(torch.autograd.Function):
    """A pinned host tensor onto ``device``; the backward hands autograd
    the gradient in host memory (waited for: autograd may add it to
    another on the host)."""

    @staticmethod
    def forward(ctx, host, device):
        return memspace.fetch(host, device).wait()

    @staticmethod
    def backward(ctx, g):
        return memspace.offload(g.contiguous()).host_wait(), None


def to_host(t: torch.Tensor) -> torch.Tensor:
    return _ToHost.apply(t)


def to_device(host: torch.Tensor, device) -> torch.Tensor:
    return _ToDevice.apply(host, torch.device(device))


# ---------------------------------------------------------------------------
# host-KV streaming attention
# ---------------------------------------------------------------------------


def _masked_scores(q_c, k_rep, q_pos, k_pos, causal: bool, s_valid: int):
    """Scaled masked scores [B, N, C, kv_tile], the forward's numerics."""
    d = q_c.shape[-1]
    s = torch.einsum("bqnd,bknd->bnqk", q_c, k_rep).float() / math.sqrt(d)
    mask = block_mask(q_pos, k_pos, causal, s_valid)
    return torch.where(mask[None, None], s, float("-inf"))


def _repeat(tile: torch.Tensor, g: int) -> torch.Tensor:
    return torch.repeat_interleave(tile, g, dim=2) if g > 1 else tile


def _unrepeat(grad: torch.Tensor, g: int) -> torch.Tensor:
    """[B, kv_tile, Nkv*g, D] gradient summed back to the kv heads."""
    if g == 1:
        return grad
    B, T, NG, D = grad.shape
    return grad.reshape(B, T, NG // g, g, D).sum(dim=3)


class _TileRing:
    """The KV tiles of a host stack fetched in order, the next one in
    flight while the current one is used."""

    def __init__(self, k_host, v_host, n: int, device):
        self.k, self.v, self.n, self.device = k_host, v_host, n, device
        self.next = self._issue(0) if n else None

    def _issue(self, t):
        return (memspace.fetch(self.k[t], self.device),
                memspace.fetch(self.v[t], self.device))

    def __iter__(self):
        for t in range(self.n):
            kt, vt = self.next
            self.next = self._issue(t + 1) if t + 1 < self.n else None
            yield t, kt.wait(), vt.wait()


def stream_attn_forward(q_c, k_host, v_host, q_pos, n_tiles: int, g: int,
                        s_valid: int, causal: bool, kv_tile: int):
    """One q chunk [B, C, N, D] against the first ``n_tiles`` host K/V
    tiles ([B, kv_tile, Nkv, D] each): (ctx [B, C, N, D] in q's dtype,
    lse [B, N, C] fp32)."""
    B, C, N, D = q_c.shape
    dev = q_c.device
    o, m, l = init_accumulators(B, N, C, D, device=dev)
    for t, k_t, v_t in _TileRing(k_host, v_host, n_tiles, dev):
        k_pos = t * kv_tile + torch.arange(kv_tile, device=dev)
        s = _masked_scores(q_c, _repeat(k_t, g), q_pos, k_pos, causal,
                           s_valid)
        m_blk = torch.amax(s, dim=-1)
        valid = torch.isfinite(m_blk)
        m_safe = torch.where(valid, m_blk, 0.0)
        p = torch.exp(s - m_safe[..., None])
        l_blk = torch.where(valid, p.sum(dim=-1), 0.0)
        o_blk = torch.einsum("bnqk,bknd->bnqd", p, _repeat(v_t, g).float())
        m_new = torch.maximum(m, torch.where(valid, m_blk, float("-inf")))
        m_new_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new_safe),
                            0.0)
        beta = torch.where(valid, torch.exp(m_blk - m_new_safe), 0.0)
        o = o * alpha[..., None] + o_blk * beta[..., None]
        l = l * alpha + l_blk * beta
        m = m_new
        # the tile's score-sized temporaries go before the next tile's
        del s, p, o_blk, k_t, v_t
    l_safe = torch.clamp(l, min=1e-30)
    ctx = (o / l_safe[..., None]).permute(0, 2, 1, 3).to(q_c.dtype)
    lse = torch.where(l > 0, torch.where(torch.isfinite(m), m, 0.0)
                      + torch.log(l_safe), 0.0)
    return ctx, lse


def _dq_tile(q_c, k_t, v_t, q_pos, k_pos, lse, d_ctx32, delta, g,
             s_valid, causal, scale):
    """One tile's terms of the backward: (p, ds, k_rep) for dq / dk."""
    k_rep, v_rep = _repeat(k_t, g), _repeat(v_t, g)
    s = _masked_scores(q_c, k_rep, q_pos, k_pos, causal, s_valid)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bnqd,bknd->bnqk", d_ctx32, v_rep.float())
    ds = p * (dp - delta[..., None])
    return p, ds, k_rep


class _StreamAttn(torch.autograd.Function):
    """One q chunk against host-resident KV tiles (JAX ``_stream_attn``).
    The backward recomputes each tile's probabilities from the saved
    logsumexp instead of differentiating the online merge, and hands
    autograd each tile's dk / dv in host memory."""

    @staticmethod
    def forward(ctx, q_c, meta, *kv):
        q_pos0, n_tiles, g, s_valid, causal, kv_tile = meta
        k_host, v_host = kv[:n_tiles], kv[n_tiles:]
        q_pos = q_pos0 + torch.arange(q_c.shape[1], device=q_c.device)
        out, lse = stream_attn_forward(q_c, k_host, v_host, q_pos, n_tiles,
                                       g, s_valid, causal, kv_tile)
        ctx.save_for_backward(q_c, out, lse, *kv)
        ctx.meta = meta
        return out

    @staticmethod
    def backward(ctx, dctx):
        q_c, out, lse, *kv = ctx.saved_tensors
        q_pos0, n_tiles, g, s_valid, causal, kv_tile = ctx.meta
        k_host, v_host = kv[:n_tiles], kv[n_tiles:]
        B, C, N, D = q_c.shape
        dev = q_c.device
        scale = 1.0 / math.sqrt(D)
        q_pos = q_pos0 + torch.arange(C, device=dev)
        d_ctx32 = dctx.float().permute(0, 2, 1, 3)
        delta = (d_ctx32 * out.float().permute(0, 2, 1, 3)).sum(dim=-1)
        q32 = q_c.float().permute(0, 2, 1, 3)
        dq = torch.zeros((B, N, C, D), dtype=torch.float32, device=dev)
        dks, dvs = [], []
        for t, k_t, v_t in _TileRing(k_host, v_host, n_tiles, dev):
            k_pos = t * kv_tile + torch.arange(kv_tile, device=dev)
            p, ds, k_rep = _dq_tile(q_c, k_t, v_t, q_pos, k_pos, lse,
                                    d_ctx32, delta, g, s_valid, causal,
                                    scale)
            dv_rep = torch.einsum("bnqk,bnqd->bknd", p, d_ctx32)
            dq = dq + torch.einsum("bnqk,bknd->bnqd", ds,
                                   k_rep.float()) * scale
            dk_rep = torch.einsum("bnqk,bnqd->bknd", ds, q32) * scale
            dks.append(memspace.offload(_unrepeat(dk_rep, g),
                                        dtype=k_t.dtype))
            dvs.append(memspace.offload(_unrepeat(dv_rep, g),
                                        dtype=v_t.dtype))
            del p, ds, k_rep, dv_rep, dk_rep, k_t, v_t
        dq_out = dq.permute(0, 2, 1, 3).to(q_c.dtype)
        # autograd adds the host tiles of several chunks on the host
        host = [x.host_wait() for x in dks + dvs]
        return (dq_out, None, *host)


def _rope_chunk(x, rope, start: int, length: int):
    from deepspeed_tpu_torch.models.transformer import apply_rope

    if rope is None:
        return x
    cos, sin = rope
    return apply_rope(x, cos[:, start:start + length],
                      sin[:, start:start + length])


def _pad_rope(rope, to: int):
    """The forward's (cos, sin) tables padded along the sequence to
    ``to`` rows (position 0's angles: the padded rows are masked keys or
    dropped queries)."""
    if rope is None:
        return None
    cos, sin = rope
    S = cos.shape[1]
    if to == S:
        return rope
    pad = list(cos.shape)
    pad[1] = to - S
    return (torch.cat([cos, cos.new_ones(pad)], dim=1),
            torch.cat([sin, sin.new_zeros(pad)], dim=1))


def _proj(x, w, b=None):
    out = torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])
    return out if b is None else out + b


def fpdt_attention_block(y, ap, rope, *, num_heads: int, kv_heads: int,
                         head_dim: int, q_chunks: int,
                         kv_tile: Optional[int] = None, causal: bool = True,
                         use_biases: bool = False,
                         norm_fn: Optional[Callable] = None,
                         post_fn: Optional[Callable] = None,
                         sp_axis: Optional[str] = None,
                         sp_size: int = 1) -> torch.Tensor:
    """The FPDT attention sub-layer with host-resident KV (the
    reference's pinned double-buffered sequence chunks,
    sequence/fpdt_layer.py:545).

    y: [B, S, H] layer input, pre-norm when ``norm_fn`` is given (the
    norm then runs per chunk / tile); ``ap`` the layer's attention
    params; ``rope`` the forward's (cos, sin) tables or None. Returns
    the attention branch [B, S, H] (wo applied), or ``post_fn(x_chunk,
    attn_chunk)`` chunk by chunk (the fused rest of the block). The card
    never holds a full-S query, output or repeated-KV tensor."""
    if sp_axis is not None:
        raise NotImplementedError(
            f"fpdt_attention_block(sp_axis={sp_axis!r}): {_A11_SP}")
    B, S, H = y.shape
    dt = y.dtype
    g = num_heads // kv_heads
    pad_q = (-S) % q_chunks
    Sp = S + pad_q
    C = Sp // q_chunks
    kv_tile = kv_tile or C
    Skv = S + (-S) % kv_tile
    T = Skv // kv_tile
    P = max(Sp, Skv)
    y_p = _pad_seq(y, P)
    rope_p = _pad_rope(rope, P)

    def maybe_norm(t):
        return norm_fn(t) if norm_fn is not None else t

    def bias(name):
        return ap[name].to(dt) if use_biases else None

    def kv_tile_fn(x_tile, t):
        yt = maybe_norm(x_tile)
        kt = _proj(yt, ap["wk"].to(dt), bias("bk"))
        vt = _proj(yt, ap["wv"].to(dt), bias("bv"))
        return _rope_chunk(kt, rope_p, t * kv_tile, kv_tile), vt

    # the K/V build: a tile at a time (recomputed in the backward, so its
    # norm intermediates stay tile-sized), each tile straight to the host
    k_host, v_host = [], []
    for t in range(T):
        kt, vt = torch.utils.checkpoint.checkpoint(
            kv_tile_fn, y_p[:, t * kv_tile:(t + 1) * kv_tile], t,
            use_reentrant=False)
        k_host.append(to_host(kt))
        v_host.append(to_host(vt))

    wo = ap["wo"].to(dt)

    def chunk(x_chunk, idx, n_tiles, *kv):
        q_c = _proj(maybe_norm(x_chunk), ap["wq"].to(dt), bias("bq"))
        q_c = _rope_chunk(q_c, rope_p, idx * C, C)
        ctx = _StreamAttn.apply(q_c, (idx * C, n_tiles, g, S, causal,
                                      kv_tile), *kv)
        attn_c = torch.matmul(ctx.reshape(B, C, -1),
                              wo.reshape(-1, wo.shape[-1]))
        if post_fn is not None:
            return post_fn(x_chunk, attn_c)
        return attn_c

    out = y_p.new_zeros((B, Sp, H))
    for idx in range(q_chunks):
        # causal: the tiles past the chunk are never fetched
        n_tiles = (min(-(-((idx + 1) * C) // kv_tile), T) if causal
                   else T)
        res = torch.utils.checkpoint.checkpoint(
            chunk, y_p[:, idx * C:(idx + 1) * C], idx, n_tiles,
            *k_host[:n_tiles], *v_host[:n_tiles], use_reentrant=False)
        out[:, idx * C:(idx + 1) * C] = res
    return out[:, :S] if pad_q else out


# ---------------------------------------------------------------------------
# the hosted-residual layer with a two-pass backward
# ---------------------------------------------------------------------------


class HostedSpec:
    """The static shape of a hosted layer (JAX ``fpdt_hosted_layer``'s
    keyword arguments)."""

    def __init__(self, seq_len: int, q_chunks: int, num_heads: int,
                 kv_heads: int, head_dim: int, rope, use_biases: bool,
                 norm_kind: str, norm_eps: float, activation: str,
                 treedef: Sequence[str], device):
        self.S, self.T = seq_len, q_chunks
        self.C = -(-seq_len // q_chunks)
        self.N, self.Nkv, self.D = num_heads, kv_heads, head_dim
        self.g = num_heads // kv_heads
        self.rope = _pad_rope(rope, self.T * self.C)
        self.use_biases = use_biases
        self.norm_kind, self.norm_eps = norm_kind, norm_eps
        self.activation = activation
        self.paths = list(treedef)
        self.device = device

    def params(self, values) -> dict:
        tree: dict = {}
        for path, leaf in zip(self.paths, values):
            set_leaf(tree, path, leaf)
        return tree


def _hosted_pieces(spec: HostedSpec, dt):
    from deepspeed_tpu_torch.models.transformer import _norm, act_fn

    def norm(x, p):
        return _norm(x, p, spec.norm_kind, spec.norm_eps)

    def bias(ap, name):
        return ap[name].to(dt) if spec.use_biases else None

    def head_q(x_c, idx, params):
        ap = params["attn"]
        q = _proj(norm(x_c, params["ln1"]), ap["wq"].to(dt), bias(ap, "bq"))
        return _rope_chunk(q, spec.rope, idx * spec.C, spec.C)

    def build_kv(x_c, idx, params):
        ap = params["attn"]
        y = norm(x_c, params["ln1"])
        k = _proj(y, ap["wk"].to(dt), bias(ap, "bk"))
        v = _proj(y, ap["wv"].to(dt), bias(ap, "bv"))
        return _rope_chunk(k, spec.rope, idx * spec.C, spec.C), v

    def tail(x_c, ctx_c, params):
        ap, mp = params["attn"], params["mlp"]
        wo = ap["wo"].to(dt)
        attn = torch.matmul(ctx_c.reshape(*ctx_c.shape[:2], -1),
                            wo.reshape(-1, wo.shape[-1]))
        if spec.use_biases:
            attn = attn + ap["bo"].to(dt)
        xc2 = x_c + attn
        y2 = norm(xc2, params["ln2"])
        if spec.activation == "swiglu":
            z = torch.nn.functional.silu(torch.matmul(y2, mp["wg"].to(dt))) \
                * torch.matmul(y2, mp["wi"].to(dt))
        else:
            pre = torch.matmul(y2, mp["wi"].to(dt))
            if spec.use_biases:
                pre = pre + mp["bi"].to(dt)
            z = act_fn(spec.activation)(pre)
        out = torch.matmul(z, mp["wo"].to(dt))
        if spec.use_biases:
            out = out + mp["bo"].to(dt)
        return xc2 + out

    return head_q, build_kv, tail


class _HostedLayer(torch.autograd.Function):
    """One fused block over host residual chunks (JAX
    ``fpdt_hosted_layer``'s custom VJP)."""

    @staticmethod
    def forward(ctx, spec: HostedSpec, n_chunks: int, *inputs):
        x_t, leaves = inputs[:n_chunks], inputs[n_chunks:]
        params = spec.params(leaves)
        dt = x_t[0].dtype
        head_q, build_kv, tail = _hosted_pieces(spec, dt)
        dev, T, C = spec.device, spec.T, spec.C
        k_host, v_host = [], []
        nxt = memspace.fetch(x_t[0], dev)
        for t in range(T):
            x_tile = nxt.wait()
            nxt = memspace.fetch(x_t[t + 1], dev) if t + 1 < T else None
            k, v = build_kv(x_tile, t, params)
            k_host.append(memspace.offload(k).tensor)
            v_host.append(memspace.offload(v).tensor)
        out_t, ctx_t, lse_t = [], [], []
        nxt = memspace.fetch(x_t[0], dev)
        for idx in range(T):
            x_c = nxt.wait()
            nxt = memspace.fetch(x_t[idx + 1], dev) if idx + 1 < T else None
            q_c = head_q(x_c, idx, params)
            q_pos = idx * C + torch.arange(C, device=dev)
            c, lse = stream_attn_forward(q_c, k_host, v_host, q_pos,
                                         idx + 1, spec.g, spec.S, True, C)
            out_t.append(memspace.offload(tail(x_c, c, params)))
            ctx_t.append(memspace.offload(c).tensor)
            lse_t.append(memspace.offload(lse).tensor)
        ctx.spec, ctx.n_chunks = spec, n_chunks
        ctx.save_for_backward(*x_t, *leaves)
        ctx.res = (k_host, v_host, ctx_t, lse_t)
        # the next layer fetches these on the copy stream, in order; the
        # host itself reads them only after a backward's wait
        return tuple(o.tensor for o in out_t)

    @staticmethod
    def backward(ctx, *d_out_t):
        spec, n = ctx.spec, ctx.n_chunks
        saved = ctx.saved_tensors
        x_t, leaves = saved[:n], saved[n:]
        k_host, v_host, ctx_t, lse_t = ctx.res
        dt = x_t[0].dtype
        head_q, build_kv, tail = _hosted_pieces(spec, dt)
        dev, T, C, g = spec.device, spec.T, spec.C, spec.g
        B = x_t[0].shape[0]
        N, D = spec.N, spec.D
        scale = 1.0 / math.sqrt(D)
        f32 = torch.float32
        dparams = [torch.zeros(p.shape, dtype=f32, device=p.device)
                   for p in leaves]

        def leaf_inputs():
            ps = [p.detach().requires_grad_() for p in leaves]
            return ps, spec.params(ps)

        def fetched(host):
            return memspace.fetch(host, dev).wait()

        # pass A: chunk by chunk --- the tail's VJP, dq, the queries' VJP
        dxa_t, q_t, dctx_t, delta_t = [], [], [], []
        with torch.enable_grad():
            for idx in range(T):
                x_c = fetched(x_t[idx]).requires_grad_()
                c_c = fetched(ctx_t[idx]).requires_grad_()
                d_out = fetched(d_out_t[idx].contiguous())
                lse = fetched(lse_t[idx])
                ps, params = leaf_inputs()
                grads = torch.autograd.grad(tail(x_c, c_c, params),
                                            [x_c, c_c] + ps, d_out,
                                            allow_unused=True)
                dx_post, d_ctx, dp_tail = grads[0], grads[1], grads[2:]
                d_ctx32 = d_ctx.float().permute(0, 2, 1, 3)
                delta = (d_ctx32 * c_c.detach().float().permute(
                    0, 2, 1, 3)).sum(dim=-1)
                x_q = x_c.detach().requires_grad_()
                ps_q, params_q = leaf_inputs()
                q_c = head_q(x_q, idx, params_q)
                q_pos = idx * C + torch.arange(C, device=dev)
                dq = torch.zeros((B, N, C, D), dtype=f32, device=dev)
                with torch.no_grad():
                    for t, k_t, v_t in _TileRing(k_host, v_host, idx + 1,
                                                 dev):
                        k_pos = t * C + torch.arange(C, device=dev)
                        _, ds, k_rep = _dq_tile(q_c.detach(), k_t, v_t,
                                                q_pos, k_pos, lse, d_ctx32,
                                                delta, g, spec.S, True,
                                                scale)
                        dq = dq + torch.einsum("bnqk,bknd->bnqd", ds,
                                               k_rep.float()) * scale
                        del ds, k_rep, k_t, v_t
                dq = dq.permute(0, 2, 1, 3).to(q_c.dtype)
                grads_q = torch.autograd.grad(q_c, [x_q] + ps_q, dq,
                                              allow_unused=True)
                for i, (a, b) in enumerate(zip(dp_tail, grads_q[1:])):
                    for part in (a, b):
                        if part is not None:
                            dparams[i] += part.float()
                dx_c = (dx_post + grads_q[0]).to(dt)
                dxa_t.append(memspace.offload(dx_c).tensor)
                q_t.append(memspace.offload(q_c.detach()).tensor)
                dctx_t.append(memspace.offload(d_ctx).tensor)
                delta_t.append(memspace.offload(delta).tensor)

        # pass B: tile by tile --- dk / dv from every later chunk, then the
        # K/V build's VJP
        dx_t = []
        with torch.enable_grad():
            for t in range(T):
                x_tile = fetched(x_t[t]).requires_grad_()
                k_t, v_t = fetched(k_host[t]), fetched(v_host[t])
                k_rep, v_rep = _repeat(k_t, g), _repeat(v_t, g)
                k_pos = t * C + torch.arange(C, device=dev)
                dk = torch.zeros((B, C, N, D), dtype=f32, device=dev)
                dv = torch.zeros((B, C, N, D), dtype=f32, device=dev)
                with torch.no_grad():
                    for c in range(t, T):
                        q_c = fetched(q_t[c])
                        d_ctx32 = fetched(dctx_t[c]).float().permute(
                            0, 2, 1, 3)
                        lse, delta = fetched(lse_t[c]), fetched(delta_t[c])
                        q_pos = c * C + torch.arange(C, device=dev)
                        s = _masked_scores(q_c, k_rep, q_pos, k_pos, True,
                                           spec.S)
                        p = torch.exp(s - lse[..., None])
                        dv = dv + torch.einsum("bnqk,bnqd->bknd", p,
                                               d_ctx32)
                        dp = torch.einsum("bnqd,bknd->bnqk", d_ctx32,
                                          v_rep.float())
                        ds = p * (dp - delta[..., None])
                        dk = dk + torch.einsum(
                            "bnqk,bnqd->bknd", ds,
                            q_c.float().permute(0, 2, 1, 3)) * scale
                        del s, p, dp, ds
                ps, params = leaf_inputs()
                k_new, v_new = build_kv(x_tile, t, params)
                grads = torch.autograd.grad(
                    (k_new, v_new), [x_tile] + ps,
                    (_unrepeat(dk, g).to(dt), _unrepeat(dv, g).to(dt)),
                    allow_unused=True)
                for i, part in enumerate(grads[1:]):
                    if part is not None:
                        dparams[i] += part.float()
                dx = (fetched(dxa_t[t]) + grads[0]).to(dt)
                dx_t.append(memspace.offload(dx))
        dx_host = [x.host_wait() for x in dx_t]
        dleaves = [gp.to(p.dtype) for gp, p in zip(dparams, leaves)]
        return (None, None, *dx_host, *dleaves)


def fpdt_hosted_layer(x_t: Sequence[torch.Tensor], layer_params, rope, *,
                      seq_len: int, q_chunks: int, num_heads: int,
                      kv_heads: int, head_dim: int, use_biases: bool,
                      norm_kind: str, norm_eps: float, activation: str,
                      device) -> Tuple[torch.Tensor, ...]:
    """One fused transformer block over a tuple of ``q_chunks`` host
    residual chunks [B, C, H] (the padded sequence on the chunk grid);
    returns the block's output chunks, on the host. The backward runs
    JAX's two passes, with every host object written once and read a
    bounded number of times through tile-sized card buffers."""
    if len(x_t) != q_chunks:
        raise ValueError(f"hosted fpdt: q_chunks={q_chunks} must equal the "
                         f"host stack's chunk count {len(x_t)}")
    flat = list(leaves(layer_params))
    spec = HostedSpec(seq_len, q_chunks, num_heads, kv_heads, head_dim,
                      rope, use_biases, norm_kind, norm_eps, activation,
                      [p for p, _ in flat], torch.device(device))
    return _HostedLayer.apply(spec, len(x_t), *x_t, *[v for _, v in flat])


__all__ = ["chunked_attention", "fpdt_attention_block", "fpdt_hosted_layer",
           "stream_attn_forward", "to_host", "to_device"]
