"""Paged (blocked-KV) decode and chunked-prefill attention.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``: same functions,
signatures and layouts. On CUDA tensors each wrapper launches its
hand-written Hopper kernel (``csrc/paged_attention.cu``) or raises; on
CPU tensors it runs the plain PyTorch version beside it, which folds the
pages in the kernel's order. There is no other path: no fallback when a
build or a launch fails.

Prefill has two kernels, chosen by ``paged_prefill_variant`` from type,
shapes and alignment alone: the tensor-core kernel (``wgmma`` fed by TMA)
for bf16 q and pool with head dim 128, a block size of 8 to 128 that
divides 128, a query group (num_heads / kv_heads) that divides 128 and
16-byte aligned data; the scalar kernel (``simt``) for the rest. Decode
has two too, chosen by ``paged_decode_variant``: the split kernel
(``split``: spans of pages in parallel, merged inside the same launch)
for bf16 q and pool with head dim 128, contiguous and 16-byte aligned;
the scalar kernel for the rest. The span is a whole number of pages
chosen from shapes alone (``decode_span_pages``), never from the context
lengths, so a sequence's output does not depend on its neighbours'.

Layout (as ``inference/ragged/kv_cache.py``): one layer's pool is
``kv[num_blocks, block_size, 2, kv_heads, head_dim]`` with K in plane 0
and V in plane 1.

``LAUNCHES`` counts kernel launches per kernel (the plain version never
counts), so a run can show that its main path went through the kernels;
``VARIANT_LAUNCHES`` splits the decode and prefill launches by variant.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e30

LAUNCHES: Dict[str, int] = {"paged_decode": 0, "paged_prefill": 0}
VARIANT_LAUNCHES: Dict[str, int] = {"paged_decode/split": 0,
                                    "paged_decode/simt": 0,
                                    "paged_prefill/wgmma": 0,
                                    "paged_prefill/simt": 0}

# query rows per prefill thread block, and tokens read per chunk
_PREFILL_ROWS = 64
_DECODE_CHUNK_TOKENS = 64
_PREFILL_CHUNK_TOKENS = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# split decode: blocks wanted per SM when every row fills its table, the
# fewest tokens a span holds, query rows a block takes at most
_SPLIT_BLOCKS_PER_SM = 2
_MIN_SPAN_TOKENS = 128
_SPLIT_ROWS = 8


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def paged_prefill_variant(q: torch.Tensor, kv_layer: torch.Tensor,
                          device_type: Optional[str] = None) -> str:
    """Which prefill kernel runs on q [S, Tq, nh, hd] and the layer pool
    [nb, bs, 2, nkv, hd]: "plain" on the CPU; on the card "wgmma" (the
    tensor-core kernel) for bf16 q and pool with hd 128, bs in {8, 16,
    32, 64, 128} (TMA page boxes stacked on 1024-byte swizzle atoms),
    nh / nkv dividing 128 (a tile's rows are whole queries), both
    contiguous and 16-byte aligned, else "simt" (the scalar kernel).
    ``device_type`` stands in for q's device (tests ask the card's rule
    of CPU tensors)."""
    if (device_type or q.device.type) == "cpu":
        return "plain"
    bs, nkv, hd = kv_layer.shape[1], kv_layer.shape[3], kv_layer.shape[4]
    g = q.shape[2] // nkv
    if (q.dtype == kv_layer.dtype == torch.bfloat16 and hd == 128
            and q.shape[-1] == hd and bs % 8 == 0 and 128 % bs == 0
            and g > 0 and 128 % g == 0
            and q.is_contiguous() and kv_layer.is_contiguous()
            and q.data_ptr() % 16 == 0 and kv_layer.data_ptr() % 16 == 0):
        return "wgmma"
    return "simt"


def paged_decode_variant(q: torch.Tensor, kv_layer: torch.Tensor,
                         device_type: Optional[str] = None) -> str:
    """Which decode kernel runs on q [S, nh, hd] and the layer pool
    [nb, bs, 2, nkv, hd]: "plain" on the CPU; on the card "split" (the
    split kernel) for bf16 q and pool with hd 128, both contiguous and
    16-byte aligned, else "simt" (the scalar kernel). ``device_type``
    stands in for q's device (tests ask the card's rule of CPU
    tensors)."""
    if (device_type or q.device.type) == "cpu":
        return "plain"
    if (q.dtype == kv_layer.dtype == torch.bfloat16
            and kv_layer.shape[-1] == q.shape[-1] == 128
            and q.is_contiguous() and kv_layer.is_contiguous()
            and q.data_ptr() % 16 == 0 and kv_layer.data_ptr() % 16 == 0):
        return "split"
    return "simt"


def decode_split_groups(nh: int, nkv: int) -> int:
    """Blocks that share a kv head's span in the split decode: each takes
    up to ``_SPLIT_ROWS`` (8) of its g = nh / nkv query heads."""
    return -(-(nh // nkv) // _SPLIT_ROWS)


def decode_span_pages(S: int, nh: int, nkv: int, max_pages: int, bs: int,
                      sms: int) -> int:
    """Pages a split-decode block takes, from shapes alone: enough spans
    that ``_SPLIT_BLOCKS_PER_SM`` blocks an SM run when every sequence
    fills its ``max_pages``-page table, no span under
    ``_MIN_SPAN_TOKENS`` tokens, none past the table. More spans cost
    more partials for the last block of a sequence to merge; 2 blocks an
    SM measured best on an H100 (PERF.md, the split decode's finding)."""
    blocks = max(1, S * nkv * decode_split_groups(nh, nkv))
    splits = -(-_SPLIT_BLOCKS_PER_SM * sms // blocks)
    span = max(max_pages // splits, -(-_MIN_SPAN_TOKENS // bs), 1)
    return min(span, max(max_pages, 1))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _fold_page(q, k, v, visible, m, l, acc):
    """Fold one K/V page into the online-softmax state.

    q [..., R, hd] fp32 (pre-scaled); k/v [..., bs, hd] fp32; visible
    [..., R, bs]; m/l [..., R, 1]; acc [..., R, hd]."""
    sc = torch.matmul(q, k.transpose(-1, -2))
    sc = torch.where(visible, sc, torch.full_like(sc, NEG_INF))
    m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    # explicit zero for masked columns: when every score so far is the
    # NEG_INF sentinel, exp(sc - m_new) == exp(0) would count them
    p = torch.where(visible, torch.exp(sc - m_new), torch.zeros_like(sc))
    l = alpha * l + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.matmul(p, v)
    return m_new, l, acc


def _paged_fold(qg, kv_layer, block_table, qpos, ctx, scale):
    """qg [S, nkv, R, hd]; qpos [S, R] absolute position of each row;
    ctx [S]. Column col is visible to a row when col <= qpos and
    col < ctx. Folds the table's pages in ascending order from a fresh
    state; returns fp32 (m, l [S, nkv, R, 1], acc [S, nkv, R, hd])."""
    S, nkv, R, hd = qg.shape
    nb, bs = kv_layer.shape[0], kv_layer.shape[1]
    q = qg.float() * scale
    m = torch.full((S, nkv, R, 1), NEG_INF, device=q.device)
    l = torch.zeros((S, nkv, R, 1), device=q.device)
    acc = torch.zeros((S, nkv, R, hd), device=q.device)
    bt = block_table.long().clamp(0, nb - 1)
    ctx = ctx.long()
    qpos = qpos.long()
    # pages at or past every slot's context fold nothing: stop there
    max_ctx = int(ctx.max()) if S else 0
    n_pages = min(block_table.shape[1], -(-max_ctx // bs))
    for j in range(n_pages):
        page = kv_layer[bt[:, j]].float()  # [S, bs, 2, nkv, hd]
        k = page[:, :, 0].permute(0, 2, 1, 3)  # [S, nkv, bs, hd]
        v = page[:, :, 1].permute(0, 2, 1, 3)
        cols = j * bs + torch.arange(bs, device=q.device)
        visible = ((cols[None, None, :] <= qpos[:, :, None])
                   & (cols[None, None, :] < ctx[:, None, None]))
        m, l, acc = _fold_page(q, k, v, visible[:, None], m, l, acc)
    return m, l, acc


def _finish(l, acc):
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # dead rows give 0
    return acc / l


def _paged_plain(qg, kv_layer, block_table, qpos, ctx, scale):
    """The fold of :func:`_paged_fold`, normalised: fp32 [S, nkv, R, hd]."""
    _, l, acc = _paged_fold(qg, kv_layer, block_table, qpos, ctx, scale)
    return _finish(l, acc)


def paged_decode_attention_plain(q, kv_layer, block_table, context_lens,
                                 scale: float):
    S, nh, hd = q.shape
    nkv = kv_layer.shape[3]
    g = nh // nkv
    qpos = (context_lens.long() - 1)[:, None].expand(S, g)
    out = _paged_plain(q.reshape(S, nkv, g, hd), kv_layer, block_table,
                       qpos, context_lens, scale)
    return out.reshape(S, nh, hd).to(q.dtype)


def paged_decode_attention_split_plain(q, kv_layer, block_table,
                                       context_lens, scale: float,
                                       span_pages: int):
    """The split kernel's fold order: the table cut into spans of
    ``span_pages`` pages, each span's pages folded in ascending order
    from a fresh (m, l, acc) as :func:`_paged_plain` folds them, then the
    spans merged in ascending order: M = max_i m_i, w_i = exp(m_i - M),
    L = sum_i w_i l_i, A = sum_i w_i acc_i, out = A / L (0 where L == 0).
    A span with no visible column (m = NEG_INF, l = 0, acc = 0) weighs
    exactly 0 beside a live one. With one span covering the table this is
    :func:`paged_decode_attention_plain` bit for bit."""
    if span_pages < 1:
        raise ValueError(f"span_pages must be >= 1, got {span_pages}")
    S, nh, hd = q.shape
    nkv, bs = kv_layer.shape[3], kv_layer.shape[1]
    g = nh // nkv
    qg = q.reshape(S, nkv, g, hd)
    ctx = context_lens.long()
    Bm = block_table.shape[1]
    states = []
    for p0 in range(0, max(Bm, 1), span_pages):
        # the span's columns, counted from its first one
        ctx_k = ctx - p0 * bs
        qpos = (ctx_k - 1)[:, None].expand(S, g)
        states.append(_paged_fold(qg, kv_layer,
                                  block_table[:, p0:p0 + span_pages], qpos,
                                  ctx_k, scale))
    M = states[0][0]
    for m, _, _ in states[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.exp(m - M)
        L = L + w * l
        A = A + w * acc
    return _finish(L, A).reshape(S, nh, hd).to(q.dtype)


def paged_prefill_attention_plain(q, kv_layer, block_table, seg_pos0,
                                  context_lens, scale: float):
    S, tq, nh, hd = q.shape
    nkv = kv_layer.shape[3]
    g = nh // nkv
    # [S, Tq, nh, hd] -> [S, nkv, Tq*g, hd]: rows query-major, group-minor
    qg = (q.reshape(S, tq, nkv, g, hd).permute(0, 2, 1, 3, 4)
          .reshape(S, nkv, tq * g, hd))
    rows = torch.arange(tq * g, device=q.device) // g
    qpos = seg_pos0.long()[:, None] + rows[None, :]
    out = _paged_plain(qg, kv_layer, block_table, qpos, context_lens, scale)
    return (out.reshape(S, nkv, tq, g, hd).permute(0, 2, 1, 3, 4)
            .reshape(S, tq, nh, hd).to(q.dtype))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from deepspeed_tpu_torch.ops import build

        lib = build.load("paged_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dstpu_paged_decode.argtypes = [
            I, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P]
        lib.dstpu_paged_decode.restype = I
        lib.dstpu_paged_decode_split.argtypes = [
            P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P]
        lib.dstpu_paged_decode_split.restype = I
        lib.dstpu_paged_prefill.argtypes = [
            I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, P]
        lib.dstpu_paged_prefill.restype = I
        lib.dstpu_paged_prefill_wgmma.argtypes = [
            P, P, P, P, P, P, I, I, I, I, I, I, I, F, P]
        lib.dstpu_paged_prefill_wgmma.restype = I
        lib.dstpu_cuda_error_string.argtypes = [I]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_common(q, kv_layer, block_table, ints, nh):
    if kv_layer.dim() != 5 or kv_layer.shape[2] != 2:
        raise ValueError(f"kv_layer must be [nb, bs, 2, nkv, hd], got "
                         f"{tuple(kv_layer.shape)}")
    nkv, hd = kv_layer.shape[3], kv_layer.shape[4]
    if q.shape[-1] != hd:
        raise ValueError(f"q head_dim {q.shape[-1]} != pool head_dim {hd}")
    if nh % nkv:
        raise ValueError(f"num_heads {nh} not a multiple of kv_heads {nkv}")
    if block_table.dim() != 2 or block_table.shape[0] != q.shape[0]:
        raise ValueError(f"block_table must be [S, max_pages], got "
                         f"{tuple(block_table.shape)}")
    for t in ints:
        if t.shape != (q.shape[0],):
            raise ValueError(f"per-sequence metadata must be [S], got "
                             f"{tuple(t.shape)}")
    tensors = (q, kv_layer, block_table, *ints)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, kv_layer and the metadata must share a device")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE or kv_layer.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q and pool of "
                        f"one type, got {q.dtype} and {kv_layer.dtype}")
    if any(t.dtype != torch.int32 for t in (block_table, *ints)):
        raise TypeError("block_table and per-sequence metadata must be "
                        "int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    return True


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().dstpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


# per (device, stream): the split decode's ticket counters, zero between
# launches (each launch leaves them 0); the SM count per device
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}
_SMS: Dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _COUNTERS.get((dev.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[(dev.index, stream)] = buf
    return buf


def decode_span_of(q: torch.Tensor, kv_layer: torch.Tensor,
                   block_table: torch.Tensor) -> int:
    """The span (pages) the split decode takes on these CUDA tensors."""
    return decode_span_pages(q.shape[0], q.shape[1], kv_layer.shape[3],
                             block_table.shape[1], kv_layer.shape[1],
                             _sm_count(q.device))


def _decode_split(q, kv_layer, block_table, context_lens, out, scale,
                  stream):
    S, nh, _ = q.shape
    nb, bs, _, nkv, hd = kv_layer.shape
    Bm = block_table.shape[1]
    if nb * bs >= 2 ** 31:
        raise ValueError(f"the split decode indexes pool rows in 32 bits: "
                         f"{nb} x {bs} rows")
    span = decode_span_of(q, kv_layer, block_table)
    nsplit = -(-Bm // span) if Bm else 1
    seqs = S * nkv * decode_split_groups(nh, nkv)
    # each block's (acc, m, l) for its 8 rows; untouched where a sequence
    # has one span
    part = torch.empty(
        seqs * nsplit * _SPLIT_ROWS * (hd + 2) if nsplit > 1 else 1,
        dtype=torch.float32, device=q.device)
    counters = _counters(q.device, stream, seqs)
    return _lib().dstpu_paged_decode_split(
        q.data_ptr(), kv_layer.data_ptr(), block_table.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), part.data_ptr(),
        counters.data_ptr(), S, nh, nkv, nb, bs, Bm, span, float(scale),
        stream)


def paged_decode_attention(q: torch.Tensor, kv_layer: torch.Tensor,
                           block_table: torch.Tensor,
                           context_lens: torch.Tensor,
                           scale: Optional[float] = None,
                           pages_per_compute_block: int = 1,
                           variant: Optional[str] = None) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q            [S, num_heads, head_dim] — one query token per sequence
    kv_layer     [num_blocks, block_size, 2, kv_heads, head_dim]
    block_table  [S, max_pages] int32 page ids (entries past the context
                 may be stale; they are never read)
    context_lens [S] int32 — keys visible per sequence (including the
                 token written this step); 0 marks a dead slot (output 0)

    ``pages_per_compute_block`` is accepted for parity with the JAX
    signature; the JAX result is bit-identical for every value, and the
    port's does not depend on it. ``variant`` ("split" or "simt", CUDA
    tensors only) overrides :func:`paged_decode_variant`'s choice, so that
    the scalar kernel can run on inputs the split one takes; "split" on
    inputs it does not take raises.

    Returns [S, num_heads, head_dim] in q.dtype.
    """
    del pages_per_compute_block
    S, nh, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if not _check_common(q, kv_layer, block_table, (context_lens,), nh):
        if variant is not None:
            raise ValueError("a decode kernel variant runs on CUDA tensors")
        return paged_decode_attention_plain(q, kv_layer, block_table,
                                            context_lens, scale)
    rule = paged_decode_variant(q, kv_layer)
    variant = rule if variant is None else variant
    if variant not in ("split", "simt"):
        raise ValueError(f"unknown paged decode variant {variant!r}")
    if variant == "split" and rule != "split":
        raise ValueError("the split decode takes bf16 q and pool of head "
                         "dim 128, contiguous and 16-byte aligned")
    nb, bs, _, nkv, _ = kv_layer.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "split":
        rc = _decode_split(q, kv_layer, block_table, context_lens, out,
                           scale, stream)
    else:
        rc = _lib().dstpu_paged_decode(
            _DTYPE_CODE[q.dtype], q.data_ptr(), kv_layer.data_ptr(),
            block_table.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            S, nh, nkv, hd, nb, bs, block_table.shape[1],
            max(1, _DECODE_CHUNK_TOKENS // bs), float(scale), stream)
    _raise_on(rc, f"paged_decode ({variant})")
    LAUNCHES["paged_decode"] += 1
    VARIANT_LAUNCHES[f"paged_decode/{variant}"] += 1
    return out


def paged_prefill_attention(q: torch.Tensor, kv_layer: torch.Tensor,
                            block_table: torch.Tensor,
                            seg_pos0: torch.Tensor,
                            context_lens: torch.Tensor,
                            scale: Optional[float] = None,
                            pages_per_compute_block: int = 1,
                            variant: Optional[str] = None
                            ) -> torch.Tensor:
    """Chunked-prefill attention over paged KV (SplitFuse chunk step).

    Segment s holds ``Tq`` new queries at absolute positions
    pos0[s]..pos0[s]+Tq-1, already scattered into the paged cache; query
    at position qpos attends columns col <= qpos with col < ctx[s].

    q            [S, Tq, num_heads, head_dim]
    kv_layer     [num_blocks, block_size, 2, kv_heads, head_dim]
    block_table  [S, max_pages] int32
    seg_pos0     [S] int32 absolute position of each segment's first query
    context_lens [S] int32 keys visible to the segment's last real query
                 (pos0 + n_real_tokens); 0 marks a dead segment (output 0)

    ``pages_per_compute_block`` is accepted for signature parity (see
    :func:`paged_decode_attention`). Unlike the TPU kernel, Tq * group
    need not be a multiple of 8: the Hopper kernels tile query rows.
    ``variant`` ("wgmma" or "simt", CUDA tensors only) overrides
    :func:`paged_prefill_variant`'s choice, so that the scalar kernel can
    run on inputs the tensor-core one takes; "wgmma" on inputs it does
    not take raises.

    Returns [S, Tq, num_heads, head_dim] in q.dtype.
    """
    del pages_per_compute_block
    S, tq, nh, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if not _check_common(q, kv_layer, block_table, (seg_pos0, context_lens),
                         nh):
        if variant is not None:
            raise ValueError("a prefill kernel variant runs on CUDA tensors")
        return paged_prefill_attention_plain(q, kv_layer, block_table,
                                             seg_pos0, context_lens, scale)
    rule = paged_prefill_variant(q, kv_layer)
    variant = rule if variant is None else variant
    if variant not in ("wgmma", "simt"):
        raise ValueError(f"unknown paged prefill variant {variant!r}")
    if variant == "wgmma" and rule != "wgmma":
        raise ValueError("the tensor-core prefill takes bf16 q and pool of "
                         "head dim 128, block size 8 to 128 dividing 128, a "
                         "query group dividing 128 and 16-byte aligned data")
    nb, bs, _, nkv, _ = kv_layer.shape
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), kv_layer.data_ptr(), block_table.data_ptr(),
            seg_pos0.data_ptr(), context_lens.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "wgmma":
        rc = _lib().dstpu_paged_prefill_wgmma(
            *ptrs, S, tq, nh, nkv, nb, bs, block_table.shape[1],
            float(scale), stream)
    else:
        rc = _lib().dstpu_paged_prefill(
            _DTYPE_CODE[q.dtype], *ptrs, S, tq, nh, nkv, hd, nb, bs,
            block_table.shape[1], _PREFILL_ROWS,
            max(1, _PREFILL_CHUNK_TOKENS // bs), float(scale), stream)
    _raise_on(rc, f"paged_prefill ({variant})")
    LAUNCHES["paged_prefill"] += 1
    VARIANT_LAUNCHES[f"paged_prefill/{variant}"] += 1
    return out
