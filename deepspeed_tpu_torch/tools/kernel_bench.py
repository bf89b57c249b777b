"""kernel_bench: each hand-written kernel against the path the dispatch
falls back to, per shape bucket (port of ``tools/kernel_bench.py``).

Run as ``python -m deepspeed_tpu_torch.tools.kernel_bench``. For every
arm it times the kernel and its fallback on the same inputs, records the
win ratio (xla_ms / kernel_ms; >= 1.0 means the kernel earns its slot)
with :func:`ops.kernel_table.record`, and gates:

  - numerics: every kernel's forward matches its fallback, and the flash
    and gmm arms' gradients match the fallback's, row by row: a row's
    largest error over its largest reference entry (gradients: over a
    tenth of the tensor's largest entry where that is more) within
    ``ROW_TOL`` (gradients: ``GRAD_ROW_TOL``) of the type, and the
    outputs elementwise ``allclose`` at ``ALLCLOSE_TOL`` (JAX's gate);
  - launches (CUDA only): every arm's kernels launched (their launch
    counters moved), and ``blocks`` names the template that ran;
  - the dispatch probe: with the fresh table, a losing flash bucket
    routes through ``multi_head_attention`` to ``xla_attention`` bit for
    bit, and a winning one dispatches to the flash kernel.

The arms (fallback in brackets): ``flash`` (``xla_attention``), forward
plus backward, so the forward, dK/dV and dQ kernels; ``paged`` (the
pages gathered dense, masked, fp32 softmax; JAX's gather-path
reference), forward only; ``gmm`` (the dense per-group product: one
matmul per group's rows, in fp32 accumulation), forward plus backward,
so gmm, gmm^T and tgmm; ``blocksparse`` (the masked form over the same
layout, KV heads repeated), forward only and outside autograd, where the
block-sparse kernel runs. The Hopper kernels fix their own tiles, so
there is no block sweep: ``blocks`` records the template that ran.
Each row also carries ``library_ms``, one PyTorch call computing the same
function (``scaled_dot_product_attention``, with a boolean mask for the
paged and block-sparse arms; ``torch._grouped_mm`` for gmm where this
torch has it), for information only: it is never used to route and never
called by the port's paths.

Timing: on the card ``KERNEL_BENCH_ITERS`` calls (default 10) run back
to back between one pair of CUDA events, after one warm-up, and the
median of ``REPEATS`` such runs over the calls is a call's time: one
call's host work overlaps the card's work on the one before, so a row
reads the card unless the host is the slower. The host clock times
single calls on the CPU (default 2), where the "kernel" is its plain
PyTorch version.

Rows land in ``KERNEL_BENCH_RECORD_PATH``, else in a table in a fresh
temporary directory: a run never rewrites the port's committed table
(``deepspeed_tpu_torch/kernel_table.json``) unless that path is given
explicitly, and never the table a later dispatch reads by default. (JAX
refreshes its committed table from every TPU run.) Env knobs (JAX's):
KERNEL_BENCH_KERNELS (csv of flash,paged,gmm,blocksparse),
KERNEL_BENCH_FULL (1: the card tier's shapes, PERF.md's kernel table;
default 1 on the card, 0 elsewhere), KERNEL_BENCH_ITERS,
KERNEL_BENCH_RECORD_PATH. Payload schema: JAX's ``kernel_bench/v1``.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import kernel_table

SCHEMA = "kernel_bench/v1"

# the numerics gate's bound on a row's relative error, by type: bf16
# kernels round P (or the product) differently from the dense path,
# which itself takes its scores in bf16 (flash against it: 0.013-0.015
# on the CPU at S 256-2048)
ROW_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# outputs also stay elementwise allclose at this rtol = atol (JAX's gate)
ALLCLOSE_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# gradients: a row's error over at least GRAD_FLOOR of the tensor's
# largest entry, within GRAD_ROW_TOL (both bf16 backwards round dS and
# P; flash's dQ against the dense path's: 0.055 on the CPU at S 256, D 64)
GRAD_FLOOR = 0.1
GRAD_ROW_TOL = {torch.bfloat16: 1e-1, torch.float32: 1e-4}
# timed runs of KERNEL_BENCH_ITERS back-to-back calls on the card
REPEATS = 3


def _device() -> torch.device:
    return torch.device(kernel_table.default_backend())


def _on_card() -> bool:
    return kernel_table.default_backend() == "cuda"


def _iters() -> int:
    if os.environ.get("KERNEL_BENCH_ITERS"):
        return max(1, int(os.environ["KERNEL_BENCH_ITERS"]))
    return 10 if _on_card() else 2


def _time_ms(fn: Callable[[], Any]) -> float:
    """Median ms of one ``fn()`` after one warm-up: on the card
    ``_iters()`` back-to-back calls between one pair of CUDA events,
    ``REPEATS`` times; the host clock around single calls on the CPU."""
    fn()
    if not _on_card():
        times = []
        for _ in range(_iters()):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    n, pairs = _iters(), []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) / n for a, b in pairs]))


def _row_err(got: torch.Tensor, want: torch.Tensor,
             floor: float = 0.0) -> float:
    """The largest, over rows (the last axis), of a row's largest
    |got - want| over its largest |want|, or over ``floor`` times the
    tensor's largest |want| where that is more."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs().amax(-1)
    top = want.abs().amax(-1)
    top = top.clamp_min(max(floor * float(top.max()),
                            torch.finfo(torch.float32).tiny))
    return float((err / top).max())


def _numerics(got, want, grads: bool = False) -> Tuple[bool, float]:
    """(ok, error): ``got`` against ``want`` (one tensor, or a tuple of
    them), the largest ``_row_err``, within ``ROW_TOL`` of the
    reference's type, the outputs also within ``ALLCLOSE_TOL``
    elementwise (gradients: over ``GRAD_FLOOR``, within
    ``GRAD_ROW_TOL``)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    if any(g.shape != w.shape for g, w in zip(got, want)):
        return False, float("inf")
    floor, tol = (GRAD_FLOOR, GRAD_ROW_TOL) if grads else (0.0, ROW_TOL)
    err = max(_row_err(g, w, floor) for g, w in zip(got, want))
    ok = err <= min(tol[w.dtype] for w in want)
    if not grads:
        ok = ok and all(torch.allclose(
            g.detach().float(), w.detach().float(),
            rtol=ALLCLOSE_TOL[w.dtype], atol=ALLCLOSE_TOL[w.dtype])
            for g, w in zip(got, want))
    return ok, err


def _randn(rng: np.random.Generator, shape, dtype) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(_device(), dtype)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _launched(counts: Dict[str, int], before: Dict[str, int],
              names) -> Dict[str, int]:
    return {n: counts[n] - before[n] for n in names}


def _template(variants: Dict[str, int], before: Dict[str, int],
              prefix: str) -> Optional[str]:
    """The variants of ``prefix`` that launched since ``before``, joined
    (None on the CPU, where nothing launches)."""
    ran = sorted(k.split("/", 1)[1] for k in variants
                 if k.startswith(prefix + "/") and variants[k] > before[k])
    return "+".join(ran) or None


def _row(kernel, bucket, kernel_ms, xla_ms, blocks, numerics,
         library_ms, launches, shape) -> Dict[str, Any]:
    """One bench row; ``numerics`` is ``{"out": (ok, err)}`` and, for the
    arms with a backward, ``"grads": (ok, err)``."""
    kernel_ms, xla_ms = round(kernel_ms, 4), round(xla_ms, 4)
    return {"kernel": kernel, "bucket": bucket,
            "kernel_ms": kernel_ms, "xla_ms": xla_ms,
            # from the rounded times, as ``kernel_table.record`` computes it
            "ratio": round(xla_ms / max(kernel_ms, 1e-9), 4),
            "blocks": blocks,
            "numerics_ok": all(ok for ok, _ in numerics.values()),
            "row_rel_err": {k: round(e, 6) for k, (_, e) in
                            numerics.items()},
            "library_ms": (None if library_ms is None
                           else round(library_ms, 4)),
            "launches": launches, "shape": shape}


def _launch_ok(row: Dict[str, Any]) -> bool:
    """On the card every kernel of the arm launched; on the CPU the
    plain versions run and nothing is counted."""
    return not _on_card() or (bool(row["launches"])
                              and min(row["launches"].values()) > 0)


# ---------------------------------------------------------------------------
# arms: each returns one win/loss row
# ---------------------------------------------------------------------------


def bench_flash(seq: int, head_dim: int, heads: int = 4,
                kv_heads: Optional[int] = None, batch: int = 1,
                causal: bool = True, dtype: str = "bfloat16"
                ) -> Dict[str, Any]:
    """Flash attention vs ``xla_attention``, forward plus backward."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.attention import xla_attention

    kv_heads = kv_heads or heads
    rng = np.random.default_rng(0)
    dt = _dtype(dtype)
    q = _randn(rng, (batch, seq, heads, head_dim), dt).requires_grad_()
    k = _randn(rng, (batch, seq, kv_heads, head_dim), dt).requires_grad_()
    v = _randn(rng, (batch, seq, kv_heads, head_dim), dt).requires_grad_()

    def fwd_bwd(attn):
        def run():
            out = attn()
            return out, torch.autograd.grad(out.float().sum(), (q, k, v))
        return run

    xla_run = fwd_bwd(lambda: xla_attention(q, k, v, causal=causal))
    flash_run = fwd_bwd(lambda: fa.flash_attention(q, k, v, causal=causal))
    xla_ms = _time_ms(xla_run)
    before = dict(fa.LAUNCHES), dict(fa.VARIANT_LAUNCHES)
    kernel_ms = _time_ms(flash_run)
    launches = ({} if not _on_card() else
                _launched(fa.LAUNCHES, before[0], fa.LAUNCHES))
    template = _template(fa.VARIANT_LAUNCHES, before[1], "flash_fwd")
    (out, grads), (want, want_grads) = flash_run(), xla_run()
    numerics = {"out": _numerics(out, want),
                "grads": _numerics(grads, want_grads, grads=True)}
    del out, grads, want, want_grads
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))

    def sdpa():
        out = F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=kv_heads != heads)
        torch.autograd.grad(out.float().sum(), (qt, kt, vt))

    library_ms = _time_ms(sdpa)
    return _row("flash_attention",
                kernel_table.attention_bucket(seq, head_dim, causal),
                kernel_ms, xla_ms, {"template": template or "plain"},
                numerics, library_ms, launches,
                {"B": batch, "S": seq, "Hq": heads, "Hkv": kv_heads,
                 "D": head_dim, "causal": causal, "dtype": dtype})


def _paged_xla_reference(q, kv_layer, block_table, context_lens):
    """Gather-path fallback (JAX's): each sequence's pages pulled dense,
    masked, fp32 softmax, the output cast back."""
    S, nh, hd = q.shape
    _, bs, _, nkv, _ = kv_layer.shape
    Bm = block_table.shape[1]
    kvs = kv_layer[block_table.long()].reshape(S, Bm * bs, 2, nkv, hd)
    keys = kvs[:, :, 0].repeat_interleave(nh // nkv, dim=2)
    values = kvs[:, :, 1].repeat_interleave(nh // nkv, dim=2)
    s = torch.einsum("snd,smnd->snm", q.float(), keys.float()) / math.sqrt(hd)
    pos = torch.arange(Bm * bs, device=q.device)[None, None, :]
    s = s.masked_fill(pos >= context_lens.long()[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("snm,smnd->snd", p, values.float()).to(q.dtype)
    return torch.where((context_lens > 0)[:, None, None], out,
                       torch.zeros_like(out))


def bench_paged(S: int, heads: int, kv_heads: int, head_dim: int,
                block_size: int, max_pages: int, dtype: str = "float32"
                ) -> Dict[str, Any]:
    """Paged decode attention vs the gather-path fallback, forward only
    (decode is inference). Every sequence holds ``max_pages`` full pages
    of a shuffled pool."""
    from deepspeed_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(1)
    dt = _dtype(dtype)
    nb = S * max_pages + 2
    kv = _randn(rng, (nb, block_size, 2, kv_heads, head_dim), dt)
    table = torch.from_numpy(rng.permutation(nb - 1)[:S * max_pages].reshape(
        S, max_pages).astype(np.int32)).to(_device())
    ctx = torch.full((S,), max_pages * block_size, dtype=torch.int32,
                     device=_device())
    q = _randn(rng, (S, heads, head_dim), dt)
    with torch.no_grad():
        xla_ms = _time_ms(lambda: _paged_xla_reference(q, kv, table, ctx))
        before = dict(pa.LAUNCHES), dict(pa.VARIANT_LAUNCHES)
        kernel_ms = _time_ms(lambda: pa.paged_decode_attention(
            q, kv, table, ctx))
        launches = ({} if not _on_card() else
                    _launched(pa.LAUNCHES, before[0], ("paged_decode",)))
        template = _template(pa.VARIANT_LAUNCHES, before[1], "paged_decode")
        numerics = {"out": _numerics(
            pa.paged_decode_attention(q, kv, table, ctx),
            _paged_xla_reference(q, kv, table, ctx))}
        # the library call: SDPA on the K/V gathered dense beforehand
        L = max_pages * block_size
        g = kv[table.long()].reshape(S, L, 2, kv_heads, head_dim)
        kt = g[:, :, 0].permute(0, 2, 1, 3).repeat_interleave(
            heads // kv_heads, dim=1).contiguous()
        vt = g[:, :, 1].permute(0, 2, 1, 3).repeat_interleave(
            heads // kv_heads, dim=1).contiguous()
        mask = (torch.arange(L, device=_device())[None, :]
                < ctx[:, None])[:, None, None, :]
        qt = q[:, :, None, :]
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
    return _row("paged_attention",
                kernel_table.attention_bucket(max_pages * block_size,
                                              head_dim, True),
                kernel_ms, xla_ms, {"template": template or "plain"},
                numerics, library_ms, launches,
                {"S": S, "Hq": heads, "Hkv": kv_heads, "D": head_dim,
                 "block_size": block_size, "pages": max_pages,
                 "dtype": dtype})


def _group_sizes(M: int, groups: int, sizes: Optional[List[int]]
                 ) -> List[int]:
    if sizes is not None:
        return list(sizes)
    out = [M // groups] * groups
    out[-1] += M - sum(out)
    return out


def _per_group(lhs, rhs, sizes):
    """The dense per-group product: one matmul a group's rows (fp32
    accumulation, the result in lhs's type)."""
    outs, r0 = [], 0
    for e, n in enumerate(sizes):
        outs.append(torch.matmul(lhs[r0:r0 + n], rhs[e]))
        r0 += n
    return torch.cat(outs, dim=0)


def _grouped_mm_ms(lhs, rhs, gs) -> Optional[float]:
    """``torch._grouped_mm`` forward plus backward on the same operands
    (rhs row- or column-major, whichever this torch takes), or None on
    the CPU or where this torch has no such call for them."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or not _on_card() or lhs.dtype != torch.bfloat16:
        return None
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    a = lhs.detach().requires_grad_()
    col_major = rhs.detach().transpose(-2, -1).contiguous().transpose(-2, -1)
    for b in (rhs.detach().requires_grad_(), col_major.requires_grad_()):
        def run(b=b):
            torch.autograd.grad(fn(a, b, offs=offs).float().sum(), (a, b))
        try:  # a capability probe of the yardstick, not a path
            run()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return _time_ms(run)
    return None


def bench_gmm(M: int, K: int, N: int, groups: int,
              sizes: Optional[List[int]] = None, dtype: str = "bfloat16"
              ) -> Dict[str, Any]:
    """Grouped matmul vs the dense per-group product, forward plus
    backward (gmm; gmm^T for dlhs and tgmm for drhs)."""
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    rng = np.random.default_rng(2)
    dt = _dtype(dtype)
    sizes = _group_sizes(M, groups, sizes)
    M = sum(sizes)
    lhs = _randn(rng, (M, K), dt).requires_grad_()
    rhs = _randn(rng, (groups, K, N), dt).requires_grad_()
    gs = torch.tensor(sizes, dtype=torch.int32, device=_device())

    def fwd_bwd(mm):
        def run():
            out = mm()
            return out, torch.autograd.grad(out.float().sum(), (lhs, rhs))
        return run

    xla_run = fwd_bwd(lambda: _per_group(lhs, rhs, sizes))
    gmm_run = fwd_bwd(lambda: gm.gmm(lhs, rhs, gs))
    xla_ms = _time_ms(xla_run)
    before = dict(gm.LAUNCHES), dict(gm.VARIANT_LAUNCHES)
    kernel_ms = _time_ms(gmm_run)
    launches = ({} if not _on_card() else
                _launched(gm.LAUNCHES, before[0], gm.LAUNCHES))
    template = _template(gm.VARIANT_LAUNCHES, before[1], "gmm")
    (out, grads), (want, want_grads) = gmm_run(), xla_run()
    numerics = {"out": _numerics(out, want),
                "grads": _numerics(grads, want_grads, grads=True)}
    del out, grads, want, want_grads
    library_ms = _grouped_mm_ms(lhs, rhs, gs)
    return _row("grouped_matmul", kernel_table.gmm_bucket(M, K, N, groups),
                kernel_ms, xla_ms, {"template": template or "plain"},
                numerics, library_ms, launches,
                {"M": M, "K": K, "N": N, "groups": groups, "sizes": sizes,
                 "dtype": dtype})


def bench_blocksparse(seq: int, head_dim: int, heads: int = 4,
                      kv_heads: Optional[int] = None, batch: int = 1,
                      block: int = 128, num_local_blocks: int = 2,
                      dtype: str = "bfloat16") -> Dict[str, Any]:
    """The block-sparse forward vs the masked form on the same layout
    (KV heads repeated for it), forward only and outside autograd."""
    from deepspeed_tpu_torch.ops import blocksparse_attention as bsa
    from deepspeed_tpu_torch.ops.attention import repeat_kv_heads

    kv_heads = kv_heads or heads
    sparsity = bsa.FixedSparsityConfig(block=block,
                                       num_local_blocks=num_local_blocks)
    rng = np.random.default_rng(3)
    dt = _dtype(dtype)
    q = _randn(rng, (batch, seq, heads, head_dim), dt)
    k = _randn(rng, (batch, seq, kv_heads, head_dim), dt)
    v = _randn(rng, (batch, seq, kv_heads, head_dim), dt)
    with torch.no_grad():
        kr, vr = repeat_kv_heads(q, k, v)

        def masked():
            return bsa.blocksparse_attention(q, kr, vr, sparsity,
                                             causal=True)

        def kernel():
            return bsa.blocksparse_attention_kernel(q, k, v, sparsity,
                                                    causal=True)

        xla_ms = _time_ms(masked)
        before = dict(bsa.LAUNCHES), dict(bsa.VARIANT_LAUNCHES)
        kernel_ms = _time_ms(kernel)
        launches = ({} if not _on_card() else
                    _launched(bsa.LAUNCHES, before[0], bsa.LAUNCHES))
        template = _template(bsa.VARIANT_LAUNCHES, before[1],
                             "blocksparse_fwd")
        numerics = {"out": _numerics(kernel(), masked())}
        mask = bsa._element_mask(sparsity, seq, True, q.device)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kr, vr))
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        del qt, kt, vt, kr, vr
    return _row("blocksparse_attention",
                kernel_table.attention_bucket(seq, head_dim, True),
                kernel_ms, xla_ms, {"template": template or "plain",
                                    "block": block},
                numerics, library_ms, launches,
                {"B": batch, "S": seq, "Hq": heads, "Hkv": kv_heads,
                 "D": head_dim, "mode": "fixed", "block": block,
                 "num_local_blocks": num_local_blocks, "dtype": dtype})


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


# the card tier: PERF.md's kernel-table shapes (Llama-3-8B attention, 32/8
# heads of 128; Mixtral-8x7B experts, 4096 imbalanced rows; the 2048 x 16
# bf16 pool; the fixed layout at S 8192), and the flash buckets S 256 to
# 4096 that impl="auto" meets on the main paths
_TRAIN_WI_SIZES = [704, 0, 1000, 296, 64, 1496, 504, 32]
CARD_FLASH_SEQS = (256, 512, 1024, 2048, 4096)


def _shapes(full: bool) -> Dict[str, List[Dict[str, Any]]]:
    """Bench shapes by arm: the card tier (``full``) at the main paths'
    widths, the CPU tier at sizes the plain versions run in seconds
    (head dim 64: the flash kernels are built for 64 and 128)."""
    if full:
        return {
            "flash": [{"seq": s, "head_dim": 128, "heads": 32, "kv_heads": 8,
                       "batch": 2} for s in CARD_FLASH_SEQS],
            "paged": [{"S": 16, "heads": 32, "kv_heads": 8, "head_dim": 128,
                       "block_size": 16, "max_pages": 48,
                       "dtype": "bfloat16"}],
            "gmm": [{"M": 4096, "K": 4096, "N": 14336, "groups": 8,
                     "sizes": _TRAIN_WI_SIZES}],
            "blocksparse": [{"seq": 8192, "head_dim": 128, "heads": 32,
                             "kv_heads": 8, "num_local_blocks": 4}],
        }
    return {
        "flash": [{"seq": 256, "head_dim": 64, "heads": 4, "kv_heads": 2,
                   "batch": 1}],
        "paged": [{"S": 2, "heads": 8, "kv_heads": 2, "head_dim": 64,
                   "block_size": 16, "max_pages": 4}],
        "gmm": [{"M": 256, "K": 128, "N": 256, "groups": 4}],
        "blocksparse": [{"seq": 256, "head_dim": 64, "heads": 4,
                         "kv_heads": 2, "block": 64}],
    }


_ARMS = {"flash": bench_flash, "paged": bench_paged, "gmm": bench_gmm,
         "blocksparse": bench_blocksparse}


def _record_path() -> str:
    """Where measured rows land: ``KERNEL_BENCH_RECORD_PATH``, else a
    table in a fresh temporary directory (no run rewrites a table that
    dispatch reads unless told to)."""
    if os.environ.get("KERNEL_BENCH_RECORD_PATH"):
        return os.environ["KERNEL_BENCH_RECORD_PATH"]
    return os.path.join(tempfile.mkdtemp(prefix="dstpu_kernel_bench_"),
                        "kernel_table.json")


def _probe_qkv(seq: int, hd: int):
    """The dispatch probe's inputs: the card tier's heads (32/8) in bf16
    on the card, 4/2 on the CPU."""
    rng = np.random.default_rng(7)
    heads, kv = (32, 8) if _on_card() else (4, 2)
    return (_randn(rng, (1, seq, heads, hd), torch.bfloat16),
            _randn(rng, (1, seq, kv, hd), torch.bfloat16),
            _randn(rng, (1, seq, kv, hd), torch.bfloat16))


def _dispatch_probe(rows: List[Dict[str, Any]], path: str
                    ) -> List[Dict[str, Any]]:
    """The freshly recorded table must steer ``multi_head_attention``: a
    losing flash bucket gives the ``xla_attention`` result bit for bit, a
    winning one dispatches to the kernel (on the card: a flash launch)."""
    from deepspeed_tpu_torch.ops import attention as attn_ops
    from deepspeed_tpu_torch.ops import flash_attention as fa

    violations = []
    flash_rows = [r for r in rows if r["kernel"] == "flash_attention"]
    if not flash_rows:
        return violations
    old_env = os.environ.get("DSTPU_KERNEL_TABLE")
    old_cfg = attn_ops._KERNEL_CONFIG
    os.environ["DSTPU_KERNEL_TABLE"] = path
    attn_ops.set_kernel_config(None)  # the table at ``path``, not a config's
    kernel_table.invalidate_cache()
    try:
        for row in flash_rows:
            # the benched bucket's shape, from its label
            seq = int(row["bucket"].split("_")[0][1:])
            hd = int(row["bucket"].split("_")[1][1:])
            q, k, v = _probe_qkv(seq, hd)
            before = attn_ops.dispatch_stats()
            launched = fa.LAUNCHES["flash_fwd"]
            with torch.no_grad():
                out = attn_ops.multi_head_attention(q, k, v, causal=True)
            after = attn_ops.dispatch_stats()
            took_kernel = after["kernel"] > before["kernel"]
            if _on_card():
                took_kernel = took_kernel and \
                    fa.LAUNCHES["flash_fwd"] > launched
            won = row["ratio"] >= 1.0
            if won and not took_kernel:
                violations.append(
                    {"gate": "dispatch_consults_table", "row": row,
                     "detail": f"winning bucket {row['bucket']} did not "
                               f"dispatch to the kernel"})
            if not won:
                with torch.no_grad():
                    want = attn_ops.xla_attention(q, k, v, causal=True)
                if took_kernel or not torch.equal(out, want):
                    violations.append(
                        {"gate": "losing_bucket_bit_identical", "row": row,
                         "detail": f"losing bucket {row['bucket']} must "
                                   f"route to xla_attention bit-identically"})
    finally:
        if old_env is None:
            os.environ.pop("DSTPU_KERNEL_TABLE", None)
        else:
            os.environ["DSTPU_KERNEL_TABLE"] = old_env
        attn_ops.set_kernel_config(old_cfg)
        kernel_table.invalidate_cache()
    return violations


def run_kernel_bench() -> Tuple[str, Dict[str, Any], bool]:
    """Run the selected arms, record rows, gate, and report.

    Returns (markdown table, JSON payload, ok)."""
    from deepspeed_tpu_torch.ops import attention as attn_ops

    full = bool(int(os.environ.get("KERNEL_BENCH_FULL",
                                   "1" if _on_card() else "0")))
    names = [n.strip() for n in os.environ.get(
        "KERNEL_BENCH_KERNELS", "flash,paged,gmm,blocksparse").split(",")
        if n.strip()]
    shapes = _shapes(full)
    rows, errors = [], []
    for name in names:
        if name not in _ARMS:
            errors.append({"gate": "unknown_kernel", "detail": name})
            continue
        for kw in shapes[name]:
            rows.append(_ARMS[name](**kw))
            if _on_card():
                torch.cuda.empty_cache()

    path = _record_path()
    for row in rows:
        kernel_table.record(row["kernel"], row["bucket"], row["kernel_ms"],
                            row["xla_ms"], blocks=row["blocks"], path=path)

    violations = list(errors)
    violations += [{"gate": "numerics", "row": r,
                    "detail": f"{r['kernel']} diverged from its fallback on "
                              f"{r['bucket']}: row errors "
                              f"{r['row_rel_err']}"}
                   for r in rows if not r["numerics_ok"]]
    violations += [{"gate": "kernel_launched", "row": r,
                    "detail": f"{r['kernel']} on {r['bucket']}: a kernel "
                              f"of the arm did not launch: {r['launches']}"}
                   for r in rows if not _launch_ok(r)]
    violations += _dispatch_probe(rows, path)

    winning = sorted(f"{r['kernel']}:{r['bucket']}"
                     for r in rows if r["ratio"] >= 1.0)
    ratios = [r["ratio"] for r in rows]
    geomean = float(np.exp(np.mean(np.log(ratios)))) if ratios else 0.0
    backend = kernel_table.default_backend()
    payload = {
        "schema": SCHEMA,
        "metric": "kernel_win_ratio_geomean",
        "value": round(geomean, 4),
        "unit": "x",
        "backend": backend,
        "device": (kernel_table.card_name() if backend == "cuda"
                   else "cpu"),
        "full": full,
        "table_path": path,
        "entries": rows,
        "winning_kernels": winning,
        "flash_fallback_ratio": round(attn_ops.flash_fallback_ratio(), 4),
        "violations": violations,
        "ok": not violations,
    }
    lines = ["### kernel win/loss: hand-written kernel vs its fallback "
             f"({payload['device']}, {'full' if full else 'smoke'} tier)",
             "",
             "| kernel | bucket | kernel ms | fallback ms | ratio | "
             "library ms | template | verdict |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        verdict = "WIN" if r["ratio"] >= 1.0 else "loss"
        if not r["numerics_ok"]:
            verdict = "NUMERICS-FAIL"
        blocks = ",".join(f"{k}={v}" for k, v in r["blocks"].items())
        lines.append(f"| {r['kernel']} | {r['bucket']} | "
                     f"{r['kernel_ms']} | {r['xla_ms']} | {r['ratio']} | "
                     f"{r['library_ms']} | {blocks} | {verdict} |")
    lines += ["", f"table -> {path}",
              f"flash_fallback_ratio={payload['flash_fallback_ratio']}"]
    if violations:
        lines += ["", f"{len(violations)} gate violation(s): exit nonzero"]
    return "\n".join(lines), payload, not violations


def main() -> int:
    table, payload, ok = run_kernel_bench()
    print(table)
    print(json.dumps(payload))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
