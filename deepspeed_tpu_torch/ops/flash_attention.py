"""Flash attention forward and backward (GQA-native, segment ids).

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py``: same public
function, signature and ``[B, S, H, D]`` layout. ``_flash_fwd`` and
``_flash_bwd`` launch the hand-written Hopper kernels
(``csrc/flash_attention.cu``) on CUDA tensors, or raise; on CPU tensors
they run the plain PyTorch versions beside them, which fold key tiles in
the kernels' order. ``_FlashAttention`` (a ``torch.autograd.Function``)
stands for the JAX custom VJP ``_flash`` (``:488-513``): it saves q, k,
v, o and the per-row logsumexp, and its backward recomputes the
probabilities from them. Its forward goes through PyTorch's dispatcher as
the operator ``dstpu::flash_fwd`` (:data:`FLASH_FWD_OP`, which returns
fresh ``o`` and ``lse``), so that a dispatch mode, such as an
activation-checkpointing policy's, sees the kernel as one op and can keep
its outputs or run it again.

What the TPU wrapper does for its tiling and this port does not: pad S
to a block multiple (with -2/-1 segment ids), swap ``[B, S, H, D]`` to
``[B*H, S, D]``, walk a packed lower triangle, and broadcast the row
statistics over ``STAT_LANES``. The kernels read the public layout by
strides and mask rows and columns past S themselves; lse is ``[B, Hq,
S]`` fp32.

The forward, dK/dV and dQ each have two kernels, chosen by
``flash_variant`` from type, head dim, strides and alignment alone: the
tensor-core kernel (``wgmma`` fed by TMA) for bf16 with head dim 128,
16-byte aligned data and (batch, seq, head) strides that are positive
multiples of 8 (q, k and v; the backward's dO too), and the scalar
kernel (``simt``) for the rest (fp32, head dim 64, other strides).

``LAUNCHES`` counts kernel launches per kernel (the plain versions never
count), so a run can show that its main path went through the kernels;
``VARIANT_LAUNCHES`` splits each kernel's launches by variant.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30
TILE = 64            # query rows and key columns per kernel tile
HEAD_DIMS = (64, 128)  # the head dims the kernels are built for

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                            "flash_bwd_dq": 0}
VARIANT_LAUNCHES: Dict[str, int] = {
    f"{name}/{variant}": 0
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
    for variant in ("wgmma", "simt")}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def flash_variant(device_type: str, dtype: torch.dtype, head_dim: int,
                  strides: Sequence[int], data_ptrs: Sequence[int]) -> str:
    """Which kernel runs: "plain" on the CPU; on the card "wgmma" (the
    tensor-core kernel) for bf16 with head dim 128, every (batch, seq,
    head) stride a positive multiple of 8 elements (TMA's 16-byte
    strides) and every data pointer 16-byte aligned, else "simt" (the
    scalar kernel). The forward passes the strides and pointers of q, k
    and v, the backward those of q, k, v and dO."""
    if device_type == "cpu":
        return "plain"
    if (dtype == torch.bfloat16 and head_dim == 128
            and all(s > 0 and s % 8 == 0 for s in strides)
            and all(p % 16 == 0 for p in data_ptrs)):
        return "wgmma"
    return "simt"


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, S, H, D] -> fp32 [B, Hkv, H/Hkv, S, D] (q head h = kv head
    h // group, member h % group: the JAX ``_kv_row`` map)."""
    B, S, H, D = x.shape
    return x.float().reshape(B, S, hkv, H // hkv, D).permute(0, 2, 3, 1, 4)


def _ungrouped(x: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, g, S, D] -> [B, S, Hkv * g, D]."""
    B, hkv, g, S, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, hkv * g, D)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 x rounded to the input type and back (the kernels' cast of p
    and ds before a matmul)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _visible(rows, cols, S: int, causal: bool,
             seg: Optional[torch.Tensor]) -> torch.Tensor:
    """[B or 1, 1, 1, len(rows), len(cols)] mask of key columns each
    query row may attend."""
    vis = (rows[:, None] < S) & (cols[None, :] < S)
    if causal:
        vis = vis & (cols[None, :] <= rows[:, None])
    vis = vis[None, None, None]
    if seg is not None:
        same = seg[:, rows][:, :, None] == seg[:, cols][:, None, :]
        vis = vis & same[:, None, None]
    return vis


def flash_fwd_plain(q, k, v, segment_ids, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise online softmax over 64-column key tiles, as the forward
    kernel folds them. Returns (o [B, S, Hq, D] in q.dtype, lse
    [B, Hq, S] fp32)."""
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    qf, kf, vf = _grouped(q, hkv), _grouped(k, hkv), _grouped(v, hkv)
    rows = torch.arange(S, device=q.device)
    shape = (B, hkv, hq // hkv, S, 1)
    m = torch.full(shape, NEG_INF, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(qf.shape, device=q.device)
    for c0 in range(0, S, TILE):
        cols = rows[c0:c0 + TILE]
        s = torch.matmul(qf, kf[..., c0:c0 + TILE, :].transpose(-1, -2))
        vis = _visible(rows, cols, S, causal, segment_ids)
        s = torch.where(vis, s * scale, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new), torch.zeros_like(s))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(_rounded(p, q.dtype),
                                         vf[..., c0:c0 + TILE, :])
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = _ungrouped(acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe)).reshape(B, hq, S)
    return o, lse


def _bwd_tiles(q, k, v, segment_ids, lse, delta, do, causal: bool,
               scale: float):
    """For each 64-column key tile: (c0, qf, dof, kt, p, ds) with p =
    exp(s - lse) recomputed from the saved lse and ds = p (dO.V - delta),
    both rounded to the input type as the kernels round them. Tensors are
    grouped fp32 [B, Hkv, g, S or TILE, ...]."""
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf, kf, vf = _grouped(q, hkv), _grouped(k, hkv), _grouped(v, hkv)
    dof = _grouped(do, hkv)
    lse = lse.reshape(B, hkv, g, S, 1)
    delta = delta.reshape(B, hkv, g, S, 1)
    rows = torch.arange(S, device=q.device)
    for c0 in range(0, S, TILE):
        kt, vt = kf[..., c0:c0 + TILE, :], vf[..., c0:c0 + TILE, :]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        vis = _visible(rows, rows[c0:c0 + TILE], S, causal, segment_ids)
        p = torch.where(vis, torch.exp(s - lse), torch.zeros_like(s))
        ds = p * (torch.matmul(dof, vt.transpose(-1, -2)) - delta)
        yield (c0, qf, dof, kt, _rounded(p, q.dtype),
               _rounded(ds, q.dtype))


def flash_bwd_dkdv_plain(q, k, v, segment_ids, lse, delta, do, causal: bool,
                         scale: float):
    """dK and dV: per key tile, summed over the kv head's q-head group
    and every q row. lse and delta are [B, Hq, S] fp32."""
    B, S, hkv, D = k.shape
    dk = torch.zeros((B, hkv, 1, S, D), device=q.device)
    dv = torch.zeros((B, hkv, 1, S, D), device=q.device)
    for c0, qf, dof, _, p, ds in _bwd_tiles(q, k, v, segment_ids, lse, delta,
                                            do, causal, scale):
        dv[..., c0:c0 + TILE, :] = torch.matmul(
            p.transpose(-1, -2), dof).sum(dim=2, keepdim=True)
        dk[..., c0:c0 + TILE, :] = torch.matmul(
            ds.transpose(-1, -2), qf).sum(dim=2, keepdim=True)
    return _ungrouped(dk * scale).to(k.dtype), _ungrouped(dv).to(v.dtype)


def flash_bwd_dq_plain(q, k, v, segment_ids, lse, delta, do, causal: bool,
                       scale: float):
    """dQ: the key tiles' ds K summed in tile order, times scale."""
    dq = None
    for _, _, _, kt, _, ds in _bwd_tiles(q, k, v, segment_ids, lse, delta,
                                         do, causal, scale):
        part = torch.matmul(ds, kt)
        dq = part if dq is None else dq + part
    return _ungrouped(dq * scale).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from deepspeed_tpu_torch.ops import build

        lib = build.load("flash_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dstpu_flash_fwd.argtypes = [I, I, P, P, P, P, P, P, P,
                                        I, I, I, I, I, F, P]
        lib.dstpu_flash_fwd_wgmma.argtypes = [P, P, P, P, P, P, P,
                                              I, I, I, I, I, F, P]
        lib.dstpu_flash_bwd_dkdv.argtypes = [I, I, P, P, P, P, P, P, P, P, P,
                                             P, I, I, I, I, I, F, P]
        lib.dstpu_flash_bwd_dq.argtypes = [I, I, P, P, P, P, P, P, P, P, P,
                                           I, I, I, I, I, F, P]
        lib.dstpu_flash_bwd_dkdv_wgmma.argtypes = \
            lib.dstpu_flash_bwd_dkdv.argtypes[2:]
        lib.dstpu_flash_bwd_dq_wgmma.argtypes = \
            lib.dstpu_flash_bwd_dq.argtypes[2:]
        for fn in (lib.dstpu_flash_fwd, lib.dstpu_flash_fwd_wgmma,
                   lib.dstpu_flash_bwd_dkdv, lib.dstpu_flash_bwd_dq,
                   lib.dstpu_flash_bwd_dkdv_wgmma,
                   lib.dstpu_flash_bwd_dq_wgmma):
            fn.restype = I
        lib.dstpu_cuda_error_string.argtypes = [I]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().dstpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _use_kernel(q, k, v, segment_ids, *extra) -> bool:
    """Check shapes for both paths; True for CUDA tensors (the kernels),
    False for CPU tensors (the plain versions). Raises on what the
    kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, S, Hq, D] and k, v [B, S, Hkv, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, hq, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"q heads ({hq}) not a multiple of kv heads "
                         f"({k.shape[2]})")
    if segment_ids is not None and tuple(segment_ids.shape) != (B, S):
        raise ValueError(f"segment_ids must be [B, S] = {(B, S)}, got "
                         f"{tuple(segment_ids.shape)}")
    tensors = [t for t in (q, k, v, segment_ids, *extra) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention inputs must share a device")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got head_dim {D}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q, k, v of "
                        f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v, *extra)):
        raise ValueError("flash kernel needs unit stride over head_dim")
    if segment_ids is not None and not (segment_ids.dtype == torch.int32
                                        and segment_ids.is_contiguous()):
        raise TypeError("flash kernel takes contiguous int32 segment_ids")
    return True


def _strides(*ts) -> ctypes.Array:
    """(batch, seq, head) element strides of each [B, S, H, D] tensor, as
    the kernels' int64 array of 12 (unused slots 0)."""
    vals = [s for t in ts for s in t.stride()[:3]]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def _seg_ptr(segment_ids) -> Optional[int]:
    return None if segment_ids is None else segment_ids.data_ptr()


# FLOPs a (query row, key column) pair costs each kernel, per head dim
_PAIR_FLOPS = {"flash_fwd": 4, "flash_bwd_dkdv": 8, "flash_bwd_dq": 6}


def kernel_work(name: str, q: torch.Tensor, k: torch.Tensor,
                causal: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch of kernel ``name`` on q [B, S, Hq,
    D] and k, v [B, S, Hkv, D]: the pairs of the TILE x TILE tiles it
    computes (causal: the key tiles up to the diagonal, the diagonal
    tile whole) at 4·D FLOPs a pair forward (QKᵀ, PV), 8·D for dK/dV
    (QKᵀ, PᵀdO, dO Vᵀ, dSᵀQ) and 6·D for dQ (QKᵀ, dO Vᵀ, dS K); each
    input read once, each output written once (segment ids left out).
    The work counter of ``observability/attribution.py`` reads it."""
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    n = -(-S // TILE)
    rows = [min(TILE, S - i * TILE) for i in range(n)]
    pairs = sum(rows[i] * (sum(rows[:i + 1]) if causal else S)
                for i in range(n))
    flops = float(_PAIR_FLOPS[name] * D * B * hq * pairs)
    it = q.element_size()
    qo = B * S * hq * D * it     # q, o, dO, dq: one q-shaped tensor
    kv = B * S * hkv * D * it    # k, v, dk, dv: one kv-shaped tensor
    stat = B * hq * S * 4        # lse, delta
    nbytes = {"flash_fwd": 2 * qo + 2 * kv + stat,
              "flash_bwd_dkdv": 2 * qo + 4 * kv + 2 * stat,
              "flash_bwd_dq": 3 * qo + 2 * kv + 2 * stat}[name]
    return flops, float(nbytes)


def _meta_launch(name: str, q, k, causal: bool) -> None:
    """A meta pass (attribution's counter): the kernel's work, reported
    in place of a launch."""
    from deepspeed_tpu_torch.observability.attribution import report_kernel

    report_kernel(name, *kernel_work(name, q, k, causal))


def _fwd_outputs_like(q):
    """Empty (o, lse) for q: [B, S, Hq, D] in q.dtype, [B, Hq, S] fp32."""
    return (torch.empty_like(q), q.new_empty(
        (q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32))


def _flash_fwd(q, k, v, segment_ids, causal: bool, scale: float):
    """Returns (o [B, S, Hq, D] in q.dtype, lse [B, Hq, S] fp32)."""
    if q.device.type == "meta":
        _meta_launch("flash_fwd", q, k, causal)
        return _fwd_outputs_like(q)
    if not _use_kernel(q, k, v, segment_ids):
        return flash_fwd_plain(q, k, v, segment_ids, causal, scale)
    return _flash_fwd_launch(q, k, v, segment_ids, causal, scale,
                             _variant(q, k, v))


def _variant(*ts) -> str:
    """``flash_variant`` of q, k, v (and dO): their strides and
    pointers."""
    q = ts[0]
    return flash_variant(q.device.type, q.dtype, q.shape[-1],
                         [s for t in ts for s in t.stride()[:3]],
                         [t.data_ptr() for t in ts])


def _flash_fwd_launch(q, k, v, segment_ids, causal: bool, scale: float,
                      variant: str):
    """``_flash_fwd``'s launch of one kernel, "wgmma" or "simt", on CUDA
    tensors that ``_use_kernel`` has checked (the smoke also times the
    scalar kernel at shapes that take the tensor-core one)."""
    B, S, hq, D = q.shape
    if variant == "wgmma" and _variant(q, k, v) != "wgmma":
        raise ValueError("the tensor-core flash forward takes bf16 q, k, v "
                         "of head dim 128 with 16-byte aligned data and "
                         "strides")
    o = torch.empty((B, S, hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, hq, S), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids),
            o.data_ptr(), lse.data_ptr(), _strides(q, k, v), B, S, hq,
            k.shape[2], int(causal), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if variant == "wgmma":
        rc = _lib().dstpu_flash_fwd_wgmma(*args)
    elif variant == "simt":
        rc = _lib().dstpu_flash_fwd(_DTYPE_CODE[q.dtype], D, *args)
    else:
        raise ValueError(f"unknown flash forward variant {variant!r}")
    _raise_on(rc, f"flash_fwd ({variant})")
    LAUNCHES["flash_fwd"] += 1
    VARIANT_LAUNCHES[f"flash_fwd/{variant}"] += 1
    return o, lse


def _bwd_use_kernel(q, k, v, segment_ids, lse, delta, do) -> bool:
    if not _use_kernel(q, k, v, segment_ids, do):
        return False
    B, S, hq, _ = q.shape
    if do.dtype != q.dtype or do.shape != q.shape:
        raise TypeError(f"dO must match q: {do.dtype} {tuple(do.shape)} vs "
                        f"{q.dtype} {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, hq, S) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous fp32 [B, Hq, S] "
                             f"on q's device, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return True


def flash_bwd_dkdv(q, k, v, segment_ids, lse, delta, do, causal: bool,
                   scale: float):
    """dK, dV through a dK/dV kernel (CPU tensors: the plain version).
    lse and delta are [B, Hq, S] fp32."""
    if q.device.type == "meta":
        _meta_launch("flash_bwd_dkdv", q, k, causal)
        return torch.empty_like(k), torch.empty_like(v)
    if not _bwd_use_kernel(q, k, v, segment_ids, lse, delta, do):
        return flash_bwd_dkdv_plain(q, k, v, segment_ids, lse, delta, do,
                                    causal, scale)
    return _flash_bwd_launch("flash_bwd_dkdv", q, k, v, segment_ids, lse,
                             delta, do, causal, scale, _variant(q, k, v, do))


def flash_bwd_dq(q, k, v, segment_ids, lse, delta, do, causal: bool,
                 scale: float):
    """dQ through a dQ kernel (CPU tensors: the plain version)."""
    if q.device.type == "meta":
        _meta_launch("flash_bwd_dq", q, k, causal)
        return torch.empty_like(q)
    if not _bwd_use_kernel(q, k, v, segment_ids, lse, delta, do):
        return flash_bwd_dq_plain(q, k, v, segment_ids, lse, delta, do,
                                  causal, scale)
    return _flash_bwd_launch("flash_bwd_dq", q, k, v, segment_ids, lse,
                             delta, do, causal, scale, _variant(q, k, v, do))


def _flash_bwd_launch(name: str, q, k, v, segment_ids, lse, delta, do,
                      causal: bool, scale: float, variant: str):
    """The launch of one backward kernel, ``name`` "flash_bwd_dkdv" (returns
    dK, dV) or "flash_bwd_dq" (returns dQ), variant "wgmma" or "simt", on
    CUDA tensors that ``_bwd_use_kernel`` has checked (the smoke also
    times the scalar kernels at shapes that take the tensor-core ones)."""
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    if variant == "wgmma" and _variant(q, k, v, do) != "wgmma":
        raise ValueError("the tensor-core flash backward takes bf16 q, k, v "
                         "and dO of head dim 128 with 16-byte aligned data "
                         "and strides")
    if name == "flash_bwd_dkdv":
        outs = tuple(torch.empty((B, S, hkv, D), dtype=q.dtype,
                                 device=q.device) for _ in range(2))
    elif name == "flash_bwd_dq":
        outs = (torch.empty((B, S, hq, D), dtype=q.dtype, device=q.device),)
    else:
        raise ValueError(f"unknown flash backward kernel {name!r}")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _seg_ptr(segment_ids), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs), _strides(q, k, v, do), B, S, hq,
            hkv, int(causal), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if variant == "wgmma":
        rc = getattr(_lib(), f"dstpu_{name}_wgmma")(*args)
    elif variant == "simt":
        rc = getattr(_lib(), f"dstpu_{name}")(_DTYPE_CODE[q.dtype], D, *args)
    else:
        raise ValueError(f"unknown flash backward variant {variant!r}")
    _raise_on(rc, f"{name} ({variant})")
    LAUNCHES[name] += 1
    VARIANT_LAUNCHES[f"{name}/{variant}"] += 1
    return outs if name == "flash_bwd_dkdv" else outs[0]


def _flash_bwd(q, k, v, segment_ids, o, lse, do, causal: bool,
               scale: float):
    """Returns (dq, dk, dv). delta = rowsum(dO * O) in fp32 is plain
    PyTorch, as the JAX wrapper computes it outside its kernels."""
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    args = (q, k, v, segment_ids, lse.contiguous(), delta, do, causal, scale)
    dk, dv = flash_bwd_dkdv(*args)
    return flash_bwd_dq(*args), dk, dv


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


@torch.library.custom_op("dstpu::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  segment_ids: Optional[torch.Tensor], causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_flash_fwd`` as a dispatcher operator (every device, the meta
    pass included)."""
    return _flash_fwd(q, k, v, segment_ids, causal, scale)


@_flash_fwd_op.register_fake
def _(q, k, v, segment_ids, causal, scale):
    # the meta pass (attribution's counter) reports the kernel's work
    if q.device.type == "meta":
        return _flash_fwd(q, k, v, segment_ids, causal, scale)
    return _fwd_outputs_like(q)


FLASH_FWD_OP = torch.ops.dstpu.flash_fwd.default


class _FlashAttention(torch.autograd.Function):
    """The custom VJP ``_flash``: forward kernel, then both backward
    kernels from the saved q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal):
        scale = 1.0 / math.sqrt(q.shape[-1])
        # through the dispatcher: an activation-checkpointing policy keeps
        # o and lse whole or launches the kernel again in the recompute
        o, lse = FLASH_FWD_OP(q, k, v, segment_ids, causal, scale)
        ctx.save_for_backward(q, k, v, segment_ids, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_ids, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded ones of a sum's grad
            do = do.contiguous()
        dq, dk, dv = _flash_bwd(q, k, v, segment_ids, o, lse, do, ctx.causal,
                                ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Public entry. q: [B, S, Nq, D]; k, v: [B, S, Nkv, D] (GQA-native:
    Nq a multiple of Nkv, no pre-repeat).

    ``segment_ids``: optional [B, S] integer array; attention is masked
    to same-segment pairs (packed sequences). Causal and non-causal both
    run in the kernels, at any S.

    ``block_q`` / ``block_k`` are accepted for parity with the JAX
    signature and not used: the Hopper kernels tile by 64 rows and
    columns, and S needs no padding.
    """
    del block_q, block_k
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, seg, bool(causal))


__all__ = ["flash_attention", "flash_bwd_dkdv", "flash_bwd_dq",
           "flash_fwd_plain", "flash_bwd_dkdv_plain", "flash_bwd_dq_plain",
           "flash_variant", "LAUNCHES", "VARIANT_LAUNCHES",
           "reset_launch_counts", "HEAD_DIMS", "kernel_work"]
