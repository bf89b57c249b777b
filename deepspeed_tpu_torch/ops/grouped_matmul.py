"""Grouped matrix multiply: the dropless-MoE expert FFN.

Port of ``deepspeed_tpu/ops/pallas/grouped_matmul.py``: same public
``gmm(lhs, rhs, group_sizes)``. The rows of ``lhs`` [M, K] are sorted by
group; group e owns rows [start_e, end_e) with end_e = min(sum of
sizes[:e+1], M), and row m is multiplied by ``rhs[group(m)]`` ([E, K,
N]). Rows past the last group's end come back zero. fp32 accumulation,
output in ``lhs.dtype``.

``gmm_raw`` (forward, and the backward's ``dout @ rhs[g]^T`` with
``transpose_rhs``) and ``tgmm`` (``lhs_e^T @ dout_e`` per group, empty
groups zero) launch the hand-written Hopper kernels
(``csrc/grouped_matmul.cu``) on CUDA tensors, or raise; on CPU tensors
they run the plain PyTorch versions beside them (one fp32 ``matmul`` per
group, the analogue of the JAX tests' ``_ref_gmm``). ``gmm_raw`` has two
kernels, chosen by ``gmm_variant`` from type and shape alone: the
tensor-core kernel (``wgmma`` fed by TMA) for bf16 operands with K and N
multiples of 8 and 16-byte aligned data, and the scalar kernel
(``simt``) for the rest (fp32, odd shapes); ``tgmm`` likewise, chosen by
``tgmm_variant``. ``_GroupedMatmul``
(a ``torch.autograd.Function``) stands for the JAX custom VJP (``:282-
317``); ``group_sizes`` gets no gradient.

What the TPU wrapper does for its tiling and this port does not: snap
each block size to a divisor of its dimension (``_pick_block``) and
build the (m-tile, group) work list on the host side of the grid
(``make_group_metadata``). The kernels mask every edge and find their
work items from ``group_sizes`` on the device, so any M, K and N run and
the host never reads the sizes. ``block_m`` / ``block_n`` / ``block_k``
are accepted and not used.

``LAUNCHES`` counts kernel launches per kernel (the plain versions never
count), so a run can show that its main path went through the kernels;
``VARIANT_LAUNCHES`` splits the launches of each by kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

LAUNCHES: Dict[str, int] = {"gmm": 0, "gmm_transposed": 0, "tgmm": 0}
VARIANT_LAUNCHES: Dict[str, int] = {
    "gmm/wgmma": 0, "gmm/simt": 0,
    "gmm_transposed/wgmma": 0, "gmm_transposed/simt": 0,
    "tgmm/wgmma": 0, "tgmm/simt": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def gmm_variant(device_type: str, dtype: torch.dtype, K: int, N: int,
                data_ptrs: Sequence[int]) -> str:
    """Which version of ``gmm_raw`` runs: "plain" on the CPU; on the card
    "wgmma" (the tensor-core kernel) for bf16 with K and N positive
    multiples of 8 (TMA's 16-byte strides) and every data pointer 16-byte
    aligned, else "simt" (the scalar kernel). K is the contraction
    length, N the output width."""
    if device_type == "cpu":
        return "plain"
    if (dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0
            and all(p % 16 == 0 for p in data_ptrs)):
        return "wgmma"
    return "simt"


def tgmm_variant(device_type: str, dtype: torch.dtype, K: int, N: int,
                 data_ptrs: Sequence[int]) -> str:
    """Which version of ``tgmm`` runs: ``gmm_variant``'s rule with K and
    N the output's [K, N], and an empty output (N 0) on the scalar
    kernel, which launches nothing for it."""
    variant = gmm_variant(device_type, dtype, K, N, data_ptrs)
    return "simt" if variant == "wgmma" and N <= 0 else variant


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _group_rows(group_sizes: torch.Tensor, m: int) -> List[range]:
    """Each group's row range, with the cumulative ends clamped to ``m``
    (the JAX metadata's over-sum guard). Reads the sizes on the host."""
    rows, end = [], 0
    for size in group_sizes.tolist():
        start, end = end, min(end + max(int(size), 0), m)
        rows.append(range(start, end))
    return rows


def _gmm_plain(lhs, rhs, group_sizes, transpose_rhs: bool):
    out = torch.zeros((lhs.shape[0], rhs.shape[1] if transpose_rhs
                       else rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    for g, r in enumerate(_group_rows(group_sizes, lhs.shape[0])):
        if len(r):
            w = rhs[g].float()
            out[r.start:r.stop] = torch.matmul(
                lhs[r.start:r.stop].float(), w.t() if transpose_rhs else w)
    return out.to(lhs.dtype)


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor) -> torch.Tensor:
    """out[m] = lhs[m] @ rhs[g(m)]: per-group fp32 matmul, cast to
    lhs.dtype; rows no group owns are zero."""
    return _gmm_plain(lhs, rhs, group_sizes, False)


def gmm_transposed_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """out[m] = lhs[m] @ rhs[g(m)]^T with rhs [E, N, K]."""
    return _gmm_plain(lhs, rhs, group_sizes, True)


def tgmm_plain(lhs: torch.Tensor, dout: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """out[e] = lhs_e^T @ dout_e, [E, K, N] in lhs.dtype; empty groups
    zero."""
    E = group_sizes.shape[0]
    out = torch.zeros((E, lhs.shape[1], dout.shape[1]), dtype=torch.float32,
                      device=lhs.device)
    for g, r in enumerate(_group_rows(group_sizes, lhs.shape[0])):
        if len(r):
            out[g] = torch.matmul(lhs[r.start:r.stop].float().t(),
                                  dout[r.start:r.stop].float())
    return out.to(lhs.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from deepspeed_tpu_torch.ops import build

        lib = build.load("grouped_matmul")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dstpu_gmm.argtypes = [I, I, P, P, P, P, I, I, I, I, P]
        lib.dstpu_gmm_wgmma.argtypes = [I, P, P, P, P, I, I, I, I, P]
        lib.dstpu_tgmm.argtypes = [I, P, P, P, P, I, I, I, I, P]
        lib.dstpu_tgmm_wgmma.argtypes = [P, P, P, P, I, I, I, I, P]
        for fn in (lib.dstpu_gmm, lib.dstpu_gmm_wgmma, lib.dstpu_tgmm,
                   lib.dstpu_tgmm_wgmma):
            fn.restype = I
        lib.dstpu_cuda_error_string.argtypes = [I]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().dstpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _use_kernel(lhs, other, group_sizes) -> bool:
    """True for CUDA tensors (the kernels), False for CPU tensors (the
    plain versions). Raises on what the kernels do not take."""
    if lhs.dim() != 2 or group_sizes.dim() != 1:
        raise ValueError(f"lhs must be [M, K] and group_sizes [E], got "
                         f"{tuple(lhs.shape)}, {tuple(group_sizes.shape)}")
    tensors = (lhs, other, group_sizes)
    if any(t.device != lhs.device for t in tensors):
        raise ValueError("grouped matmul inputs must share a device")
    if lhs.device.type == "cpu":
        return False
    if lhs.device.type != "cuda":
        raise ValueError(f"unsupported device {lhs.device}")
    if lhs.dtype not in _DTYPE_CODE or other.dtype != lhs.dtype:
        raise TypeError(f"grouped matmul kernels take float32 or bfloat16 "
                        f"operands of one type, got {lhs.dtype} and "
                        f"{other.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grouped matmul kernels need contiguous inputs")
    return True


def gmm_raw(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
            transpose_rhs: bool = False) -> torch.Tensor:
    """out [M, N] = lhs[m] @ rhs[g(m)] (rhs [E, K, N]), or with
    ``transpose_rhs`` lhs[m] @ rhs[g(m)]^T (rhs [E, N, K]), through the
    kernel (CPU tensors: the plain version). No autograd."""
    if rhs.dim() != 3 or rhs.shape[0] != group_sizes.shape[0] or \
            rhs.shape[2 if transpose_rhs else 1] != lhs.shape[-1]:
        raise ValueError(f"rhs {tuple(rhs.shape)} does not match lhs "
                         f"{tuple(lhs.shape)} and {group_sizes.shape[0]} "
                         f"groups (transpose_rhs={transpose_rhs})")
    if not _use_kernel(lhs, rhs, group_sizes):
        return _gmm_plain(lhs, rhs, group_sizes, transpose_rhs)
    M, K = lhs.shape
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    return _gmm_launch(lhs, rhs, group_sizes, transpose_rhs, gmm_variant(
        "cuda", lhs.dtype, K, N, (lhs.data_ptr(), rhs.data_ptr())))


def _gmm_launch(lhs: torch.Tensor, rhs: torch.Tensor,
                group_sizes: torch.Tensor, transpose_rhs: bool,
                variant: str) -> torch.Tensor:
    """``gmm_raw``'s launch of one kernel, "wgmma" or "simt", on CUDA
    tensors that ``gmm_raw`` has checked (the smoke also times the
    scalar kernel at shapes that take the tensor-core one)."""
    M, K = lhs.shape
    E = rhs.shape[0]
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    if variant == "wgmma" and gmm_variant(
            "cuda", lhs.dtype, K, N,
            (lhs.data_ptr(), rhs.data_ptr())) != "wgmma":
        raise ValueError("the tensor-core gmm takes bf16 operands with K "
                         "and N multiples of 8 and 16-byte aligned data")
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    name = "gmm_transposed" if transpose_rhs else "gmm"
    args = (lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), M, K, N, E,
            torch.cuda.current_stream(lhs.device).cuda_stream)
    if variant == "wgmma":
        rc = _lib().dstpu_gmm_wgmma(int(transpose_rhs), *args)
    elif variant == "simt":
        rc = _lib().dstpu_gmm(_DTYPE_CODE[lhs.dtype], int(transpose_rhs),
                              *args)
    else:
        raise ValueError(f"unknown gmm variant {variant!r}")
    _raise_on(rc, f"{name} ({variant})")
    LAUNCHES[name] += 1
    VARIANT_LAUNCHES[f"{name}/{variant}"] += 1
    return out


def tgmm(lhs: torch.Tensor, dout: torch.Tensor,
         group_sizes: torch.Tensor) -> torch.Tensor:
    """[M, K], [M, N], [E] -> [E, K, N] per-group lhs^T @ dout through
    the kernel (CPU tensors: the plain version); empty groups zero."""
    if dout.dim() != 2 or dout.shape[0] != lhs.shape[0]:
        raise ValueError(f"dout {tuple(dout.shape)} does not match lhs "
                         f"{tuple(lhs.shape)}")
    if not _use_kernel(lhs, dout, group_sizes):
        return tgmm_plain(lhs, dout, group_sizes)
    return _tgmm_launch(lhs, dout, group_sizes, tgmm_variant(
        "cuda", lhs.dtype, lhs.shape[1], dout.shape[1],
        (lhs.data_ptr(), dout.data_ptr())))


def _tgmm_launch(lhs: torch.Tensor, dout: torch.Tensor,
                 group_sizes: torch.Tensor, variant: str) -> torch.Tensor:
    """``tgmm``'s launch of one kernel, "wgmma" or "simt", on CUDA
    tensors that ``tgmm`` has checked (the smoke also times the scalar
    kernel at shapes that take the tensor-core one)."""
    M, K = lhs.shape
    N, E = dout.shape[1], group_sizes.shape[0]
    out = torch.empty((E, K, N), dtype=lhs.dtype, device=lhs.device)
    if variant == "wgmma" and tgmm_variant(
            "cuda", lhs.dtype, K, N,
            (lhs.data_ptr(), dout.data_ptr(), out.data_ptr())) != "wgmma":
        raise ValueError("the tensor-core tgmm takes bf16 operands with K "
                         "and N multiples of 8 and 16-byte aligned data")
    args = (lhs.data_ptr(), dout.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), M, K, N, E,
            torch.cuda.current_stream(lhs.device).cuda_stream)
    if variant == "wgmma":
        rc = _lib().dstpu_tgmm_wgmma(*args)
    elif variant == "simt":
        rc = _lib().dstpu_tgmm(_DTYPE_CODE[lhs.dtype], *args)
    else:
        raise ValueError(f"unknown tgmm variant {variant!r}")
    _raise_on(rc, f"tgmm ({variant})")
    LAUNCHES["tgmm"] += 1
    VARIANT_LAUNCHES[f"tgmm/{variant}"] += 1
    return out


# ---------------------------------------------------------------------------
# public entry (differentiable)
# ---------------------------------------------------------------------------


class _GroupedMatmul(torch.autograd.Function):
    """The custom VJP ``gmm``: dlhs = gmm(dout, rhs^T) without
    materialising the transpose, drhs = tgmm(lhs, dout), each cast to its
    input's type (``_gmm_bwd`` :306-314)."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm_raw(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.to(lhs.dtype).contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm_raw(dout, rhs, group_sizes,
                           transpose_rhs=True).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, dout, group_sizes).to(rhs.dtype)
        return dlhs, drhs, None


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        block_m: int = 512, block_n: int = 1024, block_k: int = 512
        ) -> torch.Tensor:
    """Grouped matmul: row m of ``lhs`` times ``rhs[group(m)]``.

    lhs [M, K] sorted by group, rhs [E, K, N] of lhs's type, group_sizes
    [E] int32 (sum == M; an over-sum is clamped, rows past an under-sum
    are zero). Returns [M, N] in lhs.dtype (fp32 accumulation).
    ``block_m`` / ``block_n`` / ``block_k`` are accepted for parity with
    the JAX signature and not used: the Hopper kernels pick their own
    tiles and mask the edges."""
    del block_m, block_n, block_k
    return _GroupedMatmul.apply(lhs.contiguous(), rhs.contiguous(),
                                group_sizes.contiguous())


__all__ = ["gmm", "gmm_raw", "tgmm", "gmm_plain", "gmm_transposed_plain",
           "tgmm_plain", "gmm_variant", "tgmm_variant", "LAUNCHES",
           "VARIANT_LAUNCHES", "reset_launch_counts"]
