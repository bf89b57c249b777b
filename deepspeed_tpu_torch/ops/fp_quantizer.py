"""Floating-point (fp8) group quantization (port of
``deepspeed_tpu/ops/fp_quantizer.py`` :25-78).

fp8 is a storage dtype on Hopper (``torch.float8_e4m3fn`` /
``torch.float8_e5m2``), so quantization is a cast with one fp32 scale per
group that maps the group's absmax to the format's largest normal. The
cast rounds to nearest even, as JAX's ``astype`` does: the two give the
same bytes for every value the scale can produce (|x / scale| <= 448 up
to one rounding of the division).

``fp8_matmul`` is JAX's per-tensor-scaled fp8 x fp8 product (JAX runs it
as a ``jnp.matmul`` on fp8 operands, outside any Pallas kernel). On CUDA
tensors whose dims are multiples of 16 it is one ``torch._scaled_mm``
(e4m3 operands, the second column-major, fp32 scales, fp32 accumulation
on Hopper's fp8 tensor cores), counted in ``FP8_LAUNCHES``; elsewhere
the fp8 values are cast back to fp32 and multiplied exactly, which is
JAX's CPU arithmetic. ``fp8_matmul_ste`` is the training recipe behind
``performance.fp8_mlp``: that forward, with the backward of the exact
product in the operands' own precision.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch

FORMATS = {
    "e4m3": torch.float8_e4m3fn,  # max normal 448
    "e5m2": torch.float8_e5m2,    # max normal 57344
}
_FMT_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
DEFAULT_GROUP = 128

# fp8 products run on the card's fp8 tensor cores (``torch._scaled_mm``)
FP8_LAUNCHES: Dict[str, int] = {"fp8_matmul": 0}


def reset_launch_counts() -> None:
    FP8_LAUNCHES["fp8_matmul"] = 0


def _resolve_format(q_bits: int = 8, fmt: Optional[str] = None) -> str:
    if fmt is not None:
        if fmt not in FORMATS:
            raise ValueError(f"unknown fp format '{fmt}' "
                             f"(choose from {sorted(FORMATS)})")
        return fmt
    if q_bits != 8:
        warnings.warn(f"fp_quantizer: {q_bits}-bit formats have no storage "
                      "dtype; rounding to fp8 e4m3")
    return "e4m3"


def fp_quantize(x: torch.Tensor, q_bits: int = 8, fmt: Optional[str] = None,
                group_size: int = DEFAULT_GROUP
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., N] -> (fp8 values [..., N], fp32 scales [..., N/group]).

    Each group's absmax maps to the format's max normal; an all-zero
    group gets scale 1.0."""
    fmt = _resolve_format(q_bits, fmt)
    n = x.shape[-1]
    if n % group_size:
        warnings.warn(
            f"fp_quantize: last dim {n} not divisible by group_size "
            f"{group_size}; using one scale per row (coarser precision)")
    g = group_size if n % group_size == 0 else n
    grouped = x.float().reshape(*x.shape[:-1], n // g, g)
    amax = grouped.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, not JAX's IEEE quotient
    scale = torch.where(amax > 0,
                        amax / torch.full_like(amax, _FMT_MAX[fmt]),
                        torch.ones_like(amax))
    q = (grouped / scale).to(FORMATS[fmt])
    return q.reshape(x.shape), scale[..., 0]


def fp_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  group_size: int = DEFAULT_GROUP,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    n = q.shape[-1]
    g = group_size if n % group_size == 0 else n
    grouped = q.float().reshape(*q.shape[:-1], n // g, g)
    out = grouped * scale[..., None]
    return out.reshape(q.shape).to(dtype)


def selective_dequantize(q: torch.Tensor, scale: torch.Tensor,
                         rows: torch.Tensor, group_size: int = DEFAULT_GROUP,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dequantize only ``rows`` (leading-dim indices), the reference's
    selective_dequantize."""
    return fp_dequantize(q[rows], scale[rows], group_size, dtype)


def _tensor_scale(t: torch.Tensor, fmt: str) -> torch.Tensor:
    amax = t.abs().amax().float()
    return torch.where(amax > 0, amax / torch.full_like(amax, _FMT_MAX[fmt]),
                       torch.ones_like(amax))


def _scaled_mm_ok(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.is_cuda and a.dim() == 2 and b.dim() == 2
            and all(d % 16 == 0 for d in (*a.shape, b.shape[1])))


def fp8_matmul(a: torch.Tensor, b: torch.Tensor, fmt: str = "e4m3",
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """a [M, K] @ b [K, N] with both operands in fp8 (one fp32 scale per
    tensor mapping its absmax to the format's max normal), fp32
    accumulation, the product rescaled by sa * sb and cast once."""
    fmt = _resolve_format(8, fmt)
    sa, sb = _tensor_scale(a, fmt), _tensor_scale(b, fmt)
    qa = (a.float() / sa).to(FORMATS[fmt])
    qb = (b.float() / sb).to(FORMATS[fmt])
    if _scaled_mm_ok(a, b):
        # _scaled_mm: the second operand column-major ([N, K] rows, .t())
        out = torch._scaled_mm(qa, qb.t().contiguous().t(), scale_a=sa,
                               scale_b=sb, out_dtype=torch.float32)
        FP8_LAUNCHES["fp8_matmul"] += 1
        return out.to(out_dtype)
    acc = torch.matmul(qa.float(), qb.float())
    return (acc * (sa * sb)).to(out_dtype)


class _Fp8MatmulSTE(torch.autograd.Function):
    """fp8 forward, straight-through backward (the exact product's
    gradients in the operands' own precision)."""

    @staticmethod
    def forward(ctx, x, w, fmt, out_dtype):
        ctx.save_for_backward(x, w)
        lead = x.shape[:-1]
        out = fp8_matmul(x.reshape(-1, x.shape[-1]), w, fmt=fmt,
                         out_dtype=out_dtype)
        return out.reshape(*lead, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.matmul(g.to(x.dtype), w.to(x.dtype).t()).to(x.dtype)
        g2 = g.reshape(-1, g.shape[-1]).float()
        x2 = x.reshape(-1, x.shape[-1]).float()
        dw = torch.matmul(x2.t(), g2).to(w.dtype)
        return dx, dw, None, None


def fp8_matmul_ste(x: torch.Tensor, w: torch.Tensor, fmt: str = "e4m3",
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [..., K] @ w [K, N] in fp8 (``fp8_matmul``) with straight-through
    gradients: dx = g @ w.T and dw = x.T @ g (batch dims summed), as if
    the product were exact. Returns [..., N] in ``out_dtype`` (default
    x's)."""
    return _Fp8MatmulSTE.apply(x, w, fmt, out_dtype or x.dtype)


class FPQuantizer:
    """The reference's ``FP_Quantize`` object API: quantize / dequantize /
    selective_dequantize with a stored group size and format."""

    def __init__(self, q_bits: int = 8, fmt: Optional[str] = None,
                 group_size: int = DEFAULT_GROUP):
        self.fmt = _resolve_format(q_bits, fmt)
        self.q_bits = 8
        self.group_size = group_size

    def quantize(self, x):
        return fp_quantize(x, fmt=self.fmt, group_size=self.group_size)

    def dequantize(self, q, scale, dtype=torch.bfloat16):
        return fp_dequantize(q, scale, self.group_size, dtype)

    def selective_dequantize(self, q, scale, rows, dtype=torch.bfloat16):
        return selective_dequantize(q, scale, rows, self.group_size, dtype)
