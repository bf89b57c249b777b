"""Floating-point (fp8) group quantization (port of
``deepspeed_tpu/ops/fp_quantizer.py`` :25-78).

fp8 is a storage dtype on Hopper (``torch.float8_e4m3fn`` /
``torch.float8_e5m2``), so quantization is a cast with one fp32 scale per
group that maps the group's absmax to the format's largest normal. The
cast rounds to nearest even, as JAX's ``astype`` does: the two give the
same bytes for every value the scale can produce (|x / scale| <= 448 up
to one rounding of the division).

Only what the fp8 KV rung needs is here; ``fp8_matmul*`` and
``FPQuantizer`` wait for ROADMAP queue A item 10.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

FORMATS = {
    "e4m3": torch.float8_e4m3fn,  # max normal 448
    "e5m2": torch.float8_e5m2,    # max normal 57344
}
_FMT_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
DEFAULT_GROUP = 128


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
