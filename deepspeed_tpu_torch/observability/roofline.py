"""Peak-rate table, MFU and roofline classification (port of
``deepspeed_tpu/observability/roofline.py``).

One home for the card's peak numbers, so the engine's MFU and a
benchmark's are computed from the same table and the same formula.
``mfu`` and ``roofline_summary`` are JAX's formulas. The table holds
NVIDIA cards keyed on ``torch.cuda.get_device_name``: the H100 80GB
HBM3 (SXM) at NVIDIA's dense bf16 peak and HBM bandwidth (data sheet,
at the 700 W limit), the figures PERF.md's MFU and kernel bounds use.
``BENCH_PEAK_TFLOPS`` / ``BENCH_HBM_GBPS`` override it.

A card that is not in the table has no peak: the lookup warns once and
returns None, and the engine then leaves ``mfu`` as None (JAX falls back
to a reference chip's figure there). A CPU device takes the named
placeholders ``CPU_PEAK_TFLOPS`` / ``CPU_HBM_GBPS``, which exist so that
the CPU tests exercise the formulas; no CPU rate is claimed by them.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.utils.logging import warning_once

# dense bf16 peak TFLOP/s by card (lower-cased substring of the name)
PEAK_TFLOPS = {
    "h100 80gb hbm3": 989.0,
}

# HBM bandwidth, GB/s
HBM_GBPS = {
    "h100 80gb hbm3": 3350.0,
}

# placeholders for CPU tensors (tests pin them; not a measured rate)
CPU_PEAK_TFLOPS = 1.0
CPU_HBM_GBPS = 100.0


def _device_name(device) -> Optional[str]:
    """The card's name, or None for a CPU device (and without CUDA)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def _lookup(table: Dict[str, float], env: str, cpu_value: float,
            device, what: str) -> Optional[float]:
    if env in os.environ:
        return float(os.environ[env])
    name = _device_name(device)
    if name is None:
        return cpu_value
    low = name.lower()
    for key, val in table.items():
        if key in low:
            return val
    warning_once(f"roofline: no {what} for card {name!r} in the table "
                 f"(observability/roofline.py; set {env}): MFU and "
                 "roofline numbers are left out")
    return None


def detect_peak_tflops(device=None) -> Optional[float]:
    """Dense bf16 peak of ``device`` (default: the current card, else the
    CPU); ``BENCH_PEAK_TFLOPS`` overrides; None for a card not in the
    table."""
    return _lookup(PEAK_TFLOPS, "BENCH_PEAK_TFLOPS", CPU_PEAK_TFLOPS,
                   device, "bf16 peak")


def detect_hbm_gbps(device=None) -> Optional[float]:
    """HBM bandwidth of ``device``; ``BENCH_HBM_GBPS`` overrides; None
    for a card not in the table."""
    return _lookup(HBM_GBPS, "BENCH_HBM_GBPS", CPU_HBM_GBPS, device,
                   "HBM bandwidth")


def mfu(tokens_per_sec_per_chip: float, flops_per_token: float,
        peak_tflops: float) -> float:
    """Model-FLOPs utilization — the benchmark's exact formula."""
    if peak_tflops <= 0:
        return 0.0
    return tokens_per_sec_per_chip * flops_per_token / (peak_tflops * 1e12)


def roofline_summary(cost: Dict[str, float], peak_tflops: float,
                     hbm_gbps: float,
                     step_seconds: Optional[float] = None
                     ) -> Dict[str, Any]:
    """Classify a step's cost against the card's roofline.

    ``cost`` is {"flops", "bytes_accessed", ...} (the engine's counted
    step, ``attribution.count_step``). Returns arithmetic intensity, the
    ridge point, which side of it the step sits on, the attainable
    TFLOP/s ceiling, and — when ``step_seconds`` is given — the achieved
    TFLOP/s and the fraction of attainable.
    """
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes_accessed", 0.0))
    intensity = flops / bytes_accessed if bytes_accessed > 0 else float("inf")
    ridge = peak_tflops * 1e12 / (hbm_gbps * 1e9)  # FLOPs per HBM byte
    bound = "compute" if intensity >= ridge else "memory"
    attainable = (peak_tflops if bound == "compute"
                  else hbm_gbps * intensity / 1e3)  # GB/s * F/B -> TFLOPS
    out = {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": round(intensity, 3),
        "ridge_intensity": round(ridge, 3),
        "bound": bound,
        "peak_tflops": peak_tflops,
        "hbm_gbps": hbm_gbps,
        "attainable_tflops": round(attainable, 3),
    }
    if step_seconds and step_seconds > 0:
        achieved = flops / step_seconds / 1e12
        out["achieved_tflops"] = round(achieved, 4)
        out["hw_flops_utilization"] = round(achieved / peak_tflops, 4)
        if attainable > 0:
            out["fraction_of_attainable"] = round(achieved / attainable, 4)
    return out
