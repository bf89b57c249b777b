"""Named op registry with compatibility probing and the measured
dispatch (port of ``deepspeed_tpu/ops/registry.py``).

A stable name -> op table for tooling (``launcher/report.py`` prints the
compat column, as ds_report does) and :func:`dispatch_op`, the
cost-driven choice between a hand-written kernel and its fallback. The
guard order is JAX's: (1) the compat probe, (2) the measured win/loss
table (``ops/kernel_table.py``, written by ``tools/kernel_bench.py``),
(3) the caller's heuristic for unmeasured buckets.

One difference from JAX: the compat probe of a hand-written kernel is
``_device.kernels_status`` (an sm_90 card and ``nvcc``). On CPU tensors
the plain PyTorch versions always qualify. On CUDA tensors a failing
probe raises with the probe's note: JAX routes such a call to its XLA
fallback, which on the card would hide that the kernel cannot run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

from deepspeed_tpu_torch import _device
from deepspeed_tpu_torch.ops import kernel_table


@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    description: str
    load: Callable[[], Callable]          # returns the op's callable
    # probe(device_type) -> (ok, note)
    compat_probe: Optional[Callable[[str], Tuple[bool, str]]] = None

    def is_compatible(self, device_type: Optional[str] = None
                      ) -> Tuple[bool, str]:
        if self.compat_probe is None:
            return True, ""
        try:
            return self.compat_probe(device_type
                                     or kernel_table.default_backend())
        except Exception as e:  # a probe must never crash tooling
            return False, f"probe error: {e}"


_REGISTRY: Dict[str, OpSpec] = {}


def register_op(name: str, description: str,
                compat_probe: Optional[Callable] = None):
    """Decorator-style registration of a loader function."""

    def deco(load_fn):
        _REGISTRY[name] = OpSpec(name, description, load_fn, compat_probe)
        return load_fn

    return deco


def get_op(name: str) -> Callable:
    _ensure_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"unknown op {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name].load()


def all_ops() -> Dict[str, OpSpec]:
    _ensure_builtin()
    return dict(_REGISTRY)


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """Which registered op runs and why. ``source`` is "kernel" (the
    hand-written kernel; JAX's "pallas") or "xla" (the fallback, in JAX's
    vocabulary); ``blocks`` carries the table entry's geometry (the
    template that was measured)."""

    op_name: str
    source: str  # "kernel" | "xla"
    reason: str
    ratio: Optional[float] = None
    blocks: Optional[Dict[str, Any]] = None


def dispatch_op(name: str, bucket: str, fallback: str,
                default_use: bool = False,
                table_path: Optional[str] = None,
                device_type: Optional[str] = None) -> DispatchDecision:
    """Pick ``name`` or ``fallback`` for a shape bucket on
    ``device_type`` (default: ``kernel_table.default_backend()``).

    Guard order: (1) the compat probe: on a CUDA device a failing probe
    raises, elsewhere the plain versions qualify; (2) the win/loss table:
    measured entries rule (ratio >= 1.0 runs the kernel, < 1.0 the
    fallback); (3) ``default_use``, the caller's heuristic for unmeasured
    buckets.
    """
    _ensure_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"unknown op {name!r}; known: {sorted(_REGISTRY)}")
    dev = device_type or kernel_table.default_backend()
    ok, note = _REGISTRY[name].is_compatible(dev)
    if not ok:
        raise RuntimeError(f"{name} cannot run on {dev}: compat probe "
                           f"failed: {note}")
    d = kernel_table.decide(name, bucket, path=table_path, backend=dev)
    if d.measured:
        if d.win:
            return DispatchDecision(name, "kernel", d.reason, d.ratio,
                                    d.blocks)
        return DispatchDecision(fallback, "xla", d.reason, d.ratio,
                                d.blocks)
    if default_use:
        return DispatchDecision(name, "kernel",
                                f"{d.reason}; heuristic prefers kernel")
    return DispatchDecision(fallback, "xla",
                            f"{d.reason}; heuristic prefers fallback")


@functools.lru_cache(None)
def _card_status() -> Tuple[bool, str]:
    return _device.kernels_status()


def _kernel_probe(device_type: str) -> Tuple[bool, str]:
    """The hand-written kernels' probe: CPU tensors run the plain
    versions; a CUDA device needs sm_90 and nvcc."""
    if device_type == "cpu":
        return True, "cpu: the plain PyTorch version"
    if device_type != "cuda":
        return False, f"no kernels for device type {device_type!r}"
    return _card_status()


_BUILTIN_LOADED = False


def _ensure_builtin() -> None:
    global _BUILTIN_LOADED
    if _BUILTIN_LOADED:
        return
    _BUILTIN_LOADED = True

    @register_op("flash_attention",
                 "hand-written flash attention, forward and both backward "
                 "kernels (ops/csrc/flash_attention.cu)", _kernel_probe)
    def _load_flash():
        from deepspeed_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention

    @register_op("quantize_blockwise",
                 "hand-written blockwise int8/int4 quantize "
                 "(ops/csrc/quantization.cu)", _kernel_probe)
    def _load_quant():
        from deepspeed_tpu_torch.ops.quantization import quantize_blockwise

        return quantize_blockwise

    @register_op("dequantize_blockwise",
                 "hand-written blockwise dequantize "
                 "(ops/csrc/quantization.cu)", _kernel_probe)
    def _load_dequant():
        from deepspeed_tpu_torch.ops.quantization import \
            dequantize_blockwise

        return dequantize_blockwise

    @register_op("xla_attention",
                 "dense multi-head attention fallback (PyTorch ops)")
    def _load_xla_attn():
        from deepspeed_tpu_torch.ops.attention import xla_attention

        return xla_attention

    @register_op("ragged_forward",
                 "paged-KV ragged inference step, plain gather attention "
                 "(inference/model_runner.py)")
    def _load_ragged():
        from deepspeed_tpu_torch.inference.model_runner import \
            ragged_forward

        return ragged_forward


__all__ = ["OpSpec", "register_op", "get_op", "all_ops",
           "DispatchDecision", "dispatch_op"]
