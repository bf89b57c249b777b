"""PyTorch + CUDA port of deepspeed_tpu for one NVIDIA H100.

The JAX package ``deepspeed_tpu`` stays the reference; module paths here
mirror it so each counterpart is easy to find. This package imports
torch, numpy and the standard library only — never JAX and never
``deepspeed_tpu``.

Ported so far (slice 1): ragged serving — ``inference.engine_v2``
(``InferenceEngineV2``) over ``models.zoo`` dense presets, with the paged
decode and paged prefill attention kernels written by hand in CUDA
(``ops/csrc/paged_attention.cu``).
"""

from deepspeed_tpu_torch._device import kernels_available, resolve_device

__all__ = ["kernels_available", "resolve_device"]
