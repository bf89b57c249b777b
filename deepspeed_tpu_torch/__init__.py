"""PyTorch + CUDA port of deepspeed_tpu for one NVIDIA H100.

The JAX package ``deepspeed_tpu`` stays the reference; module paths here
mirror it so each counterpart is easy to find. This package imports
torch, numpy and the standard library only — never JAX and never
``deepspeed_tpu``.

Ported so far (slice 1): ragged serving — ``inference.engine_v2``
(``InferenceEngineV2``) over ``models.zoo`` dense presets, with the paged
decode and paged prefill attention kernels written by hand in CUDA
(``ops/csrc/paged_attention.cu``).

Slice 2: the dense training step — ``initialize`` (``runtime.engine``)
and ``Engine.train_batch`` over the same models, with the flash
attention forward and both backward kernels written by hand in CUDA
(``ops/csrc/flash_attention.cu``).
"""

from deepspeed_tpu_torch._device import kernels_available, resolve_device
from deepspeed_tpu_torch.runtime.engine import initialize

__all__ = ["initialize", "kernels_available", "resolve_device"]
