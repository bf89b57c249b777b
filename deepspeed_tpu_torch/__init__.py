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

Slice 3: single-card MoE serving and training, with the grouped-matmul
kernels (``ops/csrc/grouped_matmul.cu``). Slice 4: quantized serving,
with the blockwise quantize, the KV quantize-on-append and the
dequantize (``ops/csrc/quantization.cu``).

Slice 5: block-sparse attention — the ``sparse_attention`` and
``kernels`` config blocks, ``attn_impl="blocksparse"`` (the masked form
where autograd records, the hand-written block-sparse forward kernel,
``ops/csrc/blocksparse_attention.cu``, elsewhere), the engine's
``training_data`` dataloader (``DeepSpeedDataLoader``,
``RepeatingLoader``) and its ``forward`` / ``backward`` / ``step``
micro-step API.

Slice 11: checkpoints and the resilience layer — the engine's
``save_checkpoint`` / ``load_checkpoint`` / ``resume_data_iter`` /
``module_state_dict`` (``checkpoint``, ``runtime.checkpoint_engine``),
with ``resilience`` (manifests, the preemption guard, the data cursor,
chaos injection, retry policy) and ``utils.telemetry``; the JAX on-disk
contract with torch tensors.

Slice 12: ZeRO-Offload on one card — ``zero_optimization.
offload_optimizer`` (``runtime.offload``): the fp32 masters and moments
on the host or a local disk, stepped by the native CPU Adam of the
repository's ``csrc/`` (``ops.native``, built with g++), the async I/O
and swap layers (``ops.native.aio``, ``runtime.swap_tensor``), the
pipelined checkpoint writer (``io``, ``checkpoint.parallel_write_
pipeline``) and ``utils.memspace``.
"""

from deepspeed_tpu_torch._device import kernels_available, resolve_device
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.engine import initialize

__all__ = ["initialize", "kernels_available", "resolve_device",
           "DeepSpeedDataLoader", "RepeatingLoader"]
