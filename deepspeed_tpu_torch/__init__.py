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

Slice 13: ZenFlow (``runtime.zenflow``: the top coordinates stepped on
the card, the rest by the native host Adam overlapped with the card's
steps), the remaining optimizers (``runtime.optimizer``,
``runtime.muon``) and the engine's remaining one-card methods.

Slice 14: speculative decoding on the ragged engine
(``inference.spec_decode``: prompt lookup and a draft model, verified
through the paged prefill kernel), ``(loss_fn, params)`` models, client
optimizers and schedulers, the prefetcher and dispatch-ahead
(``runtime.prefetch``).

Slice 15: the measured kernel dispatch — ``ops.kernel_table`` (JAX's
``kernel_table/v1`` rows, scoped to "cuda" and the card's name, or
"cpu"), ``ops.registry`` (``dispatch_op``: the compat probe, the table,
the heuristic) behind ``impl="auto"``, the ``kernels.dispatch`` and
``kernels.table_path`` config keys; the kernel bench that writes the
table (``python -m deepspeed_tpu_torch.tools.kernel_bench``) and the
environment report (``python -m deepspeed_tpu_torch.launcher.report``);
and the v1 inference engine, ``init_inference`` (``inference.engine``,
a dense KV cache through ``model_runner.forward_with_cache``).

Slice 16: ZeRO stages 1-3 across ranks on ``torch.distributed`` (NCCL
on the card, gloo on the CPU): ``comm`` (named-axis collectives, the
comms logger), ``parallel.topology`` (``build_mesh``,
``TopologyConfig``), ``runtime.sharding`` (the plan and the stage-3
gather at use), ``runtime.zero``, ``runtime.sparse_tensor`` and
``utils.tensor_fragment``; checkpoints saved and loaded at any world
size.
"""

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch._device import kernels_available, resolve_device
from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  init_inference)
from deepspeed_tpu_torch.parallel.topology import TopologyConfig, build_mesh
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.engine import initialize

__all__ = ["initialize", "init_inference", "InferenceEngine",
           "kernels_available", "resolve_device", "DeepSpeedDataLoader",
           "RepeatingLoader", "build_mesh", "TopologyConfig", "comm"]
