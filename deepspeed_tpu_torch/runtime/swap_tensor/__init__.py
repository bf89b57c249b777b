"""NVMe tensor swapping for the offload tier (port of
``deepspeed_tpu/runtime/swap_tensor``; reference
deepspeed/runtime/swap_tensor/)."""

from deepspeed_tpu_torch.runtime.swap_tensor.swapper import (
    AsyncTensorSwapper, SwapBufferPool, TensorSwapStore)

__all__ = ["AsyncTensorSwapper", "SwapBufferPool", "TensorSwapStore"]
