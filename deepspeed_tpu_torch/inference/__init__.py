"""Serving (port of ``deepspeed_tpu/inference``): the ragged engine."""

from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2

__all__ = ["InferenceEngineV2"]
