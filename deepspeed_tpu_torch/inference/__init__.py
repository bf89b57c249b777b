"""Serving (port of ``deepspeed_tpu/inference``): the v1 dense-cache
engine and the ragged engine."""

from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  init_inference)
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2

__all__ = ["InferenceEngine", "InferenceEngineV2", "init_inference"]
