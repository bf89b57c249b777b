"""Parameter-tree classification for tensor and expert parallelism (port
of ``deepspeed_tpu/module_inject``)."""

from deepspeed_tpu_torch.module_inject.auto_ep import (AutoEP, AutoEPPreset,
                                                       ep_model_init,
                                                       stack_expert_modulelist)
from deepspeed_tpu_torch.module_inject.auto_tp import AutoTP, tp_model_init

__all__ = ["AutoEP", "AutoEPPreset", "AutoTP", "ep_model_init",
           "stack_expert_modulelist", "tp_model_init"]
