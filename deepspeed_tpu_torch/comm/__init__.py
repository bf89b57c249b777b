"""Named-axis collectives on ``torch.distributed`` (port of
``deepspeed_tpu/comm``)."""

from deepspeed_tpu_torch.comm.comm import *  # noqa: F401,F403
from deepspeed_tpu_torch.comm import comm  # noqa: F401
