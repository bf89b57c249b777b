"""Engine checkpoints (port of ``deepspeed_tpu/checkpoint``). The JAX
package's universal-checkpoint tools wait for ROADMAP queue A item 16."""

from deepspeed_tpu_torch.checkpoint.state import CheckpointIO  # noqa: F401
