"""Fault tolerance: survive preemption, rank death, and flaky collectives
(port of ``deepspeed_tpu/resilience``: the same modules and exports,
each a copy of a JAX module that imports no JAX).

The production analog of the reference's DecoupledCheckpointEngine +
DSElasticAgent split, grown into a subsystem (docs/resilience.md):

* :mod:`policy`     — deadline / exponential-backoff / jitter retry policy
  for control-plane collectives; typed :class:`CommTimeoutError` carrying
  the flight-ring tail so the elastic agent can tell "peer dead" from
  "transient".
* :mod:`manifest`   — atomic per-checkpoint manifest (tag, step, world
  topology, per-file checksums, data-pipeline cursor) written tmp+rename;
  validation refuses torn/corrupt saves and falls back to the previous
  good tag.
* :mod:`preemption` — :class:`PreemptionGuard`: SIGTERM/preemption-notice
  listener that forces an emergency save+commit at the next GAS
  boundary under a bounded deadline.
* :mod:`resume`     — deterministic auto-resume of the data pipeline: the
  checkpointed cursor counts *consumed* boundaries, so a
  killed-and-resumed run replays the exact remaining batch stream.
* :mod:`chaos`      — env/config-driven fault injection (kill a rank at
  step N, delay/fail the Kth collective, corrupt a checkpoint, stall the
  input pipeline).
"""

from deepspeed_tpu_torch.resilience.chaos import (ChaosInjector, ChaosSpec,
                                                  corrupt_checkpoint,
                                                  get_chaos_injector)
from deepspeed_tpu_torch.resilience.manifest import (MANIFEST_FILE,
                                                     CheckpointCorruptError,
                                                     find_latest_valid_tag,
                                                     validate_manifest,
                                                     write_manifest)
from deepspeed_tpu_torch.resilience.policy import (TRANSIENT_EXIT_CODE,
                                                   CommTimeoutError,
                                                   RetryPolicy)
from deepspeed_tpu_torch.resilience.preemption import PreemptionGuard
from deepspeed_tpu_torch.resilience.resume import (data_cursor,
                                                   resume_data_iter)

__all__ = [
    "ChaosInjector", "ChaosSpec", "CheckpointCorruptError",
    "CommTimeoutError", "MANIFEST_FILE", "PreemptionGuard", "RetryPolicy",
    "TRANSIENT_EXIT_CODE", "corrupt_checkpoint", "data_cursor",
    "find_latest_valid_tag", "get_chaos_injector", "resume_data_iter",
    "validate_manifest", "write_manifest",
]
