"""Communication-op logging (port of
``deepspeed_tpu/utils/comms_logging.py``).

The JAX logger records each collective once, when the compiled program
is traced. The port's collectives are eager ``torch.distributed`` calls,
so ``comm`` records each one as it executes: a step that runs twice
records its collectives twice, and the counts and bytes are exact per
executed step. Each record is (op name, input bytes, axis); the
``comms_logger`` config block (``enabled``, ``verbose``, ``prof_all``,
``prof_ops``) drives it through ``comm.configure``, as in JAX.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import defaultdict
from typing import Any, Dict, Optional, Tuple

logger = logging.getLogger(__name__)


def convert_size(size_bytes: float) -> str:
    if size_bytes <= 0:
        return "0B"
    units = ("B", "KB", "MB", "GB", "TB", "PB")
    i = 0
    while size_bytes >= 1024 and i < len(units) - 1:
        size_bytes /= 1024.0
        i += 1
    return f"{size_bytes:.2f} {units[i]}"


@dataclasses.dataclass
class OpRecord:
    count: int = 0
    total_bytes: int = 0
    max_bytes: int = 0


class CommsLogger:
    """Per-executed-collective recorder (singleton via
    :func:`get_comms_logger`)."""

    def __init__(self):
        self.enabled = False
        self.verbose = False
        self.prof_all = True
        self.prof_ops: list = []
        self.comms_dict: Dict[str, Dict[Tuple, OpRecord]] = defaultdict(
            lambda: defaultdict(OpRecord))

    def configure(self, comms_config) -> None:
        self.enabled = comms_config.enabled
        self.verbose = comms_config.verbose
        self.prof_all = comms_config.prof_all
        self.prof_ops = list(comms_config.prof_ops or [])

    def _should_log(self, op_name: str) -> bool:
        if not self.enabled:
            return False
        if self.prof_ops and op_name not in self.prof_ops:
            return False
        return True

    def record(self, op_name: str, nbytes: int, axis: Any,
               log_name: Optional[str] = None) -> None:
        name = log_name or op_name
        if not self._should_log(name):
            return
        key = (str(axis),)
        rec = self.comms_dict[name][key]
        rec.count += 1
        rec.total_bytes += int(nbytes)
        rec.max_bytes = max(rec.max_bytes, int(nbytes))
        if self.verbose:
            logger.info(f"comm op: {name} | axis: {axis} | size: "
                        f"{convert_size(nbytes)}")

    def reset(self) -> None:
        self.comms_dict.clear()

    def totals(self) -> Dict[str, int]:
        """Bytes recorded per op, summed over axes."""
        return {op: sum(rec.total_bytes for rec in per_axis.values())
                for op, per_axis in self.comms_dict.items()}

    def counts(self) -> Dict[str, int]:
        """Collectives recorded per op, summed over axes."""
        return {op: sum(rec.count for rec in per_axis.values())
                for op, per_axis in self.comms_dict.items()}

    def log_summary(self) -> str:
        """Per-op communication volume since the last reset."""
        lines = [f"{'Comm op':<28}{'Axis':<22}{'Count':<8}"
                 f"{'Total bytes':<16}{'Max msg':<12}"]
        for op_name, per_axis in sorted(self.comms_dict.items()):
            for key, rec in sorted(per_axis.items()):
                lines.append(
                    f"{op_name:<28}{key[0]:<22}{rec.count:<8}"
                    f"{convert_size(rec.total_bytes):<16}"
                    f"{convert_size(rec.max_bytes):<12}")
        summary = "\n".join(lines)
        logger.info("\n" + summary)
        return summary


_COMMS_LOGGER: Optional[CommsLogger] = None


def get_comms_logger() -> CommsLogger:
    global _COMMS_LOGGER
    if _COMMS_LOGGER is None:
        _COMMS_LOGGER = CommsLogger()
    return _COMMS_LOGGER


__all__ = ["CommsLogger", "OpRecord", "convert_size", "get_comms_logger"]
