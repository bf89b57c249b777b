"""Rank-aware logging (port of ``deepspeed_tpu/utils/logging.py``).

``logger``, ``log_dist``, ``print_rank_0`` and ``warning_once``, as in
JAX (reference deepspeed/utils/logging.py:52,104). The rank is
``torch.distributed``'s when a process group exists, else ``RANK`` /
``PROCESS_ID`` from the environment, else 0 (JAX reads
``jax.process_index``).
"""

from __future__ import annotations

import functools
import logging
import os

LOG_LEVEL_ENV = "DSTPU_LOG_LEVEL"

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch") -> logging.Logger:
    """The package logger, parent of every module's
    ``logging.getLogger(__name__)``. Unlike JAX's it keeps propagating
    to the root and adds no handler of its own: the application's
    logging setup decides where records go (and pytest's ``caplog``
    sees them). ``DSTPU_LOG_LEVEL`` sets its level."""
    logger_ = logging.getLogger(name)
    env = os.environ.get(LOG_LEVEL_ENV)
    if env:
        logger_.setLevel(log_levels.get(env.lower(), logging.INFO))
    return logger_


logger = _create_logger()


def process_rank() -> int:
    """This process's rank: the process group's when one exists, else
    ``RANK`` / ``PROCESS_ID``, else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    for var in ("RANK", "PROCESS_ID"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the listed ranks (None / -1 = all)."""
    my_rank = process_rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def print_rank_0(message: str) -> None:
    if process_rank() == 0:
        print(message, flush=True)


def warning_once(message: str) -> None:
    if message not in _seen_warnings:
        _seen_warnings.add(message)
        logger.warning(message)


_seen_warnings: set = set()
