"""Capability-downgrade telemetry: no silent fallbacks (copy of
``deepspeed_tpu/utils/telemetry.py``, which imports no JAX).

Every capability fallback or refused restore calls :func:`count` with a
stable counter name and a reason; tests and users query
:func:`get` / :func:`snapshot`. Counters are plain Python ints, counted
on the host where the decision is taken (``checkpoint/state.py`` counts
``resilience.corrupt_checkpoint`` when a tag fails its manifest).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}
_REASONS: Dict[str, Dict[str, int]] = {}
_LOGGED: set = set()


def count(name: str, reason: str = "") -> None:
    """Record one occurrence of the named fallback/downgrade.

    Logs a warning the first time each (name, reason) pair fires so the
    downgrade is visible exactly once per process, then keeps counting
    silently (queryable via :func:`get`)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + 1
        if reason:
            per = _REASONS.setdefault(name, {})
            per[reason] = per.get(reason, 0) + 1
        key = (name, reason)
        if key not in _LOGGED:
            _LOGGED.add(key)
            logger.warning(
                f"capability fallback '{name}'"
                + (f": {reason}" if reason else "")
                + " (telemetry.get(%r) counts occurrences)" % name)


def get(name: str) -> int:
    """Occurrences of the named fallback since process start / reset."""
    with _LOCK:
        return _COUNTERS.get(name, 0)


def reasons(name: str) -> Dict[str, int]:
    with _LOCK:
        return dict(_REASONS.get(name, {}))


def snapshot() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Zero all counters (tests)."""
    with _LOCK:
        _COUNTERS.clear()
        _REASONS.clear()
        _LOGGED.clear()
