"""Deadline + retry/backoff policy for control-plane operations (copy of
``deepspeed_tpu/resilience/policy.py``, which imports no JAX).

At pod scale a slow or wedged reduction is indistinguishable from a dead
peer ("The Big Send-off", PAPERS.md): the process-level control-plane ops
(rendezvous init, barrier, cross-process asserts, heartbeat I/O) are the
places a single sick host turns into a silent fleet-wide hang. This
module bounds them:

* :class:`RetryPolicy` — configurable deadline per attempt, exponential
  backoff with jitter between attempts (``resilience`` config block:
  ``init_timeout_s``, ``collective_timeout_s``, ``max_retries``,
  ``backoff_base_s``).
* :class:`CommTimeoutError` — the typed exhaustion error. It carries the
  flight-ring tail (the last seconds of runtime events) so whoever
  catches it — the elastic agent, a human reading the worker log — can
  distinguish "peer dead → restart group" from "transient → retry".
  Workers that die of it exit with :data:`TRANSIENT_EXIT_CODE` so the
  elastic agent classifies the restart without parsing logs.

Deadlines run the wrapped callable on a worker thread and abandon it on
expiry (Python cannot safely interrupt a blocked C extension call); the
leaked thread is daemonic and the caller is expected to tear the process
down — that is the point: a *diagnosed* restart instead of a hang.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

#: sysexits.h EX_TEMPFAIL — the exit code a worker uses when it dies of a
#: CommTimeoutError, letting the elastic agent classify the failure as
#: transient (retry with backoff) without parsing stderr.
TRANSIENT_EXIT_CODE = 75


class CommTimeoutError(RuntimeError):
    """A control-plane op exhausted its deadline/retry budget.

    Attributes:
      op:           operation name ("init_distributed", "barrier", ...)
      timeout_s:    per-attempt deadline that expired
      attempts:     how many attempts were made
      flight_tail:  formatted tail of the flight-recorder ring at raise
                    time (what the worker was doing when it wedged)
    """

    exit_code = TRANSIENT_EXIT_CODE

    def __init__(self, op: str, timeout_s: Optional[float] = None,
                 attempts: int = 1, flight_tail: str = "",
                 cause: Optional[BaseException] = None):
        self.op = op
        self.timeout_s = timeout_s
        self.attempts = attempts
        self.flight_tail = flight_tail
        msg = (f"control-plane op {op!r} failed after {attempts} "
               f"attempt(s)"
               + (f" (deadline {timeout_s:g}s per attempt)"
                  if timeout_s else "")
               + (f": {cause}" if cause is not None else ""))
        if flight_tail:
            msg += f"\nflight-recorder tail:\n{flight_tail}"
        super().__init__(msg)


def _flight_tail(last: int = 24) -> str:
    """Best-effort flight-ring tail; never raises (a half-torn process
    must still be able to raise)."""
    try:
        from deepspeed_tpu_torch.observability.flight_recorder import \
            get_flight_recorder

        return get_flight_recorder().tail_lines(last=last)
    except Exception:
        return ""


class _DeadlineExpired(Exception):
    pass


def run_with_deadline(fn: Callable[[], Any], timeout_s: Optional[float],
                      name: str = "op") -> Any:
    """Run ``fn`` bounded by ``timeout_s`` (None/<=0 = unbounded, called
    inline). On expiry raises :class:`_DeadlineExpired`; the worker
    thread is abandoned (daemon) — see module docstring."""
    if not timeout_s or timeout_s <= 0:
        return fn()
    result: list = []
    error: list = []
    done = threading.Event()

    def target():
        try:
            result.append(fn())
        except BaseException as e:  # re-raised on the caller thread
            error.append(e)
        finally:
            done.set()

    t = threading.Thread(target=target, name=f"deadline-{name}",
                         daemon=True)
    t.start()
    if not done.wait(timeout=timeout_s):
        raise _DeadlineExpired(name)
    if error:
        raise error[0]
    return result[0]


@dataclass
class RetryPolicy:
    """Deadline + exponential backoff + jitter for control-plane ops.

    ``collective_timeout_s`` / ``init_timeout_s`` of ``None`` (the
    defaults) leave the corresponding ops unbounded — zero behavior
    change until the ``resilience`` config block opts in.
    """

    init_timeout_s: Optional[float] = None
    collective_timeout_s: Optional[float] = None
    max_retries: int = 2
    backoff_base_s: float = 1.0
    backoff_max_s: float = 30.0
    jitter: float = 0.25

    @classmethod
    def from_config(cls, rcfg) -> "RetryPolicy":
        """Build from a ResilienceConfig block (or anything duck-typed)."""
        if rcfg is None:
            return cls()
        return cls(
            init_timeout_s=getattr(rcfg, "init_timeout_s", None),
            collective_timeout_s=getattr(rcfg, "collective_timeout_s",
                                         None),
            max_retries=int(getattr(rcfg, "max_retries", 2)),
            backoff_base_s=float(getattr(rcfg, "backoff_base_s", 1.0)),
            backoff_max_s=float(getattr(rcfg, "backoff_max_s", 30.0)),
            jitter=float(getattr(rcfg, "jitter", 0.25)))

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based): exponential with
        multiplicative jitter, capped at ``backoff_max_s``."""
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** max(0, attempt - 1)))
        return base * (1.0 + self.jitter * random.random())

    def run(self, op: str, fn: Callable[[], Any],
            timeout_s: Optional[float] = None,
            retryable: Callable[[BaseException], bool] = None) -> Any:
        """Run ``fn`` under the policy: each attempt bounded by
        ``timeout_s`` (default ``collective_timeout_s``), up to
        ``max_retries`` retries with backoff between. Exhaustion (or a
        non-retryable error after a timeout was configured) raises
        :class:`CommTimeoutError` with the flight tail attached; with no
        timeout configured the call is a plain passthrough."""
        timeout_s = (self.collective_timeout_s if timeout_s is None
                     else timeout_s)
        if not timeout_s or timeout_s <= 0:
            return fn()
        attempts = self.max_retries + 1
        last: Optional[BaseException] = None
        for attempt in range(1, attempts + 1):
            try:
                return run_with_deadline(fn, timeout_s, name=op)
            except _DeadlineExpired:
                last = None
                logger.warning(
                    f"resilience: {op} exceeded {timeout_s:g}s deadline "
                    f"(attempt {attempt}/{attempts})")
            except Exception as e:  # noqa: BLE001 — classified below
                if retryable is not None and not retryable(e):
                    raise
                last = e
                logger.warning(
                    f"resilience: {op} failed (attempt "
                    f"{attempt}/{attempts}): {e}")
            if attempt < attempts:
                delay = self.backoff_s(attempt)
                logger.info(f"resilience: retrying {op} in {delay:.2f}s")
                time.sleep(delay)
        raise CommTimeoutError(op, timeout_s=timeout_s, attempts=attempts,
                               flight_tail=_flight_tail(), cause=last)
