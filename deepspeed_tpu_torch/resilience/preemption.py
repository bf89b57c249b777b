"""PreemptionGuard: turn SIGTERM into a durable checkpoint, not a corpse
(copy of ``deepspeed_tpu/resilience/preemption.py``, which imports no
JAX).

Pod schedulers (and the OOM killer's politer cousins) deliver SIGTERM
with a grace window before SIGKILL. We want the run to *keep going*
just long enough to reach the next GAS boundary and commit an emergency
checkpoint.

So the guard deliberately does NOT chain previous handlers on the first
signal: it flips a flag and returns, letting the training loop notice
at its next GAS boundary (``Engine`` checks :meth:`should_checkpoint`
there, saves, and commits under :attr:`save_deadline_s`). A second
signal means the grace window is closing faster than we can save — it
escalates: the previously-installed handler (or the default
disposition) runs, preserving "killed by SIGTERM" exit semantics. Each
notice and the escalation leave a flight-recorder record, and the
escalation dumps the ring (``observability/flight_recorder.py``, whose
own SIGTERM handler chains with this one in either order).

The guard is also the programmatic preemption entry point:
:meth:`request` lets the chaos harness and tests trigger the same path
without a real signal.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Listens for preemption notice and arranges an emergency save.

    Args:
      save_deadline_s: budget for the emergency save+commit once the
        engine reaches a GAS boundary. The engine passes it to the
        checkpoint commit wait; a blown deadline logs and proceeds to
        exit (a partial save is invisible to resume thanks to the
        manifest — see resilience/manifest.py).
      signals: which signals mean "preemption notice". SIGTERM by
        default; tests add SIGUSR1 to avoid racing the test runner.
    """

    def __init__(self, save_deadline_s: float = 60.0,
                 signals=(signal.SIGTERM,)):
        self.save_deadline_s = float(save_deadline_s)
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._handled = False
        self._installed = False
        self._prev = {}
        self._requested_at: Optional[float] = None
        self.reason: Optional[str] = None

    # -- state ---------------------------------------------------------
    @property
    def requested(self) -> bool:
        """True once a preemption notice has arrived."""
        return self._event.is_set()

    @property
    def requested_at(self) -> Optional[float]:
        return self._requested_at

    def should_checkpoint(self) -> bool:
        """True exactly once: the first boundary check after a notice.
        The engine calls this at each train_batch GAS boundary."""
        if self._event.is_set() and not self._handled:
            self._handled = True
            return True
        return False

    def reset(self) -> None:
        """Forget a handled notice (tests / multi-notice runs)."""
        self._event.clear()
        self._handled = False
        self._requested_at = None
        self.reason = None

    # -- triggering ----------------------------------------------------
    def request(self, reason: str = "programmatic") -> None:
        """Raise the preemption flag without a signal (chaos harness,
        cloud preemption-notice pollers)."""
        if self._event.is_set():
            return
        self.reason = reason
        self._requested_at = time.time()
        self._event.set()
        self._record("preempt_notice", reason=reason)
        logger.warning(
            f"resilience: preemption notice ({reason}); will "
            f"checkpoint at the next GAS boundary "
            f"(deadline {self.save_deadline_s:g}s)")

    # -- signal plumbing -----------------------------------------------
    def install(self) -> bool:
        """Install signal handlers (idempotent; main thread only —
        ``signal.signal`` raises elsewhere, in which case the guard still
        works via :meth:`request`). Returns True if handlers went in."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            logger.debug("resilience: PreemptionGuard signal install "
                         "skipped off the main thread")
            return False
        try:
            for sig in self.signals:
                self._prev[sig] = signal.getsignal(sig)
                signal.signal(sig, self._on_signal)
        except (ValueError, OSError) as e:
            logger.debug(f"resilience: PreemptionGuard install failed: {e}")
            self._prev.clear()
            return False
        self._installed = True
        return True

    def uninstall(self) -> None:
        """Restore previous handlers (tests)."""
        if not self._installed:
            return
        try:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
        except (ValueError, OSError):
            pass
        self._prev.clear()
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        if not self._event.is_set():
            # first notice: flag it and RETURN — no chaining, the run
            # must survive to the next GAS boundary to save.
            self.request(reason=f"signal {signum}")
            return
        # second notice: the grace window is closing — escalate through
        # the previous handler (flight recorder dump + kill) or default.
        logger.error("resilience: second preemption signal — escalating "
                     "to immediate shutdown")
        self._record("preempt_escalate", signum=signum)
        self._dump_flight("preempt_escalate")
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)
        else:
            try:
                signal.signal(signum, signal.SIG_DFL)
            except (ValueError, OSError):
                pass
            os.kill(os.getpid(), signum)

    # -- flight recorder (best-effort: a signal handler never raises) -----
    @staticmethod
    def _record(kind: str, **fields) -> None:
        try:
            from deepspeed_tpu_torch.observability.flight_recorder import \
                get_flight_recorder

            get_flight_recorder().record(kind, **fields)
        except Exception:
            pass

    @staticmethod
    def _dump_flight(reason: str) -> None:
        try:
            from deepspeed_tpu_torch.observability.flight_recorder import \
                dump_flight_recorder

            dump_flight_recorder(reason)
        except Exception:
            pass
