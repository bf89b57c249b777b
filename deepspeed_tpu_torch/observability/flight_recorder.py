"""Crash flight recorder: the last seconds of a worker, always on (copy
of ``deepspeed_tpu/observability/flight_recorder.py``).

A bounded, lock-cheap ring buffer of structured runtime events — step
entry/dispatch/drain from the training loop, every executed collective
from ``comm/comm.py``, compile activity, checkpoint/offload transitions,
serving steps — that costs one deque append per event while the run is
healthy and becomes the post-mortem when it is not. The ring dumps to
disk on:

* an uncaught exception (``sys.excepthook`` chain),
* SIGTERM (the preemption / OOM-killer path), and
* a stall-watchdog fire (``observability/watchdog.py`` calls
  :func:`dump_flight_recorder` from its report path),

answering "what happened in the last 2s before the hang" for a worker
whose JSONL metrics stream stops mid-step. Appends rely on the GIL-atomic
``deque.append`` (maxlen evicts the oldest) so the hot path takes no
lock; only ``dump``/``events`` snapshot under one.

The recorder is process-global (:func:`get_flight_recorder`) and
host-only, so host-side tooling can use it without importing torch.

SIGTERM chains in both orders with the preemption guard
(``resilience/preemption.py``): installed after the guard, the dump runs
and the guard's handler is called (a first notice checkpoints, a second
escalates); installed before it, the guard calls this handler when it
escalates.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.utils.logging import logger

DEFAULT_CAPACITY = 4096

# (monotonic-ordered wall-clock ts, kind, fields)
_Event = Tuple[float, str, Dict[str, Any]]


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 rank: Optional[int] = None,
                 run_dir: Optional[str] = None):
        self._ring: deque = deque(maxlen=max(0, int(capacity)) or 1)
        self.enabled = int(capacity) > 0
        self.rank = rank if rank is not None else _env_rank()
        self.run_dir = run_dir
        self._dump_lock = threading.Lock()
        self.dumps: Dict[str, str] = {}  # reason -> last written path
        # name -> zero-arg provider whose return value is embedded in
        # every dump (e.g. the request tracer's in-flight timelines);
        # providers run inside dump()'s try so a failing one cannot
        # break the post-mortem
        self._dump_context: Dict[str, Any] = {}

    # -- hot path ------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """One ring append; no lock, no I/O. Safe from any thread."""
        if not self.enabled:
            return
        self._ring.append((time.time(), kind, fields))

    def span(self, kind: str, **fields):
        """Context manager recording one event with a ``dur_ms`` field —
        the dispatch→completion span of the wrapped block (JAX's
        chrome_trace.py renders dur_ms events as Perfetto "X" slices on
        the overlap lanes). The
        event timestamp is the span START so lanes line up with the step
        timeline; one append at exit, same GIL-atomic hot path."""
        return _Span(self, kind, fields)

    def add_dump_context(self, name: str, provider) -> None:
        """Register a zero-arg callable whose result is embedded under
        ``name`` in every dump — live state (in-flight serving requests,
        scheduler occupancy, ...) that a ring of past events cannot
        carry. Last registration per name wins."""
        self._dump_context[name] = provider

    # -- configuration -------------------------------------------------
    def configure(self, capacity: Optional[int] = None,
                  rank: Optional[int] = None,
                  run_dir: Optional[str] = None) -> None:
        """Resize/re-point the recorder (engine init). Resizing keeps the
        newest events; capacity 0 disables recording entirely."""
        if capacity is not None and int(capacity) != self._ring.maxlen:
            self.enabled = int(capacity) > 0
            self._ring = deque(self._ring, maxlen=max(0, int(capacity)) or 1)
        if rank is not None:
            self.rank = int(rank)
        if run_dir:
            self.run_dir = run_dir

    # -- snapshots -----------------------------------------------------
    def events(self, last: int = 0) -> List[_Event]:
        with self._dump_lock:
            evs = list(self._ring)
        return evs[-last:] if last > 0 else evs

    def tail_lines(self, last: int = 32) -> str:
        """Human-formatted newest-last tail for stall/crash reports."""
        out = []
        for ts, kind, fields in self.events(last=last):
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            out.append(f"  {ts:.3f} {kind:<18} {kv}")
        return "\n".join(out)

    # -- dump ----------------------------------------------------------
    def _dump_dir(self) -> str:
        env = os.environ.get("DSTPU_FLIGHT_DIR")
        if env:
            return env
        if self.run_dir:
            return os.path.join(self.run_dir, "flight")
        if os.path.isdir(".git"):
            # bare default inside a repo checkout would litter the working
            # tree (and tempt a `git add .`) — park dumps under tmp instead
            import tempfile

            uid = os.getuid() if hasattr(os, "getuid") else 0
            return os.path.join(tempfile.gettempdir(),
                                f"dstpu_flight-{uid}")
        return "dstpu_flight"

    def dump(self, reason: str = "manual",
             path: Optional[str] = None, **extra) -> Optional[str]:
        """Write the ring (plus context) as one JSON file; returns the
        path, or None on failure — a dump must never raise into the
        crashing frame it is documenting."""
        try:
            with self._dump_lock:
                evs = list(self._ring)
            if path is None:
                d = self._dump_dir()
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"flight_rank{self.rank}_{reason}.json")
            doc = {
                "kind": "flight_recorder_dump",
                "reason": reason,
                "rank": self.rank,
                "pid": os.getpid(),
                "host": socket.gethostname(),
                "ts": time.time(),
                "n_events": len(evs),
                "events": [
                    {"ts": ts, "kind": kind, **fields}
                    for ts, kind, fields in evs
                ],
            }
            doc.update(extra)
            for name, provider in list(self._dump_context.items()):
                try:
                    doc[name] = provider()
                except Exception as e:  # context must never kill a dump
                    doc[name] = f"<dump context failed: {e}>"
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
            self.dumps[reason] = path
            # crash-path reasons shout; manual/planned dumps stay quiet
            level = logger.error if reason in (
                "exception", "sigterm", "watchdog") else logger.info
            level(f"flight recorder: dumped {len(evs)} events to {path} "
                  f"(reason: {reason})")
            return path
        except Exception as e:
            logger.warning(f"flight recorder dump failed: {e}")
            return None


class _Span:
    __slots__ = ("_rec", "_kind", "_fields", "_t0")

    def __init__(self, rec: "FlightRecorder", kind: str,
                 fields: Dict[str, Any]):
        self._rec = rec
        self._kind = kind
        self._fields = fields

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec.enabled:
            t0 = self._t0
            rec._ring.append((t0, self._kind, {
                **self._fields,
                "dur_ms": (time.time() - t0) * 1e3}))
        return False


def _env_rank() -> int:
    for var in ("RANK", "PROCESS_ID"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def reset_flight_recorder() -> None:
    """Drop the singleton (tests). Installed crash handlers keep working:
    they resolve the recorder at fire time."""
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = None


def dump_flight_recorder(reason: str, **extra) -> Optional[str]:
    """Module-level dump hook (watchdog, user code): dumps the current
    singleton if one exists and has events; never raises."""
    try:
        rec = get_flight_recorder()
        if not rec.events(last=1):
            return None
        return rec.dump(reason=reason, **extra)
    except Exception:
        return None


# -- crash handler installation ---------------------------------------------

_HANDLERS_INSTALLED = False
_HANDLERS_LOCK = threading.Lock()


def install_crash_handlers() -> None:
    """Dump the flight recorder on uncaught exception and SIGTERM.

    Idempotent; chains any previously-installed ``sys.excepthook`` and
    SIGTERM handler so launchers keep their exit semantics (e.g. a
    launcher's SIGTERM → ``sys.exit(143)``, or the preemption guard's
    checkpoint-then-escalate). SIGTERM install is
    skipped off the main thread — ``signal.signal`` raises there."""
    global _HANDLERS_INSTALLED
    with _HANDLERS_LOCK:
        if _HANDLERS_INSTALLED:
            return
        _HANDLERS_INSTALLED = True

    prev_hook = sys.excepthook

    def _hook(exc_type, exc, tb):
        dump_flight_recorder(
            "exception", exception=f"{exc_type.__name__}: {exc}")
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _hook

    if threading.current_thread() is not threading.main_thread():
        return
    try:
        prev_sig = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            dump_flight_recorder("sigterm")
            if callable(prev_sig):
                prev_sig(signum, frame)
            else:
                # restore the default disposition and re-raise so the
                # exit status stays "killed by SIGTERM"
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError) as e:  # non-main thread / exotic host
        logger.debug(f"flight recorder SIGTERM handler not installed: {e}")
