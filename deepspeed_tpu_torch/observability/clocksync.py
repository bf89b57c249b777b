"""Per-channel clock synchronization for the cross-process fleet (copy
of ``deepspeed_tpu/observability/clocksync.py``; the request tracer
reads its :func:`wall_time`, and its fleet callers come with ROADMAP
queue A item 13).

Request spans, load-report timestamps, and flight events all carry
wall-clock stamps from the process that produced them. On one host with
one clock that is exact; the moment the fleet leaves localhost (or a
worker's NTP steps its clock mid-run) the timelines stop being
comparable — a worker 250 ms ahead of the router renders its PREFILL
span *before* the ROUTE decision that caused it. This module closes
that gap with the NTP client discipline, scaled down to one estimator
per transport channel:

* :func:`wall_time` is the fleet's observability clock: ``time.time()``
  plus the ``DSTPU_CLOCK_SKEW_S`` env offset (read per call). Production
  code never sets the env var, so it IS ``time.time()``; chaos drills
  and the obs-fleet bench set it per process to inject a known skew and
  then assert the estimator recovers it.
* :class:`ClockSyncEstimator` consumes ping/pong round trips
  (``t0``: local send, ``t1``: peer receive, ``t2``: peer reply,
  ``t3``: local receive — all on :func:`wall_time`) injected by the
  transport layer (serving/transport/channel.py intercepts
  ``clock_ping``/``clock_pong`` messages below the message protocol, so
  every channel owner gets clock sync without protocol changes). Per
  sample: ``offset = ((t1 - t0) + (t2 - t3)) / 2`` (peer minus local),
  ``rtt = (t3 - t0) - (t2 - t1)``. The estimate is the **median offset
  of the K lowest-RTT samples** in a bounded window — the standard
  defense against queueing-delayed samples, which is exactly what a
  chaos ``net_delay_ms`` arm or a worker blocked in a multi-second JIT
  compile produces.
* The **uncertainty bound** is ``best_rtt / 2`` (the irreducible
  one-way-delay ambiguity: an adversarial asymmetric path can hide up
  to half the round trip) plus the dispersion of the voting offsets —
  honest even under asymmetric injected delay, where the point estimate
  is biased by up to half the asymmetry.
* **Drift** is an EWMA of offset change per second between re-sync
  rounds: a worker whose clock *rates* differently (not just steps)
  shows a nonzero drift long before the offset outgrows the bound.

Everything here is host-side and import-cheap — the channel
layer imports it on the first clock message, not at module load.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

SKEW_ENV = "DSTPU_CLOCK_SKEW_S"


def wall_time() -> float:
    """The observability wall clock: ``time.time()`` plus the injected
    per-process skew (``DSTPU_CLOCK_SKEW_S``, read per call so a test
    can *step* the clock mid-run). With the env unset this is exactly
    ``time.time()`` — zero-cost in the only path production takes."""
    skew = os.environ.get(SKEW_ENV)
    if not skew:
        return time.time()
    try:
        return time.time() + float(skew)
    except ValueError:
        return time.time()


class ClockSyncEstimator:
    """NTP-style offset estimator for one channel's peer.

    ``offset_s`` is *peer minus local*: a peer timestamp rebases into
    local time as ``local_ts = peer_ts - offset_s``. ``synced`` turns
    True after ``min_samples`` round trips; until then consumers must
    fall back to the raw timestamps (the bit-exact pre-clocksync
    behavior).

    Thread-safety: ``add_round_trip`` runs on the channel's receive
    thread while readers (router/supervisor) poll from theirs — one
    lock covers the sample window and the cached estimate.
    """

    def __init__(self, k: int = 5, window: int = 32,
                 min_samples: int = 3, drift_alpha: float = 0.2):
        self.k = max(1, int(k))
        self.window = max(self.k, int(window))
        self.min_samples = max(1, int(min_samples))
        self.drift_alpha = float(drift_alpha)
        self._lock = threading.Lock()
        # (rtt_s, offset_s, t3) tuples, newest last, bounded by window
        self._samples: List[Tuple[float, float, float]] = []
        self._offset = 0.0
        self._uncertainty = float("inf")
        self._drift = 0.0  # seconds of offset change per second
        self._last_estimate: Optional[Tuple[float, float]] = None
        self.n_samples = 0
        self.last_sync_mono = 0.0  # re-sync cadence (monotonic)

    # -- ingest --------------------------------------------------------
    def add_round_trip(self, t0: float, t1: float, t2: float,
                       t3: float) -> None:
        """One ping/pong sample. ``t0``/``t3`` are local send/receive
        stamps; ``t1``/``t2`` are the peer's receive/reply stamps. A
        nonsensical sample (negative RTT — a stepped clock mid-flight)
        is dropped rather than poisoning the window."""
        rtt = (t3 - t0) - (t2 - t1)
        if rtt < 0.0:
            return
        offset = ((t1 - t0) + (t2 - t3)) / 2.0
        with self._lock:
            self._samples.append((rtt, offset, t3))
            if len(self._samples) > self.window:
                self._samples = self._samples[-self.window:]
            self.n_samples += 1
            self.last_sync_mono = time.monotonic()
            self._recompute(t3)

    def _recompute(self, now: float) -> None:
        """Re-derive offset/uncertainty/drift from the window. Caller
        holds the lock."""
        if len(self._samples) < self.min_samples:
            return
        best = sorted(self._samples)[:self.k]  # lowest RTT first
        offsets = sorted(o for _, o, _ in best)
        mid = len(offsets) // 2
        est = (offsets[mid] if len(offsets) % 2
               else (offsets[mid - 1] + offsets[mid]) / 2.0)
        dispersion = max(offsets) - min(offsets)
        unc = best[0][0] / 2.0 + dispersion
        prev = self._last_estimate
        if prev is not None:
            dt = now - prev[1]
            if dt > 1e-3:
                rate = (est - prev[0]) / dt
                self._drift = (self.drift_alpha * rate
                               + (1.0 - self.drift_alpha) * self._drift)
        self._last_estimate = (est, now)
        self._offset = est
        self._uncertainty = unc

    def reset(self) -> None:
        """Drop the window (a stepped peer clock: re-converge from
        scratch rather than median across two clock regimes)."""
        with self._lock:
            self._samples.clear()
            self._offset = 0.0
            self._uncertainty = float("inf")
            self._drift = 0.0
            self._last_estimate = None

    # -- readout -------------------------------------------------------
    @property
    def synced(self) -> bool:
        with self._lock:
            return len(self._samples) >= self.min_samples

    @property
    def offset_s(self) -> float:
        """Peer clock minus local clock, in seconds (0.0 until
        synced)."""
        with self._lock:
            return self._offset if len(
                self._samples) >= self.min_samples else 0.0

    @property
    def uncertainty_s(self) -> float:
        with self._lock:
            return (self._uncertainty
                    if len(self._samples) >= self.min_samples
                    else float("inf"))

    @property
    def drift(self) -> float:
        """EWMA of offset change per second across re-sync rounds."""
        with self._lock:
            return self._drift

    def rebase(self, peer_ts: float) -> float:
        """A peer wall-clock timestamp in local time (identity until
        synced)."""
        return peer_ts - self.offset_s

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            synced = len(self._samples) >= self.min_samples
            return {
                "synced": synced,
                "offset_ms": round(self._offset * 1e3, 4) if synced
                else None,
                "uncertainty_ms": round(self._uncertainty * 1e3, 4)
                if synced else None,
                "drift_ppm": round(self._drift * 1e6, 3),
                "samples": self.n_samples,
                "window": len(self._samples),
            }
