"""Fixed-bucket latency histograms with percentile readout (copy of
``deepspeed_tpu/observability/histogram.py``, host-only Python; a value
past ``hi`` lands in the overflow bucket, where JAX's index raises).

Serving latency (TTFT, per-decode-token) needs percentiles, not means —
a t-digest would be exact but is more state than the job needs: a
geometric bucket ladder bounds the relative error of any percentile by
the bucket growth factor, costs O(1) per observe, and renders directly
as a Prometheus histogram (cumulative ``le`` buckets). Reference analog:
the FastGen benchmark suite reports P50/P90/P95 token latencies
(DeepSpeed-MII benchmarks); here the histogram is a first-class runtime
object exported via the observability hub.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class Histogram:
    """Geometric fixed-bucket histogram.

    Bucket upper bounds are ``lo * growth**i`` for i in [0, n); values
    below ``lo`` land in bucket 0, values >= the last bound in an
    overflow bucket. With the default growth of 1.15, any percentile is
    reproduced within ~7% relative error (half a bucket), which is
    plenty for latency SLO work.
    """

    def __init__(self, name: str, unit: str = "seconds",
                 lo: float = 1e-5, hi: float = 1e3,
                 growth: float = 1.15):
        assert growth > 1.0 and hi > lo > 0.0
        self.name = name
        self.unit = unit
        self._lo = lo
        self._growth = growth
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        self._bounds = [lo * growth ** i for i in range(n)]  # upper bounds
        self._counts = [0] * (n + 1)  # +1 overflow bucket
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _bucket_index(self, value: float) -> int:
        if value < self._lo:
            return 0
        # log-index is O(1) vs bisect's O(log n); clamp for float fuzz
        i = int(math.log(value / self._lo) / math.log(self._growth)) + 1
        # past the last bound: the overflow bucket (JAX's index runs off
        # the ladder there and raises)
        i = min(i, len(self._bounds))
        if i < len(self._bounds) and value > self._bounds[i]:
            i += 1
        elif i > 0 and value <= self._bounds[i - 1]:
            i -= 1
        return min(i, len(self._counts) - 1)

    def observe(self, value: float) -> None:
        value = float(value)
        if not math.isfinite(value) or value < 0:
            return
        with self._lock:
            self._counts[self._bucket_index(value)] += 1
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)

    def percentile(self, p: float) -> float:
        """Value at percentile ``p`` in [0, 100], linearly interpolated
        inside the containing bucket. 0.0 when empty."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = p / 100.0 * self.count
            seen = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if seen + c >= rank:
                    lo = self._lo * self._growth ** (i - 1) if i > 0 else 0.0
                    hi = (self._bounds[i] if i < len(self._bounds)
                          else (self.max if self.max is not None else lo))
                    lo = max(lo, self.min or 0.0) if seen == 0 else lo
                    hi = min(hi, self.max) if self.max is not None else hi
                    frac = (rank - seen) / c
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                seen += c
            return self.max or 0.0

    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        """Count/sum/min/max/mean plus p50/p95/p99."""
        out = {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.mean(), 6),
            "min": round(self.min, 6) if self.min is not None else 0.0,
            "max": round(self.max, 6) if self.max is not None else 0.0,
        }
        for p in (50, 95, 99):
            out[f"p{p}"] = round(self.percentile(p), 6)
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self.count = 0
            self.sum = 0.0
            self.min = None
            self.max = None

    # -- Prometheus text rendering ------------------------------------
    def prometheus_lines(self, metric_name: str) -> List[str]:
        """Cumulative-bucket exposition lines (TYPE histogram)."""
        lines = [f"# TYPE {metric_name} histogram"]
        with self._lock:
            cum = 0
            # collapse empty leading/trailing ladder: emit only buckets
            # up to the last non-empty one (plus +Inf) to keep the page
            # readable; cumulative semantics stay exact
            last = max((i for i, c in enumerate(self._counts) if c), default=-1)
            for i in range(last + 1):
                cum += self._counts[i]
                le = (self._bounds[i] if i < len(self._bounds) else "+Inf")
                le_s = f"{le:.6g}" if isinstance(le, float) else le
                lines.append(
                    f'{metric_name}_bucket{{le="{le_s}"}} {cum}')
            lines.append(f'{metric_name}_bucket{{le="+Inf"}} {self.count}')
            lines.append(f"{metric_name}_sum {self.sum:.6g}")
            lines.append(f"{metric_name}_count {self.count}")
        return lines
