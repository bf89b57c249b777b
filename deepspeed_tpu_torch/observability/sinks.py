"""Metrics sinks: JSON-lines stream + Prometheus text exposition (copy
of ``deepspeed_tpu/observability/sinks.py``, host-only Python).

Two export shapes the monitor backends (CSV/TensorBoard/W&B,
``deepspeed_tpu_torch/monitor``) don't cover:

* ``JSONLSink`` — one JSON object per line, appended and flushed per
  record, so a crashed or stalled run leaves a machine-readable trail up
  to its last completed step (the post-mortem artifact the stall
  watchdog points at).
* ``PrometheusTextSink`` — node-exporter *textfile collector* format:
  the full current snapshot is rewritten atomically (tmp + rename) so a
  scraper never reads a torn file. No HTTP server runs in the
  training process; the textfile handoff is the standard pattern.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str, prefix: str = "dstpu") -> str:
    """'serve.ttft_seconds' -> 'dstpu_serve_ttft_seconds'."""
    clean = _NAME_RE.sub("_", name.replace(".", "_").replace("/", "_"))
    if clean and clean[0].isdigit():
        clean = "_" + clean  # exposition names must not start with a digit
    return f"{prefix}_{clean}" if prefix else clean


def escape_label_value(value: str) -> str:
    """Prometheus text-exposition label escaping: backslash, double
    quote, and newline (in that order — escaping the escapes first).
    Label values are arbitrary strings here (telemetry *reason* text),
    and a raw newline or quote would corrupt the whole exposition file
    for every scraper."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def labeled_name(name: str, labels: Optional[Dict[str, str]]) -> str:
    """Compose a registry key that carries Prometheus labels:
    ``labeled_name('serve.queue_depth', {'replica': 'r0'})`` ->
    ``serve.queue_depth{replica="r0"}``. Values are escaped here, at
    composition time, so the renderer can paste the label part through
    verbatim. Per-replica serving metrics use this so fleet aggregation
    does not collapse N replicas into one series."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def split_labeled_name(name: str):
    """Inverse of the composition above: ``(base, label_part)`` where
    ``label_part`` is ``'{...}'`` or ``''``. The base goes through
    ``prometheus_name`` (which strips braces); the label part does not."""
    i = name.find("{")
    if i < 0:
        return name, ""
    return name[:i], name[i:]


class JSONLSink:
    """Append-and-flush JSON-lines writer (one record per call)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1)
        self._failed = False

    def write(self, record: Dict[str, Any]) -> None:
        if self._failed:
            return
        try:
            line = json.dumps(record, default=_json_default)
            with self._lock:
                self._fh.write(line + "\n")
                self._fh.flush()
        except Exception as e:  # a full disk must not kill training
            self._failed = True
            logger.warning(f"JSONL metrics sink disabled after error: {e}")

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except Exception:
                pass


def _json_default(obj):
    # numpy scalars / 0-dim tensors → python numbers; anything else → str
    for attr in ("item",):
        if hasattr(obj, attr):
            try:
                return obj.item()
            except Exception:
                pass
    return str(obj)


def render_prometheus(gauges: Dict[str, float], counters: Dict[str, float],
                      histograms: Dict[str, Any],
                      labeled_counters: Optional[
                          Dict[str, Dict[str, float]]] = None) -> str:
    """Render a metrics snapshot in Prometheus text exposition format.

    ``histograms`` maps name -> Histogram (duck-typed: needs
    ``prometheus_lines``). ``labeled_counters`` maps a metric name to
    ``{label_value: count}`` rendered with a ``name`` label (used for
    the capability-fallback telemetry counters).
    """
    lines = [f"# dstpu metrics snapshot ts={time.time():.3f}"]
    # registry keys may carry labels (``name{k="v"}``, composed by
    # labeled_name): the base goes through prometheus_name, the label
    # part is pasted through (values were escaped at composition time),
    # and the TYPE line is emitted once per base
    typed = set()
    for name in sorted(gauges):
        base, label = split_labeled_name(name)
        m = prometheus_name(base)
        if m not in typed:
            typed.add(m)
            lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{label} {gauges[name]:.6g}")
    typed = set()
    for name in sorted(counters):
        base, label = split_labeled_name(name)
        m = prometheus_name(base)
        if not m.endswith("_total"):
            m += "_total"
        if m not in typed:
            typed.add(m)
            lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}{label} {counters[name]:.6g}")
    for name, per_label in sorted((labeled_counters or {}).items()):
        m = prometheus_name(name)
        if not m.endswith("_total"):
            m += "_total"
        lines.append(f"# TYPE {m} counter")
        for label, v in sorted(per_label.items()):
            lines.append(f'{m}{{name="{escape_label_value(label)}"}} '
                         f'{v:.6g}')
    typed = set()
    for name, hist in sorted(histograms.items()):
        base, label = split_labeled_name(name)
        rendered = hist.prometheus_lines(prometheus_name(base))
        if label:
            rendered = [_inject_labels(ln, label[1:-1]) for ln in rendered]
        for ln in rendered:  # one TYPE line per base across label sets
            if ln.startswith("# TYPE"):
                if ln in typed:
                    continue
                typed.add(ln)
            lines.append(ln)
    return "\n".join(lines) + "\n"


def _inject_labels(line: str, inner: str) -> str:
    """Merge ``inner`` (``k="v",...``) into one exposition line: before
    existing labels (``m_bucket{le="x"} v``) or as a fresh label set
    (``m_sum v``). Comment lines pass through."""
    if line.startswith("#"):
        return line
    if "{" in line:
        return line.replace("{", "{" + inner + ",", 1)
    name, _, rest = line.partition(" ")
    return f"{name}{{{inner}}} {rest}"


class PrometheusTextSink:
    """Atomic whole-file snapshot writer (textfile-collector handoff)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._failed = False

    def write_text(self, text: str) -> None:
        if self._failed:
            return
        try:
            with self._lock:
                d = os.path.dirname(os.path.abspath(self.path))
                fd, tmp = tempfile.mkstemp(dir=d, suffix=".prom.tmp")
                try:
                    with os.fdopen(fd, "w") as f:
                        f.write(text)
                    os.replace(tmp, self.path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        except Exception as e:
            self._failed = True
            logger.warning(f"Prometheus metrics sink disabled after "
                           f"error: {e}")
