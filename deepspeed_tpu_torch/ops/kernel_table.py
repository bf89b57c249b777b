"""Per-(kernel, shape-bucket) win/loss table behind ``impl="auto"``
(port of ``deepspeed_tpu/ops/kernel_table.py``).

``tools/kernel_bench.py`` times each hand-written kernel against the path
the dispatch falls back to, per shape bucket, and records the result
here; ``ops/registry.py`` consults the table at dispatch time, after the
compat probe: a kernel runs on a bucket only when its measured win ratio
(xla_ms / kernel_ms) is >= 1.0 there.

The schema is JAX's ``kernel_table/v1``, so either package reads the
other's files::

    {"_meta": {"schema": "kernel_table/v1"},
     "entries": {
       "flash_attention": {
         "s2048_d128_causal": {"kernel_ms": 0.9, "xla_ms": 4.1,
                               "ratio": 4.56, "backend": "cuda",
                               "device": "NVIDIA H100 80GB HBM3",
                               "blocks": {"template": "wgmma"}}}}}

Rows are scoped by backend: ``"cuda"`` or ``"cpu"`` here (JAX writes
``"tpu"`` and ``"cpu"``). A ``"cuda"`` row also names the card it was
measured on; a row from another backend, another card, or a ``"cuda"``
row that names none counts as unmeasured. The default table is the
port's own ``deepspeed_tpu_torch/kernel_table.json``, never the JAX
package's TPU table; ``DSTPU_KERNEL_TABLE`` overrides the path. A missing
or malformed table means "unmeasured" and never raises.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch

SCHEMA = "kernel_table/v1"

DEFAULT_TABLE = str(Path(__file__).resolve().parents[1]
                    / "kernel_table.json")

_LOCK = threading.Lock()
_CACHE: Dict[str, Optional[Dict[str, Any]]] = {}
# bumped by every invalidate_cache: memos of decisions compare it
_GENERATION = 0


def table_path() -> str:
    return os.environ.get("DSTPU_KERNEL_TABLE", DEFAULT_TABLE)


def invalidate_cache() -> None:
    """Drop the parsed-table cache (tests swap tables via env var) and
    every memo of decisions taken from it."""
    global _GENERATION
    with _LOCK:
        _CACHE.clear()
        _GENERATION += 1


def generation() -> int:
    """How many times the cache was dropped (a memo keyed on it goes
    stale with the tables it was read from)."""
    return _GENERATION


def load_table(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Parsed table dict, or None when absent or unreadable (never
    raises: a missing table degrades to the heuristic)."""
    p = path or table_path()
    with _LOCK:
        if p in _CACHE:
            return _CACHE[p]
    try:
        with open(p) as f:
            data = json.load(f)
        if not isinstance(data, dict) or "entries" not in data:
            data = None
    except (OSError, ValueError):
        data = None
    with _LOCK:
        _CACHE[p] = data
    return data


# ---------------------------------------------------------------------------
# shape bucketing (JAX's keys, so the two packages' tables line up)
# ---------------------------------------------------------------------------


def bucket_pow2(n: int, lo: int = 128) -> int:
    """Round ``n`` up to a power of two (floor ``lo``)."""
    b = lo
    while b < n:
        b *= 2
    return b


def attention_bucket(seq: int, head_dim: int, causal: bool) -> str:
    """Bucket key for the attention kernels; batch and head count are
    folded out."""
    return (f"s{bucket_pow2(seq)}_d{head_dim}"
            f"_{'causal' if causal else 'full'}")


def gmm_bucket(m: int, k: int, n: int, groups: int) -> str:
    """Bucket key for the grouped matmul: token rows bucket to powers of
    two; k, n and the group count are architecture constants."""
    return f"m{bucket_pow2(m)}_k{k}_n{n}_g{groups}"


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TableDecision:
    measured: bool
    win: bool
    ratio: Optional[float]
    blocks: Optional[Dict[str, Any]]
    reason: str


def default_backend() -> str:
    """Where the port's entry points run by default: "cuda" when there is
    a card, else "cpu"."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@functools.lru_cache(None)
def card_name(index: Optional[int] = None) -> str:
    """The card's name as ``torch.cuda.get_device_name`` gives it (the
    current device by default)."""
    return torch.cuda.get_device_name(index)


def decide(kernel: str, bucket: str, path: Optional[str] = None,
           backend: Optional[str] = None) -> TableDecision:
    """Look up (kernel, bucket) for ``backend`` (default:
    ``default_backend()``; the dispatch passes the tensors' device type).

    Measured -> win iff ratio >= 1.0 (ratio = xla_ms / kernel_ms; the
    kernel must at least tie). Unmeasured -> the caller falls back to its
    heuristic."""
    here = backend or default_backend()
    data = load_table(path)
    if data is None:
        return TableDecision(False, False, None, None, "no kernel table")
    entry = (data.get("entries") or {}).get(kernel, {}).get(bucket)
    if not isinstance(entry, dict):
        return TableDecision(False, False, None, None,
                             f"bucket {bucket} unmeasured")
    be = entry.get("backend")
    if be is not None and be != here:
        return TableDecision(
            False, False, None, None,
            f"bucket {bucket} measured on {be}, running on {here}")
    if here == "cuda":
        card = entry.get("device")
        if card != card_name():
            return TableDecision(
                False, False, None, None,
                f"bucket {bucket} measured on cuda card {card!r}, running "
                f"on {card_name()!r}")
    try:
        ratio = float(entry["ratio"])
    except (KeyError, TypeError, ValueError):
        return TableDecision(False, False, None, None,
                             f"bucket {bucket} entry malformed")
    blocks = entry.get("blocks")
    if not isinstance(blocks, dict):
        blocks = None
    win = ratio >= 1.0
    verdict = "win" if win else "loss"
    return TableDecision(True, win, ratio, blocks,
                         f"measured {verdict} ratio {ratio:.2f} on {bucket}")


def record(kernel: str, bucket: str, kernel_ms: float, xla_ms: float,
           blocks: Optional[Dict[str, Any]] = None,
           backend: Optional[str] = None,
           path: Optional[str] = None,
           device: Optional[str] = None) -> Dict[str, Any]:
    """Persist one measurement (read-modify-write; the kernel bench calls
    this per bucket). A ``"cuda"`` row names its card (``device``,
    default the current card). Returns the entry written."""
    p = path or table_path()
    be = backend or default_backend()
    try:
        with open(p) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            data = {}
    except (OSError, ValueError):
        data = {}
    data.setdefault("_meta", {})["schema"] = SCHEMA
    entry = {
        "kernel_ms": round(float(kernel_ms), 4),
        "xla_ms": round(float(xla_ms), 4),
        "ratio": round(float(xla_ms) / max(float(kernel_ms), 1e-9), 4),
        "backend": be,
    }
    if be == "cuda":
        entry["device"] = device or card_name()
    if blocks:
        entry["blocks"] = {k: (v if isinstance(v, str) else int(v))
                           for k, v in blocks.items()}
    data.setdefault("entries", {}).setdefault(kernel, {})[bucket] = entry
    Path(p).parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    invalidate_cache()
    return entry


__all__ = ["SCHEMA", "DEFAULT_TABLE", "table_path", "invalidate_cache",
           "generation",
           "load_table", "bucket_pow2", "attention_bucket", "gmm_bucket",
           "TableDecision", "default_backend", "card_name", "decide",
           "record"]
