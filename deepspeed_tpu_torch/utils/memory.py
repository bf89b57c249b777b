"""Memory breadcrumbs (port of ``deepspeed_tpu/utils/memory.py``).

Reference: ``see_memory_usage`` (deepspeed/utils/timer.py + engine
breadcrumbs) prints allocated/reserved accelerator memory and host RSS at
checkpoints through engine construction; gated by the ``memory_breakdown``
config.

The device numbers come from the CUDA caching allocator's counters
(``torch.cuda.memory_stats``, host-side bookkeeping: no device sync) under
JAX's key names: ``bytes_in_use`` (allocated now), ``peak_bytes_in_use``
(the allocator's peak since the last ``reset_peak_memory_stats``) and
``bytes_limit`` (the card's memory, ``get_device_properties``). JAX's
``largest_free_block`` has no counterpart; ``reserved_gb`` (what the
allocator holds from CUDA) stands beside them. Host RSS comes from
/proc. A CPU device has no device section (JAX: the CPU simulator).
"""

from __future__ import annotations

from typing import Optional

from deepspeed_tpu_torch.utils.logging import logger


def _host_mem_gb() -> dict:
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS", "VmHWM")):
                    k, v = line.split(":", 1)
                    out[k] = round(int(v.split()[0]) / 1024 / 1024, 2)
    except OSError:
        pass
    return out


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's allocator counters in GB (JAX's keys), or None for a
    CPU device or without CUDA. ``device`` defaults to the current
    card."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    gb = 1024 ** 3
    limit = torch.cuda.get_device_properties(
        device if device is not None else torch.cuda.current_device()
    ).total_memory
    return {
        "in_use_gb": round(stats.get("allocated_bytes.all.current", 0) / gb,
                           3),
        "peak_gb": round(stats.get("allocated_bytes.all.peak", 0) / gb, 3),
        "limit_gb": round(limit / gb, 3),
        "reserved_gb": round(stats.get("reserved_bytes.all.current", 0) / gb,
                             3),
    }


MEMORY_BREAKDOWN = False  # set from config.memory_breakdown at engine init


def configure(enabled: bool) -> None:
    global MEMORY_BREAKDOWN
    MEMORY_BREAKDOWN = bool(enabled)


def see_memory_usage(message: str, force: bool = False,
                     device=None) -> Optional[dict]:
    """Log device + host memory with ``message`` (reference signature:
    breadcrumbs are no-ops unless force or memory_breakdown config)."""
    if not (force or MEMORY_BREAKDOWN):
        return None
    dev = device_memory_stats(device)
    host = _host_mem_gb()
    parts = [message]
    if dev:
        parts.append(f"device in_use={dev['in_use_gb']}GB "
                     f"peak={dev['peak_gb']}GB limit={dev['limit_gb']}GB")
    if host:
        parts.append(f"host rss={host.get('VmRSS')}GB "
                     f"hwm={host.get('VmHWM')}GB")
    logger.info(" | ".join(parts))
    return dev
