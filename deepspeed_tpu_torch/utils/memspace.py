"""Host and device placement of tensors (port of
``deepspeed_tpu/utils/memspace.py``).

Two kinds, as in JAX: ``"device"`` (the card) and ``"pinned_host"``
(page-locked host memory, which the card reads and writes by DMA and
which ``non_blocking`` copies need to overlap). Pinning exists only where
CUDA does: a PyTorch built for the CPU cannot pin (``pin_memory()``
raises there). So on such a build, as on JAX's CPU simulator, the host
and the device are one memory: ``put(t, "pinned_host")`` keeps ``t`` in
plain host memory, ``memory_kind_of`` reports ``"unpinned_host"`` (the
kind JAX reports for its CPU arrays) and ``is_on_host`` is False; the
numerics are unchanged. This is the degradation contract of the JAX
module's docstring.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from deepspeed_tpu_torch.runtime.optimizer import tree_map

KINDS = ("device", "pinned_host")


def memories_supported() -> bool:
    """True when host and device are distinct memories (a CUDA build
    with a card)."""
    return torch.cuda.is_available()


def put(t: torch.Tensor, kind: str, device: Optional[torch.device] = None,
        non_blocking: bool = False) -> torch.Tensor:
    """``t`` in memory of ``kind``: ``"pinned_host"`` (pinned where CUDA
    can pin, else plain host memory) or ``"device"`` (``device``, the
    card by default; a no-op on a tensor already there)."""
    if kind not in KINDS:
        raise ValueError(f"memory kind must be one of {KINDS}, got {kind!r}")
    if kind == "device":
        dev = torch.device("cuda" if device is None else device)
        return t.to(dev, non_blocking=non_blocking)
    if not memories_supported():
        return t.to("cpu")
    if t.device.type == "cpu" and t.is_pinned():
        return t
    # straight into page-locked memory: no pageable copy in between
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=non_blocking)


def put_tree(tree: Any, kind: str, device: Optional[torch.device] = None,
             non_blocking: bool = False) -> Any:
    return tree_map(lambda t: put(t, kind, device, non_blocking), tree)


def memory_kind_of(t: Any) -> Optional[str]:
    """``"device"``, ``"pinned_host"`` or ``"unpinned_host"``; None for
    what is not a tensor."""
    if not isinstance(t, torch.Tensor):
        return None
    if t.device.type != "cpu":
        return "device"
    return ("pinned_host" if memories_supported() and t.is_pinned()
            else "unpinned_host")


def is_on_host(t: Any) -> bool:
    """True when ``t`` demonstrably lives in pinned host memory; always
    False where host and device are one memory."""
    return memory_kind_of(t) == "pinned_host"


__all__ = ["KINDS", "memories_supported", "put", "put_tree",
           "memory_kind_of", "is_on_host"]
