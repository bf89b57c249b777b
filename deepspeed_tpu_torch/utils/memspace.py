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

The asynchronous moves of the streamed paths (the FPDT KV tiles and
residual chunks, the layer stack of ``offload_param``, the offloaded
activation saves) go through one side stream a card (``copy_stream``):
``fetch`` copies pinned host memory to the card and ``offload`` the card
to fresh pinned host memory, each returning a ``Transfer`` whose event
the consumer waits on (``wait`` on the compute stream, ``host_wait`` on
the host). The source (and a fetched tensor) is marked with
``record_stream`` so that the allocator does not hand its memory out
before the copy is done. On the CPU the moves are plain copies.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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


_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
# bytes moved by ``fetch`` (host -> card) and ``offload`` (card -> host)
# since the last ``reset_transfer_stats``
TRANSFER_STATS = {"to_device_bytes": 0, "to_host_bytes": 0}


def reset_transfer_stats() -> None:
    TRANSFER_STATS.update(to_device_bytes=0, to_host_bytes=0)


def copy_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """The side stream of the card ``device`` that carries the streamed
    paths' copies (one a card, made at first use); None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


class Transfer:
    """A copy issued on the copy stream: ``tensor`` is its destination,
    valid on the compute stream after ``wait()`` and on the host after
    ``host_wait()``."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event=None):
        self.tensor, self.event = tensor, event

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            torch.cuda.current_stream(self.event.device).wait_event(
                self.event)
        return self.tensor

    def host_wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.tensor


def fetch(host: torch.Tensor, device: torch.device,
          dtype: Optional[torch.dtype] = None) -> Transfer:
    """``host`` (pinned host memory) copied to ``device`` on its copy
    stream, cast to ``dtype`` on the card; off the card a plain copy."""
    device = torch.device(device)
    TRANSFER_STATS["to_device_bytes"] += host.numel() * host.element_size()
    stream = copy_stream(device)
    if stream is None:
        return Transfer(host.to(device, dtype or host.dtype, copy=True))
    cur = torch.cuda.current_stream(device)
    raw = torch.empty(host.shape, dtype=host.dtype, device=device)
    stream.wait_stream(cur)  # raw's memory is free on the compute stream
    with torch.cuda.stream(stream):
        raw.copy_(host, non_blocking=True)
        out = raw
        if dtype is not None and dtype != raw.dtype:
            out = raw.to(dtype)
            out.record_stream(cur)
        ev = torch.cuda.Event()
        ev.record(stream)
    raw.record_stream(stream)
    return Transfer(out, ev)


def offload(t: torch.Tensor, dtype: Optional[torch.dtype] = None,
            out: Optional[torch.Tensor] = None) -> Transfer:
    """The card tensor ``t`` copied into pinned host memory (``out``, or
    a fresh tensor of ``dtype``) on its copy stream, after the compute
    stream's work so far; off the card a plain copy."""
    dtype = dtype or t.dtype
    TRANSFER_STATS["to_host_bytes"] += t.numel() * dtype.itemsize
    stream = copy_stream(t.device)
    if stream is None:
        if out is None:
            return Transfer(t.detach().to("cpu", dtype, copy=True))
        return Transfer(out.copy_(t.detach()))
    if out is None:
        out = torch.empty(t.shape, dtype=dtype, pin_memory=True)
    src = t.detach()
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        out.copy_(src if src.dtype == dtype else src.to(dtype),
                  non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
    src.record_stream(stream)
    return Transfer(out, ev)


__all__ = ["KINDS", "memories_supported", "put", "put_tree",
           "memory_kind_of", "is_on_host", "copy_stream", "Transfer",
           "fetch", "offload", "TRANSFER_STATS", "reset_transfer_stats"]
