"""Asynchronous host <-> NVMe swap of flat host tensors (port of
``deepspeed_tpu/runtime/swap_tensor/swapper.py``).

  * ``SwapBufferPool``     — a fixed pool of page-aligned staging buffers
    (reference swap_tensor/utils.py SwapBufferPool).
  * ``AsyncTensorSwapper`` — swap-outs and swap-ins queued, completion
    deferred to ``wait`` (reference async_swapper.py:19).
  * ``TensorSwapStore``    — named flat tensors, one file each under a
    folder, swapped in and out whole or by a range of elements
    (reference partitioned_optimizer_swapper.py:27). The offload
    optimizer keeps each leaf's master and moments here on the NVMe tier
    and streams them through in chunks.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.native.aio import AsyncIOHandle, PinnedBuffer


class SwapBufferPool:
    """``count`` page-aligned buffers of ``elems`` elements each."""

    def __init__(self, count: int, elems: int,
                 dtype: torch.dtype = torch.float32):
        self.elems = int(elems)
        self.dtype = dtype
        itemsize = torch.empty((), dtype=dtype).element_size()
        self._buffers = [PinnedBuffer(self.elems * itemsize, dtype)
                         for _ in range(count)]
        self._free = list(range(count))

    def get(self) -> Tuple[int, torch.Tensor]:
        if not self._free:
            raise RuntimeError("swap buffer pool exhausted")
        i = self._free.pop()
        return i, self._buffers[i].tensor

    def put(self, i: int) -> None:
        self._free.append(i)

    def available(self) -> int:
        return len(self._free)

    def free(self) -> None:
        for b in self._buffers:
            b.free()
        self._buffers = []
        self._free = []


class AsyncTensorSwapper:
    """Queue swaps; ``wait`` completes them and raises on any failure."""

    def __init__(self, aio: Optional[AsyncIOHandle] = None):
        self.aio = aio or AsyncIOHandle()
        self._inflight: List[str] = []

    def swap_out(self, t: torch.Tensor, path: str) -> None:
        self.aio.async_pwrite(t, path)
        self._inflight.append(path)

    def swap_in(self, t: torch.Tensor, path: str) -> None:
        self.aio.async_pread(t, path)
        self._inflight.append(path)

    def wait(self) -> None:
        errs = self.aio.wait()
        inflight, self._inflight = self._inflight, []
        if errs:
            # the native layer reports a count, not which request failed
            raise IOError(f"tensor swap failed: {errs} of {len(inflight)} "
                          f"requests errored (in-flight: {inflight})")


class TensorSwapStore:
    """Named flat tensors swapped to one file each under ``folder``.

    ``register`` writes a tensor once (``reserve`` only names its size);
    ``swap_in`` / ``swap_out`` move the whole tensor, or the elements
    from ``offset`` on (as many as the given tensor holds). ``sync=False`` leaves a write in flight until
    the next ``wait`` (or synchronous call): its tensor must not change
    before then.
    """

    def __init__(self, folder: str, aio: Optional[AsyncIOHandle] = None):
        self.folder = folder
        os.makedirs(folder, exist_ok=True)
        self.aio = aio or AsyncIOHandle()
        self._meta: Dict[str, Tuple[int, torch.dtype]] = {}

    def _path(self, name: str) -> str:
        safe = name.replace("/", "_").replace(".", "_")
        return os.path.join(self.folder, f"{safe}.swp")

    def _byte_offset(self, name: str, t: torch.Tensor, offset: int) -> int:
        size, dtype = self._meta[name]
        if t.dtype != dtype or offset < 0 or offset + t.numel() > size:
            raise ValueError(
                f"swap {name!r}: {t.numel()} {t.dtype} elements at "
                f"{offset} do not fit the stored {size} {dtype}")
        return offset * t.element_size()

    def register(self, name: str, t: torch.Tensor, sync: bool = False) -> None:
        """The first write of ``name``; afterwards the host copy may go."""
        self._meta[name] = (t.numel(), t.dtype)
        self.aio.async_pwrite(t.reshape(-1), self._path(name))
        if sync:
            self._wait()

    def reserve(self, name: str, numel: int, dtype: torch.dtype) -> None:
        """Name a tensor of ``numel`` elements whose ranges are written
        later (``swap_out`` with an offset); nothing is written now."""
        self._meta[name] = (int(numel), dtype)

    def contains(self, name: str) -> bool:
        return name in self._meta

    def swap_in(self, name: str, out: Optional[torch.Tensor] = None,
                offset: int = 0, sync: bool = True) -> torch.Tensor:
        size, dtype = self._meta[name]
        if out is None:
            out = torch.empty(size - offset, dtype=dtype)
        self.aio.async_pread(out, self._path(name),
                             self._byte_offset(name, out, offset))
        if sync:
            self._wait()
        return out

    def swap_out(self, name: str, t: torch.Tensor, offset: int = 0,
                 sync: bool = False) -> None:
        if name not in self._meta and offset == 0:
            self.register(name, t, sync)
            return
        self.aio.async_pwrite(t, self._path(name),
                              self._byte_offset(name, t, offset))
        if sync:
            self._wait()

    def wait(self) -> None:
        self._wait()

    def _wait(self) -> None:
        errs = self.aio.wait()
        if errs:
            raise IOError(f"swap store I/O failed ({errs} errors)")

    def nbytes(self) -> int:
        return sum(s * torch.empty((), dtype=d).element_size()
                   for s, d in self._meta.values())

    def purge(self) -> None:
        """Delete every file of the store."""
        for name in self._meta:
            try:
                os.unlink(self._path(name))
            except FileNotFoundError:
                pass
        self._meta.clear()


__all__ = ["SwapBufferPool", "AsyncTensorSwapper", "TensorSwapStore"]
