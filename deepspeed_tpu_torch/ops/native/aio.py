"""Asynchronous file I/O of host tensors (port of
``deepspeed_tpu/ops/native/aio.py``).

``AsyncIOHandle`` queues reads and writes of contiguous CPU tensors
(``async_pread`` / ``async_pwrite`` at a byte offset of the file) and
``wait`` blocks for all of them, returning the count of failed requests,
as the reference ``aio_handle``. Backends, with JAX's selection:
``"uring"`` (io_uring, strict: raises where the kernel refuses it),
``"threads"`` (the native pthread pool, which splits each request into
``block_size`` chunks), ``"auto"`` (io_uring where it is available, else
the pool), all three in ``csrc/aio/dstpu_aio.cpp``; and ``"python"``, a
thread pool in Python, taken where the native library is missing (as in
JAX) or when asked for. ``DSTPU_AIO_BACKEND`` sets the default.

``PinnedBuffer`` is a page-aligned host allocation (mlocked where the
limit allows) exposed as a tensor: the native layer opens a file with
``O_DIRECT`` when the buffer address and the size are 512-byte aligned.
"""

from __future__ import annotations

import concurrent.futures as _fut
import ctypes
import os
from typing import List, Optional

import torch

from deepspeed_tpu_torch.ops.native.builder import build_native_lib

DEFAULT_BLOCK_SIZE = 1 << 20
DEFAULT_QUEUE_DEPTH = 32
DEFAULT_THREADS = 8


def _host_bytes(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError("aio buffers must be contiguous CPU tensors, got "
                         f"{t.device} contiguous={t.is_contiguous()}")
    return t


class PinnedBuffer:
    """Page-aligned host buffer of ``nbytes`` exposed as ``tensor``
    (reference: deepspeed_pin_tensor.cpp ``new_cpu_locked_tensor``)."""

    def __init__(self, nbytes: int, dtype: torch.dtype = torch.float32):
        self._lib = build_native_lib()
        self.nbytes = int(nbytes)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self._ptr = None
        if self._lib is not None:
            self._ptr = self._lib.dstpu_alloc_pinned(self.nbytes)
            if not self._ptr:
                raise MemoryError(f"pinned alloc of {nbytes} bytes failed")
            buf = (ctypes.c_char * self.nbytes).from_address(self._ptr)
            self.tensor = torch.frombuffer(buf, dtype=torch.uint8).view(dtype)
        else:
            self.tensor = torch.zeros(self.nbytes // itemsize, dtype=dtype)

    def free(self) -> None:
        """Release the memory; ``tensor`` must not be used after."""
        if self._ptr is not None:
            self.tensor = None
            self._lib.dstpu_free_pinned(self._ptr, self.nbytes)
            self._ptr = None

    def __del__(self):  # pragma: no cover - gc timing
        try:
            self.free()
        except Exception:
            pass


class AsyncIOHandle:
    """Async reader and writer of host tensors; ``wait`` returns the
    number of failed requests (0 on success)."""

    BACKENDS = {"auto": 0, "threads": 1, "uring": 2, "python": None}

    def __init__(self, block_size: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 num_threads: Optional[int] = None,
                 backend: Optional[str] = None):
        block_size = block_size or DEFAULT_BLOCK_SIZE
        queue_depth = queue_depth or DEFAULT_QUEUE_DEPTH
        num_threads = num_threads or DEFAULT_THREADS
        backend = backend or os.environ.get("DSTPU_AIO_BACKEND") or "auto"
        if backend not in self.BACKENDS:
            raise ValueError(f"backend must be one of {set(self.BACKENDS)}, "
                             f"got {backend!r}")
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.num_threads = num_threads
        self._lib = None if backend == "python" else build_native_lib()
        self._h = None
        self._pool = None
        if self._lib is not None:
            self._h = self._lib.dstpu_aio_create2(
                block_size, queue_depth, num_threads,
                self.BACKENDS[backend])
            if not self._h:
                raise IOError(
                    f"aio backend {backend!r} unavailable on this host "
                    "(io_uring_setup refused: a seccomp'd container or an "
                    "old kernel); use backend='auto' for the fallback")
        else:
            if backend == "uring":
                raise IOError(
                    "aio backend 'uring' needs the native library, which "
                    "failed to build on this host; use backend='auto'")
            self._pool = _fut.ThreadPoolExecutor(max_workers=num_threads)
        self._futures: List[_fut.Future] = []
        # tensors of requests in flight: the native threads read and
        # write their raw addresses, so they must outlive the request
        self._refs: List[torch.Tensor] = []

    # -- async API ---------------------------------------------------------
    def _submit(self, t: torch.Tensor, path: str, offset: int,
                write: bool) -> int:
        t = _host_bytes(t)
        self._refs.append(t)
        if self._h is not None:
            fn = (self._lib.dstpu_aio_pwrite if write
                  else self._lib.dstpu_aio_pread)
            rid = fn(self._h, t.data_ptr(), t.nbytes, path.encode(),
                     int(offset))
            if rid < 0:
                raise IOError(f"aio {'pwrite' if write else 'pread'} "
                              f"submit failed for {path}")
            return rid
        fn = self._py_write if write else self._py_read
        self._futures.append(self._pool.submit(fn, t, path, int(offset)))
        return len(self._futures)

    def async_pread(self, t: torch.Tensor, path: str, offset: int = 0) -> int:
        return self._submit(t, path, offset, write=False)

    def async_pwrite(self, t: torch.Tensor, path: str, offset: int = 0) -> int:
        return self._submit(t, path, offset, write=True)

    def wait(self) -> int:
        if self._h is not None:
            errors = self._lib.dstpu_aio_wait(self._h)
            self._refs.clear()
            return errors
        errors = 0
        for f in self._futures:
            try:
                f.result()
            except OSError:
                errors += 1
        self._futures.clear()
        self._refs.clear()
        return errors

    # -- sync convenience --------------------------------------------------
    def pread(self, t: torch.Tensor, path: str, offset: int = 0) -> None:
        self.async_pread(t, path, offset)
        errs = self.wait()
        if errs:
            raise IOError(f"aio read of {path} failed ({errs} errors)")

    def pwrite(self, t: torch.Tensor, path: str, offset: int = 0) -> None:
        self.async_pwrite(t, path, offset)
        errs = self.wait()
        if errs:
            raise IOError(f"aio write of {path} failed ({errs} errors)")

    @property
    def backend(self) -> str:
        """The backend in use: "uring" | "threads" | "python"."""
        if self._h is None:
            return "python"
        return "uring" if self._lib.dstpu_aio_backend(self._h) == 2 \
            else "threads"

    # -- stats -------------------------------------------------------------
    def bytes_read(self) -> int:
        return self._lib.dstpu_aio_bytes_read(self._h) if self._h else -1

    def bytes_written(self) -> int:
        return self._lib.dstpu_aio_bytes_written(self._h) if self._h else -1

    # -- the python backend ------------------------------------------------
    @staticmethod
    def _py_read(t: torch.Tensor, path: str, offset: int) -> None:
        view = memoryview(t.view(torch.uint8).reshape(-1).numpy())
        with open(path, "rb") as f:
            f.seek(offset)
            got = f.readinto(view)
        if got != t.nbytes:
            raise IOError(f"short read from {path}: got {got} of "
                          f"{t.nbytes} bytes")

    @staticmethod
    def _py_write(t: torch.Tensor, path: str, offset: int) -> None:
        mode = "r+b" if os.path.exists(path) else "wb"
        with open(path, mode) as f:
            f.seek(offset)
            f.write(memoryview(t.view(torch.uint8).reshape(-1).numpy()))

    def close(self) -> None:
        if self._h is not None:
            self._lib.dstpu_aio_destroy(self._h)
            self._h = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


__all__ = ["AsyncIOHandle", "PinnedBuffer", "DEFAULT_BLOCK_SIZE",
           "DEFAULT_QUEUE_DEPTH", "DEFAULT_THREADS"]
