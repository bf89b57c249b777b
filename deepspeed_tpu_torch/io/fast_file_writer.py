"""Double-buffered file writer over the native AIO library (port of
``deepspeed_tpu/io/fast_file_writer.py``; reference
deepspeed/io/fast_file_writer.py:44).

Bytes are staged into two page-aligned buffers and written by the async
I/O handle while the caller fills the other buffer, so serialization and
the disk write overlap. A full buffer is 512-byte aligned in address and
size, so the native layer writes it with ``O_DIRECT`` where the file
system allows.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from deepspeed_tpu_torch.ops.native.aio import (DEFAULT_BLOCK_SIZE,
                                                AsyncIOHandle, PinnedBuffer)


@dataclass
class FastFileWriterStats:
    """Reference: FastFileWriter._dump_state counters."""

    bytes_written: int = 0
    write_calls: int = 0
    flushes: int = 0


class FastFileWriter:
    """Sequential writer with two staging buffers: ``write`` copies into
    the active one; a full buffer goes to the aio handle and the other
    becomes active, waiting only if it still has a write in flight."""

    def __init__(self, path: str, buffer_size: int = 8 * DEFAULT_BLOCK_SIZE,
                 aio_handle: Optional[AsyncIOHandle] = None,
                 buffers: Optional[Sequence[PinnedBuffer]] = None):
        """``buffers``: two staging buffers of ``buffer_size`` bytes that
        the caller owns and reuses across files (a checkpoint writes
        many); by default the writer allocates and frees its own."""
        self.path = path
        self.buffer_size = int(buffer_size)
        self._aio = aio_handle or AsyncIOHandle()
        self._owned = buffers is None
        self._bufs = list(buffers) if buffers is not None else [
            PinnedBuffer(self.buffer_size, dtype=torch.uint8)
            for _ in range(2)]
        if len(self._bufs) != 2 or any(b.nbytes < self.buffer_size
                                       for b in self._bufs):
            raise ValueError(f"FastFileWriter needs two buffers of "
                             f"{self.buffer_size} bytes")
        self._views = [b.tensor.view(torch.uint8)[:self.buffer_size].numpy()
                       for b in self._bufs]
        self._pending = [False, False]  # handed to aio, not waited for
        self._active = 0
        self._fill = 0  # bytes staged in the active buffer
        self._offset = 0  # file offset of the next submitted write
        self.stats = FastFileWriterStats()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # truncate first: a crash mid-write cannot leave a stale tail
        with open(path, "wb"):
            pass
        self._closed = False

    def write(self, data) -> int:
        if self._closed:
            raise ValueError("write after close")
        view = memoryview(data).cast("B")
        total = len(view)
        while len(view):
            take = min(self.buffer_size - self._fill, len(view))
            dst = self._views[self._active]
            dst[self._fill:self._fill + take] = view[:take]
            self._fill += take
            view = view[take:]
            if self._fill == self.buffer_size:
                self._swap()
        self.stats.write_calls += 1
        self.stats.bytes_written += total
        return total

    def _swap(self) -> None:
        """Submit the active buffer and rotate."""
        if self._fill == 0:
            return
        buf = self._bufs[self._active].tensor.view(torch.uint8)
        self._aio.async_pwrite(buf[:self._fill], self.path,
                               offset=self._offset)
        self._pending[self._active] = True
        self._offset += self._fill
        self._active ^= 1
        self._fill = 0
        if self._pending[self._active]:
            # the buffer about to be filled is still in flight from two
            # swaps ago: drain before reusing it
            self._drain()

    def _drain(self) -> None:
        errors = self._aio.wait()
        self._pending = [False, False]
        if errors:
            raise IOError(f"{errors} async write(s) to {self.path} failed "
                          "(disk full or I/O error): the file is incomplete")

    def flush(self) -> None:
        self._swap()
        self._drain()
        self.stats.flushes += 1

    def close(self) -> None:
        if self._closed:
            return
        try:
            self.flush()
        finally:
            self._closed = True
            # a failed flush can leave writes in flight: the native threads
            # still read the buffers, so drain before freeing them
            try:
                if any(self._pending):
                    self._aio.wait()
                    self._pending = [False, False]
            finally:
                self._views = []
                if self._owned:
                    for b in self._bufs:
                        b.free()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class WriteStream:
    """A write-only file object over a FastFileWriter (``torch.save``
    writes to it sequentially)."""

    def __init__(self, writer: FastFileWriter):
        self._w = writer

    def write(self, b) -> int:
        return self._w.write(b)

    def flush(self) -> None:
        pass


__all__ = ["FastFileWriter", "FastFileWriterStats", "WriteStream"]
