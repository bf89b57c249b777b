"""Asynchronous input prefetch for the training loop (port of
``deepspeed_tpu/runtime/prefetch.py``).

The blocking loop pays host time between two steps: microbatches are
pulled from the data iterator and copied to the card before the next
step can launch. :class:`PrefetchingIterator` moves that work to a
background thread: the worker pulls items from a producer (the engine's
producer pulls ``gas`` microbatches and starts their copies to the card)
and parks up to ``depth`` finished items in a bounded queue.

Semantics (JAX's):

* items come out in the order the producer made them;
* worker exceptions are re-raised at ``next()``: an input-pipeline
  failure surfaces on the training thread, at the step that needed the
  data, and ends the stream;
* ``StopIteration`` from the producer ends the stream cleanly (each
  later ``next()`` keeps raising ``StopIteration``);
* ``close()`` stops the worker promptly even when it is blocked on a full
  buffer, joins it, and is idempotent;
* ``depth=0`` produces synchronously on the caller's thread.

The card copy (:func:`to_device_async`) is a pinned host tensor copied
with ``non_blocking=True`` on a side stream, with an event the consumer's
stream waits on (:func:`wait_ready`): the copies overlap the step in
flight and never block either thread.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


class _EndOfStream:
    """Queue sentinel: the producer raised StopIteration."""


class _WorkerError:
    """Queue sentinel carrying the exception the producer raised."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchingIterator:
    """Bounded background prefetch over a producer of ready batches.

    ``source`` is either an iterator (``next()`` is the producer) or a
    zero-argument callable returning the next item and raising
    ``StopIteration`` when exhausted."""

    def __init__(self, source, depth: int = 2, name: str = "prefetch"):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        if callable(source) and not hasattr(source, "__next__"):
            self._produce: Callable[[], Any] = source
        else:
            it: Iterator = iter(source)
            self._produce = lambda: next(it)
        self.depth = depth
        self.name = name
        self._closed = False
        self._finished = False
        # produced - consumed = batches pulled ahead of training: the work
        # a preemption discards and a resume replays
        self.produced = 0
        self.consumed = 0
        self._sync = depth == 0
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if not self._sync:
            self._queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(
                target=self._worker, name=f"dstpu-{name}", daemon=True)
            self._thread.start()

    # -- worker --------------------------------------------------------
    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._produce()
            except StopIteration:
                self._put(_EndOfStream)
                return
            except BaseException as e:  # re-raised at next(), not here
                self._put(_WorkerError(e))
                return
            self.produced += 1
            if not self._put(item):
                return  # closed while blocked on a full buffer

    def _put(self, item) -> bool:
        """Blocking put that still honours close(); False when closed."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer ------------------------------------------------------
    def __iter__(self) -> "PrefetchingIterator":
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError(f"{self.name}: next() after close()")
        if self._finished:
            raise StopIteration
        if self._sync:
            item = self._produce()  # StopIteration propagates as it is
            self.produced += 1
            self.consumed += 1
            return item
        item = self._queue.get()
        if item is _EndOfStream:
            self._finished = True
            raise StopIteration
        if isinstance(item, _WorkerError):
            self._finished = True
            raise item.exc
        self.consumed += 1
        return item

    @property
    def buffered(self) -> int:
        """Items parked in the bounded buffer now."""
        return self._queue.qsize() if self._queue is not None else 0

    # -- lifecycle -----------------------------------------------------
    def close(self, timeout: float = 2.0) -> None:
        """Stop the worker and drop the buffered items. Idempotent; safe
        mid-epoch (the worker unblocks even when the buffer is full)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._queue is not None:
            while True:  # unblock a worker waiting in _put
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                logger.warning(
                    f"{self.name}: worker did not exit within {timeout}s "
                    "(a daemon thread dies with the process)")

    def __enter__(self) -> "PrefetchingIterator":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __del__(self):
        try:
            self.close(timeout=0.1)
        except Exception:
            pass


def map_batch(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``fn`` over the leaves of a batch tree (dicts, lists, tuples and
    namedtuples over numpy arrays or tensors; ``None`` stays ``None``),
    each leaf given as a tensor."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_batch(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        cols = [map_batch(v, fn) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*cols)
        return type(tree)(cols)
    if not isinstance(tree, torch.Tensor):
        tree = torch.as_tensor(np.asarray(tree))
    return fn(tree)


def to_device_async(tree: Any, device: torch.device,
                    stream: Optional["torch.cuda.Stream"] = None
                    ) -> Tuple[Any, Optional["torch.cuda.Event"]]:
    """Start copying a batch tree to ``device``. On the card each host
    leaf is pinned and copied with ``non_blocking=True`` on ``stream``
    (a side stream), and the returned event marks the copies' end; the
    consumer passes both to :func:`wait_ready` before use. On the CPU
    the copy is the plain one and the event None."""
    if device.type != "cuda":
        return map_batch(tree, lambda t: t.to(device)), None
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        def copy(t):
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        out = map_batch(tree, copy)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def wait_ready(tree: Any, event: Optional["torch.cuda.Event"]) -> Any:
    """Make the current stream wait for ``to_device_async``'s copies and
    tie the tensors' memory to it (the allocator then keeps them until
    this stream is done with them). Returns the tree."""
    if event is None:
        return tree
    stream = torch.cuda.current_stream()
    stream.wait_event(event)

    def mark(t):
        if t.device.type == "cuda":
            t.record_stream(stream)
        return t

    return map_batch(tree, mark)


__all__ = ["PrefetchingIterator", "map_batch", "to_device_async",
           "wait_ready"]
