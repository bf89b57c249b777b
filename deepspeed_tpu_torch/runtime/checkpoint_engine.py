"""Pluggable checkpoint engines (port of
``deepspeed_tpu/runtime/checkpoint_engine.py``).

The payload is a tree of tensors (nested dicts), written as one torch
file per leaf at the leaf's tree path under the state directory
(``state/params/embed/tokens.pt``): each file goes to a ``.tmp`` name,
is fsynced, then renamed, so a reader never sees half a file and a load
can skip a subtree (the optimizer payloads) without reading it. The
engines differ in *when* the write happens and blocks:

  * ``SyncCheckpointEngine``      — blocking save.
  * ``DecoupledCheckpointEngine`` — ``checkpoint.async_save``: the
    device→host copy is synchronous (``save`` returns once every leaf
    is a host copy, so later in-place optimizer updates cannot leak into
    the write), the file writes run on a background thread;
    ``maybe_finalize`` is polled at GAS boundaries and ``commit`` blocks
    until the write is durable.

  * ``FastCheckpointEngine``      — ``checkpoint.parallel_write_pipeline``:
    a blocking save whose files are written through the pipelined AIO
    writer (``io/fast_file_writer.py``: two page-aligned staging buffers,
    the native async handle), each to a ``.tmp`` name, fsynced, then
    renamed. The bytes are those of the Sync engine's files.

With both ``async_save`` and ``parallel_write_pipeline`` the decoupled
engine wins, with a warning, as in JAX.
"""

from __future__ import annotations

import abc
import logging
import os
import threading
from typing import Dict, Iterable, Optional, Tuple

import torch

from deepspeed_tpu_torch.io.fast_file_writer import (FastFileWriter,
                                                     WriteStream)
from deepspeed_tpu_torch.ops.native.aio import AsyncIOHandle, PinnedBuffer
from deepspeed_tpu_torch.runtime.optimizer import leaves

logger = logging.getLogger(__name__)

Tree = Dict[str, object]


def leaf_file(path: str, leaf_path: str) -> str:
    """The file of the leaf at ``leaf_path`` (``/params/embed/tokens``)
    under the state directory ``path``."""
    return os.path.join(path, *leaf_path.strip("/").split("/")) + ".pt"


def _save_plain(t: torch.Tensor, tmp: str) -> None:
    with open(tmp, "wb") as f:
        torch.save(t, f)
        f.flush()
        os.fsync(f.fileno())


def _write_leaf(t: torch.Tensor, dst: str, save=_save_plain) -> None:
    """``save(t, tmp)`` writes and fsyncs ``tmp``, which then replaces
    ``dst``."""
    if t.untyped_storage().nbytes() != t.nbytes:
        t = t.clone()  # a view would save its whole storage
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    save(t, tmp)
    os.replace(tmp, dst)


def write_tree(path: str, tree: Tree) -> None:
    for leaf_path, t in leaves(tree):
        _write_leaf(t, leaf_file(path, leaf_path))


def read_tree(path: str, target: Tree,
              skip: Iterable[str] = ()) -> Tuple[int, list]:
    """Copy every leaf of ``target`` (but the top-level subtrees named in
    ``skip``) from its file under ``path``, in place. Every file is
    mapped and checked (shape and dtype) before any tensor of ``target``
    changes, so a payload of another model leaves the engine as it was.
    Returns (bytes read, leaf paths restored)."""
    skip = {f"/{k}" for k in skip}
    pairs = []
    for leaf_path, dst in leaves(target):
        if any(leaf_path == s or leaf_path.startswith(s + "/")
               for s in skip):
            continue
        src = torch.load(leaf_file(path, leaf_path), map_location="cpu",
                         weights_only=True, mmap=True)
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape \
                or src.dtype != dst.dtype:
            got = (tuple(src.shape), src.dtype) \
                if isinstance(src, torch.Tensor) else type(src).__name__
            raise ValueError(
                f"checkpoint leaf {leaf_path}: saved {got}, the engine "
                f"holds {(tuple(dst.shape), dst.dtype)}")
        pairs.append((leaf_path, dst, src))
    nbytes = 0
    with torch.no_grad():
        for _, dst, src in pairs:
            dst.copy_(src)
            nbytes += src.nbytes
    return nbytes, [p for p, _, _ in pairs]


def read_files(path: str) -> Tree:
    """Every leaf file under ``path``, mapped (``mmap``, weights only),
    as a tree keyed by the files' paths: for a payload whose shapes the
    engine cannot know beforehand (ZenFlow's protected sets)."""
    out: Tree = {}
    for dirpath, _, files in os.walk(path):
        for name in files:
            if not name.endswith(".pt"):
                continue  # a .tmp of an interrupted write
            rel = os.path.relpath(os.path.join(dirpath, name[:-3]), path)
            node = out
            keys = rel.split(os.sep)
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = torch.load(os.path.join(dirpath, name),
                                        map_location="cpu",
                                        weights_only=True, mmap=True)
    return out


class CheckpointEngine(abc.ABC):
    """Reference ABC: checkpoint_engine.py:21."""

    @abc.abstractmethod
    def save(self, path: str, state_tree: Tree):
        """Persist a tree of tensors at ``path``."""

    def load(self, path: str, target: Tree, skip: Iterable[str] = ()
             ) -> Tuple[int, list]:
        """Restore ``target``'s leaves in place (``read_tree``)."""
        return read_tree(path, target, skip)

    def commit(self, tag: str) -> bool:
        """Make the save durable / visible (reference: commit). Blocking."""
        return True

    def maybe_finalize(self) -> bool:
        """Non-blocking poll: True when no save is in flight."""
        return True


class SyncCheckpointEngine(CheckpointEngine):
    """Blocking save (TorchCheckpointEngine analog)."""

    def save(self, path: str, state_tree: Tree):
        write_tree(path, state_tree)


class DecoupledCheckpointEngine(CheckpointEngine):
    """Async save: returns after the device→host snapshot; the file
    writes complete on a background thread (commit at the next GAS
    boundary, reference engine.py:3273)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state_tree: Tree):
        self._wait()  # at most one write in flight
        # a copy even on the CPU (``.to`` would return the tensor itself):
        # the optimizer updates the engine's leaves in place
        host = [(p, t.detach().to("cpu", copy=True))
                for p, t in leaves(state_tree)]
        self._error = None

        def write():
            try:
                for leaf_path, t in host:
                    _write_leaf(t, leaf_file(path, leaf_path))
            # any end short of the last file, re-raised by commit: a
            # partial payload must never be published
            except BaseException as e:
                self._error = e

        self._thread = threading.Thread(target=write, name="ckpt-write",
                                        daemon=True)
        self._thread.start()

    def _wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def load(self, path: str, target: Tree, skip: Iterable[str] = ()):
        self._wait()  # loads never race an in-flight save
        return super().load(path, target, skip)

    def commit(self, tag: str) -> bool:
        self._wait()
        err, self._error = self._error, None
        if err is not None:
            raise err
        logger.info(f"async checkpoint committed: {tag}")
        return True

    def maybe_finalize(self) -> bool:
        if self._thread is not None and self._thread.is_alive():
            return False  # write still in flight — do not block the step
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return True


class FastCheckpointEngine(SyncCheckpointEngine):
    """Blocking save through the double-buffered AIO writer (reference
    deepspeed/io/fast_file_writer.py:44). ``torch.save`` streams each
    leaf's host copy into the writer at a ``.tmp`` name; the file is
    fsynced, then renamed, so a crash mid-write never corrupts a
    published file. One AIO handle and one pair of staging buffers serve
    every file."""

    def __init__(self, buffer_size: int = 64 << 20):
        self.buffer_size = buffer_size
        self._aio = None
        self._bufs = None

    def _save(self, t: torch.Tensor, tmp: str) -> None:
        with FastFileWriter(tmp, self.buffer_size, self._aio,
                            self._bufs) as w:
            torch.save(t, WriteStream(w))
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def save(self, path: str, state_tree: Tree):
        if self._aio is None:
            self._aio = AsyncIOHandle()
            self._bufs = [PinnedBuffer(self.buffer_size, torch.uint8)
                          for _ in range(2)]
        for leaf_path, t in leaves(state_tree):
            _write_leaf(t.detach(), leaf_file(path, leaf_path), self._save)


def make_checkpoint_engine(checkpoint_config) -> CheckpointEngine:
    """Select the engine from the config block (reference
    engine.py:1462 _configure_checkpointing)."""
    async_save = checkpoint_config.async_save
    fast = checkpoint_config.parallel_write_pipeline
    if async_save and fast:
        logger.warning(
            "checkpoint: both async_save and parallel_write_pipeline set; "
            "async_save (decoupled engine) wins: the pipelined writer "
            "only applies to the synchronous engine")
    if async_save:
        return DecoupledCheckpointEngine()
    return FastCheckpointEngine() if fast else SyncCheckpointEngine()


__all__ = ["CheckpointEngine", "SyncCheckpointEngine",
           "DecoupledCheckpointEngine", "FastCheckpointEngine",
           "make_checkpoint_engine", "leaf_file", "read_files", "read_tree",
           "write_tree"]
