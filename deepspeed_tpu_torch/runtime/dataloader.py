"""Data loading (port of ``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` batches an indexable or iterable dataset into
numpy batches (dicts of stacked arrays, or whatever ``collate_fn``
returns); the engine moves each batch to its device. Across ranks each
process reads its contiguous share of the sample space (JAX's
``_num_procs`` / ``_proc_id``: the process group's world size and rank,
taken when the loader is built; on a mesh, the data ranks and this
rank's data index, so the ranks of one tp group read the same rows); one
process reads all of it. The
index order is a
pure function of ``(seed, epoch)`` (``np.random.default_rng(seed +
epoch)``, as in JAX), so a given seed and epoch give JAX's batches.
``RepeatingLoader`` restarts an exhausted loader at the next epoch.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def default_collate(samples: Sequence[Any]):
    """Stack a list of samples (arrays, or dicts / lists / tuples /
    namedtuples of them) into one batch of the same structure, as JAX's
    ``jax.tree.map(np.stack ...)`` does: ``None`` is an empty subtree and
    stays ``None``."""
    first = samples[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (list, tuple)):
        cols = [default_collate(list(col)) for col in zip(*samples)]
        if hasattr(first, "_fields"):  # a namedtuple takes its fields
            return type(first)(*cols)
        return type(first)(cols)
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Batches an indexable or iterable dataset for this rank."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        from deepspeed_tpu_torch import comm

        from deepspeed_tpu_torch.parallel import topology

        mesh = topology._GLOBAL_MESH
        if mesh is not None and mesh.distributed:
            # the data ranks: the ranks of one tp group read the same rows
            self._num_procs = mesh.axis_size(topology.BATCH_AXES)
            self._proc_id = mesh.axis_index(topology.BATCH_AXES)
        else:
            self._num_procs = comm.get_world_size()
            self._proc_id = comm.get_rank()
        self._warned_stream_shuffle = False
        try:
            self._len = len(dataset)
        except TypeError:
            self._len = None

    def __len__(self):
        if self._len is None:
            raise TypeError("iterable dataset has no length")
        per_proc = self._len // self._num_procs
        n = per_proc // self.batch_size
        if not self.drop_last and per_proc % self.batch_size:
            n += 1
        return n

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    # Iteration order is a pure function of (seed, epoch): restoring the
    # epoch and replaying the intra-epoch offset reproduces the exact
    # remaining batch stream.
    def state_dict(self):
        return {"epoch": int(self._epoch), "seed": int(self.seed),
                "shuffle": bool(self.shuffle)}

    def load_state_dict(self, sd) -> None:
        if int(sd.get("seed", self.seed)) != int(self.seed):
            logger.warning(
                f"dataloader resume: checkpoint seed {sd.get('seed')} != "
                f"configured seed {self.seed} — the replayed batch "
                "stream will differ from the original run")
        self.set_epoch(int(sd.get("epoch", 0)))

    def __iter__(self) -> Iterator:
        if self._len is None:
            if self.shuffle and not self._warned_stream_shuffle:
                self._warned_stream_shuffle = True
                logger.warning(
                    "shuffle=True is ignored for a length-less iterable "
                    "dataset: samples stream in the order the dataset "
                    "yields them (shuffle inside the dataset, or provide "
                    "__len__ + __getitem__ for index shuffling)")
            return self._iter_stream()
        return self._iter_indexed()

    def _iter_indexed(self):
        idx = np.arange(self._len)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        per_proc = self._len // self._num_procs
        idx = idx[self._proc_id * per_proc:(self._proc_id + 1) * per_proc]
        end = (per_proc - per_proc % self.batch_size if self.drop_last
               else per_proc)
        for start in range(0, end, self.batch_size):
            chunk = idx[start:start + self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in chunk])

    def _iter_stream(self):
        buf = []
        for i, sample in enumerate(self.dataset):
            if i % self._num_procs != self._proc_id:
                continue
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)


class RepeatingLoader:
    """Wraps an iterator to restart on StopIteration (reference
    runtime/dataloader.py RepeatingLoader)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)
        self._epoch = 0
        self._offset = 0  # batches yielded since the last epoch restart

    def __iter__(self):
        return self

    def state_dict(self):
        sd = {"epoch": int(self._epoch),
              "offset_batches": int(self._offset)}
        if hasattr(self.loader, "state_dict"):
            sd["loader"] = self.loader.state_dict()
        return sd

    def load_state_dict(self, sd) -> None:
        """Restore epoch position and restart the inner iterator; the
        caller then replays ``offset_batches`` pulls to land on the first
        unconsumed batch."""
        if "loader" in sd and hasattr(self.loader, "load_state_dict"):
            self.loader.load_state_dict(sd["loader"])
        self._epoch = int(sd.get("epoch", 0))
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(self._epoch)
        self.data_iter = iter(self.loader)
        self._offset = 0

    def __next__(self):
        try:
            batch = next(self.data_iter)
            self._offset += 1
            return batch
        except StopIteration:
            self._epoch += 1
            self._offset = 0
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(self._epoch)
            self.data_iter = iter(self.loader)
            try:
                batch = next(self.data_iter)
                self._offset += 1
                return batch
            except StopIteration:
                # a restart that immediately exhausts means the wrapped
                # loader yields nothing — restarting again would spin
                # forever, so fail loudly instead
                raise ValueError(
                    "RepeatingLoader: loader produced no batches (the "
                    "wrapped loader's iterator was empty after a "
                    "restart)") from None


__all__ = ["default_collate", "DeepSpeedDataLoader", "RepeatingLoader"]
