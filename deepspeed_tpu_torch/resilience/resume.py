"""Deterministic auto-resume of the data pipeline (copy of
``deepspeed_tpu/resilience/resume.py``, which imports no JAX).

The hard part of resuming a killed run is not the tensors (the
checkpoint holds those) but the *batch stream*: the resumed run must see
exactly the batches the dead run never consumed, in the same order, or
the loss trajectories diverge and "resumed" silently means "different
run".

The cursor that makes this work counts **consumed GAS boundaries**, not
pulled batches: ``boundaries_consumed == engine.global_steps``. Batches
a ``PrefetchingIterator`` worker pulled ahead but the training loop
never consumed are excluded: while a prefetcher runs the cursor leaves
the loader's state out (it is "future" state) and a resume replays from
the counts, which replays exactly what the dead run's buffer held.

Restore strategies, in order of preference:

1. the data source exposes ``load_state_dict`` (``DeepSpeedDataLoader``,
   ``RepeatingLoader``): O(1) state restore plus
   a bounded fast-forward for the intra-epoch offset;
2. plain iterator: fast-forward by ``microbatches_consumed`` pulls.
   Deterministic loaders (rng seeded from ``seed + epoch`` / ``seed +
   step``) replay identically, so discard-and-count is exact. O(consumed
   batches) — fine for tier-1 shapes and short runs; production data
   pipelines should carry a sampler with ``state_dict``.

Both paths produce a stream positioned so the next pull is the first
batch the dead run never trained on.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

CURSOR_VERSION = 1


def data_cursor(engine) -> Dict[str, Any]:
    """Snapshot the engine's data-pipeline position for the checkpoint
    manifest, at a GAS boundary."""
    gas = int(engine.gradient_accumulation_steps)
    cursor: Dict[str, Any] = {
        "version": CURSOR_VERSION,
        "boundaries_consumed": int(engine.global_steps),
        "gas": gas,
        "microbatches_consumed": int(engine.global_steps) * gas,
        "global_samples": int(engine.global_samples),
    }
    # loader state: prefer the stream train_batch actually consumed (a
    # RepeatingLoader is its own iterator, so the engine's last data_iter
    # often IS the stateful loader); fall back to the engine-owned one
    # NOT captured while a prefetcher is active: its worker has pulled
    # ahead of consumption, so the loader's epoch / offset are future
    # values; the consumed-boundary counts above are the truthful cursor
    if getattr(engine, "_prefetcher", None) is not None:
        return cursor
    for source in (getattr(engine, "_last_data_iter", None),
                   getattr(engine, "training_dataloader", None)):
        state_fn = getattr(source, "state_dict", None)
        if callable(state_fn):
            try:
                cursor["loader"] = state_fn()
            except Exception as e:  # cursor must never block a save
                logger.warning(
                    f"resilience: loader state_dict failed ({e}); cursor "
                    "falls back to fast-forward counts")
            break
    return cursor


def _fast_forward(data_iter, n: int) -> int:
    """Pull and discard ``n`` items; returns how many were skipped (may
    be short if the stream ends — RepeatingLoader never does)."""
    skipped = 0
    for _ in range(n):
        try:
            next(data_iter)
        except StopIteration:
            break
        skipped += 1
    return skipped


def resume_data_iter(data_iter, cursor: Optional[Dict[str, Any]],
                     source=None):
    """Position ``data_iter`` at the first unconsumed microbatch.

    ``cursor`` is the manifest's ``data_cursor`` (None/empty = fresh run,
    returned untouched). ``source`` optionally names the loader object
    backing ``data_iter`` (e.g. the ``RepeatingLoader`` itself) so its
    ``load_state_dict`` can restore epoch/offset state that a bare
    iterator cannot carry.

    Call before the first ``train_batch``.
    """
    if not cursor:
        return data_iter
    n = int(cursor.get("microbatches_consumed", 0))
    if n <= 0:
        return data_iter
    loader_state = cursor.get("loader")
    target = source if source is not None else data_iter
    load_fn = getattr(target, "load_state_dict", None)
    if loader_state is not None and callable(load_fn):
        load_fn(loader_state)
        # state restore covers epoch/rng; the intra-epoch offset (batches
        # consumed since the last epoch boundary) still replays here
        n = int(loader_state.get("offset_batches", n))
        if n:
            skipped = _fast_forward(data_iter, n)
            logger.info(f"resilience: resumed loader state + fast-forward "
                        f"{skipped} intra-epoch batch(es)")
        else:
            logger.info("resilience: resumed loader state (no intra-epoch "
                        "offset)")
        return data_iter
    skipped = _fast_forward(data_iter, n)
    if skipped < n:
        logger.warning(
            f"resilience: data stream ended during resume fast-forward "
            f"({skipped}/{n} microbatches) — the resumed run will see a "
            "shorter stream than the original (wrap the loader in "
            "RepeatingLoader for epoch restarts)")
    else:
        logger.info(f"resilience: fast-forwarded data stream by {n} "
                    "consumed microbatch(es)")
    return data_iter
