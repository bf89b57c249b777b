"""ZenFlow: offloaded optimization split by gradient importance (port of
``deepspeed_tpu/runtime/zenflow.py``).

The top ``topk_ratio`` of each leaf's coordinates, picked by the size of
the accumulated gradient, update on the card every step with a compact
Adam whose moments cover only those coordinates. The rest accumulate on
the card in fp32; every ``update_interval`` steps they go to the host,
divided by the interval, where the native CPU Adam
(``ops/native/cpu_optimizer.py``) steps the fp32 masters on a thread
while the card trains on. The finished host pass is folded back into the
card's params at the next interval boundary (``overlap_step``), or at
the step after the ship (without overlap): the masters give every
coordinate but those selected since the last fold, whose card values
are ahead.

At world size 1 each leaf is one shard: JAX's ``_unique_local_shards``
and ``_rebuild_global`` are the identity, and ``shard_index`` holds the
full leaf's index. Across ranks (``blocks``, one :class:`LeafBlock` a
leaf: ZeRO's fsdp block of it) every piece of state is this rank's
block: the host masters, moments and shipped grads, the card's
accumulator, and the selected coordinates that fall in the block with
their moments. The selection stays JAX's global top-k over the whole
leaf: each rank takes its block's top k candidates (their global
indices: a block keeps the leaf's row-major order), the candidates are
all-gathered, and each rank merges them by descending value, then
ascending global index, and keeps the first k that are its own; that is
``jax.lax.top_k`` of the whole accumulator, ties included. The protected
set and the fold follow the rank's own coordinates. The schedule is
JAX's, step for step. Where JAX differs, the port does less work for the
same values:

  * host memory is 16 bytes a parameter (master, two moments, the
    shipped grads): the host pass returns nothing and the fold reads the
    masters themselves (the worker is idle at every fold), where JAX
    copies the masters in the pass and divides the grads into another
    copy;
  * the ship divides by the interval on the card, as it copies each
    chunk down (fp32 true division, correctly rounded as numpy's);
  * ship and fold run leaf by leaf in ``CHUNK_ELEMS`` chunks through
    pinned staging buffers on a side stream (JAX builds whole fp32 trees
    on the device); the fold casts a master chunk to the params' dtype on
    the host (bf16 natively, bit-equal to a torch cast), copies it up and
    writes the kept coordinates back from the card's own values, which
    is JAX's fp32 fold followed by its cast;
  * the state dict carries ``fold_due``: a fold that was due when the
    state was taken runs after a load, so a resumed run equals the
    uninterrupted one bit for bit (JAX drops its ``_pending_upload``);
  * top-k breaks ties as ``jax.lax.top_k``: by descending value, then
    ascending index (``torch.topk`` promises no order among equals).

There is no fallback: without the native library the constructor raises
(``builder.require_native_lib``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.native.builder import require_native_lib
from deepspeed_tpu_torch.ops.native.cpu_optimizer import CPUAdam
from deepspeed_tpu_torch.runtime.offload import CHUNK_ELEMS
from deepspeed_tpu_torch.runtime.optimizer import leaves

logger = logging.getLogger(__name__)

F32 = torch.float32


@dataclasses.dataclass
class ZenFlowConfig:
    """JAX's ZenFlowConfig (reference zenflow_config.py), its defaults."""

    topk_ratio: float = 0.01
    update_interval: int = 4
    select_interval: int = 16  # re-pick the important coordinates
    overlap_step: bool = True  # the host pass on a thread (False: blocking)
    workers: int = 1  # threads splitting the host pass across leaves
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0


class _AsyncWorker:
    """One in-flight host pass on a thread; its error is raised at
    ``collect``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn, *args) -> None:
        assert not self.busy, "previous host pass still in flight"
        self._error = None

        def run():
            try:
                fn(*args)
            except BaseException as e:  # surfaced at collect()
                self._error = e

        self._thread = threading.Thread(target=run, name="zenflow-host-opt",
                                        daemon=True)
        self._thread.start()

    @property
    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def collect(self) -> bool:
        """Wait for the pass in flight; True when there was one."""
        if self._thread is None:
            return False
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return True


@dataclasses.dataclass(frozen=True)
class LeafBlock:
    """This rank's block of one leaf: the whole leaf's ``shape``, the
    dim it is cut along (None: the whole leaf) into ``count`` equal
    blocks, and this rank's ``index`` among them."""

    shape: Tuple[int, ...]
    dim: Optional[int] = None
    index: int = 0
    count: int = 1

    def _geom(self):
        d = self.dim
        inner = int(np.prod(self.shape[d + 1:], dtype=np.int64))
        length = self.shape[d]
        return inner, length, length // self.count

    def to_global(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf's flat indices of the block's flat ``local``."""
        if self.dim is None or self.count == 1:
            return local
        inner, length, b = self._geom()
        o, rem = local // (b * inner), local % (b * inner)
        j, i = rem // inner, rem % inner
        return o * (length * inner) + (self.index * b + j) * inner + i

    def split(self, flat: torch.Tensor):
        """(which of the whole leaf's ``flat`` indices fall in the block,
        their block indices)."""
        if self.dim is None or self.count == 1:
            return torch.ones_like(flat, dtype=torch.bool), flat
        inner, length, b = self._geom()
        o, rem = flat // (length * inner), flat % (length * inner)
        j, i = rem // inner - self.index * b, rem % inner
        mine = (j >= 0) & (j < b)
        return mine, (o * (b * inner) + j * inner + i)[mine]

    def to_local(self, flat: torch.Tensor) -> torch.Tensor:
        """The block's flat indices of the whole leaf's ``flat`` indices
        that fall in the block (the others dropped, order kept)."""
        return self.split(flat)[1]

    @classmethod
    def from_pairs(cls, shape, pairs) -> "LeafBlock":
        """The block whose ``index_pairs`` are ``pairs``."""
        for d, ((a, b), n) in enumerate(zip(pairs, shape)):
            if (a, b) != (0, n):
                return cls(tuple(shape), d, a // (b - a), n // (b - a))
        return cls(tuple(shape))

    def index_pairs(self) -> Tuple[Tuple[int, int], ...]:
        """JAX's ``shard_index``: (start, stop) of the block on each dim."""
        out = []
        for d, n in enumerate(self.shape):
            if d == self.dim and self.count > 1:
                b = n // self.count
                out.append((self.index * b, (self.index + 1) * b))
            else:
                out.append((0, n))
        return tuple(out)


def merge_topk(values: torch.Tensor, flat: torch.Tensor, k: int
               ) -> torch.Tensor:
    """The ``k`` candidates of the largest ``values``, ties by ascending
    ``flat`` index (``jax.lax.top_k``'s order over the whole leaf):
    their flat indices, in that order."""
    by_index = torch.argsort(flat, stable=True)
    by_value = torch.sort(values[by_index], descending=True,
                          stable=True).indices
    return flat[by_index[by_value[:k]]]


def topk_indices(a: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries of the 1-D ``a`` in
    ``jax.lax.top_k``'s order: descending value, and ascending index
    among equal values. Everything above the k-th value is taken, then
    the lowest indices equal to it."""
    thr = torch.topk(a, k, sorted=False).values.min()
    above = torch.nonzero(a > thr).flatten()
    ties = torch.nonzero(a == thr).flatten()[:k - above.numel()]
    cand = torch.cat([above, ties])
    # a stable sort keeps each run of equal values in ascending index
    order = torch.sort(a[cand], descending=True, stable=True).indices
    return cand[order]


class ZenFlowOptimizer:
    """The importance-split optimizer over a tree of parameters.

    ``step(grads, params, lr)`` updates ``params`` (the compute-dtype
    tensors on the card, same tree as the init) in place and returns
    them. The host fp32 masters own the coordinates not selected since
    the last fold; the selected ones run ahead on the card.
    """

    def __init__(self, params, config: Optional[ZenFlowConfig] = None,
                 lr: float = 1e-3, device: Optional[torch.device] = None,
                 chunk_elems: int = CHUNK_ELEMS,
                 blocks: Optional[Dict[str, LeafBlock]] = None,
                 gather=None):
        """``params`` seeds the fp32 masters (pass the fp32 init, so that
        the masters hold it exactly); ``device`` holds the card state
        (default: the first leaf's device). Across ranks ``params`` are
        this rank's blocks, ``blocks`` maps each leaf path to its
        :class:`LeafBlock` and ``gather`` all-gathers a 1-D tensor over
        the ranks that share the leaves (concatenated in rank order)."""
        require_native_lib()  # no fallback: fail here, loudly
        self.cfg = config or ZenFlowConfig()
        self.lr = float(lr)
        flat = list(leaves(params))
        self.paths = [p for p, _ in flat]
        self.shapes = [tuple(t.shape) for _, t in flat]
        self._sizes = [int(np.prod(s)) for s in self.shapes]
        self.blocks = [(blocks or {}).get(p) or LeafBlock(shape)
                       for p, shape in zip(self.paths, self.shapes)]
        self._gather = gather
        # k counts the whole leaf (JAX's ceil(topk_ratio * size))
        self._ks = [max(1, int(np.ceil(self.cfg.topk_ratio
                                       * int(np.prod(b.shape)))))
                    for b in self.blocks]
        self.device = torch.device(device) if device is not None \
            else flat[0][1].device
        self.chunk_elems = max(1, min(int(chunk_elems), max(self._sizes)))
        self._cuda = self.device.type == "cuda"
        self._masters: List[torch.Tensor] = []
        self._host_opts: List[CPUAdam] = []
        self._host_grads: List[torch.Tensor] = []
        for (_, t), n in zip(flat, self._sizes):
            self._masters.append(torch.empty(n, dtype=F32))
            self._host_opts.append(self._new_host_opt(n))
            self._host_grads.append(torch.empty(n, dtype=F32))
        self._worker = _AsyncWorker()
        self._host_pool: Optional[concurrent.futures.Executor] = None
        self._bufs = None  # staging buffers, made at the first ship
        self._stream = None
        # seconds by part of the last step (the collect's wait, the ship
        # and fold walls and their copy-stream time), each host pass's
        # seconds, and the count of ships, host passes and folds
        self.last_times: Dict[str, float] = {}
        self.pass_s: List[float] = []
        self.counts = {"host_passes": 0, "folds": 0, "ships": 0}
        self.reinit(params)
        logger.info(
            f"ZenFlow: {len(flat)} tensors, {sum(self._sizes) / 1e6:.1f}M "
            f"elements, topk={self.cfg.topk_ratio:.2%}, update_interval="
            f"{self.cfg.update_interval}, overlap={self.cfg.overlap_step}")

    def _new_host_opt(self, n: int) -> CPUAdam:
        c = self.cfg
        return CPUAdam(n, lr=self.lr, betas=c.betas, eps=c.eps,
                       weight_decay=c.weight_decay)

    @torch.no_grad()
    def reinit(self, params) -> None:
        """Re-seed every piece of state from ``params`` (the tree of the
        init): masters, zeroed host moments and accumulators, the first
        k indices selected, no fold due, the step count 0."""
        self._worker.collect()
        for i, (_, t) in enumerate(leaves(params)):
            self._masters[i].copy_(t.detach().reshape(-1))
            opt = self._host_opts[i]
            for m in opt.moments():
                m.zero_()
            opt.step_count = 0
        dev = self.device
        self._acc = [torch.zeros(n, dtype=F32, device=dev)
                     for n in self._sizes]
        # the first k coordinates of the whole leaf (JAX's arange(k))
        self._idx = [b.to_local(torch.arange(k, device=dev))
                     for b, k in zip(self.blocks, self._ks)]
        self._m = [torch.zeros(i.numel(), dtype=F32, device=dev)
                   for i in self._idx]
        self._v = [torch.zeros(i.numel(), dtype=F32, device=dev)
                   for i in self._idx]
        self._sel_step = [0] * len(self._ks)
        # every coordinate selected since the last fold: its grads never
        # reach the host (zeroed at the ship for the current selection,
        # dropped from the accumulator at a reselection for past ones), so
        # the card's value survives the fold after reselections too
        self._protected: List[Optional[torch.Tensor]] = [None] * len(self._ks)
        # selective updates applied since the last fold: only then can the
        # masters be stale for a coordinate reselected away
        self._updated_since_foldin = [False] * len(self._ks)
        self._fold_due = False
        self.steps = 0

    # -- the card's work ---------------------------------------------------
    def _selective_adam(self, i: int, p: torch.Tensor, g: torch.Tensor,
                        lr: torch.Tensor) -> None:
        """Adam on leaf i's selected coordinates (ZenFlowSelectiveAdamW),
        JAX's operations in its order, the betas as fp32 scalars (JAX's
        jit takes them as fp32 operands: 1 - b1 rounds in fp32); no
        weight decay."""
        dev = self.device
        b1, b2 = (torch.tensor(b, dtype=F32, device=dev)
                  for b in self.cfg.betas)
        idx = self._idx[i]
        step = torch.tensor(float(self._sel_step[i]), dtype=F32, device=dev)
        sel_g = g.reshape(-1)[idx].float()
        m = b1 * self._m[i] + (1 - b1) * sel_g
        v = b2 * self._v[i] + (1 - b2) * sel_g * sel_g
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        upd = (lr * mhat) / (torch.sqrt(vhat) + self.cfg.eps)
        flat = p.view(-1)
        flat[idx] = (flat[idx].float() + upd.neg()).to(p.dtype)
        self._m[i], self._v[i] = m, v

    def _reselect(self, i: int, initial: bool = False) -> None:
        """Re-pick leaf i's top-k coordinates by |accumulated grad| (JAX's
        ``select_strategy='auto'``). The old selection's accumulated
        grads are dropped (the card applied them) and, where the card
        updated them since the last fold, the old coordinates join the
        protected set until the next fold."""
        if not initial:
            old = self._idx[i]
            self._acc[i].index_fill_(0, old, 0.0)
            if self._updated_since_foldin[i]:
                prev = self._protected[i]
                self._protected[i] = old if prev is None \
                    else torch.cat([prev, old])
        self._idx[i] = self._topk(i)
        self._m[i] = torch.zeros(self._idx[i].numel(), dtype=F32,
                                 device=self.device)
        self._v[i] = torch.zeros_like(self._m[i])
        self._sel_step[i] = 0

    def _topk(self, i: int) -> torch.Tensor:
        """Leaf i's top-k coordinates by |accumulated grad| over the
        whole leaf, as this rank's block indices: the block's own top-k
        where the leaf is whole here, else the merge of every rank's
        candidates (module docstring)."""
        a, k, blk = self._acc[i].abs(), self._ks[i], self.blocks[i]
        if blk.count == 1 or blk.dim is None:
            return topk_indices(a, k)
        local = topk_indices(a, min(k, a.numel()))
        values = self._gather(a[local])
        flat = self._gather(blk.to_global(local))
        return blk.to_local(merge_topk(values, flat, k))

    def global_indices(self, i: int) -> torch.Tensor:
        """Leaf i's coordinates selected on this rank, as whole-leaf flat
        indices."""
        return self.blocks[i].to_global(self._idx[i])

    # -- the host pass -----------------------------------------------------
    def _host_pass(self, lr: float) -> None:
        """The native Adam over every leaf's master with the shipped
        grads (already divided by the interval), in place. With workers
        > 1 the leaves split across a thread pool (the native step
        releases the GIL)."""
        t0 = time.perf_counter()

        def one(i):
            self._host_opts[i].step(self._masters[i], self._host_grads[i],
                                    lr=lr)

        if self.cfg.workers <= 1 or len(self._masters) <= 1:
            for i in range(len(self._masters)):
                one(i)
        else:
            if self._host_pool is None:  # one pool for the whole run
                self._host_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.cfg.workers,
                    thread_name_prefix="zenflow-host")
            list(self._host_pool.map(one, range(len(self._masters))))
        self.counts["host_passes"] += 1
        self.pass_s.append(time.perf_counter() - t0)

    # -- ship and fold -----------------------------------------------------
    def _chunks(self) -> List[Tuple[int, int, int]]:
        c = self.chunk_elems
        return [(i, s, min(c, n - s)) for i, n in enumerate(self._sizes)
                for s in range(0, n, c)]

    def _staging(self):
        if self._bufs is None:
            c = self.chunk_elems
            self._bufs = [torch.empty(c, dtype=F32, pin_memory=self._cuda)
                          for _ in range(4)]
            if self._cuda:
                self._stream = torch.cuda.Stream(self.device)
        return self._bufs

    def _pipeline(self, chunks, issue, finish=None, prepare=None) -> float:
        """For each chunk: ``prepare(chunk, buf)`` (host work into a free
        staging buffer), ``issue(chunk, buf)`` (card work on the side
        stream), and ``finish(chunk, buf)`` once the chunk's copy is done
        (host work), at most one chunk per staging buffer in flight; on
        the CPU all three run in turn. Returns the copy stream's busy
        seconds (CUDA events around ``issue``; 0 on the CPU)."""
        bufs = self._staging()
        if not self._cuda:
            for ch in chunks:
                for fn in (prepare, issue, finish):
                    if fn is not None:
                        fn(ch, bufs[0])
            return 0.0
        stream, cur = self._stream, torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        pending, events = deque(), []

        def drain_one():
            ch, buf, a, b = pending.popleft()
            b.synchronize()
            if finish is not None:
                finish(ch, buf)
            events.append((a, b))

        for j, ch in enumerate(chunks):
            if len(pending) == len(bufs):
                drain_one()
            buf = bufs[j % len(bufs)]
            if prepare is not None:
                prepare(ch, buf)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                a.record(stream)
                issue(ch, buf)
                b.record(stream)
            pending.append((ch, buf, a, b))
        while pending:
            drain_one()
        cur.wait_stream(stream)
        return sum(a.elapsed_time(b) for a, b in events) / 1e3

    @torch.no_grad()
    def _ship(self) -> None:
        """The accumulated grads, the selected coordinates zeroed and
        divided by the interval, into the host grad buffers; the
        accumulators zeroed."""
        t0 = time.perf_counter()
        denom = torch.tensor(float(self.cfg.update_interval), dtype=F32,
                             device=self.device)
        for acc, idx in zip(self._acc, self._idx):
            acc.index_fill_(0, idx, 0.0)

        def issue(ch, buf):
            i, s, n = ch
            src = torch.div(self._acc[i][s:s + n], denom)
            if self._cuda:
                buf[:n].copy_(src, non_blocking=True)
            else:
                self._host_grads[i][s:s + n].copy_(src)

        def finish(ch, buf):
            i, s, n = ch
            if self._cuda:
                self._host_grads[i][s:s + n].copy_(buf[:n])

        copy_s = self._pipeline(self._chunks(), issue, finish)
        for acc in self._acc:
            acc.zero_()
        self.counts["ships"] += 1
        self.last_times.update(ship=time.perf_counter() - t0,
                               ship_copy=copy_s)

    @torch.no_grad()
    def _fold(self, p_leaves: List[torch.Tensor]) -> None:
        """The masters into the params, but the coordinates selected
        since the last fold, which keep the card's values; the masters
        then take those values too (JAX rebuilds them from the folded
        tree). Reads the masters in place: the worker must be idle."""
        assert not self._worker.busy, "fold with a host pass in flight"
        t0 = time.perf_counter()
        lib = require_native_lib()
        kept = []
        for i, p in enumerate(p_leaves):
            keep = self._idx[i]
            if self._protected[i] is not None:
                keep = torch.cat([keep, self._protected[i]])
            kept.append((keep, p.view(-1)[keep].clone()))

        def cast(ch, buf):  # the master chunk in the params' dtype
            i, s, n = ch
            src, dtype = self._masters[i][s:s + n], p_leaves[i].dtype
            out = buf.view(dtype)[:n]
            if dtype == torch.bfloat16:
                lib.dstpu_f32_to_bf16(src.data_ptr(), out.data_ptr(), n)
            else:
                out.copy_(src)

        def issue(ch, buf):
            i, s, n = ch
            p = p_leaves[i].view(-1)[s:s + n]
            if self._cuda:
                p.copy_(buf.view(p.dtype)[:n], non_blocking=True)
            else:
                p.copy_(self._masters[i][s:s + n])  # rounds to nearest even

        copy_s = self._pipeline(self._chunks(), issue,
                                prepare=cast if self._cuda else None)
        for i, p in enumerate(p_leaves):
            keep, vals = kept[i]
            p.view(-1)[keep] = vals
            self._masters[i][keep.cpu()] = vals.float().cpu()
            self._protected[i] = None
            self._updated_since_foldin[i] = False
        self._fold_due = False
        self.counts["folds"] += 1
        self.last_times.update(fold=time.perf_counter() - t0,
                               fold_copy=copy_s)

    # -- the step ----------------------------------------------------------
    @torch.no_grad()
    def step(self, grads, params, lr: Optional[float] = None):
        """One update of ``params`` (in place) from ``grads`` (same
        tree, the params' dtype). Returns ``params``."""
        lr = self.lr if lr is None else float(lr)
        self.steps += 1
        cfg = self.cfg
        g_leaves = [g for _, g in leaves(grads)]
        p_leaves = [p for _, p in leaves(params)]
        self.last_times = {}
        # the fold schedule is step-deterministic (JAX's): with overlap the
        # pass had a whole interval and the boundary collects it; without,
        # the pass ran at the ship and the next step folds it
        if cfg.overlap_step:
            if self.steps % cfg.update_interval == 0:
                t0 = time.perf_counter()
                if self._worker.collect():
                    self._fold_due = True
                self.last_times["collect_wait"] = time.perf_counter() - t0
                if self._fold_due:
                    self._fold(p_leaves)
        elif self.steps > 1 and (self.steps - 1) % cfg.update_interval == 0:
            if self._fold_due:
                self._fold(p_leaves)

        lr_t = torch.tensor(lr, dtype=F32, device=self.device)
        reselect = (self.steps - 1) % cfg.select_interval == 0
        for i, (p, g) in enumerate(zip(p_leaves, g_leaves)):
            self._acc[i].add_(g.reshape(-1))
            if reselect:
                self._reselect(i, initial=self.steps == 1)
            self._sel_step[i] += 1
            self._selective_adam(i, p, g, lr_t)
            self._updated_since_foldin[i] = True

        if self.steps % cfg.update_interval == 0:
            self._ship()
            if self._worker.busy:  # the previous pass still runs: wait
                self._worker.collect()
                self._fold_due = True
            if cfg.overlap_step:
                self._worker.submit(self._host_pass, lr)
            else:
                self._host_pass(lr)
                self._fold_due = True
        return params

    def finalize(self) -> bool:
        """Wait for a host pass in flight (end of training, before a
        checkpoint); True when a fold is due."""
        if self._worker.collect():
            self._fold_due = True
        return self._fold_due

    def close(self) -> None:
        """Wait for the pass in flight and shut the worker pool down
        (idempotent)."""
        self._worker.collect()
        if self._host_pool is not None:
            self._host_pool.shutdown(wait=True)
            self._host_pool = None

    def __del__(self):  # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:
            pass

    # -- whole-leaf access ---------------------------------------------------
    def _leaf(self, path: str) -> int:
        key = "/" + path.strip("/")
        if key not in self.paths:
            raise KeyError(f"no ZenFlow leaf {path!r}; known leaves: "
                           f"{self.paths[:10]}...")
        return self.paths.index(key)

    def full_fp32_param(self, path: str) -> torch.Tensor:
        """The host master of leaf ``path`` (``/layers/attn/wq``), in the
        leaf's shape, after any pass in flight."""
        self.finalize()
        i = self._leaf(path)
        return self._masters[i].view(self.shapes[i])

    @torch.no_grad()
    def set_full_fp32_param(self, path: str, value) -> None:
        i = self._leaf(path)
        value = torch.as_tensor(value, dtype=F32).to("cpu")
        if tuple(value.shape) != self.shapes[i]:
            raise ValueError(f"{path}: shape {tuple(value.shape)}, the leaf "
                             f"is {self.shapes[i]}")
        self.finalize()
        self._masters[i].copy_(value.reshape(-1))

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JAX's keys (lists by leaf; per-leaf lists of one shard), and
        ``fold_due``. Waits for a pass in flight first. The tensors are
        the live ones (the worker is idle): a caller that keeps them
        across steps copies them."""
        self.finalize()
        return {
            "steps": self.steps,
            "masters": [[m] for m in self._masters],
            "shard_index": [[b.index_pairs()] for b in self.blocks],
            "host_opt": [[o.state_dict()] for o in self._host_opts],
            "idx": list(self._idx), "m": list(self._m), "v": list(self._v),
            "acc": list(self._acc),
            "sel_step": list(self._sel_step),
            "protected": list(self._protected),
            "updated_since_foldin": list(self._updated_since_foldin),
            "fold_due": self._fold_due,
        }

    def check_state_dict(self, sd: Dict[str, Any]) -> None:
        """Raise ValueError unless ``sd`` fits this optimizer's leaves."""
        n = len(self._sizes)
        for key in ("masters", "host_opt", "idx", "m", "v", "acc",
                    "sel_step"):
            if len(sd[key]) != n:
                raise ValueError(f"zenflow state: {len(sd[key])} leaves of "
                                 f"'{key}', the optimizer has {n}")
        index = sd.get("shard_index")
        for i in range(n):
            own = [self.blocks[i].index_pairs()]
            if index is not None and [tuple(tuple(int(x) for x in e)
                                            for e in shard)
                                      for shard in index[i]] != own:
                raise ValueError(
                    f"zenflow state: leaf {self.paths[i]} was saved in "
                    "other shards than this rank's block (the checkpoint "
                    "reslices a save at another world size first)")
            sel = torch.as_tensor(sd["idx"][i]).numel()
            if sel > self._ks[i]:
                raise ValueError(
                    f"zenflow state: leaf {self.paths[i]} selects {sel} "
                    f"coordinates, the optimizer keeps {self._ks[i]}")
            checks = ((sd["masters"][i][0], self._sizes[i]),
                      (sd["host_opt"][i][0]["exp_avg"], self._sizes[i]),
                      (sd["host_opt"][i][0]["exp_avg_sq"], self._sizes[i]),
                      (sd["acc"][i], self._sizes[i]),
                      (sd["m"][i], sel), (sd["v"][i], sel))
            for t, want in checks:
                if torch.as_tensor(t).numel() != want:
                    raise ValueError(
                        f"zenflow state: leaf {self.paths[i]} holds "
                        f"{torch.as_tensor(t).numel()} elements where the "
                        f"optimizer has {want}")

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy a state dict in (every shape checked before anything
        changes)."""
        self.check_state_dict(sd)
        n = len(self._sizes)
        self._worker.collect()
        dev = self.device
        for i in range(n):
            self._masters[i].copy_(torch.as_tensor(
                sd["masters"][i][0]).reshape(-1))
            self._host_opts[i].load_state_dict(sd["host_opt"][i][0])
            self._acc[i].copy_(torch.as_tensor(sd["acc"][i]).reshape(-1))
            self._idx[i] = torch.as_tensor(sd["idx"][i]).to(
                dev, torch.int64).reshape(-1)
            self._m[i] = torch.as_tensor(sd["m"][i]).to(dev, F32, copy=True)
            self._v[i] = torch.as_tensor(sd["v"][i]).to(dev, F32, copy=True)
            prot = sd.get("protected", [None] * n)[i]
            self._protected[i] = None if prot is None else \
                torch.as_tensor(prot).to(dev, torch.int64).reshape(-1)
        self.steps = int(sd["steps"])
        self._sel_step = [int(s) for s in sd["sel_step"]]
        # missing in a JAX-era state: protect (a spurious protection is
        # harmless, a missed one reverts the card's updates)
        self._updated_since_foldin = [bool(b) for b in sd.get(
            "updated_since_foldin", [True] * n)]
        self._fold_due = bool(sd.get("fold_due", False))


def reslice_state(sds: List[Dict[str, Any]], blocks: List[LeafBlock]
                  ) -> Dict[str, Any]:
    """This rank's state dict (its ``blocks``, one a leaf) from the state
    dicts every rank of a save at another world size wrote (JAX's
    ``load_state_dict`` reslice, ``runtime/zenflow.py:516-549``): the
    masters, host moments and accumulators reassembled whole from their
    ``shard_index`` and cut to the block; the selections, their moments
    and the protected sets joined as whole-leaf indices and kept where
    they fall in the block. A block saved twice (dp replicas) counts
    once."""
    first = sds[0]
    out = {key: first[key] for key in ("steps", "sel_step",
                                       "updated_since_foldin")}
    out["fold_due"] = first.get("fold_due", False)
    for key in ("masters", "shard_index", "host_opt", "idx", "m", "v",
                "acc", "protected"):
        out[key] = []
    for i, blk in enumerate(blocks):
        shape, n = blk.shape, int(np.prod(blk.shape))
        whole = {k: torch.zeros(n, dtype=F32) for k in
                 ("masters", "exp_avg", "exp_avg_sq", "acc")}
        sel, m, v, prot, seen = [], [], [], [], set()
        for sd in sds:
            pairs = tuple(tuple(int(x) for x in e)
                          for e in sd["shard_index"][i][0])
            if pairs in seen:
                continue
            seen.add(pairs)
            src = LeafBlock.from_pairs(shape, pairs)
            cut = tuple(slice(a, b) for a, b in pairs)
            part = tuple(b - a for a, b in pairs)
            opt = sd["host_opt"][i][0]
            for key, t in (("masters", sd["masters"][i][0]),
                           ("exp_avg", opt["exp_avg"]),
                           ("exp_avg_sq", opt["exp_avg_sq"]),
                           ("acc", sd["acc"][i])):
                whole[key].view(shape)[cut] = torch.as_tensor(
                    t).float().reshape(part)
            idx = torch.as_tensor(sd["idx"][i]).long().reshape(-1).cpu()
            sel.append(src.to_global(idx))
            m.append(torch.as_tensor(sd["m"][i]).float().reshape(-1).cpu())
            v.append(torch.as_tensor(sd["v"][i]).float().reshape(-1).cpu())
            if sd["protected"][i] is not None:
                prot.append(src.to_global(torch.as_tensor(
                    sd["protected"][i]).long().reshape(-1).cpu()))
        mine = tuple(slice(a, b) for a, b in blk.index_pairs())

        def block(t):
            return t.view(shape)[mine].reshape(-1).clone()

        out["masters"].append([block(whole["masters"])])
        out["shard_index"].append([blk.index_pairs()])
        out["host_opt"].append([{
            "exp_avg": block(whole["exp_avg"]),
            "exp_avg_sq": block(whole["exp_avg_sq"]),
            "step": int(first["host_opt"][i][0]["step"])}])
        out["acc"].append(block(whole["acc"]))
        keep, local = blk.split(torch.cat(sel))
        out["idx"].append(local)
        out["m"].append(torch.cat(m)[keep])
        out["v"].append(torch.cat(v)[keep])
        out["protected"].append(
            blk.to_local(torch.cat(prot)) if prot else None)
    return out


__all__ = ["ZenFlowConfig", "ZenFlowOptimizer", "LeafBlock", "merge_topk",
           "reslice_state", "topk_indices"]
