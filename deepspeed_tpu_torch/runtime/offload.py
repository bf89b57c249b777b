"""ZeRO-Offload: host fp32 masters and moments, stepped by the native
CPU optimizer (port of ``deepspeed_tpu/runtime/offload.py``).

The card computes the gradients in the compute dtype; the fp32 masters
and the optimizer moments live on the host (``offload_optimizer.device
"cpu"``) or in files on a local disk (``"nvme"``). At world size 1 each
leaf is one shard. Across ranks each rank holds the host state of its
own ZeRO block of every leaf (the engine hands it the blocks of
``runtime/zero.ZeroPartition``, JAX's unique addressable shards), steps
only those, and the engine gathers the updated compute-dtype blocks as
the stage gathers them. One ``step``:

  1. the global gradient norm, on the card in fp32, one chunk at a time,
     with one host sync (JAX sums the host copies in double: the two
     differ at rounding level, ROADMAP C); across ranks each element is
     counted once, on the rank that owns it (``include``, JAX's
     ``_owned_keys``), and the ranks' sums of squares are summed
     (``reduce``);
  2. one coefficient that applies the loss-scale unscaling and the clip
     (``clip / (gnorm + 1e-6)`` where the norm exceeds the clip), and the
     fp16-only overflow skip (a non-finite norm leaves everything as it
     was);
  3. every leaf streamed through in chunks of at most ``chunk_elems``
     elements: the gradient chunk is copied device -> host (fp32, or
     bf16 under ``grad_transfer_dtype: "bf16"``) into one of
     ``buffer_count`` staging buffers on a side CUDA stream, up to
     ``buffer_count`` chunks ahead of the host, scaled by the coefficient
     on the way (fp32) or on the host (bf16, widened first, as in JAX);
     the host runs the native step on the
     master and moment chunks (``ops/native/cpu_optimizer.py``), which
     writes the updated chunk as bf16 for a bf16 model; that chunk is
     copied host -> device into the engine's compute parameter in place
     (the GAS > 1 bookkeeping and any hooks stay bound), on the same
     stream, from one of two output buffers.

A leaf whose gradient and compute param already live in host memory
(the layer stack under ``offload_param``, ``runtime/param_stream.py``,
its gradient in fp32) skips the copies: the chunk of its gradient is
scaled in place on the host (the same fp32 product), the native step
writes the bf16 chunk straight into the host param, and its norm is
summed on the host (``torch.dot``), in the same leaf order, so the clip
coefficient differs from the all-card sum at rounding level.

Streaming bounds the host's staging memory at ``buffer_count`` chunks
(JAX copies every gradient to the host before the first update: at
Llama-3-8B's 8.03 B parameters that would add 32 GB of fp32 gradients),
and overlaps the copies with the host step. With ``pin_memory`` the
staging buffers are page-locked, so the copies run asynchronously; the
masters and moments are never pinned (96 GB at 8 B parameters may
exceed the lock limit).

On the NVMe tier each leaf's master and moments are three files of a
``TensorSwapStore`` under ``<nvme_path>/dstpu_opt_swap_<pid>/rank<r>``
(one directory a rank, as JAX's ``rank<process_index>``);
a step reads each chunk's ranges into page-aligned buffers, steps them
and writes them back, so the resident optimizer state is one chunk. Both
tiers run the same native step on the same values in the same order:
their losses and masters are equal bit for bit.
"""

from __future__ import annotations

import logging
import math
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.native.aio import PinnedBuffer
from deepspeed_tpu_torch.ops.native.builder import require_native_lib
from deepspeed_tpu_torch.ops.native.cpu_optimizer import CPU_OPTIMIZERS
from deepspeed_tpu_torch.runtime.optimizer import leaves, set_leaf
from deepspeed_tpu_torch.runtime.swap_tensor.swapper import TensorSwapStore

logger = logging.getLogger(__name__)

Tree = Dict[str, object]
CHUNK_ELEMS = 1 << 26  # 256 MB of fp32 a staging buffer
XFER_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _key(path: str) -> str:
    """A leaf path in ``leaves``' form (``/layers/attn/wq``)."""
    return "/" + path.strip("/")


class HostOffloadOptimizer:
    """The host-resident fp32 masters and moments of every leaf of
    ``params`` (a tree of tensors on any device, in any float dtype), and
    their native step. A leaf that is already a CPU fp32 tensor becomes
    its own master (shared, not copied), as the device path shares an
    fp32 model's tensors."""

    def __init__(self, params: Tree, optimizer_name: str = "adamw",
                 optimizer_params: Optional[dict] = None,
                 grad_clip: float = 0.0, nvme_path: Optional[str] = None,
                 buffer_count: int = 4, pin_memory: bool = False,
                 grad_transfer_dtype: str = "fp32",
                 chunk_elems: int = CHUNK_ELEMS, rank: int = 0):
        require_native_lib()  # no numpy fallback: fail here, loudly
        optimizer_params = dict(optimizer_params or {})
        self.lr = float(optimizer_params.pop("lr", 1e-3))
        name = optimizer_name.lower()
        if name in ("adam", "adamw"):
            optimizer_params.setdefault("adamw_mode", name == "adamw")
        self._opt_cls = CPU_OPTIMIZERS.get(name)
        if self._opt_cls is None:
            raise ValueError(
                f"host offload supports {sorted(CPU_OPTIMIZERS)}, got {name!r}")
        self._opt_kwargs = optimizer_params
        self.grad_clip = grad_clip
        if grad_transfer_dtype not in XFER_DTYPES:
            raise ValueError("grad_transfer_dtype must be fp32|bf16, got "
                             f"{grad_transfer_dtype!r}")
        self.xfer_dtype = XFER_DTYPES[grad_transfer_dtype]
        self.buffer_count = max(1, int(buffer_count))
        self.pin_memory = pin_memory
        self.count = 0  # updates applied (the LR schedule's position)

        self._swap: Optional[TensorSwapStore] = None
        if nvme_path:
            self.swap_folder = os.path.join(
                nvme_path, f"dstpu_opt_swap_{os.getpid()}", f"rank{rank}")
            self._swap = TensorSwapStore(self.swap_folder)
        self._moments_on_disk: set = set()

        self.masters: Dict[str, Optional[torch.Tensor]] = {}
        self.optimizers: Dict[str, object] = {}
        self.shapes: Dict[str, torch.Size] = {}
        for path, leaf in leaves(params):
            self._add_leaf(path, leaf)
        if self._swap is not None:
            self._swap.wait()
        numel = [o.n for o in self.optimizers.values()]
        self.chunk_elems = max(1, min(int(chunk_elems), max(numel)))
        self._bufs = None  # staging buffers, made at the first step
        self._stream = None
        self._host_leaves = False  # some grads live on the host already
        self.last_step_s: Dict[str, float] = {}
        logger.info(f"host offload optimizer: {len(numel)} leaves, "
                    f"{sum(numel) / 1e6:.1f}M elements on "
                    f"{'nvme' if self._swap else 'cpu'}")

    @property
    def tier(self) -> str:
        return "nvme" if self._swap is not None else "cpu"

    def _new_optimizer(self, n: int):
        return self._opt_cls(n, lr=self.lr, **self._opt_kwargs)

    def _add_leaf(self, path: str, leaf: torch.Tensor) -> None:
        master = leaf.detach().to("cpu", torch.float32).reshape(-1)
        self.shapes[path] = leaf.shape
        opt = self._new_optimizer(master.numel())
        self.optimizers[path] = opt
        if self._swap is None:
            self.masters[path] = master
            return
        opt.detach_state()  # the moments live in the swap store
        self._swap.register(f"{path}.master", master)
        for name in opt.state_names:
            self._swap.reserve(f"{path}.{name}", opt.n, torch.float32)
        self._swap.wait()  # the write is done before the copy goes
        self.masters[path] = None

    # -- the step ----------------------------------------------------------
    def _chunks(self) -> List[Tuple[str, int, int]]:
        c = self.chunk_elems
        return [(path, s, min(c, opt.n - s))
                for path, opt in self.optimizers.items()
                for s in range(0, opt.n, c)]

    def _make_buffers(self, device: torch.device) -> None:
        pin = self.pin_memory and device.type == "cuda"
        c = self.chunk_elems

        def buf(dtype):
            return torch.empty(c, dtype=dtype, pin_memory=pin)

        self._bufs = {
            "grad": [buf(self.xfer_dtype) for _ in range(self.buffer_count)],
            "grad32": buf(torch.float32),  # bf16 widened for the scaling
            "out": [buf(torch.bfloat16) for _ in range(2)],
            "out_ev": [None, None],
        }
        if self._swap is not None:
            # page-aligned: the native reads and writes take O_DIRECT
            n_state = len(next(iter(self.optimizers.values())).state_names)
            self._swap_bufs = [PinnedBuffer(c * 4) for _ in range(1 + n_state)]
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device)

    @torch.no_grad()
    def grad_norm(self, grads: Tree, grad_scale: Optional[float] = None,
                  include=None, reduce=None) -> float:
        """The global L2 norm of the unscaled grads as they cross to the
        host (cast to the transfer dtype): squares summed in fp32 on the
        grads' device, ``CHUNK_ELEMS`` at a time (whatever the staging
        chunk), read once. ``include(path)`` picks the leaves this rank
        counts and ``reduce`` sums the ranks' fp32 sums (across ranks)."""
        total = None
        for path, g in leaves(grads):
            if include is not None and not include(path):
                continue
            flat = g.detach().reshape(-1)
            for part in flat.split(CHUNK_ELEMS):
                if part.device.type == "cpu" and self._host_leaves:
                    # a streamed leaf: its gradient crossed already, in
                    # fp32, and is summed where it is
                    x = part if part.dtype == torch.float32 else part.float()
                    sq = torch.dot(x, x)
                else:
                    x = part.to(self.xfer_dtype).float()
                    sq = torch.sum(x * x)
                total = sq if total is None else total + sq.to(total.device)
        if total is None:
            dev = next(g.device for _, g in leaves(grads))
            total = torch.zeros((), dtype=torch.float32, device=dev)
        if reduce is not None:
            total = reduce(total.float())
        sq = float(total)
        if grad_scale and grad_scale != 1.0:
            sq /= grad_scale ** 2
        return math.sqrt(sq)

    @torch.no_grad()
    def step(self, grads: Tree, params: Tree, lr: Optional[float] = None,
             grad_scale: Optional[float] = None,
             skip_on_nonfinite: bool = False, include=None,
             reduce=None) -> Tuple[float, bool]:
        """One update: the masters and moments in place, and ``params``
        (the engine's compute params, same tree; this rank's blocks
        across ranks) recast from the masters in place. ``include`` and
        ``reduce`` make the norm global across ranks (``grad_norm``).
        Returns (grad norm, overflow)."""
        lr = self.lr if lr is None else float(lr)
        flat_g, flat_p = dict(leaves(grads)), dict(leaves(params))
        if sorted(flat_g) != sorted(self.optimizers):
            raise ValueError("grad tree does not match the offloaded leaves")
        devices = {g.device for g in flat_g.values()}
        # an engine on the card with some grads on the host already
        self._host_leaves = len({d.type for d in devices}) > 1
        device = next((d for d in devices if d.type != "cpu"),
                      next(iter(devices)))
        if device.type == "cuda":
            # the backward's tail finishes here, so "norm" times the norm
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        gnorm = self.grad_norm(grads, grad_scale, include, reduce)
        norm_s = time.perf_counter() - t0
        coef = 1.0
        if grad_scale and grad_scale != 1.0:
            coef /= grad_scale
        if self.grad_clip and gnorm > self.grad_clip:
            coef *= self.grad_clip / (gnorm + 1e-6)
        # only the fp16 loss-scaling protocol skips an overflow step; a
        # bf16 run applies it, so a NaN source shows
        if skip_on_nonfinite and not math.isfinite(gnorm):
            self.last_step_s = {"norm": norm_s}
            return gnorm, True

        if self._bufs is None:
            self._make_buffers(device)
        for opt in self.optimizers.values():
            opt.step_count += 1
        times = self._stream_step(flat_g, flat_p, lr, coef, device)
        self.count += 1
        self.last_step_s = {"norm": norm_s, **times,
                            "total": time.perf_counter() - t0}
        return gnorm, False

    def _stream_step(self, flat_g, flat_p, lr, coef, device):
        """The chunk pipeline of ``step``; returns seconds by part: the
        host's waits for the device->host and host->device copies, the
        host scaling, the native step and the NVMe swap; on the card also
        the copies' own time on the copy stream (CUDA events)."""
        cuda = device.type == "cuda"
        stream, bufs = self._stream, self._bufs
        chunks = self._chunks()
        nb = self.buffer_count
        # fp32 grads are scaled on their way down (one fp32 product, as
        # JAX's host ``g * np.float32(coef)``); bf16 ones on the host,
        # widened first, as in JAX
        on_device = coef != 1.0 and self.xfer_dtype == torch.float32
        coef_dev = torch.tensor(coef, dtype=torch.float32, device=device)
        coef_host = torch.tensor(coef, dtype=torch.float32)
        t = dict.fromkeys(("d2h_wait", "scale", "host_step", "swap",
                           "h2d_wait"), 0.0)
        events = {"d2h": [], "h2d": []}
        clock = time.perf_counter

        def timed(kind, fn):
            """``fn`` on the copy stream, bracketed by timing events."""
            if not cuda:
                fn()
                return None
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                a.record(stream)
                fn()
                b.record(stream)
            events[kind].append((a, b))
            return b

        def hosted(path):
            return self._host_leaves and flat_g[path].device.type == "cpu"

        def d2h(i):
            path, s, n = chunks[i]
            if hosted(path):
                return None  # read where it is
            src = flat_g[path].detach().reshape(-1)[s:s + n]
            dst = bufs["grad"][i % nb][:n]
            coef_t = coef_host if src.device.type == "cpu" else coef_dev

            def copy():
                x = src.to(self.xfer_dtype)
                if on_device:
                    x = x.mul(coef_t)
                dst.copy_(x, non_blocking=True)

            return timed("d2h", copy)

        def wait(ev, key):
            t0 = clock()
            if ev is not None:
                ev.synchronize()
            t[key] += clock() - t0

        if cuda:
            stream.wait_stream(torch.cuda.current_stream(device))
        pending = deque(d2h(i) for i in range(min(nb, len(chunks))))
        for i, (path, s, n) in enumerate(chunks):
            wait(pending.popleft(), "d2h_wait")
            if hosted(path):
                self._host_chunk(flat_g, flat_p, path, s, n, lr, coef,
                                 coef_host, t)
                if i + nb < len(chunks):
                    pending.append(d2h(i + nb))
                continue
            g = bufs["grad"][i % nb][:n]
            t0 = clock()
            if coef != 1.0 and not on_device:
                # the native bf16-gradient kernel takes unscaled grads
                # only: widen, then scale
                g = bufs["grad32"][:n].copy_(g).mul_(coef_host)
            t1 = clock()
            t["scale"] += t1 - t0
            master, state = self._host_state(path, s, n)
            t["swap"] += clock() - t1
            param = flat_p[path].detach().reshape(-1)[s:s + n]
            bf16_out = param.dtype == torch.bfloat16
            j = i % 2
            if bf16_out:
                wait(bufs["out_ev"][j], "h2d_wait")  # the buffer is free
            out = bufs["out"][j][:n] if bf16_out else None
            t0 = clock()
            self.optimizers[path].update(master, g, state, out, lr)
            t["host_step"] += clock() - t0
            if i + nb < len(chunks):
                pending.append(d2h(i + nb))  # this buffer is free again
            src = out if bf16_out else master
            bufs["out_ev"][j] = timed("h2d", lambda: param.copy_(
                src, non_blocking=bf16_out))
            t0 = clock()
            self._write_back(path, s, master, state)
            t["swap"] += clock() - t0
        if self._swap is not None:
            t0 = clock()
            self._swap.wait()
            self._moments_on_disk.update(self.optimizers)
            t["swap"] += clock() - t0
        if cuda:
            t0 = clock()
            stream.synchronize()
            torch.cuda.current_stream(device).wait_stream(stream)
            t["h2d_wait"] += clock() - t0
            for kind, pairs in events.items():
                t[f"{kind}_copy"] = sum(a.elapsed_time(b)
                                        for a, b in pairs) / 1e3
        return t

    def _host_chunk(self, flat_g, flat_p, path, s, n, lr, coef, coef_host,
                    t) -> None:
        """One chunk of a host-resident leaf: its fp32 gradient scaled in
        place (it is consumed by this step), the native step, the bf16
        param written in place."""
        clock = time.perf_counter
        g = flat_g[path].detach().reshape(-1)[s:s + n]
        t0 = clock()
        if g.dtype != torch.float32:
            g = self._bufs["grad32"][:n].copy_(g)
        if coef != 1.0:
            g.mul_(coef_host)
        t1 = clock()
        t["scale"] += t1 - t0
        master, state = self._host_state(path, s, n)
        t["swap"] += clock() - t1
        param = flat_p[path].detach().reshape(-1)[s:s + n]
        out = param if param.dtype == torch.bfloat16 else None
        t0 = clock()
        self.optimizers[path].update(master, g, state, out, lr)
        t["host_step"] += clock() - t0
        if out is None and param.data_ptr() != master.data_ptr():
            param.copy_(master)
        t0 = clock()
        self._write_back(path, s, master, state)
        t["swap"] += clock() - t0

    def _host_state(self, path: str, s: int, n: int):
        """The master and moment chunks of ``path`` at [s, s + n): views
        of the resident tensors, or the swap buffers read from disk."""
        opt = self.optimizers[path]
        if self._swap is None:
            return (self.masters[path][s:s + n],
                    tuple(m[s:s + n] for m in opt.moments()))
        self._swap.wait()  # the last chunk's writes are out of the buffers
        master, *state = [b.tensor[:n] for b in self._swap_bufs]
        self._swap.swap_in(f"{path}.master", master, offset=s, sync=False)
        if path in self._moments_on_disk:
            for name, buf in zip(opt.state_names, state):
                self._swap.swap_in(f"{path}.{name}", buf, offset=s,
                                   sync=False)
        else:
            for buf in state:
                buf.zero_()
        self._swap.wait()
        return master, tuple(state)

    def _write_back(self, path, s, master, state) -> None:
        if self._swap is None:
            return
        opt = self.optimizers[path]
        self._swap.swap_out(f"{path}.master", master, offset=s)
        for name, buf in zip(opt.state_names, state):
            self._swap.swap_out(f"{path}.{name}", buf, offset=s)

    # -- whole-leaf access -------------------------------------------------
    def _master_of(self, path: str) -> torch.Tensor:
        if self._swap is not None:
            return self._swap.swap_in(f"{path}.master")
        return self.masters[path]

    def _moments_of(self, path: str) -> Dict[str, torch.Tensor]:
        opt = self.optimizers[path]
        if self._swap is None:
            return dict(zip(opt.state_names, opt.moments()))
        if path not in self._moments_on_disk:
            return {name: torch.zeros(opt.n) for name in opt.state_names}
        return {name: self._swap.swap_in(f"{path}.{name}")
                for name in opt.state_names}

    def _leaf(self, path: str) -> str:
        key = _key(path)
        if key not in self.optimizers:
            raise KeyError(f"no offloaded leaf {path!r}; known leaves: "
                           f"{sorted(self.optimizers)[:10]}...")
        return key

    def full_fp32_param(self, path: str) -> torch.Tensor:
        """The fp32 master of leaf ``path`` (``/layers/attn/wq``), in the
        leaf's shape."""
        key = self._leaf(path)
        return self._master_of(key).reshape(self.shapes[key])

    def set_full_fp32_param(self, path: str, value) -> None:
        key = self._leaf(path)
        value = torch.as_tensor(value, dtype=torch.float32).to("cpu")
        if tuple(value.shape) != tuple(self.shapes[key]):
            raise ValueError(f"{path}: shape {tuple(value.shape)}, the leaf "
                             f"is {tuple(self.shapes[key])}")
        if self._swap is not None:
            self._swap.swap_out(f"{key}.master",
                                value.reshape(-1).contiguous(), sync=True)
        else:
            self.masters[key].copy_(value.reshape(-1))

    def full_optimizer_state(self, path: str, state_key: str
                             ) -> Optional[torch.Tensor]:
        """Moment ``state_key`` (``exp_avg``, ...) of leaf ``path``, or
        None when the optimizer has no such state."""
        key = self._leaf(path)
        m = self._moments_of(key).get(state_key)
        return None if m is None else m.reshape(self.shapes[key])

    # -- checkpoint surface ------------------------------------------------
    def state_dict(self) -> Tree:
        """``{"master": tree, <moment>: tree, ..., "step": tree}``, each
        tree shaped like the params with flat fp32 leaves (the step counts
        as 0-dim int64). On the cpu tier the leaves are the live tensors
        (a load copies into them); on the NVMe tier they are copies read
        from the swap store, all at once, as in JAX."""
        out: Tree = {}
        for path, opt in self.optimizers.items():
            set_leaf(out.setdefault("master", {}), path, self._master_of(path))
            for name, m in self._moments_of(path).items():
                set_leaf(out.setdefault(name, {}), path, m)
            set_leaf(out.setdefault("step", {}), path,
                 torch.tensor(opt.step_count, dtype=torch.int64))
        return out

    def load_state_dict(self, sd: Tree) -> None:
        masters, steps = dict(leaves(sd["master"])), dict(leaves(sd["step"]))
        missing = set(self.optimizers) - set(masters)
        if missing:
            # an unmatched leaf would keep its init master, and the next
            # step would overwrite the restored params with it
            raise ValueError(
                f"offload optimizer state covers {len(masters)} of "
                f"{len(self.optimizers)} leaves; missing e.g. "
                f"{sorted(missing)[:2]}. Load with "
                "load_optimizer_states=False to rebuild the masters from "
                "the checkpoint params.")
        moments = {name: dict(leaves(tree)) for name, tree in sd.items()
                   if name not in ("master", "step")}
        for path, opt in self.optimizers.items():
            opt.step_count = int(steps[path])
            states = {name: moments[name][path] for name in opt.state_names}
            if self._swap is None:
                if masters[path] is not self.masters[path]:
                    self.masters[path].copy_(masters[path].reshape(-1))
                for name, m in zip(opt.state_names, opt.moments()):
                    if states[name] is not m:
                        m.copy_(states[name].reshape(-1))
                continue
            self._swap.swap_out(f"{path}.master",
                                masters[path].reshape(-1).contiguous())
            for name in opt.state_names:
                self._swap.swap_out(f"{path}.{name}",
                                    states[name].reshape(-1).contiguous())
            self._swap.wait()
            self._moments_on_disk.add(path)

    @torch.no_grad()
    def reinit_masters(self, params: Tree) -> None:
        """Re-seed the masters from ``params`` with zeroed moments and
        counts (a checkpoint loaded without its optimizer state)."""
        for path, p in leaves(params):
            master = p.detach().to("cpu", torch.float32).reshape(-1)
            opt = self.optimizers[path] = self._new_optimizer(master.numel())
            if self._swap is None:
                self.masters[path].copy_(master)
                continue
            opt.detach_state()
            self._swap.swap_out(f"{path}.master", master, sync=True)
            self._moments_on_disk.discard(path)
        self.count = 0

    @torch.no_grad()
    def sync_params_from_masters(self, params: Tree) -> None:
        """Recast the compute params (same tree) from the masters, in
        place (after a checkpoint load)."""
        for path, p in leaves(params):
            p.copy_(self._master_of(path).reshape(p.shape))

    def close(self) -> None:
        """Delete the NVMe tier's files."""
        if self._swap is not None:
            self._swap.wait()
            self._swap.purge()


__all__ = ["HostOffloadOptimizer", "CHUNK_ELEMS"]
