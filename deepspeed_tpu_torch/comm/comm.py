"""Communication facade: named-axis collectives on ``torch.distributed``
(port of ``deepspeed_tpu/comm/comm.py``).

One process is one rank. ``init_distributed`` joins the job's process
group: NCCL for a rank on the card, gloo for a rank on the CPU. On the
card a failing NCCL init raises; it never falls back to gloo or to one
rank. The collectives take a mesh axis name (or a tuple of them) and run
on that axis's process group of the global mesh (``parallel/topology``;
without a mesh, on the world). Each returns a new tensor, as the JAX
functions do, or fills ``out=``; an axis with one rank of several sends
nothing and returns its input.

Differences from the JAX facade:
  * the collectives run eagerly, outside any compiled program, so the
    comms logger records each executed collective (JAX records at trace
    time);
  * gloo has no ``ReduceOp.AVG``: a mean is a sum divided by the group
    size, on every backend, so the CPU and the card take one path;
  * the world is the ranks (JAX: devices); ``get_rank`` is the process
    rank in both.

NCCL is the default for ranks on cards of their own. NCCL refuses two
ranks on one card, so ranks that share a card join with
``dist_backend="gloo"``; gloo takes card tensors for every collective
here (it copies them through the host itself; probed on the card by
``chip_smoke.py``'s phases 18 and 19), but its point-to-point send and
receive read the raw pointer, so ``ppermute`` stages a card tensor
through the host under gloo.
"""

from __future__ import annotations

import datetime
import os
import zlib
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.observability.flight_recorder import \
    get_flight_recorder
from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

__all__ = [
    "init_distributed", "is_initialized", "get_world_size", "get_rank",
    "get_local_rank", "get_process_count", "get_backend", "barrier",
    "assert_same_across_processes", "any_process",
    "has_all_gather_into_tensor", "has_reduce_scatter_tensor",
    "has_coalescing_manager", "all_reduce", "all_gather", "reduce_scatter",
    "all_to_all", "ppermute", "broadcast", "axis_index", "axis_size",
    "configure", "log_summary", "get_retry_policy",
    "destroy",
]

_INITIALIZED = False

# -- control-plane health (the resilience block) ----------------------------
# A RetryPolicy bounds the process-level ops a wedged peer turns into a
# silent job-wide hang: rendezvous init, barrier, cross-process asserts.
# With no resilience config applied the policy has no timeouts and every
# op is a plain passthrough.
_POLICY = None


def get_retry_policy():
    """The active control-plane RetryPolicy (timeout-less until
    ``configure`` installs one from the ``resilience`` config block)."""
    global _POLICY
    if _POLICY is None:
        from deepspeed_tpu_torch.resilience.policy import RetryPolicy

        _POLICY = RetryPolicy()
    return _POLICY


def _chaos_collective(op: str) -> None:
    """Chaos hook: lets DSTPU_CHAOS delay or fail the Kth control-plane
    op (an injected ChaosCollectiveError propagates)."""
    from deepspeed_tpu_torch.resilience.chaos import get_chaos_injector

    inj = get_chaos_injector()
    if inj.armed:
        inj.on_collective(op)


def is_initialized() -> bool:
    return _INITIALIZED or (dist.is_available() and dist.is_initialized())


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_distributed(dist_backend: Optional[str] = None,
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: Optional[float] = None,
                     dist_init_required: Optional[bool] = None,
                     init_method: Optional[str] = None,
                     device=None) -> None:
    """Join the job's process group (analog of the reference
    ``comm/comm.py:792``).

    The world comes from the arguments, else from torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` (+ ``MASTER_PORT``), else from
    JAX's ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``. A
    single process with none of them initializes nothing, as in JAX,
    unless ``dist_init_required`` (then a one-rank group).
    ``init_method`` (``file://...`` or ``tcp://host:port``) beats the
    address. The backend defaults to NCCL for a card rank (``device``,
    default the card) and gloo for a CPU rank; ``timeout`` (seconds)
    bounds each collective. The rendezvous runs under the retry policy's
    ``init_timeout_s``. An already initialized group is adopted."""
    global _INITIALIZED
    _INITIALIZED = True
    if dist.is_available() and dist.is_initialized():
        return
    if dist_init_required is False:
        return
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        rank = _env_int("PROCESS_ID")
    world = num_processes or _env_int("WORLD_SIZE") or \
        _env_int("NUM_PROCESSES")
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS") \
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if init_method is None and addr:
        init_method = addr if "://" in addr else f"tcp://{addr}"
    elif init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"  # torchrun's MASTER_ADDR / MASTER_PORT
    configured = init_method is not None or (world or 0) > 1
    if not (configured or dist_init_required):
        return  # one process: nothing to join
    world = world or 1
    rank = rank or 0
    if init_method is None:
        if world > 1:
            raise ValueError(
                f"init_distributed: a world of {world} processes needs a "
                "rendezvous: MASTER_ADDR / COORDINATOR_ADDRESS or "
                "init_method")
        import tempfile

        init_method = "file://" + os.path.join(
            tempfile.mkdtemp(prefix="dstpu_pg_"), "store")
    if device is None:
        from deepspeed_tpu_torch._device import resolve_device

        device = resolve_device(None)
    device = torch.device(device)
    backend = dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs a card rank "
                             f"(device {device})")
        local = _env_int("LOCAL_RANK")
        if device.index is None:
            device = torch.device("cuda", local if local is not None
                                  else torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device  # eager NCCL init: a failure raises here
    policy = get_retry_policy()
    policy.run("init_distributed",
               lambda: dist.init_process_group(
                   backend=backend, init_method=init_method,
                   world_size=world, rank=rank, **kw),
               timeout_s=policy.init_timeout_s)


def destroy() -> None:
    """Leave the process group (the smoke's phases after a one-rank
    group run as before)."""
    global _INITIALIZED
    from deepspeed_tpu_torch.parallel import topology

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    topology.set_global_mesh(None)
    _INITIALIZED = False


# -- world/rank queries -------------------------------------------------------


def _dist_on() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size(group: Any = None) -> int:
    """The number of ranks (one process each); 1 without a group."""
    return dist.get_world_size(group) if _dist_on() else 1


def get_rank(group: Any = None) -> int:
    return dist.get_rank(group) if _dist_on() else 0


def get_local_rank() -> int:
    return _env_int("LOCAL_RANK") or 0


def get_process_count() -> int:
    return get_world_size()


def get_backend() -> Optional[str]:
    return dist.get_backend() if _dist_on() else None


def _control_device() -> torch.device:
    """Where the control-plane tensors live: the card for NCCL."""
    if get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(group: Any = None) -> None:
    """A barrier over the world, bounded by
    ``resilience.collective_timeout_s`` when configured."""
    _chaos_collective("barrier")
    if get_world_size() > 1:
        get_retry_policy().run("barrier", lambda: dist.barrier(group))


def _process_allgather(name: str, local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` [k] int64, stacked [world, k] on the host,
    under the retry policy's deadline."""
    dev = _control_device()
    local = local.to(dev)
    out = torch.empty(get_world_size() * local.numel(), dtype=local.dtype,
                      device=dev)
    get_retry_policy().run(
        name, lambda: _all_gather_fn()(out, local))
    return out.cpu().reshape(get_world_size(), local.numel())


def assert_same_across_processes(name: str, values) -> None:
    """Fail loudly when a config-critical value diverges across ranks
    (reference ``assert_ints_same_as_other_ranks``, runtime/zero/
    utils.py:106). ``values`` is an int or a sequence of ints and
    strings (strings hash to ints); a no-op on one rank."""
    _chaos_collective(f"assert_same:{name}")
    if get_world_size() <= 1:
        return

    def canon(v):
        if isinstance(v, str):
            return zlib.crc32(v.encode())
        return int(v)

    vals = values if isinstance(values, (list, tuple)) else [values]
    local = torch.tensor([canon(v) for v in vals], dtype=torch.int64)
    gathered = _process_allgather(f"assert_same:{name}", local)
    if not bool((gathered == gathered[0]).all()):
        rows = {i: gathered[i].tolist() for i in range(gathered.shape[0])}
        raise RuntimeError(
            f"cross-process consistency check failed for {name!r}: "
            f"processes disagree — per-process values {rows}. All ranks "
            "must run identical configs/checkpoints (reference "
            "assert_ints_same_as_other_ranks, runtime/zero/utils.py:106)")


def any_process(value: bool) -> bool:
    """True when ANY rank reports ``value`` truthy. Collective: every
    rank must call it."""
    if get_world_size() <= 1:
        return bool(value)
    gathered = _process_allgather(
        "any_process", torch.tensor([int(bool(value))], dtype=torch.int64))
    return bool(gathered.any())


# -- capability probes (reference comm/comm.py:325,629) ----------------------


def has_all_gather_into_tensor() -> bool:
    """The fused all-gather under either of its names (torch 2.13
    deprecates ``all_gather_into_tensor`` for ``all_gather_single``)."""
    return _all_gather_fn() is not None


def has_reduce_scatter_tensor() -> bool:
    """The fused reduce-scatter under either of its names (torch 2.13
    deprecates ``reduce_scatter_tensor`` for ``reduce_scatter_single``)."""
    return _reduce_scatter_fn() is not None


def has_coalescing_manager() -> bool:
    from torch.distributed import distributed_c10d

    return hasattr(distributed_c10d, "_coalescing_manager")


def _all_gather_fn():
    return (getattr(dist, "all_gather_single", None)
            or getattr(dist, "all_gather_into_tensor", None))


def _reduce_scatter_fn():
    return (getattr(dist, "reduce_scatter_single", None)
            or getattr(dist, "reduce_scatter_tensor", None))


# -- the collectives ----------------------------------------------------------


def _mesh():
    from deepspeed_tpu_torch.parallel import topology

    return topology._GLOBAL_MESH


def axis_size(axis) -> int:
    mesh = _mesh()
    return mesh.axis_size(axis) if mesh is not None else get_world_size()


def axis_index(axis) -> int:
    mesh = _mesh()
    return mesh.axis_index(axis) if mesh is not None else get_rank()


def _group(axis):
    """(issues a collective, the group) for ``axis``."""
    mesh = _mesh()
    if mesh is None:
        return _dist_on(), None
    issue = mesh.issues(axis)
    return issue, (mesh.group(axis) if issue else None)


def _global_rank(group, index: int) -> int:
    return index if group is None else dist.get_global_rank(group, index)


def _record(op: str, x, axis, log_name: Optional[str] = None) -> None:
    """One executed collective in the comms logger (its op, its input's
    bytes and its axis) and in the flight recorder's ring, recorded as it
    is issued (JAX records a span at trace time; an eager NCCL call
    returns before the collective runs, so the port's is an instant)."""
    nbytes = int(x.numel() * x.element_size()) \
        if isinstance(x, torch.Tensor) else 0
    get_comms_logger().record(op, nbytes, axis, log_name)
    get_flight_recorder().record("collective", op=log_name or op,
                                 bytes=nbytes, axis=str(axis))


def all_reduce(x: torch.Tensor, axis, op: str = "sum",
               log_name: Optional[str] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum / mean / max / min over ``axis`` (reference all_reduce,
    comm/comm.py:497). ``out`` (which may be ``x``) takes the result in
    place."""
    if op not in ("sum", "avg", "mean", "max", "min"):
        raise ValueError(f"unsupported reduce op: {op}")
    issue, group = _group(axis)
    if out is None:
        out = x.clone()
    elif out is not x:
        out.copy_(x)
    if not issue:
        return out
    rop = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}.get(
        op, dist.ReduceOp.SUM)
    _record("all_reduce", x, axis, log_name)
    dist.all_reduce(out, op=rop, group=group)
    if op in ("avg", "mean"):
        n = axis_size(axis)
        if n > 1:
            out.div_(n)
    return out


def all_gather(x: torch.Tensor, axis, *, tiled: bool = True,
               gather_dim: int = 0, log_name: Optional[str] = None
               ) -> torch.Tensor:
    """all_gather_into_tensor analog (comm/comm.py:320): the group's
    tensors concatenated along ``gather_dim`` (``tiled``) or stacked on a
    new axis there."""
    issue, group = _group(axis)
    n = axis_size(axis) if issue else 1
    d = gather_dim % (x.dim() + (0 if tiled else 1))
    if not issue:
        return x.clone() if tiled else x.unsqueeze(d).clone()
    src = x.contiguous()
    flat = src.reshape(1, -1) if src.dim() == 0 else src
    buf = torch.empty((n * flat.shape[0], *flat.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _record("all_gather", x, axis, log_name)
    _all_gather_fn()(buf, flat, group=group)
    buf = buf.reshape(n, *src.shape)
    if not tiled:
        return buf.movedim(0, d)
    if d == 0:
        return buf.reshape(n * src.shape[0], *src.shape[1:])
    out = buf.movedim(0, d)
    shape = list(src.shape)
    shape[d] *= n
    return out.reshape(shape)


def reduce_scatter(x: torch.Tensor, axis, *, scatter_dim: int = 0,
                   op: str = "sum", log_name: Optional[str] = None
                   ) -> torch.Tensor:
    """reduce_scatter_tensor analog (comm/comm.py:257): the group's sum
    of ``x``, of which this rank keeps the ``axis_index``-th block along
    ``scatter_dim``."""
    issue, group = _group(axis)
    if not issue:
        return x.clone()
    n = axis_size(axis)
    d = scatter_dim % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"reduce_scatter: dim {d} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    src = x.movedim(d, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _record("reduce_scatter", x, axis, log_name)
    _reduce_scatter_fn()(out, src, group=group)
    out = out.movedim(0, d)
    if op in ("avg", "mean") and n > 1:
        out = out / n
    return out


def all_to_all(x: torch.Tensor, axis, *, split_dim: int, concat_dim: int,
               log_name: Optional[str] = None) -> torch.Tensor:
    """all_to_all_single analog (comm/comm.py:392), JAX's tiled
    semantics: block j of ``split_dim`` goes to rank j, and the blocks
    received are concatenated along ``concat_dim`` in rank order."""
    issue, group = _group(axis)
    if not issue:
        return x.clone()
    n = axis_size(axis)
    sd = split_dim % x.dim()
    if x.shape[sd] % n:
        raise ValueError(f"all_to_all: dim {sd} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    src = x.movedim(sd, 0).contiguous()
    out = torch.empty_like(src)
    _record("all_to_all", x, axis, log_name)
    dist.all_to_all_single(out, src, group=group)
    blocks = out.reshape(n, src.shape[0] // n, *src.shape[1:])
    pieces = [b.movedim(0, sd) for b in blocks]
    return torch.cat(pieces, dim=concat_dim % x.dim())


def ppermute(x: torch.Tensor, axis, perm: Sequence[Sequence[int]],
             log_name: Optional[str] = None) -> torch.Tensor:
    """Point-to-point shift along ``axis``: for each (src, dst) pair of
    axis indices, src's tensor lands on dst; a rank no pair sends to gets
    zeros (JAX ``lax.ppermute``)."""
    issue, group = _group(axis)
    me = axis_index(axis) if issue else 0
    if not issue:
        hit = [s for s, d in perm if d == me]
        return x.clone() if hit else torch.zeros_like(x)
    # gloo's send / receive read the raw pointer (a card tensor aborts
    # the process): stage it through the host
    staged = x.is_cuda and get_backend() == "gloo"
    src = x.contiguous().cpu() if staged else x.contiguous()
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, _global_rank(group, d),
                                  group=group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, _global_rank(group, s),
                                  group=group))
    _record("ppermute", x, axis, log_name)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device) if staged else out


def broadcast(x: torch.Tensor, axis, root: int = 0,
              log_name: Optional[str] = None) -> torch.Tensor:
    """``root``'s tensor on every rank of ``axis`` (comm/comm.py:227)."""
    issue, group = _group(axis)
    out = x.clone()
    if not issue:
        return out
    _record("broadcast", x, axis, log_name)
    dist.broadcast(out, src=_global_rank(group, root), group=group)
    return out


def configure(config=None) -> None:
    """Wire the comms logger (reference dist.configure engine.py:323)
    and install the control-plane RetryPolicy from the ``resilience``
    config block."""
    global _POLICY
    if config is not None:
        get_comms_logger().configure(config.comms_logger)
        rcfg = getattr(config, "resilience", None)
        if rcfg is not None and getattr(rcfg, "enabled", True):
            from deepspeed_tpu_torch.resilience.policy import RetryPolicy

            _POLICY = RetryPolicy.from_config(rcfg)


def log_summary(show_straggler: bool = False) -> str:
    return get_comms_logger().log_summary()
