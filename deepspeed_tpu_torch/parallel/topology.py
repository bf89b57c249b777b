"""Rank topology: the named mesh axes as ``torch.distributed`` process
groups (port of ``deepspeed_tpu/parallel/topology.py``).

The JAX package lays its devices out on one ``jax.sharding.Mesh`` with
the named axes ``MESH_AXES`` (outermost first) and lets XLA derive the
collectives. Here each rank is one process, and ``build_mesh`` lays the
world's ranks out row-major over the same axes, in the same order, so
rank r sits where JAX's device r sits on a mesh built from the first n
devices. For every axis (and for the data axes together) it creates the
process group of the ranks that differ only along that axis; the
collectives of ``comm`` run on those groups by axis name.

``build_mesh`` is collective when a process group is initialized: every
rank must call it, in the same order, with the same arguments
(``torch.distributed.new_group`` is). Without a process group (one
process) it builds the shape only; ``devices`` may then name any number
of ranks, which is how the solver is checked on the CPU.

An axis group is the world's group when the axis spans the world, and
nothing when it has one rank of several (its collectives are the
identity and send nothing); so at world size 1 on an initialized
one-rank group every collective runs, on that group.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

# canonical axis order, outermost -> innermost
MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# logical -> mesh axis names for activations
BATCH_AXES = ("dp", "fsdp", "ep")  # the batch dim shards over the data axes
SEQ_AXIS = "sp"
# the axis tuples that get a group of their own besides the single axes
# (qgZ's replica level reduces over dp and ep together; a gradient sums
# over the sp ranks beside its data axes)
_GROUPED_AXES = (BATCH_AXES, ("dp", "fsdp"), ("dp", "ep"),
                 BATCH_AXES + (SEQ_AXIS,), ("dp", "fsdp", SEQ_AXIS),
                 ("dp", "ep", SEQ_AXIS), ("dp", SEQ_AXIS))

AxisName = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Requested per-axis degrees. ``-1`` on at most one axis = absorb
    the remaining ranks (the reference's dp = world / (tp * pp * ep))."""

    pp: int = 1
    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self, n_devices: int) -> Dict[str, int]:
        req = {a: getattr(self, a) for a in MESH_AXES}
        for a, v in req.items():
            if v != -1 and v < 1:
                raise ValueError(
                    f"mesh axis '{a}' size must be >= 1 or -1, got {v}")
        free = [a for a, v in req.items() if v == -1]
        if len(free) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {free}")
        fixed = math.prod(v for v in req.values() if v != -1)
        if free:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"device count {n_devices} not divisible by fixed axes "
                    f"product {fixed}")
            req[free[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes product {fixed} != device count {n_devices}")
        return req


def _axes(axis: AxisName) -> Tuple[str, ...]:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {a!r}; valid axes: "
                             f"{MESH_AXES}")
    return axes


class Mesh:
    """The ranks laid out over ``MESH_AXES`` (``devices``, an int array
    of that shape), with the process group of each axis. ``shape`` maps
    axis -> size, as the JAX mesh's does."""

    axis_names = MESH_AXES

    def __init__(self, devices: np.ndarray, rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], Any]] = None,
                 distributed: bool = False):
        self.devices = devices
        self.shape = dict(zip(MESH_AXES, devices.shape))
        self.rank = rank
        self.distributed = distributed
        self._groups = groups or {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The mesh coordinates of ``rank`` (default: this process's)."""
        rank = self.rank if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if where.size == 0:
            raise ValueError(f"rank {rank} is not on this mesh")
        return dict(zip(MESH_AXES, (int(c) for c in where[0])))

    def axis_ranks(self, axis: AxisName,
                   rank: Optional[int] = None) -> list:
        """The ranks of the ``axis`` group that holds ``rank``, in axis
        index order (row-major over a tuple of axes)."""
        axes = _axes(axis)
        c = self.coords(rank)
        index = tuple(slice(None) if a in axes else c[a] for a in MESH_AXES)
        return [int(r) for r in self.devices[index].reshape(-1)]

    def axis_size(self, axis: AxisName) -> int:
        return math.prod(self.shape[a] for a in _axes(axis))

    def axis_index(self, axis: AxisName, rank: Optional[int] = None) -> int:
        """This rank's index along ``axis`` (JAX ``lax.axis_index``)."""
        rank = self.rank if rank is None else rank
        return self.axis_ranks(axis, rank).index(rank)

    def issues(self, axis: AxisName) -> bool:
        """Whether a collective over ``axis`` communicates: a process
        group is up and the axis holds this rank's whole world or a part
        with more than one rank."""
        return self.distributed and (self.axis_size(axis) > 1
                                     or self.size == 1)

    def group(self, axis: AxisName):
        """The process group of ``axis`` (None: the world's group)."""
        axes = _axes(axis)
        if self.axis_size(axes) == self.size:
            return None
        key = tuple(a for a in MESH_AXES if a in axes)
        if key not in self._groups:
            # the same ranks under a grouped key that adds one-rank axes
            for other, pg in self._groups.items():
                if set(key) <= set(other) and all(
                        self.shape[a] == 1 for a in set(other) - set(key)):
                    return pg
            raise ValueError(
                f"no process group for mesh axes {key}: the mesh builds "
                f"the single axes and {_GROUPED_AXES}")
        return self._groups[key]

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(f"{a}={s}" for a, s in
                                   self.shape.items()) + ")"


def _world() -> Tuple[bool, int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True, dist.get_world_size(), dist.get_rank()
    return False, 1, 0


def build_mesh(topo: Union[TopologyConfig, Dict[str, int], None] = None,
               devices: Optional[Sequence[int]] = None) -> Mesh:
    """Lay the ranks out over ``MESH_AXES`` (row-major, tp innermost) and
    create each axis's process group. ``devices`` defaults to every
    rank of the initialized world (one rank without one)."""
    distributed, world, rank = _world()
    if devices is None:
        devices = list(range(world))
    devices = [int(d) for d in devices]
    if topo is None:
        topo = TopologyConfig()
    elif isinstance(topo, dict):
        unknown = set(topo) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid "
                             f"axes: {MESH_AXES}")
        topo = TopologyConfig(**topo)
    sizes = topo.sizes(len(devices))
    shape = tuple(sizes[a] for a in MESH_AXES)
    array = np.asarray(devices, dtype=np.int64).reshape(shape)
    if distributed and sorted(devices) != list(range(world)):
        raise ValueError(
            f"a mesh over an initialized process group lays out all "
            f"{world} ranks, got devices {devices}")
    groups: Dict[Tuple[str, ...], Any] = {}
    if distributed and world > 1:
        import torch.distributed as dist

        mesh = Mesh(array, rank)
        for axes in [(a,) for a in MESH_AXES] + list(_GROUPED_AXES):
            n = mesh.axis_size(axes)
            if n in (1, world):
                continue
            # every rank creates every group of the axis, in one order
            others = [a for a in MESH_AXES if a not in axes]
            for combo in itertools.product(*(range(sizes[a])
                                              for a in others)):
                fixed = dict(zip(others, combo))
                index = tuple(slice(None) if a in axes else fixed[a]
                              for a in MESH_AXES)
                ranks = [int(r) for r in array[index].reshape(-1)]
                pg = dist.new_group(ranks)
                if rank in ranks:
                    groups[axes] = pg
    mesh = Mesh(array, rank, groups, distributed)
    logger.info("mesh: " + " x ".join(
        f"{a}={sizes[a]}" for a in MESH_AXES if sizes[a] > 1 or a == "dp"))
    return mesh


# ---------------------------------------------------------------------------
# group-size queries (reference: deepspeed/utils/groups.py getters)
# ---------------------------------------------------------------------------

_GLOBAL_MESH: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Mesh:
    if _GLOBAL_MESH is None:
        raise RuntimeError(
            "no global mesh set; call deepspeed_tpu_torch.initialize() or "
            "topology.set_global_mesh(mesh) first")
    return _GLOBAL_MESH


class use_mesh:
    """Scope the global mesh to one engine's mesh for the duration of a
    step: two engines in one process each set it at init."""

    def __init__(self, mesh: Mesh):
        self._mesh = mesh

    def __enter__(self):
        global _GLOBAL_MESH
        self._prev = _GLOBAL_MESH
        _GLOBAL_MESH = self._mesh

    def __exit__(self, *a):
        global _GLOBAL_MESH
        _GLOBAL_MESH = self._prev
        return False


def on_mesh(method):
    """Run an engine method with the engine's ``mesh`` as the global one
    (engines in one process each set their own; the collectives read it,
    in the backward too)."""
    def wrapper(self, *args, **kwargs):
        with use_mesh(self.mesh):
            return method(self, *args, **kwargs)

    wrapper.__name__ = method.__name__
    wrapper.__doc__ = method.__doc__
    return wrapper


def _axis_size(mesh: Optional[Mesh], axis: str) -> int:
    mesh = mesh or get_global_mesh()
    return mesh.shape[axis]


def get_data_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    """Total data parallelism = dp x fsdp x ep (reference
    groups._get_data_parallel_world_size)."""
    mesh = mesh or get_global_mesh()
    return math.prod(mesh.shape[a] for a in BATCH_AXES)


def get_model_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "tp")


def get_tensor_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "tp")


def get_pipeline_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "pp")


def get_expert_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "ep")


def get_sequence_parallel_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "sp")


def get_fsdp_world_size(mesh: Optional[Mesh] = None) -> int:
    return _axis_size(mesh, "fsdp")


@dataclasses.dataclass(frozen=True)
class BatchSlice:
    """This rank's part of a global batch: the ``index``-th of ``count``
    equal row blocks of dim 0 (JAX's ``batch_sharding`` places the same
    rows on device ``index``), and, with ``seq_count`` > 1, the
    ``seq_index``-th of as many blocks of the sequence (dim 1).

    The sequence cut follows the next-token shift, never precedes it: a
    causal-LM batch (``input_ids`` [B, S + 1] without ``labels``) becomes
    its inputs and labels first (``loss_mask`` shifted as the loss
    shifts it), as JAX's ``loss_fn`` shifts the global batch before
    anything is sharded. A sequence that does not split is padded at its
    end to the next multiple of ``seq_count`` (JAX's ring attention pads
    to the ring size), with ``loss_mask`` 0 on the padding."""

    index: int
    count: int
    seq_index: int = 0
    seq_count: int = 1

    def take(self, batch):
        """The rank's rows (and sequence block) of every array in
        ``batch`` (dicts, lists and tuples of numpy arrays or
        tensors)."""
        rows = self._rows(batch)
        if self.seq_count == 1:
            return rows
        if isinstance(rows, dict) and "input_ids" in rows \
                and "labels" not in rows:
            rows = shift_tokens(rows)
        return self._seq(rows)

    def _rows(self, batch):
        if isinstance(batch, dict):
            return {k: self._rows(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._rows(v) for v in batch)
        n = batch.shape[0]
        if n % self.count:
            raise ValueError(f"batch of {n} rows does not split into "
                             f"{self.count} equal parts")
        step = n // self.count
        return batch[self.index * step:(self.index + 1) * step]

    def _seq(self, batch):
        if isinstance(batch, dict):
            if "labels" in batch and "loss_mask" not in batch:
                lab = batch["labels"]
                batch = dict(batch, loss_mask=_ones_like(lab))
            return {k: self._seq(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._seq(v) for v in batch)
        if batch.ndim < 2:
            return batch
        S = batch.shape[1]
        pad = (-S) % self.seq_count
        if pad:
            batch = _pad_dim1(batch, pad)
        step = (S + pad) // self.seq_count
        return batch[:, self.seq_index * step:(self.seq_index + 1) * step]


def _ones_like(x):
    if isinstance(x, np.ndarray):
        return np.ones(x.shape, np.float32)
    import torch

    return torch.ones(x.shape, dtype=torch.float32, device=x.device)


def _pad_dim1(x, pad: int):
    """``x`` with ``pad`` zero columns after its dim 1 (a loss mask's
    padding is 0 too)."""
    if isinstance(x, np.ndarray):
        widths = [(0, 0)] * x.ndim
        widths[1] = (0, pad)
        return np.pad(x, widths)
    import torch

    shape = list(x.shape)
    shape[1] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=1)


def shift_tokens(batch: Dict[str, Any]) -> Dict[str, Any]:
    """A causal-LM batch's next-token shift (JAX ``loss_fn``): inputs
    ``input_ids[:, :-1]``, labels ``input_ids[:, 1:]``, and a
    ``loss_mask`` as long as ``input_ids`` loses its first column."""
    tokens = batch["input_ids"]
    out = dict(batch, input_ids=tokens[:, :-1], labels=tokens[:, 1:])
    mask = batch.get("loss_mask")
    if mask is not None and mask.shape[1] == tokens.shape[1]:
        out["loss_mask"] = mask[:, 1:]
    return out


def batch_sharding(mesh: Mesh) -> BatchSlice:
    """The batch over all data axes and the sequence over sp: this rank's
    rows, and its sequence block after the next-token shift (JAX's
    ``PartitionSpec(BATCH_AXES, SEQ_AXIS)``). The pp and tp ranks of one
    data index read the same rows."""
    return BatchSlice(mesh.axis_index(BATCH_AXES),
                      mesh.axis_size(BATCH_AXES),
                      mesh.axis_index(SEQ_AXIS), mesh.shape[SEQ_AXIS])


def replicated(mesh: Mesh) -> BatchSlice:
    return BatchSlice(0, 1)


__all__ = ["MESH_AXES", "BATCH_AXES", "SEQ_AXIS", "TopologyConfig", "Mesh",
           "BatchSlice", "shift_tokens", "build_mesh", "set_global_mesh", "get_global_mesh",
           "use_mesh", "on_mesh", "get_data_parallel_world_size",
           "get_model_parallel_world_size", "get_tensor_parallel_world_size",
           "get_pipeline_parallel_world_size",
           "get_expert_parallel_world_size",
           "get_sequence_parallel_world_size", "get_fsdp_world_size",
           "batch_sharding", "replicated"]
