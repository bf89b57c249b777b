"""ZeRO-Infinity parameter streaming: a layer stack in pinned host memory,
fetched to the card a layer at a time (port of
``deepspeed_tpu/runtime/param_stream.py``).

The reference's ``offload_param`` intercepts each submodule's
parameters on use (zero/partitioned_param_swapper.py,
partition_parameters.py:1188). As in JAX the contract is a protocol:

  * the engine keeps a model's declared ``[L, ...]`` stacked subtrees in
    pinned host memory, in the compute dtype
    (``Engine._setup_param_host_offload``), and
  * the model runs those stacks through :func:`scan_streamed` or
    :func:`streamed_layers_prefetch`, so one layer's params (plus the
    layers in flight) occupy the card at a time and the backward fetches
    each layer again for its recompute.

A model opts in either through ``config.param_host_offload`` (the
TransformerLM family: the engine turns it on) or by exposing
``host_param_paths``, the top-level keys of its stacked subtrees (the
engine then sets ``model.param_host_offload = True`` and the model's
``loss`` streams them with :func:`scan_streamed`).

Each layer's gradient leaves the card inside the backward, widened to
fp32 on the copy stream, straight into its row of the stack's fp32
gradient buffer in pinned host memory (:func:`host_grad`; never through
autograd's ``.grad``, which would hold it in the stack's own dtype), and
the host optimizer (``runtime/offload.py``) steps it there: the ``[L,
...]`` gradient stack never exists on the card. At GAS > 1 a later
microbatch's layer gradient lands in a staging buffer and is added on
the host in fp32.

Copies run on the card's copy stream (``utils/memspace.py``):
:func:`streamed_layers_prefetch` keeps ``prefetch_depth`` layers in
flight ahead of the compute in the forward and behind it in the
backward; :func:`fetch_slice` (and so :func:`scan_streamed`, and the
model's serialized mode) copies on the compute stream, right before the
layer, with no overlap. :func:`pin_stage` is JAX's scheduling barrier;
an eager program issues each copy where the code stands, before the
layer's compute, so it is the identity here, and JAX's
``overlap_depth`` has nothing to place on the host stream.

At ZeRO stage 3 over fsdp ranks :func:`resident_layers_prefetch` is
JAX's stage-3 resident overlap (``performance.overlap_depth``): the
same engine over the card-resident block stack, with the per-layer fsdp
gather as the fetch and the per-layer reduce-scatter as the gradient
sink (``runtime/sharding.fsdp_gather_layer`` / ``fsdp_scatter_grads``).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, List, Optional

import torch

from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.runtime.optimizer import leaves, set_leaf
from deepspeed_tpu_torch.utils import memspace


# host -> card layer fetches since the last reset: count and bytes
FETCH_STATS = {"layers": 0, "bytes": 0}


# layer gathers of the stage-3 overlap stream since the last reset
RESIDENT_STATS = {"gathers": 0}


def reset_fetch_stats() -> None:
    FETCH_STATS.update(layers=0, bytes=0)
    RESIDENT_STATS.update(gathers=0)


def _count(host) -> None:
    FETCH_STATS["layers"] += 1
    FETCH_STATS["bytes"] += sum(h.numel() * h.element_size() for h in host)


def _flatten(tree) -> List[tuple]:
    return list(leaves(tree))


def _unflatten(paths, values):
    out: dict = {}
    for path, v in zip(paths, values):
        set_leaf(out, path, v)
    return out


# -- the host gradient buffers ------------------------------------------------


def _land(stack: torch.Tensor, i: int, g: torch.Tensor):
    """Layer ``i``'s gradient ``g`` (on the card) into row ``i`` of the
    fp32 host gradient buffer of ``stack``: a copy into the row the
    first time in an accumulation window (in flight: returns its
    ``Transfer``), else a host add of a staged copy (waited for)."""
    buf = getattr(stack, "_dstpu_host_grad", None)
    if buf is None:
        buf = torch.empty(stack.shape, dtype=torch.float32,
                          pin_memory=stack.is_pinned())
        stack._dstpu_host_grad = buf
        stack._dstpu_host_grad_rows = set()
    rows = stack._dstpu_host_grad_rows
    if i not in rows:
        rows.add(i)
        return memspace.offload(g, dtype=torch.float32, out=buf[i])
    buf[i].add_(memspace.offload(g, dtype=torch.float32).host_wait())
    return None


def host_grad(stack: torch.Tensor) -> Optional[torch.Tensor]:
    """The fp32 gradient of a host stack since :func:`clear_host_grad`
    (rows no layer wrote are zero), or None when none was landed."""
    rows = getattr(stack, "_dstpu_host_grad_rows", None)
    if not rows:
        return None
    buf = stack._dstpu_host_grad
    for i in set(range(buf.shape[0])) - rows:
        buf[i].zero_()
        rows.add(i)
    return buf


def clear_host_grad(stack: torch.Tensor) -> None:
    """Start a new accumulation window (the buffer is kept)."""
    rows = getattr(stack, "_dstpu_host_grad_rows", None)
    if rows is not None:
        rows.clear()


class HostLayer:
    """Layer ``index`` of host stacks: a tree of the stacks, fetched
    together by :func:`fetch_layer`."""

    __slots__ = ("stacks", "index")

    def __init__(self, stacks: Any, index: int):
        self.stacks, self.index = stacks, index


class _HostFetch(torch.autograd.Function):
    """A host layer onto the card on the compute stream; the backward
    lands its gradients in the stacks' fp32 host buffers (waited for) and
    hands autograd none."""

    @staticmethod
    def forward(ctx, device, index, *stacks):
        host = [t[index] for t in stacks]
        _count(host)
        ctx.index = index
        ctx.stacks = stacks
        return tuple(h.to(device, non_blocking=True, copy=True)
                     for h in host)

    @staticmethod
    def backward(ctx, *grads):
        pending = [_land(t, ctx.index, g.contiguous())
                   for t, g in zip(ctx.stacks, grads) if g is not None]
        for p in pending:
            if p is not None:
                p.host_wait()
        return (None, None, *[None] * len(ctx.stacks))


def fetch_slice(stacked_tree: Any, i: int, device) -> Any:
    """Layer ``i`` of a host ``[L, ...]`` stacked tree on ``device``;
    under remat the recompute issues the copy again instead of keeping
    the layer."""
    return fetch_layer(HostLayer(stacked_tree, i), device)


def host_layers(stacked_tree: Any, length: int) -> List[HostLayer]:
    """The host stack's ``length`` layers, each fetched with
    :func:`fetch_layer`."""
    return [HostLayer(stacked_tree, i) for i in range(length)]


def fetch_layer(layer: HostLayer, device) -> Any:
    """A host layer on ``device`` (copies on the compute stream); its
    gradients land in the stacks' fp32 host buffers."""
    flat = _flatten(layer.stacks)
    got = _HostFetch.apply(torch.device(device), layer.index,
                           *[t for _, t in flat])
    return _unflatten([p for p, _ in flat], got)


def pin_stage(anchor: Any, pinned: Any):
    """JAX's scheduling barrier of the overlap engine: the identity (see
    the module docstring)."""
    return anchor, pinned


def scan_streamed(body: Callable[[Any, Any], Any], carry: Any,
                  stacked_tree: Any, *, length: Optional[int] = None,
                  remat: bool = True, remat_policy: Any = None,
                  device=None) -> Any:
    """A loop over a host layer stack, fetching one slice per step inside
    the (optionally remat'd) body: body(carry, layer_params) -> carry.
    Returns the final carry. ``remat=True`` is needed for the memory
    win: without it each fetched layer stays saved for the backward."""
    if length is None:
        length = _flatten(stacked_tree)[0][1].shape[0]
    if device is None:
        device = (carry.device if isinstance(carry, torch.Tensor)
                  else torch.device("cuda"))

    def fetched(c, layer):
        return body(c, fetch_layer(layer, device))

    step = ac.checkpoint_wrapper(fetched, policy=remat_policy) if remat \
        else fetched
    for layer in host_layers(stacked_tree, length):
        carry = step(carry, layer)
    return carry


class _StreamSpec:
    def __init__(self, layer_fn, paths, length, depth, device, whole=None,
                 sink=None):
        self.layer_fn, self.paths = layer_fn, paths
        self.L, self.D = length, depth
        self.device = device
        # a host stack of ZeRO-3 blocks: a fetched layer's blocks made
        # whole (the fsdp gather) and its gradient cut back to them
        self.whole = whole or (lambda tree: tree)
        self.sink = sink or (lambda tree: tree)

    def layer(self, ready) -> Any:
        return self.whole(_unflatten(self.paths, ready))


def _issue(spec: _StreamSpec, stack, i: int):
    host = [t[i] for t in stack]
    _count(host)
    return [memspace.fetch(h, spec.device) for h in host]


def _ready(transfers) -> dict:
    return [t.wait() for t in transfers]


class _Streamed(torch.autograd.Function):
    """The whole stack in one Function (JAX's custom VJP): the forward
    saves only each layer's input; the backward fetches each layer again
    (``prefetch_depth`` ahead, in reverse), recomputes and differentiates
    it, and sends its parameter gradients to the host at once."""

    @staticmethod
    def forward(ctx, spec: _StreamSpec, x, *stack):
        L, D = spec.L, spec.D
        bufs = deque(_issue(spec, stack, i) for i in range(min(D, L)))
        xs = []
        for i in range(L):
            cur = bufs.popleft()
            if i + D < L:
                # the next fetch goes out before this layer's compute: the
                # copy overlaps it
                bufs.append(_issue(spec, stack, i + D))
            xs.append(x)
            x = spec.layer_fn(x, spec.layer(_ready(cur)))
        ctx.spec = spec
        ctx.save_for_backward(*xs)
        # the stacks themselves, not what a checkpoint's unpacking hands
        # back: their gradient buffers hang on these objects
        ctx.stacks = stack
        return x

    @staticmethod
    def backward(ctx, gy):
        spec = ctx.spec
        L, D = spec.L, spec.D
        xs, stack = ctx.saved_tensors, ctx.stacks
        order = list(range(L - 1, -1, -1))
        bufs = deque(_issue(spec, stack, i) for i in order[:D])
        pending = []
        for n, i in enumerate(order):
            cur = bufs.popleft()
            if n + D < L:
                bufs.append(_issue(spec, stack, order[n + D]))
            with torch.enable_grad():
                x = xs[i].detach().requires_grad_()
                ps = [p.requires_grad_() for _, p in
                      _flatten(spec.layer(_ready(cur)))]
                y = spec.layer_fn(x, _unflatten(spec.paths, ps))
                got = torch.autograd.grad(y, [x] + ps, gy,
                                          allow_unused=True)
            gy = got[0]
            dps = [torch.zeros_like(p) if g is None else g
                   for g, p in zip(got[1:], ps)]
            dps = [g for _, g in _flatten(spec.sink(
                _unflatten(spec.paths, dps)))]
            # layer i's gradients leave while layer i-1 recomputes
            pending += [_land(t, i, g) for t, g in zip(stack, dps)]
        for p in pending:
            if p is not None:
                p.host_wait()
        return (None, gy, *[None] * len(stack))


def streamed_layers_prefetch(layer_fn: Callable[..., Any],
                             stacked_tree: Any, x: torch.Tensor,
                             length: Optional[int] = None,
                             extra: tuple = (),
                             prefetch_depth: int = 1, whole=None,
                             sink=None) -> torch.Tensor:
    """ZeRO-Infinity layer streaming with explicit prefetch (JAX's
    DeepCompile-prefetch analog): ``layer_fn(x, layer_params, *extra)``
    over a host ``[L, ...]`` stacked tree, ``prefetch_depth`` layers in
    flight ahead of the compute. Per-layer recompute is the
    ``nothing_saveable`` policy; the card holds the layers in flight, one
    layer's transient gradients and the L layer inputs. Each layer's
    gradients go to the stacks' host buffers (:func:`host_grad`) inside
    the backward. ``extra`` must not need gradients. A host stack of
    ZeRO-3 blocks (offload_param across ranks) passes ``whole`` (a
    fetched layer's blocks gathered, ``runtime/sharding.
    fsdp_gather_layer``) and ``sink`` (its gradient reduce-scattered
    back, ``fsdp_scatter_grads``) before the blocks' gradients land."""
    flat = _flatten(stacked_tree)
    if length is None:
        length = flat[0][1].shape[0]
    depth = max(1, min(int(prefetch_depth), length))

    def fn(xx, params):
        return layer_fn(xx, params, *extra)

    spec = _StreamSpec(fn, [p for p, _ in flat], length, depth, x.device,
                       whole, sink)
    return _Streamed.apply(spec, x, *[t for _, t in flat])


class _Resident(torch.autograd.Function):
    """The stage-3 overlap stream over a resident ``[L, ...]`` block
    stack (JAX's ``streamed_layers_prefetch`` with ``fetch`` the per-layer
    fsdp gather and ``grad_sink`` the per-layer reduce-scatter): the
    forward issues layer i + depth's gather before layer i's compute and
    saves each layer's input; the backward gathers each layer again,
    recomputes and differentiates it, and sinks its gradient to this
    rank's blocks at once, which become the stack's gradient."""

    @staticmethod
    def forward(ctx, spec, x, *stack):
        L, D = spec.L, spec.D
        tree = _unflatten(spec.paths, list(stack))
        bufs = deque(spec.fetch(tree, i) for i in range(min(D, L)))
        xs = []
        for i in range(L):
            cur = bufs.popleft()
            if i + D < L:
                bufs.append(spec.fetch(tree, i + D))
            xs.append(x)
            x = spec.layer_fn(x, cur)
        ctx.spec = spec
        ctx.save_for_backward(*xs, *stack)
        return x

    @staticmethod
    def backward(ctx, gy):
        spec = ctx.spec
        L, D = spec.L, spec.D
        saved = ctx.saved_tensors
        xs, stack = saved[:L], saved[L:]
        tree = _unflatten(spec.paths, list(stack))
        grads = [torch.zeros_like(t) for t in stack]
        order = list(range(L - 1, -1, -1))
        bufs = deque(spec.fetch(tree, i) for i in order[:D])
        for n, i in enumerate(order):
            cur = bufs.popleft()
            if n + D < L:
                bufs.append(spec.fetch(tree, order[n + D]))
            flat = _flatten(cur)
            with torch.enable_grad():
                x = xs[i].detach().requires_grad_()
                ps = [t.requires_grad_() for _, t in flat]
                y = spec.layer_fn(x, _unflatten(spec.paths, ps))
                got = torch.autograd.grad(y, [x] + ps, gy,
                                          allow_unused=True)
            gy = got[0]
            dps = [torch.zeros_like(p) if g is None else g
                   for g, p in zip(got[1:], ps)]
            sunk = _flatten(spec.grad_sink(_unflatten(spec.paths, dps)))
            for acc, (_, g) in zip(grads, sunk):
                acc[i] = g
        return (None, gy, *grads)


def resident_layers_prefetch(layer_fn: Callable[..., Any],
                             stacked_tree: Any, x: torch.Tensor, *,
                             fetch: Callable[[Any, int], Any],
                             grad_sink: Callable[[Any], Any],
                             length: Optional[int] = None,
                             prefetch_depth: int = 1) -> torch.Tensor:
    """The overlap engine on a resident stack (JAX's stage-3 branch of
    ``streamed_layers_prefetch``, ``models/transformer.py:831-850``):
    ``fetch(stacked_tree, i)`` gives layer i's whole params (the fsdp
    gather), ``grad_sink(layer_grads)`` its gradient as this rank's
    blocks (the reduce-scatter). Layer i + ``prefetch_depth``'s gather is
    issued before layer i's compute; per-layer recompute. The values are
    those of the remat'd layer loop under the stage-3 fetch hook: the
    same gathers, layer and reductions, only issued in another order."""
    flat = _flatten(stacked_tree)
    if length is None:
        length = flat[0][1].shape[0]
    depth = max(1, min(int(prefetch_depth), length))
    spec = _StreamSpec(layer_fn, [p for p, _ in flat], length, depth,
                       x.device)
    def counted(tree, i):
        RESIDENT_STATS["gathers"] += 1
        return fetch(tree, i)

    spec.fetch, spec.grad_sink = counted, grad_sink
    return _Resident.apply(spec, x, *[t for _, t in flat])


def pin_to_host(tree: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """A parameter subtree as pinned host copies (in ``dtype``, default
    each leaf's own), detached; a leaf already pinned there is kept."""
    def pin(t):
        dt = dtype or t.dtype
        if memspace.is_on_host(t) and t.dtype == dt:
            return t
        if not memspace.memories_supported():
            return t.detach().to("cpu", dt, copy=True)
        host = torch.empty(t.shape, dtype=dt, pin_memory=True)
        return host.copy_(t.detach())

    from deepspeed_tpu_torch.runtime.optimizer import tree_map

    return pin(tree) if isinstance(tree, torch.Tensor) else tree_map(pin,
                                                                     tree)


__all__ = ["fetch_slice", "host_layers", "fetch_layer", "HostLayer",
           "host_grad", "clear_host_grad", "pin_stage", "scan_streamed",
           "streamed_layers_prefetch", "resident_layers_prefetch",
           "pin_to_host", "FETCH_STATS", "RESIDENT_STATS",
           "reset_fetch_stats"]
