"""Profiler range annotations (port of ``deepspeed_tpu/utils/annotate.py``).

Reference: ``instrument_w_nvtx`` (deepspeed/utils/nvtx.py:25) +
``accelerator.range_push/pop`` wrap hot functions in NVTX ranges. JAX's
pair is ``jax.profiler.TraceAnnotation`` (host trace ranges) and
``jax.named_scope`` (names carried into the compiled HLO, so a profile
shows each op under its source region without asking). The port's pair is
``torch.profiler.record_function`` (the range in a ``torch.profiler``
capture, with the kernels launched inside it) and a ``torch.cuda.nvtx``
range (nsight's timeline).

Ranges are entered only while a profiler is active: with none, each
wrapper costs one check of a module flag and calls straight through.

:func:`region` names the model's source regions (attention, mlp, norm,
rope, vocab_head; the optimizer update) so a profile's device time can
be split by range (``observability.attribution.device_ms_by_region``).
An eager backward runs outside the forward's ranges, so while a profiler
is active a region also hooks its tensors' gradients (hooks that read
nothing and return None: no kernel, no change to the autograd graph or
to the numerics): the gradient of an output opens the region's range
and the gradient of an input closes it, so the region's backward
kernels land in a range of the same name. Nested regions (a norm inside
the attention half) nest there too. Each call's hooks share one handle:
a layer's output carries that layer's open hook and the next layer's
close hooks of the same names, and a tensor's hooks fire in the order
they were registered, so pairing by name would close the range just
opened and leave the next layer's open.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict

import torch
import torch.autograd.profiler as _ap


def profiling() -> bool:
    """A ``torch.profiler`` / autograd profiler capture is active."""
    return _ap._is_profiler_enabled


def _nvtx_push(name: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.nvtx.range_push(name)


def _nvtx_pop() -> None:
    if torch.cuda.is_available():
        torch.cuda.nvtx.range_pop()


def range_push(name: str):
    """Open a trace range (reference accelerator.range_push). Returns the
    handle to pass to :func:`range_pop`; None when no profiler is
    active."""
    if not _ap._is_profiler_enabled:
        return None
    handle = torch.ops.profiler._record_function_enter_new(name, None)
    _nvtx_push(name)
    return handle


def range_pop(handle) -> None:
    if handle is None:
        return
    _nvtx_pop()
    torch.ops.profiler._record_function_exit._RecordFunction(handle)


@contextlib.contextmanager
def trace_range(name: str):
    """``with trace_range(name):`` — the range while a profiler is
    active, nothing otherwise."""
    handle = range_push(name)
    try:
        yield
    finally:
        range_pop(handle)


def instrument_w_profiler(fn: Callable = None, name: str = None) -> Callable:
    """Decorator: run ``fn`` inside a trace range (reference
    instrument_w_nvtx)."""
    if fn is None:
        return functools.partial(instrument_w_profiler, name=name)
    label = name or getattr(fn, "__qualname__", getattr(fn, "__name__", "fn"))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _ap._is_profiler_enabled:
            return fn(*args, **kwargs)
        with trace_range(label):
            return fn(*args, **kwargs)

    return wrapped


# reference-name alias so ported user code keeps working
instrument_w_nvtx = instrument_w_profiler


class _BackwardRange:
    """One region call's backward range: the first of its outputs'
    gradient hooks opens it, the first of its inputs' closes it. The
    ranges of neighbouring calls may overlap by a hook's span (no kernel
    runs there), so the NVTX side uses start / end ids, not the
    push / pop stack."""

    __slots__ = ("name", "handle", "nvtx", "done")

    def __init__(self, name: str):
        self.name = name
        self.handle = None
        self.nvtx = None
        self.done = False

    def open(self, grad) -> None:
        if self.done or self.handle is not None \
                or not _ap._is_profiler_enabled:
            return
        self.handle = torch.ops.profiler._record_function_enter_new(
            self.name, None)
        if torch.cuda.is_available():
            self.nvtx = torch.cuda.nvtx.range_start(self.name)
        _OPEN[id(self)] = self

    def close(self, grad) -> None:
        self.done = True
        if self.handle is None:
            return
        if self.nvtx is not None:
            torch.cuda.nvtx.range_end(self.nvtx)
        torch.ops.profiler._record_function_exit._RecordFunction(
            self.handle)
        self.handle = self.nvtx = None
        _OPEN.pop(id(self), None)


# the backward ranges open now, by id
_OPEN: Dict[int, _BackwardRange] = {}


def close_open_ranges() -> None:
    """Close every backward range still open (the end of a capture: a
    backward that stopped between a region's hooks leaves one)."""
    for r in list(_OPEN.values()):
        r.close(None)
    _OPEN.clear()


def region(name: str) -> Callable:
    """Decorator: ``fn`` runs in the range ``name`` while a profiler is
    active (see the module docstring); a gradient hook on each tensor
    output that requires grad opens the range for its backward and a
    hook on each tensor positional argument that autograd produced (not
    a parameter) closes it."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _ap._is_profiler_enabled:
                return fn(*args, **kwargs)
            with trace_range(name):
                out = fn(*args, **kwargs)
            if not torch.is_grad_enabled():
                return out
            # activations only: a hook on a parameter (a leaf) would
            # outlive the step and pile up a call after call
            ins = [a for a in args
                   if isinstance(a, torch.Tensor) and a.grad_fn is not None]
            outs = [o for o in ((out,) if isinstance(out, torch.Tensor)
                                else out if isinstance(out, tuple) else ())
                    if isinstance(o, torch.Tensor) and o.requires_grad]
            if ins and outs:
                call = _BackwardRange(name)
                for t in ins:
                    t.register_hook(call.close)
                for t in outs:
                    t.register_hook(call.open)
            return out

        return wrapped

    return wrap
