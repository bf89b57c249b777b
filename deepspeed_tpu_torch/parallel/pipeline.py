"""Pipeline parallelism: a microbatched stage pipeline over the pp ranks
(port of ``deepspeed_tpu/parallel/pipeline.py``).

Each pp rank holds its L / PP consecutive layers of the stacked
``[L, ...]`` layer leaves (the engine cuts dim 0 over pp, JAX's
``PP_RULES``). The batch splits into M microbatches that run through
``M + PP - 1`` steps: at step t stage s computes microbatch ``t - s``
and passes its output to stage s + 1 (``comm.ppermute``); the last
stage's outputs reach every stage at the end (JAX's masked ``psum``, a
broadcast from the last stage here). ``"waves"`` runs the microbatches
in waves of ``window``, each recomputed in the backward, so the live
stage boundaries are O(window + PP) however large M grows;
``"save_boundaries"`` runs one pass that keeps every boundary. The
stage body is recomputed in the backward (JAX's ``jax.checkpoint`` of
the stage). ``with_aux`` threads an fp32 accumulator (the MoE aux loss)
through the stages and returns it averaged over M.

JAX differentiates its ``lax.scan`` of ppermutes and gets the reverse
schedule over the reversed ring. An eager program on several processes
must issue every collective in the same order on every rank, and
autograd's traversal of graphs that differ from stage to stage (stage 0
reads the microbatches, later stages what arrives; a bubble step
computes nothing) gives no such order. So the pipeline is one autograd
Function whose backward runs JAX's reverse schedule itself: for t from
the last step down, every rank receives its output's cotangent from the
next stage, recomputes its stage on the saved input, and sends the
input's cotangent to the previous one. A bubble step (no microbatch on
this stage) computes nothing in either direction; the collectives still
run on every rank.

Microbatches are JAX's: M and the window come from the global batch
(this rank's rows times the data ranks) by JAX's defaults and
divisibility loops, and microbatch m holds the global rows
``[m * B / M, (m + 1) * B / M)``. The ranks' rows are all-gathered over
the data axes at the entry, each microbatch's rows split over the data
axes that divide them (JAX's batch placement, greedy over dp, fsdp,
ep), and the outputs gathered back at the exit; a data axis that does
not divide a microbatch holds copies, and the MoE layers place their
tokens over it by the sequence, as JAX's dispatch does
(``parallel/moe.replicated_tokens``). On one data rank none of this
moves anything.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import topology as topo
from deepspeed_tpu_torch.runtime import sharding

PP = "pp"


def pipeline_enabled(mesh) -> bool:
    return mesh is not None and mesh.shape.get(PP, 1) > 1


# scoped schedule defaults (the config's pipeline.{microbatches, window,
# schedule}): the engine enters this around its own steps, so two
# engines in one process do not share a schedule
_CONFIG_MICROBATCHES = 0
_CONFIG_WINDOW = 0
_CONFIG_SCHEDULE = "waves"


class schedule_defaults:
    """``with schedule_defaults(m, w, s): model.loss(...)``: the engine
    config's defaults for ``pipelined_layers``, scoped to the call."""

    def __init__(self, microbatches: int = 0, window: int = 0,
                 schedule: str = "waves"):
        self._mws = (microbatches, window, schedule)

    def __enter__(self):
        global _CONFIG_MICROBATCHES, _CONFIG_WINDOW, _CONFIG_SCHEDULE
        self._prev = (_CONFIG_MICROBATCHES, _CONFIG_WINDOW, _CONFIG_SCHEDULE)
        _CONFIG_MICROBATCHES, _CONFIG_WINDOW, _CONFIG_SCHEDULE = self._mws

    def __exit__(self, *a):
        global _CONFIG_MICROBATCHES, _CONFIG_WINDOW, _CONFIG_SCHEDULE
        _CONFIG_MICROBATCHES, _CONFIG_WINDOW, _CONFIG_SCHEDULE = self._prev
        return False


def microbatch_plan(B: int, pp: int,
                    num_microbatches: Optional[int] = None,
                    window: Optional[int] = None,
                    schedule: Optional[str] = None) -> Tuple[int, int, str]:
    """(M, window, schedule) for a global batch of B rows, by JAX's
    defaults and divisibility loops."""
    M = num_microbatches or _CONFIG_MICROBATCHES or min(B, 2 * pp)
    M = min(M, B)
    while B % M != 0:
        M -= 1
    assert M >= 1
    sched = schedule or _CONFIG_SCHEDULE or "waves"
    if sched not in ("waves", "save_boundaries"):
        raise ValueError(f"pipeline schedule must be 'waves' or "
                         f"'save_boundaries', got {sched!r}")
    if sched == "save_boundaries":
        W = M
    else:
        W = window or _CONFIG_WINDOW or 2 * pp
        W = min(W, M)
        while M % W != 0:
            W -= 1
    return M, W, sched


def _flatten(tree, out=None, path=""):
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append((path, tree))
    else:
        for k in tree:
            _flatten(tree[k], out, f"{path}/{k}")
    return out


def _unflatten(paths, tensors):
    if paths == [""]:  # a bare tensor
        return tensors[0]
    tree: dict = {}
    for path, t in zip(paths, tensors):
        node = tree
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return tree


class _Stage:
    """One rank's stage: its layers over a microbatch, and the pipeline
    geometry (``run`` of ``_Pipeline``)."""

    def __init__(self, layer_fn, paths, n_layers, with_aux, replicated,
                 pp, stage):
        self.layer_fn = layer_fn
        self.paths = paths
        self.n_layers = n_layers
        self.with_aux = with_aux
        self.replicated = replicated
        self.pp, self.stage = pp, stage
        self.first, self.last = stage == 0, stage == pp - 1

    def __call__(self, act, aux, flat):
        """(act, aux) through this stage's layers (aux None without
        ``with_aux``)."""
        from deepspeed_tpu_torch.parallel import moe

        tree = _unflatten(self.paths, flat)
        views = _unbind(tree)
        with moe.replicated_tokens(self.replicated):
            for l in range(self.n_layers):
                lp = _pick(views, l)
                if self.with_aux:
                    act, l_aux = self.layer_fn(act, lp)
                    aux = aux + l_aux
                else:
                    act = self.layer_fn(act, lp)
        return act, aux


def _unbind(tree):
    if isinstance(tree, torch.Tensor):
        return torch.unbind(tree, 0)
    return {k: _unbind(v) for k, v in tree.items()}


def _pick(node, l):
    if isinstance(node, tuple):
        return node[l]
    return {k: _pick(v, l) for k, v in node.items()}


def _shift(x: torch.Tensor, pp: int, forward: bool, name: str):
    """Every stage's ``x`` to the next stage (``forward``) or the
    previous one; the first (last) stage receives zeros."""
    perm = ([(i, i + 1) for i in range(pp - 1)] if forward else
            [(i + 1, i) for i in range(pp - 1)])
    return comm.ppermute(x.contiguous(), PP, perm, log_name=name)


def _wave_forward(st: _Stage, flat, xs: List[torch.Tensor], keep: bool):
    """One pass of len(xs) microbatches: (the last stage's outputs, its
    aux sum, {step: the stage's (input, aux input)} when ``keep``)."""
    W = len(xs)
    T = W + st.pp - 1
    zero_act = torch.zeros_like(xs[0])
    zero_aux = torch.zeros((), dtype=torch.float32, device=xs[0].device) \
        if st.with_aux else None
    buf, aux_buf = zero_act, zero_aux
    saved, ys = {}, [None] * W
    aux_sum = zero_aux
    for t in range(T):
        j = t - st.stage
        if 0 <= j < W:
            inp = xs[j] if st.first else buf
            aux_in = zero_aux if st.first else aux_buf
            if keep:
                saved[t] = (inp, aux_in)
            out, aux_out = st(inp, aux_in, flat)
            if st.last:
                ys[j] = out
                if st.with_aux:
                    aux_sum = aux_sum + aux_out
        else:  # a bubble step: nothing to compute on this stage
            out, aux_out = zero_act, zero_aux
        if t < T - 1:
            buf = _shift(out, st.pp, True, "pp_activation")
            if st.with_aux:
                aux_buf = _shift(aux_out.reshape(1), st.pp, True,
                                 "pp_aux")[0]
    return ys, aux_sum, saved


def _wave_backward(st: _Stage, flat, saved, W: int, g_ys, g_aux,
                   d_xs: List[Optional[torch.Tensor]], d_flat: list):
    """The reverse schedule of one pass: fills ``d_xs`` (stage 0) and adds
    the stage params' gradients into ``d_flat``."""
    T = W + st.pp - 1
    act_like = next(iter(saved.values()))[0]
    zero_act = torch.zeros_like(act_like)
    zero_aux = torch.zeros((), dtype=torch.float32, device=act_like.device)
    want = [i for i, t in enumerate(flat) if t.requires_grad]
    wanted = set(want)
    g_next, g_aux_next = zero_act, zero_aux
    for t in reversed(range(T)):
        if t < T - 1:  # the backward of step t's shift
            cot = _shift(g_next, st.pp, False, "pp_activation_grad")
            cot_aux = (_shift(g_aux_next.reshape(1), st.pp, False,
                              "pp_aux_grad")[0] if st.with_aux else None)
        else:
            cot, cot_aux = zero_act, zero_aux
        g_next, g_aux_next = zero_act, zero_aux
        j = t - st.stage
        if not 0 <= j < W:
            continue
        if st.last:
            cot = cot + g_ys[j]
            if st.with_aux:
                cot_aux = cot_aux + g_aux
        inp, aux_in = saved[t]
        with torch.enable_grad():
            inp_r = inp.detach().requires_grad_(True)
            aux_r = (aux_in.detach().requires_grad_(True)
                     if st.with_aux else None)
            leaves = [f.detach().requires_grad_(True) if i in wanted else f
                      for i, f in enumerate(flat)]
            out, aux_out = st(inp_r, aux_r, leaves)
            outs, gouts = [out], [cot]
            if st.with_aux:
                outs.append(aux_out)
                gouts.append(cot_aux)
            wrt = [inp_r] + ([aux_r] if st.with_aux else []) + \
                [leaves[i] for i in want]
            grads = torch.autograd.grad(outs, wrt, gouts, allow_unused=True)
        g_inp = grads[0] if grads[0] is not None else zero_act
        k = 1
        if st.with_aux:
            if grads[1] is not None:
                g_aux_next = grads[1]
            k = 2
        for i, g in zip(want, grads[k:]):
            if g is not None:
                d_flat[i] = g if d_flat[i] is None else d_flat[i] + g
        if st.first:
            d_xs[j] = g_inp
        else:
            g_next = g_inp


class _Pipeline(torch.autograd.Function):
    """xs [M, mb, ...] (the microbatches, read by stage 0) and this
    stage's flat layer leaves -> (the last stage's outputs [M, mb, ...]
    on every stage, the aux sum)."""

    @staticmethod
    def forward(ctx, st, M, W, keep_all, xs, *flat):
        ctx.st, ctx.M, ctx.W, ctx.keep_all = st, M, W, keep_all
        xs_list = list(xs.unbind(0))
        ys, aux = [], None
        saved = []
        for w in range(M // W):
            y, a, s = _wave_forward(st, flat, xs_list[w * W:(w + 1) * W],
                                    keep=keep_all)
            ys.extend(y)
            saved.append(s)
            if st.with_aux:
                aux = a if aux is None else aux + a
        if st.last:
            Y = torch.stack(ys)
        else:
            Y = torch.zeros_like(xs)
        # the last stage's result on every stage (JAX's masked psum)
        Y = comm.broadcast(Y, PP, root=st.pp - 1, log_name="pp_output")
        if st.with_aux:
            aux = comm.broadcast(aux.reshape(1), PP, root=st.pp - 1,
                                 log_name="pp_aux_output")[0]
        else:
            aux = torch.zeros((), dtype=torch.float32, device=xs.device)
        ctx.saved = saved if keep_all else None
        ctx.save_for_backward(xs, *flat)
        return Y, aux

    @staticmethod
    def backward(ctx, gY, g_aux):
        st, M, W = ctx.st, ctx.M, ctx.W
        xs, *flat = ctx.saved_tensors
        if st.with_aux and g_aux is None:
            g_aux = torch.zeros((), dtype=torch.float32, device=xs.device)
        xs_list = list(xs.unbind(0))
        d_xs: List[Optional[torch.Tensor]] = [None] * M
        d_flat: list = [None] * len(flat)
        # only the last stage's cotangent counts: every stage reads the
        # same output, and the loss of one is the loss (the engine
        # back-propagates the last stage's)
        g_ys = None
        if st.last:
            g_ys = list((gY if gY is not None else torch.zeros_like(xs))
                        .unbind(0))
        for w in reversed(range(M // W)):
            if ctx.keep_all:
                saved = ctx.saved[w]
            else:  # the wave again, to regenerate its boundaries
                _, _, saved = _wave_forward(
                    st, flat, xs_list[w * W:(w + 1) * W], keep=True)
            wave_d = [None] * W
            _wave_backward(st, flat, saved, W,
                           g_ys[w * W:(w + 1) * W] if st.last else None,
                           g_aux, wave_d, d_flat)
            d_xs[w * W:(w + 1) * W] = wave_d
            del saved
        ctx.saved = None
        if st.first:
            gx = torch.stack([d if d is not None else torch.zeros_like(x)
                              for d, x in zip(d_xs, xs_list)])
        else:
            gx = torch.zeros_like(xs)
        grads = [None if g is None else g.to(f.dtype)
                 for g, f in zip(d_flat, flat)]
        return (None, None, None, None, gx, *grads)


def _data_placement(mesh, mb: int):
    """(the data axes with ranks, the ones a microbatch of ``mb`` rows
    splits over, the others: their ranks hold copies)."""
    data = tuple(a for a in topo.BATCH_AXES if mesh.shape[a] > 1)
    placed, prod = [], 1
    for a in data:
        if mb % (prod * mesh.shape[a]) == 0:
            placed.append(a)
            prod *= mesh.shape[a]
    rest = tuple(a for a in data if a not in placed)
    return data, tuple(placed), rest


def pipelined_layers(layer_fn: Callable, stacked_params: Any,
                     x: torch.Tensor,
                     num_microbatches: Optional[int] = None,
                     window: Optional[int] = None,
                     with_aux: bool = False,
                     schedule: Optional[str] = None):
    """``layer_fn`` over this stage's ``[L / PP, ...]``-stacked params as a
    PP-stage pipeline.

    layer_fn(carry, layer_params) -> carry, carry [mb, S, H]; with
    ``with_aux`` it returns (carry, aux scalar) and the pipeline threads
    an fp32 accumulator beside the activations. x: this rank's rows
    [B_loc, S, H] (the same on every stage). Returns the stack's output
    [B_loc, S, H] on every stage (and with ``with_aux`` the aux averaged
    over the microbatches). ``num_microbatches`` (default
    ``min(B, 2 * PP)`` of the global batch B), ``window`` (default
    2 * PP) and ``schedule`` ("waves" or "save_boundaries") default to
    the engine's ``schedule_defaults``."""
    mesh = topo.get_global_mesh()
    pp = mesh.shape[PP]
    stage = mesh.axis_index(PP)
    data, placed, rest = (), (), ()
    n_data = 1
    if mesh.distributed:
        data = tuple(a for a in topo.BATCH_AXES if mesh.shape[a] > 1)
        n_data = math.prod(mesh.shape[a] for a in data)
    B_loc = x.shape[0]
    B = B_loc * n_data
    M, W, sched = microbatch_plan(B, pp, num_microbatches, window, schedule)
    mb = B // M
    if n_data > 1:
        data, placed, rest = _data_placement(mesh, mb)
    items = _flatten(stacked_params)
    paths = [p for p, _ in items]
    flat = [t for _, t in items]
    n_layers = flat[0].shape[0]
    # the global batch's microbatches, this rank's rows of each
    X = sharding.gather_sum(x, data, 0, "pp_batch") if n_data > 1 else x
    xs = X.reshape(M, mb, *x.shape[1:])
    nb = math.prod(mesh.shape[a] for a in placed) if placed else 1
    if nb > 1:
        mb_loc = mb // nb
        xs = xs.narrow(1, mesh.axis_index(placed) * mb_loc, mb_loc)
    st = _Stage(layer_fn, paths, n_layers, with_aux, rest, pp, stage)
    ys, aux = _Pipeline.apply(st, M, W, sched == "save_boundaries",
                              xs.contiguous(), *flat)
    if nb > 1:
        ys = sharding.gather_sum(ys, placed, 1, "pp_microbatch")
    out = ys.reshape(B, *x.shape[1:])
    if n_data > 1:
        out = out.narrow(0, mesh.axis_index(data) * B_loc, B_loc)
    if with_aux:
        return out, aux / M
    return out


__all__ = ["pipeline_enabled", "schedule_defaults", "microbatch_plan",
           "pipelined_layers"]
