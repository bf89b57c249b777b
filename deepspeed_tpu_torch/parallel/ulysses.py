"""Ulysses sequence parallelism (port of
``deepspeed_tpu/parallel/ulysses.py``).

Each sp rank holds its block of the sequence, [B, S/sp, N, D]. The
first all-to-all over sp regroups q, k and v to the whole sequence on
N/sp heads, [B, S, N/sp, D]; attention runs locally over the whole
sequence (``multi_head_attention``: the flash kernels on the card, or
FPDT's ``chunked_attention`` with ``attn_chunks`` > 1); the second
all-to-all gives each rank its sequence block back on every head. JAX
writes the two exchanges as sharding constraints (heads over
``("tp", "sp")``) and XLA emits the all-to-alls; here they are explicit
autograd Functions whose backward is the inverse exchange, recorded in
the comms logger as ``ulysses_qkv`` / ``ulysses_out``.

The local heads follow JAX's ``("tp", "sp")`` order: a tp rank holds
its N/tp heads and sp rank s of it takes the s-th block of those, so
rank (t, s) holds head block ``t * sp + s``. The heads must divide over
sp (JAX pads uneven heads; ``parallel/auto_sp`` picks the ring there).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime import sharding

SP = sharding.SP


class _SeqToHeads(torch.autograd.Function):
    """[B, S/sp, N, D] -> [B, S, N/sp, D]; the backward is the inverse
    exchange."""

    @staticmethod
    def forward(ctx, x, log_name):
        ctx.log_name = log_name
        return comm.all_to_all(x, SP, split_dim=2, concat_dim=1,
                               log_name=log_name)

    @staticmethod
    def backward(ctx, g):
        return comm.all_to_all(g.contiguous(), SP, split_dim=1,
                               concat_dim=2,
                               log_name=ctx.log_name + "_grad"), None


class _HeadsToSeq(torch.autograd.Function):
    """[B, S, N/sp, D] -> [B, S/sp, N, D]; the backward is the inverse
    exchange."""

    @staticmethod
    def forward(ctx, x, log_name):
        ctx.log_name = log_name
        return comm.all_to_all(x, SP, split_dim=1, concat_dim=2,
                               log_name=log_name)

    @staticmethod
    def backward(ctx, g):
        return comm.all_to_all(g.contiguous(), SP, split_dim=2,
                               concat_dim=1,
                               log_name=ctx.log_name + "_grad"), None


def ulysses_attention(q, k, v, causal: bool = True, impl: str = "auto",
                      segment_ids: Optional[torch.Tensor] = None,
                      attn_chunks: int = 0) -> torch.Tensor:
    """Attention over a sequence-sharded input: q, k, v [B, S/sp, N, D]
    this rank's sequence block (``segment_ids`` [B, S/sp] likewise), the
    output the same block. Without sp ranks it is the local attention.
    ``attn_chunks`` > 1 runs the local attention through FPDT's chunked
    path (which takes no segment ids, as in JAX)."""
    from deepspeed_tpu_torch.ops.attention import multi_head_attention

    def local_attn(q, k, v, seg):
        if attn_chunks > 1:
            from deepspeed_tpu_torch.parallel.fpdt import chunked_attention

            return chunked_attention(q, k, v, causal=causal,
                                     q_chunks=attn_chunks)
        return multi_head_attention(q, k, v, causal=causal, impl=impl,
                                    segment_ids=seg)

    sp = sharding.sp_size()
    if sp == 1:
        return local_attn(q, k, v, segment_ids)
    if q.shape[2] % sp or k.shape[2] % sp:
        raise ValueError(
            f"ulysses_attention: {q.shape[2]} query / {k.shape[2]} kv heads "
            f"a rank do not split over sp={sp} (sp_mode='ring' shards the "
            "sequence instead)")
    q = _SeqToHeads.apply(q.contiguous(), "ulysses_qkv")
    k = _SeqToHeads.apply(k.contiguous(), "ulysses_qkv")
    v = _SeqToHeads.apply(v.contiguous(), "ulysses_qkv")
    seg = None
    if segment_ids is not None:
        seg = comm.all_gather(segment_ids.contiguous(), SP, gather_dim=1,
                              log_name="ulysses_segment_ids")
    out = local_attn(q, k, v, seg)
    return _HeadsToSeq.apply(out.contiguous(), "ulysses_out")


class UlyssesSPDataLoaderAdapter:
    """Wrap a batch iterator so each rank gets its part of every batch:
    its rows over the data axes and its block of the sequence over sp,
    cut after the next-token shift (``topology.batch_sharding``). JAX's
    adapter places the same blocks on the devices; one process is one
    rank here, so the rank keeps only its own (no rank holds another's
    sequence block)."""

    def __init__(self, loader, mesh, sp_axis: str = SP, seq_dim: int = 1):
        if sp_axis != SP or seq_dim != 1:
            raise ValueError(
                "UlyssesSPDataLoaderAdapter cuts dim 1 over the sp axis "
                f"(got sp_axis={sp_axis!r}, seq_dim={seq_dim})")
        from deepspeed_tpu_torch.parallel.topology import batch_sharding

        self.loader = loader
        self.mesh = mesh
        self.sp_axis = sp_axis
        self.seq_dim = seq_dim
        self._slice = batch_sharding(mesh)

    def shard(self, batch):
        return self._slice.take(batch)

    def __iter__(self):
        for batch in self.loader:
            yield self.shard(batch)


__all__ = ["ulysses_attention", "UlyssesSPDataLoaderAdapter"]
