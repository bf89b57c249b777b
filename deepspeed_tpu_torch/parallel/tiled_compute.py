"""ALST/arctic-style tiled compute: activation memory traded for a loop
over sequence tiles on long sequences (port of
``deepspeed_tpu/parallel/tiled_compute.py``).

Reference: runtime/sequence_parallel/ulysses_sp.py ---
``sequence_tiled_compute`` (:720) applies a module over sequence
shards, ``TiledMLP`` (:564) chunks the MLP over the sequence dim, and
``TiledFusedLogitsLoss`` (:943) computes the unembed projection and the
loss a tile at a time, so the [B, S, V] logits never exist.

Here the JAX ``lax.scan`` over tiles is a Python loop, and its
``jax.checkpoint`` on the tile body is ``torch.utils.checkpoint``
(non-reentrant): the backward recomputes each tile, so the live
activations are one tile's. Tiles are equal: the sequence is padded up
to a multiple of the tile count, as in JAX, and the loss sums the tile
sums in order from an fp32 zero, as JAX's scan carry does.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.utils.checkpoint


def _pad_axis(x: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _split_tiles(x: torch.Tensor, n_tiles: int, axis: int = 1
                 ) -> Tuple[List[torch.Tensor], int]:
    """[..., S, ...] -> n_tiles equal tiles along ``axis`` (S padded up
    to a multiple of n_tiles). Returns (tiles, S)."""
    S = x.shape[axis]
    x = _pad_axis(x, axis, (-S) % n_tiles)
    return list(torch.chunk(x, n_tiles, dim=axis)), S


def sequence_tiled_compute(fn: Callable, x: torch.Tensor, n_tiles: int,
                           axis: int = 1, checkpoint: bool = True):
    """``fn`` (shape-preserving along ``axis``) applied tile by tile; the
    backward recomputes each tile (``checkpoint``), so peak activation
    memory is one tile's."""
    if n_tiles <= 1:
        return fn(x)
    tiles, S = _split_tiles(x, n_tiles, axis)
    if checkpoint:
        outs = [torch.utils.checkpoint.checkpoint(fn, t, use_reentrant=False)
                for t in tiles]
    else:
        outs = [fn(t) for t in tiles]
    return torch.cat(outs, dim=axis).narrow(axis, 0, S)


def tiled_mlp(mlp_fn: Callable, x: torch.Tensor, n_tiles: int,
              checkpoint: bool = True):
    """MLPs are position-wise: chunk the sequence dim (reference TiledMLP
    ulysses_sp.py:564)."""
    return sequence_tiled_compute(mlp_fn, x, n_tiles, axis=1,
                                  checkpoint=checkpoint)


def _tile_nll(h, lbl, m, unembed, transpose_unembed, tile_transform):
    from deepspeed_tpu_torch.runtime import sharding

    if tile_transform is not None:
        h = tile_transform(h)
    h = sharding.tp_copy(h)  # a vocab-sharded head at tp > 1
    if transpose_unembed:
        logits = torch.matmul(h, unembed.t())
    else:
        logits = torch.matmul(h, unembed)
    nll = sharding.vocab_parallel_nll(logits.float(), lbl) * m
    return nll.sum(), m.sum()


def tiled_logits_loss(hidden: torch.Tensor, unembed: torch.Tensor,
                      labels: torch.Tensor, mask: Optional[torch.Tensor],
                      n_tiles: int, transpose_unembed: bool = False,
                      tile_transform=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused unembed + causal-LM cross-entropy without the [B, S, V]
    logits (reference TiledFusedLogitsLoss ulysses_sp.py:943).

    hidden: [B, S, H]; unembed: [V, H] with ``transpose_unembed`` (a
    tied embedding) or [H, V]; labels: [B, S] int; mask: [B, S] or None.
    ``tile_transform`` (the model's final norm) runs on each hidden tile
    inside the recomputed tile body, so its fp32 intermediates stay
    tile-sized. Returns (masked nll sum, mask total): the caller
    divides."""
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    n_tiles = max(n_tiles, 1)
    h_tiles, _ = _split_tiles(hidden, n_tiles)
    l_tiles, _ = _split_tiles(labels, n_tiles)
    m_tiles, _ = _split_tiles(mask, n_tiles)
    total_nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    total_m = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for h, lbl, m in zip(h_tiles, l_tiles, m_tiles):
        s_nll, s_m = torch.utils.checkpoint.checkpoint(
            _tile_nll, h, lbl, m, unembed, transpose_unembed,
            tile_transform, use_reentrant=False)
        total_nll = total_nll + s_nll
        total_m = total_m + s_m
    return total_nll, total_m


__all__ = ["sequence_tiled_compute", "tiled_mlp", "tiled_logits_loss"]
