"""Sparse gradients for embedding tables (port of
``deepspeed_tpu/runtime/sparse_tensor.py``; reference
``deepspeed/runtime/sparse_tensor.py`` and ``engine.sparse_allreduce``,
engine.py:3634).

An embedding gradient touches only the rows of the batch's tokens, so
the data-parallel exchange ships (indices, values) instead of the dense
[vocab, hidden] matrix. As in JAX the row count is the batch's token
count (duplicates keep their first slot and send zeros to a padding
row), so every rank sends the same shapes; the ranks all-gather the
compact pairs over the ``dp`` axis and a scatter-add rebuilds the dense
sum.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepspeed_tpu_torch import comm


class SparseTensor:
    """(indices [K], values [K, H], dense_shape) — reference
    SparseTensor."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 dense_shape: Tuple[int, int]):
        self.indices = indices
        self.values = values
        self.dense_shape = tuple(dense_shape)

    @classmethod
    def from_dense_rows(cls, grad: torch.Tensor, token_ids: torch.Tensor
                        ) -> "SparseTensor":
        """Compact an embedding gradient to the rows named by
        ``token_ids`` (K = the token count): the dense grad holds each
        row's whole contribution, so a repeated id takes its row once and
        its other slots carry zeros to the padding row ``vocab``."""
        vocab, h = grad.shape
        s = torch.sort(token_ids.reshape(-1).long()).values
        first = torch.ones_like(s, dtype=torch.bool)
        first[1:] = s[1:] != s[:-1]
        rows = grad[s] * first[:, None].to(grad.dtype)
        idx = torch.where(first, s, torch.full_like(s, vocab))
        return cls(idx, rows, (vocab, h))

    def to_dense(self) -> torch.Tensor:
        vocab, h = self.dense_shape
        dense = torch.zeros((vocab + 1, h), dtype=self.values.dtype,
                            device=self.values.device)  # +1: padding row
        dense.index_add_(0, self.indices, self.values)
        return dense[:vocab]


def sparse_allreduce(grad: torch.Tensor, token_ids: torch.Tensor,
                     axis: str = "dp") -> torch.Tensor:
    """The data-parallel sum of an embedding gradient by exchanging
    compact rows (reference engine.sparse_allreduce, engine.py:3634).
    ``token_ids`` are this rank's tokens; returns the dense sum."""
    st = SparseTensor.from_dense_rows(grad, token_ids)
    all_idx = comm.all_gather(st.indices, axis)
    all_val = comm.all_gather(st.values, axis)
    return SparseTensor(all_idx, all_val, st.dense_shape).to_dense()


__all__ = ["SparseTensor", "sparse_allreduce"]
