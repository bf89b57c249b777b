"""Dense metadata for a ragged forward step (port of
``deepspeed_tpu/inference/ragged/ragged_batch.py``).

Every step is padded to a (max_tokens, max_seqs) bucket, as in the JAX
package, so the runner sees fixed shapes.

Layout (all int32):
  token_ids   [T]     flattened new tokens across sequences
  token_seq   [T]     local slot (0..S-1) of the owning sequence
  token_pos   [T]     absolute position of the token in its sequence
  block_table [S, Bm] KV block ids per slot (padded with 0)
  ctx_lens    [S]     tokens in cache *after* this step per slot
  num_tokens  []      true token count (rest is padding)
  last_token_index [S] index into [T] of each slot's final token (for
                      next-token logits), 0 for empty slots
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.ragged.sequence import SequenceDescriptor


@dataclasses.dataclass
class RaggedBatch:
    token_ids: np.ndarray
    token_seq: np.ndarray
    token_pos: np.ndarray
    block_table: np.ndarray
    ctx_lens: np.ndarray
    num_tokens: int
    last_token_index: np.ndarray


def build_ragged_batch(
    scheduled: List[Tuple[SequenceDescriptor, np.ndarray, int]],
    max_tokens: int,
    max_seqs: int,
    max_blocks_per_seq: int,
) -> RaggedBatch:
    """Pack (sequence, new_tokens, start_pos) triples into dense arrays.

    ``scheduled`` comes from the SplitFuse scheduler: each entry is a chunk
    of a sequence's tokens to run this step (full/partial prefill or a
    single decode token).
    """
    if len(scheduled) > max_seqs:
        raise ValueError(f"{len(scheduled)} sequences > bucket max {max_seqs}")
    token_ids = np.zeros(max_tokens, np.int32)
    token_seq = np.zeros(max_tokens, np.int32)
    token_pos = np.zeros(max_tokens, np.int32)
    block_table = np.zeros((max_seqs, max_blocks_per_seq), np.int32)
    ctx_lens = np.zeros(max_seqs, np.int32)
    last_token_index = np.zeros(max_seqs, np.int32)

    cursor = 0
    for slot, (seq, new_tokens, start_pos) in enumerate(scheduled):
        n = len(new_tokens)
        if cursor + n > max_tokens:
            raise ValueError("token budget overflow; scheduler bug")
        token_ids[cursor:cursor + n] = new_tokens
        token_seq[cursor:cursor + n] = slot
        token_pos[cursor:cursor + n] = np.arange(start_pos, start_pos + n)
        nb = len(seq.kv_blocks)
        if nb > max_blocks_per_seq:
            raise ValueError(
                f"sequence needs {nb} blocks > bucket max {max_blocks_per_seq}")
        block_table[slot, :nb] = seq.kv_blocks
        ctx_lens[slot] = start_pos + n
        last_token_index[slot] = cursor + n - 1
        cursor += n

    # padding tokens point at slot 0 with pos 0; they are masked out by
    # comparing token index against num_tokens in the runner.
    return RaggedBatch(
        token_ids=token_ids, token_seq=token_seq, token_pos=token_pos,
        block_table=block_table, ctx_lens=ctx_lens, num_tokens=cursor,
        last_token_index=last_token_index)
