"""Parallelism (port of ``deepspeed_tpu/parallel``): the rank topology
(``topology``: the named mesh axes as process groups), the single-card
dropless MoE dispatch, ALST tiled compute (``tiled_compute``) and FPDT's
one-card parts (``fpdt``, over ``_blockwise``'s online softmax)."""
