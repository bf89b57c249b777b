"""Parallelism (port of ``deepspeed_tpu/parallel``): the rank topology
(``topology``: the named mesh axes as process groups), the MoE dispatch
(``moe``), ALST tiled compute (``tiled_compute``), FPDT's one-card parts
(``fpdt``, over ``_blockwise``'s online softmax), sequence parallelism
(``ulysses``, ``ring_attention``, the ``auto_sp`` planner), the stage
pipeline (``pipeline``) and Domino's chunked tp layer (``domino``)."""
