"""Parallelism (port of ``deepspeed_tpu/parallel``): the rank topology
(``topology``: the named mesh axes as process groups) and the
single-card dropless MoE dispatch."""
