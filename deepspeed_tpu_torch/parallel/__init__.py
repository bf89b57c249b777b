"""Parallelism (port of ``deepspeed_tpu/parallel``): so far the
single-card dropless MoE dispatch."""
