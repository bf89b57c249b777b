"""Hand-written Hopper kernels and their plain PyTorch versions (port of
``deepspeed_tpu/ops/pallas``)."""
