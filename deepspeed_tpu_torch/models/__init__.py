"""Model definitions (port of ``deepspeed_tpu/models``)."""
