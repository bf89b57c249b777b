"""Command-line tools (port of ``deepspeed_tpu/launcher``): the
environment report."""
