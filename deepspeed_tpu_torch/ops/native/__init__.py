"""Native (C++) host components: the host optimizers, async file I/O and
page-aligned buffers (port of ``deepspeed_tpu/ops/native``), over the
repository's ``csrc/`` built with g++ and loaded through ctypes."""
