"""Host file I/O (port of ``deepspeed_tpu/io``)."""

from deepspeed_tpu_torch.io.fast_file_writer import FastFileWriter

__all__ = ["FastFileWriter"]
