"""Device resolution and the hand-kernel availability probe.

Entry points take ``device=None`` and run on the card: no CUDA device is
an error that says so, never a quiet move to the CPU. The CPU runs only
when the caller asks for it (``device="cpu"``), as the tests do; there
every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def nvcc_path() -> Optional[str]:
    """The CUDA compiler the kernel build uses, or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else None


def kernels_status() -> Tuple[bool, str]:
    """Can the hand-written Hopper kernels build and run here: a CUDA
    device of compute capability >= 9.0 and ``nvcc``; when not, why not.
    Counterpart of the JAX package's TPU probe (``ops/registry.py``
    ``_tpu_probe``)."""
    if not torch.cuda.is_available():
        return False, "no CUDA device (torch.cuda.is_available() is False)"
    cap = torch.cuda.get_device_capability()
    if cap < (9, 0):
        return False, (f"compute capability {cap[0]}.{cap[1]}: the kernels "
                       "are built for sm_90")
    if nvcc_path() is None:
        return False, "nvcc not found (PATH, CUDA_HOME/bin)"
    return True, ""


def kernels_available() -> bool:
    """``kernels_status`` as a bool."""
    return kernels_status()[0]
