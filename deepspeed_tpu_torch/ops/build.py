"""Build the hand-written CUDA kernels at first use.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``. Libraries land in ``deepspeed_tpu_torch/_build/``
(listed in ``.gitignore``) under a name keyed by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads
straight away. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict, Iterable, Optional

from deepspeed_tpu_torch._device import nvcc_path
from deepspeed_tpu_torch.observability.hub import note_compile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
SOURCES = {"paged_attention": "paged_attention.cu",
           "flash_attention": "flash_attention.cu",
           "grouped_matmul": "grouped_matmul.cu",
           "quantization": "quantization.cu",
           "blocksparse_attention": "blocksparse_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _lib_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header it may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in (SOURCES[name], *headers):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    seconds each build took (0.0 when it was already built). The
    compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``<lib>.log``. Each source compiled counts as one of the
    hub's compile events (``observability.hub.note_compile``). Raises
    RuntimeError when nvcc is missing or a build fails."""
    names = list(SOURCES if names is None else names)
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        if nvcc is None:
            raise RuntimeError(
                f"cannot build kernel '{name}': nvcc not found on PATH or "
                "under $CUDA_HOME/bin")
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(out + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    if procs:  # the hub's compile events (JAX: XLA compilations)
        note_compile(sum(seconds[n] for n in procs), events=len(procs))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _LOADED[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (registers, shared memory, spills) for ``name``."""
    path = _lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
