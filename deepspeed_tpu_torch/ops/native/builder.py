"""Build and load the native host library (port of
``deepspeed_tpu/ops/native/builder.py``).

The repository's C++ sources ``csrc/aio/dstpu_aio.cpp`` and
``csrc/adam/dstpu_cpu_adam.cpp`` compile as they are, with ``g++ -O3
-fopenmp -march=native`` (retried without ``-march=native`` where the
host refuses it, as in JAX), into one shared library with a plain C
interface, loaded through ``ctypes``. ``$CXX`` is tried first, then
g++, c++, clang++ and the system g++: a compiler whose OpenMP runtime
is missing (no ``libgomp.spec``) fails the build and the next one is
tried. The library lands in ``deepspeed_tpu_torch/_build/`` beside the
CUDA kernels, under a name keyed by a hash of the sources, the compiler
and the flags, so an edited source rebuilds. Nothing here runs at
import.

The JAX package falls back to numpy when the build fails. Here a failed
build is recorded, and the callers that need the library (the offload
optimizer, the AIO handle of the NVMe tier) raise with its reason
through :func:`require_native_lib`.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from deepspeed_tpu_torch.observability.hub import note_compile
from deepspeed_tpu_torch.ops.build import BUILD_DIR

logger = logging.getLogger(__name__)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "csrc")
SOURCES = ("aio/dstpu_aio.cpp", "adam/dstpu_cpu_adam.cpp")
# -fno-math-errno: sqrtf need not set errno, so the Adam loops vectorize
# (without it GCC keeps them scalar); sqrt is correctly rounded either
# way, so the bits do not change (tests/test_torch_offload.py holds the
# steps bit-equal to the JAX package's build)
BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fno-math-errno",
              "-fopenmp")
FLAG_SETS = (("-march=native",), ())  # tried in this order

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _compilers():
    """$CXX, g++, c++ and clang++ on PATH, and the system g++."""
    names = [os.environ.get("CXX", ""), "g++", "c++", "clang++",
             "/usr/bin/g++"]
    seen, out = set(), []
    for name in names:
        path = shutil.which(name)
        if name and path and os.path.realpath(path) not in seen:
            seen.add(os.path.realpath(path))
            out.append(path)
    return out


def _lib_path(cxx: str, flags, srcs) -> str:
    h = hashlib.sha1(" ".join((*BASE_FLAGS, *flags)).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(cxx.encode())
    return os.path.join(BUILD_DIR, f"libdstpu_native_{h.hexdigest()[:12]}.so")


def _build(srcs, verbose: bool):
    """(path, flags) of a built library: an existing build of the first
    compiler and flag set that works, else a new one; errors listed."""
    candidates = [(cxx, flags, _lib_path(cxx, flags, srcs))
                  for cxx in _compilers() for flags in FLAG_SETS]
    for _, flags, path in candidates:
        if os.path.exists(path):
            return path, flags, []
    errors = []
    os.makedirs(BUILD_DIR, exist_ok=True)
    for cxx, flags, path in candidates:
        # a name of its own per process: concurrent builds (test
        # workers) never write through the same inode
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *BASE_FLAGS, *flags, *srcs, "-o", tmp, "-lpthread"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=not verbose, text=True)
        if proc.returncode == 0:
            os.replace(tmp, path)  # atomic: loaders see all or none
            # one of the hub's compile events (JAX: XLA compilations)
            note_compile(time.perf_counter() - t0)
            return path, flags, errors
        errors.append(f"{' '.join(cmd)}: {(proc.stderr or '')[-500:]}")
    return None, None, errors


def build_native_lib(verbose: bool = False) -> Optional[ctypes.CDLL]:
    """Compile (once per source hash) and load the library; None when it
    cannot be built here (the reason is in :func:`native_status`)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        if not _compilers():
            _build_error = "no C++ compiler ($CXX, g++, c++ or clang++)"
            return None
        srcs = [os.path.join(CSRC, s) for s in SOURCES]
        missing = [s for s in srcs if not os.path.exists(s)]
        if missing:
            _build_error = f"missing sources: {missing}"
            return None
        so_path, flags, errors = _build(srcs, verbose)
        if so_path is None:
            _build_error = "native build failed:\n" + "\n".join(errors)
            logger.warning(_build_error)
            return None
        if errors:
            logger.warning(f"native library built with {flags} after "
                           f"{len(errors)} failed attempts: {errors[-1]}")
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            _build_error = f"dlopen failed: {e}"
            return None
        _declare(lib)
        _lib = lib
        return _lib


def require_native_lib() -> ctypes.CDLL:
    """The library, or RuntimeError saying why it is not there."""
    lib = build_native_lib()
    if lib is None:
        raise RuntimeError(
            "the native host library (csrc/adam, csrc/aio) is required "
            f"and did not build or load: {_build_error}")
    return lib


def native_available() -> bool:
    return build_native_lib() is not None


def native_status() -> str:
    """'built' or the reason it is not."""
    if build_native_lib() is not None:
        return "built"
    return _build_error or "not built"


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    i64, vp, cp = c.c_int64, c.c_void_p, c.c_char_p
    flt, i32 = c.c_float, c.c_int

    lib.dstpu_aio_create2.restype = vp
    lib.dstpu_aio_create2.argtypes = [i32, i32, i32, i32]
    lib.dstpu_aio_backend.restype = i32
    lib.dstpu_aio_backend.argtypes = [vp]
    lib.dstpu_aio_destroy.restype = None
    lib.dstpu_aio_destroy.argtypes = [vp]
    for name in ("dstpu_aio_pread", "dstpu_aio_pwrite"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [vp, vp, i64, cp, i64]
    lib.dstpu_aio_wait.restype = i32
    lib.dstpu_aio_wait.argtypes = [vp]
    lib.dstpu_aio_bytes_read.restype = i64
    lib.dstpu_aio_bytes_read.argtypes = [vp]
    lib.dstpu_aio_bytes_written.restype = i64
    lib.dstpu_aio_bytes_written.argtypes = [vp]
    lib.dstpu_alloc_pinned.restype = vp
    lib.dstpu_alloc_pinned.argtypes = [i64]
    lib.dstpu_free_pinned.restype = None
    lib.dstpu_free_pinned.argtypes = [vp, i64]

    # tensors cross as raw addresses (``Tensor.data_ptr()``)
    for name in ("dstpu_adam_step", "dstpu_adam_step_bf16grad"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [vp, vp, vp, vp, i64, flt, flt, flt, flt, flt, i32,
                       i32, i32, vp]
    lib.dstpu_lion_step.restype = None
    lib.dstpu_lion_step.argtypes = [vp, vp, vp, i64, flt, flt, flt, flt, vp]
    lib.dstpu_adagrad_step.restype = None
    lib.dstpu_adagrad_step.argtypes = [vp, vp, vp, i64, flt, flt, flt, vp]
    lib.dstpu_f32_to_bf16.restype = None
    lib.dstpu_f32_to_bf16.argtypes = [vp, vp, i64]
    lib.dstpu_bf16_to_f32.restype = None
    lib.dstpu_bf16_to_f32.argtypes = [vp, vp, i64]
    lib.dstpu_sq_norm.restype = ctypes.c_double
    lib.dstpu_sq_norm.argtypes = [vp, i64]


__all__ = ["build_native_lib", "require_native_lib", "native_available",
           "native_status", "CSRC", "SOURCES"]
