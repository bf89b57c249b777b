"""Environment and compat report (port of ``deepspeed_tpu/launcher/
report.py``; reference: bin/ds_report -> deepspeed/env_report.py).

Run as ``python -m deepspeed_tpu_torch.launcher.report``. Prints the
versions (the port, Python, torch, CUDA, nvcc), the devices (name,
compute capability, memory, nvidia-smi's power limit), the op registry's
compat column, and the kernel table's path with its rows for this card.
Without a card it says "no CUDA device" and exits 0, as ds_report does:
it reports, it computes nothing.
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys
from typing import List, Optional

import torch


def _row(name, value, width=34):
    return f"{name:.<{width}} {value}"


def _nvcc_version(nvcc: Optional[str]) -> str:
    if nvcc is None:
        return "not found"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"{nvcc} ({e})"
    release = [line for line in out.splitlines() if "release" in line]
    return f"{nvcc} ({release[-1].strip() if release else 'no version'})"


def _power_limits() -> List[str]:
    """nvidia-smi's name and power limit of each card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable ({e})"]
    if out.returncode != 0:
        return [f"nvidia-smi failed ({out.stderr.strip()[:120]})"]
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def report_lines() -> List[str]:
    from deepspeed_tpu_torch import _device
    from deepspeed_tpu_torch.ops import kernel_table
    from deepspeed_tpu_torch.ops.registry import all_ops

    rule = "-" * 60
    lines = [rule, "deepspeed_tpu_torch environment report", rule]
    from deepspeed_tpu_torch.version import __version__

    lines.append(_row("deepspeed_tpu_torch version", __version__))
    lines.append(_row("python", platform.python_version()))
    lines.append(_row("platform", platform.platform()))
    lines.append(_row("torch version", torch.__version__))
    lines.append(_row("torch CUDA", torch.version.cuda or "none (CPU build)"))
    lines.append(_row("nvcc", _nvcc_version(_device.nvcc_path())))
    import numpy

    lines.append(_row("numpy", numpy.__version__))

    lines += [rule, "devices", rule]
    backend = kernel_table.default_backend()
    if backend != "cuda":
        lines.append(_row("cuda", "no CUDA device "
                          "(torch.cuda.is_available() is False)"))
    else:
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            lines.append(_row(f"cuda:{i}", f"{props.name}, capability "
                              f"{props.major}.{props.minor}, "
                              f"{props.total_memory / 2**30:.1f} GiB"))
        for line in _power_limits():
            lines.append(_row("nvidia-smi name, power.limit", line))
    ok, why = _device.kernels_status()
    lines.append(_row("hand-written kernels", "OK" if ok else f"NO ({why})"))

    # op registry compat (ds_report's op compatibility table), for the
    # device the entry points run on by default
    lines += [rule, f"op compatibility ({backend})", rule]
    for name, op in sorted(all_ops().items()):
        ok, why = op.is_compatible(backend)
        status = (f"OK ({why})" if why else "OK") if ok else f"NO ({why})"
        lines.append(_row(name, status))

    path = kernel_table.table_path()
    lines += [rule, "kernel table", rule, _row("path", path)]
    data = kernel_table.load_table(path)
    if data is None:
        lines.append(_row("rows", "none (missing or unreadable: impl='auto' "
                          "follows the heuristic)"))
    else:
        # the rows the dispatch would use here (decide's scoping)
        here = []
        for kernel, buckets in sorted((data.get("entries") or {}).items()):
            for bucket in sorted(buckets):
                d = kernel_table.decide(kernel, bucket, path, backend)
                if d.measured:
                    here.append((kernel, bucket, d, buckets[bucket]))
        lines.append(_row("rows for this device", str(len(here))))
        for kernel, bucket, d, e in here:
            lines.append(_row(f"{kernel} {bucket}",
                              f"ratio {d.ratio} ({'win' if d.win else 'loss'})"
                              f", kernel {e.get('kernel_ms')} ms, fallback "
                              f"{e.get('xla_ms')} ms"))

    env_flags = {k: v for k, v in os.environ.items()
                 if k.startswith(("CUDA_", "DSTPU_", "KERNEL_BENCH_"))}
    if env_flags:
        lines += [rule, "relevant environment", rule]
        for k in sorted(env_flags):
            lines.append(_row(k, env_flags[k]))
    return lines


def main(argv=None) -> int:
    print("\n".join(report_lines()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
