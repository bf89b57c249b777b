"""Host optimizer steps on CPU fp32 tensors (port of
``deepspeed_tpu/ops/native/cpu_optimizer.py``).

``CPUAdam`` (adam and adamw), ``CPULion`` and ``CPUAdagrad`` own the
moments of one flat fp32 leaf and step it in place through the native
OpenMP kernels of ``csrc/adam/dstpu_cpu_adam.cpp`` (the library the JAX
package loads), passing ``Tensor.data_ptr()`` over ``ctypes``; a step can
also write the updated parameters as bf16 for the upload. There is no
silent fallback: a missing library raises (``builder.require_native_lib``).

``update`` applies one step at the current count to a contiguous chunk,
with the moments given explicitly: the offload optimizer
(``runtime/offload.py``) streams each leaf through in chunks, with the
moments resident on the host or read from the NVMe swap. ``step`` is
``update`` over the whole leaf after advancing the count.

``adam_plain``, ``lion_plain`` and ``adagrad_plain`` are the same
arithmetic in PyTorch, in the kernels' order of operations (fp32
constants, no fused multiply-add): the tests hold the native steps
against them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.ops.native.builder import require_native_lib

F32, BF16 = torch.float32, torch.bfloat16


def _ptr(t: Optional[torch.Tensor], dtype, n: int, what: str) -> Optional[int]:
    """The address of a contiguous CPU tensor of ``n`` elements of
    ``dtype``, checked before any pointer reaches native code."""
    if t is None:
        return None
    if t.device.type != "cpu" or not t.is_contiguous() or t.dtype != dtype \
            or t.numel() != n:
        raise ValueError(
            f"{what}: needs a contiguous CPU {dtype} tensor of {n} "
            f"elements, got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
    return t.data_ptr()


class _HostOptimizer:
    """Moments of one flat fp32 leaf; subclasses name them and step."""

    state_names: Sequence[str] = ()

    def __init__(self, n: int, lr: float):
        self.n = int(n)
        self.lr = lr
        self.step_count = 0
        self._lib = require_native_lib()
        for name in self.state_names:
            setattr(self, name, None)
        self.ensure_state()

    def moments(self):
        return tuple(getattr(self, name) for name in self.state_names)

    def step(self, param: torch.Tensor, grad: torch.Tensor,
             param_bf16_out: Optional[torch.Tensor] = None,
             lr: Optional[float] = None) -> None:
        """Advance the count and update the whole leaf in place."""
        self.ensure_state()
        self.step_count += 1
        self.update(param, grad, self.moments(), param_bf16_out, lr)

    def update(self, param, grad, state, param_bf16_out=None, lr=None):
        raise NotImplementedError

    def state_dict(self) -> dict:
        self.ensure_state()
        return {name: getattr(self, name) for name in self.state_names}

    def load_state_dict(self, sd: dict) -> None:
        self.ensure_state()
        for name in self.state_names:
            getattr(self, name).copy_(torch.as_tensor(sd[name]).reshape(-1))

    def ensure_state(self) -> None:
        """(Re)allocate the moments after ``detach_state``."""
        for name in self.state_names:
            if getattr(self, name) is None:
                setattr(self, name, torch.zeros(self.n, dtype=F32))

    def detach_state(self) -> None:
        """Drop the moments from host memory (the NVMe tier keeps them in
        its swap store between steps)."""
        for name in self.state_names:
            setattr(self, name, None)

    def _grad32(self, grad: torch.Tensor) -> torch.Tensor:
        return bf16_to_f32(grad) if grad.dtype == BF16 else grad


class CPUAdam(_HostOptimizer):
    """Adam / AdamW on a flat fp32 leaf (reference: DeepSpeedCPUAdam)."""

    state_names = ("exp_avg", "exp_avg_sq")

    def __init__(self, n: int, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adamw_mode=True, bias_correction=True):
        self.betas, self.eps = tuple(betas), eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        super().__init__(n, lr)

    def update(self, param, grad, state, param_bf16_out=None, lr=None):
        """One step at ``step_count`` over ``param`` (a contiguous fp32
        chunk), ``grad`` (fp32, or bf16 for the bf16-gradient kernel) and
        ``state`` (exp_avg, exp_avg_sq chunks of the same size)."""
        n = param.numel()
        lr = self.lr if lr is None else float(lr)
        b1, b2 = self.betas
        fn = (self._lib.dstpu_adam_step_bf16grad if grad.dtype == BF16
              else self._lib.dstpu_adam_step)
        m, v = state
        fn(_ptr(param, F32, n, "param"),
           _ptr(grad, BF16 if grad.dtype == BF16 else F32, n, "grad"),
           _ptr(m, F32, n, "exp_avg"), _ptr(v, F32, n, "exp_avg_sq"), n,
           lr, b1, b2, self.eps, self.weight_decay, self.step_count,
           int(self.adamw_mode), int(self.bias_correction),
           _ptr(param_bf16_out, BF16, n, "param_bf16_out"))

    def state_dict(self) -> dict:
        return {**super().state_dict(), "step": self.step_count}

    def load_state_dict(self, sd: dict) -> None:
        super().load_state_dict(sd)
        self.step_count = int(sd["step"])


class CPULion(_HostOptimizer):
    """Lion on a flat fp32 leaf (reference: deepspeed/ops/lion)."""

    state_names = ("exp_avg",)

    def __init__(self, n: int, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0):
        self.betas, self.weight_decay = tuple(betas), weight_decay
        super().__init__(n, lr)

    def update(self, param, grad, state, param_bf16_out=None, lr=None):
        n = param.numel()
        lr = self.lr if lr is None else float(lr)
        (m,) = state
        self._lib.dstpu_lion_step(
            _ptr(param, F32, n, "param"),
            _ptr(self._grad32(grad), F32, n, "grad"),
            _ptr(m, F32, n, "exp_avg"), n, lr, self.betas[0],
            self.betas[1], self.weight_decay,
            _ptr(param_bf16_out, BF16, n, "param_bf16_out"))


class CPUAdagrad(_HostOptimizer):
    """Adagrad on a flat fp32 leaf (reference: csrc/adagrad)."""

    state_names = ("exp_avg_sq",)

    def __init__(self, n: int, lr=1e-2, eps=1e-10, weight_decay=0.0):
        self.eps, self.weight_decay = eps, weight_decay
        super().__init__(n, lr)

    def update(self, param, grad, state, param_bf16_out=None, lr=None):
        n = param.numel()
        lr = self.lr if lr is None else float(lr)
        (v,) = state
        self._lib.dstpu_adagrad_step(
            _ptr(param, F32, n, "param"),
            _ptr(self._grad32(grad), F32, n, "grad"),
            _ptr(v, F32, n, "exp_avg_sq"), n, lr, self.eps,
            self.weight_decay,
            _ptr(param_bf16_out, BF16, n, "param_bf16_out"))


def f32_to_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even fp32 -> bf16 on the host, natively."""
    src = x.detach().to("cpu", F32).contiguous()
    out = torch.empty(src.shape, dtype=BF16)
    require_native_lib().dstpu_f32_to_bf16(src.data_ptr(), out.data_ptr(),
                                           src.numel())
    return out


def bf16_to_f32(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> fp32 on the host (exact), natively."""
    src = x.detach().to("cpu").contiguous()
    if src.dtype != BF16:
        raise ValueError(f"bf16_to_f32 takes bf16, got {src.dtype}")
    out = torch.empty(src.shape, dtype=F32)
    require_native_lib().dstpu_bf16_to_f32(src.data_ptr(), out.data_ptr(),
                                           src.numel())
    return out


# -- plain twins (the tests' references) -------------------------------------


@torch.no_grad()
def adam_plain(param, grad, exp_avg, exp_avg_sq, *, lr, betas, eps,
               weight_decay, step, adamw_mode=True, bias_correction=True,
               param_bf16_out=None) -> None:
    """``dstpu_adam_step`` in PyTorch, in place, op for op."""
    b1, b2 = np.float32(betas[0]), np.float32(betas[1])
    lr, eps, wd = np.float32(lr), np.float32(eps), np.float32(weight_decay)
    bc1 = bc2 = np.float32(1.0)
    if bias_correction:
        bc1 = np.float32(1.0) - b1 ** np.float32(step)
        bc2 = np.float32(1.0) - b2 ** np.float32(step)
    step_size, bc2_sqrt = lr / bc1, np.sqrt(bc2)
    g = grad.float()
    if not adamw_mode and wd > 0:
        g = g + param * float(wd)
    exp_avg.copy_(exp_avg * float(b1) + g * float(np.float32(1) - b1))
    exp_avg_sq.copy_(exp_avg_sq * float(b2)
                     + (g * float(np.float32(1) - b2)) * g)
    denom = exp_avg_sq.sqrt() / float(bc2_sqrt) + float(eps)
    if adamw_mode and wd > 0:
        param.sub_(param * float(lr * wd))
    param.sub_((exp_avg / denom) * float(step_size))
    if param_bf16_out is not None:
        param_bf16_out.copy_(param)


@torch.no_grad()
def lion_plain(param, grad, exp_avg, *, lr, betas, weight_decay,
               param_bf16_out=None) -> None:
    """``dstpu_lion_step`` in PyTorch, in place."""
    b1, b2 = np.float32(betas[0]), np.float32(betas[1])
    lr, wd = np.float32(lr), np.float32(weight_decay)
    g = grad.float()
    c = exp_avg * float(b1) + g * float(np.float32(1) - b1)
    param.mul_(float(np.float32(1) - lr * wd))
    param.sub_(torch.sign(c) * float(lr))
    exp_avg.copy_(exp_avg * float(b2) + g * float(np.float32(1) - b2))
    if param_bf16_out is not None:
        param_bf16_out.copy_(param)


@torch.no_grad()
def adagrad_plain(param, grad, exp_avg_sq, *, lr, eps, weight_decay,
                  param_bf16_out=None) -> None:
    """``dstpu_adagrad_step`` in PyTorch, in place."""
    lr, eps, wd = np.float32(lr), np.float32(eps), np.float32(weight_decay)
    g = grad.float()
    if wd > 0:
        g = g + param * float(wd)
    exp_avg_sq.add_(g * g)
    param.sub_((g * float(lr)) / (exp_avg_sq.sqrt() + float(eps)))
    if param_bf16_out is not None:
        param_bf16_out.copy_(param)


CPU_OPTIMIZERS = {"adam": CPUAdam, "adamw": CPUAdam, "lion": CPULion,
                  "adagrad": CPUAdagrad}

__all__ = ["CPUAdam", "CPULion", "CPUAdagrad", "CPU_OPTIMIZERS",
           "f32_to_bf16", "bf16_to_f32", "adam_plain", "lion_plain",
           "adagrad_plain"]
